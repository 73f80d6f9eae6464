"""PyTorch trust steps: the CSR step, the power-iteration loop, and the
fused windowed pipeline on the hand-written CUDA gather kernel."""

from .gather_window import (  # noqa: F401
    PLAN_VERSION,
    WindowPlan,
    bridge_partials_plain,
    bucket_by_window,
    build_window_plan,
    converge_windowed,
    gather_windowed,
    gather_windowed_plain,
    power_step_windowed,
    prefix_bridge,
    prefix_bridge_plain,
    row_run_ptr,
    windowed_ct,
)
from .sparse import converge_csr, power_step_csr, rowsum_sorted, run_power_iteration  # noqa: F401
