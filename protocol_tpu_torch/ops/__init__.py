"""PyTorch trust steps: dense, sparse (COO and CSR), the power-iteration
loop, and the fused windowed pipeline on the hand-written CUDA gather
kernel."""

from .dense import converge_dense, filter_and_normalize, set_converge_dense  # noqa: F401
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
from .sparse import (  # noqa: F401
    converge_csr,
    converge_sparse,
    gather_multiply,
    power_step_coo,
    power_step_csr,
    rowsum_sorted,
    run_power_iteration,
)
