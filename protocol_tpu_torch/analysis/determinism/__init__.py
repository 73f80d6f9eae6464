"""graftlint pass 13 — the determinism wall.

An AST taint walk flagging divergence-feasible Python sources
(``ast_walk``), a runtime leg replaying every card backend's converge in
this process and in a fresh one (``checker``, ``replay``), a scan of the
kernels' sources for floating-point atomics (``checker``), and the
enumerated, stale-tested waiver table (``waivers``).
"""

from .ast_walk import DET_AST_RULES, DET_TREES, run_det_ast_pass, scan_det_source
from .checker import (
    check_replays,
    digest,
    run_determinism_pass,
    scan_atomics,
    scan_atomics_source,
)
from .waivers import DET_WAIVERS

__all__ = [
    "DET_AST_RULES",
    "DET_TREES",
    "DET_WAIVERS",
    "check_replays",
    "digest",
    "run_determinism_pass",
    "run_det_ast_pass",
    "scan_atomics",
    "scan_atomics_source",
    "scan_det_source",
]
