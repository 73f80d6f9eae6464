"""graftlint pass 8 — the communication analyzer, run on ranks.

``checker`` starts the sharded composites on ``run_ranks`` ranks at the
reference's two scales (E x4 while N x2) and holds each rank's
all-reduces — calls a step, bytes a step, their growth with the scale,
and the group each covers — to the composite's ``COMM_INVARIANTS``
budget; ``waivers`` is the enumerated, stale-tested suppression table
(empty).
"""

from __future__ import annotations

from .checker import COMM_SCALES, CommCase, check_comm_case, check_scaling, run_comm_pass
from .waivers import COMM_WAIVERS

__all__ = [
    "COMM_SCALES",
    "COMM_WAIVERS",
    "CommCase",
    "check_comm_case",
    "check_scaling",
    "run_comm_pass",
]
