"""graftlint pass 12 — the peak-memory analyzer (memory wall).

See ``checker.py`` for the rule set and the measured leg, and
``waivers.py`` for the enumerated, stale-tested suppression table.
"""

from .checker import MEM_SCALES, MemCase, check_mem_case, judge_peak, pod_budget_view, run_memory_pass
from .waivers import MEM_WAIVERS

__all__ = [
    "MEM_SCALES",
    "MEM_WAIVERS",
    "MemCase",
    "check_mem_case",
    "judge_peak",
    "pod_budget_view",
    "run_memory_pass",
]
