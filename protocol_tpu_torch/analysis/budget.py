"""Declared per-backend kernel budgets — the ``KERNEL_INVARIANTS`` table.

Each ``cuda-*`` backend declares, next to its class
(``trust/backend.py``), the hand-written kernels one power step launches
and how often.  The node reads the table before every converge
(``node/manager.py``): a configured backend with no declaration runs
with its launch pattern unpinned, which is legal but logged, as in the
reference.  ``chip_smoke.py`` holds the launch counts a converge makes
on the card against ``iterations * launches_per_step``.

Host-only backends (``HOST_BACKENDS``) launch no kernel and are exempt.
This module imports only the standard library.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class KernelBudget:
    """The kernels one power step of ``backend`` launches, by the name
    of the wrapper that counts them (``ops/*.py``; each wrapper's
    ``launches`` attribute), and how many times a step."""

    backend: str
    launches_per_step: dict[str, int] = field(default_factory=dict)
    notes: str = ""

    def expected_launches(self, iterations: int) -> dict[str, int]:
        """Launches a converge of ``iterations`` steps makes, by wrapper."""
        return {name: per * int(iterations) for name, per in self.launches_per_step.items()}


#: Backends that launch no kernel (exact host arithmetic) — exempt.
HOST_BACKENDS = frozenset({"native-cpu"})

#: backend name -> declared budget.  Populated by ``trust/backend.py``
#: at import, next to each backend class.
KERNEL_INVARIANTS: dict[str, KernelBudget] = {}


def declare(budget: KernelBudget) -> KernelBudget:
    """Register a kernel budget (idempotent per backend name)."""
    KERNEL_INVARIANTS[budget.backend] = budget
    return budget
