"""Declared per-backend kernel budgets — the ``KERNEL_INVARIANTS`` table.

Each ``cuda-*`` backend declares, next to its class
(``trust/backend.py``), the hand-written kernels one power step launches
and how often.  The node reads the table before every converge
(``node/manager.py``): a configured backend with no declaration runs
with its launch pattern unpinned, which is legal but logged, as in the
reference.  ``chip_smoke.py`` holds the launch counts a converge makes
on the card against ``iterations * launches_per_step``.

Host-only backends (``HOST_BACKENDS``) launch no kernel and are exempt.

The sharded backends also declare their collectives (``COMM_INVARIANTS``,
``parallel/sharded.py``): the wrappers a step calls and the bytes they
carry, linear in N and never in E.  The node warns at configuration
time about a sharded backend without one, and ``chip_smoke.py`` holds
each rank's counts against it.  The reference's comm budget also pins
the compiled module's host round trips at 0; the port's does not, as
gloo stages an all-reduce of CUDA tensors through the host.
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


@dataclass(frozen=True)
class CommBudget:
    """The collectives one power step of a sharded ``backend`` makes on
    each rank, by the name of the wrapper that counts them (its
    ``calls`` and ``bytes``), and their bytes a step, ``bytes_n * n``:
    there is no term in the edge count."""

    backend: str
    calls_per_step: dict[str, int] = field(default_factory=dict)
    bytes_n: float = 0.0
    notes: str = ""

    def expected(self, iterations: int, n: int) -> dict[str, int]:
        """Calls by wrapper and total bytes (``"bytes"``) of a converge
        of ``iterations`` steps over ``n`` peers."""
        out = {name: per * int(iterations) for name, per in self.calls_per_step.items()}
        out["bytes"] = int(iterations) * int(self.bytes_n * n)
        return out


#: sharded backend name -> declared comm budget.  Populated by
#: ``parallel/sharded.py`` at import.
COMM_INVARIANTS: dict[str, CommBudget] = {}


def declare_comm(budget: CommBudget) -> CommBudget:
    """Register a comm budget (idempotent per backend name)."""
    COMM_INVARIANTS[budget.backend] = budget
    return budget
