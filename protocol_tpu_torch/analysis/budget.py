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

The graft prover's kernels (``zk/graft/``) declare theirs as well
(``ZK_INVARIANTS``): for each of the reference's registry names
(``zk.graft.ZK_KERNELS``), the wrapper that counts its launches and how
many launches one call of each graft entry makes, from the call's size,
with the gathers and scatters a call may run outside the kernels and the
downloads each entry makes.  ``chip_smoke.py`` holds every graft call's
launches against them.  Each of those names also declares a
``MemBudget`` (its lanes are the N of the formulas) and a ``CommBudget``
of no collective, next to its kernel, as the reference's do; the
analyzers' graft leg (``analysis/zk_lowering.py``, ``--zk``) runs each
kernel against all three.

Every card backend, the sharded composites included, also declares its
memory (``MEM_INVARIANTS``): the reference's resident and transient
formulas, linear in N, the segments and the plan rows, with an edge
term for the resident arguments only.  ``analysis/memory`` measures a
converge's peak on the card at two scales against them.

The analyzers (``python -m protocol_tpu_torch.analysis``) check all of
these tables; a registered backend without its budgets is an error
there.  This module imports only the standard library.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable


@dataclass(frozen=True)
class KernelBudget:
    """The kernels one power step of ``backend`` launches, by the name
    of the wrapper that counts them (``ops/*.py``; each wrapper's
    ``launches`` attribute), and how many times a step.

    The step leg (``analysis/step.py``) also holds a step's PyTorch ops
    to the rest of the reference's contract.  Counting convention, the
    reference's: ops inside a kernel wrapper (its plain version on the
    CPU, its operand checks) are not gathers or scatters of the step,
    since on the card they run inside the kernel."""

    backend: str
    launches_per_step: dict[str, int] = field(default_factory=dict)
    notes: str = ""
    #: Gather-family ops (``index_select``, ``gather``, ``index``, ...)
    #: a step may run outside its kernels (checked on the card).
    max_gathers: int = 0
    #: Scatter-family ops (``index_put``, ``scatter*``, ``index_add``,
    #: ...) a step may run outside its kernels.
    max_scatters: int = 0

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


@dataclass(frozen=True)
class ZkKernelBudget:
    """The launches of one graft kernel, by the reference's registry
    name (``kernel``), counted by the wrapper ``wrapper``
    (``zk/graft/*.py``; its ``launches`` attribute): for each graft
    entry that launches it, a function of the call's size (``n`` points,
    scalars or elements, and ``inverse`` for the NTT) giving the
    launches one call makes.  Two names may share a wrapper, as the
    MSM's scan and bucket passes share K13's."""

    kernel: str
    wrapper: str
    per_call: dict[str, Callable[..., int]] = field(default_factory=dict)
    notes: str = ""
    #: Gather-family and scatter-family ops a call may run outside the
    #: kernel wrappers (the reference's ``max_random_gathers`` and
    #: ``max_scatters``; the port's permutes and bucket writes run inside
    #: K12 and K13).
    max_gathers: int = 0
    max_scatters: int = 0
    #: For each graft entry that downloads this kernel's result, a
    #: function of the call's size giving the bytes of each device-to-host
    #: copy one call makes; any other host read is a finding.
    host_copies: dict[str, Callable[..., list[int]]] = field(default_factory=dict)


#: registry name -> declared budget.  Populated by ``zk/graft/field.py``,
#: ``ntt.py`` and ``pippenger.py`` at import, next to their kernels.
ZK_INVARIANTS: dict[str, ZkKernelBudget] = {}


def declare_zk(budget: ZkKernelBudget) -> ZkKernelBudget:
    """Register a graft kernel budget (idempotent per registry name)."""
    ZK_INVARIANTS[budget.kernel] = budget
    return budget


@dataclass(frozen=True)
class MemBudget:
    """Per-backend peak-memory contract, the reference's fields and
    formulas, checked by ``analysis/memory`` against a converge measured
    on the card.  All numbers are one rank's (one device's) view, so
    "per-shard peak scales as E/n_shards" is the formula itself.

    - **resident**: the converge's argument tensors (edge tables,
      window-plan rows, segment tables, score vectors).  The edge term
      is divided by ``n_shards``: an edge operand replicated on every
      rank busts the budget by construction (``shard-replicated-edges``).
    - **transient**: ``torch.cuda.max_memory_allocated`` over the
      converge less what was allocated when it started.  It is linear in
      N, the segments and the plan rows only — there is **no edge
      coefficient**, so an O(E) live buffer beyond the resident
      arguments is inexpressible (``o-e-live-temporary``).  Rows are a
      plan-layout dimension (1024 edge slots each), never a raw edge
      count.

    ``donated_args`` is kept for the reference's shape: torch has no
    buffer donation, so every N-vector a converge holds, the carry's
    copies included, is counted in ``transient_n`` instead.
    """

    backend: str
    #: Resident (argument) allowance coefficients.
    resident_edge_bytes: float = 0.0  # x E / n_shards
    resident_n: float = 0.0  # x N
    resident_segments: float = 0.0  # x n_segments (per-shard table)
    resident_rows: float = 0.0  # x plan rows (per shard)
    resident_const: float = 0.0
    #: Transient allowance — NO edge coefficient can be declared here.
    transient_n: float = 0.0
    transient_segments: float = 0.0
    transient_rows: float = 0.0
    transient_const: float = 0.0
    donated_args: tuple[str, ...] = ()
    #: Per-op device-to-host copy cap (``staging_n * N + staging_const``):
    #: a converge that copies more than this to the host in one op — an
    #: O(E) staging copy — is a ``host-staging-over-cap`` finding.
    staging_n: float = 0.0
    staging_const: float = 0.0
    notes: str = ""

    def max_resident(
        self, n: int, edges: int, n_segments: int, rows: int, n_shards: int
    ) -> float:
        return (
            self.resident_edge_bytes * edges / max(n_shards, 1)
            + self.resident_n * n
            + self.resident_segments * n_segments
            + self.resident_rows * rows
            + self.resident_const
        )

    def max_transient(self, n: int, n_segments: int, rows: int) -> float:
        return (
            self.transient_n * n
            + self.transient_segments * n_segments
            + self.transient_rows * rows
            + self.transient_const
        )

    def staging_cap(self, n: int) -> float:
        return self.staging_n * n + self.staging_const


#: backend name -> declared memory budget.  Populated by
#: ``trust/backend.py`` and ``parallel/sharded.py`` at import, next to
#: the kernel and comm budgets.
MEM_INVARIANTS: dict[str, MemBudget] = {}


def declare_mem(budget: MemBudget) -> MemBudget:
    """Register a memory budget (idempotent per backend name)."""
    MEM_INVARIANTS[budget.backend] = budget
    return budget


def expected_zk_launches(entry: str, **size) -> dict[str, int]:
    """Launches one call of graft entry ``entry`` (``ntt_limbs``,
    ``msm_limbs``, ``point_cache``) of the given size makes, by wrapper.
    A wrapper that two names share must be declared alike by both."""
    out: dict[str, int] = {}
    for budget in ZK_INVARIANTS.values():
        fn = budget.per_call.get(entry)
        if fn is None:
            continue
        k = int(fn(**size))
        if out.setdefault(budget.wrapper, k) != k:
            raise ValueError(f"{budget.wrapper}: declared {out[budget.wrapper]} and {k} for {entry}")
    return out


def expected_zk_host_copies(entry: str, **size) -> list[int]:
    """Bytes of each device-to-host copy one call of graft entry
    ``entry`` of the given size declares, in the budgets' order."""
    out: list[int] = []
    for budget in ZK_INVARIANTS.values():
        fn = budget.host_copies.get(entry)
        if fn is not None:
            out.extend(int(b) for b in fn(**size))
    return out
