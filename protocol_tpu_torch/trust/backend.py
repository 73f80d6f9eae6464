"""TrustBackend on PyTorch — the port's execution backends.

Port of ``protocol_tpu/trust/backend.py``'s single-device ladder:

- ``native-cpu``     exact rational dense power iteration on the host
  (``fractions.Fraction``): the parity oracle, a CPU backend by name.
- ``cuda-dense``     dense matrix-vector power iteration in chunks of 8
  with a host residual check between them (``ops.dense.converge_dense``).
- ``cuda-sparse``    COO SpMV (``ops.sparse.converge_sparse``): the CSR
  step over the edges' dst segments, derived on the device.
- ``cuda-csr``       gather-only CSR / compensated-cumsum SpMV
  (``ops.sparse.converge_csr``).
- ``cuda-windowed``  the fused fixed-slot pipeline on the hand-written
  CUDA windowed gather (``ops.gather_window.converge_windowed``), with
  the host-built ``WindowPlan`` cached and revalidated by graph
  fingerprint, delta-updated from a churn hint, or rebuilt.
- ``cuda-sharded[:cuda-csr|:cuda-windowed]``  the CSR or the windowed
  step over this rank's shard, completed by one all-reduce a step
  (``parallel.sharded.converge_sharded``), in a rank of an initialized
  ``torch.distributed`` group; plain ``cuda-sharded`` is ``:cuda-csr``.

Each backend but ``native-cpu`` runs on ``device``: ``None`` means CUDA
and raises where there is no card; ``device="cpu"`` runs the plain
versions (the tests).  Each ``cuda-*`` backend declares the hand-written
kernels one of its power steps launches (``analysis/budget.py``), and
the converges, plan outcomes and plan builds land on the ``obs`` spans,
metrics and journal under the reference's names.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

from .. import resolve_device
from ..analysis.budget import KernelBudget, MemBudget, declare, declare_mem
from ..obs import TRACER
from ..obs.journal import JOURNAL
from ..obs.metrics import PLAN_OUTCOMES, PLAN_REBUILDS, PLAN_REUSES
from ..ops.gather_window import (
    PLAN_VERSION,
    WindowPlan,
    build_window_plan,
    converge_windowed,
    graph_fingerprint,
    try_plan_delta,
)
from ..ops.dense import converge_dense
from ..ops.sparse import converge_csr, converge_sparse
from ..parallel.mesh import default_mesh
# parallel/sharded.py imports this package (``trust.graph``): bound as
# a module, so importing either one first works.
from ..parallel import sharded as _sharded
from .graph import TrustGraph


@dataclass
class ConvergenceResult:
    """Scores plus convergence metadata, as the reference returns them."""

    scores: np.ndarray  # (n,) float64, L1-normalized global trust
    iterations: int
    residual: float
    backend: str
    #: Per-iteration L1 residual trajectory (length == ``iterations``),
    #: written on the device each step and fetched once after the loop.
    #: None when the caller opted out (``record_residuals=False``).
    residuals: np.ndarray | None = None

    def scaled(self, total: float) -> np.ndarray:
        """Rescale to reference-style score units (e.g. N·INITIAL_SCORE
        so a uniform result reads 1000 per peer)."""
        return self.scores * total


def _history(hist: torch.Tensor, iterations: int) -> np.ndarray:
    """The one post-convergence fetch of the device residual history,
    sliced to the iterations actually run."""
    return hist.cpu().numpy().astype(np.float64)[: int(iterations)]


def _initial_vector(t0, p: np.ndarray) -> np.ndarray:
    """The starting vector: the caller's warm start ``t0`` clipped at 0
    and L1-renormalized, or the pre-trust vector ``p`` when ``t0`` is
    absent, mis-shaped, or degenerate (the reference's rules)."""
    if t0 is None:
        return p
    t0 = np.asarray(t0, dtype=np.float32).reshape(-1)
    if t0.shape != p.shape or not np.isfinite(t0).all():
        return p
    # Converged score vectors carry ±1-ulp negative dust on zero-score
    # peers (compensated-sum differencing); clip rather than reject.
    t0 = np.maximum(t0, 0.0)
    s = float(t0.sum())
    if not np.isfinite(s) or s <= 0:
        return p
    return t0 / np.float32(s)


def _result(out: tuple, name: str, record_residuals: bool) -> ConvergenceResult:
    t, it, resid = out[:3]
    return ConvergenceResult(
        scores=t.cpu().numpy().astype(np.float64),
        iterations=int(it),
        residual=float(resid),
        backend=name,
        residuals=_history(out[3], it) if record_residuals else None,
    )


class TrustBackend:
    name = "abstract"

    def __init__(self, device=None):
        #: The device every converge runs on (``None`` → CUDA or raise).
        self.device = resolve_device(device)

    def _vectors(self, graph: TrustGraph, dangling: np.ndarray, t0):
        """``(t0, p, dangling)`` as float32 tensors on the device."""
        p = graph.pre_trust_vector()
        return tuple(
            torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.device)
            for a in (_initial_vector(t0, p), p, dangling)
        )

    def converge(
        self,
        graph: TrustGraph,
        *,
        alpha: float = 0.0,
        tol: float = 1e-6,
        max_iter: int = 50,
        record_residuals: bool = True,
        t0: np.ndarray | None = None,
    ) -> ConvergenceResult:
        raise NotImplementedError


class NativeCPUBackend(TrustBackend):
    """Exact rational dense power iteration on the host — small sets only.

    With ``alpha=0`` and ``max_iter=I`` this is the reference kernel
    modulo normalisation: it iterates the row-normalised matrix exactly
    like ``native()`` iterates the SCALE-summing ops matrix
    (circuit/src/circuit.rs:434-454), with dangling rows redirected to
    the pre-trust vector.  It runs on the CPU by name and never asks for
    the card."""

    name = "native-cpu"

    def __init__(self):
        self.device = torch.device("cpu")

    def converge(self, graph, *, alpha=0.0, tol=1e-6, max_iter=50,
                 record_residuals=True, t0=None):
        g = graph.drop_self_edges()
        dense = g.to_dense()
        n = g.n
        # Exact pre-trust vector (the float pre_trust_vector() is this
        # same distribution rounded to f32).
        if graph.pre_trusted is not None and graph.pre_trusted.any():
            cnt = int(graph.pre_trusted.sum())
            p = [
                Fraction(1, cnt) if graph.pre_trusted[i] else Fraction(0)
                for i in range(n)
            ]
        else:
            p = [Fraction(1, n)] * n
        # Exact rational row-normalised matrix with dangling → p.
        rows: list[list[Fraction]] = []
        row_sums = dense.sum(axis=1)
        for i in range(n):
            if row_sums[i] <= 0:
                rows.append([p[j] for j in range(n)])
            else:
                s = Fraction(row_sums[i])
                rows.append([Fraction(dense[i][j]) / s for j in range(n)])
        a = Fraction(alpha).limit_denominator(10**9)
        # Warm start: rationalise the seed exactly like alpha; the
        # fixed point is start-independent, only the path shortens.
        pf = np.array([float(x) for x in p], dtype=np.float32)
        start = _initial_vector(t0, pf)
        if start is pf:
            t = list(p)
        else:
            raw = [Fraction(float(x)).limit_denominator(10**12) for x in start]
            s = sum(raw)
            t = [x / s for x in raw] if s > 0 else list(p)
        it = 0
        resid = Fraction(0)
        history: list[float] = []
        for it in range(1, max_iter + 1):
            new_t = [
                (1 - a) * sum(rows[j][i] * t[j] for j in range(n)) + a * p[i]
                for i in range(n)
            ]
            resid = sum(abs(x - y) for x, y in zip(new_t, t))
            if record_residuals:
                history.append(float(resid))
            t = new_t
            if tol > 0 and resid < tol:
                break
        return ConvergenceResult(
            scores=np.array([float(x) for x in t], dtype=np.float64),
            iterations=it,
            residual=float(resid),
            backend=self.name,
            residuals=np.array(history) if record_residuals else None,
        )


class DenseTorchBackend(TrustBackend):
    """Dense matrix-vector power iteration (``ops.dense.converge_dense``)
    over the host-built damped matrix, for sets up to ~10k peers."""

    name = "cuda-dense"

    def converge(self, graph, *, alpha=0.0, tol=1e-6, max_iter=50,
                 record_residuals=True, t0=None):
        g = graph.drop_self_edges()
        dense = g.to_dense().astype(np.float32)
        row_sums = dense.sum(axis=1)
        p = graph.pre_trust_vector().astype(np.float32)
        dangling = row_sums <= 0
        norm = np.where(dangling[:, None], p[None, :], dense / np.where(dangling, 1.0, row_sums)[:, None])
        m = (1.0 - alpha) * norm.T + alpha * np.outer(p, np.ones(g.n, np.float32))
        dev = self.device
        t = torch.from_numpy(np.ascontiguousarray(_initial_vector(t0, p))).to(dev)
        m = torch.from_numpy(m.astype(np.float32)).to(dev)
        it = 0
        resid = np.inf
        history: list[float] = []
        # Fixed-size chunks with host-side residual checks between them,
        # as the reference runs compiled scan chunks: the residual
        # trajectory is chunk-granular here (one entry per host check).
        chunk = 8 if tol > 0 else max_iter
        while it < max_iter:
            steps = min(chunk, max_iter - it)
            t_new = converge_dense(m, t, steps)
            t_new = t_new / torch.sum(t_new)
            resid = float(torch.sum(torch.abs(t_new - t)))
            if record_residuals:
                history.append(resid)
            t = t_new
            it += steps
            if tol > 0 and resid < tol:
                break
        return ConvergenceResult(
            scores=t.cpu().numpy().astype(np.float64),
            iterations=it,
            residual=resid,
            backend=self.name,
            residuals=np.array(history) if record_residuals else None,
        )


class SparseTorchBackend(TrustBackend):
    """COO SpMV (``ops.sparse.converge_sparse``) over the dst-sorted,
    row-normalised edge list."""

    name = "cuda-sparse"

    def converge(self, graph, *, alpha=0.0, tol=1e-6, max_iter=50,
                 record_residuals=True, t0=None):
        g = graph.drop_self_edges()
        w, dangling = g.row_normalized()
        g = TrustGraph(g.n, g.src, g.dst, w, graph.pre_trusted).sorted_by_dst()
        dev = self.device
        with TRACER.span("converge", backend=self.name):
            out = converge_sparse(
                torch.from_numpy(g.src).to(dev),
                torch.from_numpy(g.dst).to(dev),
                torch.from_numpy(g.weight).to(dev),
                *self._vectors(graph, dangling, t0),
                n=g.n,
                alpha=alpha,
                tol=tol,
                max_iter=max_iter,
                record_residuals=record_residuals,
            )
        return _result(out, self.name, record_residuals)


class CsrTorchBackend(TrustBackend):
    """Gather-only CSR/cumsum SpMV (``ops.sparse.power_step_csr``)."""

    name = "cuda-csr"

    def converge(self, graph, *, alpha=0.0, tol=1e-6, max_iter=50,
                 record_residuals=True, t0=None):
        g = graph.drop_self_edges()
        w, dangling = g.row_normalized()
        g = TrustGraph(g.n, g.src, g.dst, w, graph.pre_trusted).sorted_by_dst()
        dev = self.device
        with TRACER.span("converge", backend=self.name):
            out = converge_csr(
                torch.from_numpy(g.src).to(dev),
                torch.from_numpy(g.row_ptr_by_dst()).to(dev),
                torch.from_numpy(g.weight).to(dev),
                *self._vectors(graph, dangling, t0),
                alpha=alpha,
                tol=tol,
                max_iter=max_iter,
                record_residuals=record_residuals,
            )
        return _result(out, self.name, record_residuals)


class WindowedTorchBackend(TrustBackend):
    """Fused fixed-slot pipeline on the CUDA windowed gather.

    The ``WindowPlan`` is cached on the instance and revalidated by
    graph fingerprint; on a miss with a churn hint (``delta_rows``: the
    source peers whose out-edges changed since the cached plan's graph)
    it is delta-updated instead of rebuilt.  ``plan_outcomes`` counts
    this instance's ``reuse`` / ``delta`` / ``rebuild`` outcomes, which
    also land on ``eigentrust_plan_outcomes_total{outcome}`` and the
    journal."""

    name = "cuda-windowed"

    def __init__(self, plan: WindowPlan | None = None, device=None):
        super().__init__(device)
        #: Candidate plan to reuse (e.g. checkpoint-restored); replaced
        #: when its fingerprint doesn't match the converged graph.
        self.plan = plan
        #: The plan the last converge actually used (for persistence).
        self.last_plan: WindowPlan | None = plan
        #: Churn hint for the NEXT converge (a superset is fine);
        #: consumed (reset to None) by the converge.
        self.delta_rows: np.ndarray | None = None
        #: Plan outcomes of this backend's converges.
        self.plan_outcomes = {"reuse": 0, "delta": 0, "rebuild": 0}

    def _outcome(self, outcome: str, **fields) -> None:
        self.plan_outcomes[outcome] += 1
        PLAN_OUTCOMES.inc(outcome=outcome)
        JOURNAL.record("plan", outcome=outcome, backend=self.name, **fields)

    def _resolve_plan(self, g: TrustGraph, w: np.ndarray, fp: str) -> WindowPlan:
        """Reuse, delta-update, or rebuild the cached plan for the
        normalized graph — all on the host, before any device work."""
        plan, rows = self.plan, self.delta_rows
        self.delta_rows = None
        valid = plan is not None and getattr(plan, "version", 0) == PLAN_VERSION
        if valid and plan.fingerprint == fp:
            PLAN_REUSES.inc()
            self._outcome("reuse")
            return plan
        if valid and rows is not None:
            with TRACER.span("plan", backend=self.name, reason="delta"):
                delta = try_plan_delta(plan, g.src, g.dst, w, n=g.n, rows=rows, fingerprint=fp)
            if delta is not None:
                self._outcome("delta", rows=int(rows.size))
                return delta
        reason = "cold" if plan is None else ("stale-layout" if not valid else "fingerprint-miss")
        with TRACER.span("plan", backend=self.name, reason=reason):
            plan = build_window_plan(g.src, g.dst, w, n=g.n)
        PLAN_REBUILDS.inc()
        self._outcome("rebuild", reason=reason)
        return plan

    def converge(self, graph, *, alpha=0.0, tol=1e-6, max_iter=50,
                 record_residuals=True, t0=None):
        g = graph.drop_self_edges()
        w, dangling = g.row_normalized()
        fp = graph_fingerprint(g.n, g.src, g.dst, w)
        plan = self._resolve_plan(g, w, fp)
        self.plan = self.last_plan = plan
        with TRACER.span("converge", backend=self.name):
            out = converge_windowed(
                *plan.device_args(self.device),
                *self._vectors(graph, dangling, t0),
                n_rows=plan.n_rows,
                table_entries=plan.table_entries,
                alpha=alpha,
                tol=tol,
                max_iter=max_iter,
                record_residuals=record_residuals,
            )
        return _result(out, self.name, record_residuals)


class ShardedTorchBackend(TrustBackend):
    """Convergence over the ranks of a process group, kernel-selectable
    (``parallel/sharded.py::SHARDED_KERNELS``): ``cuda-csr`` shards the
    dst-sorted edge list, ``cuda-windowed`` the window plan's rows, with
    the ``WindowPlan`` cached, revalidated, delta-updated or rebuilt as
    ``cuda-windowed`` does (``plan``/``last_plan``/``delta_rows`` carry
    it to and from the node's checkpoints).

    Every rank constructs its own backend and converges the same graph.
    ``mesh`` is the rank's ``ShardGroup``; None takes the initialized
    default group at converge (``default_mesh``, raising where there is
    none) on this backend's ``device``."""

    name = "cuda-sharded"

    def __init__(self, mesh=None, kernel: str = "cuda-csr", device=None):
        if kernel not in _sharded.SHARDED_KERNELS:
            raise ValueError(
                f"unknown sharded kernel {kernel!r}; available: {sorted(_sharded.SHARDED_KERNELS)}"
            )
        super().__init__(mesh.device if mesh is not None and device is None else device)
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the mesh's device is {mesh.device}, not {self.device}")
        self.mesh = mesh
        self.kernel = kernel
        #: Candidate WindowPlan to reuse (cuda-windowed kernel only).
        self.plan: WindowPlan | None = None
        #: The plan the last converge actually used (for persistence).
        self.last_plan: WindowPlan | None = None
        #: Churn hint consumed by the next converge, as ``cuda-windowed``'s.
        self.delta_rows: np.ndarray | None = None
        #: Plan outcomes of this backend's converges.
        self.plan_outcomes = {"reuse": 0, "delta": 0, "rebuild": 0}

    def converge(self, graph, *, alpha=0.0, tol=1e-6, max_iter=50,
                 record_residuals=True, t0=None):
        mesh = self.mesh if self.mesh is not None else default_mesh(device=self.device)
        name = self.name if self.kernel == "cuda-csr" else f"{self.name}:{self.kernel}"
        problem: _sharded.ShardedTrustProblem | _sharded.ShardedWindowPlan
        if self.kernel == "cuda-windowed":
            candidate, rows = self.plan, self.delta_rows
            self.delta_rows = None
            with TRACER.span("plan", backend=name):
                problem = _sharded.ShardedWindowPlan.build(graph, mesh, plan=candidate, delta_rows=rows)
            outcome = problem.plan_outcome
            if outcome == "reuse":
                PLAN_REUSES.inc()
            elif outcome == "rebuild":
                PLAN_REBUILDS.inc()
            PLAN_OUTCOMES.inc(outcome=outcome)
            JOURNAL.record("plan", outcome=outcome, backend=name)
            self.plan_outcomes[outcome] += 1
            self.plan = self.last_plan = problem.plan
        else:
            problem = _sharded.ShardedTrustProblem.build(graph, mesh)
        start = None if t0 is None else _initial_vector(t0, graph.pre_trust_vector())
        with TRACER.span("converge", backend=name):
            out = _sharded.converge_sharded(
                problem, alpha=alpha, tol=tol, max_iter=max_iter,
                record_residuals=record_residuals, t0=start,
            )
        return _result(out, name, record_residuals)


# The hand-written kernels one power step of each card backend launches,
# by the wrapper that counts them (each wrapper's ``launches``).
_CSR_STEP = {"gather_ds_cumsum": 1, "block_total_scan": 1, "rowsum_tail": 1}
declare(KernelBudget("cuda-dense", {}, notes="torch.mv steps; no hand-written kernel"))
declare(KernelBudget("cuda-sparse", dict(_CSR_STEP), notes="the CSR step over the dst segments"))
declare(KernelBudget("cuda-csr", dict(_CSR_STEP)))
declare(
    KernelBudget(
        "cuda-windowed",
        {
            "gather_windowed": 1, "prefix_bridge": 1, "ds_cumsum_axis1": 1,
            "block_total_scan": 1, "rowsum_tail": 1,
        },
    )
)

# The memory each card backend's converge entry holds on its device
# (``analysis/memory``), from the port's own allocations.  Resident: the
# entry's arguments.  Transient, at the damping epilogue's peak: the
# loop's ``prev`` and ``t``, the step's ``ct`` and ``damp``'s three
# temporaries, six float32 N-vectors (24 B a peer).  The constant
# covers K6's block totals (two float32 a 2048-edge block, 256 KB at
# 64M edges) and the caching allocator's 512-byte rounding.  K9's two
# float32 lanes a padded edge (the CSR and COO steps) are an O(E)
# temporary this budget cannot express; ``analysis/memory/waivers.py``
# records them (ROADMAP B, K9).  A converge copies at most one scalar
# to the host at a time.
_TRANSIENT_CONST = 262144.0
declare_mem(
    MemBudget(
        "cuda-dense", resident_edge_bytes=4.0, resident_n=4.0, resident_const=4096.0,
        transient_n=8.0, transient_const=4096.0, staging_const=8.0,
        notes="converge_dense: the N x N matrix (E = N^2) and s0 resident; "
        "the old and new s of one torch.mv transient",
    )
)
declare_mem(
    MemBudget(
        "cuda-sparse", resident_edge_bytes=12.0, resident_n=12.0, resident_const=4096.0,
        transient_n=28.0, transient_const=_TRANSIENT_CONST, staging_const=8.0,
        notes="converge_sparse: src, dst, w and t0, p, dangling resident; the "
        "CSR converge's transient plus the derived row pointers (4 B a peer)",
    )
)
declare_mem(
    MemBudget(
        "cuda-csr", resident_edge_bytes=8.0, resident_n=16.0, resident_const=4096.0,
        transient_n=24.0, transient_const=_TRANSIENT_CONST, staging_const=8.0,
        notes="converge_csr: src, w, row_ptr and t0, p, dangling resident",
    )
)
declare_mem(
    MemBudget(
        "cuda-windowed", resident_rows=8196.0, resident_segments=9.0, resident_n=16.0,
        resident_const=4096.0, transient_rows=4100.0, transient_segments=12.0,
        transient_n=24.0, transient_const=_TRANSIENT_CONST, staging_const=8.0,
        notes="converge_windowed: the plan's wid, local, weight (8,196 B a row), "
        "seg_end, seg_first, seg_perm (9 B a run), dst_ptr and the vectors "
        "resident; transient: K1's gathered slots (4,096 B a row), row_run_ptr "
        "(4 B a row), K7's partials and K5's two lanes (12 B a run), the padded "
        "score table within the six N-vectors",
    )
)

_BACKENDS = {
    "native-cpu": NativeCPUBackend,
    "cuda-dense": DenseTorchBackend,
    "cuda-sparse": SparseTorchBackend,
    "cuda-csr": CsrTorchBackend,
    "cuda-windowed": WindowedTorchBackend,
    "cuda-sharded": ShardedTorchBackend,
}


def registered_backends() -> list[str]:
    """Every constructible backend name, the sharded composites expanded
    (plain ``cuda-sharded`` is ``cuda-sharded:cuda-csr``)."""
    names: list[str] = []
    for base in _BACKENDS:
        if base == "cuda-sharded":
            names.extend(f"{base}:{kernel}" for kernel in sorted(_sharded.SHARDED_KERNELS))
        else:
            names.append(base)
    return names


def backend_class(name: str) -> tuple[type, str | None]:
    """The backend class a name selects and its per-shard kernel suffix
    (None without one); raises ``ValueError`` for a name outside the
    ladder, a ``tpu-*`` name of the reference's ladder included."""
    base, _, kernel = name.partition(":")
    if kernel and base != "cuda-sharded":
        raise ValueError(
            f"unknown trust backend {name!r}; only cuda-sharded takes a "
            f":<kernel> suffix (available: {sorted(_BACKENDS)})"
        )
    try:
        return _BACKENDS[base], kernel or None
    except KeyError:
        raise ValueError(
            f"unknown trust backend {name!r}; available: {sorted(_BACKENDS)}"
        ) from None


def get_backend(name: str, **kwargs) -> TrustBackend:
    """Construct a backend by name; ``device`` (default: the card; not
    taken by ``native-cpu``) and the backend's own arguments pass
    through.  ``cuda-sharded`` alone takes a per-shard kernel suffix,
    ``cuda-sharded:cuda-windowed``."""
    cls, kernel = backend_class(name)
    if kernel:
        kwargs.setdefault("kernel", kernel)
    return cls(**kwargs)
