"""TrustBackend on PyTorch — the port's execution backends.

Port of ``protocol_tpu/trust/backend.py`` for the backends of this
slice:

- ``cuda-csr``       gather-only CSR / compensated-cumsum SpMV
  (``ops.sparse.converge_csr``).
- ``cuda-windowed``  the fused fixed-slot pipeline on the hand-written
  CUDA windowed gather (``ops.gather_window.converge_windowed``), with
  the host-built ``WindowPlan`` cached and revalidated by graph
  fingerprint, delta-updated from a churn hint, or rebuilt.

Each backend runs on ``device``: ``None`` means CUDA and raises where
there is no card; ``device="cpu"`` runs the plain versions (the tests).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..ops.gather_window import (
    PLAN_VERSION,
    WindowPlan,
    build_window_plan,
    converge_windowed,
    graph_fingerprint,
    try_plan_delta,
)
from ..ops.sparse import converge_csr
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


class CsrTorchBackend(TrustBackend):
    """Gather-only CSR/cumsum SpMV (``ops.sparse.power_step_csr``)."""

    name = "cuda-csr"

    def converge(self, graph, *, alpha=0.0, tol=1e-6, max_iter=50,
                 record_residuals=True, t0=None):
        g = graph.drop_self_edges()
        w, dangling = g.row_normalized()
        g = TrustGraph(g.n, g.src, g.dst, w, graph.pre_trusted).sorted_by_dst()
        dev = self.device
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
    each converge's ``reuse`` / ``delta`` / ``rebuild``."""

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

    def _resolve_plan(self, g: TrustGraph, w: np.ndarray, fp: str) -> WindowPlan:
        """Reuse, delta-update, or rebuild the cached plan for the
        normalized graph — all on the host, before any device work."""
        plan, rows = self.plan, self.delta_rows
        self.delta_rows = None
        valid = plan is not None and getattr(plan, "version", 0) == PLAN_VERSION
        if valid and plan.fingerprint == fp:
            self.plan_outcomes["reuse"] += 1
            return plan
        if valid and rows is not None:
            delta = try_plan_delta(plan, g.src, g.dst, w, n=g.n, rows=rows, fingerprint=fp)
            if delta is not None:
                self.plan_outcomes["delta"] += 1
                return delta
        self.plan_outcomes["rebuild"] += 1
        return build_window_plan(g.src, g.dst, w, n=g.n)

    def converge(self, graph, *, alpha=0.0, tol=1e-6, max_iter=50,
                 record_residuals=True, t0=None):
        g = graph.drop_self_edges()
        w, dangling = g.row_normalized()
        fp = graph_fingerprint(g.n, g.src, g.dst, w)
        plan = self._resolve_plan(g, w, fp)
        self.plan = self.last_plan = plan
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


_BACKENDS = {
    "cuda-csr": CsrTorchBackend,
    "cuda-windowed": WindowedTorchBackend,
}


def registered_backends() -> list[str]:
    """Every constructible backend name."""
    return list(_BACKENDS)


def get_backend(name: str, **kwargs) -> TrustBackend:
    """Construct a backend by name; ``device`` (default: the card) and
    the backend's own arguments pass through."""
    try:
        cls = _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown trust backend {name!r}; available: {sorted(_BACKENDS)}"
        ) from None
    return cls(**kwargs)
