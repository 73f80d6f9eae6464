"""The runtime legs' cases: each card backend's converge entry and its
power step, on device tensors built from a seeded graph.

The jaxpr and HLO legs of the reference trace or compile a backend's
step on a synthetic graph (``scale_free(1500, 9000, seed=2)`` with the
out-edges of peers 0, 17 and 1499 dropped, so some rows dangle,
``protocol_tpu/analysis/invariants.py:63-71``).  The port has nothing
to trace, so its legs run the same graph instead: ``step_graph`` makes
it, and ``build_case`` lays one backend out on a device, as its
converge entry takes it:

- ``cuda-dense``: ``ops.dense.converge_dense`` over the normalised
  N x N matrix (the edge dimension of its budgets is N^2);
- ``cuda-sparse``: ``ops.sparse.converge_sparse`` over the dst-sorted
  COO edges; its step is the CSR step over the dst segments the
  converge derives once;
- ``cuda-csr``: ``ops.sparse.converge_csr``;
- ``cuda-windowed``: ``ops.gather_window.converge_windowed`` over the
  graph's ``WindowPlan``; its step takes the run pointers the converge
  derives once;
- ``cuda-sharded:<kernel>``: ``parallel.sharded.converge_sharded`` over
  this rank's shard, its step ``sharded_step``; the caller has joined a
  process group (``single_rank_group`` or ``run_ranks``).

A case's ``args`` are the tensors its converge entry holds for the whole
call (the memory leg's resident bytes); ``step(t)`` is one power step
and ``converge(max_iter, tol)`` the entry itself.
"""

from __future__ import annotations

import contextlib
import pathlib
import tempfile
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

#: The reference's synthetic graph: ``scale_free(1500, 9000, seed=2)``.
STEP_GRAPH = (1500, 9000, 2)
#: The damping the steps and converges run at.
ALPHA = 0.1


def step_graph(n: int = STEP_GRAPH[0], nnz: int = STEP_GRAPH[1], seed: int = STEP_GRAPH[2]):
    """The reference analyzers' synthetic graph, or one of its shape at
    another size: ``scale_free(n, nnz, seed)`` without the out-edges of
    peers 0, 17 and n - 1."""
    from ..models.graphs import scale_free
    from ..trust.graph import TrustGraph

    g = scale_free(n, nnz, seed=seed)
    keep = ~np.isin(g.src, np.asarray([0, 17, n - 1], dtype=np.int32))
    return TrustGraph(g.n, g.src[keep], g.dst[keep], g.weight[keep], g.pre_trusted)


def launch_counts() -> dict[str, int]:
    """Every kernel's launches in this process so far, by wrapper."""
    return {name: w.launches for name, w in kernel_wrappers().items()}


def launches_since(before: dict[str, int]) -> dict[str, int]:
    """Launches by wrapper since ``before`` (a ``launch_counts()``)."""
    return {name: n - before.get(name, 0) for name, n in launch_counts().items()}


def kernel_wrappers() -> dict[str, Callable]:
    """Every kernel wrapper the runtime legs run, by name (each counts its
    launches in ``launches``): the converge's, as
    ``KernelBudget.launches_per_step`` names them, then the graft
    prover's, as ``ZkKernelBudget.wrapper`` does."""
    from ..ops import gather_window as gw
    from ..ops import sparse as sp
    from ..zk.graft import field, ntt, pippenger

    return {
        fn.__name__: fn
        for fn in (
            gw.gather_windowed, gw.prefix_bridge, sp.ds_cumsum_axis1,
            sp.block_total_scan, sp.rowsum_tail, sp.gather_ds_cumsum,
            field.field_op, ntt.ntt_device, pippenger.msm_window, pippenger.msm_bucket,
        )
    }


@dataclass
class BackendCase:
    """One backend laid out on a device for its converge entry."""

    backend: str
    #: Budget dimensions: n, edges, n_segments, n_rows, n_shards.
    dims: dict[str, int]
    #: The converge entry's tensor arguments (held for the whole call).
    args: tuple[torch.Tensor, ...]
    #: The step's input vector (the pre-trust vector).
    t: torch.Tensor
    #: One power step of the converge's loop.
    step: Callable[[torch.Tensor], torch.Tensor]
    #: ``converge(max_iter, tol)`` -> ``(t, iterations, residual)``.
    converge: Callable[[int, float], tuple]
    meta: dict = field(default_factory=dict)

    @property
    def resident_bytes(self) -> int:
        """Bytes of the converge's arguments, each storage once."""
        seen, total = set(), 0
        for a in self.args:
            key = a.untyped_storage().data_ptr()
            if key not in seen:
                seen.add(key)
                total += a.untyped_storage().nbytes()
        return total


def _normalized(graph):
    """The backends' own preparation: self edges dropped, rows
    normalised, edges in dst order; and the float32 dangling mask."""
    from ..trust.graph import TrustGraph

    g = graph.drop_self_edges()
    w, dangling = g.row_normalized()
    gs = TrustGraph(g.n, g.src, g.dst, w, graph.pre_trusted).sorted_by_dst()
    return gs, dangling.astype(np.float32)


def _on(device, *arrays) -> tuple[torch.Tensor, ...]:
    """Each array as a tensor of its own on ``device`` (copied, so two
    arguments made from one array never share storage, on the CPU too)."""
    return tuple(torch.from_numpy(np.array(a)).to(device) for a in arrays)


def _dense(graph, device) -> BackendCase:
    from ..ops.dense import converge_dense

    g = graph.drop_self_edges()
    dense = g.to_dense().astype(np.float32)
    rows = dense.sum(axis=1)
    p = graph.pre_trust_vector().astype(np.float32)
    dangling = rows <= 0
    norm = np.where(dangling[:, None], p[None, :], dense / np.where(dangling, 1.0, rows)[:, None])
    m = (1.0 - ALPHA) * norm.T + ALPHA * np.outer(p, np.ones(g.n, np.float32))
    m_d, t0 = _on(device, m.astype(np.float32), p)

    def converge(max_iter, tol):
        t = converge_dense(m_d, t0, max_iter)
        return t, max_iter, torch.zeros((), dtype=t.dtype, device=t.device)

    return BackendCase(
        "cuda-dense", {"n": g.n, "edges": g.n * g.n, "n_shards": 1}, (m_d, t0), t0,
        lambda t: converge_dense(m_d, t, 1), converge,
    )


def _csr(graph, device, name: str) -> BackendCase:
    from ..ops import sparse as sp

    gs, dangling = _normalized(graph)
    p = graph.pre_trust_vector()
    alpha = torch.tensor(ALPHA, dtype=torch.float32, device=device)
    src, dst, w, row_ptr, t0, p_d, dang = _on(
        device, gs.src, gs.dst, gs.weight, gs.row_ptr_by_dst(), p, p, dangling
    )
    dims = {"n": gs.n, "edges": gs.nnz, "n_shards": 1}
    if name == "cuda-sparse":
        seg_src, seg_w, seg_ptr = sp.dst_segments(src, dst, w, n=gs.n)
        return BackendCase(
            name, dims, (src, dst, w, t0, p_d, dang), t0,
            lambda t: sp.power_step_csr(seg_src, seg_ptr, seg_w, t, p_d, dang, alpha),
            lambda max_iter, tol: sp.converge_sparse(
                src, dst, w, t0, p_d, dang, n=gs.n, alpha=ALPHA, tol=tol, max_iter=max_iter
            ),
        )
    return BackendCase(
        name, dims, (src, row_ptr, w, t0, p_d, dang), t0,
        lambda t: sp.power_step_csr(src, row_ptr, w, t, p_d, dang, alpha),
        lambda max_iter, tol: sp.converge_csr(
            src, row_ptr, w, t0, p_d, dang, alpha=ALPHA, tol=tol, max_iter=max_iter
        ),
    )


def _windowed(graph, device) -> BackendCase:
    from ..ops import gather_window as gw

    gs, dangling = _normalized(graph)
    plan = gw.build_window_plan(gs.src, gs.dst, gs.weight, n=gs.n)
    p = graph.pre_trust_vector()
    alpha = torch.tensor(ALPHA, dtype=torch.float32, device=device)
    plan_args = plan.device_args(device)
    t0, p_d, dang = _on(device, p, p, dangling)
    run_ptr = gw.row_run_ptr(plan_args[3], plan_args[4], plan.n_rows)
    kw = dict(n_rows=plan.n_rows, table_entries=plan.table_entries)
    return BackendCase(
        "cuda-windowed",
        {"n": gs.n, "edges": gs.nnz, "n_segments": plan.seg_capacity, "n_rows": plan.n_rows,
         "n_shards": 1},
        (*plan_args, t0, p_d, dang), t0,
        lambda t: gw.power_step_windowed(*plan_args, t, p_d, dang, alpha, run_ptr=run_ptr, **kw),
        lambda max_iter, tol: gw.converge_windowed(
            *plan_args, t0, p_d, dang, alpha=ALPHA, tol=tol, max_iter=max_iter, **kw
        ),
        meta={"plan_rows": plan.n_rows, "plan_segments": plan.n_segments},
    )


def _sharded(graph, device, kernel: str) -> BackendCase:
    from ..parallel import sharded as sh
    from ..parallel.mesh import default_mesh

    mesh = default_mesh(device=device)
    gs, _ = _normalized(graph)
    if kernel == "cuda-windowed":
        problem = sh.ShardedWindowPlan.build(graph, mesh)
        tensors = (problem.wid, problem.local, problem.weight, problem.seg_end,
                   problem.seg_first, problem.seg_perm, problem.dst_ptr, problem.run_ptr)
        dims = {"n_segments": int(problem.seg_end.shape[0]), "n_rows": problem.rows_per_shard}
    else:
        problem = sh.ShardedTrustProblem.build(graph, mesh)
        tensors = (problem.src, problem.w, problem.row_ptr)
        dims = {}
    alpha = torch.tensor(ALPHA, dtype=torch.float32, device=mesh.device)
    return BackendCase(
        f"cuda-sharded:{kernel}",
        {"n": gs.n, "edges": gs.nnz, "n_shards": mesh.size, **dims},
        (*tensors, problem.p, problem.dangling), problem.p,
        sh.sharded_step(problem, alpha),
        lambda max_iter, tol: sh.converge_sharded(
            problem, alpha=ALPHA, tol=tol, max_iter=max_iter
        ),
        meta={"rank": mesh.rank},
    )


def build_case(backend: str, graph, device) -> BackendCase:
    """``backend`` laid out for ``graph`` on ``device`` (a sharded
    composite on this rank's shard of the initialized group)."""
    if backend == "cuda-dense":
        return _dense(graph, device)
    if backend in ("cuda-sparse", "cuda-csr"):
        return _csr(graph, device, backend)
    if backend == "cuda-windowed":
        return _windowed(graph, device)
    base, _, kernel = backend.partition(":")
    if base == "cuda-sharded" and kernel:
        return _sharded(graph, device, kernel)
    raise ValueError(f"no runtime case for backend {backend!r}")


def card_backends() -> list[str]:
    """The registered backends that run on a device (all but the host's)."""
    from ..trust.backend import registered_backends
    from .budget import HOST_BACKENDS

    return [name for name in registered_backends() if name not in HOST_BACKENDS]


@contextlib.contextmanager
def host_threads(device):
    """One intra-op thread while the runtime legs run on the CPU: their
    graphs are small, and several processes of many threads each (the
    analyzer, its replay process, test workers) oversubscribe the cores.
    Every leg that compares bits runs at this one count.  A card leg
    keeps the caller's count."""
    device = torch.device(device)
    if device.type != "cpu":
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@contextlib.contextmanager
def single_rank_group(device):
    """A process group of one rank in this process, for the sharded
    composites' cases: ``nccl`` on the card (its all-reduce can be
    captured in a CUDA graph), ``gloo`` on the CPU.  Refuses to replace
    a group the caller already has."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized in this process")
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(prefix="analysis-group-") as tmp:
        if device.type == "cuda":
            torch.cuda.set_device(device.index or 0)
        dist.init_process_group(
            backend, init_method=f"file://{pathlib.Path(tmp) / 'store'}", rank=0, world_size=1
        )
        try:
            yield
        finally:
            dist.destroy_process_group()


__all__ = [
    "ALPHA",
    "BackendCase",
    "STEP_GRAPH",
    "build_case",
    "card_backends",
    "host_threads",
    "kernel_wrappers",
    "single_rank_group",
    "step_graph",
]
