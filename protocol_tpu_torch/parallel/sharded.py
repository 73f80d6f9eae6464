"""Edge-sharded trust convergence over the ranks of a process group.

Counterpart of ``protocol_tpu/parallel/sharded.py``, with processes as
devices.  Every rank runs the same program (SPMD) on its own device:

- **the host layout** is the reference's, in numpy and bit for bit:
  ``problem_arrays`` (``ShardedTrustProblem.build``'s dst sort, padding
  to a multiple of the world size and per-shard clipped row pointers)
  and ``_partition_plan_arrays`` (the window plan cut into contiguous,
  BLOCK_ROWS-aligned row slices).  Each rank computes it from the same
  inputs and moves **only its own shard** to its device, each array a
  tensor of its own; ``p`` and ``dangling`` are replicated.
- **a step** runs the single-card kernels over the rank's shard — the
  CSR step's ``gathered_rowsum`` (K9, K6, K8) or the windowed step's
  ``windowed_ct`` (K1, K7, K5, K6, K8) — which gives the rank's partial
  ``Cᵀt``.  Destinations whose edges (or runs) straddle a shard cut are
  partially summed on each side; exactly one ``all_reduce_sum`` a step,
  the ``lax.psum`` of the reference, completes them.  Then the shared
  ``damp`` epilogue runs on the replicated result, so every rank holds
  the same bits of ``t`` and takes the same exit decision.

Two kernels share this recipe (``SHARDED_KERNELS``, selected as
``cuda-sharded:<kernel>``): ``cuda-csr`` (``ShardedTrustProblem``) and
``cuda-windowed`` (``ShardedWindowPlan``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..analysis.budget import CommBudget, KernelBudget, declare, declare_comm
from ..ops.gather_window import (
    BLOCK_ROWS,
    PLAN_VERSION,
    ROW,
    WindowPlan,
    _counting_sort,
    build_window_plan,
    graph_fingerprint,
    row_run_ptr,
    try_plan_delta,
    windowed_ct,
)
from ..ops.sparse import damp, gathered_rowsum, run_power_iteration
from ..trust.graph import TrustGraph
from .mesh import ShardGroup


def all_reduce_sum(x: torch.Tensor, mesh: ShardGroup) -> torch.Tensor:
    """``x`` summed over the ranks of ``mesh``, in place and returned:
    one ``dist.all_reduce(SUM)``.  Adds one to ``all_reduce_sum.calls``
    and ``x``'s bytes to ``all_reduce_sum.bytes``."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    all_reduce_sum.calls += 1
    all_reduce_sum.bytes += x.numel() * x.element_size()
    return x


#: All-reduces in this process, and their bytes.
all_reduce_sum.calls = 0  # type: ignore[attr-defined]
all_reduce_sum.bytes = 0  # type: ignore[attr-defined]


def _on(mesh: ShardGroup, a: np.ndarray) -> torch.Tensor:
    """``a`` as a tensor of its own on the rank's device: a shard is
    never a view into the whole, so it starts on an allocation boundary
    (K9 reads ``w`` and ``src`` 16 bytes at a time)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device, copy=True)


def _normalized(graph: TrustGraph) -> tuple[TrustGraph, np.ndarray]:
    """Self edges dropped, rows normalised: the graph and its dangling mask."""
    g = graph.drop_self_edges()
    w, dangling = g.row_normalized()
    return TrustGraph(g.n, g.src, g.dst, w, g.pre_trusted), dangling


def problem_arrays(graph: TrustGraph, n_shards: int) -> dict:
    """The host half of ``ShardedTrustProblem.build``, for all shards:
    the dst-sorted, zero-padded ``src`` and ``w`` (``E_pad``, a multiple
    of ``n_shards``), the per-shard row pointers ``row_ptr``
    (``(n_shards, n + 1)``, the global pointers clipped to each shard's
    slice and rebased to it), ``p``, ``dangling`` and ``n``, equal to the
    reference's arrays.  The dst sort is the stable counting sort, the
    order ``TrustGraph.sorted_by_dst`` gives."""
    g, dangling = _normalized(graph)
    order, _, _ = _counting_sort(g.dst, g.n)
    g = TrustGraph(g.n, g.src[order], g.dst[order], g.weight[order], g.pre_trusted)
    pad = (-g.nnz) % n_shards
    src = np.concatenate([g.src, np.zeros(pad, np.int32)])
    w = np.concatenate([g.weight, np.zeros(pad, np.float32)])
    # A destination whose edges straddle a shard cut gets a partial range
    # on both sides; the all-reduce completes it.  Pad slots (w = 0) lie
    # beyond every clipped pointer.
    gptr = g.row_ptr_by_dst().astype(np.int64)
    m = (g.nnz + pad) // n_shards
    starts = np.arange(n_shards, dtype=np.int64)[:, None] * m
    row_ptr = (np.clip(gptr[None, :], starts, starts + m) - starts).astype(np.int32)
    return {
        "n": g.n, "src": src, "w": w, "row_ptr": row_ptr,
        "p": graph.pre_trust_vector(), "dangling": dangling.astype(np.float32),
    }


@dataclass
class ShardedTrustProblem:
    """One rank's shard of the dst-sorted edge list, on its device."""

    mesh: ShardGroup
    n: int
    src: torch.Tensor  # (E_pad / size,) int32, this rank's slice
    w: torch.Tensor  # (E_pad / size,) f32, row-normalised
    row_ptr: torch.Tensor  # (n + 1,) int32, this rank's clipped pointers
    p: torch.Tensor  # (n,) f32, replicated
    dangling: torch.Tensor  # (n,) f32, replicated

    @classmethod
    def build(cls, graph: TrustGraph, mesh: ShardGroup) -> "ShardedTrustProblem":
        """``problem_arrays`` on the host, then this rank's slice to its device."""
        a = problem_arrays(graph, mesh.size)
        m = a["src"].shape[0] // mesh.size
        cut = slice(mesh.rank * m, (mesh.rank + 1) * m)
        return cls(
            mesh=mesh, n=a["n"], src=_on(mesh, a["src"][cut]), w=_on(mesh, a["w"][cut]),
            row_ptr=_on(mesh, a["row_ptr"][mesh.rank]), p=_on(mesh, a["p"]),
            dangling=_on(mesh, a["dangling"]),
        )

    def partial_ct(self, t: torch.Tensor) -> torch.Tensor:
        """This shard's partial ``Cᵀt``: the CSR step's row sums."""
        return gathered_rowsum(self.w, t, self.src, self.row_ptr)


def _partition_plan_arrays(
    plan: WindowPlan,
    n_shards: int,
    *,
    rows_per_shard: int | None = None,
    s_max: int | None = None,
) -> dict:
    """Host-side partition of one ``WindowPlan`` into ``n_shards``
    contiguous, BLOCK_ROWS-aligned row slices, as the reference cuts it
    (bit for bit).  ``rows_per_shard`` and ``s_max`` may be forced
    upward by a caller that must agree on shapes with other hosts (a
    pod).  Returns the numpy shard tables and the resolved dimensions.

    Each shard's runs are its live runs, rebased to shard-local slots,
    then pad runs (``seg_end`` 0, ``seg_first`` True) up to ``s_max``;
    ``dst_ptr[k, n]`` is shard ``k``'s live run count, so no destination
    reaches a pad."""
    min_rps = -(-plan.n_rows // (n_shards * BLOCK_ROWS)) * BLOCK_ROWS
    if rows_per_shard is None:
        rows_per_shard = min_rps
    elif rows_per_shard < min_rps or rows_per_shard % BLOCK_ROWS:
        raise ValueError(
            f"rows_per_shard={rows_per_shard} cannot hold {plan.n_rows} "
            f"plan rows over {n_shards} shards (need >= {min_rps}, "
            f"BLOCK_ROWS-aligned)"
        )
    total_rows = n_shards * rows_per_shard
    wid = np.zeros(total_rows, np.int32)
    wid[: plan.n_rows] = plan.wid
    local = np.zeros((total_rows * 8, 128), np.int32)
    local[: plan.n_rows * 8] = plan.local
    weight = np.zeros((total_rows * 8, 128), np.float32)
    weight[: plan.n_rows * 8] = plan.weight

    # Bucket order is slot order, so the row cuts give contiguous
    # per-shard slices of the live runs; the plan's capacity pads are
    # regenerated per shard.
    live_end = plan.seg_end[: plan.n_segments]
    live_first = plan.seg_first[: plan.n_segments]
    shard_of = (live_end // ROW) // rows_per_shard
    counts = np.bincount(shard_of, minlength=n_shards)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    min_smax = -(-max(int(counts.max()), 1) // 1024) * 1024
    if s_max is None:
        s_max = min_smax
    elif s_max < min_smax:
        raise ValueError(
            f"s_max={s_max} below this plan's per-shard run count {min_smax}"
        )
    seg_dst = plan.seg_dst
    seg_end = np.zeros((n_shards, s_max), np.int32)
    seg_first = np.ones((n_shards, s_max), bool)
    seg_perm = np.zeros((n_shards, s_max), np.int32)
    dst_ptr = np.zeros((n_shards, plan.n + 1), np.int32)
    for k in range(n_shards):
        beg, end = int(offsets[k]), int(offsets[k + 1])
        sk = end - beg
        seg_end[k, :sk] = live_end[beg:end] - k * rows_per_shard * ROW
        seg_first[k, :sk] = live_first[beg:end]
        seg_perm[k, sk:] = np.arange(sk, s_max, dtype=np.int32)
        if sk:
            sperm, dst_counts, _ = _counting_sort(seg_dst[beg:end], plan.n)
            seg_perm[k, :sk] = sperm
            np.cumsum(dst_counts, out=dst_ptr[k, 1:])
    return {
        "rows_per_shard": rows_per_shard,
        "s_max": int(s_max),
        "wid": wid,
        "local": local,
        "weight": weight,
        "seg_end": seg_end,
        "seg_first": seg_first,
        "seg_perm": seg_perm,
        "dst_ptr": dst_ptr,
    }


def _resolve_plan(
    g: TrustGraph, plan: WindowPlan | None, delta_rows: np.ndarray | None
) -> tuple[WindowPlan, str]:
    """The plan of the normalised graph ``g`` and how it was resolved: the
    candidate ``plan`` where its layout version and fingerprint match
    (``reuse``), else delta-updated from the churn hint ``delta_rows``
    (``delta``), else built anew (``rebuild``)."""
    fp = graph_fingerprint(g.n, g.src, g.dst, g.weight)
    valid = plan is not None and getattr(plan, "version", 0) == PLAN_VERSION
    if valid and plan.fingerprint == fp:
        return plan, "reuse"
    if valid and delta_rows is not None:
        delta = try_plan_delta(
            plan, g.src, g.dst, g.weight, n=g.n, rows=delta_rows, fingerprint=fp
        )
        if delta is not None:
            return delta, "delta"
    return build_window_plan(g.src, g.dst, g.weight, n=g.n), "rebuild"


@dataclass
class ShardedWindowPlan:
    """One rank's slice of the window plan: the ``cuda-windowed`` kernel
    of ``converge_sharded``.

    The rank holds its ``rows_per_shard`` plan rows and its **live** runs
    only (``dst_ptr[rank, n]`` of them, or one pad run where there are
    none): ``prefix_bridge`` and ``row_run_ptr`` take the run ends sorted,
    and the partition's pad runs (end 0) follow the live ones.
    ``run_ptr`` is derived once, at build.  The whole ``plan`` is kept
    for the node's checkpoints."""

    mesh: ShardGroup
    n: int
    rows_per_shard: int
    table_entries: int
    wid: torch.Tensor  # (rows_per_shard,) int32
    local: torch.Tensor  # (rows_per_shard * 8, 128) int32
    weight: torch.Tensor  # (rows_per_shard * 8, 128) f32
    seg_end: torch.Tensor  # (runs,) int32, shard-local slots
    seg_first: torch.Tensor  # (runs,) bool
    seg_perm: torch.Tensor  # (runs,) int32, this shard's dst order
    dst_ptr: torch.Tensor  # (n + 1,) int32
    run_ptr: torch.Tensor  # (rows_per_shard + 1,) int32, row_run_ptr
    p: torch.Tensor  # (n,) f32, replicated
    dangling: torch.Tensor  # (n,) f32, replicated
    plan: WindowPlan
    plan_outcome: str  # reuse | delta | rebuild

    @classmethod
    def build(
        cls,
        graph: TrustGraph,
        mesh: ShardGroup,
        *,
        plan: WindowPlan | None = None,
        delta_rows: np.ndarray | None = None,
    ) -> "ShardedWindowPlan":
        """Normalise the graph, reuse, delta-update or build its
        ``WindowPlan`` (``_resolve_plan``), partition it over the group
        and move this rank's slice to its device."""
        g, dangling = _normalized(graph)
        plan, outcome = _resolve_plan(g, plan, delta_rows)
        parts = _partition_plan_arrays(plan, mesh.size)
        k, rps = mesh.rank, parts["rows_per_shard"]
        rows = slice(k * rps * 8, (k + 1) * rps * 8)
        # The live runs; a shard with none keeps its first pad run (end 0,
        # partial 0, beyond every destination), so every rank runs the
        # same kernels a step.
        runs = slice(0, max(int(parts["dst_ptr"][k, -1]), 1))
        seg_end = _on(mesh, parts["seg_end"][k, runs])
        seg_first = _on(mesh, parts["seg_first"][k, runs])
        return cls(
            mesh=mesh,
            n=plan.n,
            rows_per_shard=rps,
            table_entries=plan.table_entries,
            wid=_on(mesh, parts["wid"][k * rps:(k + 1) * rps]),
            local=_on(mesh, parts["local"][rows]),
            weight=_on(mesh, parts["weight"][rows]),
            seg_end=seg_end,
            seg_first=seg_first,
            seg_perm=_on(mesh, parts["seg_perm"][k, runs]),
            dst_ptr=_on(mesh, parts["dst_ptr"][k]),
            run_ptr=row_run_ptr(seg_end, seg_first, rps),
            p=_on(mesh, graph.pre_trust_vector()),
            dangling=_on(mesh, dangling.astype(np.float32)),
            plan=plan,
            plan_outcome=outcome,
        )

    def partial_ct(self, t: torch.Tensor) -> torch.Tensor:
        """This shard's partial ``Cᵀt``: the windowed step over its rows."""
        return windowed_ct(
            self.wid, self.local, self.weight, self.seg_end, self.seg_first, self.seg_perm,
            self.dst_ptr, t, n_rows=self.rows_per_shard, table_entries=self.table_entries,
            run_ptr=self.run_ptr,
        )


#: Kernels selectable under ``converge_sharded`` (``cuda-sharded:<kernel>``).
SHARDED_KERNELS: dict[str, type] = {
    "cuda-csr": ShardedTrustProblem,
    "cuda-windowed": ShardedWindowPlan,
}


def converge_sharded(
    problem: ShardedTrustProblem | ShardedWindowPlan,
    *,
    alpha: float = 0.1,
    tol: float = 1e-6,
    max_iter: int = 50,
    record_residuals: bool = False,
    t0: np.ndarray | None = None,
) -> tuple:
    """Damped power iteration to an L1 fixed point over the group, the
    kernel chosen by the problem's type (``SHARDED_KERNELS``).  ``t0``
    warm-starts it (replicated like ``p``); None starts from ``p``.

    Returns ``(t, iterations, residual)`` — ``t`` on the rank's device,
    the same bits on every rank — plus the device residual history with
    ``record_residuals``; ``tol <= 0`` runs exactly ``max_iter`` steps.
    A step is the shard's partial ``Cᵀt``, one ``all_reduce_sum``, then
    ``damp``, in ``run_power_iteration`` (exit rule
    ``(it < max_iter) & ((it == 0) | (resid > tol))``)."""
    mesh = problem.mesh
    alpha_t = torch.tensor(alpha, dtype=torch.float32, device=mesh.device)
    start = problem.p.clone() if t0 is None else _on(mesh, np.asarray(t0, np.float32))

    def step(t):
        ct = all_reduce_sum(problem.partial_ct(t), mesh)
        return damp(ct, t, problem.p, problem.dangling, alpha_t)

    out = run_power_iteration(
        step, start, tol=tol, max_iter=max_iter, record_residuals=record_residuals
    )
    t, it, resid = out[:3]
    if record_residuals:
        return t, int(it), float(resid), out[3]
    return t, int(it), float(resid)


# The kernels one step launches on each rank (per rank, per step), and
# the one all-reduce that completes the step.
declare(
    KernelBudget(
        "cuda-sharded:cuda-csr",
        {"gather_ds_cumsum": 1, "block_total_scan": 1, "rowsum_tail": 1},
        notes="per rank: the CSR step's row sums over the rank's edge slice",
    )
)
declare(
    KernelBudget(
        "cuda-sharded:cuda-windowed",
        {
            "gather_windowed": 1, "prefix_bridge": 1, "ds_cumsum_axis1": 1,
            "block_total_scan": 1, "rowsum_tail": 1,
        },
        notes="per rank: the windowed step over the rank's plan rows",
    )
)
for _kernel in SHARDED_KERNELS:
    declare_comm(
        CommBudget(
            f"cuda-sharded:{_kernel}",
            {"all_reduce_sum": 1},
            bytes_n=4.0,
            notes="one f32[n] all-reduce completes the partial Cᵀt a step; "
            "no term in E",
        )
    )
