"""Pod scale-out: each host builds the window plan of its own edges.

Counterpart of ``protocol_tpu/parallel/pod.py``.  ``ShardedWindowPlan``
cuts ONE window plan built over the whole graph, so one host pays the
whole O(E) plan build serially and holds the whole edge set.  A pod
inverts the order:

1. every process computes the same peer→host partition
   (``parallel.partition.HostPartition``: a rendezvous hash, no
   coordination round) and keeps only the edges whose **source** peer it
   owns;
2. each host builds a ``WindowPlan`` over its own edges only, so the
   pod's plan-build critical path is the slowest host's build, about
   ``build(E) / n_hosts``;
3. the hosts agree on the shard shape (``rows_per_shard``, ``s_max``:
   two element-wise maxima over the group), and each cuts its plan with
   the same BLOCK_ROWS-aligned cut as the single-host path
   (``sharded._partition_plan_arrays``);
4. each host keeps its shard on its own device — nothing is gathered and
   no edge byte crosses hosts — and the pod runs the same
   ``converge_sharded`` windowed runner: the shard's partial ``Cᵀt``
   and one ``all_reduce_sum`` of ``f32[n]`` a step over the whole group.

A host is one process with one device (the card, or the CPU when
asked), so a host holds one shard (``PodContext.local_shards`` is 1);
the reference's hosts each cut their plan across a block of local
devices.

Churn stays partition-local: the protocol's churn unit is a sender's
out-row rewrite and a source peer's edges live on one host, so a host
whose peers saw no churn revalidates its local fingerprint and reuses
its plan (``ops.gather_window.partition_delta``).

``dangling`` (a peer with no out-edges anywhere) is the one globally
coupled input: every process derives it from its copy of the whole
normalised graph.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..ops.gather_window import (
    BLOCK_ROWS,
    PLAN_VERSION,
    ROW,
    WindowPlan,
    build_window_plan,
    graph_fingerprint,
    partition_delta,
    try_plan_delta,
)
from ..trust.graph import TrustGraph
from .mesh import ShardGroup, default_mesh
from .partition import HostPartition
from .sharded import ShardedWindowPlan, _normalized, _on, _partition_plan_arrays, _shard_on


@dataclass(frozen=True)
class PodContext:
    """One process's view of the pod: its host id, the pod size, its
    rank of the process group and the shared peer→host partition.  Every
    process builds the same context from its own ``torch.distributed``
    state: no leader election, no membership exchange."""

    host_id: int
    n_hosts: int
    mesh: ShardGroup
    partition: HostPartition

    @classmethod
    def current(cls, *, seed: int = 0, device=None) -> "PodContext":
        """The pod as the initialized process group sees it: one host a
        rank, ``host_id`` the rank and ``n_hosts`` the world size, the
        rank's device from ``mesh.rank_device(device, rank)``."""
        mesh = default_mesh(device=device)
        return cls(
            host_id=mesh.rank,
            n_hosts=mesh.size,
            mesh=mesh,
            partition=HostPartition(mesh.size, seed=seed),
        )

    @property
    def local_shards(self) -> int:
        """Shards a host holds: one, on its one device."""
        return self.mesh.size // self.n_hosts


def _pod_max(ctx: PodContext, values: np.ndarray) -> np.ndarray:
    """The element-wise max of an int64 vector over the pod's hosts: the
    shape agreement (every shard must have the same shape).  A 1-host pod
    short-circuits; otherwise one ``all_reduce(MAX)`` of the vector, on
    the host under gloo, on the rank's device under NCCL."""
    values = np.asarray(values, np.int64)
    if ctx.n_hosts == 1:
        return values
    device = "cpu" if ctx.mesh.backend == "gloo" else ctx.mesh.device
    x = torch.from_numpy(values.copy()).to(device)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=ctx.mesh.group)
    return x.cpu().numpy()


@dataclass
class PodWindowPlan(ShardedWindowPlan):
    """One host's shard of the pod's windowed layout: a
    ``ShardedWindowPlan`` (``converge_sharded`` runs it as one), cut
    from this host's own plan, plus the pod's bookkeeping: the agreed
    run capacity, which host this is, the peer→host owner map, the
    edges this host holds and how long its plan build took (the pod's
    plan-build critical path is the max of these)."""

    s_max: int = 0  # the pod's agreed per-shard run capacity
    interpret: bool = False  # the steps run the plain versions (a CPU host)
    host_id: int = 0
    n_hosts: int = 1
    owner: np.ndarray | None = None  # (n,) int32 peer→host owner map
    local_edges: int = 0  # edges this host's partition holds
    build_seconds: float = 0.0  # local plan construction wall-clock
    #: The barrier probe: when this host entered the shape agreement
    #: (the caller's monotonic clock) and how long both agreement rounds
    #: blocked.  The pod trace stitcher (``obs.podtrace``) aligns the
    #: hosts' enter stamps into the barrier-arrival spread.  0.0 without
    #: a clock.
    barrier_enter_monotonic: float = 0.0
    barrier_wait_seconds: float = 0.0
    #: One monotonic↔wall clock-sync sample taken at build entry (both
    #: clocks read back to back), a sample for the stitcher's per-host
    #: offset estimate.  0.0 without injected clocks.
    sync_monotonic: float = 0.0
    sync_unix: float = 0.0

    @classmethod
    def build(
        cls,
        graph: TrustGraph,
        pod: PodContext,
        *,
        plan: WindowPlan | None = None,
        delta_rows: np.ndarray | None = None,
        clock: Callable[[], float] | None = None,
        wall: Callable[[], float] | None = None,
    ) -> "PodWindowPlan":
        """Partition the graph by source-peer owner, resolve this host's
        local plan (reuse, delta or rebuild against the local
        fingerprint: churn owned by other hosts leaves it untouched),
        agree on the shard shape with the other hosts and move this
        host's shard to its device.  ``plan`` is this host's cached
        local plan; ``delta_rows`` the global churn hint, clipped to the
        owned rows here.  ``clock`` is the caller's monotonic clock, for
        ``build_seconds`` and the barrier probe; ``wall`` its wall clock,
        read back to back with ``clock`` at entry for the clock-sync
        sample.  Without them those fields stay 0.0."""
        sync_monotonic = clock() if clock is not None else 0.0
        sync_unix = wall() if wall is not None else 0.0
        g, dangling = _normalized(graph)
        owner = pod.partition.assign_ids(g.n)
        owned_rows, lsrc, ldst, lw = partition_delta(
            delta_rows, g.src, g.dst, g.weight, owner, pod.host_id
        )
        fp = graph_fingerprint(g.n, lsrc, ldst, lw)
        outcome = "reuse"
        build_seconds = 0.0
        valid = plan is not None and getattr(plan, "version", 0) == PLAN_VERSION
        if not (valid and plan.fingerprint == fp):
            t_build = clock() if clock is not None else 0.0
            delta = None
            if valid and owned_rows is not None and owned_rows.size:
                delta = try_plan_delta(
                    plan, lsrc, ldst, lw, n=g.n, rows=owned_rows, fingerprint=fp
                )
            if delta is not None:
                plan, outcome = delta, "delta"
            else:
                plan = build_window_plan(lsrc, ldst, lw, n=g.n)
                outcome = "rebuild"
            if clock is not None:
                build_seconds = clock() - t_build

        # The shape agreement, two rounds: row capacity first (the run
        # cut depends on it), then the per-shard run capacity.  The first
        # round is the pod's barrier: the first host to arrive waits for
        # the last, so the hosts' aligned enter stamps are the arrival
        # spread and the time over both rounds is this host's wait.
        L = pod.local_shards
        min_rps = -(-plan.n_rows // (L * BLOCK_ROWS)) * BLOCK_ROWS
        barrier_enter = clock() if clock is not None else 0.0
        rows_per_shard = int(_pod_max(pod, np.asarray([min_rps]))[0])
        live_end = plan.seg_end[: plan.n_segments]
        counts = np.bincount((live_end // ROW) // rows_per_shard, minlength=L)
        min_smax = -(-max(int(counts.max()), 1) // 1024) * 1024
        s_max = int(_pod_max(pod, np.asarray([min_smax]))[0])
        barrier_wait = clock() - barrier_enter if clock is not None else 0.0

        parts = _partition_plan_arrays(plan, L, rows_per_shard=rows_per_shard, s_max=s_max)
        mesh = pod.mesh
        return cls(
            **_shard_on(mesh, parts, 0),
            n=plan.n,
            table_entries=plan.table_entries,
            p=_on(mesh, graph.pre_trust_vector()),
            dangling=_on(mesh, dangling.astype(np.float32)),
            plan=plan,
            plan_outcome=outcome,
            s_max=s_max,
            interpret=mesh.device.type == "cpu",
            host_id=pod.host_id,
            n_hosts=pod.n_hosts,
            owner=owner,
            local_edges=int(lsrc.shape[0]),
            build_seconds=build_seconds,
            barrier_enter_monotonic=barrier_enter,
            barrier_wait_seconds=barrier_wait,
            sync_monotonic=sync_monotonic,
            sync_unix=sync_unix,
        )

    def t0(self) -> torch.Tensor:
        """A fresh device copy of the pre-trust vector."""
        return self.p.clone()


__all__ = ["PodContext", "PodWindowPlan"]
