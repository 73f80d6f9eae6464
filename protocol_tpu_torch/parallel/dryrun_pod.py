"""The pod's dry run: a churned epoch replay over host-sharded edge
partitions, and the pod's rank programs.

    python -m protocol_tpu_torch.parallel.dryrun_pod --hosts 2 --device cpu|cuda \\
        [--peers N] [--edges E] [--epochs K] [--churn 0.01] [--smoke] \\
        [--chaos-host-loss] [--resume --workdir DIR] [--out FILE]

Counterpart of ``tools/dryrun_pod.py``, with processes as hosts: the
parent starts ``--hosts`` ranks of one ``torch.distributed`` group
(``run_ranks`` over gloo: NCCL refuses two ranks on one card), each a
pod host on its device (``--device``; unset means the card, and the run
raises without one).  Each host derives the
same deterministic attestation stream (``models.churn`` sender-centric
epochs from ``scale_free(peers, edges, seed)``) and, per epoch,

- journals **only the churn rows whose source peer it owns**
  (``parallel.partition``) into its own WAL shard, fsyncs and
  acknowledges them (``acks-h*.jsonl``);
- builds its **local** window plan (``parallel.pod.PodWindowPlan``:
  reuse, delta or rebuild against its local fingerprint) and converges
  over the whole pod with a warm start from the previous fixed point
  (``converge_sharded``: one ``all_reduce_sum`` a step);
- checkpoints its shard, publishes its stamp, and host 0 seals the epoch
  (``node.pod.PodDurability``); each host publishes its epoch trace and
  metric snapshot, and host 0 stitches the pod trace (``obs.podtrace``)
  and serves it through the node's ``/trace/pod/latest`` route.

Each host counts its converges' kernel launches and all-reduces, each
set to 0 just before the converge and read just after, and holds them to
``KERNEL_INVARIANTS`` and ``COMM_INVARIANTS`` (``analysis/budget.py``;
on the CPU no kernel launches).  The parent requires every epoch's
residual and score digest to be the same on every host, bit for bit,
and runs the reference comparison in one more rank: the serial plan
build of the whole graph against the per-host builds
(``plan_build_speedup``) and a single-host cold converge of the final
graph, which the pod's warm fixed point must match within L1
``SCORE_TOL``.

``--chaos-host-loss`` adds the host-loss row: a second run in which host
1 leaves with ``os._exit`` after its WAL ack and before the converge
(``run_ranks`` then fails the launch and kills the other host), and a
relaunch of the whole pod with ``--resume`` from the newest sealed
manifest.  It requires zero acknowledged attestations lost (every acked
epoch past the manifest replays from the host's WAL shard with the same
payload digest) and a final fixed point bit-identical to the control
run's.

``--smoke`` takes the CI scale (2,048 peers, 16,384 edges, 3 epochs at
most).  The last line of standard output is one JSON summary; ``--out``
also writes the whole report.  Exit 0 only when every check holds.

The reference's AOT scrape of the compiled runner (its collective and
memory passes over the lowered module) has nothing to walk here; the
launch and all-reduce counts above stand in for it.  The pod's
observability verdict (the skew SLO, the straggler watcher and a seeded
straggler) is not run.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import struct
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..analysis.budget import COMM_INVARIANTS, KERNEL_INVARIANTS
from .dryrun import SOURCES, WRAPPERS, _graph, _sync, loaded_modules, step_wall_ms
from .launch import rank_schedule, run_ranks
from .mesh import ShardGroup
from .pod import PodContext, PodWindowPlan
from .sharded import ShardedWindowPlan, all_reduce_sum, converge_sharded

BACKEND = "cuda-sharded:cuda-windowed"

#: L1 bar for the pod's warm fixed point against a single-host cold one.
SCORE_TOL = 1e-4

#: The CI scale ``--smoke`` takes.
SMOKE = dict(peers=2048, edges=16384, epochs=3)

#: WAL record header: epoch u32, row u32, out-degree u32, then ``deg``
#: destinations (u32) and ``deg`` weights (f32).  Recovery re-derives
#: the row's out-edges from the record alone.
_HDR = struct.Struct("<III")


def encode_row(epoch: int, row: int, dst, w) -> bytes:
    dst = np.asarray(dst, "<u4")
    return _HDR.pack(epoch, row, dst.size) + dst.tobytes() + np.asarray(w, "<f4").tobytes()


def decode_row(payload: bytes):
    epoch, row, deg = _HDR.unpack_from(payload)
    off = _HDR.size
    dst = np.frombuffer(payload, "<u4", deg, off)
    w = np.frombuffer(payload, "<f4", deg, off + 4 * deg)
    return epoch, row, dst, w


def _jsonable(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON-serializable: {type(o)}")


# -- the deterministic stream: every host derives the same epochs ---------


def _epoch_rng(seed: int, epoch: int) -> np.random.Generator:
    # One generator an epoch, not one carried across epochs: any host,
    # one recovering from a crash too, regenerates epoch e without
    # replaying the epochs before it.
    return np.random.default_rng((seed + 1) * 1_000_003 + epoch)


def bootstrap_graph(params: dict):
    from ..models.graphs import scale_free

    return scale_free(params["peers"], params["edges"], seed=params["seed"]).drop_self_edges()


def churn_epoch(cur, epoch: int, params: dict):
    from ..models.churn import churn_cohort_dims, sender_centric_churn

    cohort_size, deg = churn_cohort_dims(cur, params["churn"])
    return sender_centric_churn(
        _epoch_rng(params["seed"], epoch), cur, cohort_size=cohort_size, deg=deg
    )


def _counted_converge(mesh: ShardGroup, podplan: PodWindowPlan, kw: dict, t0):
    """``converge_sharded(podplan, t0=t0, **kw)`` with every launch and
    all-reduce count set to 0 just before it and read just after: ``(t,
    iterations, residual, seconds, launches, all_reduce)``."""
    for w in WRAPPERS:
        w.launches = 0
    all_reduce_sum.calls = all_reduce_sum.bytes = 0
    _sync(mesh)
    t_conv = time.perf_counter()
    t, iters, resid = converge_sharded(podplan, t0=t0, **kw)
    _sync(mesh)
    seconds = time.perf_counter() - t_conv
    launches = {w.__name__: w.launches for w in WRAPPERS}
    comm = {"calls": all_reduce_sum.calls, "bytes": all_reduce_sum.bytes}
    return t, iters, resid, seconds, launches, comm


def budget_findings(mesh: ShardGroup, n: int, iterations: int, launches: dict,
                    comm: dict) -> list[str]:
    """Where a converge's launches and all-reduces differ from the pod
    backend's declared budgets (on the CPU the plain versions launch no
    kernel)."""
    want = dict.fromkeys(launches, 0)
    if mesh.device.type == "cuda":
        want.update(KERNEL_INVARIANTS[BACKEND].expected_launches(iterations))
    c = COMM_INVARIANTS[BACKEND].expected(iterations, n)
    findings = []
    if launches != want:
        findings.append(f"launched {launches}, expected {want}")
    if comm != {"calls": c["all_reduce_sum"], "bytes": c["bytes"]}:
        findings.append(f"all-reduced {comm}, expected {c}")
    return findings


# -- the worker: one pod host ------------------------------------------------


def worker_rank(mesh: ShardGroup, params: dict, state_dir: str, resume: bool = False,
                crash_host: int = -1, crash_epoch: int = -1) -> dict:
    """One pod host's epochs (module doc); returns its report."""
    from ..node.epoch import Epoch
    from ..node.pod import PodDurability
    from ..obs import metrics as obs_metrics
    from ..obs import podtrace as obs_podtrace
    from ..obs.fleet import publish_snapshot
    from ..obs.journal import JOURNAL
    from ..obs.trace import TRACER
    from ..trust.graph import TrustGraph

    pod = PodContext.current(seed=params["seed"], device=mesh.device)
    host = pod.host_id
    obs_metrics.POD_HOSTS.set(pod.n_hosts)
    obs_metrics.POD_HOST_ID.set(host)
    state = Path(state_dir)
    pd = PodDurability(state, host, pod.n_hosts)
    ack_path = state / f"acks-h{host:03d}.jsonl"
    fleet_dir = state / "fleet"
    flight_dir = state / "flight"
    flight_dir.mkdir(parents=True, exist_ok=True)
    kw = dict(alpha=0.1, tol=params["tol"], max_iter=params["max_iter"])

    # -- recovery: the newest sealed manifest and this host's own shards --
    start_epoch, scores, plan = 0, None, None
    last_seq = -1
    replayed: dict[int, dict] = {}
    recovery = manifest = snap = None
    if resume:
        t_rec = time.perf_counter()
        manifest = pd.load_manifest()
        lost: list[int] = []
        if manifest is not None:
            stamp = pd.my_stamp(manifest)
            snap = pd.checkpoints.load(Epoch(int(manifest["epoch"])))
            scores, plan = snap.scores, snap.plan
            start_epoch = int(manifest["epoch"]) + 1
            last_seq = int(stamp["wal_seq"])
            # The WAL tail past the sealed stamp, digested by epoch.
            tail: dict[int, "hashlib._Hash"] = {}
            tail_records = 0
            for seq, payload in pd.wal.replay(after_seq=last_seq):
                e = _HDR.unpack_from(payload)[0]
                tail.setdefault(e, hashlib.sha256()).update(payload)
                tail_records += 1
                last_seq = seq
            # Zero acknowledged loss: every acked epoch past the manifest
            # replays from this host's shard with the same digest.
            acks = []
            if ack_path.exists():
                acks = [json.loads(ln) for ln in ack_path.read_text().splitlines() if ln.strip()]
            for rec in acks:
                if rec["epoch"] <= int(manifest["epoch"]):
                    continue  # inside the checkpoint shard
                got = tail.get(rec["epoch"])
                if got is None or got.hexdigest() != rec["digest"]:
                    lost.append(rec["epoch"])
                else:
                    replayed[rec["epoch"]] = rec
            recovery = {
                "seconds": time.perf_counter() - t_rec,
                "manifest_epoch": int(manifest["epoch"]),
                "resume_epoch": start_epoch,
                "wal_tail_records": tail_records,
                "acked_epochs_replayed": sorted(replayed),
                "lost_acked_epochs": lost,
            }
        else:
            recovery = {"seconds": time.perf_counter() - t_rec, "resume_epoch": 0,
                        "cold": True, "lost_acked_epochs": lost}

    # -- the deterministic stream up to the resume point -----------------
    cur = bootstrap_graph(params)
    for e in range(1, start_epoch):
        _, cur, _ = churn_epoch(cur, e, params)
    owner = pod.partition.assign_ids(cur.n)
    if snap is not None:
        # The checkpoint shard must equal the stream's local partition,
        # column for column: recovery is reconstruction, not trust.
        m = owner[cur.src] == host
        g = snap.graph
        recovery["checkpoint_matches_stream"] = bool(
            np.array_equal(g.src, cur.src[m]) and np.array_equal(g.dst, cur.dst[m])
            and np.array_equal(g.weight, cur.weight[m])
        )

    epochs_detail = []
    ok = True
    for e in range(start_epoch, params["epochs"]):
        rows = None
        owned_count = 0
        if e > 0:
            rows, cur, (ns, nd, nw) = churn_epoch(cur, e, params)
        t_epoch = time.perf_counter()
        with TRACER.epoch(e):
            if e > 0:
                with TRACER.span("wal_flush"):
                    deg = ns.shape[0] // rows.shape[0]
                    owned_idx = np.flatnonzero(owner[rows] == host)
                    owned_count = int(owned_idx.size)
                    payloads = [
                        encode_row(e, int(rows[i]), nd[i * deg:(i + 1) * deg],
                                   nw[i * deg:(i + 1) * deg])
                        for i in owned_idx
                    ]
                    digest = hashlib.sha256(b"".join(payloads)).hexdigest()
                    if e in replayed:
                        # Durable and acknowledged before the crash, and the
                        # recovery audit saw the shard replay it: journaling
                        # it again would duplicate records.  The regenerated
                        # stream must still agree with what was acked.
                        if replayed[e]["digest"] != digest:
                            recovery.setdefault("replay_stream_mismatch", []).append(e)
                            ok = False
                    else:
                        for pbytes in payloads:
                            last_seq = pd.wal.append(pbytes, flush=False)
                        pd.wal.flush()
                        with ack_path.open("a") as f:
                            f.write(json.dumps({"epoch": e, "count": len(payloads),
                                                "digest": digest, "wal_to": last_seq}) + "\n")
                            f.flush()
                            os.fsync(f.fileno())
                if crash_host == host and crash_epoch == e:
                    # The kill -9 analog: acked data is on disk, nothing
                    # else is.  The flight ring dump is the last act.
                    JOURNAL.dump(flight_dir / f"flight-pod-h{host:03d}.jsonl",
                                 reason=f"crash-epoch-{e}")
                    os._exit(137)

            with TRACER.span("plan"):
                t_plan = time.perf_counter()
                # time.monotonic, so the barrier and sync stamps share a
                # clock with the clock_sync_samples() pairs the stitcher
                # aligns on.
                podplan = PodWindowPlan.build(cur, pod, plan=plan, delta_rows=rows,
                                              clock=time.monotonic, wall=time.time)
                plan_update_seconds = time.perf_counter() - t_plan
                plan = podplan.plan

            with TRACER.span("converge"):
                t, iters, resid, converge_seconds, launches, comm = _counted_converge(
                    mesh, podplan, kw, scores)
            scores = t.cpu().numpy()
            budget = budget_findings(mesh, podplan.n, iters, launches, comm)
            ok = ok and not budget

            # Durability: local shard checkpoint, then stamp, then host 0 seals.
            with TRACER.span("checkpoint"):
                m = owner[cur.src] == host
                lg = TrustGraph(cur.n, cur.src[m], cur.dst[m], cur.weight[m], cur.pre_trusted)
                pd.checkpoints.save(Epoch(e), lg, scores=scores, plan=plan, wal_seq=last_seq)
                entry = pd.checkpoints.manifest_entry(Epoch(e))
                sdig = hashlib.sha256(scores.tobytes()).hexdigest()
                pd.publish_shard(e, wal_seq=last_seq, columns=entry["columns"],
                                 extra={"scores_sha256": sdig, "residual": float(resid)})
            sealed = None
            if host == 0:
                with TRACER.span("seal"):
                    deadline = time.monotonic() + params["seal_timeout"]
                    while sealed is None and time.monotonic() < deadline:
                        sealed = pd.seal_epoch(e)
                        if sealed is None:
                            time.sleep(0.02)
                ok = ok and sealed is not None

        epoch_seconds = time.perf_counter() - t_epoch
        obs_metrics.POD_OWNED_PEERS.set(int((owner == host).sum()))
        obs_metrics.POD_LOCAL_EDGES.set(podplan.local_edges)
        obs_metrics.POD_PLAN_BUILD_SECONDS.set(podplan.build_seconds)
        obs_metrics.POD_PLAN_REUSED.inc(outcome=podplan.plan_outcome)
        obs_metrics.POD_EPOCH_SECONDS.set(epoch_seconds)
        if sealed is not None:
            obs_metrics.POD_MANIFESTS_SEALED.inc()

        # The pod's observability exchange: this epoch's span tree, the
        # clock-sync samples and the barrier probe, the metric snapshot;
        # host 0 stitches once every host has published.
        sync = obs_podtrace.clock_sync_samples()
        if podplan.sync_unix > 0.0:
            sync.append({"monotonic": podplan.sync_monotonic, "unix": podplan.sync_unix})
        obs_podtrace.publish_epoch_trace(
            fleet_dir, host, e, sync=sync,
            barrier={"enter_monotonic": podplan.barrier_enter_monotonic,
                     "wait_seconds": podplan.barrier_wait_seconds},
        )
        publish_snapshot(fleet_dir, f"h{host:03d}")
        stitch = None
        if host == 0 and pod.n_hosts > 1:
            deadline = time.monotonic() + params["seal_timeout"]
            while (len(obs_podtrace.directory_hosts(fleet_dir, e)) < pod.n_hosts
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            stitched = obs_podtrace.stitch_epoch(fleet_dir, e, expected_hosts=pod.n_hosts,
                                                 graft_into=TRACER)
            if stitched is not None:
                stitch = {"complete": stitched["complete"],
                          "missing_hosts": stitched["missing_hosts"],
                          "stitch_seconds": stitched["stitch_seconds"],
                          "phase_skew_s": stitched["phase_skew_s"],
                          "barrier_spread_s": stitched["barrier"]["spread_s"]}
            ok = ok and stitch is not None and stitch["complete"]

        epochs_detail.append({
            "epoch": e,
            "seconds": epoch_seconds,
            "plan_update_seconds": plan_update_seconds,
            "converge_seconds": converge_seconds,
            "iterations": int(iters),
            "residual": float(resid),
            "scores_sha256": sdig,
            "plan_outcome": podplan.plan_outcome,
            "local_plan_build_seconds": podplan.build_seconds,
            "local_edges": int(podplan.local_edges),
            "owned_rows": owned_count,
            "rows_per_shard": podplan.rows_per_shard,
            "s_max": podplan.s_max,
            "launches": launches,
            "all_reduce": comm,
            "budget_findings": budget,
            "sealed": (sealed is not None) if host == 0 else None,
            "barrier_wait_seconds": podplan.barrier_wait_seconds,
            "phase_seconds": obs_podtrace.phase_durations(TRACER.get_trace(e) or {}),
            "stitch": stitch,
        })

    JOURNAL.dump(flight_dir / f"flight-pod-h{host:03d}.jsonl", reason="run-end")
    trace_served = None
    if host == 0 and pod.n_hosts > 1 and epochs_detail:
        # The stitched trace through the node's own route.
        from ..node.server import handle_request

        status, body = handle_request("GET", "/trace/pod/latest", None)
        hosts = json.loads(body).get("hosts", []) if status == 200 else []
        trace_served = status == 200 and sorted(hosts) == list(range(pod.n_hosts))
        ok = ok and trace_served
    if recovery is not None:
        ok = ok and not recovery["lost_acked_epochs"]
        ok = ok and recovery.get("checkpoint_matches_stream", True)
    ok = ok and scores is not None and abs(float(scores.sum()) - 1.0) < 1e-3
    forbidden = loaded_modules(mesh)
    ok = ok and not forbidden
    return {
        "backend": BACKEND,
        "n_hosts": pod.n_hosts,
        "host_id": host,
        "device": str(mesh.device),
        "n": int(cur.n),
        "edges": int(cur.nnz),
        "owned_peers": int((owner == host).sum()),
        "epochs": epochs_detail,
        "recovery": recovery,
        "trace_pod_served": trace_served,
        "final_scores_sha256": hashlib.sha256(scores.tobytes()).hexdigest(),
        "final_scores": scores,
        "l1": float(scores.sum()),
        "loaded_forbidden": forbidden,
        "schedule": rank_schedule(),
        "ok": bool(ok),
    }


# -- the reference comparison, in one rank ---------------------------------


def reference_rank(mesh: ShardGroup, params: dict, hosts: int) -> dict:
    """The serial plan build of the whole bootstrap graph against the
    per-host builds, back to back in one process so that neither pays
    the other's contention (the pod's plan-build critical path is the
    slowest host); then a single-host cold converge of the final churned
    graph, the pin the pod's warm fixed point is held to."""
    from ..ops.gather_window import build_window_plan
    from .partition import HostPartition

    cur = bootstrap_graph(params)
    w, _ = cur.row_normalized()
    t0 = time.perf_counter()
    build_window_plan(cur.src, cur.dst, w, n=cur.n)
    serial = time.perf_counter() - t0
    owner = HostPartition(hosts, seed=params["seed"]).assign_ids(cur.n)
    per_host = []
    for h in range(hosts):
        m = owner[cur.src] == h
        t0 = time.perf_counter()
        build_window_plan(cur.src[m], cur.dst[m], w[m], n=cur.n)
        per_host.append(time.perf_counter() - t0)
    critical = max(per_host)
    for e in range(1, params["epochs"]):
        _, cur, _ = churn_epoch(cur, e, params)
    podplan = PodWindowPlan.build(cur, PodContext.current(seed=params["seed"], device=mesh.device))
    t, iters, resid = converge_sharded(podplan, alpha=0.1, tol=params["tol"],
                                       max_iter=params["max_iter"])
    return {
        "serial_plan_build_seconds": serial,
        "partitioned_plan_build_seconds": per_host,
        "plan_build_seconds": critical,
        "plan_build_speedup": serial / max(critical, 1e-9),
        "ref_iterations": int(iters),
        "ref_residual": float(resid),
        "scores": t,
        "loaded_forbidden": loaded_modules(mesh),
    }


# -- the headline pod, for chip_smoke.py -----------------------------------


def converge_pod_rank(mesh: ShardGroup, graphs: list, delta_rows: list, kw: dict, seed: int,
                      steps: int = 20) -> dict:
    """The pod over a sequence of graphs (each a ``TrustGraph`` or the
    arrays ``share_arrays`` wrote of one): the first cold, each later one
    from the previous plan with its churn hint ``delta_rows[i]`` and
    warm-started from the previous fixed point.  Per graph: the plan's
    outcome, local edges, build seconds and shape, the converge's
    iterations, residual, score digest and scores, seconds, launches and
    all-reduces (counts set to 0 just before, read just after) and the
    rank's peak device memory.  ``kw`` are ``converge_sharded``'s
    keywords.  Then the median wall ms of a step of the
    last plan and of its parts (``dryrun.step_wall_ms``)."""
    pod = PodContext.current(seed=seed, device=mesh.device)
    plan = scores = podplan = None
    out = {"epochs": []}
    for i, g in enumerate(graphs):
        graph = _graph(g)
        if mesh.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(mesh.device)
        dist.barrier(group=mesh.group)
        t0 = time.perf_counter()
        podplan = PodWindowPlan.build(graph, pod, plan=plan,
                                      delta_rows=None if i == 0 else np.asarray(delta_rows[i]),
                                      clock=time.perf_counter)
        plan_seconds = time.perf_counter() - t0
        t, iters, resid, seconds, launches, comm = _counted_converge(mesh, podplan, kw, scores)
        scores = t.cpu().numpy()
        plan = podplan.plan
        out["epochs"].append({
            "plan_outcome": podplan.plan_outcome,
            "local_edges": podplan.local_edges,
            "build_seconds": podplan.build_seconds,
            "plan_seconds": plan_seconds,
            "rows_per_shard": podplan.rows_per_shard,
            "s_max": podplan.s_max,
            "runs": int(podplan.seg_end.shape[0]),
            "iterations": int(iters),
            "residual": float(resid),
            "scores_sha256": hashlib.sha256(scores.tobytes()).hexdigest(),
            "scores": scores,
            "converge_seconds": seconds,
            "launches": launches,
            "all_reduce": comm,
            "budget_findings": budget_findings(mesh, podplan.n, iters, launches, comm),
            "max_memory_allocated": (torch.cuda.max_memory_allocated(mesh.device)
                                     if mesh.device.type == "cuda" else None),
        })
    alpha = torch.tensor(0.1, dtype=torch.float32, device=mesh.device)
    t = torch.from_numpy(scores).to(mesh.device)
    out["step_wall_ms"] = step_wall_ms(mesh, podplan, t, alpha, steps)
    out["loaded_forbidden"] = loaded_modules(mesh)
    return out


#: A pod plan's device arrays, as ``ShardedWindowPlan`` names them.
PLAN_ARRAYS = ("wid", "local", "weight", "seg_end", "seg_first", "seg_perm", "dst_ptr",
               "run_ptr", "p", "dangling")


def _plan_record(pp) -> dict:
    rec = {name: getattr(pp, name) for name in PLAN_ARRAYS}
    rec.update(n=pp.n, rows_per_shard=pp.rows_per_shard, table_entries=pp.table_entries,
               plan_outcome=pp.plan_outcome, fingerprint=pp.plan.fingerprint)
    return rec


def pod_plans_rank(mesh: ShardGroup, steps: list, seed: int, sharded: bool = False) -> list:
    """``PodWindowPlan.build`` for each ``(graph, delta_rows, warm)`` of
    ``steps``, ``warm`` passing the previous step's local plan: each
    plan's arrays (``PLAN_ARRAYS``), shape and outcome, with the pod's
    bookkeeping, whether ``t0()`` is a fresh copy of ``p``, and with
    ``sharded`` the ``ShardedWindowPlan`` of the same graph on the group
    (``"sharded"``)."""
    pod = PodContext.current(seed=seed, device=mesh.device)
    plan = None
    out = []
    for graph, rows, warm in steps:
        graph = _graph(graph)
        pp = PodWindowPlan.build(graph, pod, plan=plan if warm else None,
                                 delta_rows=None if rows is None else np.asarray(rows),
                                 clock=time.perf_counter, wall=time.time)
        rec = _plan_record(pp)
        t0 = pp.t0()
        rec.update(s_max=pp.s_max, interpret=pp.interpret, host_id=pp.host_id,
                   n_hosts=pp.n_hosts, local_shards=pod.local_shards, owner=pp.owner,
                   local_edges=pp.local_edges, build_seconds=pp.build_seconds,
                   barrier_wait_seconds=pp.barrier_wait_seconds, sync_unix=pp.sync_unix,
                   t0_fresh=(t0.data_ptr() != pp.p.data_ptr()
                             and torch.equal(t0.view(torch.int32), pp.p.view(torch.int32))))
        if sharded:
            rec["sharded"] = _plan_record(ShardedWindowPlan.build(graph, mesh))
        out.append(rec)
        plan = pp.plan
    return out


# -- the parent ----------------------------------------------------------------


def launch_pod(params: dict, hosts: int, state_dir: Path, *, device: str, backend: str,
               timeout_s: float, resume: bool = False, crash_host: int = -1,
               crash_epoch: int = -1, **schedule) -> list[dict]:
    """The pod's hosts as ranks of one group; their reports.  Raises
    where a host fails (``run_ranks`` kills the others).  ``schedule``
    passes ``run_ranks``'s start order, stagger, threads and environment
    through."""
    state_dir.mkdir(parents=True, exist_ok=True)
    return run_ranks(hosts, worker_rank, params, str(state_dir), resume, crash_host,
                     crash_epoch, backend=backend, device=device, timeout_s=timeout_s,
                     **schedule)


def bit_identity(workers: list[dict]) -> dict:
    """Every epoch's residual and score digest on every host, compared
    exactly: each host holds the replicated vector, so the pod agrees bit
    for bit or is broken."""
    by_epoch: dict[int, list] = {}
    for wkr in workers:
        for ep in wkr.get("epochs", []):
            by_epoch.setdefault(ep["epoch"], []).append((ep["residual"], ep["scores_sha256"]))
    mismatches = {str(e): v for e, v in sorted(by_epoch.items()) if len(set(v)) != 1}
    return {"epochs_checked": len(by_epoch), "ok": not mismatches and bool(by_epoch),
            "mismatches": mismatches}


def chaos_host_loss(params: dict, hosts: int, workdir: Path, control: list[dict],
                    **launch) -> dict:
    """The host-loss row: host 1 leaves mid-epoch (after its WAL ack,
    before the converge), the launch fails and every host is killed, the
    whole pod relaunches with resume; zero acknowledged loss and the
    control run's fixed point, bit for bit, are required."""
    crash_epoch = max(1, params["epochs"] // 2)
    crash_host = min(1, hosts - 1)
    state = workdir / "chaos-state"
    crash_error = None
    try:
        launch_pod(params, hosts, state, crash_host=crash_host, crash_epoch=crash_epoch, **launch)
    except RuntimeError as exc:
        crash_error = str(exc)
    crashed_as_planned = (crash_error is not None
                          and f"rank {crash_host} of {hosts} exited with code 137" in crash_error)
    t0 = time.perf_counter()
    resumed = launch_pod(params, hosts, state, resume=True, **launch)
    recovery_seconds = time.perf_counter() - t0
    control_digests = {w["final_scores_sha256"] for w in control}
    resume_digests = {w["final_scores_sha256"] for w in resumed}
    identity = bit_identity(resumed)
    lost = [(w.get("recovery") or {}).get("lost_acked_epochs") for w in resumed]
    crashed_recovery = next((w["recovery"] for w in resumed if w["host_id"] == crash_host), None)
    ok = (
        crashed_as_planned
        and all(w["ok"] for w in resumed)
        and identity["ok"]
        and all(isinstance(w.get("recovery"), dict) for w in resumed)
        and all(x == [] for x in lost)
        and resume_digests == control_digests
        and len(control_digests) == 1
    )
    return {
        "point": "pod.host-loss",
        "crash_host": crash_host,
        "crash_epoch": crash_epoch,
        "crash_error": crash_error[-400:] if crash_error else None,
        "crashed_as_planned": crashed_as_planned,
        "recovery_seconds": recovery_seconds,
        "crashed_host_recovery": crashed_recovery,
        "lost_acked": lost,
        "fixed_point_matches_control": resume_digests == control_digests,
        "residual_bit_identity": identity,
        "flight_dumps": sorted(p.name for p in (state / "flight").glob("*.jsonl")),
        "resume_workers": resumed,
        "ok": bool(ok),
    }


def run(args) -> dict:
    """The dry run the arguments ask for; returns the report."""
    from .. import resolve_device

    dev = resolve_device(args.device)  # no card with --device unset raises here
    device = "cuda" if dev.type == "cuda" else "cpu"
    if device == "cuda":
        from ..ops import _build

        _build.build(SOURCES)
    params = dict(peers=args.peers, edges=args.edges, epochs=args.epochs, churn=args.churn,
                  seed=args.seed, tol=args.tol, max_iter=args.max_iter,
                  seal_timeout=args.seal_timeout)
    launch = dict(device=device, backend="gloo", timeout_s=args.timeout)
    tmp = tempfile.TemporaryDirectory(prefix="dryrun_pod-") if args.workdir is None else None
    workdir = Path(args.workdir or tmp.name)
    workdir.mkdir(parents=True, exist_ok=True)
    t_run = time.perf_counter()
    try:
        if args.resume:
            workers = launch_pod(params, args.hosts, workdir / "pod-state", resume=True, **launch)
            reference = chaos = None
        else:
            reference = run_ranks(1, reference_rank, params, args.hosts, **launch)[0]
            workers = launch_pod(params, args.hosts, workdir / "pod-state", **launch)
            chaos = None
            if args.chaos_host_loss and args.hosts > 1:
                chaos = chaos_host_loss(params, args.hosts, workdir, workers, **launch)
    finally:
        if tmp is not None:
            tmp.cleanup()
    identity = bit_identity(workers)
    warm_vs_cold_l1 = None
    if reference is not None:
        ref_scores = reference.pop("scores")
        warm_vs_cold_l1 = float(np.abs(workers[0]["final_scores"] - ref_scores).sum())
    for w in workers + (chaos["resume_workers"] if chaos else []):
        w.pop("final_scores")
    ok = (
        all(w["ok"] for w in workers)
        and identity["ok"]
        and (reference is None or not reference["loaded_forbidden"])
        and (warm_vs_cold_l1 is None or warm_vs_cold_l1 < SCORE_TOL)
        and (chaos is None or chaos["ok"])
        and (not args.chaos_host_loss or chaos is not None)
    )
    return {
        "tool": "dryrun_pod",
        "backend": BACKEND,
        "device": device,
        "n_hosts": args.hosts,
        "n_cpus": os.cpu_count(),
        "params": params,
        "resume": bool(args.resume),
        "ok": bool(ok),
        "seconds": time.perf_counter() - t_run,
        "residual_bit_identity": identity,
        "warm_vs_cold_l1": warm_vs_cold_l1,
        "reference": reference,
        "chaos": chaos,
        "workers": workers,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="each host's device; unset means the card")
    ap.add_argument("--peers", type=int, default=8192)
    ap.add_argument("--edges", type=int, default=65536)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--churn", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=16)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--max-iter", type=int, default=60)
    ap.add_argument("--seal-timeout", type=float, default=120.0)
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds a launch of the hosts may take")
    ap.add_argument("--smoke", action="store_true", help="CI scale")
    ap.add_argument("--chaos-host-loss", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="resume the pod in --workdir from its newest sealed manifest")
    ap.add_argument("--workdir", default=None,
                    help="keep the pod's state here (else a temporary directory)")
    ap.add_argument("--out", default=None, help="also write the whole report to this file")
    args = ap.parse_args(argv)
    if args.smoke:
        args.peers = min(args.peers, SMOKE["peers"])
        args.edges = min(args.edges, SMOKE["edges"])
        args.epochs = min(args.epochs, SMOKE["epochs"])
    if args.resume and args.workdir is None:
        ap.error("--resume needs the --workdir of the pod to resume")
    report = run(args)
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1, default=_jsonable) + "\n")
    chaos = report["chaos"]
    summary = {
        "dryrun": "pod", "ok": report["ok"], "device": report["device"],
        "n_hosts": report["n_hosts"], "params": report["params"],
        "seconds": report["seconds"], "residual_bit_identity": report["residual_bit_identity"]["ok"],
        "warm_vs_cold_l1": report["warm_vs_cold_l1"],
        "plan_build_speedup": (report["reference"] or {}).get("plan_build_speedup"),
        "epochs": [{k: ep[k] for k in ("epoch", "iterations", "residual", "plan_outcome",
                                       "local_plan_build_seconds", "converge_seconds", "launches",
                                       "all_reduce")}
                   for ep in report["workers"][0]["epochs"]],
        "chaos": None if chaos is None else {
            k: chaos[k] for k in ("ok", "crash_host", "crash_epoch", "crashed_as_planned",
                                  "lost_acked", "fixed_point_matches_control", "recovery_seconds")},
    }
    print(json.dumps(summary, default=_jsonable), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
