"""The sharded converge's dry run over several ranks, and the rank programs.

    python -m protocol_tpu_torch.parallel.dryrun --ranks 8 --device cpu|cuda [--out FILE]

Counterpart of ``tools/dryrun_multichip.py`` and the reference's
``dryrun_multichip`` entry, with processes as devices: ``--ranks``
spawned ranks of one ``torch.distributed`` group (``--backend``, gloo
unless named) converge the reference's dry-run graph
``scale_free(512, 4096, seed=1)`` on ``cuda-sharded:cuda-csr`` and
``cuda-sharded:cuda-windowed`` (alpha 0.1, tol 1e-6, 8 iterations at
most).  It checks that every rank holds the same bits, that the scores
sum to 1 and that the windowed kernel stays within L1 1e-4 of the CSR
one, then prints one JSON line: iterations, residual, that drift, and
the all-reduces a step with their bytes.  It writes a file only with
``--out``.

The rank programs (``converge_rank``, ``step_rank``, ``node_rank``,
``loaded_modules``, ``jobs_rank``, ``stall_rank``) are what
``run_ranks`` runs for this script, the tests and ``chip_smoke.py``: a
spawned rank imports them from here, so it imports neither ``jax`` nor
``protocol_tpu``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..obs import TRACER
from ..ops import gather_window as gw
from ..ops import sparse as sp
from ..trust.backend import get_backend
from ..trust.graph import TrustGraph
from .launch import map_arrays, run_ranks
from .mesh import ShardGroup
from .sharded import SHARDED_KERNELS, ShardedTrustProblem, ShardedWindowPlan, all_reduce_sum

#: The reference's dry-run graph and converge (``__graft_entry__.py``).
GRAPH = dict(n=512, nnz=4096, seed=1)
KW = dict(alpha=0.1, tol=1e-6, max_iter=8)
#: Windowed against CSR, the reference's dry-run gate.
DRIFT_TOL = 1e-4

#: The wrappers that count the launches of the kernels a sharded step runs.
WRAPPERS = (
    gw.gather_windowed, gw.prefix_bridge, sp.ds_cumsum_axis1, sp.block_total_scan,
    sp.rowsum_tail, sp.gather_ds_cumsum,
)
#: The kernel sources a sharded step runs, built once before the ranks
#: start on a card.
SOURCES = (
    "gather_window", "prefix_bridge", "ds_cumsum_rows", "compensated_scan", "rowsum_tail",
    "gather_ds_cumsum",
)
#: Top-level packages a rank must never load.
FORBIDDEN = ("jax", "jaxlib", "protocol_tpu")


def loaded_modules(mesh: ShardGroup) -> list[str]:
    """The rank's loaded modules of the ``FORBIDDEN`` packages."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _graph(graph) -> TrustGraph:
    """A ``TrustGraph``, or the arrays ``share_arrays`` wrote of one
    (``n``, ``src``, ``dst``, ``weight``, ``pre_trusted``), mapped."""
    if isinstance(graph, TrustGraph):
        return graph
    a = map_arrays(graph)
    return TrustGraph(
        int(a["n"]), a["src"], a["dst"], a["weight"], np.asarray(a["pre_trusted"])
    )


def _plan(plan) -> gw.WindowPlan | None:
    """A ``WindowPlan``, None, or the arrays ``share_arrays`` wrote of one
    (``WindowPlan.to_arrays``), mapped."""
    if plan is None or isinstance(plan, gw.WindowPlan):
        return plan
    return gw.WindowPlan.from_arrays(map_arrays(plan))


def _sync(mesh: ShardGroup) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def converge_rank(mesh: ShardGroup, graph, kernels=tuple(SHARDED_KERNELS), kw=None, plan=None):
    """Converge ``graph`` on ``cuda-sharded:<kernel>`` for each of
    ``kernels``, through ``get_backend``, the windowed kernel seeded with
    the candidate ``plan``.  Per kernel: the scores, iterations, residual
    and residual history; the kernel launches, all-reduces and their
    bytes (every count set to 0 just before the converge and read just
    after); the converge's seconds, those of its ``plan`` and ``converge``
    spans, its peak device memory on a card, and the plan outcome."""
    graph, plan = _graph(graph), _plan(plan)
    kw = dict(KW if kw is None else kw)
    out = {}
    for kernel in kernels:
        backend = get_backend(f"cuda-sharded:{kernel}", mesh=mesh)
        backend.plan = plan
        _sync(mesh)
        if mesh.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(mesh.device)
        for w in WRAPPERS:
            w.launches = 0
        all_reduce_sum.calls = all_reduce_sum.bytes = 0
        dist.barrier(group=mesh.group)
        t0 = time.perf_counter()
        with TRACER.span("rank", kernel=kernel) as root:
            res = backend.converge(graph, **kw)
        seconds = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in WRAPPERS}
        spans = {name: (s.duration_s if (s := root.find(name)) else None)
                 for name in ("plan", "converge")}
        out[kernel] = {
            "backend": res.backend,
            "scores": res.scores,
            "iterations": res.iterations,
            "residual": res.residual,
            "residuals": res.residuals,
            "launches": launches,
            "all_reduce": {"calls": all_reduce_sum.calls, "bytes": all_reduce_sum.bytes},
            "seconds": seconds,
            "plan_seconds": spans["plan"],
            "converge_seconds": spans["converge"],
            "max_memory_allocated": (torch.cuda.max_memory_allocated(mesh.device)
                                     if mesh.device.type == "cuda" else None),
            "plan_outcome": backend.plan_outcomes if kernel == "cuda-windowed" else None,
            "plan_reused": kernel == "cuda-windowed" and backend.last_plan is plan,
        }
    out["loaded_forbidden"] = loaded_modules(mesh)
    return out


def _plain_partial_ct(problem, t: torch.Tensor) -> torch.Tensor:
    """The shard's partial ``Cᵀt`` through the plain versions of every
    pass: the route the kernels' route is held against."""
    if isinstance(problem, ShardedTrustProblem):
        contrib = sp._gather_multiply(problem.w, t, problem.src)
        return sp.rowsum_sorted_plain(contrib, problem.row_ptr)
    table = torch.nn.functional.pad(t, (0, problem.table_entries - t.shape[0]))
    slots = gw.gather_windowed_plain(problem.wid, table, problem.local, problem.weight)
    hi, lo = sp._ds_cumsum_axis1(slots.reshape(problem.rows_per_shard, gw.ROW))
    runs = gw.bridge_partials_plain(
        hi.reshape(-1), lo.reshape(-1), problem.seg_end, problem.seg_first, problem.seg_perm
    )
    return sp.rowsum_sorted_plain(runs, problem.dst_ptr)


def _device_split(device_ms: dict) -> dict:
    """A step's device ms by part: the port's hand-written kernels (all
    in anonymous namespaces), the all-reduce's host copies (gloo stages a
    CUDA tensor through pinned memory; its ``gloo:`` range, which spans
    them, is not counted again) and the rest (``damp``'s and the table
    pad's PyTorch kernels)."""
    split = {"shard_kernels": 0.0, "all_reduce_copies": 0.0, "other": 0.0}
    for name, ms in device_ms.items():
        if name.startswith("gloo:"):
            continue
        if "(anonymous namespace)::" in name:
            split["shard_kernels"] += ms
        elif name.startswith("Memcpy") and "Pinned" in name:
            split["all_reduce_copies"] += ms
        else:
            split["other"] += ms
    return split


def step_rank(mesh: ShardGroup, graph, kernels=tuple(SHARDED_KERNELS), plan=None,
              steps: int = 20, trace: bool = False):
    """One sharded step of each kernel on this rank's shard, at a seeded
    score vector (the same on every rank): the kernel route against the
    plain route, bit for bit, for the shard's partial ``Cᵀt`` and for the
    whole step (all-reduce and ``damp`` included); then the median wall
    ms over ``steps`` steps of the whole step and of its three parts (the
    partial, the all-reduce with gloo's copies, ``damp``), each part
    timed between a device synchronisation and a group barrier; with
    ``trace``, on rank 0 on a card, the device ms a step by kernel and
    copy name from a ``torch.profiler`` trace of ``steps`` steps, and by
    part (``_device_split``)."""
    from ..bench._timing import device_events, same_bits, trace_session

    graph, plan = _graph(graph), _plan(plan)
    rng = np.random.default_rng(5)
    x = rng.random(graph.n).astype(np.float32)
    t = torch.from_numpy(x / x.sum()).to(mesh.device)
    alpha = torch.tensor(0.1, dtype=torch.float32, device=mesh.device)
    out = {}
    for kernel in kernels:
        if kernel == "cuda-csr":
            problem = ShardedTrustProblem.build(graph, mesh)
        else:
            problem = ShardedWindowPlan.build(graph, mesh, plan=plan)

        def step(partial):
            ct = all_reduce_sum(partial(t), mesh)
            return sp.damp(ct, t, problem.p, problem.dangling, alpha)

        kernel_part = problem.partial_ct(t)
        plain_part = _plain_partial_ct(problem, t)
        routes = {
            "partial": same_bits(kernel_part, plain_part),
            "step": same_bits(
                step(problem.partial_ct), step(lambda v: _plain_partial_ct(problem, v))
            ),
        }

        wall = step_wall_ms(mesh, problem, t, alpha, steps)
        device_ms = split = None
        if trace and mesh.rank == 0 and mesh.device.type == "cuda":
            step(problem.partial_ct)
            _sync(mesh)
            with trace_session() as prof:
                for _ in range(steps):
                    step(problem.partial_ct)
                _sync(mesh)
            device_ms = {}
            for e in device_events(prof):
                ms = e.time_range.elapsed_us() / 1e3 / steps
                device_ms[e.name] = device_ms.get(e.name, 0.0) + ms
            split = _device_split(device_ms)
        else:
            for _ in range(steps + 1):
                step(problem.partial_ct)
        out[kernel] = {
            "routes_equal": routes,
            "wall_ms": wall,
            "device_ms": device_ms,
            "device_split_ms": split,
            "runs": int(problem.seg_end.shape[0]) if kernel == "cuda-windowed" else None,
            "edges": int(problem.src.shape[0]) if kernel == "cuda-csr" else None,
        }
        del problem, kernel_part, plain_part
    return out


def step_wall_ms(mesh: ShardGroup, problem, t: torch.Tensor, alpha: torch.Tensor,
                 steps: int) -> dict:
    """The median wall ms over ``steps`` runs of a whole sharded step of
    ``problem`` at ``t`` and of its three parts: the shard's partial
    ``Cᵀt``, the all-reduce (with gloo's copies) and ``damp``, each
    timed between a device synchronisation and a group barrier."""

    def timed(fn):
        times = []
        for _ in range(steps):
            _sync(mesh)
            dist.barrier(group=mesh.group)
            t0 = time.perf_counter()
            fn()
            _sync(mesh)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def step():
        ct = all_reduce_sum(problem.partial_ct(t), mesh)
        return sp.damp(ct, t, problem.p, problem.dangling, alpha)

    ct = problem.partial_ct(t)
    return {
        "step": timed(step),
        "partial_ct": timed(lambda: problem.partial_ct(t)),
        "all_reduce": timed(lambda: all_reduce_sum(ct, mesh)),
        "damp": timed(lambda: sp.damp(ct, t, problem.p, problem.dangling, alpha)),
    }


def jobs_rank(mesh: ShardGroup, jobs) -> list:
    """``[fn(mesh, *args) for fn, args in jobs]``: several rank programs
    in one launch."""
    return [fn(mesh, *args) for fn, args in jobs]


def stall_rank(mesh: ShardGroup, dead: int, seconds: float) -> None:
    """A rank program that fails its launch, for the launcher's checks:
    rank ``dead`` exits at once with code 3 and no word, while every other
    rank waits for it in an all-reduce; with ``dead`` -1 every rank
    sleeps ``seconds`` instead."""
    if dead < 0:
        time.sleep(seconds)
    elif mesh.rank == dead:
        import os

        os._exit(3)
    else:
        all_reduce_sum(torch.zeros(1, device=mesh.device), mesh)


def run_node(
    backend: str, device: str, rows, epochs: int = 3, alpha: float = 0.1
) -> list[dict]:
    """The bootstrap group of 5 on one ``Manager`` (commitment prover, no
    circuit check) on ``backend``: every member's attestation from
    ``rows`` (score rows summing to SCALE), ``epochs`` epochs through an
    ``EpochPipeline``, sender 0 attesting ``rows[0]`` reversed before the
    last.  Returns each epoch's scores, iterations and residual."""
    from ..crypto import calculate_message_hash
    from ..crypto.eddsa import sign
    from ..node.attestation import Attestation
    from ..node.bootstrap import FIXED_SET, keyset_from_raw
    from ..node.epoch import Epoch
    from ..node.manager import Manager, ManagerConfig
    from ..node.pipeline import EpochPipeline

    sks, pks = keyset_from_raw(FIXED_SET)
    rows = [list(r) for r in rows] + [list(rows[0])[::-1]]
    _, msgs = calculate_message_hash(pks, rows)
    atts = [
        Attestation(sig=sign(sks[i % 5], pks[i % 5], m), pk=pks[i % 5],
                    neighbours=list(pks), scores=r)
        for i, (r, m) in enumerate(zip(rows, msgs))
    ]
    m = Manager(ManagerConfig(backend=backend, device=device, prover="commitment",
                              check_circuit=False))
    if not all(r.accepted for r in m.add_attestations_bulk(atts[:-1])):
        raise RuntimeError("the group's attestations were refused")
    with EpochPipeline(m, alpha=alpha) as pipe:
        for k in range(1, epochs + 1):
            if k == epochs and not m.add_attestation(atts[-1]).accepted:
                raise RuntimeError("the re-attestation was refused")
            pipe.submit(Epoch(k))
            if not pipe.drain(60):
                raise RuntimeError(f"epoch {k} did not finish")
    out = []
    for k in range(1, epochs + 1):
        o = pipe.outcomes[k]
        if o.error is not None:
            raise RuntimeError(f"epoch {k} failed: {o.error}")
        out.append({"scores": o.result.scores, "iterations": o.result.iterations,
                    "residual": o.result.residual, "backend": o.result.backend})
    return out


def node_rank(mesh: ShardGroup, backend: str, rows, epochs: int = 3) -> list[dict]:
    """``run_node`` in a rank, on the rank's device."""
    return run_node(backend, str(mesh.device), rows, epochs)


def dryrun(ranks: int, device: str, backend: str, timeout_s: float = 300.0) -> dict:
    """Both sharded kernels over ``ranks`` ranks on the dry-run graph,
    checked; returns the JSON record."""
    from ..models.graphs import scale_free

    graph = scale_free(GRAPH["n"], GRAPH["nnz"], seed=GRAPH["seed"])
    if device == "cuda":
        from ..ops import _build

        _build.build(SOURCES)
    t0 = time.perf_counter()
    results = run_ranks(ranks, converge_rank, graph, backend=backend, device=device,
                        timeout_s=timeout_s)
    seconds = time.perf_counter() - t0
    head = results[0]
    for r, res in enumerate(results):
        if res["loaded_forbidden"]:
            raise RuntimeError(f"rank {r} loaded {res['loaded_forbidden']}")
        for kernel in SHARDED_KERNELS:
            if not np.array_equal(res[kernel]["scores"], head[kernel]["scores"]):
                raise RuntimeError(f"rank {r}'s {kernel} scores differ from rank 0's")
    csr, win = head["cuda-csr"], head["cuda-windowed"]
    total = float(csr["scores"].sum())
    if abs(total - 1.0) >= 1e-3:
        raise RuntimeError(f"the CSR scores sum to {total}")
    drift = float(np.abs(win["scores"] - csr["scores"]).sum())
    if drift >= DRIFT_TOL:
        raise RuntimeError(f"windowed sharded kernel drifted from CSR: L1 {drift}")
    per_step = {}
    for kernel in SHARDED_KERNELS:
        it = head[kernel]["iterations"]
        calls, nbytes = head[kernel]["all_reduce"]["calls"], head[kernel]["all_reduce"]["bytes"]
        per_step[kernel] = {
            "iterations": it,
            "residual": head[kernel]["residual"],
            "all_reduce_calls_per_step": calls / it,
            "all_reduce_bytes_per_step": nbytes / it,
            "launches": head[kernel]["launches"],
        }
    return {
        "dryrun": "sharded", "ranks": ranks, "device": device, "backend": backend,
        "peers": graph.n, "edges": graph.nnz, "windowed_l1_drift": drift, "seconds": seconds,
        "kernels": per_step,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", choices=("cpu", "cuda"), required=True)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                    help="collective backend (nccl needs a card a rank)")
    ap.add_argument("--out", help="also write the JSON record to this file")
    args = ap.parse_args(argv)
    record = dryrun(args.ranks, args.device, args.backend)
    line = json.dumps(record)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
