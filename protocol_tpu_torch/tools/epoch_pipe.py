"""Multi-epoch pipelined churn dryrun: warm churned epochs must land by
delta plans in fewer iterations than the cold one.

Counterpart of ``tools/epoch_pipe.py``.  It drives the port's
:class:`~protocol_tpu_torch.node.pipeline.EpochPipeline` and
:class:`~protocol_tpu_torch.node.manager.Manager` (warm starts and the
windowed plan's delta updates, on ``cuda-windowed``) over a synthetic
open graph for N epochs with edge churn between them: the reference's
``scale_free(peers, edges, seed=7)`` and its churn stream from
``np.random.default_rng(23)``, so every epoch's graph is the
reference's bit for bit.  Its checks, each an explicit one:

- epoch 0 is a cold start, and every later epoch warm-starts and
  converges in fewer iterations than epoch 0;
- at least ``epochs - 1`` plan delta-applies (``PLAN_OUTCOMES``);
- no tick dropped (``EPOCH_TICKS_DROPPED``) or superseded
  (``pipe.coalesced``);
- the warm fixed point lies within L1 1e-4 of a cold converge of the
  final graph (``get_backend("cuda-windowed")``);
- and, beyond the reference's: each epoch launches K1, K5, K6, K7 and K8
  exactly ``KERNEL_INVARIANTS["cuda-windowed"]`` times its iterations,
  and no other kernel (each count read just before the epoch's converge
  and just after; on the CPU the plain versions launch none);
- with ``--against-plain``, each epoch's converge and the cold converge
  of the final graph are run once more with the plain versions on the
  CPU on the same inputs (the graph, the warm seed and the window plan
  the converge used): equal iterations, scores within L1 ``PLAIN_L1``.  On the card that holds the
  kernels against their plain versions at the pipe's own shapes.

The epochs converge on the card unless ``--device cpu`` asks for the
plain versions; with ``--device`` unset and no card the driver raises.
The report (the reference's keys, plus the device, the card's name and
power limit, the kernel launches by wrapper and the failed checks) is
written before the exit: 0 when every check holds, else 1.

Run: ``python -m protocol_tpu_torch.tools.epoch_pipe [--out FILE] [--device cuda|cpu] [--against-plain]``
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

#: The converge's parameters, the reference's.
CONVERGE = dict(alpha=0.1, tol=1e-6, max_iter=80)

#: L1 bar for the warm fixed point against a cold converge of the final graph.
SCORE_TOL = 1e-4

#: L1 bar for an epoch's scores against the plain versions' on the same
#: inputs: the node's card-against-CPU limit.
PLAIN_L1 = 1e-6

BACKEND = "cuda-windowed"

#: The manager's delta/rebuild crossover, the reference's: 1 % edge churn
#: touches ~6 % of the rows at this mean degree, above the production
#: default, so the crossover is raised.
PLAN_DELTA_MAX_CHURN = 0.25


def synthetic_graph_manager(graph, device: str):
    """A ``Manager`` whose open graph is a synthetic scale-free edge list
    with injected churn: peer "hashes" are row ids, so the warm-start
    remap and the dirty-row hints run as in production, without signing
    20k attestations."""
    from ..node.manager import Manager, ManagerConfig
    from ..trust.graph import TrustGraph

    class _Mgr(Manager):
        def __init__(self, g):
            super().__init__(ManagerConfig(backend=BACKEND, device=device, prover="commitment",
                                           plan_delta_max_churn=PLAN_DELTA_MAX_CHURN))
            self._graph = g
            self._rng = np.random.default_rng(23)

        def churn(self, fraction: float) -> int:
            g = self._graph
            k = max(1, int(g.nnz * fraction))
            idx = self._rng.choice(g.nnz, k, replace=False)
            dst = g.dst.copy()
            dst[idx] = self._rng.integers(0, g.n, k)
            while (bad := dst[idx] == g.src[idx]).any():
                dst[idx[bad]] = self._rng.integers(0, g.n, int(bad.sum()))
            w = g.weight.copy()
            w[idx] = self._rng.integers(1, 1000, k).astype(np.float32)
            self._graph = TrustGraph(g.n, g.src, dst, w, g.pre_trusted)
            self._dirty_hashes.update(int(s) for s in np.unique(g.src[idx]))
            return k

        def build_graph(self):
            self._id_order = list(range(self._graph.n))
            return self._graph

    return _Mgr(graph)


def launch_findings(device: str, iterations: int, launches: dict) -> list[str]:
    """Where an epoch's launches differ from ``iterations`` steps of the
    backend's declared budget (every other wrapper 0; on the CPU all 0)."""
    from ..analysis.budget import KERNEL_INVARIANTS

    want = dict.fromkeys(launches, 0)
    if device == "cuda":
        want.update(KERNEL_INVARIANTS[BACKEND].expected_launches(iterations))
    return [] if launches == want else [f"launched {launches}, expected {want}"]


def against_plain(converges: list) -> dict:
    """Each ``(label, graph, t0, plan, scores, iterations)`` converge run
    once more with the plain versions on the CPU from the same inputs:
    its iterations and the L1 of its scores from those given, and the
    failed checks (unequal iterations, L1 above ``PLAIN_L1``)."""
    from ..trust.backend import get_backend

    rows, failed = [], []
    for label, graph, t0, plan, scores, iterations in converges:
        ref = get_backend(BACKEND, device="cpu", plan=plan).converge(graph, t0=t0, **CONVERGE)
        l1 = float(np.abs(np.asarray(scores, dtype=np.float64) - ref.scores).sum())
        rows.append({"converge": label, "iterations": int(ref.iterations), "l1": l1})
        if int(ref.iterations) != iterations or not l1 <= PLAIN_L1:
            failed.append(f"{label}: {iterations} iterations against the plain versions' "
                          f"{ref.iterations}, L1 {l1}")
    return {"converges": rows, "failed": failed}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="EPOCH_PIPE.json", help="report path")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the epochs converge; unset means the card")
    ap.add_argument("--peers", type=int, default=20_000)
    ap.add_argument("--edges", type=int, default=120_000)
    ap.add_argument("--churn", type=float, default=0.01)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--against-plain", action="store_true",
                    help="hold every converge against the plain versions on the CPU "
                    "on the same inputs")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    from .. import resolve_device

    # --device unset means the card, and raises here where there is none.
    device = resolve_device(args.device).type
    from ..analysis.cases import launch_counts, launches_since
    from ..models.graphs import scale_free
    from ..node.epoch import Epoch
    from ..node.pipeline import EpochPipeline
    from ..obs.metrics import EPOCH_TICKS_DROPPED, PLAN_OUTCOMES
    from ..trust.backend import get_backend
    from . import card_name_and_limit
    from .crash_matrix import warm_kernels

    # Build the step's kernels before the first epoch, so that no epoch's
    # seconds hold an nvcc run.
    warm_kernels(device, BACKEND)
    t_run = time.perf_counter()
    manager = synthetic_graph_manager(scale_free(args.peers, args.edges, seed=7), device)
    failures: list[str] = []

    def need(cond, msg) -> None:
        if not cond:
            failures.append(str(msg))

    per_launches: dict[int, dict] = {}
    outcomes_seen: dict[int, list] = {}
    converges: list = []  # (label, graph, t0, plan, scores, iterations), for --against-plain

    def device_stage(prepared):
        outcomes = {k: PLAN_OUTCOMES.value(outcome=k) for k in ("reuse", "delta", "rebuild")}
        before = launch_counts()
        result = manager.converge_prepared(prepared, **CONVERGE)
        per_launches[prepared.epoch.number] = launches_since(before)
        if args.against_plain:
            converges.append((f"epoch {prepared.epoch.number}", prepared.graph, prepared.t0,
                              manager.window_plan, np.array(result.scores),
                              int(result.iterations)))
        outcomes_seen[prepared.epoch.number] = [
            k for k, v in outcomes.items() if PLAN_OUTCOMES.value(outcome=k) > v]
        return result

    per_epoch = []
    delta0 = PLAN_OUTCOMES.value(outcome="delta")
    dropped0 = EPOCH_TICKS_DROPPED.value()
    with EpochPipeline(manager, device_stage=device_stage, **CONVERGE) as pipe:
        for k in range(args.epochs):
            churned = manager.churn(args.churn) if k else 0
            t0 = time.perf_counter()
            prepared = pipe.submit(Epoch(k))
            landed = pipe.drain(timeout=600)
            outcome = pipe.outcomes.get(k)
            need(landed, f"epoch {k} did not finish")
            need(outcome is not None and outcome.error is None,
                 f"epoch {k}: {None if outcome is None else outcome.error!r}")
            if not landed or outcome is None or outcome.error is not None:
                break
            iterations = int(outcome.result.iterations)
            launches = per_launches[k]
            per_epoch.append({
                "epoch": k,
                "seconds": time.perf_counter() - t0,
                "iterations": iterations,
                "warm": prepared.t0 is not None,
                "edges_churned": churned,
                "plan_outcome": outcomes_seen[k],
                "launches": launches,
                "launch_findings": launch_findings(device, iterations, launches),
            })
    final_scores = manager.last_scores

    # -- the acceptance shape -------------------------------------------
    cold_iters = per_epoch[0]["iterations"] if per_epoch else None
    need(len(per_epoch) == args.epochs, f"{len(per_epoch)} of {args.epochs} epochs landed")
    need(not per_epoch or not per_epoch[0]["warm"], "epoch 0 must be a cold start")
    for entry in per_epoch[1:]:
        need(entry["warm"], f"epoch {entry['epoch']} did not warm start")
        need(entry["iterations"] < cold_iters,
             f"epoch {entry['epoch']} took {entry['iterations']} iterations, "
             f"not fewer than cold epoch 0's {cold_iters}")
    for entry in per_epoch:
        failures.extend(f"epoch {entry['epoch']}: {f}" for f in entry["launch_findings"])
    delta_applies = PLAN_OUTCOMES.value(outcome="delta") - delta0
    need(delta_applies >= args.epochs - 1,
         f"expected >= {args.epochs - 1} plan delta-applies, saw {delta_applies}")
    dropped = EPOCH_TICKS_DROPPED.value() - dropped0
    need(dropped == 0 and pipe.coalesced == 0,
         f"dropped {dropped} ticks, coalesced {pipe.coalesced}")

    # The warm path must land on the cold fixed point of the final graph
    # (where an epoch landed at all: the count check above holds that).
    l1 = None
    if final_scores is not None:
        final_graph = manager.build_graph()
        cold = get_backend(BACKEND, device=device)
        ref = cold.converge(final_graph, **CONVERGE)
        l1 = float(np.abs(final_scores - ref.scores).sum())
        need(l1 <= SCORE_TOL, f"warm fixed point drifted from cold: L1 {l1}")
        if args.against_plain:
            converges.append(("final graph, cold", final_graph, None, cold.last_plan,
                              ref.scores, int(ref.iterations)))

    plain = None
    if args.against_plain:
        plain = against_plain(converges)
        failures.extend(plain["failed"])

    report = {
        "peers": args.peers,
        "edges": args.edges,
        "churn": args.churn,
        "cold_iterations": cold_iters,
        "warm_iterations": [e["iterations"] for e in per_epoch[1:]],
        "plan_delta_applies": delta_applies,
        "dropped_ticks": dropped,
        "coalesced_ticks": pipe.coalesced,
        "warm_vs_cold_l1": l1,
        "per_epoch": per_epoch,
        "against_plain": plain,
        "backend": BACKEND,
        "plan_delta_max_churn": PLAN_DELTA_MAX_CHURN,
        "device": device,
        "nvidia_smi": card_name_and_limit(device),
        "seconds": time.perf_counter() - t_run,
        "failed_checks": failures,
        "ok": not failures,
        "launches": launch_counts(),
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=2) + "\n")
    if failures:
        print(f"epoch_pipe: FAILED checks: {failures}; report at {args.out}", file=sys.stderr)
        return 1
    print(
        f"epoch_pipe: OK on {device}: cold {cold_iters} iters, warm "
        f"{report['warm_iterations']}, {int(delta_applies)} delta-applies, "
        f"0 dropped ticks; report at {args.out}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
