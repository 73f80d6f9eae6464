"""Differential replay probe: the pod's churned replay, run twice under
perturbed schedules, must leave every durability sink bit-identical.

Counterpart of ``tools/divergence_probe.py``.  It runs the port's
2-host churned pod replay (``parallel/dryrun_pod.py``'s ``worker_rank``,
each host a gloo rank of ``run_ranks``) once under each of the two
``SCHEDULES`` and requires every sink identical across the runs:

- **perturbations** (everything a correct run must be invariant to): a
  different ``PYTHONHASHSEED`` (set and dict salts), a different
  intra-op thread count in each host (``torch.set_num_threads``, with
  ``OMP_NUM_THREADS`` beside it), the hosts started in reversed order
  with a stagger (rendezvous timing), and a different fleet-directory
  scrape interleaving (decoy snapshots created in another order, and a
  concurrent scraper thread merging the directory at another cadence
  during the replay);
- **identical across runs**: each host's WAL ack digests
  (``acks-h*.jsonl``), the checkpoint, pod-manifest and shard-stamp
  files (canonical JSON), per-epoch residuals and score digests, the
  final score digests and the ``.npy`` bytes of rank 0's scores, and the
  commitment proof over them (``zk.proof.PoseidonCommitmentProver``);
- **within each run**: per-epoch cross-host bit identity, and the fleet
  merge reaching the same aggregate whatever the scan interleaving.

Each host reports the hash seed, thread count and start position it saw
(``parallel.launch.rank_schedule``); a host that did not see its
schedule fails the ``workers_ok`` leg, so an unapplied perturbation
cannot pass for an invariance.

The durability files are digested by name (``DURABLE_JSON``): the
hosts also write ``fleet/`` (metric snapshots carrying a pid and a wall
clock, epoch traces with monotonic stamps), which are not sinks of the
replay.  There is no ``skipped`` outcome: gloo is always there, and a
failed launch fails the run.

``--seed-divergence`` moves the protocol seed in the second schedule, so
every digest leg must trip and the probe must exit 1: the self-check
that the comparator compares.

``--against-plain`` holds the replay against the plain versions too: the
baseline schedule's replay is run once more with ``device="cpu"`` (the
same seed, the launcher's default schedule), and host 0's per-epoch
iterations and plan outcomes must equal the first replay's, its
per-epoch checkpointed scores and its final scores lie within L1
``PLAIN_L1`` of them, and its residuals within ``2 * PLAIN_L1`` (a
residual is the L1 norm of a step, so iterates within ``PLAIN_L1`` give
residuals within twice it).  On the card that is the kernels against
their plain versions at the replay's own shapes; the ten legs compare
the card with itself.

Run::

    python -m protocol_tpu_torch.tools.divergence_probe --smoke [--device cpu] --out DET_smoke.json
    python -m protocol_tpu_torch.tools.divergence_probe --peers 4096 --edges 32768 --epochs 3
    python -m protocol_tpu_torch.tools.divergence_probe --smoke --against-plain

The hosts run on the card (two ranks share it over gloo) unless
``--device cpu`` asks for the plain versions; with ``--device`` unset
and no card the probe raises.  Exit 0 when every leg (and the plain
check, where asked for) holds, 1 otherwise; the report (the reference's
keys, plus the device, the card's name and power limit, the hosts'
kernel launches by wrapper and the plain check) is written first.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import threading
import time
from pathlib import Path

#: The two perturbed schedules.  Everything here is a knob a correct
#: replay must be invariant to; the protocol seed (the one legitimate
#: input) is held fixed across both.  The reference's, value for value.
SCHEDULES: tuple[dict, ...] = (
    {
        "name": "baseline",
        "hashseed": "1",
        "omp_threads": "2",
        "reverse_launch": False,
        "launch_stagger": 0.0,
        "decoy_order": (0, 1, 2),
        "scrape_interval": 0.05,
    },
    {
        "name": "perturbed",
        "hashseed": "31337",
        "omp_threads": "1",
        "reverse_launch": True,
        "launch_stagger": 0.25,
        "decoy_order": (2, 0, 1),
        "scrape_interval": 0.013,
    },
)

#: The durability files a replay writes, by pattern under the state
#: directory: each host's checkpoint manifest, the sealed pod manifests
#: and the shard stamps.
DURABLE_JSON = (
    "host-*/checkpoints/manifest.json",
    "manifests/pod_manifest_e*.json",
    "manifests/shard-e*-h*.json",
)

#: L1 bar for the card's scores against the plain replay's, each epoch's
#: and the final ones: the node's card-against-CPU limit.
PLAIN_L1 = 1e-6

#: The legs that compare digests of the replay's output: a moved
#: protocol seed must trip each of them, and no other.
DIGEST_LEGS = (
    "wal_ack_digests",
    "manifest_digests",
    "epoch_digests",
    "final_scores_sha256",
    "scores_npy_bytes",
    "proof_bytes",
)


def _sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _canonical_json_digest(obj) -> str:
    return _sha256_bytes(json.dumps(obj, sort_keys=True, separators=(",", ":")).encode())


# -- fleet-directory scrape interleaving --------------------------------------

#: Fixed-content decoy snapshots (the fleet snapshot schema): only their
#: creation order and the scrape cadence differ by schedule, so any
#: aggregate difference is a scan-order dependence in the merge.
_DECOYS = tuple(
    {
        "version": 1,
        "pid": 900000 + i,
        "source": f"decoy-{i}",
        "taken_unix": 0,
        "metrics": {
            "probe_decoy_total": {
                "kind": "counter",
                "help": "divergence-probe decoy series",
                "labelnames": ["decoy"],
                "samples": [[[str(i)], float(10 * (i + 1))]],
            }
        },
    }
    for i in range(3)
)


def _write_decoys(fleet_dir: Path, order) -> None:
    fleet_dir.mkdir(parents=True, exist_ok=True)
    for i in order:
        (fleet_dir / f"fleet-decoy{i}.json").write_text(json.dumps(_DECOYS[i]) + "\n")
        time.sleep(0.01)  # distinct mtimes: a real creation-order skew


class _Scraper(threading.Thread):
    """A fleet-directory merge running beside the replay, with an
    aggregator of its own so two schedules' merges share no state."""

    def __init__(self, fleet_dir: Path, interval: float):
        super().__init__(daemon=True)
        from ..obs.fleet import FleetAggregator

        self.fleet_dir = fleet_dir
        self.interval = interval
        self.aggregator = FleetAggregator()
        self.scrapes = 0
        self._halt = threading.Event()

    def run(self) -> None:
        from ..obs.fleet import load_directory

        scrapes = 0
        while not self._halt.is_set():
            load_directory(self.fleet_dir, self.aggregator)
            scrapes += 1
            self.scrapes = scrapes  # read once the thread is joined
            self._halt.wait(self.interval)

    def finish(self) -> dict:
        self._halt.set()
        self.join(timeout=10.0)
        return {
            "scrapes": self.scrapes,
            "sources": self.aggregator.sources(),
            "aggregate_sha256": _canonical_json_digest(self.aggregator.snapshots()),
        }


# -- one schedule = one full pod replay ---------------------------------------


def launch_schedule(sched: dict, hosts: int) -> dict:
    """``run_ranks``'s schedule keywords for ``sched``."""
    order = list(range(hosts))
    if sched["reverse_launch"]:
        order.reverse()
    return {
        "start_order": order,
        "stagger_s": float(sched["launch_stagger"]),
        "threads": int(sched["omp_threads"]),  # OMP_NUM_THREADS with it
        "env": {"PYTHONHASHSEED": sched["hashseed"]},
    }


def schedule_seen(worker: dict, launch: dict) -> bool:
    """Whether a host ran under the schedule it was launched with: its
    hash seed, its thread count and its place in the start order."""
    seen = worker.get("schedule") or {}
    order = launch["start_order"]
    return (
        worker.get("host_id") in order
        and seen.get("start_position") == order.index(worker["host_id"])
        and seen.get("hashseed") == launch["env"]["PYTHONHASHSEED"]
        and seen.get("omp_num_threads") == str(launch["threads"])
        and seen.get("threads") == launch["threads"]
    )


def replay_params(args, seed: int) -> dict:
    """``worker_rank``'s parameters for one replay."""
    return dict(peers=args.peers, edges=args.edges, epochs=args.epochs, churn=args.churn,
                seed=seed, tol=args.tol, max_iter=args.max_iter,
                seal_timeout=args.seal_timeout)


def run_schedule(args, sched: dict, workdir: Path, *, seed: int) -> dict:
    """One perturbed full replay; returns the run record with every sink
    digested."""
    import numpy as np

    from ..parallel.dryrun_pod import bit_identity, launch_pod

    state = workdir / f"state-{sched['name']}"
    fleet_dir = workdir / f"fleet-{sched['name']}"
    scores_path = workdir / f"scores-{sched['name']}.npy"
    _write_decoys(fleet_dir, sched["decoy_order"])
    params = replay_params(args, seed)
    launch = launch_schedule(sched, args.processes)

    scraper = _Scraper(fleet_dir, sched["scrape_interval"])
    scraper.start()
    t0 = time.perf_counter()
    error = None
    try:
        workers = launch_pod(params, args.processes, state, device=args.device, backend="gloo",
                             timeout_s=args.timeout, **launch)
        rcs = [0] * args.processes
    except (RuntimeError, TimeoutError) as exc:
        # ``run_ranks`` kills every host once one fails; its message names
        # the host and its exit code.
        error = str(exc)[-2000:]
        rcs = [None] * args.processes
        workers = [{"ok": False, "error": "no worker report"} for _ in range(args.processes)]
    wall = time.perf_counter() - t0
    fleet = scraper.finish()

    if "final_scores" in workers[0]:
        np.save(scores_path, np.asarray(workers[0]["final_scores"]))
    for w in workers:
        w.pop("final_scores", None)

    # -- digest every sink -------------------------------------------------
    acks = {p.name: _sha256_bytes(p.read_bytes()) for p in sorted(state.rglob("acks-h*.jsonl"))}
    manifests = {}
    for p in sorted({p for pattern in DURABLE_JSON for p in state.glob(pattern)}):
        try:
            manifests[str(p.relative_to(state))] = _canonical_json_digest(json.loads(p.read_text()))
        except (OSError, json.JSONDecodeError):
            manifests[str(p.relative_to(state))] = "unreadable"
    epoch_digests = [
        {"epoch": ep["epoch"], "residual": ep["residual"], "scores_sha256": ep["scores_sha256"]}
        for ep in (workers[0].get("epochs") or [])
    ]
    launches: dict = {}
    for w in workers:
        for ep in w.get("epochs") or []:
            for name, k in ep["launches"].items():
                launches[name] = launches.get(name, 0) + k

    scores_sha = proof = None
    if scores_path.exists():
        scores_sha = _sha256_bytes(scores_path.read_bytes())
        proof = _proof_digest(scores_path)

    return {
        "schedule": dict(sched),
        "seed": seed,
        "return_codes": rcs,
        "error": error,
        "workers_ok": [bool(w.get("ok")) and schedule_seen(w, launch) for w in workers],
        "schedule_seen": [w.get("schedule") for w in workers],
        "wall_seconds": wall,
        "wal_ack_digests": acks,
        "manifest_digests": manifests,
        "epoch_digests": epoch_digests,
        "cross_host_bit_identity": bit_identity(workers)["ok"],
        "final_scores_sha256": [w.get("final_scores_sha256") for w in workers],
        "scores_npy_sha256": scores_sha,
        "proof": proof,
        "fleet": fleet,
        "iterations": [ep["iterations"] for ep in (workers[0].get("epochs") or [])],
        "plan_outcomes": [ep["plan_outcome"] for ep in (workers[0].get("epochs") or [])],
        "budget_findings": [f for w in workers for ep in w.get("epochs") or []
                            for f in ep["budget_findings"]],
        "launches": launches,
    }


def _proof_digest(scores_path: Path) -> dict:
    """Commitment proof bytes over the final fixed point, through the
    prover path: quantized scores as public inputs, the leading rows as
    witness ops.  Two bit-identical replays give byte-identical proofs."""
    import numpy as np

    from ..zk.proof import PoseidonCommitmentProver

    scores = np.load(scores_path)
    scale = 1 << 24
    pub_ins = [int(round(float(x) * scale)) for x in scores[:64]]
    ops = [pub_ins[:16], pub_ins[16:32]]
    prover = PoseidonCommitmentProver()
    proof = prover.prove(pub_ins, {"ops": ops})
    return {
        "prover": prover.name,
        "proof_bytes": len(proof),
        "proof_sha256": _sha256_bytes(proof),
        "verified": bool(prover.verify(pub_ins, proof)),
    }


def _checkpointed_scores(state: Path) -> dict:
    """Host 0's checkpointed scores by epoch under a replay's state."""
    from ..node.checkpoint import CheckpointStore
    from ..node.epoch import Epoch

    store = CheckpointStore(state / "host-000" / "checkpoints")
    return {e: store.load(Epoch(e)).scores for e in store.epochs()}


def against_plain(args, card: dict, workdir: Path) -> dict:
    """The baseline schedule's replay (``card``, its state under
    ``workdir``) held against one more replay of the same seed with the
    plain versions on the CPU: host 0's per-epoch iterations and plan
    outcomes equal, residuals within ``2 * PLAIN_L1``, checkpointed and
    final scores within L1 ``PLAIN_L1``."""
    import numpy as np

    from ..parallel.dryrun_pod import launch_pod

    from ..node.checkpoint import SnapshotCorrupt

    name = card["schedule"]["name"]
    state = workdir / "state-plain"
    if card["error"] is not None:
        return {"ok": False, "error": "the replay to compare failed"}
    t0 = time.perf_counter()
    try:
        workers = launch_pod(replay_params(args, card["seed"]), args.processes, state,
                             device="cpu", backend="gloo", timeout_s=args.timeout)
    except (RuntimeError, TimeoutError) as exc:
        return {"ok": False, "error": str(exc)[-2000:], "seconds": time.perf_counter() - t0}
    seconds = time.perf_counter() - t0
    epochs = workers[0]["epochs"]
    residual_diff = [abs(a["residual"] - b["residual"])
                     for a, b in zip(card["epoch_digests"], epochs)]
    try:
        card_ckpt = _checkpointed_scores(workdir / f"state-{name}")
        plain_ckpt = _checkpointed_scores(state)
        card_final = np.load(workdir / f"scores-{name}.npy")
    except (OSError, SnapshotCorrupt) as exc:
        return {"ok": False, "error": repr(exc), "seconds": seconds}
    epoch_l1 = {e: float(np.abs(card_ckpt[e].astype(np.float64) - plain_ckpt[e]).sum())
                for e in sorted(set(card_ckpt) & set(plain_ckpt))}
    final_l1 = float(np.abs(card_final.astype(np.float64) - workers[0]["final_scores"]).sum())
    record = {
        "seconds": seconds,
        "workers_ok": [bool(w["ok"]) for w in workers],
        "iterations": [ep["iterations"] for ep in epochs],
        "plan_outcomes": [ep["plan_outcome"] for ep in epochs],
        "residuals": [ep["residual"] for ep in epochs],
        "residual_diff": residual_diff,
        "epoch_l1": epoch_l1,
        "final_l1": final_l1,
    }
    record["ok"] = bool(
        all(record["workers_ok"])
        and record["iterations"] == card["iterations"]
        and record["plan_outcomes"] == card["plan_outcomes"]
        and len(residual_diff) == args.epochs and max(residual_diff) <= 2 * PLAIN_L1
        and sorted(card_ckpt) == sorted(plain_ckpt) and len(epoch_l1) > 0
        and max(epoch_l1.values()) <= PLAIN_L1
        and final_l1 <= PLAIN_L1
    )
    return record


# -- cross-run comparison -----------------------------------------------------


def compare_runs(a: dict, b: dict) -> dict:
    """Leg-by-leg equality verdicts across two perturbed replays.  Every
    leg must hold; the record names each one."""
    legs = {
        "return_codes": a["return_codes"] == b["return_codes"] == [0] * len(a["return_codes"]),
        "workers_ok": all(a["workers_ok"]) and all(b["workers_ok"]),
        "wal_ack_digests": (
            a["wal_ack_digests"] == b["wal_ack_digests"] and bool(a["wal_ack_digests"])
        ),
        "manifest_digests": (
            a["manifest_digests"] == b["manifest_digests"]
            and bool(a["manifest_digests"])
            and "unreadable" not in a["manifest_digests"].values()
        ),
        "epoch_digests": a["epoch_digests"] == b["epoch_digests"] and bool(a["epoch_digests"]),
        "cross_host_bit_identity": a["cross_host_bit_identity"] and b["cross_host_bit_identity"],
        "final_scores_sha256": (
            a["final_scores_sha256"] == b["final_scores_sha256"]
            and len(set(a["final_scores_sha256"])) == 1
            and a["final_scores_sha256"][0] is not None
        ),
        "scores_npy_bytes": (
            a["scores_npy_sha256"] == b["scores_npy_sha256"] and a["scores_npy_sha256"] is not None
        ),
        "proof_bytes": (
            a["proof"] is not None
            and b["proof"] is not None
            and a["proof"]["proof_sha256"] == b["proof"]["proof_sha256"]
            and a["proof"]["verified"]
            and b["proof"]["verified"]
        ),
        "fleet_merge_order_insensitive": (
            a["fleet"]["aggregate_sha256"] == b["fleet"]["aggregate_sha256"]
            and a["fleet"]["sources"] == b["fleet"]["sources"]
            and bool(a["fleet"]["sources"])
        ),
    }
    return {"ok": all(legs.values()), "legs": legs}


# -- main -----------------------------------------------------------------------


def parse_args(argv=None):
    """The command line, with ``--smoke``'s scale applied."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="DET_smoke.json")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the hosts' device; unset means the card")
    ap.add_argument("--peers", type=int, default=4096)
    ap.add_argument("--edges", type=int, default=32768)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--churn", type=float, default=0.01)
    ap.add_argument("--processes", type=int, default=2, help="pod hosts, one rank each")
    ap.add_argument("--seed", type=int, default=16)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--max-iter", type=int, default=60)
    ap.add_argument("--seal-timeout", type=float, default=120.0)
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds a launch of the hosts may take")
    ap.add_argument("--smoke", action="store_true", help="CI scale")
    ap.add_argument("--seed-divergence", action="store_true",
                    help="self-check: perturb the protocol seed in schedule 2 so every "
                    "digest leg must trip and the probe must exit 1")
    ap.add_argument("--against-plain", action="store_true",
                    help="also replay the baseline schedule with the plain versions on the "
                    "CPU and hold host 0's iterations, residuals and scores against it")
    ap.add_argument("--round", type=int, default=0)
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    if args.smoke:
        args.peers = min(args.peers, 2048)
        args.edges = min(args.edges, 16384)
        args.epochs = min(args.epochs, 3)
    return args


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    from .. import resolve_device
    from ..parallel.dryrun_pod import _jsonable
    from . import card_name_and_limit
    from .crash_matrix import warm_kernels

    # --device unset means the card, and raises here where there is none.
    args.device = resolve_device(args.device).type
    # Build the step's kernels once here, so that no host runs nvcc.
    warm_kernels(args.device, "cuda-windowed")

    tmp_ctx = tempfile.TemporaryDirectory(prefix="divergence_probe-") if args.workdir is None else None
    workdir = Path(args.workdir or tmp_ctx.name)
    workdir.mkdir(parents=True, exist_ok=True)
    try:
        runs = [
            run_schedule(args, sched, workdir,
                         seed=args.seed + (1 if args.seed_divergence and i == 1 else 0))
            for i, sched in enumerate(SCHEDULES)
        ]
        plain = against_plain(args, runs[0], workdir) if args.against_plain else None
    finally:
        if tmp_ctx is not None:
            tmp_ctx.cleanup()

    comparison = compare_runs(runs[0], runs[1])
    scale = f"{args.peers} peers/{args.edges} edges"
    mesh = f"{args.processes}x1"
    launches: dict = {}
    for r in runs:
        for name, k in r["launches"].items():
            launches[name] = launches.get(name, 0) + k
    report = {
        "tool": "divergence_probe",
        "round": args.round,
        "mesh": mesh,
        "n_hosts": args.processes,
        "n_cpus": os.cpu_count(),
        "params": {
            "peers": args.peers, "edges": args.edges, "epochs": args.epochs,
            "churn": args.churn, "tol": args.tol, "max_iter": args.max_iter, "seed": args.seed,
        },
        "seed_divergence_mode": bool(args.seed_divergence),
        "ok": comparison["ok"] and (plain is None or plain["ok"]),
        "skipped": False,
        "comparison": comparison,
        "entries": [{
            "metric": (f"divergence probe full-replay wall-clock ({scale}, {mesh} mesh, "
                       f"{args.epochs} epochs, per perturbed schedule)"),
            "value": sum(r["wall_seconds"] for r in runs) / len(runs),
            "unit": "seconds",
            "n_hosts": args.processes,
            "per_schedule_seconds": [r["wall_seconds"] for r in runs],
            "legs_checked": sorted(comparison["legs"]),
        }],
        "runs": runs,
        "against_plain": plain,
        "device": args.device,
        "nvidia_smi": card_name_and_limit(args.device),
        "launches": launches,
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=2, default=_jsonable) + "\n")
    failed = sorted(k for k, v in comparison["legs"].items() if not v)
    if plain is not None and not plain["ok"]:
        failed.append("against_plain")
    status = "OK" if report["ok"] else f"FAILED {failed}"
    print(f"divergence_probe: {status} on {args.device}; report in {args.out}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
