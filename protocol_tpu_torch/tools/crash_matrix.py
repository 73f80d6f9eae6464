"""Crash matrix: kill -9 the node at every registered fault point and
prove recovery.

For each fault point in the chaos registry (``protocol_tpu_torch/chaos``)
the matrix runs the churned attestation replay in a child process with a
deterministic schedule that **crashes the process at that point**
(``os._exit``, the kill -9 analog: no flush, no atexit), restarts it
against the same directories, and checks the recovery invariants:

- **no acknowledged attestation lost**: every apply the parent saw
  acknowledged before the crash is present in the recovered cache;
- **same fixed point**: after feeding the rest of the stream, the
  recovered run's converged scores match an uncrashed control run
  within ``SCORE_TOL`` (L1; the fixed point is start-independent, which
  is what makes the warm recovered seed safe);
- **proofs still land** after recovery;
- recovery is bounded (``recovery_seconds`` recorded for each entry).

Two torn-write entries ride along (``wal.append`` / ``checkpoint.write``
with the torn fault: a truncated record or snapshot reaches disk and the
process dies), and a **double-crash** entry kills the restarted child
*during recovery itself* (``wal.replay``).  The node phase boots
``python -m protocol_tpu_torch.node.server`` over HTTP, SIGKILLs it
after a checkpointed epoch, restarts it with a delayed replay schedule,
and checks that ``/healthz`` walks ``recovering`` -> ``ok`` with the WAL
metrics populated and every SLO green.  The pod phase runs
``python -m protocol_tpu_torch.parallel.dryrun_pod --chaos-host-loss``.

The workload: P synthetic peers attesting over K neighbours with a
recency-biased churned sender mix, driven through the node's own
Manager -> AttestationWAL -> CheckpointStore -> converge (warm start,
plan cache) -> commitment prover.  Synthetic peers use a fast injective
pk-hash stand-in (Poseidon over many synthetic keys is slow in Python
and irrelevant to durability); the 5-member fixed set keeps its real
Poseidon hashes and real signatures.

The children and the node converge on the card (``--device`` unset,
raising where there is none) or, with ``--device cpu``, on the backend's
plain versions.  Before the first child the parent builds the backend's
kernel libraries once, so no child compiles and no ``recovery_seconds``
includes a compile.  ``--jobs N`` runs N matrix entries and the node
phase at a time (each in its own directories); the control, the run
without the WAL and the pod phase always run alone.

Run::

    python -m protocol_tpu_torch.tools.crash_matrix --smoke --out CHAOS_smoke.json
    python -m protocol_tpu_torch.tools.crash_matrix --backend cuda-csr \\
        --peers 5000 --events 20000 --epochs 5 --out CHAOS.json

Exit 0 = every entry recovered clean; 1 = any invariant violated.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: Synthetic peer keys: y = base + i (injective, never the null point,
#: recognized by the fast-hash override in the child).
SYNTH_Y_BASE = 1 << 40

#: Convergence-tolerance bar for recovered-vs-control scores (L1).
SCORE_TOL = 1e-4

#: The kernel sources each card backend's power step loads, built once
#: by the parent before the first child (``ops/_build.py``); a backend
#: not named here loads none.
STEP_SOURCES = {
    "cuda-csr": ("gather_ds_cumsum", "compensated_scan", "rowsum_tail"),
    "cuda-sparse": ("gather_ds_cumsum", "compensated_scan", "rowsum_tail"),
    "cuda-windowed": (
        "gather_window", "prefix_bridge", "ds_cumsum_rows", "compensated_scan", "rowsum_tail",
    ),
}


# ---------------------------------------------------------------------------
# deterministic workload stream (parent side)
# ---------------------------------------------------------------------------


def build_stream(peers: int, events: int, neighbours: int, seed: int):
    """``events`` wire-encoded synthetic attestations with a
    recency-biased churned sender mix."""
    import numpy as np

    from ..crypto import field
    from ..node.attestation import AttestationData

    rng = np.random.default_rng(seed)
    zero = field.to_le_bytes(0)
    out: list[str] = []
    for _ in range(events):
        # Recency bias: a hot cohort of senders re-attests often.
        if rng.random() < 0.7:
            sender = int(rng.integers(0, max(1, peers // 10)))
        else:
            sender = int(rng.integers(0, peers))
        nbr_ids = rng.choice(peers, size=neighbours, replace=False)
        scores = rng.integers(1, 1000, size=neighbours)
        data = AttestationData(
            sig_r_x=zero,
            sig_r_y=zero,
            sig_s=zero,
            pk=(
                field.to_le_bytes(sender + 1),
                field.to_le_bytes(SYNTH_Y_BASE + sender),
            ),
            neighbours=[
                (
                    field.to_le_bytes(int(j) + 1),
                    field.to_le_bytes(SYNTH_Y_BASE + int(j)),
                )
                for j in nbr_ids
            ],
            scores=[field.to_le_bytes(int(s)) for s in scores],
        )
        out.append(data.to_bytes().hex())
    return out


def sender_of(wire_hex: str) -> str:
    """Sender pk bytes (x‖y): the parent's cache key for ack tracking."""
    return wire_hex[96 * 2 : 160 * 2]


def digest_of(wire_hex: str) -> str:
    return hashlib.sha256(bytes.fromhex(wire_hex)).hexdigest()


# ---------------------------------------------------------------------------
# child worker (runs the node's Manager/WAL/CheckpointStore under chaos)
# ---------------------------------------------------------------------------


def worker_main(args) -> int:
    from .. import chaos
    from ..analysis.cases import launch_counts
    from ..crypto.eddsa import PublicKey
    from ..node.attestation import AttestationData
    from ..node.checkpoint import CheckpointStore
    from ..node.epoch import Epoch
    from ..node.ethereum import ChainEventSource
    from ..node.manager import Manager, ManagerConfig
    from ..node.wal import AttestationWAL, recover

    class MatrixManager(Manager):
        """The node's Manager with a fast injective pk-hash stand-in for
        the synthetic peer keys (durability does not depend on WHICH
        injective id keys a peer's rows; the fixed set keeps real
        Poseidon hashes so the proof path is untouched)."""

        def _pk_hash(self, pk: PublicKey) -> int:
            y = pk.point.y
            if SYNTH_Y_BASE <= y < SYNTH_Y_BASE + (1 << 32):
                return ((y - SYNTH_Y_BASE) << 64) | pk.point.x
            return super()._pk_hash(pk)

    class StubRpc:
        """Tiny in-process RPC backend so the matrix workload exercises
        the rpc.* fault points through the node's ChainEventSource."""

        def __init__(self):
            self.head = 0

        def block_number(self):
            self.head += 1
            return self.head

        def get_logs(self, address, from_block, to_block, topic0):
            return []

    base = Path(args.dir)
    manager = MatrixManager(
        ManagerConfig(
            backend=args.backend, device=args.device, prover="commitment", check_circuit=False
        )
    )
    manager.generate_initial_attestations()
    store = CheckpointStore(base / "checkpoints")
    wal = None
    if args.wal:
        wal = AttestationWAL(base / "checkpoints" / "wal", fsync=args.fsync)
    recovery = recover(manager, store, wal)
    rpc_source = ChainEventSource(StubRpc(), "0x" + "11" * 20)

    out = sys.stdout
    print(json.dumps({"ready": True, "recovery": recovery}), file=out, flush=True)
    for line in sys.stdin:
        cmd = json.loads(line)
        op = cmd["op"]
        if op == "apply_batch":
            t0 = time.perf_counter()
            n = 0
            for wire_hex in cmd["items"]:
                wire = bytes.fromhex(wire_hex)
                k = cmd["neighbours"]
                att = AttestationData.from_bytes(wire, k).to_attestation(k)
                manager.apply_verified(att, raw=wire, flush=False)
                n += 1
            manager.flush_wal()
            print(
                json.dumps({"ok": True, "applied": n, "seconds": time.perf_counter() - t0}),
                file=out,
                flush=True,
            )
        elif op == "epoch":
            number = cmd["number"]
            t0 = time.perf_counter()
            result = manager.converge_epoch(Epoch(number), alpha=0.1, max_iter=80)
            store.save(
                Epoch(number),
                manager.last_graph,
                result.scores,
                None,
                plan=manager.window_plan,
                peer_hashes=manager.last_peer_hashes,
                wal_seq=manager.checkpoint_watermark(),
                attestations=manager.snapshot_attestations(),
            )
            if chaos.ACTIVE:
                chaos.fire("checkpoint.post_save")
            if wal is not None:
                floor = store.retained_wal_floor()
                if floor is not None:
                    wal.truncate_through(floor)
            print(
                json.dumps(
                    {
                        "ok": True,
                        "iterations": int(result.iterations),
                        "peers": int(manager.last_graph.n),
                        "seconds": time.perf_counter() - t0,
                        # Cumulative, so a child that crashes later has
                        # reported its converges' launches already.
                        "launches": launch_counts(),
                    }
                ),
                file=out,
                flush=True,
            )
        elif op == "prove":
            manager.calculate_proofs(Epoch(cmd["number"]))
            print(json.dumps({"ok": True, "proved": True}), file=out, flush=True)
        elif op == "rpc":
            list(rpc_source.replay(from_block=0, to_block=rpc_source._block_number()))
            print(json.dumps({"ok": True}), file=out, flush=True)
        elif op == "state":
            scores = {}
            if manager.last_scores is not None and manager.last_peer_hashes:
                scores = {
                    str(h): float(s)
                    for h, s in zip(manager.last_peer_hashes, manager.last_scores)
                }
            cache = {}
            for h, att in manager.attestations.items():
                wire = AttestationData.from_attestation(att).to_bytes()
                cache[str(h)] = hashlib.sha256(wire).hexdigest()
            print(
                json.dumps(
                    {
                        "ok": True,
                        "cache": cache,
                        "scores": scores,
                        "proofs": sorted(e.number for e in manager.cached_proofs),
                        "hits": chaos.hits(),
                        "launches": launch_counts(),
                    }
                ),
                file=out,
                flush=True,
            )
        elif op == "exit":
            print(json.dumps({"ok": True}), file=out, flush=True)
            return 0
    return 0


# ---------------------------------------------------------------------------
# parent-side child driver
# ---------------------------------------------------------------------------


def child_env(chaos_spec: dict | None = None) -> dict:
    """A child's environment: the port importable from any working
    directory, the chaos schedule given or none, no JAX setting."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    env.pop("PROTOCOL_TPU_CHAOS", None)
    if chaos_spec is not None:
        env["PROTOCOL_TPU_CHAOS"] = json.dumps(chaos_spec)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    return env


class Child:
    """One worker process, driven line by line over its stdin/stdout.
    ``launches`` holds the kernel launches it last reported (a crashed
    child keeps what it reported before it died)."""

    def __init__(self, workdir: Path, args, chaos_spec: dict | None, wal=True):
        cmd = [
            sys.executable,
            "-m",
            "protocol_tpu_torch.tools.crash_matrix",
            "--worker",
            "--dir",
            str(workdir),
            "--backend",
            args.backend,
            "--device",
            args.device,
        ]
        if not wal:
            cmd.append("--no-wal")
        if not args.fsync:
            cmd.append("--no-fsync")
        workdir.mkdir(parents=True, exist_ok=True)
        self.workdir = workdir
        self.launches: dict[str, int] = {}
        args.children.append(self)
        self._stderr = open(workdir / "stderr.log", "a")
        self.proc = subprocess.Popen(
            cmd,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=self._stderr,
            text=True,
            env=child_env(chaos_spec),
            cwd=str(workdir),
        )
        self.ready = self._read()

    def _read(self) -> dict | None:
        line = self.proc.stdout.readline()
        if not line:
            return None
        reply = json.loads(line)
        if "launches" in reply:
            self.launches = reply["launches"]
        return reply

    def call(self, **cmd) -> dict | None:
        """One command round-trip; None = the child died (crashed)."""
        try:
            self.proc.stdin.write(json.dumps(cmd) + "\n")
            self.proc.stdin.flush()
        except (BrokenPipeError, OSError):
            return None
        return self._read()

    def close(self) -> int:
        try:
            self.call(op="exit")
        except (OSError, ValueError):  # a dying child's pipe or half a line
            pass
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        rc = self.proc.wait(timeout=60)
        self._stderr.close()
        return rc


def child_launches(args) -> dict[str, int]:
    """The kernel launches every child of this run reported
    (``args.children``), summed by wrapper."""
    total: dict[str, int] = {}
    for child in args.children:
        for name, n in child.launches.items():
            total[name] = total.get(name, 0) + n
    return total


def run_stream(child: Child, stream, args, acked: list | None = None):
    """Feed the full workload; returns (crashed_at_op | None, timing).
    ``acked`` collects indices of acknowledged apply batches."""
    batch, batch_idx = [], 0
    apply_seconds = 0.0
    epoch_seconds: list[float] = []
    epoch_no = 0
    per_epoch = max(1, len(stream) // max(1, args.epochs))
    for i, wire_hex in enumerate(stream):
        batch.append(wire_hex)
        end_of_epoch = (i + 1) % per_epoch == 0 or i + 1 == len(stream)
        if len(batch) >= args.batch or end_of_epoch:
            ack = child.call(op="apply_batch", items=batch, neighbours=args.neighbours)
            if ack is None:
                return f"apply_batch:{batch_idx}", (apply_seconds, epoch_seconds)
            apply_seconds += ack["seconds"]
            if acked is not None:
                acked.append(batch_idx)
            batch, batch_idx = [], batch_idx + 1
        if end_of_epoch:
            for op in (
                {"op": "rpc"},
                {"op": "epoch", "number": epoch_no},
                {"op": "prove", "number": epoch_no},
            ):
                ack = child.call(**op)
                if ack is None:
                    return f"{op['op']}:{epoch_no}", (apply_seconds, epoch_seconds)
                if op["op"] == "epoch":
                    epoch_seconds.append(ack["seconds"])
            epoch_no += 1
    return None, (apply_seconds, epoch_seconds)


def batch_bounds(stream, args):
    """[(batch_idx, [event indices])] mirroring run_stream's batching."""
    out, batch, idx = [], [], 0
    per_epoch = max(1, len(stream) // max(1, args.epochs))
    for i in range(len(stream)):
        batch.append(i)
        if len(batch) >= args.batch or (i + 1) % per_epoch == 0 or i + 1 == len(stream):
            out.append((idx, batch))
            batch, idx = [], idx + 1
    return out


def expected_cache(stream, args, upto_batch: int) -> dict[str, str]:
    """Per-sender last acked digest after ``upto_batch`` batches."""
    out: dict[str, str] = {}
    for idx, events in batch_bounds(stream, args):
        if idx >= upto_batch:
            break
        for i in events:
            out[sender_of(stream[i])] = digest_of(stream[i])
    return out


def lost_attestations(stream, args, n_acked: int, cache: dict[str, str]) -> list[str]:
    """The acknowledged senders (first 16 hex digits) whose last acked
    attestation the recovered ``cache`` (sender hash -> wire digest)
    lacks.  A newer digest from the written-but-unacked in-flight tail
    counts as kept: both are on disk, neither was lost."""
    later: dict[str, list[str]] = {}
    for idx, events in batch_bounds(stream, args):
        if idx >= n_acked:
            for i in events:
                later.setdefault(sender_of(stream[i]), []).append(digest_of(stream[i]))
    lost = []
    for sender, digest in expected_cache(stream, args, upto_batch=n_acked).items():
        got = cache.get(sender_hash_str(sender))
        if got is None or (got != digest and got not in later.get(sender, ())):
            lost.append(sender[:16])
    return lost


# ---------------------------------------------------------------------------
# matrix entries
# ---------------------------------------------------------------------------


def run_entry(args, stream, point, spec_fault, control, tmp: Path, crash_in_recovery=False):
    """One matrix row: crash the workload at ``point``, restart, verify."""
    from .. import chaos as chaos_mod

    entry = {"point": point, "fault": spec_fault.get("kind", "crash"), "ok": False}
    workdir = tmp / point.replace(".", "_") / spec_fault.get("kind", "crash")
    workdir.mkdir(parents=True, exist_ok=True)

    if crash_in_recovery:
        # Phase 0 of the recovery-crash entry: land some state, then die
        # at a late apply so the NEXT boot has a tail to replay.
        first_spec = {
            "seed": args.seed,
            "faults": [
                {
                    "point": "ingest.pre_apply",
                    "kind": "crash",
                    "after": control["hits"]["ingest.pre_apply"] * 3 // 4,
                }
            ],
        }
    else:
        first_spec = {"seed": args.seed, "faults": [spec_fault]}
    acked: list[int] = []
    child = Child(workdir, args, first_spec)
    if child.ready is None:
        entry["error"] = "child failed to boot"
        return entry
    crashed_at, _ = run_stream(child, stream, args, acked)
    if crashed_at is None:
        entry["error"] = f"fault at {point} never crashed the child"
        child.close()
        return entry
    rc = child.proc.wait(timeout=60)
    if rc != chaos_mod.CRASH_EXIT_CODE:
        entry["error"] = f"child exited rc={rc}, expected chaos crash"
        return entry
    entry["crashed_at"] = crashed_at
    entry["acked_batches"] = len(acked)

    if crash_in_recovery:
        # Restart WITH a schedule that kills the replay mid-recovery,
        # then restart again clean: recovery must itself be crash-safe.
        crash_child = Child(workdir, args, {"seed": args.seed, "faults": [spec_fault]})
        mid_rc = None
        if crash_child.ready is None:
            mid_rc = crash_child.proc.wait(timeout=60)
        else:  # replay too short to hit the scheduled point: still fine
            crash_child.close()
        entry["recovery_crash_rc"] = mid_rc

    # Clean restart: recovery must find every acked attestation.
    resumed = Child(workdir, args, None)
    if resumed.ready is None:
        entry["error"] = "resumed child failed to boot"
        return entry
    recovery = resumed.ready["recovery"]
    entry["recovery"] = recovery
    entry["recovery_seconds"] = recovery["seconds"]
    state = resumed.call(op="state")
    if state is None:
        entry["error"] = "resumed child died before reporting its state"
        return entry
    lost = lost_attestations(stream, args, len(acked), dict(state["cache"]))
    entry["lost_attestations"] = len(lost)

    # Feed the remainder, converge the final epoch, compare to control.
    tail_start = sum(len(ev) for idx, ev in batch_bounds(stream, args) if idx < len(acked))
    tail = stream[tail_start:]
    crashed2, _ = run_stream(resumed, tail, args)
    if crashed2 is not None:
        entry["error"] = f"resumed child crashed at {crashed2}"
        return entry
    final = resumed.call(op="state")
    resumed.close()
    if final is None:
        entry["error"] = "resumed child died before its final state"
        return entry
    entry["score_l1"] = score_l1(control["state"]["scores"], final["scores"])
    entry["proofs_landed"] = len(final["proofs"])
    cache_match = final["cache"] == control["state"]["cache"]
    entry["cache_matches_control"] = cache_match
    entry["ok"] = (
        not lost
        and cache_match
        and entry["score_l1"] <= SCORE_TOL
        and entry["proofs_landed"] >= 1
    )
    if not entry["ok"] and "error" not in entry:
        entry["error"] = "invariant violated (see fields)"
    return entry


def sender_hash_str(sender_hex: str) -> str:
    """Parent-side mirror of MatrixManager's fast synthetic pk hash."""
    from ..crypto import field

    raw = bytes.fromhex(sender_hex)
    x = field.from_le_bytes(raw[:32])
    y = field.from_le_bytes(raw[32:])
    return str(((y - SYNTH_Y_BASE) << 64) | x)


def score_l1(a: dict, b: dict) -> float:
    keys = set(a) | set(b)
    return float(sum(abs(a.get(k, 0.0) - b.get(k, 0.0)) for k in keys))


# ---------------------------------------------------------------------------
# node-level phase: /healthz walks recovering -> ok across kill -9
# ---------------------------------------------------------------------------


def http_get(port: int, path: str, timeout=2.0):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def node_phase(args, tmp: Path) -> dict:
    """Boot ``python -m protocol_tpu_torch.node.server``, accept an
    attestation, kill -9 after a checkpointed epoch, restart with a
    slowed replay, and check the /healthz walk, the WAL metrics and the
    SLOs."""
    import http.client
    import socket

    from ..crypto import calculate_message_hash
    from ..crypto.eddsa import sign
    from ..node.attestation import Attestation, AttestationData
    from ..node.bootstrap import FIXED_SET, keyset_from_raw

    entry: dict = {"point": "node.restart", "fault": "sigkill", "ok": False}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    node_dir = tmp / "node"
    node_dir.mkdir(parents=True, exist_ok=True)
    cfg = {
        "epoch_interval": 4,
        "endpoint": [[127, 0, 0, 1], port],
        "trust_backend": args.node_backend,
        "device": args.device,
        "prover": "commitment",
        "checkpoint_dir": str(node_dir / "checkpoints"),
        "ingest_plane": True,
        "ingest_workers": 0,
    }
    cfg_path = node_dir / "config.json"
    cfg_path.write_text(json.dumps(cfg))

    def boot(chaos_spec=None, log="server.log"):
        with open(node_dir / log, "w") as out:
            return subprocess.Popen(
                [sys.executable, "-m", "protocol_tpu_torch.node.server", "--config", str(cfg_path)],
                env=child_env(chaos_spec),
                cwd=str(node_dir),
                stdout=out,
                stderr=subprocess.STDOUT,
            )

    def wait_http(path, pred, deadline=90.0, interval=0.2):
        t0 = time.time()
        while time.time() - t0 < deadline:
            try:
                status, body = http_get(port, path)
                if pred(status, body):
                    return True, body
            except OSError:
                pass
            time.sleep(interval)
        return False, ""

    sks, pks = keyset_from_raw(FIXED_SET)

    def post_att(sender: int, scores: list[int]) -> bool:
        _, msgs = calculate_message_hash(pks, [scores])
        sig = sign(sks[sender], pks[sender], msgs[0])
        att = Attestation(sig=sig, pk=pks[sender], neighbours=list(pks), scores=scores)
        payload = AttestationData.from_attestation(att).to_bytes()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        try:
            conn.request("POST", "/attestation", body=payload)
            resp = conn.getresponse()
            return resp.status == 200 and json.loads(resp.read().decode()).get("accepted", False)
        finally:
            conn.close()

    t_boot = time.perf_counter()
    proc = boot()
    try:
        ok, _ = wait_http("/status", lambda s, b: s == 200)
        if not ok:
            entry["error"] = "node never served /status"
            return entry
        entry["boot_to_status_s"] = time.perf_counter() - t_boot
        # Signed fixed-set attestations through POST /attestation.
        if not post_att(0, [217, 183, 200, 200, 200]):
            entry["error"] = "attestation not accepted"
            return entry
        # Wait for a checkpointed epoch...
        ok, _ = wait_http(
            "/metrics",
            lambda s, b: s == 200
            and any(
                line.startswith("eigentrust_checkpoint_saves_total")
                and float(line.split()[-1]) >= 1
                for line in b.splitlines()
            ),
        )
        if not ok:
            entry["error"] = "no checkpoint before kill"
            return entry
        # ...then land one MORE accepted attestation past the snapshot
        # (it lives only in the WAL) and kill -9 before the next tick.
        if not post_att(1, [190, 210, 200, 200, 200]):
            entry["error"] = "post-checkpoint attestation not accepted"
            return entry
    finally:
        proc.kill()  # SIGKILL: the point of the exercise
        proc.wait(timeout=30)

    # Restart with a slowed WAL replay so the recovering window is
    # scrapeable, and record the /healthz walk.
    slow = {
        "seed": 0,
        "faults": [{"point": "wal.replay", "kind": "delay", "delay_s": args.replay_delay_s}],
    }
    proc = boot(slow, "server_restart.log")
    walk: list[str] = []
    try:
        t0 = time.time()
        deadline = 120.0
        while time.time() - t0 < deadline:
            try:
                status, body = http_get(port, "/healthz")
            except OSError:
                time.sleep(0.05)
                continue
            obj = json.loads(body)
            state = obj.get("components", {}).get("recovery", {}).get("state")
            if not walk or walk[-1] != state:
                walk.append(state)
            if (
                state == "ok"
                and obj.get("status") == "ok"
                and obj["components"]["recovery"].get("wal_replayed", 0) >= 1
            ):
                break
            time.sleep(0.05)
        entry["healthz_walk"] = walk
        entry["restart_to_ok_s"] = time.time() - t0
        _, metrics = http_get(port, "/metrics")
        wal_replayed = recovery_s = 0.0
        for line in metrics.splitlines():
            if line.startswith("eigentrust_wal_replayed_total"):
                wal_replayed = float(line.split()[-1])
            if line.startswith("eigentrust_recovery_seconds"):
                recovery_s = float(line.split()[-1])
        _, slo = http_get(port, "/slo")
        entry["wal_replayed"] = wal_replayed
        entry["recovery_seconds"] = recovery_s
        slo_obj = json.loads(slo)
        entry["slo_ok"] = bool(slo_obj.get("ok"))
        entry["slo_violating"] = sorted(
            k for k, o in slo_obj.get("objectives", {}).items() if not o.get("ok")
        )
        entry["ok"] = (
            walk[-1:] == ["ok"]
            and "recovering" in walk
            and wal_replayed >= 1
            and recovery_s > 0
            and entry["slo_ok"]
        )
        if not entry["ok"]:
            entry["error"] = f"healthz walk {walk}, slo_ok={entry.get('slo_ok')}"
    finally:
        proc.kill()
        proc.wait(timeout=30)
    return entry


def pod_phase(args, tmp: Path) -> dict:
    """Host-loss row: kill one process of a 2-host pod mid-epoch and
    prove pod recovery.  Delegates to ``python -m
    protocol_tpu_torch.parallel.dryrun_pod --smoke --chaos-host-loss``: a
    control pod run, a run that ``os._exit``\\ s one host after its WAL
    ack but before converge, and a whole-pod resume that must replay the
    dead host's WAL shard with zero acknowledged loss and reconverge to a
    fixed point **bit-identical** to the control run's."""
    entry: dict = {"point": "pod.host-loss", "fault": "kill -9 host 1 of 2"}
    out = tmp / "pod_chaos.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [
            sys.executable,
            "-m",
            "protocol_tpu_torch.parallel.dryrun_pod",
            "--smoke",
            "--chaos-host-loss",
            "--device", args.device,
            "--workdir", str(tmp / "pod"),
            "--out", str(out),
        ],
        cwd=str(tmp),
        env=child_env(),
        stdout=subprocess.DEVNULL,
        timeout=3000,
    )
    entry["seconds"] = round(time.perf_counter() - t0, 3)
    try:
        report = json.loads(out.read_text())
    except (OSError, json.JSONDecodeError) as exc:
        entry.update(ok=False, error=f"no dryrun_pod report: {exc!r}")
        return entry
    chaos = report.get("chaos") or {}
    entry.update(
        crash_host=chaos.get("crash_host"),
        crash_epoch=chaos.get("crash_epoch"),
        recovery_seconds=chaos.get("recovery_seconds"),
        lost_attestations=sum(len(x) for x in chaos.get("lost_acked", []) if x),
        fixed_point_matches_control=chaos.get("fixed_point_matches_control"),
        residual_bit_identity=(chaos.get("residual_bit_identity") or {}).get("ok"),
        ok=bool(proc.returncode == 0 and chaos.get("ok")),
    )
    if not entry["ok"]:
        entry["error"] = f"dryrun_pod rc={proc.returncode}, chaos={chaos.get('ok')}"
    return entry


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def control_run(args, stream, tmp: Path) -> tuple[dict, float, tuple]:
    """The counting-mode control: the whole stream, no faults.  Returns
    (control state and hits, seconds, (apply_s, epoch_s)), or raises
    ``RuntimeError`` if the control itself crashed."""
    t_control = time.perf_counter()
    control_child = Child(tmp / "control", args, {"seed": args.seed, "faults": []})
    if control_child.ready is None:
        raise RuntimeError("control child failed to boot")
    crashed, timing = run_stream(control_child, stream, args)
    if crashed is not None:
        raise RuntimeError(f"control run crashed at {crashed}")
    state = control_child.call(op="state")
    control_child.close()
    if state is None:
        raise RuntimeError("control child died before reporting its state")
    return {"state": state, "hits": state["hits"]}, time.perf_counter() - t_control, timing


def matrix_faults(registry, hits) -> list[tuple[str, dict, bool]]:
    """The matrix's rows, in order: (point, fault, crash_in_recovery)."""
    rows = []
    for point in sorted(registry):
        if point == "wal.replay":
            # Double crash: the schedule kills the RESTARTED child during
            # its own recovery replay, then a third boot must still
            # recover clean: recovery is itself crash-safe.
            rows.append((point, {"point": point, "kind": "crash", "after": 2}, True))
        elif hits.get(point, 0):
            rows.append(
                (point, {"point": point, "kind": "crash", "after": max(1, hits[point] // 2)}, False)
            )
    # Torn-write rows: a truncated record / snapshot reaches disk and the
    # process dies (then_crash arms the next fired point).
    for point in ("wal.append", "checkpoint.write"):
        if hits.get(point, 0):
            fault = {"point": point, "kind": "torn", "at": 24, "after": max(1, hits[point] // 2)}
            rows.append((point, fault, False))
    return rows


def warm_kernels(device: str, *backends: str) -> None:
    """Build the backends' kernel libraries once, here, so that no child
    or epoch tick runs ``nvcc`` and no recovery time includes a compile."""
    if device != "cuda":
        return
    from ..ops import _build

    _build.build(tuple(sorted({name for b in backends for name in STEP_SOURCES.get(b, ())})))


def parse_args(argv=None):
    """The command line, with ``--smoke``'s scale applied."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--backend", default="cuda-windowed")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the children and the node converge; unset means the card")
    ap.add_argument("--peers", type=int, default=2000)
    ap.add_argument("--events", type=int, default=6000)
    ap.add_argument("--neighbours", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=14)
    ap.add_argument("--smoke", action="store_true", help="CI scale")
    ap.add_argument("--no-wal", dest="wal", action="store_false", default=True)
    ap.add_argument("--no-fsync", dest="fsync", action="store_false", default=True)
    ap.add_argument("--skip-node-phase", action="store_true")
    ap.add_argument("--skip-pod-phase", action="store_true")
    ap.add_argument("--replay-delay-s", type=float, default=0.4)
    ap.add_argument("--jobs", type=int, default=1, help="matrix entries run at a time")
    ap.add_argument("--round", type=int, default=1)
    ap.add_argument("--out", default="CHAOS_smoke.json")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    # Every child this run starts, for the kernel-launch total.
    args.children = []
    # The node phase boots the server on the CSR backend.
    args.node_backend = "cuda-csr"
    if args.smoke and not args.worker:
        # CI scale: a small stream.  The backend stays a card backend, so
        # the children converge on the card (or, with --device cpu, on the
        # same backend's plain versions).
        args.peers, args.events, args.epochs = 120, 600, 3
        args.backend = "cuda-csr"
    return args


def main(argv=None) -> int:
    args = parse_args(argv)

    if args.worker:
        return worker_main(args)

    from .. import chaos as chaos_mod
    from .. import resolve_device
    from . import card_name_and_limit

    # --device unset means the card, and raises here where there is none.
    args.device = resolve_device(args.device).type

    # Importing the node tree registers every fault point.
    import protocol_tpu_torch.node.checkpoint  # noqa: F401
    import protocol_tpu_torch.node.ethereum  # noqa: F401
    import protocol_tpu_torch.node.server  # noqa: F401
    import protocol_tpu_torch.node.wal  # noqa: F401

    registry = chaos_mod.registry()
    warm_kernels(args.device, args.backend, args.node_backend)
    keep = tempfile.TemporaryDirectory(prefix="chaos_") if args.workdir is None else None
    tmp = Path(args.workdir or keep.name)
    try:
        report = run_matrix(args, registry, tmp)
    finally:
        if keep is not None:
            keep.cleanup()
    report["nvidia_smi"] = card_name_and_limit(args.device)
    Path(args.out).write_text(json.dumps(report, indent=2) + "\n")
    for e in report["entries_detail"]:
        status = "OK " if e.get("ok") else "FAIL"
        print(
            f"  [{status}] {e['point']} ({e.get('fault')}): "
            f"crashed_at={e.get('crashed_at', 'sigkill')} "
            f"recovery={e.get('recovery_seconds')}s "
            f"lost={e.get('lost_attestations', '-')} l1={e.get('score_l1', '-')}"
            + (f"  ERROR: {e['error']}" if "error" in e else "")
        )
    if report["not_exercised"]:
        print(
            f"crash_matrix: points never exercised by the workload: {report['not_exercised']}",
            file=sys.stderr,
        )
    if report.get("error"):
        print(f"crash_matrix: {report['error']}", file=sys.stderr)
    print(
        f"crash_matrix: {'OK' if report['ok'] else 'FAILED'}: "
        f"{len(report['entries_detail'])} entries on {args.device}, median recovery "
        f"{report['entries'][0]['recovery_seconds']}s, WAL overhead "
        f"{report['wal_overhead']['pct_of_epoch']}% of the epoch ({args.out})"
    )
    return 0 if report["ok"] else 1


def run_matrix(args, registry, tmp: Path) -> dict:
    """The control, the run without the WAL, the matrix, and the node
    and pod phases; returns the report."""
    stream = build_stream(args.peers, args.events, args.neighbours, args.seed)
    scale = {
        "peers": args.peers,
        "events": args.events,
        "neighbours": args.neighbours,
        "epochs": args.epochs,
        "backend": args.backend,
    }
    report = {"n": args.round, "tool": "crash_matrix", "device": args.device, "scale": scale,
              "registry": registry, "jobs": args.jobs}

    # -- control: counting-mode run, full stream, no faults -------------
    try:
        control, control_seconds, (apply_s, epoch_s) = control_run(args, stream, tmp)
    except RuntimeError as exc:
        report.update(ok=False, error=str(exc), not_exercised=[], entries_detail=[],
                      entries=[{"recovery_seconds": None}], wal_overhead={"pct_of_epoch": None},
                      launches=child_launches(args))
        return report

    # -- WAL overhead: same stream without the WAL ----------------------
    nowal_child = Child(tmp / "nowal", args, None, wal=False)
    _, (apply_nowal, _) = run_stream(nowal_child, stream, args)
    nowal_child.close()
    per_event_overhead = max(0.0, (apply_s - apply_nowal)) / max(1, len(stream))
    events_per_epoch = len(stream) / max(1, args.epochs)
    mean_epoch_s = sum(epoch_s) / max(1, len(epoch_s))
    wal_overhead_pct = (
        100.0 * per_event_overhead * events_per_epoch / mean_epoch_s if mean_epoch_s else 0.0
    )

    # -- the matrix ------------------------------------------------------
    hits = control["hits"]
    # wal.replay only fires on a RESTART's recovery: the control run (one
    # boot, fresh dirs) never replays; its double-crash entry exercises it.
    not_exercised = sorted(p for p in registry if hits.get(p, 0) == 0 and p != "wal.replay")
    rows = matrix_faults(registry, hits)
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, args.jobs)) as pool:
        futures = [
            pool.submit(run_entry, args, stream, point, fault, control, tmp, crash_in_recovery=rec)
            for point, fault, rec in rows
        ]
        # The node phase has its own directory and port: with --jobs > 1
        # it runs beside the last entries.
        if not args.skip_node_phase:
            futures.append(pool.submit(node_phase, args, tmp))
        entries = [f.result() for f in futures]

    if not args.skip_pod_phase:
        entries.append(pod_phase(args, tmp))

    recoveries = [e["recovery_seconds"] for e in entries if e.get("recovery_seconds") is not None]
    recovery_seconds = sorted(recoveries)[len(recoveries) // 2] if recoveries else None
    ok = all(e.get("ok") for e in entries) and not not_exercised
    label = f"{args.peers} peers/{args.events} events, {args.backend}"
    report.update(
        control={
            "seconds": round(control_seconds, 3),
            "apply_seconds": round(apply_s, 3),
            "apply_seconds_no_wal": round(apply_nowal, 3),
            "mean_epoch_seconds": round(mean_epoch_s, 4),
            "epoch_seconds": epoch_s,
            "hits": hits,
            "proofs": control["state"]["proofs"],
        },
        wal_overhead={
            "per_event_us": round(per_event_overhead * 1e6, 2),
            "pct_of_epoch": round(wal_overhead_pct, 3),
        },
        not_exercised=not_exercised,
        entries_detail=entries,
        entries=[
            {
                "metric": f"crash-matrix recovery ({label})",
                "recovery_seconds": recovery_seconds,
                "wal_overhead_pct": round(wal_overhead_pct, 3),
            }
        ],
        # Kernel launches the children reported, by wrapper (the node
        # phase's server processes are killed with SIGKILL and report none).
        launches=child_launches(args),
        ok=ok,
    )
    return report


if __name__ == "__main__":
    sys.exit(main())
