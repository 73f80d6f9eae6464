"""Epoch-indexed snapshots of the assembled trust graph and scores.

The port's copy of the reference package's store: the files are the
same byte for byte (columns, dtypes, digests, the plan sidecar), so
either package loads a snapshot the other saved.

The reference has no durable node state: the chain is the checkpoint
and every boot replays events from block 0 (server/src/main.rs:139-143).
The rebuild keeps the chain as the *source of truth* but no longer
treats snapshots as a mere optimization: together with the write-ahead
attestation log (node/wal.py) they are the crash-consistent recovery
state — at 50M attestations a from-zero replay is not a viable boot
path, so a snapshot must be **provably loadable or provably skippable**.

Format: ``<dir>/epoch_<N>.npz`` (numpy arrays) + ``manifest.json``.
The manifest carries, per retained epoch, a **sha256 digest of every
column** (dtype + shape + bytes), the digests of the plan sidecar and
proof document, and the WAL watermark ``wal_seq`` (all records ≤ it
are inside this snapshot's graph); it also persists the chain-replay
``block_cursor`` so event ingestion resumes where it left off instead
of from block 0.  ``load`` verifies the digests and raises
:class:`SnapshotCorrupt` on any mismatch or decode failure;
``load_latest`` falls back epoch by epoch to the newest snapshot that
verifies (finally giving ``keep=4`` a reason to exist), counting each
skip on ``eigentrust_checkpoint_fallbacks_total`` and journaling it.
Writes are atomic (tmp + fsync + rename) and carry the
``checkpoint.write`` / ``checkpoint.pre_rename`` fault points the
crash matrix kills at.

The snapshot optionally carries a ``peer_hashes`` column (Poseidon
hash per score row, graph assembly order) — the key the warm-start
remap needs — and, on the windowed backends, the bucketing plan rides
along as ``epoch_<N>.plan.npz`` with its delta lineage; a sidecar from
a stale plan-format version (or one failing its digest) degrades to a
rebuild on first converge, never a boot failure.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .. import chaos
from ..obs import TRACER
from ..obs.journal import JOURNAL
from ..obs.metrics import (
    CHECKPOINT_FALLBACKS,
    CHECKPOINT_RESTORES,
    CHECKPOINT_SAVES,
)
from ..ops.gather_window import WindowPlan
from ..trust.graph import TrustGraph
from .epoch import Epoch

chaos.declare("checkpoint.write", "snapshot bytes streaming into the atomic tmp (torn target)")
chaos.declare("checkpoint.pre_rename", "atomic write complete, before the rename lands")


class SnapshotCorrupt(Exception):
    """A snapshot failed digest verification or could not be decoded —
    the typed error ``load_latest`` falls back on (callers of ``load``
    see this instead of whatever npz/JSON internals raise)."""


@dataclass
class Snapshot:
    epoch: Epoch
    graph: TrustGraph
    scores: np.ndarray | None
    proof_json: str | None = None
    plan: WindowPlan | None = None
    #: Peer hash per score row (graph assembly order) — the key the
    #: warm-start remap needs, so a reboot's first epoch starts from
    #: the checkpointed fixed point instead of cold.
    peer_hashes: list[int] | None = None
    #: WAL watermark: every log record with seq ≤ this is inside the
    #: snapshot's graph, so boot replay starts just past it.  None on
    #: legacy snapshots (replay everything; apply is idempotent).
    wal_seq: int | None = None
    #: The attestation cache itself, ``(num_neighbours, wire bytes)``
    #: per sender (last-wins) — the recovery state the graph column
    #: alone cannot reconstruct: post-recovery epochs rebuild the graph
    #: FROM the cache, and the WAL only holds the tail past ``wal_seq``.
    attestations: list[tuple[int, bytes]] | None = None


def _digest(arr: np.ndarray) -> str:
    """sha256 over dtype ‖ shape ‖ bytes — a flipped bit, truncated
    column, or silently re-typed array all change it."""
    arr = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(str(arr.dtype).encode())
    h.update(repr(arr.shape).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def _text_digest(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


class CheckpointStore:
    def __init__(self, directory: str | Path, keep: int = 4):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _path(self, epoch: Epoch) -> Path:
        return self.dir / f"epoch_{epoch.number}.npz"

    def _atomic_write(self, dest: Path, write_fn, mode: str) -> None:
        """tmp + fsync + rename with cleanup on failure — the data
        blocks are forced to disk *before* the rename publishes them,
        so a crash leaves either the old file or the complete new one,
        never a renamed torn body."""
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, mode) as f:
                target = f
                if chaos.ACTIVE:
                    target = chaos.wrap_file("checkpoint.write", f)
                write_fn(target)
                f.flush()
                os.fsync(f.fileno())
            if chaos.ACTIVE:
                chaos.fire("checkpoint.pre_rename")
            os.replace(tmp, dest)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    # -- manifest -------------------------------------------------------

    def _read_manifest(self) -> dict:
        """Tolerant manifest read: a torn or garbage manifest is an
        empty one (the directory scan still finds snapshots; digests
        are then simply unavailable for verification)."""
        manifest = self.dir / "manifest.json"
        try:
            obj = json.loads(manifest.read_text())
        except (OSError, json.JSONDecodeError):
            return {}
        return obj if isinstance(obj, dict) else {}

    def _write_manifest(self, obj: dict) -> None:
        self._atomic_write(
            self.dir / "manifest.json", lambda f: json.dump(obj, f), "w"
        )

    def retained_wal_floor(self) -> int | None:
        """Highest WAL seq the log may truncate through: the MINIMUM
        ``wal_seq`` across every retained snapshot — fallback must be
        able to recover from the *oldest* retained epoch, so records
        its snapshot lacks have to stay replayable.  (Pre-WAL legacy
        snapshots carry no watermark and are excluded: their recovery
        replays the whole remaining log anyway.)  None = nothing to
        truncate against yet."""
        entries = self._read_manifest().get("epochs", {})
        seqs = [
            int(e["wal_seq"])
            for e in entries.values()
            if isinstance(e, dict) and e.get("wal_seq") is not None
        ]
        return min(seqs) if seqs else None

    def block_cursor(self) -> int | None:
        """The persisted chain-replay cursor (next block to fetch), or
        None for a from-genesis replay."""
        cursor = self._read_manifest().get("block_cursor")
        return int(cursor) if cursor is not None else None

    def save_block_cursor(self, next_block: int) -> None:
        """Persist the event stream's resume point — called by the
        node as the chain replay advances, so a restart resumes from
        here instead of block 0."""
        manifest = self._read_manifest()
        manifest["block_cursor"] = int(next_block)
        self._write_manifest(manifest)

    # -- save -----------------------------------------------------------

    def save(
        self,
        epoch: Epoch,
        graph: TrustGraph,
        scores=None,
        proof_json: str | None = None,
        plan: WindowPlan | None = None,
        peer_hashes: list[int] | None = None,
        wal_seq: int | None = None,
        attestations: list[tuple[int, bytes]] | None = None,
    ) -> Path:
        CHECKPOINT_SAVES.inc()
        path = self._path(epoch)
        payload = {
            "n": np.int64(graph.n),
            "src": graph.src,
            "dst": graph.dst,
            "weight": graph.weight,
        }
        if attestations is not None:
            # The cache as three flat columns: per-record neighbour
            # count, cumulative end offsets, and the concatenated wire
            # bytes — no pickling, digest-verified like every column.
            lengths = np.array([len(w) for _, w in attestations], np.int64)
            payload["att_nbrs"] = np.array(
                [n for n, _ in attestations], np.int32
            )
            payload["att_offsets"] = np.cumsum(lengths, dtype=np.int64)
            payload["att_wire"] = np.frombuffer(
                b"".join(w for _, w in attestations), np.uint8
            )
        if graph.pre_trusted is not None:
            payload["pre_trusted"] = graph.pre_trusted
        if scores is not None:
            payload["scores"] = np.asarray(scores, dtype=np.float64)
        if peer_hashes is not None:
            # Poseidon hashes are field elements < 2^254: 32 bytes each,
            # big-endian, one fixed-width bytes row per score row.
            payload["peer_hashes"] = np.array(
                [h.to_bytes(32, "big") for h in peer_hashes], dtype="S32"
            )

        entry: dict = {
            "columns": {k: _digest(np.asarray(v)) for k, v in payload.items()}
        }
        if wal_seq is not None:
            entry["wal_seq"] = int(wal_seq)
        self._atomic_write(path, lambda f: np.savez_compressed(f, **payload), "wb")
        if plan is not None:
            # Uncompressed: the plan is int/float index arrays that
            # barely compress, and the save sits on the epoch tick.
            plan_arrays = plan.to_arrays(core_only=True)
            entry["plan"] = {
                k: _digest(np.asarray(v)) for k, v in plan_arrays.items()
            }
            self._atomic_write(
                self.dir / f"epoch_{epoch.number}.plan.npz",
                lambda f: np.savez(f, **plan_arrays),
                "wb",
            )
        if proof_json is not None:
            entry["proof"] = _text_digest(proof_json)
            self._atomic_write(
                self.dir / f"epoch_{epoch.number}.proof.json",
                lambda f: f.write(proof_json),
                "w",
            )
        manifest = self._read_manifest()
        epochs_meta = manifest.get("epochs")
        if not isinstance(epochs_meta, dict):
            epochs_meta = {}
        epochs_meta[str(epoch.number)] = entry
        kept = self._prune()
        manifest.update(
            {
                "latest_epoch": epoch.number,
                "epochs": {
                    k: v for k, v in epochs_meta.items() if int(k) in kept
                },
            }
        )
        self._write_manifest(manifest)
        return path

    def _prune(self) -> set[int]:
        snaps = sorted(self.epochs())
        for number in snaps[: -self.keep]:
            self._path(Epoch(number)).unlink(missing_ok=True)
            (self.dir / f"epoch_{number}.proof.json").unlink(missing_ok=True)
            (self.dir / f"epoch_{number}.plan.npz").unlink(missing_ok=True)
        return set(snaps[-self.keep :])

    def epochs(self) -> list[int]:
        # Sidecar files (epoch_N.plan.npz) share the prefix and glob;
        # only bare epoch_N.npz snapshots define the epoch set.  The
        # scan is sorted numerically: glob order is inode-history-
        # dependent, and this list feeds prune order and the boot-time
        # latest() pick, which must match across hosts bit for bit.
        return sorted(
            int(p.stem.removeprefix("epoch_"))
            for p in self.dir.glob("epoch_*.npz")
            if p.stem.removeprefix("epoch_").isdigit()
        )

    def manifest_entry(self, epoch: Epoch) -> dict | None:
        """This epoch's manifest entry (column/plan digests + WAL
        watermark) — what a pod host binds into its shard stamp
        (``node.pod.PodDurability.publish_shard``): the stamp quotes
        the digests the store itself verifies on load, so manifest
        verification and snapshot verification can never disagree."""
        entry = self._read_manifest().get("epochs", {}).get(str(epoch.number))
        return entry if isinstance(entry, dict) else None

    # -- load -----------------------------------------------------------

    def load(self, epoch: Epoch) -> Snapshot:
        """Load one snapshot, verifying every column against its
        manifest digest.  Raises :class:`SnapshotCorrupt` on a torn,
        bit-flipped, truncated, or undecodable snapshot — callers that
        can fall back (``load_latest``) catch exactly that; nothing
        here leaks raw npz/zip internals."""
        entry = self._read_manifest().get("epochs", {}).get(str(epoch.number), {})
        digests: dict = entry.get("columns", {}) if isinstance(entry, dict) else {}
        with TRACER.span("checkpoint_restore", epoch=epoch.number):
            try:
                with np.load(self._path(epoch)) as z:
                    for name, want in digests.items():
                        if name not in z:
                            raise SnapshotCorrupt(
                                f"epoch {epoch.number}: column {name!r} missing"
                            )
                        if _digest(z[name]) != want:
                            raise SnapshotCorrupt(
                                f"epoch {epoch.number}: column {name!r} digest mismatch"
                            )
                    graph = TrustGraph(
                        n=int(z["n"]),
                        src=z["src"],
                        dst=z["dst"],
                        weight=z["weight"],
                        pre_trusted=z["pre_trusted"] if "pre_trusted" in z else None,
                    )
                    scores = np.array(z["scores"]) if "scores" in z else None
                    # numpy's S32 strips trailing NUL bytes when it
                    # hands a row back, and the low byte of a
                    # big-endian hash is last: pad it back to 32 bytes,
                    # or a hash ending in 0x00 loads 256x too small.
                    peer_hashes = (
                        [
                            int.from_bytes(bytes(b).ljust(32, b"\0"), "big")
                            for b in z["peer_hashes"]
                        ]
                        if "peer_hashes" in z
                        else None
                    )
                    attestations = None
                    if "att_wire" in z:
                        wire_all = z["att_wire"].tobytes()
                        attestations = []
                        start = 0
                        for n, end in zip(z["att_nbrs"], z["att_offsets"]):
                            attestations.append(
                                (int(n), wire_all[start : int(end)])
                            )
                            start = int(end)
            except SnapshotCorrupt:
                raise
            except Exception as exc:  # noqa: BLE001 - npz/zip/OS decode soup
                raise SnapshotCorrupt(
                    f"epoch {epoch.number}: unreadable snapshot ({exc!r})"
                ) from exc
            proof_json = self._load_proof(epoch, entry)
            plan = self._load_plan(epoch, entry)
        CHECKPOINT_RESTORES.inc()
        return Snapshot(
            epoch=epoch,
            graph=graph,
            scores=scores,
            proof_json=proof_json,
            plan=plan,
            peer_hashes=peer_hashes,
            wal_seq=entry.get("wal_seq") if isinstance(entry, dict) else None,
            attestations=attestations,
        )

    def _load_proof(self, epoch: Epoch, entry: dict) -> str | None:
        """Proof sidecar: re-derivable from the attestation stream, so
        a corrupt one degrades to None (journaled), never a failure."""
        proof_path = self.dir / f"epoch_{epoch.number}.proof.json"
        if not proof_path.exists():
            return None
        try:
            proof_json = proof_path.read_text()
        except OSError:
            return None
        want = entry.get("proof")
        if want is not None and _text_digest(proof_json) != want:
            JOURNAL.record(
                "anomaly", what="checkpoint-proof-corrupt", epoch=epoch.number
            )
            return None
        return proof_json

    def _load_plan(self, epoch: Epoch, entry: dict) -> WindowPlan | None:
        """Plan sidecar: an optimization, never a source of truth — a
        stale layout version, decode failure, or digest mismatch all
        degrade to a rebuild on first converge."""
        plan_path = self.dir / f"epoch_{epoch.number}.plan.npz"
        if not plan_path.exists():
            return None
        want = entry.get("plan")
        try:
            with np.load(plan_path) as pz:
                if want is not None:
                    for name, digest in want.items():
                        if name not in pz or _digest(pz[name]) != digest:
                            JOURNAL.record(
                                "anomaly",
                                what="checkpoint-plan-corrupt",
                                epoch=epoch.number,
                                column=name,
                            )
                            return None
                return WindowPlan.from_arrays(pz)
        except Exception:  # noqa: BLE001 - torn sidecar, stale layout, zip soup
            return None

    def load_latest(self) -> Snapshot | None:
        """Newest snapshot that *verifies*: the manifest's latest
        first, then every on-disk epoch newest-to-oldest.  Each torn or
        corrupt candidate is journaled and counted on
        ``eigentrust_checkpoint_fallbacks_total``; cold start (None)
        only when no snapshot survives."""
        candidates: list[int] = []
        latest = self._read_manifest().get("latest_epoch")
        if latest is not None and self._path(Epoch(int(latest))).exists():
            candidates.append(int(latest))
        for number in sorted(self.epochs(), reverse=True):
            if number not in candidates:
                candidates.append(number)
        for number in candidates:
            try:
                return self.load(Epoch(number))
            except SnapshotCorrupt as exc:
                CHECKPOINT_FALLBACKS.inc()
                JOURNAL.record(
                    "checkpoint-fallback", epoch=number, error=str(exc)
                )
        return None
