"""Write-ahead attestation log: crash-consistent node state.

The port's copy of the reference package's log: the record format is
the same byte for byte, so a log either package wrote replays in the
other to the same attestation cache.

The reference's durability story is "the chain is the checkpoint" —
every boot replays events from block 0 (server/src/main.rs:139-143).
At 50M attestations that replay is the recovery path's whole cost, and
between periodic snapshots a crash silently loses every accepted
attestation since the last one.  This module closes that window: every
attestation the Manager applies is first appended to an fsync'd,
size-rotated segment log, and boot recovery is deterministic —

1. load the newest *valid* checkpoint (digest-verified, falling back
   epoch by epoch — node/checkpoint.py),
2. replay the WAL tail (records past the checkpoint's ``wal_seq``
   watermark) through the existing ``apply_verified`` fast path,
3. rebuild warm state via ``restore_warm_state`` so the first epoch
   converges from the recovered fixed point (arXiv:1603.00589's
   start-independence is what makes the warm recovered state safe).

Format: segments ``wal_<first_seq>.seg``, each an 8-byte magic header
followed by records ``[u64 seq][u32 len][u32 crc32][payload]`` (crc
over seq‖len‖payload).  The payload is ``[u16 num_neighbours][wire
bytes]`` — the attestation's reference wire form plus the neighbour
count the decoder needs.  A torn tail (crash mid-append, the
``wal.append`` torn fault) fails the crc and drops exactly the tail
record: it was never acknowledged, so nothing acknowledged is lost.
Segments whose records are all ≤ the checkpointed watermark are
deleted after a successful checkpoint (``truncate_through``), bounding
disk to roughly one epoch of traffic per retained snapshot.

Durability contract: an ingest verdict is returned only after the
record's ``flush()`` (write + fsync) — the admission plane appends a
verify batch with ``flush=False`` and flushes once per batch, so the
fsync cost amortizes exactly like the signature checks do.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import time
import zlib
from pathlib import Path
from typing import TYPE_CHECKING, Iterator

from .. import chaos
from ..obs.journal import JOURNAL
from ..obs.metrics import (
    CHECKPOINT_FALLBACKS,
    RECOVERY_SECONDS,
    WAL_APPENDED,
    WAL_REPLAYED,
)

if TYPE_CHECKING:
    from .checkpoint import CheckpointStore
    from .manager import Manager

log = logging.getLogger(__name__)

_MAGIC = b"ETWAL001"
_HEADER = struct.Struct(">QII")  # seq, payload length, crc32

chaos.declare("wal.append", "a WAL record is serialized, pre-write (torn target)")
chaos.declare("wal.post_append", "a WAL record hit the OS (post write/fsync)")
chaos.declare("wal.pre_truncate", "before checkpointed segments are deleted")
chaos.declare("wal.replay", "one record re-applied during boot recovery")


def encode_payload(num_neighbours: int, wire: bytes) -> bytes:
    """``[u16 n][wire]`` — the neighbour count rides with the record so
    replay decodes without global config."""
    return num_neighbours.to_bytes(2, "big") + wire


def decode_payload(payload: bytes) -> tuple[int, bytes]:
    return int.from_bytes(payload[:2], "big"), payload[2:]


class AttestationWAL:
    """Append-only, fsync'd, size-rotated attestation log."""

    def __init__(
        self,
        directory: str | Path,
        *,
        segment_max_bytes: int = 4 << 20,
        fsync: bool = True,
    ):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.segment_max_bytes = int(segment_max_bytes)
        self.fsync = bool(fsync)
        self._lock = threading.Lock()
        self._file = None  # active segment, opened lazily on append
        self._active_path: Path | None = None
        self._active_first: int | None = None
        self._active_bytes = 0
        #: Closed segments: path -> (first_seq, last_seq).
        self._segments: dict[Path, tuple[int, int]] = {}
        #: Highest sequence number ever assigned.
        self._last_seq = 0
        #: Appended-but-not-yet-applied seqs (the applied watermark is
        #: the highest seq below every pending one — records at or
        #: below it are guaranteed to be in the attestation cache).
        self._pending: set[int] = set()
        self.dropped_tail = 0
        self._scan()

    # -- boot scan ------------------------------------------------------

    def _segment_paths(self) -> list[Path]:
        return sorted(self.dir.glob("wal_*.seg"))

    def _scan(self) -> None:
        """Index existing segments and find the highest valid seq.
        Old segments stay read-only; new appends open a new segment, so
        a torn tail never needs in-place surgery.  Runs at construction
        (pre-sharing), under the lock like every other index mutation."""
        with self._lock:
            for path in self._segment_paths():
                first, last, torn = self._scan_segment(path)
                if first is None or last is None:
                    # Empty or header-only segment (crash before the
                    # first record landed): nothing to replay, drop it.
                    path.unlink(missing_ok=True)
                    continue
                self._segments[path] = (first, last)
                self._last_seq = max(self._last_seq, last)
                self.dropped_tail += torn

    @staticmethod
    def _scan_segment(path: Path) -> tuple[int | None, int | None, int]:
        """(first_seq, last_seq, torn_records) of one segment —
        validated record by record, stopping at the first torn one."""
        first = last = None
        torn = 0
        try:
            data = path.read_bytes()
        except OSError:
            return None, None, 0
        if not data.startswith(_MAGIC):
            return None, None, 1
        off = len(_MAGIC)
        while off + _HEADER.size <= len(data):
            seq, length, crc = _HEADER.unpack_from(data, off)
            start = off + _HEADER.size
            payload = data[start : start + length]
            if len(payload) < length or zlib.crc32(
                data[off : off + 12] + payload
            ) != crc:
                torn = 1
                break
            if first is None:
                first = seq
            last = seq
            off = start + length
        else:
            if off != len(data) and off < len(data):
                torn = 1
        return first, last, torn

    # -- append path ----------------------------------------------------

    def _rotate_locked(self) -> None:
        if self._file is not None:
            self._file.close()
            assert self._active_path is not None and self._active_first is not None
            self._segments[self._active_path] = (
                self._active_first,
                self._last_seq,
            )
            self._file = None
            self._active_path = None
            self._active_first = None
            self._active_bytes = 0

    def _open_segment_locked(self, first_seq: int) -> None:
        """Create the next active segment: header written and fsync'd
        before any record, so a segment file is never magic-less."""
        path = self.dir / f"wal_{first_seq:020d}.seg"
        f = open(path, "wb")
        f.write(_MAGIC)
        f.flush()
        os.fsync(f.fileno())
        self._file = f
        self._active_path = path
        self._active_first = first_seq
        self._active_bytes = len(_MAGIC)

    def append(self, payload: bytes, *, flush: bool = True) -> int:
        """Append one record; returns its sequence number.  With
        ``flush`` (the default) the record is fsync'd before return —
        batch callers pass ``flush=False`` and call :meth:`flush` once
        per batch."""
        with self._lock:
            seq = self._last_seq + 1
            if (
                self._file is not None
                and self._active_bytes >= self.segment_max_bytes
            ):
                self._rotate_locked()
            if self._file is None:
                self._open_segment_locked(seq)
            header = _HEADER.pack(
                seq, len(payload), zlib.crc32(seq.to_bytes(8, "big") + len(payload).to_bytes(4, "big") + payload)
            )
            record = header + payload
            if chaos.ACTIVE:
                record = chaos.corrupt("wal.append", record)
            self._file.write(record)
            self._active_bytes += len(record)
            self._last_seq = seq
            self._pending.add(seq)
            if flush:
                self._flush_locked()
        WAL_APPENDED.inc()
        if chaos.ACTIVE:
            chaos.fire("wal.post_append")
        return seq

    def _flush_locked(self) -> None:
        if self._file is not None:
            self._file.flush()
            if self.fsync:
                os.fsync(self._file.fileno())

    def flush(self) -> None:
        """Flush buffered records to the OS and fsync (the durability
        boundary an ingest verdict waits on)."""
        with self._lock:
            self._flush_locked()

    def mark_applied(self, seq: int) -> None:
        """The record's attestation reached the cache — it now counts
        toward the applied watermark a checkpoint may truncate through."""
        with self._lock:
            self._pending.discard(seq)

    def applied_watermark(self) -> int:
        """Highest seq S such that every record ≤ S has been applied —
        a graph built *after* reading this absorbs all of them, so a
        checkpoint of that graph may truncate through S."""
        with self._lock:
            if not self._pending:
                return self._last_seq
            return min(self._pending) - 1

    @property
    def seq(self) -> int:
        with self._lock:
            return self._last_seq

    # -- recovery path --------------------------------------------------

    def replay(self, after_seq: int = -1) -> Iterator[tuple[int, bytes]]:
        """Yield ``(seq, payload)`` for every valid record with
        ``seq > after_seq``, oldest first.  A torn record ends its
        segment's replay (only the unacknowledged tail is lost)."""
        with self._lock:
            paths = sorted(set(self._segments) | (
                {self._active_path} if self._active_path else set()
            ))
        for path in paths:
            try:
                data = path.read_bytes()
            except OSError:
                continue
            if not data.startswith(_MAGIC):
                continue
            off = len(_MAGIC)
            while off + _HEADER.size <= len(data):
                seq, length, crc = _HEADER.unpack_from(data, off)
                start = off + _HEADER.size
                payload = data[start : start + length]
                if len(payload) < length or zlib.crc32(
                    data[off : off + 12] + payload
                ) != crc:
                    break
                if seq > after_seq:
                    if chaos.ACTIVE:
                        chaos.fire("wal.replay")
                    yield seq, payload
                off = start + length

    # -- truncation -----------------------------------------------------

    def truncate_through(self, seq: int) -> int:
        """Delete closed segments whose records are all ≤ ``seq`` (the
        checkpoint watermark).  The active segment is rotated first
        when fully covered.  Returns the number of segments removed."""
        if chaos.ACTIVE:
            chaos.fire("wal.pre_truncate")
        removed = 0
        with self._lock:
            if (
                self._file is not None
                and self._last_seq <= seq
                and self._active_bytes > len(_MAGIC)
            ):
                self._flush_locked()
                self._rotate_locked()
            for path, (_, last) in list(self._segments.items()):
                if last <= seq:
                    path.unlink(missing_ok=True)
                    del self._segments[path]
                    removed += 1
        return removed

    def segment_count(self) -> int:
        with self._lock:
            return len(self._segments) + (1 if self._file is not None else 0)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._flush_locked()
                self._rotate_locked()


def recover(
    manager: "Manager",
    store: "CheckpointStore | None",
    wal: AttestationWAL | None,
) -> dict:
    """THE boot recovery path, shared by the node daemon and the crash
    matrix: newest valid checkpoint → warm state → WAL tail replayed
    through ``apply_verified`` → WAL attached for new appends.  Returns
    a report dict (also the /healthz ``recovery`` component body)."""
    t0 = time.perf_counter()
    fallbacks0 = CHECKPOINT_FALLBACKS.value()
    snapshot = store.load_latest() if store is not None else None
    wal_seq = -1
    checkpoint_epoch = None
    restored_atts = 0
    bad_records = 0
    if snapshot is not None:
        checkpoint_epoch = snapshot.epoch.number
        if snapshot.wal_seq is not None:
            wal_seq = int(snapshot.wal_seq)
        if snapshot.attestations:
            from .attestation import AttestationData

            for n, wire_bytes in snapshot.attestations:
                try:
                    att = AttestationData.from_bytes(wire_bytes, n).to_attestation(n)
                except (ValueError, IndexError) as exc:
                    bad_records += 1
                    JOURNAL.record(
                        "anomaly", what="checkpoint-bad-attestation", error=repr(exc)
                    )
                    continue
                manager.restore_attestation(att)
                restored_atts += 1
        if snapshot.proof_json:
            from ..zk.proof import ProofRaw

            manager.cache_proof(
                snapshot.epoch,
                ProofRaw.from_json(snapshot.proof_json).to_proof(),
            )
        manager.restore_warm_state(
            graph=snapshot.graph,
            plan=snapshot.plan,
            scores=snapshot.scores,
            peer_hashes=snapshot.peer_hashes,
        )
    replayed = 0
    if wal is not None:
        from .attestation import AttestationData

        for seq, payload in wal.replay(after_seq=wal_seq):
            try:
                n, wire = decode_payload(payload)
                att = AttestationData.from_bytes(wire, n).to_attestation(n)
            except (ValueError, IndexError) as exc:
                # CRC-valid but undecodable should be impossible; skip
                # rather than abort recovery over one record.
                bad_records += 1
                JOURNAL.record("anomaly", what="wal-bad-record", seq=seq, error=repr(exc))
                continue
            manager.apply_verified(att, raw=wire, flush=False)
            WAL_REPLAYED.inc()
            replayed += 1
        # New appends go through the manager from here on.
        manager.wal = wal
    seconds = time.perf_counter() - t0
    RECOVERY_SECONDS.set(seconds)
    report = {
        "checkpoint_epoch": checkpoint_epoch,
        "checkpoint_fallbacks": int(CHECKPOINT_FALLBACKS.value() - fallbacks0),
        "attestations_restored": restored_atts,
        "wal_seq": wal_seq,
        "wal_replayed": replayed,
        "wal_dropped_tail": wal.dropped_tail if wal is not None else 0,
        "wal_bad_records": bad_records,
        "seconds": round(seconds, 6),
    }
    JOURNAL.record("recovery", **report)
    return report


__all__ = [
    "AttestationWAL",
    "decode_payload",
    "encode_payload",
    "recover",
]
