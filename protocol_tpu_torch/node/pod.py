"""Pod durability plane: per-host WAL and checkpoint shards bound to one
epoch by a pod-level manifest.

Counterpart of ``protocol_tpu/node/pod.py``; its stamps and manifests
are the reference's JSON, key for key, so either package reads the
other's.  Each host owns a disjoint peer partition
(``parallel.partition``), so each host journals **only the attestations
whose source peer it owns** into its own ``AttestationWAL`` and
checkpoints only its local window-plan shard through its own
``CheckpointStore``: the durability plane shards like the edge set, and
a host recovers from its own shard alone.

What a single-host node gets for free ("the checkpoint and the WAL
watermark describe the same epoch") a pod has to state explicitly: host
A's checkpoint at epoch 12 plus host B's at epoch 11 is not a
recoverable pod state.  The **pod manifest** closes that seam: after an
epoch's converge, every host publishes an immutable *shard stamp* (its
checkpoint column digests and WAL watermark, atomically written), and
the sealer host (host 0 by convention) binds the complete stamp set into
``pod_manifest_e<N>.json``.  Recovery reads the newest *sealed*
manifest: a crash between publish and seal leaves a partial stamp set
that no manifest references, so every host rolls back to the same
previous epoch.  Torn pod states cannot be represented; the same
tmp + fsync + rename discipline as ``CheckpointStore``, one level up.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

from .checkpoint import CheckpointStore
from .wal import AttestationWAL


def _atomic_write(dest: Path, write_fn, mode: str = "w") -> None:
    """tmp + fsync + rename: the stamp/manifest bytes hit disk before
    the rename publishes the name, so a reader never sees a torn
    document."""
    fd, tmp = tempfile.mkstemp(dir=dest.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, dest)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class PodDurability:
    """One host's handle on the pod's sharded durability tree::

        root/
          host-000/wal/...          per-host WAL segments
          host-000/checkpoints/...  per-host CheckpointStore
          manifests/
            shard-e00000012-h000.json   immutable per-host stamps
            pod_manifest_e00000012.json sealed epoch binding

    The WAL and checkpoint store are the single-host node's classes
    verbatim: sharding the plane is a directory-layout decision, not a
    format change, so single-host recovery tooling reads a pod shard
    as-is.
    """

    def __init__(
        self,
        root: str | Path,
        host_id: int,
        n_hosts: int,
        *,
        keep: int = 4,
        fsync: bool = True,
        segment_max_bytes: int = 4 << 20,
    ):
        if not 0 <= host_id < n_hosts:
            raise ValueError(f"host_id {host_id} outside pod of {n_hosts}")
        self.root = Path(root)
        self.host_id = int(host_id)
        self.n_hosts = int(n_hosts)
        host_dir = self.root / f"host-{host_id:03d}"
        self.wal = AttestationWAL(
            host_dir / "wal", segment_max_bytes=segment_max_bytes, fsync=fsync
        )
        self.checkpoints = CheckpointStore(host_dir / "checkpoints", keep=keep)
        self.manifest_dir = self.root / "manifests"
        self.manifest_dir.mkdir(parents=True, exist_ok=True)

    # -- per-host stamps ---------------------------------------------------

    def _stamp_path(self, epoch: int, host: int) -> Path:
        return self.manifest_dir / f"shard-e{epoch:08d}-h{host:03d}.json"

    def _manifest_path(self, epoch: int) -> Path:
        return self.manifest_dir / f"pod_manifest_e{epoch:08d}.json"

    def publish_shard(
        self,
        epoch: int,
        *,
        wal_seq: int,
        columns: dict[str, str],
        extra: dict | None = None,
    ) -> Path:
        """Atomically publish this host's stamp for ``epoch``: the
        checkpoint column digests and the WAL watermark the checkpoint
        covers.  Must be called after the host's own
        ``CheckpointStore.save`` returns (the stamp asserts durable
        local state, it does not create it)."""
        stamp = {
            "epoch": int(epoch),
            "host": self.host_id,
            "n_hosts": self.n_hosts,
            "wal_seq": int(wal_seq),
            "columns": dict(columns),
        }
        if extra:
            stamp.update(extra)
        dest = self._stamp_path(epoch, self.host_id)
        _atomic_write(dest, lambda f: json.dump(stamp, f, indent=1))
        return dest

    # -- pod-level sealing -------------------------------------------------

    def seal_epoch(self, epoch: int) -> dict | None:
        """Bind the epoch's complete stamp set into the pod manifest
        (sealer host only — host 0 by convention, but any single
        designated host works; the write is atomic and idempotent).
        Returns the manifest, or None when stamps are still missing —
        the caller retries next epoch; an unsealed epoch is simply not
        recoverable-to and every host rolls back past it."""
        stamps = {}
        for h in range(self.n_hosts):
            path = self._stamp_path(epoch, h)
            try:
                stamps[str(h)] = json.loads(path.read_text())
            except (OSError, json.JSONDecodeError):
                return None
        manifest = {
            "epoch": int(epoch),
            "n_hosts": self.n_hosts,
            "shards": stamps,
        }
        _atomic_write(
            self._manifest_path(epoch), lambda f: json.dump(manifest, f, indent=1)
        )
        return manifest

    def load_manifest(self) -> dict | None:
        """Newest sealed pod manifest (recovery entry point): every
        host resumes from ``manifest['epoch']`` using its own
        checkpoint shard and replays its own WAL tail past the
        recorded ``wal_seq`` — no cross-host reads."""
        paths = sorted(self.manifest_dir.glob("pod_manifest_e*.json"))
        for path in reversed(paths):
            try:
                manifest = json.loads(path.read_text())
            except (OSError, json.JSONDecodeError):
                continue  # torn manifests are impossible; stale tmp noise
            if len(manifest.get("shards", {})) == manifest.get("n_hosts"):
                return manifest
        return None

    def my_stamp(self, manifest: dict) -> dict | None:
        return manifest.get("shards", {}).get(str(self.host_id))


__all__ = ["PodDurability"]
