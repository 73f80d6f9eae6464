"""Sharded dedup/nonce cache — replays die before the signature check.

The port of ``protocol_tpu/ingest/dedup.py``.

A replayed attestation costs the node a full EdDSA verification
(~0.3 ms native) unless something cheaper rejects it first.  This cache
is that something: per-sender monotonic nonces plus a recent-message
digest set, sharded by sender so shard locks never contend across
senders, with two-generation rotation for bounded memory.

Eviction is *epoch-aligned*: the node rotates generations on every
epoch tick (``rotate_all``), so "recent" means "this epoch or the
last" — exactly the horizon inside which a replay could still perturb
the next convergence.  A shard whose current generation overflows
``hashes_per_shard`` rotates early, so a storm of unique messages
cannot grow memory without bound either.

Admission checks here are digest comparisons and dict lookups — no
field arithmetic, no Poseidon — so the cache holds the line at
intake rates far above what the verify tier can absorb.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

#: splitmix64 odd multiplier (golden-ratio constant).
_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 64) - 1


def _shard_index(sender: tuple[int, int], n_shards: int) -> int:
    """Stable shard key: a splitmix-style mix of the sender's pk
    coordinates, identical across processes and interpreter versions by
    construction.  Builtin ``hash()`` happens to be salt-free for int
    tuples in today's CPython, but shard placement is observable state
    (lock contention patterns, eviction order under ``senders_per_shard``
    pressure), and bit-identical state does not stand on
    implementation details.  The port keeps the reference's function,
    so shard placement is the reference's bit for bit."""
    x, y = sender
    acc = (int(x) * _MIX + int(y)) & _MASK
    acc ^= acc >> 31
    acc = (acc * 0xBF58476D1CE4E5B9) & _MASK
    acc ^= acc >> 27
    return acc % n_shards


@dataclass
class _Shard:
    """One dedup shard: lock, nonce map, and two digest generations."""

    lock: threading.Lock = field(default_factory=threading.Lock)
    #: sender key -> highest nonce admitted (monotonic-nonce senders).
    nonces: dict[tuple[int, int], int] = field(default_factory=dict)
    #: Message digests admitted this generation / the previous one.
    current: dict[bytes, None] = field(default_factory=dict)
    previous: dict[bytes, None] = field(default_factory=dict)


class ShardedDedupCache:
    """Replay/nonce filter sharded by sender hash.

    ``admit`` is the whole API surface the plane uses: it either
    rejects with a reason code (``duplicate`` / ``stale-nonce``) or
    records the digest (and nonce, when the sender supplied one) and
    admits.  Recording happens at admission time — before the
    signature verdict — so two copies of the same message racing
    through the plane cannot both reach the verify tier; the second is
    a duplicate regardless of which wins.
    """

    def __init__(
        self,
        n_shards: int = 16,
        hashes_per_shard: int = 65536,
        senders_per_shard: int = 65536,
    ):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self._shards = [_Shard() for _ in range(n_shards)]
        self.hashes_per_shard = int(hashes_per_shard)
        self.senders_per_shard = int(senders_per_shard)

    def _shard(self, sender: tuple[int, int]) -> _Shard:
        return self._shards[_shard_index(sender, len(self._shards))]

    def admit(
        self, sender: tuple[int, int], digest: bytes, nonce: int | None = None
    ) -> str | None:
        """Reason code for a rejection, or None (admitted + recorded)."""
        shard = self._shard(sender)
        with shard.lock:
            if digest in shard.current or digest in shard.previous:
                return "duplicate"
            if nonce is not None:
                last = shard.nonces.get(sender)
                if last is not None and nonce <= last:
                    return "stale-nonce"
                if (
                    sender not in shard.nonces
                    and len(shard.nonces) >= self.senders_per_shard
                ):
                    # Evict the oldest-inserted sender (dict preserves
                    # insertion order) — bounded memory under sender
                    # churn at the cost of forgetting their floor.
                    shard.nonces.pop(next(iter(shard.nonces)))
                shard.nonces[sender] = nonce
            shard.current[digest] = None
            if len(shard.current) >= self.hashes_per_shard:
                shard.previous = shard.current
                shard.current = {}
            return None

    def rotate_all(self) -> None:
        """Epoch-aligned eviction: age ``current`` into ``previous``
        and drop the old ``previous`` — after two rotations a digest is
        forgotten.  The node calls this once per epoch tick."""
        for shard in self._shards:
            with shard.lock:
                shard.previous = shard.current
                shard.current = {}

    def __len__(self) -> int:
        """Digests currently held (both generations, all shards)."""
        total = 0
        for shard in self._shards:
            with shard.lock:
                total += len(shard.current) + len(shard.previous)
        return total


__all__ = ["ShardedDedupCache"]
