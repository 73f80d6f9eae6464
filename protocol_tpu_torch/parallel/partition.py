"""Deterministic peer→host partition for pod scale-out.

Every host in a pod must agree on which host owns which peer **without
a coordination round**: ownership decides which edges a host folds into
its local window plan, which WAL shard an attestation is acknowledged
into, and which checkpoint shard carries a peer's row.  The assignment
is rendezvous (highest-random-weight) hashing over a vectorized
splitmix64 mix:

- **deterministic** — ``owner = argmax_h mix(key ^ salt_h)`` is a pure
  function of ``(key, n_hosts, seed)``, so every process computes the
  identical partition from its own copy of the peer set (property-
  tested across process boundaries in ``tests/test_partition.py``);
- **balanced** — splitmix64 is a 64-bit finalizer-grade mixer, so the
  per-host buckets concentrate around ``n/n_hosts`` (the tests pin a
  ±20% envelope at realistic sizes);
- **minimal remap under churn** — when a host joins, only the keys
  whose new-host score beats their incumbent move (≈ ``1/(n_hosts+1)``
  of them); when a host leaves, only *its* keys move.  Nothing else
  re-shuffles, so steady-state membership churn never invalidates the
  surviving hosts' window plans (the delta path stays partition-local).

Edges are owned by their **source** peer's host: row normalization is a
per-source operation, so a host that owns every out-edge of its peers
normalizes exactly like the single-host path; and the protocol's churn
unit is the sender-centric row rewrite (one attestation replaces one
out-edge), so a dirty row is dirty on exactly one host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_U64 = np.uint64
#: 64-bit mask for folding arbitrary-width Python ints (Poseidon field
#: elements are ~254 bits) into the mixer's domain.
MASK64 = (1 << 64) - 1


def mix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer: the avalanche stage of the
    SplitMix64 generator (Steele et al.), applied elementwise to a
    uint64 array.  Unsigned numpy arithmetic wraps mod 2^64, which is
    exactly the reference semantics."""
    z = x.astype(_U64, copy=True)
    z += _U64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
    return z ^ (z >> _U64(31))


def keys_from_hashes(hashes) -> np.ndarray:
    """Fold an iterable of Python-int peer hashes (arbitrary width —
    the manager keys peers by Poseidon field elements) into the
    partition's uint64 key domain."""
    return np.asarray([int(h) & MASK64 for h in hashes], dtype=_U64)


@dataclass(frozen=True)
class HostPartition:
    """Rendezvous-hash peer→host assignment for an ``n_hosts`` pod.

    ``seed`` namespaces the salt chain so test pods and production pods
    with the same membership count never collide by construction.
    """

    n_hosts: int
    seed: int = 0

    def __post_init__(self) -> None:
        if self.n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {self.n_hosts}")

    def _salt(self, host: int) -> np.uint64:
        # Double-mix the (seed, host) pair so adjacent host ids land in
        # unrelated salt points — a raw ``seed + host`` salt would make
        # neighboring hosts' score streams correlated.
        base = np.asarray([(self.seed * 0x9E3779B9 + host + 1) & MASK64], _U64)
        return mix64(mix64(base))[0]

    def assign(self, keys: np.ndarray) -> np.ndarray:
        """Owner host id (int32) for each uint64 key: the host whose
        salted mix scores highest — the rendezvous winner.  Runs as a
        streaming argmax over hosts, so peak memory is two extra arrays
        of ``len(keys)`` regardless of pod size."""
        keys = np.ascontiguousarray(keys, dtype=_U64)
        if self.n_hosts == 1:
            return np.zeros(keys.shape[0], np.int32)
        best_score = mix64(keys ^ self._salt(0))
        best_host = np.zeros(keys.shape[0], np.int32)
        for h in range(1, self.n_hosts):
            score = mix64(keys ^ self._salt(h))
            wins = score > best_score
            best_score[wins] = score[wins]
            best_host[wins] = h
        return best_host

    def assign_ids(self, n: int) -> np.ndarray:
        """Owners for the dense integer id space ``0..n-1`` (the
        synthetic-graph path: row ids are the peer identity)."""
        return self.assign(np.arange(n, dtype=_U64))

    def owned_mask(self, keys: np.ndarray, host: int) -> np.ndarray:
        """Boolean mask of the keys this host owns."""
        return self.assign(keys) == np.int32(host)


def remap_fraction(before: np.ndarray, after: np.ndarray) -> float:
    """Fraction of keys whose owner changed between two assignments —
    the churn metric the minimal-remap property tests pin (HRW moves
    ≈ 1/n_hosts of the keys on a membership change; a modulo partition
    would move ≈ (n_hosts-1)/n_hosts of them)."""
    before = np.asarray(before)
    after = np.asarray(after)
    if before.shape != after.shape:
        raise ValueError(f"shape mismatch: {before.shape} vs {after.shape}")
    if before.size == 0:
        return 0.0
    return float(np.mean(before != after))


__all__ = [
    "HostPartition",
    "MASK64",
    "keys_from_hashes",
    "mix64",
    "remap_fraction",
]
