"""Bootstrap identities and protocol constants.

The reference hard-codes a fixed 5-peer set and its pk-hashes
(server/src/manager/mod.rs:32-69, data/bootstrap-nodes.csv); here the
same values are runtime data with CSV/JSON loaders so the set can be
swapped or scaled.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from pathlib import Path

from ..crypto.eddsa import PublicKey, SecretKey

#: Default protocol constants (server/src/manager/mod.rs:31-38).
NUM_ITER = 10
NUM_NEIGHBOURS = 5
INITIAL_SCORE = 1000
SCALE = 1000

#: The reference's published bootstrap secret keys (bs58 pairs), also in
#: data/bootstrap-nodes.csv as Alice..Craig.
FIXED_SET: list[tuple[str, str]] = [
    ("2L9bbXNEayuRMMbrWFynPtgkrXH1iBdfryRH9Soa8M67", "9rBeBVtbN2MkHDTpeAouqkMWNFJC6Bxb6bXH9jUueWaF"),
    ("ARVqgNQtnV4JTKqgajGEpuapYEnWz93S5vwRDoRYWNh8", "2u1LC2JmKwkzUccS9hd5yS2DUUGTuYQ8MA7y28A9SgQY"),
    ("phhPpTLWJbC4RM39Ww3e6wWvZnVkk86iNAXyA1tRAHJ", "93aMkAqd7AY4c3m6ij6RuBzw3F9QYhQsAMnkKF2Ck2R8"),
    ("Bp3FqLd6Man9h7xujkbYDdhyF42F2dX871SJHvo3xsnU", "AUUqgGTvqzPetRMQdTrQ1xHnwz2BHDxPTi85wL4WYQaK"),
    ("AKo18M6YSE1dQQuXt4HfWNrXA6dKXBVkWVghEi6827u1", "ArT8Kk13Heai2UPbMbrqs3RuVm4XXFN2pVHttUnKpDoV"),
]


@dataclass
class BootstrapNode:
    name: str
    sk0: str
    sk1: str

    def secret_key(self) -> SecretKey:
        return SecretKey.from_bs58(self.sk0, self.sk1)


def keyset_from_raw(
    pairs: list[tuple[str, str]],
) -> tuple[list[SecretKey], list[PublicKey]]:
    """bs58 pairs → (secret keys, public keys)
    (server/src/utils.rs:27-50)."""
    sks = [SecretKey.from_bs58(a, b) for a, b in pairs]
    return sks, [sk.public() for sk in sks]


def read_bootstrap_csv(path: str | Path) -> list[BootstrapNode]:
    """Parse data/bootstrap-nodes.csv (client/src/utils.rs:27-53)."""
    nodes = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            nodes.append(BootstrapNode(row["name"], row["sk0"], row["sk1"]))
    return nodes
