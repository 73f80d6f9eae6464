"""The local-trust graph assembled from attestations.

The reference's "graph" is an N×N dense ops matrix gathered from the
attestation cache (server/src/manager/mod.rs:182-188).  At TPU scale the
graph is edge-list COO: ``src`` scored ``dst`` with weight ``w``.  This
module owns host-side assembly and normalization; device kernels consume
the arrays it produces.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TrustGraph:
    """A weighted directed trust graph.

    ``src/dst/weight`` are parallel COO arrays; ``pre_trusted`` flags the
    seed set used for the pre-trust vector p (the scaled analog of the
    reference's fixed bootstrap set, server/src/manager/mod.rs:40-61).
    """

    n: int
    src: np.ndarray  # int32 (nnz,)
    dst: np.ndarray  # int32 (nnz,)
    weight: np.ndarray  # float32 (nnz,)
    pre_trusted: np.ndarray | None = None  # bool (n,)

    def __post_init__(self):
        self.src = np.asarray(self.src, dtype=np.int32)
        self.dst = np.asarray(self.dst, dtype=np.int32)
        self.weight = np.asarray(self.weight, dtype=np.float32)
        assert self.src.shape == self.dst.shape == self.weight.shape

    @property
    def nnz(self) -> int:
        return int(self.src.shape[0])

    @classmethod
    def from_dense(cls, ops: np.ndarray, pre_trusted=None) -> "TrustGraph":
        ops = np.asarray(ops, dtype=np.float64)
        src, dst = np.nonzero(ops)
        return cls(
            n=ops.shape[0],
            src=src.astype(np.int32),
            dst=dst.astype(np.int32),
            weight=ops[src, dst].astype(np.float32),
            pre_trusted=pre_trusted,
        )

    def to_dense(self) -> np.ndarray:
        ops = np.zeros((self.n, self.n), dtype=np.float64)
        np.add.at(ops, (self.src, self.dst), self.weight.astype(np.float64))
        return ops

    def drop_self_edges(self) -> "TrustGraph":
        """EigenTrust nullifies self-scores (native.rs:183-191)."""
        keep = self.src != self.dst
        return TrustGraph(
            self.n, self.src[keep], self.dst[keep], self.weight[keep], self.pre_trusted
        )

    def row_normalized(self) -> tuple[np.ndarray, np.ndarray]:
        """Return ``(normalized weights, dangling mask)``.

        Weights are divided by their row (sender) sum — the local-trust
        normalization ``c_ij = s_ij / Σ_j s_ij`` of the EigenTrust paper
        and of the set kernel's credit distribution (native.rs:89-102).
        Rows with no positive mass are *dangling*; device kernels
        redistribute their rank to the pre-trust vector.
        """
        sums = np.zeros(self.n, dtype=np.float64)
        np.add.at(sums, self.src, self.weight.astype(np.float64))
        dangling = sums <= 0
        safe = np.where(dangling, 1.0, sums)
        w = (self.weight.astype(np.float64) / safe[self.src]).astype(np.float32)
        return w, dangling

    def pre_trust_vector(self) -> np.ndarray:
        """p: uniform over the pre-trusted set, or uniform over all peers
        when no seed set is designated."""
        if self.pre_trusted is None or not self.pre_trusted.any():
            return np.full(self.n, 1.0 / self.n, dtype=np.float32)
        p = self.pre_trusted.astype(np.float64)
        return (p / p.sum()).astype(np.float32)

    def sorted_by_dst(self) -> "TrustGraph":
        """Sort edges by destination — enables ``segment_sum`` with
        ``indices_are_sorted=True`` on TPU (no random-scatter path)."""
        order = np.argsort(self.dst, kind="stable")
        return TrustGraph(
            self.n, self.src[order], self.dst[order], self.weight[order], self.pre_trusted
        )

    def row_ptr_by_dst(self) -> np.ndarray:
        """CSC-style pointers over dst-sorted edges: ``row_ptr[j] ..
        row_ptr[j+1]`` is the edge range whose destination is j.  Feeds
        the cumsum SpMV formulation (gather-only, no scatter)."""
        return np.searchsorted(self.dst, np.arange(self.n + 1), side="left").astype(
            np.int32
        )
