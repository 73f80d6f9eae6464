"""Synthetic trust-graph generators for the BASELINE.md config ladder.

Config 2 (Erdős–Rényi 10k), config 4 (scale-free 1M peers / 50M edges)
and config 5 (10M peers with a 30% sybil collective) are generated here;
config 1 is the bootstrap CSV and config 3 an attestation-log snapshot
(see protocol_tpu.node).
"""

from __future__ import annotations

import numpy as np

from ..trust.graph import TrustGraph


def erdos_renyi(
    n: int, avg_degree: float = 8.0, *, n_pre_trusted: int = 16, seed: int = 0
) -> TrustGraph:
    """Uniform random directed graph with integer weights in [1, 100]."""
    rng = np.random.default_rng(seed)
    nnz = int(n * avg_degree)
    src = rng.integers(0, n, nnz, dtype=np.int32)
    dst = rng.integers(0, n, nnz, dtype=np.int32)
    w = rng.integers(1, 101, nnz).astype(np.float32)
    pre = np.zeros(n, bool)
    pre[rng.choice(n, min(n_pre_trusted, n), replace=False)] = True
    return TrustGraph(n, src, dst, w, pre)


def scale_free(
    n: int,
    nnz: int,
    *,
    exponent: float = 1.1,
    n_pre_trusted: int = 64,
    seed: int = 0,
    chunk: int = 1 << 22,
) -> TrustGraph:
    """Power-law attention graph: sources uniform, destinations Zipf-like
    (popularity ∝ rank^-exponent via inverse-CDF sampling on a permuted
    rank order).  This is the load-balance stress case for sharded SpMV —
    a few peers receive a large fraction of all edges.
    """
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n).astype(np.int32)

    srcs, dsts, ws = [], [], []
    remaining = nnz
    while remaining > 0:
        m = min(chunk, remaining)
        remaining -= m
        src = rng.integers(0, n, m, dtype=np.int32)
        # Inverse-CDF of a truncated Pareto over ranks [1, n].
        u = rng.random(m)
        if abs(exponent - 1.0) < 1e-9:
            ranks = np.exp(u * np.log(n))
        else:
            a = 1.0 - exponent
            ranks = (1.0 + u * (n**a - 1.0)) ** (1.0 / a)
        dst = perm[np.clip(ranks.astype(np.int64) - 1, 0, n - 1)]
        w = rng.integers(1, 101, m).astype(np.float32)
        srcs.append(src)
        dsts.append(dst)
        ws.append(w)

    pre = np.zeros(n, bool)
    pre[rng.choice(n, min(n_pre_trusted, n), replace=False)] = True
    return TrustGraph(
        n, np.concatenate(srcs), np.concatenate(dsts), np.concatenate(ws), pre
    )


def sybil_stress(
    n: int,
    nnz: int,
    *,
    sybil_fraction: float = 0.3,
    seed: int = 0,
    n_pre_trusted: int = 64,
) -> TrustGraph:
    """An honest scale-free core plus a sybil collective: the last
    ``sybil_fraction·n`` peers score only each other (a closed clique
    ring) and receive a few bridge edges from compromised honest peers.
    Used to measure how pre-trust damping bounds collective rank
    (BASELINE.md config 5)."""
    rng = np.random.default_rng(seed)
    n_sybil = int(n * sybil_fraction)
    n_honest = n - n_sybil
    honest_nnz = int(nnz * (1 - sybil_fraction))
    g = scale_free(n_honest, honest_nnz, seed=seed, n_pre_trusted=n_pre_trusted)

    sybil_nnz = nnz - honest_nnz
    s_src = n_honest + rng.integers(0, n_sybil, sybil_nnz, dtype=np.int32)
    # Ring + random intra-clique edges keep the collective strongly
    # connected so its self-reinforcement is maximal.
    s_dst = n_honest + (
        (s_src - n_honest + 1 + rng.integers(0, max(n_sybil // 8, 1), sybil_nnz)) % n_sybil
    ).astype(np.int32)
    s_w = np.full(sybil_nnz, 100.0, np.float32)

    # 0.1% of honest edges are bridges captured by the collective.
    n_bridge = max(honest_nnz // 1000, 1)
    b_src = rng.integers(0, n_honest, n_bridge, dtype=np.int32)
    b_dst = n_honest + rng.integers(0, n_sybil, n_bridge, dtype=np.int32)
    b_w = np.full(n_bridge, 100.0, np.float32)

    pre = np.zeros(n, bool)
    pre[: g.pre_trusted.shape[0]][g.pre_trusted] = True
    return TrustGraph(
        n,
        np.concatenate([g.src, s_src, b_src]),
        np.concatenate([g.dst, s_dst, b_dst]),
        np.concatenate([g.weight, s_w, b_w]),
        pre,
    )


def sybil_mass(result_scores: np.ndarray, n: int, sybil_fraction: float) -> float:
    """Fraction of total trust captured by the sybil block."""
    n_sybil = int(n * sybil_fraction)
    return float(result_scores[n - n_sybil :].sum() / result_scores.sum())
