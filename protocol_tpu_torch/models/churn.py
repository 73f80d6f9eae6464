"""Sender-centric churn generator (the bench.py epoch doctrine, shared).

The protocol's churn unit is a sender's out-row rewrite: a peer
re-attests, replacing its whole out-edge row (row normalization makes
the row the atomic delta unit).  The re-attesting cohort is
recency-biased — ids exponential toward the top of the id space,
mirroring production id assignment where manager peer ids are
first-seen order, so the churning cohort (recently joined / most
active users) is id-local and the plan delta's touched windows stay
far below the window count (the delta/rebuild crossover, PERF.md §11).

Extracted from ``bench.py::epochs_entry`` so the steady-state
benchmark, the partition property tests, and the pod dryrun all replay
the *identical* event stream shape — churn locality claims measured by
one tool are the claims the others verify.
"""

from __future__ import annotations

import numpy as np

from ..trust.graph import TrustGraph


def churn_cohort_dims(graph: TrustGraph, churn: float) -> tuple[int, int]:
    """``(cohort_size, deg)`` for a churn fraction: the cohort rewriting
    ``churn``·E edges at the graph's average out-degree."""
    avg_deg = max(graph.nnz / graph.n, 1.0)
    cohort_size = max(1, int(round(churn * graph.nnz / avg_deg)))
    deg = max(1, int(round(avg_deg)))
    return cohort_size, deg


def sender_centric_churn(
    rng: np.random.Generator,
    graph: TrustGraph,
    *,
    cohort_size: int,
    deg: int,
) -> tuple[np.ndarray, TrustGraph, tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """One epoch of sender-centric churn.

    Returns ``(rows, new_graph, (ns, nd, nw))``: the re-attesting row
    ids (sorted, unique), the churned graph, and the cohort's new
    out-edges as three flat arrays grouped by row — ``ns`` is
    ``np.repeat(rows, deg)``, so row ``rows[i]``'s fresh out-row is the
    slice ``[i*deg, (i+1)*deg)`` of ``nd``/``nw`` (the pod dryrun
    journals exactly these slices into per-host WAL shards).

    Draw order (exponential offsets, destinations, self-edge
    resamples, weights) is pinned: callers carrying one ``rng`` across
    epochs reproduce the historical bench.py stream bit-for-bit.
    """
    n_peers = graph.n
    offs = rng.exponential(
        scale=max(n_peers * 0.02, cohort_size), size=cohort_size
    ).astype(np.int64)
    rows = np.unique(n_peers - 1 - np.minimum(offs, n_peers - 1))
    keep = ~np.isin(graph.src, rows.astype(np.int32))
    ns = np.repeat(rows.astype(np.int32), deg)
    nd = rng.integers(0, n_peers, ns.shape[0]).astype(np.int32)
    while (bad := nd == ns).any():  # no self-edges
        nd[bad] = rng.integers(0, n_peers, int(bad.sum()))
    nw = rng.integers(1, 1000, ns.shape[0]).astype(np.float32)
    new_graph = TrustGraph(
        graph.n,
        np.concatenate([graph.src[keep], ns]),
        np.concatenate([graph.dst[keep], nd]),
        np.concatenate([graph.weight[keep], nw]),
        graph.pre_trusted,
    )
    return rows, new_graph, (ns, nd, nw)


__all__ = ["churn_cohort_dims", "sender_centric_churn"]
