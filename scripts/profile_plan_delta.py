#!/usr/bin/env python3
"""Profile one plan-delta epoch of the PyTorch port's host side.

    python3 scripts/profile_plan_delta.py [n_peers] [n_edges]

Builds a ``WindowPlan`` for ``scale_free(n_peers, n_edges, seed=7)``,
applies one epoch of 1 % sender-centric churn through
``try_plan_delta``, and prints the build and delta seconds and the
functions that took the most time inside the delta (cProfile).  Host
numpy only: no card is needed.  Defaults to 300,000 peers / 15M edges.
"""

import cProfile
import pathlib
import pstats
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from protocol_tpu_torch.models.churn import churn_cohort_dims, sender_centric_churn  # noqa: E402
from protocol_tpu_torch.models.graphs import scale_free  # noqa: E402
from protocol_tpu_torch.ops import gather_window as gw  # noqa: E402


def main(n_peers: int = 300_000, n_edges: int = 15_000_000) -> None:
    g = scale_free(n_peers, n_edges, seed=7).drop_self_edges()
    w, _ = g.row_normalized()
    t0 = time.perf_counter()
    plan = gw.build_window_plan(g.src, g.dst, w, n=g.n)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    cohort, deg = churn_cohort_dims(g, 0.01)
    rows, g2, _ = sender_centric_churn(rng, g, cohort_size=cohort, deg=deg)
    w2, _ = g2.row_normalized()
    fp = gw.graph_fingerprint(g2.n, g2.src, g2.dst, w2)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    new = gw.try_plan_delta(plan, g2.src, g2.dst, w2, n=g2.n, rows=rows, fingerprint=fp)
    prof.disable()
    delta_s = time.perf_counter() - t0
    print(
        f"peers {g.n} edges {g.nnz} n_segments {plan.n_segments} "
        f"touched windows {np.unique(rows >> 10).size} of {-(-g.n // gw.WINDOW)}"
    )
    print(f"build_window_plan {build_s:.3f} s; try_plan_delta {delta_s:.3f} s "
          f"({'delta' if new is not None else 'declined'})")
    pstats.Stats(prof).sort_stats("tottime").print_stats(6)


if __name__ == "__main__":
    main(*map(int, sys.argv[1:3]))
