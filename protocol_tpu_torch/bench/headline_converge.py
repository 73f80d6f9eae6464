"""The headline converges, timed many times in one process on the card.

    python -m protocol_tpu_torch.bench.headline_converge [repeats]

On the headline graph (``scale_free(1M, 50M, seed=7)``, made by
``prepared``, which ``chip_smoke.py`` calls too: self edges dropped,
rows normalised, edges in dst order) it builds the window plan once,
then times the
windowed and the CSR converge (alpha 0.1, tol 0, 40 iterations) in
turns, ``repeats`` times each (default 15), each from staging ``t0`` to
the scores on the host, as ``chip_smoke.py`` times its one converge of
each.  Prints one JSON line: the card's name and power limit, the
package it timed, every converge's seconds and their medians.

It calls only entry points whose signatures are those of the first
port, so run as a file it can time another checkout of the package,
which ``PYTHONPATH`` then names (the file's own directory holds no
package of that name)::

    PYTHONPATH=<checkout> python3 protocol_tpu_torch/bench/headline_converge.py

Two trees run so in turns, on one card, compare the converges with the
host's share of each included; a gain is claimed from ten such pairs
or more.  Importing it runs nothing; ``run()`` raises without a card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import protocol_tpu_torch
from protocol_tpu_torch.models.graphs import scale_free
from protocol_tpu_torch.ops import gather_window as gw
from protocol_tpu_torch.ops import sparse as sp
from protocol_tpu_torch.trust.graph import TrustGraph

#: The headline graph and converge.
N, NNZ, SEED, ITERS = 1_000_000, 50_000_000, 7, 40
#: Converges of each formulation, in turns.
REPEATS = 15


def prepared(n: int, nnz: int, seed: int):
    """``(graph, g, dangling, p)``: the scale-free graph, its edges
    without self edges, rows normalised and in dst order (``g``), the
    dangling mask and the pre-trust vector, on the host."""
    graph = scale_free(n, nnz, seed=seed)
    g = graph.drop_self_edges()
    w, dangling = g.row_normalized()
    g = TrustGraph(g.n, g.src, g.dst, w, graph.pre_trusted).sorted_by_dst()
    return graph, g, dangling, graph.pre_trust_vector()


def run(repeats: int = REPEATS) -> dict:
    """Time ``repeats`` windowed and CSR headline converges in turns."""
    dev = protocol_tpu_torch.resolve_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    _, g, dangling, p = prepared(N, NNZ, SEED)
    plan = gw.build_window_plan(g.src, g.dst, g.weight, n=g.n)
    args = plan.device_args(dev)
    p_d = torch.from_numpy(p).to(dev)
    dang_d = torch.from_numpy(dangling.astype(np.float32)).to(dev)
    src_d = torch.from_numpy(g.src).to(dev)
    ptr_d = torch.from_numpy(g.row_ptr_by_dst()).to(dev)
    w_d = torch.from_numpy(g.weight).to(dev)

    def windowed():
        t, _, _ = gw.converge_windowed(
            *args, torch.from_numpy(p).to(dev), p_d, dang_d, n_rows=plan.n_rows,
            table_entries=plan.table_entries, alpha=0.1, tol=0.0, max_iter=ITERS,
        )
        return t.cpu()

    def csr():
        t, _, _ = sp.converge_csr(
            src_d, ptr_d, w_d, torch.from_numpy(p).to(dev), p_d, dang_d,
            alpha=0.1, tol=0.0, max_iter=ITERS,
        )
        return t.cpu()

    converges = {"windowed": windowed, "csr": csr}
    for fn in converges.values():  # warm-up: kernel load, allocator
        fn()
    seconds: dict[str, list[float]] = {name: [] for name in converges}
    for _ in range(repeats):
        for name, fn in converges.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            seconds[name].append(time.perf_counter() - t0)
    return {
        "nvidia_smi": smi,
        "package": protocol_tpu_torch.__file__,
        "iterations": ITERS,
        "seconds": seconds,
        "median_seconds": {name: statistics.median(s) for name, s in seconds.items()},
    }


if __name__ == "__main__":
    print(json.dumps(run(*(int(a) for a in sys.argv[1:2]))), flush=True)
