"""Launches a ``torch.profiler`` session loses just after it starts.

    python -m protocol_tpu_torch.bench.probe_trace_start [--sessions N]

On the CSR step's row sums of the headline graph (``scale_free(1M, 50M,
seed=7)``, dst-sorted, row-normalised weights, uniform scores:
``ops/sparse.py::gathered_rowsum``, K9, K6 and K8 once each), it takes
``N`` profiler sessions of 20 calls each, alternating between a session
whose calls start as soon as the profiler has started and one settled
first (``_timing.py::settle_trace``: throwaway launches, then a wait).
A launch of the calls is lost where the trace holds its runtime call but
no device record with the same correlation id.  Prints one JSON line per
session that lost a launch (its lost launches' positions in launch
order) and a last summary line per variant: sessions, sessions that lost
a launch, launches lost, the most a session lost.  Importing it runs nothing; ``run()`` raises without a
card.
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import resolve_device
from ..models.graphs import scale_free
from ..ops import sparse as sp
from ..trust.graph import TrustGraph
from ._timing import TRACE_PRIMER_LAUNCHES, TRACE_SETTLE_S, settle_trace, settled_after

#: The headline graph.
N, NNZ, SEED = 1_000_000, 50_000_000, 7
#: Calls of the row sums a session.
CALLS = 20


def _operands(device: torch.device):
    """The CSR step's row-sum operands at the headline graph."""
    graph = scale_free(N, NNZ, seed=SEED).drop_self_edges()
    w, _ = graph.row_normalized()
    g = TrustGraph(graph.n, graph.src, graph.dst, w, graph.pre_trusted).sorted_by_dst()
    t = torch.full((g.n,), 1.0 / g.n, device=device)
    return (torch.from_numpy(g.weight).to(device), t, torch.from_numpy(g.src).to(device),
            torch.from_numpy(g.row_ptr_by_dst()).to(device))


def _session(fn, settled: bool) -> list[int]:
    """Positions, in launch order, of the launches of ``fn``'s calls that
    one session lost (a settled session's primer not counted)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if settled:
            settle_trace()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    after = settled_after(prof)
    recorded, launched = set(), []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            recorded.add(e.id)
        elif "LaunchKernel" in e.name and e.time_range.start > after:
            launched.append((e.time_range.start, e.id))
    return [i for i, (_, cid) in enumerate(sorted(launched)) if cid not in recorded]


def run(sessions: int = 400) -> list[dict]:
    device = resolve_device(None)
    operands = _operands(device)

    def fn():
        return sp.gathered_rowsum(*operands)

    fn()
    torch.cuda.synchronize()
    records, summary = [], {}
    for s in range(sessions):
        variant = "settled" if s % 2 else "at_start"
        lost = _session(fn, variant == "settled")
        row = summary.setdefault(variant, {"sessions": 0, "sessions_losing": 0,
                                           "launches_lost": 0, "most_lost": 0})
        row["sessions"] += 1
        row["sessions_losing"] += bool(lost)
        row["launches_lost"] += len(lost)
        row["most_lost"] = max(row["most_lost"], len(lost))
        if lost:
            records.append({"probe": "trace_start", "session": s, "variant": variant,
                            "lost_positions": lost})
    records += [{"probe": "trace_start", "variant": v, "calls_a_session": CALLS,
                 "primer_launches": TRACE_PRIMER_LAUNCHES if v == "settled" else 0,
                 "settle_s": TRACE_SETTLE_S if v == "settled" else 0.0, **row}
                for v, row in summary.items()]
    return records


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sessions", type=int, default=400)
    args = parser.parse_args()
    kind = torch.cuda.get_device_name(0)
    for rec in run(args.sessions):
        print(json.dumps({**rec, "device": kind}), flush=True)


if __name__ == "__main__":
    main()
