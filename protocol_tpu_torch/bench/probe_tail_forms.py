"""The pointer tail (K8) in several forms, side by side on the card.

    python -m protocol_tpu_torch.bench.probe_tail_forms

On the CSR step's operands of the headline graph (``scale_free(1M,
50M, seed=7)``, dst-sorted, row-normalised weights, uniform scores):
the 24,415 blocks of prefix lanes and the 1,000,001 row pointers.  It
times the port's kernel (``ops/csrc/rowsum_tail.cu``: 4 pointers a
thread, interleaved over a warp's tile, over a resident grid), the
same kernel and a consecutive layout (a thread's pointers side by
side) at 1, 2, 4 and 8 pointers a thread over a resident grid or a full
one (``bench/csrc/rowsum_tail_forms.cu``), and the earlier
one-thread-a-pointer form (``bench/csrc/rowsum_tail_scalar.cu``).  Each form is held
bit-equal to the plain version first (a difference raises), then every
form is timed in two rounds, the second in the reverse order, so that a
drift of the card shows as a difference between rounds.  Prints one
JSON line per form.  Importing it runs nothing; ``run()`` raises
without a card.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import resolve_device
from ..models.graphs import scale_free
from ..ops import _build
from ..ops import sparse as sp
from ..trust.graph import TrustGraph
from . import yardsticks
from ._timing import same_bits, time_ms

#: The headline graph.
N, NNZ, SEED = 1_000_000, 50_000_000, 7
#: Layouts of ``rowsum_tail_forms.cu``.
LAYOUTS = {"interleaved": 0, "consecutive": 1}
#: (layout, pointers a thread, resident grid) of the probed forms.
FORMS = tuple(
    (layout, per, resident)
    for layout in LAYOUTS for per in (1, 2, 4, 8) for resident in (True, False)
)


def _operands(device: torch.device):
    """The CSR step's tail operands at the headline graph."""
    graph = scale_free(N, NNZ, seed=SEED).drop_self_edges()
    w, _ = graph.row_normalized()
    g = TrustGraph(graph.n, graph.src, graph.dst, w, graph.pre_trusted).sorted_by_dst()
    t = torch.full((g.n,), 1.0 / g.n, device=device)
    contrib = torch.from_numpy(g.weight).to(device) * t.index_select(
        0, torch.from_numpy(g.src).to(device)
    )
    ptr = torch.from_numpy(g.row_ptr_by_dst()).to(device)
    wh, wl = sp.ds_cumsum_axis1(contrib, sp._ROWSUM_BLOCK)
    return (wh, wl, *sp.block_total_scan(wh, wl), ptr)


def _form(operands, layout: str, per: int, resident: bool):
    wh, wl, hi_in, lo_in, ptr = operands

    def call():
        out = wh.new_empty(ptr.shape[0] - 1)
        _build.launch(
            "rowsum_tail_forms", wh.device, wh.data_ptr(), wl.data_ptr(), hi_in.data_ptr(),
            lo_in.data_ptr(), ptr.data_ptr(), out.data_ptr(), wh.shape[0], wh.shape[1],
            ptr.shape[0] - 1, per, int(resident), LAYOUTS[layout],
        )
        return out

    return call


def run(device=None) -> list[dict]:
    """One record per form: its two rounds' times in ms and their mean."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"the probe times the card; got device {device}")
    operands = _operands(device)
    plain = sp._rowsum_tail(*operands)
    calls = {"port": lambda: sp.rowsum_tail(*operands),
             "scalar": lambda: yardsticks.rowsum_tail_scalar(*operands)}
    calls.update({
        f"{layout}_per{per}_{'resident' if resident else 'full'}": _form(
            operands, layout, per, resident
        )
        for layout, per, resident in FORMS
    })
    for name, call in calls.items():
        if not same_bits(call(), plain):
            raise RuntimeError(f"tail form {name} differs from the plain version")
    rounds = {name: [] for name in calls}
    for order in (list(calls), list(reversed(calls))):
        for name in order:
            rounds[name].append(time_ms(calls[name]))
    return [
        {"probe": "tail_forms", "form": name, "ms_rounds": ms, "ms": float(np.mean(ms)),
         "pointers": int(operands[4].shape[0]), "blocks": int(operands[0].shape[0])}
        for name, ms in rounds.items()
    ]


def main() -> None:
    kind = torch.cuda.get_device_name(0)
    for rec in run():
        print(json.dumps({**rec, "device": kind}), flush=True)


if __name__ == "__main__":
    main()
