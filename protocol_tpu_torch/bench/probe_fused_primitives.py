"""The fused windowed pipeline's primitives, on the card.

Port of ``bench/probe_fused_primitives.py``, with its shapes and its
``default_rng(0)``, ``default_rng(1)`` and ``default_rng(2)`` draws:

1. The pipeline's two 268 MB transposes, (1024, 1024, 64) by
   ``(1, 0, 2)`` and (1024, 64, 1024) by ``(0, 2, 1)``.  They are XLA
   ops in the reference, not Pallas, and stay PyTorch calls here:
   ``permute(...).contiguous()``.
2. K4, the region-table windowed gather: K1 without the weight, over a
   table of 256 KB regions (``gather_region``, the hand-written CUDA
   kernel ``ops/csrc/gather_region.cu``), held against its plain
   version at the probe's 1,024 regions (67.1M slots).

Differences from the reference script:

- Importing this module runs nothing; ``run()`` measures and
  ``python -m protocol_tpu_torch.bench.probe_fused_primitives`` prints
  one JSON line per measurement.
- Nothing is caught: a kernel that does not build, launch or match
  raises.
- The timing doctrine of the reference (ping-pong ``fori_loop`` carries
  that keep XLA from hoisting, folding or deleting the transposes) is
  dropped: eager PyTorch launches each call for real, and every time is
  the median of CUDA-event-timed calls after warm-up
  (``bench/_timing.py``).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import resolve_device
from ..ops import _build
from ._timing import bound_ms, kernel_vs_plain, time_ms

#: The big bucket transpose's (W, W, S) shape.
W, S = 1024, 64
#: (shape, permutation, seed) of the two transposes.
TRANSPOSES = (((W, W, S), (1, 0, 2), 0), ((1024, 64, 1024), (0, 2, 1), 1))
#: 1024-slot rows (= 1024-entry windows) per 256 KB region.
BLOCK_ROWS = 64
#: Table entries (and slots) per window.
WINDOW = 1024
#: Table entries per region, as a (512, 128) block.
REGION = BLOCK_ROWS * WINDOW
#: The probe's size: 1,024 regions, 67.1M slots.
N_REGIONS = 1024


def gather_region_plain(wid: torch.Tensor, table: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K4:
    ``table.flat[(r // 512) * 65536 + wid[r // 8] * 1024 + local[r, c]]``
    for slot ``(r, c)``."""
    slot_rows = local.shape[0]
    region = torch.arange(slot_rows, device=local.device) // (8 * BLOCK_ROWS)
    base = region * REGION + wid.long().repeat_interleave(8) * WINDOW
    return table.reshape(-1)[base[:, None] + local]


def gather_region(wid: torch.Tensor, table: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """``out[r, c] = table.flat[(r // 512) * 65536 + wid[r // 8] * 1024
    + local[r, c]]`` for a ``(n_regions * 512, 128)`` float32 ``table``
    and int32 ``local`` of the same shape (window-local indices in
    [0, 1024)), and int32 ``wid`` of ``(n_regions * 64,)`` window ids in
    [0, 64).

    On CUDA tensors this launches ``csrc/gather_region.cu`` and adds one
    to ``gather_region.launches``; on CPU tensors it is the plain
    version.  Any other mix raises."""
    if table.dim() != 2 or table.shape[1] != 128 or table.shape[0] % (8 * BLOCK_ROWS):
        raise ValueError(f"table must be (n_regions * 512, 128), got {tuple(table.shape)}")
    if tuple(local.shape) != tuple(table.shape):
        raise ValueError(f"local must have the table's shape, got {tuple(local.shape)}")
    n_rows = table.shape[0] // 8
    if tuple(wid.shape) != (n_rows,):
        raise ValueError(f"wid must have shape ({n_rows},), got {tuple(wid.shape)}")
    for name, a, dtype in (
        ("wid", wid, torch.int32), ("table", table, torch.float32), ("local", local, torch.int32)
    ):
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")
    device = _build.operand_device("gather_region", wid=wid, table=table, local=local)
    if device.type == "cpu":
        return gather_region_plain(wid, table, local)
    out = torch.empty_like(table)
    if n_rows:
        _build.launch(
            "gather_region", device, wid.data_ptr(), table.data_ptr(), local.data_ptr(),
            out.data_ptr(), n_rows,
        )
        gather_region.launches += 1
    return out


#: Kernel launches in this process (the plain version does not count).
gather_region.launches = 0  # type: ignore[attr-defined]


def region_gather_bytes(wid: torch.Tensor) -> tuple[int, int]:
    """The bytes K4 must move for window ids ``wid``, and the number of
    distinct (region, window) pairs among them: ``local`` read and
    ``out`` written (8 B a slot), ``wid`` read (4 B a row), and each
    distinct window's 4 KB read once."""
    n_rows = wid.shape[0]
    region = torch.arange(n_rows, device=wid.device) // BLOCK_ROWS
    distinct = int(torch.unique(region * BLOCK_ROWS + wid.long()).numel())
    return 8 * n_rows * WINDOW + 4 * n_rows + 4 * WINDOW * distinct, distinct


def _transpose_record(shape, perm, seed: int, device) -> dict:
    x = torch.from_numpy(np.random.default_rng(seed).random(shape, np.float32)).to(device)
    ms = time_ms(lambda: x.permute(*perm).contiguous())
    nbytes = 8 * x.numel()  # one read and one write of every element
    return dict(
        probe="fused_primitives", op=f"permute{perm}.contiguous()", shape=list(shape), ms=ms,
        gb_per_s=nbytes / ms / 1e6, bound_ms=bound_ms(nbytes), bytes=nbytes,
    )


def _region_gather_record(device) -> dict:
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.random((N_REGIONS * 512, 128), np.float32)).to(device)
    wid = torch.from_numpy(rng.integers(0, 64, N_REGIONS * BLOCK_ROWS).astype(np.int32)).to(device)
    local = torch.from_numpy(
        rng.integers(0, 1024, (N_REGIONS * 512, 128)).astype(np.int32)
    ).to(device)
    nbytes, distinct = region_gather_bytes(wid)
    res = kernel_vs_plain(
        lambda: gather_region(wid, table, local), lambda: gather_region_plain(wid, table, local),
        wrapper=gather_region, nbytes=nbytes,
    )
    slots = local.numel()
    return dict(
        probe="fused_primitives", kernel="gather_region", shape=list(table.shape),
        n_regions=N_REGIONS, distinct_windows=distinct, library_call=None,
        gelem_per_s=slots / res["ms"] / 1e6, **res,
    )


def run(device=None) -> list[dict]:
    """Every measurement of the probe on the card, in the reference
    script's order, one dict each.  ``device=None`` means CUDA and
    raises ``RuntimeError`` where there is none; the probes time the
    card, so a CPU device raises ``ValueError``."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"the probes time the card; got device {device}")
    records = [_transpose_record(shape, perm, seed, device) for shape, perm, seed in TRANSPOSES]
    records.append(_region_gather_record(device))
    return records


def main() -> None:
    records = run()
    kind = torch.cuda.get_device_name(0)
    for rec in records:
        print(json.dumps({**rec, "device": kind}), flush=True)


if __name__ == "__main__":
    main()
