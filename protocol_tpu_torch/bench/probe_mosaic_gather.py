"""The in-block gather and transpose probes, and the random-gather rate
against table size, on the card.

Port of ``bench/probe_mosaic_gather.py``.  On the TPU that script mapped
what Mosaic could compile: a lane gather (``take_along_axis`` on axis 1)
over growing index ranges, a sublane gather (axis 0), an in-kernel
transpose, and XLA's gather against table size.  Here the two Pallas
kernels are hand-written CUDA kernels, with the reference's shapes,
index ranges and ``default_rng(0)`` draws, in the same order:

- K2 ``take_along_axis`` (``ops/csrc/take_along_axis.cu``), held against
  its plain version and ``torch.gather``;
- K3 ``transpose2d`` (``ops/csrc/transpose2d.cu``), held against
  ``t.t().contiguous()``, which is its plain version and the library
  call at once;
- the XLA leg stays a PyTorch call, ``t[idx]``: 8M int32 indices into
  tables of 16,384 / 131,072 / 1,048,576 entries.

Differences from the reference script:

- Importing this module runs nothing; ``run()`` measures and
  ``python -m protocol_tpu_torch.bench.probe_mosaic_gather`` prints one
  JSON line per measurement.
- Nothing is caught.  The reference wrapped each shape in ``try`` and
  printed ``FAILED`` because Mosaic's crashes were what it measured; a
  kernel here that does not build, launch or match raises.
- The timing doctrine of the reference (dependent ``fori_loop`` chains
  that keep XLA from hoisting or deleting the op) is dropped: eager
  PyTorch launches each call for real, and every time is the median of
  CUDA-event-timed calls after warm-up (``bench/_timing.py``).
- The XLA leg times the index alone; the reference's ``.max()`` only
  kept the result alive.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import resolve_device
from ..ops import _build
from ._timing import bound_ms, kernel_vs_plain, time_ms

#: (R, L) of the lane-gather (axis 1) probe; indices in [0, L).
AXIS1_SHAPES = ((8192, 128), (1024, 1024), (128, 8192), (64, 16384), (8, 131072), (8, 1048576))
#: (R, L) of the sublane-gather (axis 0) probe; indices in [0, R).
AXIS0_SHAPES = ((8, 128), (64, 128), (256, 128), (1024, 128), (8192, 128))
#: (R, L) inputs of the transpose probe.
TRANSPOSE_SHAPES = ((128, 8192), (8192, 128))
#: Table sizes and index count of the random-gather leg.
GATHER_TABLES = (16384, 131072, 1048576)
GATHER_INDICES = 8_000_000


def take_along_axis_plain(t: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """The plain PyTorch version of K2, the reference probe's own
    oracle: ``t[arange(R)[:, None], idx]`` for axis 1 and
    ``t[idx, arange(L)[None, :]]`` for axis 0."""
    rows, cols = t.shape
    if axis == 1:
        return t[torch.arange(rows, device=t.device)[:, None], idx]
    return t[idx, torch.arange(cols, device=t.device)[None, :]]


def take_along_axis(t: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``out[r, c] = t[r, idx[r, c]]`` (axis 1) or ``t[idx[r, c], c]``
    (axis 0) for a 2-D float32 ``t`` with a multiple of 4 columns (the
    kernel moves four elements a thread) and int32 ``idx`` of its shape.

    On CUDA tensors this launches ``csrc/take_along_axis.cu`` and adds
    one to ``take_along_axis.launches``; on CPU tensors it is the plain
    version.  Any other mix raises."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if t.dim() != 2 or tuple(idx.shape) != tuple(t.shape):
        raise ValueError(f"t must be 2-D and idx of its shape, got {tuple(t.shape)}, {tuple(idx.shape)}")
    if t.shape[1] % 4:
        raise ValueError(f"t must have a multiple of 4 columns, got {t.shape[1]}")
    if t.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"t must be float32 and idx int32, got {t.dtype}, {idx.dtype}")
    device = _build.operand_device("take_along_axis", t=t, idx=idx)
    if device.type == "cpu":
        return take_along_axis_plain(t, idx, axis)
    out = torch.empty_like(t)
    if out.numel():
        rows, cols = t.shape
        _build.launch(
            "take_along_axis", device, t.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, cols, axis
        )
        take_along_axis.launches += 1
    return out


#: Kernel launches in this process (the plain version does not count).
take_along_axis.launches = 0  # type: ignore[attr-defined]


def transpose2d_plain(t: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K3, and the library call too:
    ``t.t().contiguous()``."""
    return t.t().contiguous()


#: grid.y of the kernel walks the row tiles: at most 65,535 of 32 rows.
_TRANSPOSE_MAX_ROWS = 65_535 * 32


def transpose2d(t: torch.Tensor) -> torch.Tensor:
    """The (L, R) transpose of a 2-D float32 ``t``, contiguous.

    On CUDA tensors this launches ``csrc/transpose2d.cu`` and adds one
    to ``transpose2d.launches``; on CPU tensors it is the plain version.
    Any other device raises."""
    if t.dim() != 2:
        raise ValueError(f"t must be 2-D, got {tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"t must be float32, got {t.dtype}")
    device = _build.operand_device("transpose2d", t=t)
    if device.type == "cpu":
        return transpose2d_plain(t)
    rows, cols = t.shape
    if rows > _TRANSPOSE_MAX_ROWS:
        raise ValueError(f"transpose2d takes at most {_TRANSPOSE_MAX_ROWS} rows, got {rows}")
    out = t.new_empty((cols, rows))
    if out.numel():
        _build.launch("transpose2d", device, t.data_ptr(), out.data_ptr(), rows, cols)
        transpose2d.launches += 1
    return out


#: Kernel launches in this process (the plain version does not count).
transpose2d.launches = 0  # type: ignore[attr-defined]


def _gather_record(rng, axis: int, rows: int, cols: int, device) -> dict:
    hi = rows if axis == 0 else cols
    t = torch.from_numpy(rng.random((rows, cols), dtype=np.float32)).to(device)
    idx = torch.from_numpy(rng.integers(0, hi, (rows, cols)).astype(np.int32)).to(device)
    idx64 = idx.long()
    n = rows * cols
    res = kernel_vs_plain(
        lambda: take_along_axis(t, idx, axis), lambda: take_along_axis_plain(t, idx, axis),
        wrapper=take_along_axis,
        # idx read, out written, t read once: 4 B each per element.
        nbytes=12 * n, library=lambda: torch.gather(t, axis, idx64),
    )
    return dict(
        probe="mosaic_gather", kernel="take_along_axis", axis=axis, shape=[rows, cols], range=hi,
        library_call="torch.gather(t, axis, idx.long())", gelem_per_s=n / res["ms"] / 1e6, **res,
    )


def _transpose_record(rng, rows: int, cols: int, device) -> dict:
    t = torch.from_numpy(rng.random((rows, cols), dtype=np.float32)).to(device)
    n = rows * cols
    # One element read and one written, 4 B each.
    res = kernel_vs_plain(
        lambda: transpose2d(t), lambda: transpose2d_plain(t), wrapper=transpose2d, nbytes=8 * n
    )
    # The plain version is the library call: timed once, reported as both.
    res["library_ms"] = res["plain_ms"]
    return dict(
        probe="mosaic_gather", kernel="transpose2d", shape=[rows, cols],
        library_call="t.t().contiguous() (= the plain version)",
        gelem_per_s=n / res["ms"] / 1e6, **res,
    )


def _table_gather_record(rng, entries: int, device) -> dict:
    t = torch.from_numpy(rng.random(entries, dtype=np.float32)).to(device)
    idx = torch.from_numpy(
        rng.integers(0, entries, GATHER_INDICES).astype(np.int32)
    ).to(device)
    ms = time_ms(lambda: t[idx])
    # idx read and out written, 4 B a gathered element; the table once.
    nbytes = 8 * GATHER_INDICES + 4 * entries
    return dict(
        probe="mosaic_gather", op="t[idx]", table=entries, indices=GATHER_INDICES, ms=ms,
        gelem_per_s=GATHER_INDICES / ms / 1e6, bound_ms=bound_ms(nbytes), bytes=nbytes,
    )


def run(device=None) -> list[dict]:
    """Every measurement of the probe on the card, in the reference
    script's order, one dict each.  ``device=None`` means CUDA and
    raises ``RuntimeError`` where there is none; the probes time the
    card, so a CPU device raises ``ValueError``."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"the probes time the card; got device {device}")
    rng = np.random.default_rng(0)
    records = [_gather_record(rng, 1, r, c, device) for r, c in AXIS1_SHAPES]
    records += [_gather_record(rng, 0, r, c, device) for r, c in AXIS0_SHAPES]
    records += [_transpose_record(rng, r, c, device) for r, c in TRANSPOSE_SHAPES]
    records += [_table_gather_record(rng, n, device) for n in GATHER_TABLES]
    return records


def main() -> None:
    records = run()
    kind = torch.cuda.get_device_name(0)
    for rec in records:
        print(json.dumps({**rec, "device": kind}), flush=True)


if __name__ == "__main__":
    main()
