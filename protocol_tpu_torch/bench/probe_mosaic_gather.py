"""The in-block gather and transpose probes, and the random-gather rate
against table size, on the card.

Port of ``bench/probe_mosaic_gather.py``.  On the TPU that script mapped
what Mosaic could compile: a lane gather (``take_along_axis`` on axis 1)
over growing index ranges, a sublane gather (axis 0), an in-kernel
transpose, and XLA's gather against table size.  Here the two Pallas
kernels are hand-written CUDA kernels, with the reference's shapes,
index ranges and ``default_rng(0)`` draws, in the same order:

- K2 ``take_along_axis`` (``ops/csrc/take_along_axis.cu``), held against
  its plain version and ``torch.gather``.  It gathers from a table staged
  on chip where that pays, in one of two regimes that
  ``take_along_axis_geometry`` chooses from the shape: ``smem`` (a block
  stages a whole row of 16–200 KB) and ``direct`` (no staging; rows that
  fit L1 are served from there);
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
- Each K2 and K3 record also carries the kernel's trace time
  (``trace_ms``, ``bench/_timing.py::trace_ms``); each K2 record the
  regime it took and the earlier form's times (``earlier_ms``,
  ``earlier_trace_ms``: the port's first K2, kept as a yardstick in
  ``bench/csrc/take_along_axis_ldg.cu``).  ``check_edges()`` holds both
  kernels at the regimes' limits and at ragged and unaligned shapes.
"""

from __future__ import annotations

import functools
import json
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import _build
from . import yardsticks
from ._timing import bound_ms, kernel_vs_plain, same_bits, time_ms, trace_ms

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


#: Floats one block of K2 stages at most (``kStageMaxFloats`` of
#: ``csrc/take_along_axis.cu``): 200 KB of the 227 KB a block may hold.
STAGE_MAX_FLOATS = 51_200
#: Where a staged row is split among blocks, it takes at most one block
#: for each this many elements.
PART_MIN = 4096
#: The C entry point's regime codes.
REGIMES = {"smem": 1, "direct": 2}
#: Axis-1 rows of more than this many floats (and at most
#: ``STAGE_MAX_FLOATS``) are staged in shared memory; shorter rows are
#: served from L1 by the direct regime, which was faster there on the
#: card, as it was for longer rows and on axis 0 (PERF.md §6).
SMEM_MIN_COLS = 4096


class Geometry(NamedTuple):
    """A K2 launch: the regime and its parameters.

    - ``parts``: blocks that stage the same row and split its outputs
      (smem; 1 for direct);
    - ``per``: elements a thread of the direct regime (4, 8 or 16; 0
      for smem)."""

    regime: str
    parts: int = 1
    per: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _direct_per(axis: int, cols: int) -> int:
    """Elements a thread of the direct regime, the fastest of 4, 8 and
    16 at the probe's shapes on an H100 (PERF.md §6): rows that fit L1
    take more loads in flight a thread."""
    if axis == 0 or cols <= 1024 or cols > 131072:
        return 4
    return 8 if cols <= 2048 else 16


def take_along_axis_geometry(axis: int, rows: int, cols: int, sms: int) -> Geometry:
    """K2's launch at a ``(rows, cols)`` shape on a card of ``sms`` SMs:
    ``smem`` for axis-1 rows of 4,097 to 51,200 floats, else ``direct``."""
    if axis == 1 and SMEM_MIN_COLS < cols <= STAGE_MAX_FLOATS:
        # Enough blocks a row to fill two a SM (two staging blocks fit a
        # SM), and at most one block for each PART_MIN elements of it.
        return Geometry("smem", parts=max(1, min(2 * sms // rows, _cdiv(cols, PART_MIN))))
    return Geometry("direct", per=_direct_per(axis, cols))


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def take_along_axis(t: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``out[r, c] = t[r, idx[r, c]]`` (axis 1) or ``t[idx[r, c], c]``
    (axis 0) for a 2-D float32 ``t`` with a multiple of 4 columns (the
    kernel moves four elements a thread) and int32 ``idx`` of its shape.

    On CUDA tensors this launches ``csrc/take_along_axis.cu`` in the
    regime ``take_along_axis_geometry`` chooses and adds one to
    ``take_along_axis.launches``; on CPU tensors it is the plain
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
        g = take_along_axis_geometry(axis, rows, cols, _sm_count(device))
        _build.launch(
            "take_along_axis", device, t.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, cols,
            axis, REGIMES[g.regime], g.parts, g.per,
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


def _held(out: torch.Tensor, ref: torch.Tensor, what: str) -> None:
    if not same_bits(out, ref):
        raise RuntimeError(f"{what} differs from its plain version")


def _gather_record(rng, axis: int, rows: int, cols: int, device) -> tuple[dict, dict]:
    """K2's record at one shape, and the calls whose traces it still
    needs (``run`` traces them after every event time is taken)."""
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
    earlier = lambda: yardsticks.take_along_axis_ldg(t, idx, axis)  # noqa: E731
    _held(earlier(), take_along_axis_plain(t, idx, axis), f"the earlier take_along_axis at {(rows, cols)}")
    return dict(
        probe="mosaic_gather", kernel="take_along_axis", axis=axis, shape=[rows, cols], range=hi,
        library_call="torch.gather(t, axis, idx.long())", gelem_per_s=n / res["ms"] / 1e6, **res,
        regime=take_along_axis_geometry(axis, rows, cols, _sm_count(device))._asdict(),
        earlier_ms=time_ms(earlier), launches_total=res["launches"],
    ), dict(trace_ms=lambda: take_along_axis(t, idx, axis), earlier_trace_ms=earlier)


def _transpose_record(rng, rows: int, cols: int, device) -> tuple[dict, dict]:
    """K3's record at one shape, and the call it still needs traced."""
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
        gelem_per_s=n / res["ms"] / 1e6, **res, launches_total=res["launches"],
    ), dict(trace_ms=lambda: transpose2d(t))


#: K2's edge shapes: +- 4 columns about each axis-1 limit (where rows
#: start and stop being staged, and where the direct regime changes its
#: elements a thread) at 3 rows and at 133 (fewer and more rows than the
#: card has SMs), the smallest shapes, and axis 0 about the probe's
#: 8,192 rows.
GATHER_EDGES = tuple(
    [(1, r, c + d)
     for c in (1024, 2048, SMEM_MIN_COLS, STAGE_MAX_FLOATS, 131072)
     for d in (-4, 0, 4) for r in (3, 133)]
    + [(1, 1, 4), (1, 2, 8), (1, 5, 12), (0, 1, 4), (0, 3, 8), (0, 5, 132)]
    + [(0, r, c) for r in (8188, 8192, 8196) for c in (4, 132)]
)
#: K3's edge shapes: ragged tiles, one row or column, and rows and
#: columns whose bytes are not multiples of 16.
TRANSPOSE_EDGES = ((33, 65), (1, 4), (4, 1), (65, 4097), (128, 8190), (100, 36), (4098, 128))


def _edge_indices(gen, axis: int, rows: int, cols: int, device) -> torch.Tensor:
    """Random indices with both ends of the range and values outside it
    (which the kernel clamps) planted in every seventh element."""
    hi = rows if axis == 0 else cols
    idx = torch.randint(0, hi, (rows, cols), generator=gen, device=device, dtype=torch.int32)
    planted = torch.tensor([0, hi - 1, -1, hi, -(2**31), 2**31 - 1], dtype=torch.int32, device=device)
    flat = idx.view(-1)
    at = torch.arange(0, flat.numel(), 7, device=device)
    flat[at] = planted[torch.arange(at.numel(), device=device) % planted.numel()]
    return idx


def check_edges(device=None) -> dict:
    """K2 and its earlier form at ``GATHER_EDGES``, held bit-equal to the
    plain version and to ``torch.gather`` on the clamped indices (which
    both require in range), and K3 at ``TRANSPOSE_EDGES``, bit-equal to
    the plain transpose.  Raises on a difference; returns what was held."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"the edge checks run on the card; got device {device}")
    gen = torch.Generator(device=device)
    sms = _sm_count(device)
    gathers = []
    for axis, rows, cols in GATHER_EDGES:
        gen.manual_seed(rows * 1_000_003 + cols * 2 + axis)
        t = torch.rand((rows, cols), generator=gen, device=device)
        idx = _edge_indices(gen, axis, rows, cols, device)
        clamped = idx.clamp(0, (rows if axis == 0 else cols) - 1)
        ref = take_along_axis_plain(t, clamped, axis)
        _held(torch.gather(t, axis, clamped.long()), ref, "torch.gather")
        _held(take_along_axis(t, idx, axis), ref, f"take_along_axis at {(axis, rows, cols)}")
        _held(yardsticks.take_along_axis_ldg(t, idx, axis), ref,
              f"the earlier take_along_axis at {(axis, rows, cols)}")
        gathers.append(dict(axis=axis, shape=[rows, cols],
                            **take_along_axis_geometry(axis, rows, cols, sms)._asdict()))
        del t, idx, clamped, ref
    transposes = []
    for rows, cols in TRANSPOSE_EDGES:
        gen.manual_seed(rows * 1_000_003 + cols)
        t = torch.rand((rows, cols), generator=gen, device=device)
        _held(transpose2d(t), transpose2d_plain(t), f"transpose2d at {(rows, cols)}")
        transposes.append([rows, cols])
    return dict(take_along_axis=gathers, transpose2d=transposes, same_bits=True)


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
    traced = [_gather_record(rng, 1, r, c, device) for r, c in AXIS1_SHAPES]
    traced += [_gather_record(rng, 0, r, c, device) for r, c in AXIS0_SHAPES]
    traced += [_transpose_record(rng, r, c, device) for r, c in TRANSPOSE_SHAPES]
    records = [_table_gather_record(rng, n, device) for n in GATHER_TABLES]
    # The traces come last: event times taken after a profiler run ran
    # long on the host (PERF.md, header).
    for rec, calls in traced:
        wrapper = take_along_axis if rec["kernel"] == "take_along_axis" else transpose2d
        before = wrapper.launches
        rec.update({key: trace_ms(fn) for key, fn in calls.items()})
        rec["launches_total"] += wrapper.launches - before
    return [rec for rec, _ in traced] + records


def main() -> None:
    records = run()
    kind = torch.cuda.get_device_name(0)
    for rec in records:
        print(json.dumps({**rec, "device": kind}), flush=True)
    print(json.dumps({"edges": check_edges(), "device": kind}), flush=True)


if __name__ == "__main__":
    main()
