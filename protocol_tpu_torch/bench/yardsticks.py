"""Kernels that ``chip_smoke.py`` times beside the port's, on the card only.

- ``compensated_scan_global(x)``: the earlier form of the block-total
  scan (``bench/csrc/compensated_scan_global.cu``): one block over a
  device-memory level pyramid, fed by a separate PyTorch add of the
  block totals.  ``ops/sparse.py::block_total_scan`` replaced it.
- ``rowsum_tail_scalar(wh, wl, hi_in, lo_in, row_ptr)``: the earlier
  form of the pointer tail (``bench/csrc/rowsum_tail_scalar.cu``), one
  thread a pointer.  ``ops/sparse.py::rowsum_tail`` replaced it.
- ``empty_kernel()``: one launch of an empty kernel, the floor under
  every small kernel's time.
- ``take_along_axis_ldg(t, idx, axis)``: the earlier K2
  (``bench/csrc/take_along_axis_ldg.cu``), one read of the table a
  gathered element.  ``ops/csrc/take_along_axis.cu`` replaced it.
- ``gather_multiply(w, t, src)``: the earlier edge product of the CSR
  and COO steps (``bench/csrc/gather_multiply.cu``), ``w * t[src]``
  written to device memory, which ``ops/sparse.py::ds_cumsum_axis1``
  then scanned.  ``ops/sparse.py::gather_ds_cumsum`` replaced the pair.
- ``ntt_stage(x, tw, half)``: the first NTT (``bench/csrc/zk_ntt_stage.cu``),
  one launch a butterfly stage, in place on Montgomery Fr words;
  ``ntt_stages`` runs them all.  ``zk/graft/ntt.py::ntt_device``
  (``ops/csrc/zk_ntt.cu``) replaced it.
- ``msm_bucket_chunked(ds, perm, points)``: the first bucket sums
  (``bench/csrc/zk_msm_bucket_chunked.cu``), three launches over fixed
  16-lane chunks.  ``zk/graft/pippenger.py::msm_bucket`` replaced it.

The port never calls them.  Each takes CUDA tensors only and raises
otherwise; they keep no launch counts.
"""

from __future__ import annotations

import torch

from protocol_tpu_torch.ops import _build
from protocol_tpu_torch.ops.sparse import _check_edge_operands, _check_tail_operands


def _cuda(name: str, align: int = 16, **operands: torch.Tensor) -> torch.device:
    device = _build.operand_device(name, align=align, **operands)
    if device.type != "cuda":
        raise ValueError(f"{name} is a yardstick on the card: it takes CUDA tensors only")
    return device


def compensated_scan_global(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The earlier block-total scan of a contiguous 1-D float32 ``x``."""
    if x.dim() != 1 or x.dtype != torch.float32:
        raise ValueError("compensated_scan_global takes a 1-D float32 tensor")
    device = _cuda("compensated_scan_global", x=x)
    n = x.shape[0]
    hi, lo = torch.empty_like(x), torch.empty_like(x)
    if n:
        scratch = x.new_empty((n, 2))  # the levels above the input
        _build.launch(
            "compensated_scan_global", device,
            x.data_ptr(), hi.data_ptr(), lo.data_ptr(), scratch.data_ptr(), n,
        )
    return hi, lo


def rowsum_tail_scalar(wh, wl, hi_in, lo_in, row_ptr) -> torch.Tensor:
    """The earlier pointer tail, on the operands ``rowsum_tail`` takes."""
    _check_tail_operands(wh, wl, hi_in, lo_in, row_ptr)
    device = _cuda("rowsum_tail_scalar", wh=wh, wl=wl, hi_in=hi_in, lo_in=lo_in, row_ptr=row_ptr)
    n_blocks, b = wh.shape
    n = row_ptr.shape[0] - 1
    out = wh.new_empty(n)
    if n:
        _build.launch(
            "rowsum_tail_scalar", device, wh.data_ptr(), wl.data_ptr(), hi_in.data_ptr(),
            lo_in.data_ptr(), row_ptr.data_ptr(), out.data_ptr(), n_blocks, b, n,
        )
    return out


def empty_kernel(device: torch.device | str = "cuda") -> None:
    """One launch of an empty kernel on ``device``'s current stream."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("empty_kernel is a yardstick on the card: it takes a CUDA device")
    _build.launch("empty_kernel", device)


def take_along_axis_ldg(t: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """The earlier K2 on the operands ``take_along_axis`` takes."""
    if axis not in (0, 1) or t.dim() != 2 or tuple(idx.shape) != tuple(t.shape) or t.shape[1] % 4:
        raise ValueError("take_along_axis_ldg takes a 2-D t with a multiple of 4 columns and idx of its shape")
    if t.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError("take_along_axis_ldg takes float32 t and int32 idx")
    device = _cuda("take_along_axis_ldg", t=t, idx=idx)
    out = torch.empty_like(t)
    if out.numel():
        rows, cols = t.shape
        _build.launch(
            "take_along_axis_ldg", device, t.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, cols,
            axis,
        )
    return out


def gather_multiply(w: torch.Tensor, t: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The earlier edge product on the operands ``gather_ds_cumsum``
    takes; 4-byte accesses, so a slice at any element offset is taken."""
    _check_edge_operands("gather_multiply", w, t, src)
    device = _cuda("gather_multiply", align=4, w=w, t=t, src=src)
    out = w.new_empty(w.shape)
    if w.numel():
        _build.launch(
            "gather_multiply", device, w.data_ptr(), t.data_ptr(), src.data_ptr(),
            out.data_ptr(), w.numel(), t.numel(),
        )
    return out


def ntt_stage(x: torch.Tensor, tw: torch.Tensor, half: int) -> None:
    """One butterfly stage of the first NTT, in place: ``x`` (n, 4) int64
    words of Montgomery Fr, ``tw`` the stage's (half, 4) twiddles."""
    n = x.shape[0]
    if x.dtype != torch.int64 or x.dim() != 2 or x.shape[1] != 4 or tw.dtype != torch.int64:
        raise ValueError("ntt_stage: x must be an (n, 4) int64 word tensor")
    if half < 1 or half & (half - 1) or n % (2 * half) or tuple(tw.shape) != (half, 4):
        raise ValueError(f"ntt_stage: half {half} and twiddles {tuple(tw.shape)} do not fit n = {n}")
    device = _cuda("zk_ntt_stage", x=x, tw=tw)
    _build.launch("zk_ntt_stage", device, x.data_ptr(), tw.data_ptr(), n, half)


def ntt_stages(x: torch.Tensor, plan: torch.Tensor) -> None:
    """Every stage of the first NTT over ``x`` in place, bit-reversed
    input to natural output, with the plan ``zk/graft/ntt.py::_device_plan``
    caches (stage ``L``'s twiddles from row ``L/2 - 1``): log2(n) launches."""
    half, n = 1, x.shape[0]
    while half < n:
        ntt_stage(x, plan[half - 1 : 2 * half - 1], half)
        half <<= 1


def msm_bucket_chunked(ds: torch.Tensor, perm: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """The first bucket sums on the operands ``msm_bucket`` takes: the
    (32, 256, 3, 4) word grid, canonical Jacobian Fq, bucket 0 empty."""
    m = ds.shape[1]
    if ds.shape != perm.shape or ds.shape[0] != 32 or m < 1 or m & (m - 1):
        raise ValueError("msm_bucket_chunked: ds and perm must be (32, m), m a power of two")
    if ds.dtype != torch.int32 or perm.dtype != torch.int32 or tuple(points.shape) != (m, 3, 4):
        raise ValueError("msm_bucket_chunked: int32 ds and perm, (m, 3, 4) int64 points")
    device = _cuda("zk_msm_bucket_chunked", ds=ds, perm=perm, points=points)
    ch = min(m, 16)
    nch = m // ch
    tails = torch.empty((32, nch, 3, 4), dtype=torch.int64, device=device)
    flags = torch.empty((32, nch), dtype=torch.int32, device=device)
    loc = torch.empty((32, 256, 3, 4), dtype=torch.int64, device=device)
    carry_from = torch.full((32, 256), -2, dtype=torch.int32, device=device)
    out = torch.empty((32, 256, 3, 4), dtype=torch.int64, device=device)
    _build.launch(
        "zk_msm_bucket_chunked", device, ds.data_ptr(), perm.data_ptr(), points.data_ptr(),
        tails.data_ptr(), flags.data_ptr(), loc.data_ptr(), carry_from.data_ptr(),
        out.data_ptr(), m, ch,
    )
    return out
