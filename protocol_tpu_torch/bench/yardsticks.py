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
