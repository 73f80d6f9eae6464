"""Sorted-segment helpers (the port of ``protocol_tpu/ops/segments.py``).

Values carrying sorted integer ids, folded per id: run-end masks and
the segmented block-carry scan, dtype- and monoid-agnostic.  The graft
prover's plain MSM (``zk/graft/pippenger.py``) folds its bucket runs
with them, the elliptic-curve group as the monoid; its kernel K13
(``ops/csrc/zk_msm_bucket.cu``) computes the same on the card.  Plain
PyTorch, any device.
"""

from __future__ import annotations

from typing import Callable

import torch


def run_end_mask(ids: torch.Tensor) -> torch.Tensor:
    """(..., n) sorted ids -> bool mask marking the LAST lane of every
    run of equal ids.  The final lane is always a run end (the wrapped
    ``roll`` comparison would otherwise drop it when all ids match)."""
    n = ids.shape[-1]
    nxt = torch.roll(ids, -1, dims=-1)
    last = torch.arange(n, device=ids.device) == n - 1
    return (ids != nxt) | last


def block_boundary_flags(ids_blocked: torch.Tensor) -> torch.Tensor:
    """(..., nblocks, B) sorted ids -> (..., nblocks) bool: True when
    the block contains an internal run boundary.  Sortedness makes the
    test O(1) per block: first == last implies the whole block is one
    run."""
    return ids_blocked[..., 0] != ids_blocked[..., -1]


def segmented_carry_scan(values, flags: torch.Tensor, combine: Callable, axis: int = -1):
    """Segmented inclusive Hillis–Steele scan over ``axis``.

    Computes ``C[b] = values[b] if flags[b] else combine(C[b-1],
    values[b])`` in ``log2(n)`` rounds.  ``combine(left, right)`` must
    be associative; ``values`` may have trailing payload dims beyond
    ``flags`` (they are broadcast on the mask)."""
    axis = axis % flags.dim()
    n = flags.shape[axis]
    lane = torch.arange(n, device=flags.device).reshape((n,) + (1,) * (flags.dim() - 1 - axis))
    extra = values.dim() - flags.dim()
    s = 1
    while s < n:
        v_shift = torch.roll(values, s, dims=axis)
        f_shift = torch.roll(flags, s, dims=axis)
        active = (lane >= s) & ~flags
        values = torch.where(
            active.reshape(active.shape + (1,) * extra), combine(v_shift, values), values
        )
        flags = flags | ((lane >= s) & f_shift)
        s <<= 1
    return values
