"""Sparse trust steps on PyTorch: the double-single prefix machinery,
the gather-only CSR step and the shared power-iteration loop.

Port of ``protocol_tpu/ops/sparse.py``.  One damped power step is

    t' = (1−α)·(Cᵀt + (Σ_{i dangling} t_i)·p) + α·p,   t' ← t' / Σ t'

Everything up to ``Cᵀt`` repeats the reference's arithmetic op for op,
so the prefix sums and row sums are bit-identical to the JAX package
(tests/test_torch_kernels.py); only the epilogue's two ``sum``
reductions may run in another order.  None of these passes is a Pallas
kernel in the reference (they are jit'd XLA), so they stay plain
PyTorch here; their times on the card are in PERF.md.
"""

from __future__ import annotations

import math

import torch


def _two_sum(a, b):
    """The ``_compensated_cumsum`` combiner: TwoSum of the hi lanes,
    lo lanes summed with the rounding error."""
    a_hi, a_lo = a
    b_hi, b_lo = b
    s = a_hi + b_hi
    bb = s - a_hi
    err = (a_hi - (s - bb)) + (b_hi - bb)
    return s, a_lo + b_lo + err


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``lax.associative_scan``'s interleave: both operands zero-padded
    to the output length and added, so a ``-0.0`` comes out ``+0.0``
    exactly as in the reference."""
    n = a.shape[0] + b.shape[0]
    pa = a.new_zeros(n)
    pb = b.new_zeros(n)
    pa[0::2] = a
    pb[1::2] = b
    return pa + pb


def _scan(elems: tuple[torch.Tensor, torch.Tensor]):
    """``lax.associative_scan(_two_sum, ...)`` along axis 0, with the
    same odd/even recursion (combine adjacent pairs, recurse, combine
    the evens, interleave) — a sequential scan would round differently."""
    num = elems[0].shape[0]
    if num < 2:
        return elems
    reduced = _two_sum(tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems))
    odd = _scan(reduced)
    if num % 2 == 0:
        even = _two_sum(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = _two_sum(odd, tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def _compensated_cumsum(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive prefix sum in double-single (hi, lo) arithmetic, the
    reference's ``lax.associative_scan`` with a TwoSum combiner."""
    hi, lo = _scan((x, torch.zeros_like(x)))
    return hi, lo


#: Edges per cumsum block in the hierarchical row-sum.
_ROWSUM_BLOCK = 2048


def _ds_add(ah, al, bh, bl):
    """Double-single addition (TwoSum + renormalize)."""
    s = ah + bh
    v = s - ah
    e = (ah - (s - v)) + (bh - v)
    e = e + al + bl
    hi = s + e
    lo = e - (hi - s)
    return hi, lo


def _shift_right(x: torch.Tensor, shift: int) -> torch.Tensor:
    """``x`` moved ``shift`` places along axis 1, zero-filled on the left."""
    out = torch.zeros_like(x)
    out[:, shift:] = x[:, :-shift]
    return out


def _ds_cumsum_axis1(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive double-single prefix sum along axis 1 via Hillis-Steele
    (log2(B) shifted double-single adds)."""
    hi, lo = x, torch.zeros_like(x)
    b = x.shape[1]
    shift = 1
    while shift < b:
        hi, lo = _ds_add(hi, lo, _shift_right(hi, shift), _shift_right(lo, shift))
        shift <<= 1
    return hi, lo


def rowsum_sorted(contrib: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """Per-row sums of dst-sorted contributions,
    ``out[j] = sum(contrib[row_ptr[j] : row_ptr[j+1]])``, through the
    reference's hierarchical double-single prefix: block-local
    Hillis-Steele, a TwoSum scan over block totals, four pointer
    lookups, and hi/lo-separate differencing (the hi cancellation stays
    exact)."""
    e = contrib.shape[0]
    b = _ROWSUM_BLOCK
    n_blocks = -(-e // b)
    padded = torch.nn.functional.pad(contrib, (0, n_blocks * b - e))
    wh, wl = _ds_cumsum_axis1(padded.reshape(n_blocks, b))
    hi_in, lo_in = _compensated_cumsum(wh[:, -1] + wl[:, -1])
    # Exclusive block prefixes.
    zero = contrib.new_zeros(1)
    bhi = torch.cat([zero, hi_in[:-1]])
    blo = torch.cat([zero, lo_in[:-1]])
    # Inclusive prefix at index i-1 for every row pointer (i=0 -> 0);
    # floor division and remainder match jnp's semantics for i = -1.
    i = row_ptr - 1
    blk = torch.clamp(torch.div(i, b, rounding_mode="floor"), 0, n_blocks - 1)
    off = torch.clamp(torch.remainder(i, b), 0, b - 1)
    flat = blk * b + off
    ph, pl = _ds_add(
        bhi.index_select(0, blk),
        blo.index_select(0, blk),
        wh.reshape(-1).index_select(0, flat),
        wl.reshape(-1).index_select(0, flat),
    )
    ph = torch.where(i < 0, 0.0, ph)
    pl = torch.where(i < 0, 0.0, pl)
    return (ph[1:] - ph[:-1]) + (pl[1:] - pl[:-1])


def damp(
    ct: torch.Tensor,
    t: torch.Tensor,
    p: torch.Tensor,
    dangling: torch.Tensor,
    alpha: torch.Tensor,
) -> torch.Tensor:
    """The epilogue every step shares: dangling mass to ``p``, damping
    toward ``p``, L1 renormalisation."""
    dangling_mass = torch.sum(t * dangling)
    t_new = (1.0 - alpha) * (ct + dangling_mass * p) + alpha * p
    return t_new / torch.sum(t_new)


def power_step_csr(
    src: torch.Tensor,
    row_ptr: torch.Tensor,
    w: torch.Tensor,
    t: torch.Tensor,
    p: torch.Tensor,
    dangling: torch.Tensor,
    alpha: torch.Tensor,
) -> torch.Tensor:
    """One damped step in the gather-only CSR formulation:
    ``cᵀt[j] = rowsum_sorted(w · t[src], row_ptr)``."""
    ct = rowsum_sorted(w * t.index_select(0, src), row_ptr)
    return damp(ct, t, p, dangling, alpha)


def run_power_iteration(
    step_fn, t0: torch.Tensor, *, tol: float, max_iter: int,
    record_residuals: bool = False,
):
    """Iterate ``step_fn`` with the reference's exit rule,
    ``(it < max_iter) & ((it == 0) | (resid > tol))`` from ``prev = inf``;
    ``tol <= 0`` runs exactly ``max_iter`` steps.

    Returns ``(t, iterations, residual)`` — ``residual`` a 0-d device
    tensor — plus, with ``record_residuals``, the ``(max_iter,)`` device
    history written in place each step and fetched once by the caller.
    ``t0`` is not written to.

    Host syncs: none inside the loop when ``tol <= 0``.  With
    ``tol > 0`` the exit test reads the residual on the host once per
    iteration (``.item()``); keeping it on the device needs a CUDA-graph
    loop, a later item (ROADMAP).  Scores are the same op sequence
    either way, so recording does not change them."""
    t = t0
    prev = torch.full_like(t0, math.inf)
    resid = torch.tensor(math.inf, dtype=t0.dtype, device=t0.device)
    hist = (
        torch.zeros(max_iter, dtype=t0.dtype, device=t0.device)
        if record_residuals
        else None
    )
    it = 0
    while it < max_iter:
        t_new = step_fn(t)
        prev, t = t, t_new
        if tol > 0 or record_residuals:
            resid = torch.sum(torch.abs(t - prev))
            if hist is not None:
                hist[it] = resid
        it += 1
        if tol > 0 and not resid.item() > tol:
            break
    if tol <= 0 and not record_residuals:
        resid = torch.sum(torch.abs(t - prev))
    if hist is not None:
        return t, it, resid, hist
    return t, it, resid


def converge_csr(
    src: torch.Tensor,
    row_ptr: torch.Tensor,
    w: torch.Tensor,
    t0: torch.Tensor,
    p: torch.Tensor,
    dangling: torch.Tensor,
    *,
    alpha: torch.Tensor | float = 0.1,
    tol: float = 1e-6,
    max_iter: int = 50,
    record_residuals: bool = False,
) -> tuple:
    """CSR convergence; returns ``(t, iterations, residual[, history])``
    (see ``run_power_iteration``).  ``alpha`` is used as a float32
    scalar on ``t0``'s device, as the reference stages it."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=t0.device)
    return run_power_iteration(
        lambda t: power_step_csr(src, row_ptr, w, t, p, dangling, alpha),
        t0,
        tol=tol,
        max_iter=max_iter,
        record_residuals=record_residuals,
    )
