"""Sparse trust steps on PyTorch: the double-single prefix machinery,
the gather-only CSR step, the COO step over it and the shared
power-iteration loop.

Port of ``protocol_tpu/ops/sparse.py``.  One damped power step is

    t' = (1−α)·(Cᵀt + (Σ_{i dangling} t_i)·p) + α·p,   t' ← t' / Σ t'

Everything up to ``Cᵀt`` repeats the reference's CSR arithmetic op for
op, so the prefix sums and row sums are bit-identical to the JAX package
(tests/test_torch_kernels.py); only the epilogue's two ``sum``
reductions may run in another order.  None of these passes is a Pallas
kernel in the reference (they are jit'd XLA).  On a card
``rowsum_sorted``'s three passes run as ``ds_cumsum_axis1``
(``csrc/ds_cumsum_rows.cu``), ``block_total_scan``
(``csrc/compensated_scan.cu``, which reads the block totals from the
prefix lanes itself) and ``rowsum_tail`` (``csrc/rowsum_tail.cu``).
The CSR and COO steps fold the edge product ``w · t[src]`` into the
first of them: ``gather_ds_cumsum`` (``csrc/gather_ds_cumsum.cu``)
gathers, multiplies and scans each 2048-edge block in one kernel, so the
products never reach device memory (``gathered_rowsum``).  All are
hand-written CUDA with the reference's op order; their plain versions
``_ds_cumsum_axis1``, ``_block_total_scan``, ``_rowsum_tail`` and
``_gather_ds_cumsum`` serve CPU tensors.  The COO step sums over ``dst``
with the same row sums on pointers derived from the dst order
(``dst_segments``), not with a scatter: its sums are double-single where
the reference's ``segment_sum`` is float32, so COO scores agree with the
reference within its cross-backend tolerance, not bit for bit.  The
epilogue stays plain PyTorch; the times on the card are in PERF.md.
"""

from __future__ import annotations

import math

import torch

from . import _build


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


def _check_prefix_operand(x: torch.Tensor, name: str, dim: int) -> None:
    if x.dim() != dim:
        raise ValueError(f"{name} takes a {dim}-D tensor, got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")


def _block_total_scan(wh: torch.Tensor, wl: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``block_total_scan``: the reference's
    composition, ``_compensated_cumsum(wh[:, -1] + wl[:, -1])``."""
    return _compensated_cumsum(wh[:, -1] + wl[:, -1])


def block_total_scan(wh: torch.Tensor, wl: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``_block_total_scan`` of the contiguous float32 prefix lanes
    ``(wh, wl)`` (n_blocks, B): the inclusive double-single scan of the
    block totals ``wh[:, -1] + wl[:, -1]``.

    On CUDA tensors this launches ``csrc/compensated_scan.cu`` (one
    block: it reads the totals from the lanes, keeps three levels of the
    recursion a pass in registers and the levels above in shared memory)
    and adds one to ``block_total_scan.launches``; a launch the card
    refuses raises.  On CPU tensors it is the plain version.  Mixed or
    other devices raise."""
    _check_prefix_operand(wh, "block_total_scan", 2)
    _check_prefix_operand(wl, "block_total_scan", 2)
    if wl.shape != wh.shape:
        raise ValueError(
            f"block_total_scan: wl has shape {tuple(wl.shape)}, wh {tuple(wh.shape)}"
        )
    if wh.shape[1] < 1:
        raise ValueError("block_total_scan takes blocks of at least one element")
    device = _build.operand_device("compensated_scan", wh=wh, wl=wl)
    if device.type == "cpu":
        return _block_total_scan(wh, wl)
    n, b = wh.shape
    hi, lo = wh.new_empty(n), wh.new_empty(n)
    if n:
        _build.launch(
            "compensated_scan", device,
            wh.data_ptr(), wl.data_ptr(), hi.data_ptr(), lo.data_ptr(), n, b,
        )
        block_total_scan.launches += 1
    return hi, lo


#: Kernel launches in this process (the plain version does not count).
block_total_scan.launches = 0  # type: ignore[attr-defined]


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


def _blocks(x: torch.Tensor, width: int) -> torch.Tensor:
    """The 1-D ``x`` in rows of ``width``, the last row zero-padded."""
    rows = -(-x.shape[0] // width)
    return torch.nn.functional.pad(x, (0, rows * width - x.shape[0])).reshape(rows, width)


def _ds_cumsum_blocks(x: torch.Tensor, width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``ds_cumsum_axis1(x, width)``: the prefix of
    the zero-padded copy."""
    return _ds_cumsum_axis1(_blocks(x, width))


#: Row widths the row-prefix kernel takes: the plan's 1024-slot rows and
#: ``rowsum_sorted``'s 2048-edge blocks.
DS_CUMSUM_WIDTHS = (1024, _ROWSUM_BLOCK)


def ds_cumsum_axis1(
    x: torch.Tensor, width: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """``_ds_cumsum_axis1`` of a contiguous 2-D float32 ``x``; with
    ``width``, of a contiguous 1-D ``x`` in rows of ``width``, the last
    row zero-padded (``rowsum_sorted``'s blocks).

    On a CUDA tensor this launches ``csrc/ds_cumsum_rows.cu`` (one block
    a row) and adds one to ``ds_cumsum_axis1.launches``; the kernel reads
    the 1-D form's padding as +0.0, so no padded copy is made.  It takes
    rows of ``DS_CUMSUM_WIDTHS`` only: another width raises, as does a
    launch the card refuses.  On a CPU tensor it is the plain version
    (of the padded copy, for the 1-D form).  Any other device raises."""
    _check_prefix_operand(x, "ds_cumsum_axis1", 2 if width is None else 1)
    if width is not None and width < 1:
        raise ValueError(f"ds_cumsum_axis1 takes a positive width, got {width}")
    device = _build.operand_device("ds_cumsum_rows", x=x)
    if device.type == "cpu":
        return _ds_cumsum_axis1(x) if width is None else _ds_cumsum_blocks(x, width)
    n = x.numel()
    rows, cols = x.shape if width is None else (-(-n // width), width)
    if cols not in DS_CUMSUM_WIDTHS:
        raise ValueError(
            f"ds_cumsum_axis1 on the card takes rows of {DS_CUMSUM_WIDTHS}, got {cols}"
        )
    hi, lo = x.new_empty((rows, cols)), x.new_empty((rows, cols))
    if rows:
        _build.launch(
            "ds_cumsum_rows", device, x.data_ptr(), hi.data_ptr(), lo.data_ptr(), rows, cols, n
        )
        ds_cumsum_axis1.launches += 1
    return hi, lo


#: Kernel launches in this process (the plain version does not count).
ds_cumsum_axis1.launches = 0  # type: ignore[attr-defined]


def _rowsum_tail(
    wh: torch.Tensor,
    wl: torch.Tensor,
    hi_in: torch.Tensor,
    lo_in: torch.Tensor,
    row_ptr: torch.Tensor,
) -> torch.Tensor:
    """``rowsum_sorted``'s tail: the inclusive prefix before every row
    pointer, from the block-local prefix lanes ``(wh, wl)`` and the scan
    ``(hi_in, lo_in)`` of the block totals (four lookups and one
    double-single add), then hi/lo-separate differencing (the hi
    cancellation stays exact)."""
    n_blocks, b = wh.shape
    # Exclusive block prefixes.
    zero = wh.new_zeros(1)
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


def _check_tail_operands(wh, wl, hi_in, lo_in, row_ptr) -> None:
    for name, a, dim, dtype in (
        ("wh", wh, 2, torch.float32),
        ("wl", wl, 2, torch.float32),
        ("hi_in", hi_in, 1, torch.float32),
        ("lo_in", lo_in, 1, torch.float32),
        ("row_ptr", row_ptr, 1, torch.int32),
    ):
        if a.dim() != dim:
            raise ValueError(f"rowsum_tail: {name} must be {dim}-D, got shape {tuple(a.shape)}")
        if a.dtype != dtype:
            raise TypeError(f"rowsum_tail: {name} must be {dtype}, got {a.dtype}")
    if wl.shape != wh.shape:
        raise ValueError(f"rowsum_tail: wl has shape {tuple(wl.shape)}, wh {tuple(wh.shape)}")
    for name, a in (("hi_in", hi_in), ("lo_in", lo_in)):
        if a.shape[0] != wh.shape[0]:
            raise ValueError(f"rowsum_tail: {name} must hold {wh.shape[0]} block totals")
    if row_ptr.shape[0] < 1:
        raise ValueError("rowsum_tail: row_ptr needs at least one pointer")


def rowsum_tail(
    wh: torch.Tensor,
    wl: torch.Tensor,
    hi_in: torch.Tensor,
    lo_in: torch.Tensor,
    row_ptr: torch.Tensor,
) -> torch.Tensor:
    """``_rowsum_tail`` of float32 lanes ``(wh, wl)`` (n_blocks, B),
    float32 block-total scans ``(hi_in, lo_in)`` (n_blocks,) and int32
    ``row_ptr`` (n + 1,): the n row sums.

    On CUDA tensors this launches ``csrc/rowsum_tail.cu`` (four pointers
    a thread) and adds one to ``rowsum_tail.launches``; a launch the card
    refuses raises.  On CPU tensors it is the plain version.  Mixed or
    other devices raise."""
    _check_tail_operands(wh, wl, hi_in, lo_in, row_ptr)
    device = _build.operand_device(
        "rowsum_tail", wh=wh, wl=wl, hi_in=hi_in, lo_in=lo_in, row_ptr=row_ptr
    )
    if device.type == "cpu":
        return _rowsum_tail(wh, wl, hi_in, lo_in, row_ptr)
    n_blocks, b = wh.shape
    n = row_ptr.shape[0] - 1
    out = wh.new_empty(n)
    if n:
        _build.launch(
            "rowsum_tail", device, wh.data_ptr(), wl.data_ptr(), hi_in.data_ptr(),
            lo_in.data_ptr(), row_ptr.data_ptr(), out.data_ptr(), n_blocks, b, n,
        )
        rowsum_tail.launches += 1
    return out


#: Kernel launches in this process (the plain version does not count).
rowsum_tail.launches = 0  # type: ignore[attr-defined]


def rowsum_sorted(contrib: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """Per-row sums of dst-sorted contributions,
    ``out[j] = sum(contrib[row_ptr[j] : row_ptr[j+1]])``, through the
    reference's hierarchical double-single prefix: block-local
    Hillis-Steele over zero-padded 2048-blocks (``ds_cumsum_axis1``), a
    TwoSum scan over block totals (``block_total_scan``), then the
    pointer lookups and hi/lo-separate differencing (``rowsum_tail``)."""
    return _rowsum_sorted(
        ds_cumsum_axis1(contrib, _ROWSUM_BLOCK), row_ptr, block_total_scan, rowsum_tail
    )


def rowsum_sorted_plain(contrib: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """``rowsum_sorted`` through the three passes' plain versions on any
    device, the padding into blocks a real copy: the route the kernels'
    route is held against on the card."""
    return _rowsum_sorted(
        _ds_cumsum_blocks(contrib, _ROWSUM_BLOCK), row_ptr, _block_total_scan, _rowsum_tail
    )


def gathered_rowsum(
    w: torch.Tensor, t: torch.Tensor, src: torch.Tensor, row_ptr: torch.Tensor
) -> torch.Tensor:
    """``rowsum_sorted(w · t[src], row_ptr)``, the CSR step's ``Cᵀt``,
    with the edge product folded into the block-local prefix
    (``gather_ds_cumsum``), then ``block_total_scan`` and ``rowsum_tail``
    on its lanes: the products never exist as a tensor."""
    return _rowsum_sorted(gather_ds_cumsum(w, t, src), row_ptr, block_total_scan, rowsum_tail)


def _rowsum_sorted(lanes, row_ptr, scan, tail) -> torch.Tensor:
    """The row sums from the block-local prefix lanes ``(wh, wl)`` of the
    contributions in 2048-blocks: the block totals' scan, then the
    pointer tail."""
    wh, wl = lanes
    hi_in, lo_in = scan(wh, wl)
    return tail(wh, wl, hi_in, lo_in, row_ptr)


def _gather_multiply(w: torch.Tensor, t: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The edge product ``w * t[src]``, every index clamped to
    ``[0, len(t) - 1]`` as the kernels clamp it: the plain version of the
    product ``gather_ds_cumsum`` folds into its prefix.  For an index at
    or past the table's end this is the reference's ``t[src]``; a
    negative index differs, since JAX wraps it first (-1 reads
    ``t[n - 1]`` there and ``t[0]`` here)."""
    return w * t.index_select(0, src.clamp(0, t.shape[0] - 1))


def _check_edge_operands(name: str, w: torch.Tensor, t: torch.Tensor, src: torch.Tensor) -> None:
    """Raise unless ``w`` and ``t`` are 1-D float32, ``src`` 1-D int32 of
    ``w``'s shape, and the table is non-empty where there are edges."""
    for arg, a, dtype in (("w", w, torch.float32), ("t", t, torch.float32),
                          ("src", src, torch.int32)):
        if a.dim() != 1:
            raise ValueError(f"{name}: {arg} must be 1-D, got shape {tuple(a.shape)}")
        if a.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {a.dtype}")
    if src.shape != w.shape:
        raise ValueError(f"{name}: src has shape {tuple(src.shape)}, w {tuple(w.shape)}")
    if w.numel() and not t.numel():
        raise ValueError(f"{name}: edges need a non-empty table")


def _gather_ds_cumsum(
    w: torch.Tensor, t: torch.Tensor, src: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``gather_ds_cumsum``: the block prefix of the
    zero-padded edge products."""
    return _ds_cumsum_blocks(_gather_multiply(w, t, src), _ROWSUM_BLOCK)


def gather_ds_cumsum(
    w: torch.Tensor, t: torch.Tensor, src: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``_ds_cumsum_axis1`` of the edge products ``w[e] * t[src[e]]`` in
    ``rowsum_sorted``'s 2048-edge rows, the last row padded with +0.0:
    the lanes ``(wh, wl)``, each ``(ceil(E / 2048), 2048)``.  ``w`` and
    ``t`` are contiguous 1-D float32, ``src`` int32, one entry an edge; a
    gathered index is clamped to the table (``_gather_multiply``).

    On CUDA tensors this launches ``csrc/gather_ds_cumsum.cu`` (one block
    a row: the gathers, one IEEE multiply an edge and K5's row scan, so
    bit-equal to the plain version) and adds one to
    ``gather_ds_cumsum.launches``; ``w`` and ``src`` must be 16-byte
    aligned (a misaligned slice raises here; the steps and converges
    copy it once, ``_aligned``), and a launch the card refuses
    raises.  On CPU tensors it is the plain version.  Mixed or other
    devices raise."""
    _check_edge_operands("gather_ds_cumsum", w, t, src)
    # 16-byte loads of the streams; the table is read 4 bytes at a time.
    device = _build.operand_device("gather_ds_cumsum", w=w, src=src)
    _build.operand_device("gather_ds_cumsum", align=4, w=w, t=t)
    if device.type == "cpu":
        return _gather_ds_cumsum(w, t, src)
    e = w.numel()
    rows = -(-e // _ROWSUM_BLOCK)
    hi, lo = w.new_empty((rows, _ROWSUM_BLOCK)), w.new_empty((rows, _ROWSUM_BLOCK))
    if rows:
        _build.launch(
            "gather_ds_cumsum", device, w.data_ptr(), t.data_ptr(), src.data_ptr(),
            hi.data_ptr(), lo.data_ptr(), e, t.numel(),
        )
        gather_ds_cumsum.launches += 1
    return hi, lo


#: Kernel launches in this process (the plain version does not count).
gather_ds_cumsum.launches = 0  # type: ignore[attr-defined]


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it where it starts off a 16-byte boundary, as
    a slice at an odd element offset does: ``gather_ds_cumsum`` loads
    ``w`` and ``src`` 16 bytes at a time.  The CSR step takes the copy a
    call, the converges once before their loop."""
    return x.clone() if x.data_ptr() % 16 else x


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
    ``cᵀt[j] = rowsum_sorted(w · t[src], row_ptr)`` (``gathered_rowsum``).
    ``w`` and ``src`` may be slices at any element offset (``_aligned``)."""
    ct = gathered_rowsum(_aligned(w), t, _aligned(src), row_ptr)
    return damp(ct, t, p, dangling, alpha)


def dst_segments(
    src: torch.Tensor,
    dst: torch.Tensor,
    w: torch.Tensor,
    *,
    n: int,
    sorted_by_dst: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(src, w, row_ptr)`` of the COO edge list in dst order, on the
    edges' device: ``row_ptr[j] .. row_ptr[j+1]`` is the range of the
    edges whose destination is j (int32, ``n + 1`` pointers), the input
    to ``power_step_csr``.

    With ``sorted_by_dst`` the edges are taken in the given order once
    one pass over ``dst`` (a host read) finds it non-decreasing; where
    it is not, as when zero-weight padding edges carry any ``dst``, and
    with ``sorted_by_dst=False``, they are put in order by one stable
    sort of ``dst`` (the order ``TrustGraph.sorted_by_dst`` gives).  A
    ``dst`` outside ``[0, n)`` falls outside every segment and is
    dropped, as ``segment_sum`` drops it."""
    if sorted_by_dst and bool(torch.all(dst[1:] >= dst[:-1])):
        dst_sorted = dst
    else:
        dst_sorted, order = torch.sort(dst, stable=True)
        src, w = src.index_select(0, order), w.index_select(0, order)
    bounds = torch.arange(n + 1, dtype=dst.dtype, device=dst.device)
    row_ptr = torch.searchsorted(dst_sorted, bounds, out_int32=True)
    return src, w, row_ptr


def power_step_coo(
    src: torch.Tensor,
    dst: torch.Tensor,
    w: torch.Tensor,
    t: torch.Tensor,
    p: torch.Tensor,
    dangling: torch.Tensor,
    alpha: torch.Tensor | float,
    *,
    n: int,
    sorted_by_dst: bool = True,
) -> torch.Tensor:
    """One damped transpose-SpMV step over a COO edge list (edge arrays
    may be zero-padded: pad edges with w=0): the edges' dst segments
    (``dst_segments``), then the CSR step over them, so ``Cᵀt`` is a
    sorted double-single segmented sum and no scatter runs."""
    src, w, row_ptr = dst_segments(src, dst, w, n=n, sorted_by_dst=sorted_by_dst)
    return power_step_csr(src, row_ptr, w, t, p, dangling, alpha)


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
    scalar on ``t0``'s device, as the reference stages it.  A ``w`` or
    ``src`` off a 16-byte boundary is copied once, before the loop."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=t0.device)
    w, src = _aligned(w), _aligned(src)
    return run_power_iteration(
        lambda t: power_step_csr(src, row_ptr, w, t, p, dangling, alpha),
        t0,
        tol=tol,
        max_iter=max_iter,
        record_residuals=record_residuals,
    )


def converge_sparse(
    src: torch.Tensor,
    dst: torch.Tensor,
    w: torch.Tensor,
    t0: torch.Tensor,
    p: torch.Tensor,
    dangling: torch.Tensor,
    *,
    n: int,
    alpha: torch.Tensor | float = 0.1,
    tol: float = 1e-6,
    max_iter: int = 50,
    sorted_by_dst: bool = True,
    record_residuals: bool = False,
) -> tuple:
    """COO convergence; returns ``(t, iterations, residual[, history])``
    as ``converge_csr``.  The dst segments are derived once, before the
    loop (``dst_segments``), and every step is then ``power_step_coo``'s
    CSR step over them."""
    src, w, row_ptr = dst_segments(src, dst, w, n=n, sorted_by_dst=sorted_by_dst)
    return converge_csr(
        src, row_ptr, w, t0, p, dangling,
        alpha=alpha, tol=tol, max_iter=max_iter, record_residuals=record_residuals,
    )
