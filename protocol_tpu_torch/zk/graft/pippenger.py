"""Pippenger MSM over BN254 G1 on the card (the port of
``protocol_tpu/zk/graft/pippenger.py``).

Windows: c = 8 fixed windows, byte ``w`` of the 32-byte little-endian
scalar is the window-``w`` digit, and all 32 windows go through every
kernel together.  Points live in a :class:`PointCache` on the graft
device: Jacobian over Fq in the Montgomery domain, ``Z == 0`` the
point at infinity, padded to a power of two with copies of point 0, so
every MSM over a prefix of the SRS slices it and converts nothing.

One MSM on the card is two kernels and the host's last mile:

- K12 (``ops/csrc/zk_msm_window.cu``, :func:`msm_window`): per window,
  a stable counting sort of the digits read straight from the scalars,
  over a cluster of blocks: the order ``perm`` (the reference's
  ``jnp.argsort`` order) and the sorted digits ``ds``, (32, m) int32 each;
- K13 (``ops/csrc/zk_msm_bucket.cu``, :func:`msm_bucket`, two
  launches): every (window, digit) bucket, the points read as
  ``points[perm]`` and summed with mixed adds over pieces of
  ``2^PIECE_LOG`` sorted lanes, a bucket within one piece finished
  there; then a join of each bucket's pieces by complete adds (by one
  thread, or by a block where a bucket covers many pieces), empty
  buckets zeroed, into a (32, 256, 3, 4) word grid out of the
  Montgomery domain;
- ``_finish`` on the host: 255 bucket-weighted running sums a window and
  the Horner window combine in exact Python-int Jacobian arithmetic,
  ending in the MSM's one inversion, as in the reference.

The plain versions (:func:`_window_plain`, :func:`_buckets_plain`, on
16-bit limb tensors) follow the reference's two levels: a stable sort,
a block-local sequential fold over 64-lane blocks, the segmented
Hillis–Steele carry over the block tails (``ops/segments.py``), two
scatters and one combine, so at one block they give the reference's
Jacobian buckets limb for limb.  Over several blocks the port starts a
carry segment also where a block's first digit differs from the block
before it: the reference does not, and there its bucket is wrong
(ROADMAP §C).  K12's sort is stable, so its ``perm`` equals the plain
version's bit for bit; K13 adds a bucket's points in pieces of
``2^PIECE_LOG`` lanes and joins them, another grouping than the 64-lane
fold, so its buckets equal the plain ones as points, not as Jacobian
limbs; the MSM's result is exact either way.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ...crypto.field import MODULUS as FR_MOD
from ...ops import _build
from ...ops.segments import block_boundary_flags, run_end_mask, segmented_carry_scan
from ...utils.limbs import to_limbs_fast
from ..bn254 import G1
from ..rns import FQ_MODULUS as Q
from . import _bump_phase, zk_device
from .field import FQ, NLIMBS, from16, is_zero16, tensor_to_u64, to16, u64_to_limbs, u64_to_tensor

WINDOWS = 32
C_BITS = 8
N_BUCKETS = 1 << C_BITS
#: The plain version's fold block (the reference's B).
BLOCK = 64
#: log2 of K13's piece, the sorted lanes one thread adds in a row
#: (``PIECE_LOG`` of ``ops/csrc/zk_msm_bucket.cu``): sizes its scratch.
PIECE_LOG = 4


# ---------------------------------------------------------------------------
# The plain group law (Jacobian over Montgomery Fq), (..., 3, 16) limb
# tensors.  The reference's formulas, its multiplies batched by level.
# ---------------------------------------------------------------------------


def _mm(*pairs):
    """Montgomery products of equally shaped (a, b) limb pairs, in one call."""
    a = torch.stack([p[0] for p in pairs])
    b = torch.stack([p[1] for p in pairs])
    return FQ.mont_mul16(a, b).unbind(0)


def _jdbl(p):
    """dbl-2009-l, 7 muls; Z==0 stays Z==0 (infinity is absorbing)."""
    x, y, z = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    a, b = _mm((x, x), (y, y))
    t = FQ.add16(x, b)
    c, tt = _mm((b, b), (t, t))
    d = FQ.sub16(FQ.sub16(tt, a), c)
    d = FQ.add16(d, d)
    e = FQ.add16(FQ.add16(a, a), a)
    f, z3 = _mm((e, e), (y, z))
    x3 = FQ.sub16(f, FQ.add16(d, d))
    c8 = FQ.add16(c, c)
    c8 = FQ.add16(c8, c8)
    c8 = FQ.add16(c8, c8)
    (ed,) = _mm((e, FQ.sub16(d, x3)))
    y3 = FQ.sub16(ed, c8)
    z3 = FQ.add16(z3, z3)
    return torch.stack([x3, y3, z3], dim=-2)


def _madd(p, q):
    """The kernel's mixed add (madd-2007-bl, 11 muls) of ``p`` and a
    point ``q`` of the point cache (Z the Montgomery one, or 0 for the
    identity, which leaves ``p``): an identity ``p`` gives ``q``;
    ``P == -Q`` gives ``Z3 = 0``; ``P == Q`` takes the doubling."""
    x1, y1, z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    x2, y2, z2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]
    z1z = is_zero16(z1)
    z2z = is_zero16(z2)
    (z1z1,) = _mm((z1, z1))
    u2, z1c = _mm((x2, z1z1), (z1, z1z1))
    (s2,) = _mm((y2, z1c))
    h = FQ.sub16(u2, x1)
    sy = FQ.sub16(s2, y1)
    (hh,) = _mm((h, h))
    i = FQ.add16(hh, hh)
    i = FQ.add16(i, i)
    r = FQ.add16(sy, sy)
    j, v, r2 = _mm((h, i), (x1, i), (r, r))
    x3 = FQ.sub16(FQ.sub16(r2, j), FQ.add16(v, v))
    zh = FQ.add16(z1, h)
    ry, yj, zh2 = _mm((r, FQ.sub16(v, x3)), (y1, j), (zh, zh))
    y3 = FQ.sub16(ry, FQ.add16(yj, yj))
    z3 = FQ.sub16(FQ.sub16(zh2, z1z1), hh)
    gen = torch.stack([x3, y3, z3], dim=-2)
    need_dbl = is_zero16(h) & is_zero16(sy) & ~z1z & ~z2z
    if bool(need_dbl.any()):
        gen = torch.where(need_dbl[..., None, None], _jdbl(p), gen)
    out = torch.where(z2z[..., None, None], p, gen)
    return torch.where(z1z[..., None, None], q, out)


def _jadd(p, q):
    """Complete Jacobian add (add-2007-bl shape, 16 muls): ``P == -Q``
    gives ``Z3 = 0``; ``P == Q`` (H == 0 and R == 0, neither the
    identity) takes the doubling, computed only when a lane needs it."""
    x1, y1, z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    x2, y2, z2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]
    z1z = is_zero16(z1)
    z2z = is_zero16(z2)
    z1z1, z2z2 = _mm((z1, z1), (z2, z2))
    u1, u2, z2c, z1c = _mm((x1, z2z2), (x2, z1z1), (z2, z2z2), (z1, z1z1))
    s1, s2 = _mm((y1, z2c), (y2, z1c))
    h = FQ.sub16(u2, u1)
    r = FQ.sub16(s2, s1)
    hh, r2, z1z2 = _mm((h, h), (r, r), (z1, z2))
    hhh, v, z3 = _mm((h, hh), (u1, hh), (z1z2, h))
    x3 = FQ.sub16(FQ.sub16(r2, hhh), FQ.add16(v, v))
    rv, shhh = _mm((r, FQ.sub16(v, x3)), (s1, hhh))
    y3 = FQ.sub16(rv, shhh)
    gen = torch.stack([x3, y3, z3], dim=-2)
    need_dbl = is_zero16(h) & is_zero16(r) & ~z1z & ~z2z
    if bool(need_dbl.any()):
        gen = torch.where(need_dbl[..., None, None], _jdbl(p), gen)
    out = torch.where(z2z[..., None, None], p, gen)
    return torch.where(z1z[..., None, None], q, out)


# ---------------------------------------------------------------------------
# K12: the per-window digit sort
# ---------------------------------------------------------------------------


def _digits(scalars: torch.Tensor) -> torch.Tensor:
    """(m, 4) int64 scalar words -> (32, m) int64 window digits (byte w of each scalar)."""
    m = scalars.shape[0]
    return scalars.contiguous().view(torch.uint8).reshape(m, 32).t().to(torch.int64)


def _window_plain(scalars: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    ds, perm = torch.sort(_digits(scalars), dim=-1, stable=True)
    return ds.to(torch.int32), perm.to(torch.int32)


def msm_window(scalars: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each window's digits sorted: ``(ds, perm)``, (32, m) int32, with
    ``digits[w, perm[w]] == ds[w]``, from (m, 4) int64 scalar words.

    The order is stable: within one digit the lanes keep their order,
    so ``perm`` is the reference's ``jnp.argsort`` order and the kernel
    equals the plain version bit for bit.  On CUDA tensors this launches
    ``ops/csrc/zk_msm_window.cu`` (K12, a counting sort over a cluster
    of blocks a window) once and adds one to ``msm_window.launches``; a
    launch the card refuses raises.  On CPU tensors it is the plain
    version (a stable sort).  Mixed or other devices raise."""
    if scalars.dtype != torch.int64 or scalars.dim() != 2 or scalars.shape[1] != 4:
        raise ValueError("msm_window: scalars must be an (m, 4) int64 word tensor")
    m = scalars.shape[0]
    if m >= 1 << 31:
        raise ValueError(f"msm_window: {m} scalars do not fit int32 indices")
    device = _build.operand_device("zk_msm_window", scalars=scalars)
    if device.type == "cpu":
        return _window_plain(scalars)
    ds = torch.empty((WINDOWS, m), dtype=torch.int32, device=device)
    perm = torch.empty_like(ds)
    if m:
        _build.launch("zk_msm_window", device, scalars.data_ptr(), ds.data_ptr(), perm.data_ptr(), m)
        msm_window.launches += 1
    return ds, perm


#: Kernel launches in this process (the plain version does not count).
msm_window.launches = 0  # type: ignore[attr-defined]


# ---------------------------------------------------------------------------
# K13: the bucket sums
# ---------------------------------------------------------------------------


def _buckets_plain(ds: torch.Tensor, perm: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """The reference's ``fold``, ``carry`` and ``bucket`` on 16-bit
    limbs: (32, 256, 3, 4) int64 words of canonical Jacobian Fq."""
    ds = ds.to(torch.int64)
    w, m = ds.shape
    pts = to16(points)[perm.to(torch.int64)]  # (w, m, 3, 16)
    blk = min(BLOCK, m)
    nb = m // blk
    dsb = ds.reshape(w, nb, blk)
    cols = pts.reshape(w, nb, blk, 3, NLIMBS)
    # Level 1: block-local sequential fold.
    run = cols[:, :, 0]
    local = [run]
    for j in range(1, blk):
        same = dsb[:, :, j] == dsb[:, :, j - 1]
        col = cols[:, :, j]
        run = torch.where(same[..., None, None], _jadd(run, col), col)
        local.append(run)
    local = torch.stack(local, dim=2).reshape(w, m, 3, NLIMBS)
    # Level 2: segmented carry over the block tails.  A block starts a
    # segment where it holds a run boundary, and also where its first
    # digit is not the last digit of the block before (the reference
    # flags only the first).
    flags = block_boundary_flags(dsb) | (dsb[..., 0] != torch.roll(dsb[..., -1], 1, dims=-1))
    c = segmented_carry_scan(run, flags, _jadd, axis=1)
    # Run-end extraction: two unique scatters, one combine.
    ends = run_end_mask(ds)
    lane = torch.arange(m, device=ds.device)
    head = dsb[:, :, 0].repeat_interleave(blk, dim=-1)
    tail_prev = torch.roll(dsb[:, :, -1], 1, dims=-1).repeat_interleave(blk, dim=-1)
    in_head_run = (ds == head) & (lane // blk > 0) & (tail_prev == ds)
    c_prev = torch.roll(c, 1, dims=1).repeat_interleave(blk, dim=1)
    rows = torch.arange(w, device=ds.device)[:, None]
    park = N_BUCKETS + lane
    b_local = local.new_zeros((w, N_BUCKETS + m, 3, NLIMBS))
    b_local[rows, torch.where(ends, ds, park)] = local
    b_carry = local.new_zeros((w, N_BUCKETS + m, 3, NLIMBS))
    b_carry[rows, torch.where(ends & in_head_run, ds, park)] = c_prev
    # Zeros are Z == 0, the identity: empty buckets and parked lanes vanish.
    out = _jadd(b_local[:, :N_BUCKETS], b_carry[:, :N_BUCKETS])
    return from16(FQ.mont_mul16(out, torch.tensor([1] + [0] * 15, device=ds.device)))


def msm_bucket(ds: torch.Tensor, perm: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """The (32, 256, 3, 4) int64 word grid of bucket sums, canonical
    Jacobian Fq out of the Montgomery domain (Z == 0 an empty bucket),
    from ``msm_window``'s ``(ds, perm)`` over ``points`` (m, 3, 4), the
    point cache's first m rows.

    On CUDA tensors this launches ``ops/csrc/zk_msm_bucket.cu`` (K13:
    the piece sums, then the join; bucket 0, which the host reduction
    skips, comes out empty, as every empty bucket, all zeros) and adds
    its two launches to ``msm_bucket.launches``; a launch the card
    refuses raises.  On CPU tensors it is the plain version (bucket 0
    summed, as the reference's).  Mixed or other devices raise."""
    if ds.shape != perm.shape or ds.dim() != 2 or ds.shape[0] != WINDOWS:
        raise ValueError(f"msm_bucket: ds {tuple(ds.shape)} and perm {tuple(perm.shape)} must be (32, m)")
    if ds.dtype != torch.int32 or perm.dtype != torch.int32 or points.dtype != torch.int64:
        raise ValueError("msm_bucket: ds and perm must be int32, points int64")
    m = ds.shape[1]
    if m < 1 or m & (m - 1) or tuple(points.shape) != (m, 3, 4):
        raise ValueError(f"msm_bucket: m = {m} must be a power of two and points (m, 3, 4), "
                         f"got {tuple(points.shape)}")
    device = _build.operand_device("zk_msm_bucket", ds=ds, perm=perm, points=points)
    if device.type == "cpu":
        return _buckets_plain(ds, perm, points)
    plog = min(PIECE_LOG, m.bit_length() - 1)
    head = torch.empty((WINDOWS, m >> plog, 3, 4), dtype=torch.int64, device=device)
    tail = torch.empty_like(head)
    out = torch.empty((WINDOWS, N_BUCKETS, 3, 4), dtype=torch.int64, device=device)
    _build.launch(
        "zk_msm_bucket", device, ds.data_ptr(), perm.data_ptr(), points.data_ptr(),
        head.data_ptr(), tail.data_ptr(), out.data_ptr(), m,
    )
    msm_bucket.launches += 2
    return out


#: Kernel launches in this process (the plain version does not count).
msm_bucket.launches = 0  # type: ignore[attr-defined]


# ---------------------------------------------------------------------------
# Point preprocessing (once per SRS and device)
# ---------------------------------------------------------------------------


def _points_to_u64(points) -> np.ndarray:
    if isinstance(points, np.ndarray):
        return np.ascontiguousarray(points, dtype=np.uint64)
    buf = b"".join(p.x.to_bytes(32, "little") + p.y.to_bytes(32, "little") for p in points)
    return np.frombuffer(buf, dtype=np.uint64).reshape(-1, 8).copy()


class PointCache:
    """Montgomery-Jacobian points on one device, padded to a power of
    two so every MSM over a prefix of the SRS slices them (never
    re-converted): ``points`` is (padded, 3, 4) int64 words."""

    __slots__ = ("n", "padded", "points", "device")

    def __init__(self, n: int, padded: int, points: torch.Tensor):
        self.n = n
        self.padded = padded
        self.points = points
        self.device = points.device

    @classmethod
    def build(cls, points, device=None) -> "PointCache":
        """From affine points (``G1``s or (n, 8) u64 words), on ``device``
        (default: the graft device, ``zk_device()``): X and Y into the
        Montgomery domain (two K10 launches on the card), Z the
        Montgomery one, or 0 for the identity (0, 0)."""
        device = zk_device() if device is None else torch.device(device)
        raw = _points_to_u64(points)
        n = raw.shape[0]
        if n == 0:
            raise ValueError("empty point set")
        padded = 1 << max(0, (n - 1).bit_length())
        if padded > n:
            raw = np.concatenate([raw, np.repeat(raw[:1], padded - n, axis=0)])
        ident = torch.from_numpy(~raw.any(axis=1)).to(device)
        xm = FQ.to_mont(u64_to_tensor(raw[:, :4], device))
        ym = FQ.to_mont(u64_to_tensor(raw[:, 4:], device))
        # A masked fill, not ``one[ident] = 0``: an index through a boolean
        # mask counts its lanes on the host, a sync on the card.
        one = FQ.const(FQ.r, device).expand(padded, 4).masked_fill(ident[:, None], 0)
        return cls(n, padded, torch.stack([xm, ym, one], dim=1).contiguous())


# ---------------------------------------------------------------------------
# Host last mile: exact Python-int Jacobian bucket reduction
# ---------------------------------------------------------------------------


def _hdbl(p):
    if p is None:
        return None
    x, y, z = p
    a = x * x % Q
    b = y * y % Q
    c = b * b % Q
    d = 2 * ((x + b) * (x + b) - a - c) % Q
    e = 3 * a % Q
    f = e * e % Q
    x3 = (f - 2 * d) % Q
    y3 = (e * (d - x3) - 8 * c) % Q
    z3 = 2 * y * z % Q
    return (x3, y3, z3)


def _hadd(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % Q
    z2z2 = z2 * z2 % Q
    u1 = x1 * z2z2 % Q
    u2 = x2 * z1z1 % Q
    s1 = y1 * z2 * z2z2 % Q
    s2 = y2 * z1 * z1z1 % Q
    if u1 == u2:
        if s1 == s2:
            return _hdbl(p)
        return None
    h = (u2 - u1) % Q
    r = (s2 - s1) % Q
    hh = h * h % Q
    hhh = h * hh % Q
    v = u1 * hh % Q
    x3 = (r * r - hhh - 2 * v) % Q
    y3 = (r * (v - x3) - s1 * hhh) % Q
    z3 = z1 * z2 % Q * h % Q
    return (x3, y3, z3)


def _hmul(p, k):
    acc = None
    while k:
        if k & 1:
            acc = _hadd(acc, p)
        p = _hdbl(p)
        k >>= 1
    return acc


def _finish(buckets: np.ndarray) -> G1:
    """(32, 256, 3, 16) canonical Fq limb buckets -> affine G1.

    Per window a descending running sum (empty-gap runs collapsed into
    one scalar multiple) then Horner across windows; one inversion."""
    from .field import limbs_to_ints

    zmask = buckets[:, :, 2, :].any(axis=-1)
    ws, ds = np.nonzero(zmask)
    vals = {}
    if len(ws):
        flat = buckets[ws, ds].reshape(len(ws), 3 * NLIMBS)
        ints = limbs_to_ints(flat.reshape(-1, NLIMBS))
        for i, (w, d) in enumerate(zip(ws, ds)):
            vals[(int(w), int(d))] = tuple(ints[3 * i : 3 * i + 3])

    total = None
    for w in reversed(range(WINDOWS)):
        if total is not None:
            for _ in range(C_BITS):
                total = _hdbl(total)
        s = None
        acc = None
        gap = 0
        for d in range(N_BUCKETS - 1, 0, -1):
            b = vals.get((w, d))
            if b is None:
                if s is not None:
                    gap += 1
                continue
            if gap:
                acc = _hadd(acc, _hmul(s, gap))
                gap = 0
            s = _hadd(s, b)
            acc = _hadd(acc, s)
        if gap:
            acc = _hadd(acc, _hmul(s, gap))
        total = _hadd(total, acc)

    if total is None or total[2] == 0:
        return G1(0, 0)
    x, y, z = total
    zinv = pow(z, Q - 2, Q)
    zi2 = zinv * zinv % Q
    return G1(x * zi2 % Q, y * zi2 % Q * zinv % Q)


_finish_lock = threading.Lock()
_finish_table = {"calls": 0, "seconds": 0.0}


def finish_stats() -> dict[str, float]:
    """Calls of the host last mile ``_finish`` and their seconds, this
    process (a part of the ``msm`` phase's seconds)."""
    with _finish_lock:
        return dict(_finish_table)


def reset_finish_stats() -> None:
    with _finish_lock:
        _finish_table.update(calls=0, seconds=0.0)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def msm_limbs(scalars: np.ndarray, cache: PointCache) -> G1:
    """MSM of (n, 4) canonical u64 scalar limbs against a point cache,
    on the cache's device.

    Scalars are zero-padded up to a power of two — digit-0 lanes never
    leave bucket 0, which the reduction skips, so padding is free."""
    t0 = time.perf_counter()
    n = int(scalars.shape[0])
    if n > cache.n:
        raise ValueError(f"msm length mismatch: {n} scalars vs {cache.n} points")
    if n == 0:
        return G1(0, 0)
    m = 1 << max(0, (n - 1).bit_length())
    arr = np.ascontiguousarray(scalars, dtype=np.uint64)
    if m > n:
        arr = np.concatenate([arr, np.zeros((m - n, 4), np.uint64)])
    ds, perm = msm_window(u64_to_tensor(arr, cache.device))
    buckets = tensor_to_u64(msm_bucket(ds, perm, cache.points[:m]))
    t1 = time.perf_counter()
    out = _finish(u64_to_limbs(buckets.reshape(-1, 4)).reshape(WINDOWS, N_BUCKETS, 3, NLIMBS))
    t2 = time.perf_counter()
    with _finish_lock:
        _finish_table["calls"] += 1
        _finish_table["seconds"] += t2 - t1
    _bump_phase("msm", t2 - t0)
    return out


def msm_limbs_batch(arrs, cache: PointCache):
    """The commit/open MSMs of one prove against one shared cache."""
    return [msm_limbs(a, cache) for a in arrs]


def msm(scalars, points) -> G1:
    """List-of-ints MSM (the ``kzg.msm`` dispatch target)."""
    if len(scalars) != len(points):
        raise ValueError(f"msm length mismatch: {len(scalars)} scalars vs {len(points)} points")
    if not scalars:
        return G1(0, 0)
    cache = PointCache.build(points)
    arr = to_limbs_fast([s % FR_MOD for s in scalars])
    return msm_limbs(arr, cache)


# ---------------------------------------------------------------------------
# Declared budgets (``analysis/budget.py``, kept next to the kernels).
# Launches: one K12 and one K13 call an MSM; K13's two launches carry the
# reference's scan (fold, carry: the piece sums) and bucket kernels (the
# join).  ``msm_limbs`` downloads the bucket grid once.  Memory, per lane
# of the analyzers' recipes: K12 ``msm_window(scalars)`` holds the (m, 4)
# int64 scalars (32 B) and writes ``ds`` and ``perm``, (32, m) int32 each
# (256 B); K13 ``msm_bucket(ds, perm, points)`` holds those and the
# (m, 3, 4) int64 points (352 B) and allocates ``head`` and ``tail``,
# (32, m / 2^PIECE_LOG, 3, 4) int64 each (384 B), and the (32, 256, 3, 4)
# grid (786,432 B at any m): the scan's budget holds the pieces, the
# bucket's the grid, and the one call is judged against their sum.
# ---------------------------------------------------------------------------

from ...analysis.budget import (  # noqa: E402
    CommBudget,
    MemBudget,
    ZkKernelBudget,
    declare_comm,
    declare_mem,
    declare_zk,
)

#: Bytes of K13's bucket grid, (32, 256, 3, 4) int64: ``msm_limbs``'s one download.
GRID_BYTES = WINDOWS * N_BUCKETS * 3 * 4 * 8


def _one_an_msm(n: int) -> int:
    return 1 if n else 0


def _k13_an_msm(n: int) -> int:
    return 2 if n else 0


declare_zk(
    ZkKernelBudget(
        kernel="zk-graft-msm-window",
        wrapper="msm_window",
        per_call={"msm_limbs": _one_an_msm},
        notes="the per-window stable counting sort, a cluster of blocks a window; "
              "the only random reads are K13's points[perm]",
    )
)
declare_zk(
    ZkKernelBudget(
        kernel="zk-graft-msm-scan",
        wrapper="msm_bucket",
        per_call={"msm_limbs": _k13_an_msm},
        notes="K13's piece launch: mixed adds over pieces of sorted lanes, whole buckets finished",
    )
)
declare_zk(
    ZkKernelBudget(
        kernel="zk-graft-msm-bucket",
        wrapper="msm_bucket",
        per_call={"msm_limbs": _k13_an_msm},
        host_copies={"msm_limbs": lambda n: [GRID_BYTES] if n else []},
        notes="K13's join launch: the pieces of each bucket added, empty buckets zeroed, from_mont",
    )
)

for _name, _what in (("zk-graft-msm-window", "sort"), ("zk-graft-msm-scan", "group fold"),
                     ("zk-graft-msm-bucket", "bucket join")):
    declare_comm(CommBudget(backend=_name, notes=f"single-device {_what}: no wire"))

declare_mem(
    MemBudget(
        backend="zk-graft-msm-window",
        resident_n=32.0,  # the (m, 4) int64 scalars
        resident_const=4096.0,
        transient_n=256.0,  # ds and perm, (32, m) int32 each
        transient_const=4096.0,
        notes="the sort's rounds live in shared memory; only its two outputs are allocated",
    )
)
declare_mem(
    MemBudget(
        backend="zk-graft-msm-scan",
        resident_n=352.0,  # ds and perm (256 B) and the (m, 3, 4) int64 points (96 B)
        resident_const=4096.0,
        transient_n=384.0,  # head and tail, (32, m / 16, 3, 4) int64 each
        transient_const=4096.0,
        notes="K13's piece partials, one head and one tail a piece of 16 lanes; judged with "
              "zk-graft-msm-bucket's budget against their one shared call",
    )
)
declare_mem(
    MemBudget(
        backend="zk-graft-msm-bucket",
        transient_const=float(GRID_BYTES),  # the (32, 256, 3, 4) int64 grid
        notes="the bucket grid at any m; its inputs are zk-graft-msm-scan's residents",
    )
)
