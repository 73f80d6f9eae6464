"""Iterative radix-2 NTT over Fr on the card (the port of
``protocol_tpu/zk/graft/ntt.py``).

Decimation-in-time Cooley–Tukey, all on the card in the kernel K11
(``ops/csrc/zk_ntt.cu``, through :func:`ntt_device`): ``ntt_limbs``
uploads the natural-order input, K11's first pass reads it at the
bit-reversed indices and runs the first ``log_tile(n)`` butterfly
stages in shared memory, a second pass runs the rest (``passes``: one
launch up to 2^8 points, two up to 2^24) and scales
the inverse by ``1/n`` in its stores; then the download.  The reference
bit-reverses on the host, runs a launch a stage and converts into and
out of the Montgomery domain; the port's data stays out of it, because
its Montgomery twiddles make each Montgomery product the plain one.
Twiddle plans are exact Python ints, computed once per ``(n, root)``
and kept on each device they are used on as one ``(n - 1, 4)`` tensor
(stage ``L``'s ``L/2`` twiddles from row ``L/2 - 1``).

The transform is bit-identical to ``plonk._py_ntt`` / native
``zk_ntt`` by construction: every butterfly is exact modular
arithmetic.  On the CPU (``zk_device() == cpu``) the same code runs the
kernel's plain version (:func:`_ntt_plain`, the same passes over the
reference's stage, :func:`_stage_plain`).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ...crypto.field import MODULUS as R
from ...ops import _build
from . import _bump_phase, zk_device
from .field import FR, from16, tensor_to_u64, to16, u64_to_tensor

_plan_lock = threading.Lock()
_twiddle_plans: dict[tuple[int, int], np.ndarray] = {}
_device_plans: dict[tuple[int, int, torch.device], torch.Tensor] = {}
_bitrev_cache: dict[int, np.ndarray] = {}
_ninv_cache: dict[int, int] = {}
#: The largest log2 tile K11 takes: 2^12 elements of 32 bytes, 128 KB
#: of shared memory a block.
MAX_LOG_TILE = 12


def _bitrev_perm(n: int) -> np.ndarray:
    """Index vector for the DIT input permutation (cached per n)."""
    perm = _bitrev_cache.get(n)
    if perm is None:
        bits = n.bit_length() - 1
        idx = np.arange(n, dtype=np.int64)
        rev = np.zeros(n, dtype=np.int64)
        for b in range(bits):
            rev |= ((idx >> b) & 1) << (bits - 1 - b)
        perm = rev
        _bitrev_cache[n] = perm
    return perm


def _twiddle_plan(n: int, root: int) -> np.ndarray:
    """Every stage's Montgomery twiddles ``w_len^k, k < L/2`` for
    ``L = 2, 4, ..., n``, concatenated: (n - 1, 4) u64 words, stage ``L``
    from row ``L/2 - 1`` (host ints once, then cached)."""
    key = (n, root)
    with _plan_lock:
        plan = _twiddle_plans.get(key)
    if plan is not None:
        return plan
    rows = []
    length = 2
    while length <= n:
        w_len = pow(root, n // length, R)
        half = length >> 1
        tws = [1] * half
        for k in range(1, half):
            tws[k] = tws[k - 1] * w_len % R
        rows.extend(FR.to_mont_int(w) for w in tws)
        length <<= 1
    buf = b"".join(v.to_bytes(32, "little") for v in rows)
    plan = np.frombuffer(buf, dtype=np.uint64).reshape(-1, 4).copy()
    with _plan_lock:
        _twiddle_plans[key] = plan
    return plan


def _device_plan(n: int, root: int, device: torch.device) -> torch.Tensor:
    key = (n, root, device)
    with _plan_lock:
        plan = _device_plans.get(key)
    if plan is None:
        plan = u64_to_tensor(_twiddle_plan(n, root), device)
        with _plan_lock:
            _device_plans[key] = plan
    return plan


def _stage_plain(x: torch.Tensor, tw: torch.Tensor, half: int) -> None:
    """The reference's stage on 16-bit limbs: groups of ``2 * half``,
    ``t = x_odd * w``, then ``(u + t, u - t)``; written back into ``x``."""
    n = x.shape[0]
    limbs = to16(x).reshape(n // (2 * half), 2 * half, 16)
    u = limbs[:, :half]
    t = FR.mont_mul16(limbs[:, half:], to16(tw)[None])
    out = torch.cat([FR.add16(u, t), FR.sub16(u, t)], dim=1)
    x.copy_(from16(out.reshape(n, 16)))


def needed_multiplies(n: int, inverse: bool) -> int:
    """The Montgomery multiplies an NTT of ``n`` points needs, whatever
    computes it: a twiddle product for every butterfly whose twiddle is
    not 1, ``(n / 2) log2 n - (n - 1)`` (each stage's ``k = 0``
    butterflies, so the whole first stage, multiply by 1), and the
    inverse's ``n`` products by ``1/n``."""
    return (n // 2) * (n.bit_length() - 1) - (n - 1) + (n if inverse else 0)


def log_tile(n: int) -> int:
    """log2 of the elements a block of K11 holds in shared memory for an
    NTT of ``n`` points, so of the stages a pass runs: the fastest of
    2^7 to 2^12 on an H100 at 2^14 (2^8) and at 2^17 points (2^9;
    ``bench/probe_graft_forms.py``); above 2^18 half the stages, so two
    passes up to 2^24 points."""
    log_n = n.bit_length() - 1
    return 8 if log_n <= 16 else min(MAX_LOG_TILE, max(9, (log_n + 1) // 2))


def pass_stages(n: int, tile: int | None = None) -> list[tuple[int, int]]:
    """The kernel's passes over an NTT of ``n`` points at log2 tile
    ``tile`` (default ``log_tile(n)``): ``(s0, q)``, the pass runs stages
    ``s0 + 1 .. s0 + q`` (halves ``2^s0 .. 2^(s0+q-1)``)."""
    tile = log_tile(n) if tile is None else tile
    log_n = n.bit_length() - 1
    out, s0 = [], 0
    while s0 < log_n:
        q = min(log_n - s0, tile)
        out.append((s0, q))
        s0 += q
    return out


def passes(n: int, tile: int | None = None) -> int:
    """Launches of K11 an NTT of ``n`` points: 1 up to ``2^tile``, 2 up
    to ``2^(2 tile)``."""
    return len(pass_stages(n, tile))


def _ninv(n: int) -> int:
    """Montgomery form of 1/n in Fr: the inverse transform's scale."""
    c = _ninv_cache.get(n)
    if c is None:
        c = _ninv_cache[n] = FR.to_mont_int(pow(n, R - 2, R))
    return c


def _ntt_plain(x: torch.Tensor, plan: torch.Tensor, inverse: bool, tile: int | None = None,
               max_passes: int | None = None) -> torch.Tensor:
    """The kernel's passes on 16-bit limbs: the bit-reverse by index, the
    plain stages of each pass in turn, and in the last pass of the whole
    NTT the inverse's scale; after ``max_passes`` passes where given.  The
    data stays out of the Montgomery domain (the twiddles are Montgomery
    forms, so a Montgomery product by one is the plain product)."""
    n = x.shape[0]
    y = x[torch.from_numpy(_bitrev_perm(n)).to(x.device)]
    stages = pass_stages(n, tile)
    for s0, q in stages[:max_passes]:
        for j in range(q):
            half = 1 << (s0 + j)
            _stage_plain(y, plan[half - 1 : 2 * half - 1], half)
    if inverse and (max_passes is None or max_passes >= len(stages)):
        y = from16(FR.mont_mul16(to16(y), to16(FR.const(_ninv(n), x.device))))
    return y


def ntt_device(x: torch.Tensor, plan: torch.Tensor, inverse: bool, *, tile: int | None = None,
               max_passes: int | None = None) -> torch.Tensor:
    """The NTT of ``x`` (n, 4) int64 words of canonical Fr in natural
    order, with ``plan`` the (n - 1, 4) Montgomery twiddles of its root
    (``_device_plan``), scaled by 1/n where ``inverse``: a new (n, 4)
    tensor, canonical, in natural order.  ``tile``: log2 of a block's
    elements (default ``log_tile(n)``); ``max_passes`` stops after that
    many passes, without the scale (a check of the first pass).

    On CUDA tensors this launches ``ops/csrc/zk_ntt.cu`` (K11,
    ``passes(n)`` launches: the first ``tile`` stages on tiles read at
    the bit-reversed indices, then the rest) and adds its launches to
    ``ntt_device.launches``; a launch the card refuses raises.  On CPU
    tensors it is the plain version.  Mixed or other devices raise."""
    n = x.shape[0]
    if x.dtype != torch.int64 or plan.dtype != torch.int64 or x.dim() != 2 or x.shape[1] != 4:
        raise ValueError("ntt_device: x must be an (n, 4) int64 word tensor")
    if n < 2 or n & (n - 1) or tuple(plan.shape) != (n - 1, 4):
        raise ValueError(f"ntt_device: n = {n} and plan {tuple(plan.shape)} do not fit")
    tile = log_tile(n) if tile is None else tile
    if not 1 <= tile <= MAX_LOG_TILE:
        raise ValueError(f"ntt_device: tile {tile} not in 1..{MAX_LOG_TILE}")
    device = _build.operand_device("zk_ntt", x=x, plan=plan)
    if device.type == "cpu":
        return _ntt_plain(x, plan, inverse, tile, max_passes)
    scale = FR.const(_ninv(n), device) if inverse else None
    runs = passes(n, tile)
    if max_passes is not None:
        runs = min(runs, max_passes)
    y = torch.empty_like(x)
    _build.launch(
        "zk_ntt", device, x.data_ptr(), y.data_ptr(), plan.data_ptr(),
        None if scale is None else scale.data_ptr(), n, tile, runs,
    )
    ntt_device.launches += runs
    return y


#: Kernel launches in this process (the plain version does not count).
ntt_device.launches = 0  # type: ignore[attr-defined]


def ntt_limbs(arr: np.ndarray, root: int, inverse: bool) -> np.ndarray:
    """In-place NTT over (n, 4) u64 canonical Fr limbs — the graft
    analog of native ``zk_ntt`` (the signature ``Domain.ntt_limbs``
    uses), on the graft device (``zk_device()``): the upload, K11, the
    download."""
    t0 = time.perf_counter()
    n = arr.shape[0]
    if n & (n - 1):
        raise ValueError(f"NTT size must be a power of two, got {n}")
    if n == 1:
        _bump_phase("ntt", time.perf_counter() - t0)
        return arr
    device = zk_device()
    y = ntt_device(u64_to_tensor(arr, device), _device_plan(n, root, device), inverse)
    arr[:] = tensor_to_u64(y)
    _bump_phase("ntt", time.perf_counter() - t0)
    return arr


# ---------------------------------------------------------------------------
# Declared launches (``analysis/budget.py``, kept next to the kernel): one
# K11 a pass, ``passes(n)`` passes; no K10.
# ---------------------------------------------------------------------------

from ...analysis.budget import ZkKernelBudget, declare_zk  # noqa: E402

declare_zk(
    ZkKernelBudget(
        kernel="zk-graft-ntt-stage",
        wrapper="ntt_device",
        per_call={"ntt_limbs": lambda n, inverse: passes(n) if n > 1 else 0},
        notes="every butterfly stage in passes of log_tile(n) stages, the bit-reverse in the "
        "first pass's loads, the inverse's scale in the last pass's stores",
    )
)
