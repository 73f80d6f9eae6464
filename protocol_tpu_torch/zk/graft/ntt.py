"""Iterative radix-2 NTT over Fr on the card (the port of
``protocol_tpu/zk/graft/ntt.py``).

Decimation-in-time Cooley–Tukey: one host-side bit-reverse permutation
(numpy, as in the reference), then ``log2(n)`` butterfly stages, each
one launch of the kernel K11 (``ops/csrc/zk_ntt_stage.cu``, through
:func:`ntt_stage`), in place on the card.  The conversions into and out
of the Montgomery domain and the inverse transform's ``1/n`` scale are
K10 (``field.field_op``) with a broadcast operand.  Twiddle plans are
exact Python ints, computed once per ``(n, root)`` and kept on each
device they are used on as one ``(n - 1, 4)`` tensor (stage ``L``'s
``L/2`` twiddles from row ``L/2 - 1``).

The transform is bit-identical to ``plonk._py_ntt`` / native
``zk_ntt`` by construction: every butterfly is exact modular
arithmetic.  On the CPU (``zk_device() == cpu``) the same code runs the
kernels' plain versions.
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


def ntt_stage(x: torch.Tensor, tw: torch.Tensor, half: int) -> None:
    """One butterfly stage, in place: ``x`` (n, 4) int64 words of
    Montgomery Fr, ``tw`` the stage's (half, 4) Montgomery twiddles.

    On CUDA tensors this launches ``ops/csrc/zk_ntt_stage.cu`` (K11,
    one thread a butterfly) and adds one to ``ntt_stage.launches``; a
    launch the card refuses raises.  On CPU tensors it is the plain
    version.  Mixed or other devices raise."""
    n = x.shape[0]
    if x.dtype != torch.int64 or tw.dtype != torch.int64 or x.dim() != 2 or x.shape[1] != 4:
        raise ValueError("ntt_stage: x must be an (n, 4) int64 word tensor")
    if half < 1 or half & (half - 1) or n % (2 * half) or tuple(tw.shape) != (half, 4):
        raise ValueError(f"ntt_stage: half {half} and twiddles {tuple(tw.shape)} do not fit n = {n}")
    device = _build.operand_device("zk_ntt_stage", x=x, tw=tw)
    if device.type == "cpu":
        _stage_plain(x, tw, half)
        return
    _build.launch("zk_ntt_stage", device, x.data_ptr(), tw.data_ptr(), n, half)
    ntt_stage.launches += 1


#: Kernel launches in this process (the plain version does not count).
ntt_stage.launches = 0  # type: ignore[attr-defined]


def ntt_limbs(arr: np.ndarray, root: int, inverse: bool) -> np.ndarray:
    """In-place NTT over (n, 4) u64 canonical Fr limbs — the graft
    analog of native ``zk_ntt`` (the signature ``Domain.ntt_limbs``
    uses), on the graft device (``zk_device()``)."""
    t0 = time.perf_counter()
    n = arr.shape[0]
    if n & (n - 1):
        raise ValueError(f"NTT size must be a power of two, got {n}")
    if n == 1:
        _bump_phase("ntt", time.perf_counter() - t0)
        return arr
    device = zk_device()
    x = FR.to_mont(u64_to_tensor(arr[_bitrev_perm(n)], device))
    plan = _device_plan(n, root, device)
    half = 1
    while half < n:
        ntt_stage(x, plan[half - 1 : 2 * half - 1], half)
        half <<= 1
    if inverse:
        c = _ninv_cache.get(n)
        if c is None:
            c = _ninv_cache[n] = FR.to_mont_int(pow(n, R - 2, R))
        x = FR.mont_mul(x, FR.const(c, device))
    arr[:] = tensor_to_u64(FR.from_mont(x))
    _bump_phase("ntt", time.perf_counter() - t0)
    return arr


# ---------------------------------------------------------------------------
# Declared launches (``analysis/budget.py``, kept next to the kernel): one
# K11 a stage, log2(n) stages.
# ---------------------------------------------------------------------------

from ...analysis.budget import ZkKernelBudget, declare_zk  # noqa: E402

declare_zk(
    ZkKernelBudget(
        kernel="zk-graft-ntt-stage",
        wrapper="ntt_stage",
        per_call={"ntt_limbs": lambda n, inverse: n.bit_length() - 1},
        notes="one radix-2 butterfly stage a launch; the bit-reverse stays on the host",
    )
)
