"""BN254 Fr and Fq arithmetic on the card: the graft prover's field layer.

The port of ``protocol_tpu/zk/graft/field.py``.  An element travels as
four little-endian 64-bit words, an ``(n, 4)`` ``int64`` tensor holding
the bit pattern of the native runtime's ``(n, 4)`` ``uint64`` limbs
(``utils/limbs.py``).  Products live in the Montgomery domain with
``R = 2^256``, exactly as in the reference, so Montgomery-form values
(and so the MSM's buckets) compare with the reference's limb for limb;
every result is canonical (``< p``).

:func:`field_op` is the one entry of the kernel K10
(``ops/csrc/zk_mulmod.cu``): a Montgomery multiply, an add or a
subtract mod p of two ``(n, 4)`` operands, the second one either
``(n, 4)`` or one element broadcast ``(1, 4)``.  On CUDA tensors it
launches K10 and adds one to ``field_op.launches``; on CPU tensors it
runs the plain version, which computes on ``int64`` tensors of sixteen
16-bit limbs (every limb product fits 32 bits, a column of sixteen of
them 37 bits) with the reference's schoolbook product and REDC fold.
Both give the one canonical result, so they agree bit for bit.

The host helpers ``ints_to_limbs``, ``limbs_to_ints``, ``u64_to_limbs``
and ``limbs_to_u64`` keep the reference's names and ``(n, 16)`` uint32
16-bit-limb layout, so a test feeds both packages the same arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ...crypto.field import MODULUS as FR_MODULUS
from ...ops import _build
from ..rns import FQ_MODULUS

NLIMBS = 16
LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1
RADIX = 1 << (NLIMBS * LIMB_BITS)  # 2^256, the Montgomery R

#: K10's operations, by the code its C function takes.
OPS = {"mul": 0, "add": 1, "sub": 2}


def _int_to_limbs_np(v: int, n: int = NLIMBS) -> np.ndarray:
    return np.array([(v >> (LIMB_BITS * i)) & MASK for i in range(n)], dtype=np.uint32)


def ints_to_limbs(values) -> np.ndarray:
    """Python ints -> (n, 16) u32 little-endian 16-bit limbs."""
    buf = b"".join(v.to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, dtype=np.uint16).reshape(-1, NLIMBS).astype(np.uint32)


def limbs_to_ints(arr: np.ndarray) -> list[int]:
    buf = np.ascontiguousarray(arr.astype(np.uint16)).tobytes()
    return [int.from_bytes(buf[i : i + 32], "little") for i in range(0, len(buf), 32)]


def u64_to_limbs(arr: np.ndarray) -> np.ndarray:
    """(n, 4) u64 canonical limbs (utils/limbs.py layout) -> (n, 16) u32."""
    a = np.ascontiguousarray(arr, dtype=np.uint64)
    return a.view(np.uint16).reshape(a.shape[0], NLIMBS).astype(np.uint32)


def limbs_to_u64(arr: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(arr).astype(np.uint16))
    return a.view(np.uint64).reshape(a.shape[0], 4).copy()


def u64_to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """(n, 4) u64 numpy limbs -> an (n, 4) int64 tensor of the same bits on ``device``."""
    a = np.ascontiguousarray(arr, dtype=np.uint64).view(np.int64)
    return torch.from_numpy(a).to(device)


def tensor_to_u64(x: torch.Tensor) -> np.ndarray:
    """(..., 4) int64 tensor -> numpy uint64 limbs of the same bits, on the host."""
    return x.detach().cpu().contiguous().numpy().view(np.uint64)


# ---------------------------------------------------------------------------
# The plain version: int64 tensors of sixteen 16-bit limbs
# ---------------------------------------------------------------------------


def to16(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) int64 words -> (..., 16) int64 16-bit limbs."""
    return x.contiguous().view(torch.int16).to(torch.int64) & MASK


def from16(limbs: torch.Tensor) -> torch.Tensor:
    """(..., 16) int64 16-bit limbs -> (..., 4) int64 words."""
    signed = torch.where(limbs >= 1 << 15, limbs - (1 << 16), limbs)
    return signed.to(torch.int16).contiguous().view(torch.int64)


_COLUMN: dict[torch.device, torch.Tensor] = {}


def _column_index(device: torch.device) -> torch.Tensor:
    """Column ``i + j`` of limb product ``(i, j)``, flattened."""
    idx = _COLUMN.get(device)
    if idx is None:
        r = torch.arange(NLIMBS, device=device)
        idx = _COLUMN[device] = (r[:, None] + r[None, :]).reshape(-1)
    return idx


def _cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook columns of ``a * b``: (..., 32), each a sum of at most
    sixteen limb products (< 2^37), carries not yet resolved."""
    a, b = torch.broadcast_tensors(a, b)
    prod = (a.unsqueeze(-1) * b.unsqueeze(-2)).reshape(*a.shape[:-1], NLIMBS * NLIMBS)
    out = prod.new_zeros(*a.shape[:-1], 2 * NLIMBS)
    return out.index_add_(-1, _column_index(a.device), prod)


def _carry(c: torch.Tensor) -> torch.Tensor:
    """The same value with every limb but the top one in [0, 2^16):
    carries (and borrows, from negative limbs) moved up until none is
    left; the top limb keeps what reaches it.  A pass moves every limb's
    carry one place, so a chain of k limbs takes k passes; most inputs
    settle in three.  The first pass is made untested (every caller has
    a carry to move) and makes a new tensor, so ``c`` is never written."""
    first = True
    while True:
        hi = c >> LIMB_BITS
        hi[..., -1] = 0
        if not first and not bool(hi.any()):
            return c
        first = False
        c = c - (hi << LIMB_BITS)
        c[..., 1:] += hi[..., :-1]


_CONST16: dict[tuple[int, torch.device], torch.Tensor] = {}


def _const16(v: int, device) -> torch.Tensor:
    key = (v, torch.device(device))
    c = _CONST16.get(key)
    if c is None:
        c = _CONST16[key] = torch.from_numpy(_int_to_limbs_np(v).astype(np.int64)).to(device)
    return c


class Field:
    """One prime field's constants and tensor operations (``FR``, ``FQ``).

    Elements are canonical (``< p``) ``(..., 4)`` int64 words; products
    are Montgomery products (``a * b * 2^-256 mod p``)."""

    def __init__(self, name: str, p: int, code: int):
        self.name = name
        self.p = p
        #: K10's field argument.
        self.code = code
        self.p_np = _int_to_limbs_np(p)
        # -p^{-1} mod 2^256: the REDC multiplier.
        self.nprime = (-pow(p, -1, RADIX)) % RADIX
        self.nprime_np = _int_to_limbs_np(self.nprime)
        self.r = RADIX % p  # Montgomery form of 1
        self.r2 = (RADIX * RADIX) % p
        self.r_np = _int_to_limbs_np(self.r)
        self.r2_np = _int_to_limbs_np(self.r2)
        self._consts: dict[tuple[int, torch.device], torch.Tensor] = {}

    # -- tensor operations (K10 on the card, the plain version on the CPU) --

    def const(self, v: int, device) -> torch.Tensor:
        """The canonical word form of ``v`` as a (1, 4) int64 tensor on
        ``device``, made once (the NTT's 1/n, the point cache's R^2 and R); read only."""
        key = (v, torch.device(device))
        c = self._consts.get(key)
        if c is None:
            words = np.array([[(v >> (64 * i)) & ((1 << 64) - 1) for i in range(4)]], np.uint64)
            c = self._consts[key] = u64_to_tensor(words, device)
        return c

    def mont_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return field_op(a, b, self, "mul")

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return field_op(a, b, self, "add")

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return field_op(a, b, self, "sub")

    def to_mont(self, a: torch.Tensor) -> torch.Tensor:
        return field_op(a, self.const(self.r2, a.device), self, "mul")

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        return field_op(a, self.const(1, a.device), self, "mul")

    # -- the plain version on 16-bit limbs (the MSM's plain version composes them) --

    def mont_mul16(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product of (..., 16) limb tensors: the schoolbook
        product ``T``, ``m = (T mod R) * (-p^-1) mod R``, ``(T + m p) / R``,
        one conditional subtract."""
        t = _cols(a, b)
        t_low = _carry(t[..., :NLIMBS]) & MASK
        m = _carry(_cols(t_low, _const16(self.nprime, a.device))[..., :NLIMBS]) & MASK
        s = _carry(t + _cols(m, _const16(self.p, a.device)))
        return self.cond_sub_p16(s[..., NLIMBS:])

    def cond_sub_p16(self, x: torch.Tensor) -> torch.Tensor:
        d = _carry(x - _const16(self.p, x.device))
        return torch.where((d[..., -1] < 0).unsqueeze(-1), x, d)

    def add16(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        # a + b < 2p < 2^256: the top limb stays below 2^16.
        return self.cond_sub_p16(_carry(a + b))

    def sub16(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        d = _carry(a - b)
        wrapped = _carry(d + _const16(self.p, d.device))
        return torch.where((d[..., -1] < 0).unsqueeze(-1), wrapped, d)

    # -- host-side exact helpers (conversion boundaries) --------------

    def to_mont_int(self, v: int) -> int:
        return (v * RADIX) % self.p

    def from_mont_int(self, v: int) -> int:
        return (v * pow(RADIX, -1, self.p)) % self.p


FR = Field("fr", FR_MODULUS, 0)
FQ = Field("fq", FQ_MODULUS, 1)

_FIELDS = {"fr": FR, "fq": FQ}


def is_zero16(a: torch.Tensor) -> torch.Tensor:
    """(..., 16) -> (...,) bool; Montgomery zero is limbwise zero."""
    return (a == 0).all(dim=-1)


def _plain(a: torch.Tensor, b: torch.Tensor, field: Field, op: str) -> torch.Tensor:
    fn = {"mul": field.mont_mul16, "add": field.add16, "sub": field.sub16}[op]
    return from16(fn(to16(a), to16(b)))


def field_op(a: torch.Tensor, b: torch.Tensor, field: Field, op: str = "mul") -> torch.Tensor:
    """``op`` ("mul": the Montgomery product, "add", "sub", all mod p)
    of canonical (n, 4) int64 word tensors; ``b`` is (n, 4) or one
    element (1, 4) broadcast over ``a``.  Returns a new (n, 4) tensor.

    On CUDA tensors this launches ``ops/csrc/zk_mulmod.cu`` (K10, one
    thread an element) and adds one to ``field_op.launches``; a launch
    the card refuses raises.  On CPU tensors it is the plain version.
    Mixed or other devices raise."""
    if op not in OPS:
        raise ValueError(f"field_op: unknown op {op!r}; expected one of {tuple(OPS)}")
    if a.dtype != torch.int64 or b.dtype != torch.int64:
        raise ValueError("field_op: operands must be int64 word tensors")
    if a.dim() != 2 or a.shape[1] != 4 or b.dim() != 2 or b.shape[1] != 4:
        raise ValueError(f"field_op: operands must be (n, 4), got {tuple(a.shape)}, {tuple(b.shape)}")
    n = a.shape[0]
    if b.shape[0] not in (1, n):
        raise ValueError(f"field_op: b has {b.shape[0]} rows, not 1 or {n}")
    device = _build.operand_device("zk_mulmod", a=a, b=b)
    if device.type == "cpu":
        return _plain(a, b, field, op)
    out = torch.empty_like(a)
    if n:
        _build.launch(
            "zk_mulmod", device, a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
            1 if b.shape[0] == n else 0, field.code, OPS[op],
        )
        field_op.launches += 1
    return out


#: Kernel launches in this process (the plain version does not count).
field_op.launches = 0  # type: ignore[attr-defined]


def mulmod_fr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched Montgomery multiply in Fr (the reference's ``zk-graft-mulmod`` entry)."""
    return field_op(a, b, FR)


def mulmod_fq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return field_op(a, b, FQ)


# ---------------------------------------------------------------------------
# Declared launches (``analysis/budget.py``, kept next to the kernel):
# K10 converts X and Y of a point cache into the Montgomery domain; the
# NTT (K11) and the MSM (K12, K13) launch none.
# ---------------------------------------------------------------------------

from ...analysis.budget import ZkKernelBudget, declare_zk  # noqa: E402

declare_zk(
    ZkKernelBudget(
        kernel="zk-graft-mulmod",
        wrapper="field_op",
        per_call={
            "ntt_limbs": lambda n, inverse: 0,
            "point_cache": lambda n: 2,
            "msm_limbs": lambda n: 0,
        },
        notes="to_mont of X and of Y of a point cache",
    )
)
