"""PLONK prover/verifier over the PLONKish constraint system.

The real SNARK behind the proof layer — the analog of the reference's
Halo2 KZG proving path (``create_proof``/``verify_proof`` behind
circuit/src/utils.rs:259-303 and the EVM transcript flow in
circuit/src/verifier/mod.rs:62-83).  This is a fresh design,
not a Halo2 port: the circuit layer (``zk.cs``) stays a plain
trace-of-columns with black-box arithmetic gates, and this module
compiles it into a polynomial IOP:

* gates are *traced symbolically* (their Python callables run once over
  operator-overloading symbols) into expression trees, linearized to
  stack bytecode for the C++ gate evaluator (native/zk_runtime.cpp),
  which evaluates the whole y-combined constraint polynomial over the
  extended coset domain in one OpenMP pass per gate;
* copy constraints become a Halo2-style chunked permutation argument
  (grand products z_c over column chunks, chained through rotation −1,
  with the last row reserved so blinding needs no usable-region
  bookkeeping);
* boolean selectors become committed fixed columns;
* everything is committed with KZG over Bn254 and opened at the
  evaluation challenge with a GWC-style batched multi-open (one witness
  commitment per rotation point, two pairings total);
* Fiat-Shamir runs over the Poseidon transcript
  (``zk.transcript``), so the whole proof is one replayable
  byte string in the reference's ``Proof``/``ProofRaw`` wire shape.

Zero-knowledge: advice and z polynomials are blinded with random
multiples of the vanishing polynomial ((b0 + b1·X)·Z_H), which leaves
their evaluations on the domain — and therefore every constraint —
unchanged.

No instruction-following from the reference repo: cited lines document
behavioral parity targets only.
"""

from __future__ import annotations

import contextlib
import secrets
import time
from collections import Counter
from dataclasses import dataclass, field as dc_field

import numpy as np

from ..crypto import field
from ..crypto.poseidon import PoseidonSponge
from ..obs import TRACER
from ..utils.limbs import from_limbs_fast, ptr as _ptr, to_limbs, to_limbs_fast
from .bn254 import G1, GENERATOR
from .cs import Column, ConstraintSystem
from . import graft as zk_graft
from .kzg import Setup, _div_by_linear, _eval_poly, msm
from .transcript import KeccakRead, KeccakWrite, PoseidonRead, PoseidonWrite

#: Fiat-Shamir backends: "poseidon" (native flow, aggregation-friendly)
#: and "keccak" (EVM flow — replayable with the KECCAK256 opcode, the
#: snark-verifier EvmTranscript analog).
_TRANSCRIPTS = {
    "poseidon": (PoseidonWrite, PoseidonRead),
    "keccak": (KeccakWrite, KeccakRead),
}

R = field.MODULUS
TWO_ADICITY = 28

#: 5 generates Fr* (5^((R-1)/2) == -1 checked below), so ROOT28 is a
#: primitive 2^28-th root of unity and DELTA = 5^(2^28) generates the
#: odd-order subgroup — its powers tag disjoint cosets k_j·H for the
#: permutation argument and shift the quotient evaluation coset off H.
_GEN = 5
ROOT28 = pow(_GEN, (R - 1) >> TWO_ADICITY, R)
DELTA = pow(_GEN, 1 << TWO_ADICITY, R)
assert pow(ROOT28, 1 << (TWO_ADICITY - 1), R) == R - 1, "ROOT28 not primitive"


def omega(k: int) -> int:
    """Primitive 2^k-th root of unity."""
    assert 0 <= k <= TWO_ADICITY
    return pow(ROOT28, 1 << (TWO_ADICITY - k), R)


# ---------------------------------------------------------------------------
# Symbolic gate tracing
# ---------------------------------------------------------------------------


class Sym:
    """Arithmetic expression node produced by tracing gate callables.

    Gate polynomials in the constraint system are plain Python
    callables over `+ - * % neg`; running them over Sym operands
    records the expression once, after which it can be linearized to
    C++ stack bytecode (coset evaluation) or evaluated scalar-wise
    (the verifier's single-point check).
    """

    __slots__ = ("op", "args", "deg")

    def __init__(self, op: str, args: tuple, deg: int):
        self.op = op
        self.args = args
        self.deg = deg

    # -- constructors ---------------------------------------------------

    @staticmethod
    def col(slot: int, rot: int = 0) -> "Sym":
        return Sym("col", (slot, rot), 1)

    @staticmethod
    def const(v: int) -> "Sym":
        return Sym("const", (v % R,), 0)

    @staticmethod
    def _wrap(x) -> "Sym":
        if isinstance(x, Sym):
            return x
        if isinstance(x, int):
            return Sym.const(x)
        return NotImplemented  # pragma: no cover

    # -- operators ------------------------------------------------------

    def __add__(self, o):
        o = Sym._wrap(o)
        return Sym("add", (self, o), max(self.deg, o.deg))

    __radd__ = __add__

    def __sub__(self, o):
        o = Sym._wrap(o)
        return Sym("sub", (self, o), max(self.deg, o.deg))

    def __rsub__(self, o):
        return Sym._wrap(o).__sub__(self)

    def __mul__(self, o):
        o = Sym._wrap(o)
        return Sym("mul", (self, o), self.deg + o.deg)

    __rmul__ = __mul__

    def __neg__(self):
        return Sym("neg", (self,), self.deg)

    def __mod__(self, o):
        assert o == R, "gate polynomials must reduce modulo the Bn254 scalar field"
        return self

    # -- analysis -------------------------------------------------------

    def used_cols(self, out: set | None = None) -> set:
        """All (slot, rot) pairs referenced."""
        if out is None:
            out = set()
        stack = [self]
        while stack:
            node = stack.pop()
            if node.op == "col":
                out.add(node.args)
            elif node.op not in ("const",):
                stack.extend(node.args)
        return out


class SymView:
    """RowView stand-in handed to gate callables during tracing:
    ``view[col]`` / ``view[col, rot]`` return column symbols."""

    def __init__(self, slot_of: dict):
        self._slot_of = slot_of

    def __getitem__(self, key):
        if isinstance(key, tuple):
            col, rot = key
        else:
            col, rot = key, 0
        return Sym.col(self._slot_of[col], rot)


def sym_eval(sym: Sym, getval, memo: dict | None = None) -> int:
    """Scalar evaluation; getval(slot, rot) -> int.  Memoized on node
    identity so shared subtrees evaluate once."""
    if memo is None:
        memo = {}
    key = id(sym)
    if key in memo:
        return memo[key]
    op = sym.op
    if op == "col":
        v = getval(*sym.args)
    elif op == "const":
        v = sym.args[0]
    elif op == "add":
        v = (sym_eval(sym.args[0], getval, memo) + sym_eval(sym.args[1], getval, memo)) % R
    elif op == "sub":
        v = (sym_eval(sym.args[0], getval, memo) - sym_eval(sym.args[1], getval, memo)) % R
    elif op == "mul":
        v = sym_eval(sym.args[0], getval, memo) * sym_eval(sym.args[1], getval, memo) % R
    else:  # neg
        v = (-sym_eval(sym.args[0], getval, memo)) % R
    memo[key] = v
    return v


_OP_COL, _OP_CONST, _OP_ADD, _OP_SUB, _OP_MUL, _OP_NEG = 0, 1, 2, 3, 4, 5


def linearize(sym: Sym, local_slot: dict, const_pool: dict, code: list) -> int:
    """Emit stack bytecode for the C++ evaluator; returns the maximum
    stack depth.  Deeper operands are emitted first so depth stays
    logarithmic (sub order is restored with a neg)."""
    op = sym.op
    if op == "col":
        slot, rot = sym.args
        code += [_OP_COL, local_slot[slot], rot]
        return 1
    if op == "const":
        idx = const_pool.setdefault(sym.args[0], len(const_pool))
        code += [_OP_CONST, idx]
        return 1
    if op == "neg":
        d = linearize(sym.args[0], local_slot, const_pool, code)
        code.append(_OP_NEG)
        return d
    a, b = sym.args
    da, db = _depth(a), _depth(b)
    swapped = db > da
    first, second = (b, a) if swapped else (a, b)
    d1 = linearize(first, local_slot, const_pool, code)
    d2 = linearize(second, local_slot, const_pool, code)
    depth = max(d1, d2 + 1)
    if op == "add":
        code.append(_OP_ADD)
    elif op == "mul":
        code.append(_OP_MUL)
    else:  # sub: stack holds first − second
        code.append(_OP_SUB)
        if swapped:  # computed b − a, want a − b
            code.append(_OP_NEG)
    return depth


def _depth(sym: Sym) -> int:
    if sym.op in ("col", "const"):
        return 1
    if sym.op == "neg":
        return _depth(sym.args[0])
    a, b = (_depth(x) for x in sym.args)
    return max(min(a, b) + 1, max(a, b))


# ---------------------------------------------------------------------------
# Domain / FFT helpers (native NTT with a pure-Python fallback)
# ---------------------------------------------------------------------------


def _native_lib():
    from . import native as zk_native

    if zk_native.available():
        return zk_native._load()
    return None


def _py_ntt(vals: list[int], root: int, inverse: bool) -> list[int]:
    n = len(vals)
    a = list(vals)
    # bit-reverse permute
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        w_len = pow(root, n // length, R)
        for start in range(0, n, length):
            w = 1
            half = length >> 1
            for k in range(start, start + half):
                u, t = a[k], a[k + half] * w % R
                a[k] = (u + t) % R
                a[k + half] = (u - t) % R
                w = w * w_len % R
        length <<= 1
    if inverse:
        n_inv = pow(n, R - 2, R)
        a = [x * n_inv % R for x in a]
    return a


class Domain:
    """Power-of-two evaluation domain."""

    def __init__(self, k: int):
        self.k = k
        self.n = 1 << k
        self.omega = omega(k)
        self.omega_inv = pow(self.omega, R - 2, R)

    def fft(self, coeffs: list[int]) -> list[int]:
        vals = list(coeffs) + [0] * (self.n - len(coeffs))
        return self._ntt(vals, self.omega, False)

    def ifft(self, evals: list[int]) -> list[int]:
        assert len(evals) == self.n
        return self._ntt(list(evals), self.omega_inv, True)

    def _ntt(self, vals: list[int], root: int, inverse: bool) -> list[int]:
        if zk_graft.zk_backend() == "graft":
            arr = zk_graft.ntt_limbs(to_limbs_fast(vals), root, inverse)
            return from_limbs_fast(arr)
        lib = _native_lib()
        if lib is None:
            return _py_ntt(vals, root, inverse)
        arr = to_limbs_fast(vals)
        rl = to_limbs([root])
        lib.zk_ntt(_ptr(arr), len(vals), _ptr(rl), 1 if inverse else 0)
        return from_limbs_fast(arr)

    def ifft_arr(self, values: list[int] | np.ndarray) -> np.ndarray:
        """Interpolate n evaluations into coefficient limbs without a
        Python-int round trip."""
        if isinstance(values, np.ndarray):
            arr = np.ascontiguousarray(values, dtype=np.uint64)
            assert arr.shape[0] == self.n
        else:
            assert len(values) == self.n
            arr = to_limbs_fast(values)
        return self.ntt_limbs(arr, self.omega_inv, True)

    def ntt_limbs(self, arr: np.ndarray, root: int, inverse: bool) -> np.ndarray:
        """In-place NTT over a (n, 4) limb array (``zk_backend`` path)."""
        if zk_graft.zk_backend() == "graft":
            return zk_graft.ntt_limbs(arr, root, inverse)
        lib = _native_lib()
        if lib is None:
            vals = _py_ntt(from_limbs_fast(arr), root, inverse)
            arr[:] = to_limbs_fast(vals)
            return arr
        rl = to_limbs([root])
        lib.zk_ntt(_ptr(arr), arr.shape[0], _ptr(rl), 1 if inverse else 0)
        return arr


def _powers(base: int, n: int) -> list[int]:
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * base % R
    return out


# -- limb-array helpers -----------------------------------------------------
#
# The proving hot path keeps polynomials as (n, 4) uint64 canonical-limb
# arrays end to end (ifft -> blind -> commit -> coset -> open), so the
# per-element Python big-int <-> limb conversions that dominated early
# profiles only happen at the few scalar boundaries (transcript,
# challenges, blinders).  Every helper falls back to pure Python via
# from/to_limbs_fast when the native runtime is unavailable.


def _row_int(arr: np.ndarray, i: int) -> int:
    r = arr[i]
    return int(r[0]) | int(r[1]) << 64 | int(r[2]) << 128 | int(r[3]) << 192


def _set_row(arr: np.ndarray, i: int, v: int) -> None:
    arr[i, 0] = v & 0xFFFFFFFFFFFFFFFF
    arr[i, 1] = (v >> 64) & 0xFFFFFFFFFFFFFFFF
    arr[i, 2] = (v >> 128) & 0xFFFFFFFFFFFFFFFF
    arr[i, 3] = (v >> 192) & 0xFFFFFFFFFFFFFFFF


def _powers_arr(base: int, n: int) -> np.ndarray:
    lib = _native_lib()
    if lib is None:
        return to_limbs_fast(_powers(base % R, n))
    from .native import powers as native_powers

    return native_powers(base, n)


def _poly_eval_arr(arr: np.ndarray, x: int) -> int:
    lib = _native_lib()
    if lib is None:
        acc = 0
        for c in reversed(from_limbs_fast(arr)):
            acc = (acc * x + c) % R
        return acc
    from .native import poly_eval_limbs

    return poly_eval_limbs(arr, x)


def _div_linear_arr(arr: np.ndarray, z: int) -> np.ndarray:
    """(p - p(z)) / (X - z) on limb arrays."""
    lib = _native_lib()
    if lib is None:
        coeffs = from_limbs_fast(arr)
        out = [0] * (len(coeffs) - 1)
        rem = 0
        for i in range(len(coeffs) - 1, 0, -1):
            rem = (rem * z + coeffs[i]) % R
            out[i - 1] = rem
        return to_limbs_fast(out) if out else np.zeros((1, 4), np.uint64)
    from .native import div_linear_limbs

    return div_linear_limbs(arr, z)


def _scale_add_arr(acc: np.ndarray, p: np.ndarray, s: int) -> None:
    lib = _native_lib()
    if lib is None:
        n = min(acc.shape[0], p.shape[0])
        av = from_limbs_fast(acc[:n])
        pv = from_limbs_fast(p[:n])
        acc[:n] = to_limbs_fast([(a + s * b) % R for a, b in zip(av, pv)])
        return
    from .native import scale_add

    scale_add(acc, p, s)


def _vec_mul_arr(a: np.ndarray, b: np.ndarray, out: np.ndarray) -> None:
    """out = a * b elementwise over min-length rows (canonical limbs)."""
    lib = _native_lib()
    n = min(a.shape[0], b.shape[0], out.shape[0])
    if lib is None:
        av, bv = from_limbs_fast(a[:n]), from_limbs_fast(b[:n])
        out[:n] = to_limbs_fast([(x * y) % R for x, y in zip(av, bv)])
        return
    lib.zk_vec_mul(_ptr(a[:n]), _ptr(b[:n]), _ptr(out[:n]), n)


def _batch_inv(vals: list[int]) -> list[int]:
    """Montgomery batch inversion; zeros invert to zero."""
    n = len(vals)
    prefix = [1] * n
    acc = 1
    for i, v in enumerate(vals):
        prefix[i] = acc
        if v:
            acc = acc * v % R
    inv_acc = pow(acc, R - 2, R)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        v = vals[i]
        if v:
            out[i] = prefix[i] * inv_acc % R
            inv_acc = inv_acc * v % R
    return out


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------


@dataclass
class GateSpec:
    name: str
    sel_slot: int
    constraints: list  # list[Sym]


@dataclass
class LookupSpec:
    """One compiled lookup argument (Halo2-style A'/S' permutation +
    grand product re-derived for the reserved-last-row domain layout).

    ``table_fixed_idx[j]`` indexes the synthetic fixed column holding
    tuple element j of the (sorted, padded) table; ``pad`` is the table
    entry substituted for rows where the selector is off."""

    name: str
    sel_slot: int
    input_slots: list[int]
    table_fixed_idx: list[int]
    pad: list[int]


@dataclass
class VerifyingKey:
    k: int
    ext_factor: int
    advice_names: list[str]
    instance_names: list[str]
    fixed_names: list[str]  # includes __q_* selector columns
    slot_of_name: dict[str, int]
    gates: list[GateSpec]
    gate_rots: dict[int, tuple[int, ...]]  # slot -> rotations used by gates
    perm_slots: list[int]
    perm_tags: list[int]  # k_j coset tags, aligned with perm_slots
    chunks: list[list[int]]  # chunk -> indices into perm_slots
    fixed_commits: list[G1]
    sigma_commits: list[G1]
    srs: Setup
    lookups: list[LookupSpec] = dc_field(default_factory=list)
    digest: int = 0

    @property
    def n(self) -> int:
        return 1 << self.k

    @property
    def n_advice(self) -> int:
        return len(self.advice_names)

    def omega(self) -> int:
        return omega(self.k)

    def compute_digest(self) -> int:
        t = PoseidonWrite()
        t.write_scalar(self.k)
        t.write_scalar(self.ext_factor)
        t.write_scalar(len(self.advice_names))
        t.write_scalar(len(self.gates))
        for c in self.fixed_commits:
            t.write_point(c)
        for c in self.sigma_commits:
            t.write_point(c)
        for tag in self.perm_tags:
            t.write_scalar(tag)
        t.write_scalar(len(self.lookups))
        for lk in self.lookups:
            # Width delimiter first: without it, adjacent lookups'
            # variable-length field sequences concatenate ambiguously.
            t.write_scalar(len(lk.input_slots))
            t.write_scalar(lk.sel_slot)
            for s in lk.input_slots:
                t.write_scalar(s)
            for ti in lk.table_fixed_idx:
                t.write_scalar(ti)
            for v in lk.pad:
                t.write_scalar(v)
        return t.squeeze_challenge()


@dataclass
class ProvingKey:
    vk: VerifyingKey
    fixed_values: list[list[int]]  # n evals per fixed column
    fixed_polys: list[np.ndarray]  # (n,4) canonical coefficient limbs
    sigma_values: list[list[int]]  # permutation tags sigma_j(w^i)
    sigma_polys: list[np.ndarray]
    row_tags: list[int]  # omega^i, i < n
    #: Coset-extended evaluations of every fixed/sigma polynomial,
    #: precomputed at keygen so epoch proving never re-runs their
    #: coset NTTs (they are witness-independent).
    fixed_cosets: list[np.ndarray] = dc_field(default_factory=list)
    sigma_cosets: list[np.ndarray] = dc_field(default_factory=list)


# ---------------------------------------------------------------------------
# Compilation (keygen)
# ---------------------------------------------------------------------------

# Permutation columns per grand product (degree _M_CHUNK+2 each).  5
# keeps the permutation at degree 7, matching the worst gate (ed_mul
# select at 6 + selector), so the quotient extension stays at 8× —
# one more z polynomial in exchange for half the extended domain.
_M_CHUNK = 5


def _classify_columns(cs: ConstraintSystem):
    advice = [c for c in cs.columns.values() if c.kind == "advice"]
    instance = [c for c in cs.columns.values() if c.kind == "instance"]
    fixed = [c for c in cs.columns.values() if c.kind == "fixed"]
    return advice, instance, fixed


def compile_circuit(
    cs: ConstraintSystem, srs: Setup | None = None, k: int | None = None
) -> ProvingKey:
    """Preprocess a synthesized circuit into proving/verifying keys.

    The circuit *structure* (columns, gates, selector positions, fixed
    values, copy topology) must be witness-independent — the same
    guarantee Halo2's keygen relies on (circuit/src/utils.rs:229-248).
    """
    advice, instance, fixed = _classify_columns(cs)
    sel_names = sorted(cs.selectors)

    max_table = max((len(lk.table) for lk in cs.lookups), default=0)
    required = max(cs.n_rows + 1, max_table + 1, 4)
    min_k = (required - 1).bit_length()
    if k is None:
        k = min_k
    n = 1 << k
    assert n >= required, f"k={k} too small for {cs.n_rows} rows / {max_table} table"
    assert k + 4 <= TWO_ADICITY

    # Slot assignment: advice, instance, fixed, then selector columns.
    slot_of_col: dict[Column, int] = {}
    names_adv, names_inst, names_fix = [], [], []
    for col in advice:
        slot_of_col[col] = len(slot_of_col)
        names_adv.append(col.name)
    for col in instance:
        slot_of_col[col] = len(slot_of_col)
        names_inst.append(col.name)
    for col in fixed:
        slot_of_col[col] = len(slot_of_col)
        names_fix.append(col.name)
    sel_slot: dict[str, int] = {}
    for sname in sel_names:
        qname = f"__q_{sname}"
        assert qname not in cs.columns
        sel_slot[sname] = len(slot_of_col) + len(sel_slot)
        names_fix.append(qname)
    slot_of_name = {}
    for col, slot in slot_of_col.items():
        slot_of_name[col.name] = slot
    for sname, slot in sel_slot.items():
        slot_of_name[f"__q_{sname}"] = slot

    # Trace gates symbolically.
    view = SymView(slot_of_col)
    gates: list[GateSpec] = []
    used: set[tuple[int, int]] = set()
    max_deg = 1
    for gate in cs.gates:
        out = gate.poly(view)
        cons = list(out) if isinstance(out, (list, tuple)) else [out]
        spec = GateSpec(gate.name, sel_slot[gate.selector], cons)
        gates.append(spec)
        used.add((spec.sel_slot, 0))
        for sym in cons:
            used |= sym.used_cols()
            max_deg = max(max_deg, sym.deg + 1)  # +1 boolean selector

    # Lookup arguments: materialize each (sorted, padded) table as
    # synthetic fixed columns; inputs/tables are theta-compressed at
    # prove time inside the constraints.
    lookup_specs: list[LookupSpec] = []
    lookup_tables: list[list[list[int]]] = []  # per lookup: per element, n values
    for lk in cs.lookups:
        width = len(lk.columns)
        entries = sorted(
            (e if isinstance(e, tuple) else (e,)) for e in lk.table
        )
        assert entries, f"lookup {lk.name}: empty table"
        assert all(len(e) == width for e in entries), "table tuple width mismatch"
        assert len(entries) <= n - 1, "lookup table exceeds usable rows"
        pad = [v % R for v in entries[0]]
        padded = entries + [tuple(pad)] * (n - len(entries))
        cols_vals = [[int(e[j]) % R for e in padded] for j in range(width)]
        table_idx = []
        for j in range(width):
            table_idx.append(len(names_fix))
            names_fix.append(f"__lt{len(lookup_specs)}_{j}")
        spec = LookupSpec(
            name=lk.name,
            sel_slot=sel_slot[lk.selector],
            input_slots=[slot_of_col[c] for c in lk.columns],
            table_fixed_idx=table_idx,
            pad=pad,
        )
        lookup_specs.append(spec)
        lookup_tables.append(cols_vals)
        used.add((spec.sel_slot, 0))
        for s in spec.input_slots:
            used.add((s, 0))
        for ti in table_idx:
            slot = len(advice) + len(instance) + ti
            slot_of_name[names_fix[ti]] = slot
            used.add((slot, 0))
        max_deg = max(max_deg, 5)  # grand-product constraint degree

    # Permutation: columns appearing in copy constraints.
    perm_cols: list[Column] = []
    seen = set()
    for a, b in cs.copies:
        for cell in (a, b):
            if cell.column not in seen:
                seen.add(cell.column)
                perm_cols.append(cell.column)
    perm_cols.sort(key=lambda c: slot_of_col[c])
    perm_slots = [slot_of_col[c] for c in perm_cols]
    perm_tags = [pow(DELTA, j, R) for j in range(len(perm_slots))]
    chunks = [
        list(range(i, min(i + _M_CHUNK, len(perm_slots))))
        for i in range(0, len(perm_slots), _M_CHUNK)
    ]
    max_deg = max(max_deg, (_M_CHUNK if chunks else 0) + 2)

    ext_factor = 1 << (max_deg + 1 - 1).bit_length()
    assert k + ext_factor.bit_length() - 1 <= TWO_ADICITY

    # Gate rotation sets per slot (plus rot 0 for permuted columns).
    rots: dict[int, set[int]] = {}
    for slot, rot in used:
        rots.setdefault(slot, set()).add(rot)
    for slot in perm_slots:
        rots.setdefault(slot, set()).add(0)
    gate_rots = {slot: tuple(sorted(v)) for slot, v in rots.items()}

    # Fixed column values (trace + selectors).
    domain = Domain(k)
    fixed_values: list[list[int]] = []
    for col in fixed:
        vals = [0] * n
        for row, v in cs.trace[col].items():
            vals[row] = v
        fixed_values.append(vals)
    for sname in sel_names:
        vals = [0] * n
        for row in cs.selectors[sname]:
            vals[row] = 1
        fixed_values.append(vals)
    for cols_vals in lookup_tables:
        fixed_values.extend(cols_vals)
    assert len(fixed_values) == len(names_fix)
    fixed_polys = [domain.ifft_arr(v) for v in fixed_values]

    # Permutation mapping sigma: identity tags, then rewire cycles.
    row_tags = _powers(domain.omega, n)
    sigma_values = [
        [tag * row_tags[i] % R for i in range(n)] for tag in perm_tags
    ]
    col_index = {slot: j for j, slot in enumerate(perm_slots)}
    parent: dict[tuple[int, int], tuple[int, int]] = {}

    def find(p):
        while parent.get(p, p) != p:
            parent[p] = parent.get(parent[p], parent[p])
            p = parent[p]
        return p

    def union(p, q):
        rp, rq = find(p), find(q)
        if rp != rq:
            parent[rp] = rq

    def pos(cell):
        return (col_index[slot_of_col[cell.column]], cell.row)

    for a, b in cs.copies:
        pa, pb = pos(a), pos(b)
        assert pa[1] < n and pb[1] < n
        parent.setdefault(pa, pa)
        parent.setdefault(pb, pb)
        union(pa, pb)
    cycles: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for p in parent:
        cycles.setdefault(find(p), []).append(p)
    for members in cycles.values():
        members.sort()
        for i, (j, row) in enumerate(members):
            nj, nrow = members[(i + 1) % len(members)]
            sigma_values[j][row] = perm_tags[nj] * row_tags[nrow] % R
    sigma_polys = [domain.ifft_arr(v) for v in sigma_values]

    if srs is None:
        # Fresh random tau, discarded after the ladder is built: the
        # trust model is "whoever ran keygen" (a dev/test setup, or the
        # booting node operator) — a ceremony SRS should be supplied
        # via ``srs`` / loaded with Setup.from_bytes for anything whose
        # verifiers don't trust the prover's machine.
        srs = Setup.generate(k + 1, seed=secrets.token_bytes(32))
    # Headroom for blinded polynomials: advice columns get
    # len(rotations)+1 blinders (see prove), permutation z gets 4.
    max_blind = max(
        [4] + [len(rots) + 1 for slot, rots in gate_rots.items() if slot < len(advice)]
    )
    assert srs.n >= n + max_blind, (
        f"SRS too small for blinded polynomials: need {n + max_blind} powers "
        f"(degree bound n={n} + {max_blind} blinders), have {srs.n}"
    )

    fixed_commits = [srs.commit(p) for p in fixed_polys]
    sigma_commits = [srs.commit(p) for p in sigma_polys]

    vk = VerifyingKey(
        k=k,
        ext_factor=ext_factor,
        advice_names=names_adv,
        instance_names=names_inst,
        fixed_names=names_fix,
        slot_of_name=slot_of_name,
        gates=gates,
        gate_rots=gate_rots,
        perm_slots=perm_slots,
        perm_tags=perm_tags,
        chunks=chunks,
        fixed_commits=fixed_commits,
        sigma_commits=sigma_commits,
        srs=srs,
        lookups=lookup_specs,
    )
    vk.digest = vk.compute_digest()
    # Precompute coset-extended evaluations of the witness-independent
    # polynomials so prove() never re-runs their coset NTTs.
    ev = _CosetEvaluator(k, ext_factor)
    fixed_cosets = [ev._coset_fft(p) for p in fixed_polys]
    sigma_cosets = [ev._coset_fft(p) for p in sigma_polys]

    return ProvingKey(
        vk=vk,
        fixed_values=fixed_values,
        fixed_polys=fixed_polys,
        sigma_values=sigma_values,
        sigma_polys=sigma_polys,
        row_tags=row_tags,
        fixed_cosets=fixed_cosets,
        sigma_cosets=sigma_cosets,
    )


# ---------------------------------------------------------------------------
# Shared prover/verifier structure
# ---------------------------------------------------------------------------


def _perm_constraints(
    vk: VerifyingKey,
    beta: int,
    gamma: int,
    z_slots: list[int],
    sigma_slots: list[int],
    x_slot: int,
    l0_slot: int,
    llast_slot: int,
) -> list[Sym]:
    """The permutation argument's constraints, as symbols.  Order and
    content are identical for prover (coset) and verifier (scalar)."""
    if not vk.chunks:
        return []
    cons: list[Sym] = []
    one = Sym.const(1)
    l0 = Sym.col(l0_slot)
    llast = Sym.col(llast_slot)
    x = Sym.col(x_slot)
    # z_0 starts at 1.
    cons.append(l0 * (Sym.col(z_slots[0]) - one))
    # Chunk chaining: z_c(1) = z_{c-1}(omega^{-1}) (= previous chunk's
    # full product over the n-1 active rows).
    for c in range(1, len(vk.chunks)):
        cons.append(l0 * (Sym.col(z_slots[c]) - Sym.col(z_slots[c - 1], -1)))
    # Recurrence per chunk, active on rows 0..n-2.
    for c, chunk in enumerate(vk.chunks):
        num = one
        den = one
        for j in chunk:
            v = Sym.col(vk.perm_slots[j])
            num = num * (v + _c(beta * vk.perm_tags[j] % R) * x + _c(gamma))
            den = den * (v + _c(beta) * Sym.col(sigma_slots[j]) + _c(gamma))
        z, z_next = Sym.col(z_slots[c]), Sym.col(z_slots[c], 1)
        cons.append((one - llast) * (z_next * den - z * num))
    # Total product is 1.
    cons.append(llast * (Sym.col(z_slots[-1]) - one))
    return cons


def _c(v) -> Sym:
    """Wrap a scalar as a constant symbol; pass symbols through —
    challenges may arrive as ints (prover/verifier) or as runtime
    symbols (the EVM verifier codegen), and the constraint builders
    must produce identical structure either way."""
    return v if isinstance(v, Sym) else Sym.const(v)


def _theta_compress(values, theta):
    """Σ theta^j · v_j — THE tuple compression for lookups, shared by
    prover and verifier (ints in, int out; Syms in, Sym out)."""
    acc = None
    th = 1
    for v in values:
        if isinstance(v, Sym) or isinstance(th, Sym):
            term = _c(th) * v
        else:
            term = th * (v % R) % R
        acc = term if acc is None else acc + term
        th = th * theta % R
    if acc is None:
        return 0
    return acc if isinstance(acc, Sym) else acc % R


def _lookup_constraints(
    vk: VerifyingKey,
    theta: int,
    beta: int,
    gamma: int,
    lk_a_slots: list[int],
    lk_s_slots: list[int],
    lk_z_slots: list[int],
    l0_slot: int,
    llast_slot: int,
    n_adv_inst: int,
) -> list[Sym]:
    """The lookup argument's constraints (shared prover/verifier):

    for each lookup, with A the selector-gated theta-compressed input,
    T the theta-compressed table, A'/S' the committed permutations and
    Z the grand product over the n-1 active rows:

      l_0·(Z−1);  l_last·(Z−1);
      (1−l_last)·[Z(ωX)(A'+β)(S'+γ) − Z(X)(A+β)(T+γ)];
      l_0·(A'−S');  (1−l_last)·(A'−S')(A'−A'(ω⁻¹X))
    """
    cons: list[Sym] = []
    if not vk.lookups:
        return cons
    one = Sym.const(1)
    l0 = Sym.col(l0_slot)
    llast = Sym.col(llast_slot)
    for i, lk in enumerate(vk.lookups):
        sel = Sym.col(lk.sel_slot)
        # A = sel·(compressed − pad) + pad
        comp = _theta_compress([Sym.col(s) for s in lk.input_slots], theta)
        padc = _theta_compress(lk.pad, theta)
        a_expr = sel * (comp - _c(padc)) + _c(padc)
        t_expr = _theta_compress(
            [Sym.col(n_adv_inst + ti) for ti in lk.table_fixed_idx], theta
        )
        ap, sp_, z = (
            Sym.col(lk_a_slots[i]),
            Sym.col(lk_s_slots[i]),
            Sym.col(lk_z_slots[i]),
        )
        z_next = Sym.col(lk_z_slots[i], 1)
        ap_prev = Sym.col(lk_a_slots[i], -1)
        b, g = _c(beta), _c(gamma)
        cons.append(l0 * (z - one))
        cons.append(llast * (z - one))
        cons.append(
            (one - llast)
            * (z_next * ((ap + b) * (sp_ + g)) - z * ((a_expr + b) * (t_expr + g)))
        )
        cons.append(l0 * (ap - sp_))
        cons.append((one - llast) * (ap - sp_) * (ap - ap_prev))
    return cons


def _opening_entries(vk: VerifyingKey, n_t: int):
    """Deterministic list of (kind, index, rots) for every opened
    polynomial: advice, fixed (incl. selectors), sigma, z, t-chunks."""
    entries = []
    n_adv = len(vk.advice_names)
    n_inst = len(vk.instance_names)
    for i in range(n_adv):
        rots = vk.gate_rots.get(i, ())
        if rots:
            entries.append(("advice", i, rots))
    for i in range(len(vk.fixed_names)):
        slot = n_adv + n_inst + i
        rots = vk.gate_rots.get(slot, ())
        if rots:
            entries.append(("fixed", i, rots))
    for j in range(len(vk.perm_slots)):
        entries.append(("sigma", j, (0,)))
    n_chunks = len(vk.chunks)
    for c in range(n_chunks):
        rots = [0, 1]
        if c < n_chunks - 1:
            rots = [-1, 0, 1]
        entries.append(("z", c, tuple(rots)))
    for i in range(len(vk.lookups)):
        entries.append(("lkA", i, (-1, 0)))
        entries.append(("lkS", i, (0,)))
        entries.append(("lkZ", i, (0, 1)))
    for c in range(n_t):
        entries.append(("t", c, (0,)))
    return entries


def _lagrange_eval(vals: dict[int, int], x: int, k: int) -> int:
    """Evaluate the low-degree extension of sparse row values at x:
    sum_i v_i * L_i(x) with L_i(x) = w^i (x^n - 1) / (n (x - w^i))."""
    n = 1 << k
    w = omega(k)
    zh = (pow(x, n, R) - 1) % R
    if zh == 0:
        # x landed on the domain (negligible probability for a
        # Fiat-Shamir challenge); fall back to direct membership.
        for i, v in vals.items():
            if pow(w, i, R) == x % R:
                return v % R
        return 0
    n_inv = pow(n, R - 2, R)
    acc = 0
    denoms = [(x - pow(w, i, R)) % R for i in vals]
    invs = _batch_inv(denoms)
    for (i, v), inv_d in zip(vals.items(), invs):
        acc = (acc + v * pow(w, i, R) % R * inv_d) % R
    return acc * zh % R * n_inv % R


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------


class _ProveAttribution:
    """Deep attribution for one ``prove()`` call: where did the SNARK
    seconds go?

    Two disjoint layers, attached as closed children of the enclosing
    span (the manager's ``snark``) when the prove finishes:

    - the kernel engines' phase-timer tables (``zk.native.phase_stats``
      and ``zk.graft.phase_stats``: msm / ntt / gate_eval / field_ops /
      srs), each delta'd over the whole prove — the inner loops, with
      call counts, tagged ``engine="native"`` / ``engine="graft"`` so
      the same ``snark -> {msm, ntt, ...}`` children survive a
      ``zk_backend`` switch;
    - per-stage *host residuals* (``witness_gen`` / ``commit`` /
      ``quotient`` / ``open``): each stage's wall-clock minus whatever
      engine time ran inside it, so the stage spans and the engine
      spans partition the prove instead of double counting.

    Without either kernel runtime the engine rows are zero and the
    stage residuals are full stage wall-clock — attribution still sums
    to the prove.  The tables are process-global, so a concurrent
    engine user on another thread (e.g. a concurrent verify) can
    inflate the engine rows of an overlapping prove; attribution is
    diagnostic, not an invariant, and the skew is bounded by that
    request's work.
    """

    def __init__(self) -> None:
        from . import native as zk_native

        self._engines = (("native", zk_native), ("graft", zk_graft))
        self._snap0 = {
            name: mod.phase_stats() for name, mod in self._engines
        }
        self._stages: dict[str, list[float]] = {}  # name -> [host_s, calls]

    @staticmethod
    def _total_seconds(stats: dict[str, dict[str, float]]) -> float:
        return sum(row["seconds"] for row in stats.values())

    def _engine_seconds(self) -> float:
        return sum(
            self._total_seconds(mod.phase_stats()) for _, mod in self._engines
        )

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        n0 = self._engine_seconds()
        try:
            yield
        finally:
            wall = time.perf_counter() - t0
            engine = self._engine_seconds() - n0
            rec = self._stages.setdefault(name, [0.0, 0])
            rec[0] += max(wall - engine, 0.0)
            rec[1] += 1

    def attach(self) -> None:
        """Bridge the attribution into the current span tree (no-op
        outside a span, e.g. direct prove() calls in tests)."""
        for name, mod in self._engines:
            delta = mod.phase_delta(self._snap0[name], mod.phase_stats())
            for phase, row in delta.items():
                if row["calls"] > 0:
                    TRACER.attach_closed(
                        phase, row["seconds"], calls=int(row["calls"]), engine=name
                    )
        for name, (host_s, calls) in self._stages.items():
            TRACER.attach_closed(name, host_s, calls=int(calls), engine="host")


class _CosetEvaluator:
    """Evaluates y-combined constraint programs over the extended coset
    domain, with per-slot lazy materialization and refcounted frees."""

    def __init__(self, k: int, ext_factor: int):
        self.k = k
        self.n = 1 << k
        self.E = ext_factor
        self.ext_k = k + ext_factor.bit_length() - 1
        self.m = 1 << self.ext_k
        self.ext = Domain(self.ext_k)
        self.shift = DELTA
        self._arrays: dict[int, np.ndarray] = {}
        self._coeffs: dict[int, np.ndarray] = {}
        self._shift_pows: np.ndarray | None = None

    def set_coeffs(self, slot: int, coeffs: list[int] | np.ndarray) -> None:
        if not isinstance(coeffs, np.ndarray):
            coeffs = to_limbs_fast(coeffs)
        self._coeffs[slot] = coeffs

    def set_values_ext(self, slot: int, arr: np.ndarray) -> None:
        self._arrays[slot] = arr

    def _coset_fft(self, coeffs: np.ndarray) -> np.ndarray:
        if self._shift_pows is None:
            self._shift_pows = _powers_arr(self.shift, self.m)
        arr = np.zeros((self.m, 4), dtype=np.uint64)
        arr[: coeffs.shape[0]] = coeffs
        _vec_mul_arr(arr, self._shift_pows, arr)
        return self.ext.ntt_limbs(arr, self.ext.omega, False)

    def array(self, slot: int) -> np.ndarray:
        if slot not in self._arrays:
            self._arrays[slot] = self._coset_fft(self._coeffs.pop(slot))
        return self._arrays[slot]

    def free(self, slot: int) -> None:
        self._arrays.pop(slot, None)

    def run(self, sym: Sym, acc: np.ndarray | None) -> np.ndarray:
        """Evaluate sym over the coset; add into acc (canonical limbs)."""
        used = sorted(sym.used_cols())
        local = {}
        for slot, _rot in used:
            if slot not in local:
                local[slot] = len(local)
        lib = _native_lib()
        if lib is not None:
            import ctypes

            const_pool: dict[int, int] = {}
            code: list[int] = []
            depth = linearize(sym, local, const_pool, code)
            assert depth <= 150, f"gate program too deep: {depth}"
            # Pointer table instead of an np.stack copy: each column is
            # passed as its own (m,4) C-contiguous array.
            arrays = [np.ascontiguousarray(self.array(slot)) for slot in local]
            ptrs = (ctypes.c_void_p * len(arrays))(
                *[a.ctypes.data for a in arrays]
            )
            consts = sorted(const_pool, key=const_pool.get)
            out = np.empty((self.m, 4), dtype=np.uint64)
            carr = to_limbs(consts) if consts else np.zeros((1, 4), dtype=np.uint64)
            code_arr = np.asarray(code, dtype=np.int64)
            from .native import _iptr

            rc = lib.zk_eval_program2(
                self.m,
                len(arrays),
                ptrs,
                self.E,
                _iptr(code_arr),
                len(code_arr),
                _ptr(carr),
                len(consts),
                _ptr(out),
            )
            assert rc == 0, "gate program rejected by native evaluator"
            if acc is None:
                return out
            lib.zk_vec_add(_ptr(acc), _ptr(out), _ptr(acc), self.m)
            return acc
        # Pure-Python fallback (small circuits only).
        cols = {slot: from_limbs_fast(self.array(slot)) for slot in local}
        out_vals = []
        for i in range(self.m):
            def getval(slot, rot, _i=i):
                return cols[slot][(_i + rot * self.E) % self.m]

            out_vals.append(sym_eval(sym, getval, {}))
        arr = to_limbs_fast(out_vals)
        if acc is None:
            return arr
        vals = from_limbs_fast(acc)
        summed = [(a + b) % R for a, b in zip(vals, out_vals)]
        return to_limbs_fast(summed)


def prove(
    pk: ProvingKey,
    cs: ConstraintSystem,
    instances: dict[str, list[int]] | list[int],
    seed: bytes | None = None,
    transcript: str = "poseidon",
) -> bytes:
    """Produce a PLONK proof that ``cs``'s trace satisfies the compiled
    circuit with the given public inputs."""
    vk = pk.vk
    k, n = vk.k, vk.n
    domain = Domain(k)
    srs = vk.srs
    advice, instance_cols, fixed = _classify_columns(cs)
    assert [c.name for c in advice] == vk.advice_names, "circuit/key mismatch"
    assert [c.name for c in instance_cols] == vk.instance_names
    assert cs.n_rows <= n - 1, "circuit overflows reserved last row"

    inst_map = _canon_instances(vk, instances)
    for col in instance_cols:
        vals = inst_map[col.name]
        for row, v in cs.trace[col].items():
            assert vals[row] == v % R, "instance values disagree with trace"

    rng = secrets.SystemRandom() if seed is None else __import__("random").Random(seed)
    # Deep attribution: native engine phase deltas + host
    # stage residuals, attached under the enclosing snark span.
    att = _ProveAttribution()

    def blind(coeffs: np.ndarray, n_blind: int) -> np.ndarray:
        """p + r(X)·Z_H with r random of n_blind coefficients.  The mask
        vanishes on the domain, so constraints are untouched; n_blind
        must be ≥ the number of rotations the polynomial is opened at,
        or the revealed evaluations over-determine the mask.  Operates
        on (len, 4) canonical-limb arrays; only the 2·n_blind touched
        rows round-trip through Python ints."""
        out = np.zeros((n + n_blind, 4), dtype=np.uint64)
        out[: coeffs.shape[0]] = coeffs
        for i in range(n_blind):
            b = rng.randrange(R)
            _set_row(out, i, (_row_int(out, i) - b) % R)
            _set_row(out, n + i, (_row_int(out, n + i) + b) % R)
        return out

    # Column value tables (n evals).
    def col_values(col: Column) -> list[int]:
        vals = [0] * n
        for row, v in cs.trace[col].items():
            vals[row] = v
        return vals

    advice_values = [col_values(c) for c in advice]
    instance_values = [
        list(inst_map[c.name]) + [0] * (n - len(inst_map[c.name]))
        for c in instance_cols
    ]

    transcript = _TRANSCRIPTS[transcript][0]()
    with att.stage("transcript"):
        transcript.common_scalar(vk.digest)
        for name in vk.instance_names:
            for v in inst_map[name]:
                transcript.common_scalar(v)

    slot_values: dict[int, list[int]] = {}
    n_adv, n_inst = len(advice), len(instance_cols)
    for i, vals in enumerate(advice_values):
        slot_values[i] = vals
    for i, vals in enumerate(instance_values):
        slot_values[n_adv + i] = vals
    for i, vals in enumerate(pk.fixed_values):
        slot_values[n_adv + n_inst + i] = vals

    # Round 1: advice commitments.  Zero-knowledge needs one blinder more
    # than the number of opening points, so derive the count from the
    # rotations each column is actually opened at instead of assuming 2.
    with att.stage("witness_gen"):
        advice_polys = [
            blind(domain.ifft_arr(v), len(vk.gate_rots.get(i, ())) + 1)
            for i, v in enumerate(advice_values)
        ]
    with att.stage("commit"):
        for c in srs.commit_batch(advice_polys):
            transcript.write_point(c)

    # Round 1.5: lookup permutations (Halo2 ordering: theta after
    # advice, A'/S' commitments before beta/gamma).
    with att.stage("transcript"):
        theta = transcript.squeeze_challenge() if vk.lookups else 0
    lk_a_vals: list[list[int]] = []  # compressed selector-gated inputs
    lk_t_vals: list[list[int]] = []  # compressed table
    lk_ap_vals: list[list[int]] = []  # A' (sorted input)
    lk_sp_vals: list[list[int]] = []  # S' (table permutation)
    lk_ap_polys: list[list[int]] = []
    lk_sp_polys: list[list[int]] = []
    with att.stage("witness_gen"):
        for lk in vk.lookups:
            sel_vals = slot_values[lk.sel_slot]
            padc = _theta_compress(lk.pad, theta)
            a_comp = [
                _theta_compress([slot_values[s][i] for s in lk.input_slots], theta)
                if sel_vals[i]
                else padc
                for i in range(n)
            ]
            t_comp = [
                _theta_compress(
                    [pk.fixed_values[ti][i] for ti in lk.table_fixed_idx], theta
                )
                for i in range(n)
            ]
            # Sort the active rows; build S' giving each first occurrence
            # its table copy.
            a_sorted = sorted(a_comp[: n - 1])
            remaining = Counter(t_comp[: n - 1])
            s_prime = [None] * (n - 1)
            fill_rows = []
            for i, val in enumerate(a_sorted):
                if i == 0 or val != a_sorted[i - 1]:
                    if remaining[val] <= 0:
                        raise AssertionError(
                            f"lookup {lk.name}: input {val:#x} not in table"
                        )
                    remaining[val] -= 1
                    s_prime[i] = val
                else:
                    fill_rows.append(i)
            leftovers = [v for v, c in sorted(remaining.items()) for _ in range(c)]
            assert len(leftovers) == len(fill_rows)
            for i, v in zip(fill_rows, leftovers):
                s_prime[i] = v
            lk_a_vals.append(a_comp)
            lk_t_vals.append(t_comp)
            lk_ap_vals.append(a_sorted + [0])
            lk_sp_vals.append(list(s_prime) + [0])
            ap_poly = blind(domain.ifft_arr(a_sorted + [0]), 3)
            sp_poly = blind(domain.ifft_arr(list(s_prime) + [0]), 3)
            lk_ap_polys.append(ap_poly)
            lk_sp_polys.append(sp_poly)
            transcript.write_point(srs.commit(ap_poly))
            transcript.write_point(srs.commit(sp_poly))

    with att.stage("transcript"):
        beta = transcript.squeeze_challenge()
        gamma = transcript.squeeze_challenge()

    with att.stage("witness_gen"):
        z_polys: list[list[int]] = []
        z_values: list[list[int]] = []
        start = 1
        for chunk in vk.chunks:  # within witness_gen accounting: host loop
            nums, dens = [1] * n, [1] * n
            for j in chunk:
                vals = slot_values[vk.perm_slots[j]]
                tag = vk.perm_tags[j]
                sig = pk.sigma_values[j]
                for i in range(n - 1):
                    nums[i] = (
                        nums[i] * ((vals[i] + beta * tag % R * pk.row_tags[i] + gamma) % R) % R
                    )
                    dens[i] = dens[i] * ((vals[i] + beta * sig[i] + gamma) % R) % R
            den_inv = _batch_inv(dens[: n - 1])
            z = [0] * n
            z[0] = start
            for i in range(n - 1):
                z[i + 1] = z[i] * nums[i] % R * den_inv[i] % R
            start = z[n - 1]
            z_values.append(z)
            # z is opened at up to 3 rotations (−1, 0, 1); 4 blinders.
            z_polys.append(blind(domain.ifft_arr(z), 4))
        if vk.chunks:
            assert start == 1, "permutation product != 1 (copy constraints broken?)"
    with att.stage("commit"):
        for c in srs.commit_batch(z_polys):
            transcript.write_point(c)

    with att.stage("witness_gen"):
        # Lookup grand products Z_i over the active rows.
        lk_z_polys: list[list[int]] = []
        for li in range(len(vk.lookups)):
            a_comp, t_comp = lk_a_vals[li], lk_t_vals[li]
            ap, sp_ = lk_ap_vals[li], lk_sp_vals[li]
            dens = [
                (ap[i] + beta) % R * ((sp_[i] + gamma) % R) % R for i in range(n - 1)
            ]
            den_inv = _batch_inv(dens)
            z = [0] * n
            z[0] = 1
            for i in range(n - 1):
                num = (a_comp[i] + beta) % R * ((t_comp[i] + gamma) % R) % R
                z[i + 1] = z[i] * num % R * den_inv[i] % R
            assert z[n - 1] == 1, "lookup product != 1 (input not a table subset?)"
            lk_z_polys.append(blind(domain.ifft_arr(z), 3))
            transcript.write_point(srs.commit(lk_z_polys[-1]))
    with att.stage("transcript"):
        y = transcript.squeeze_challenge()

    # Round 3: quotient.
    _quotient_stage = att.stage("quotient")
    _quotient_stage.__enter__()
    ev = _CosetEvaluator(k, vk.ext_factor)
    n_fixed = len(vk.fixed_names)
    base_slots = n_adv + n_inst + n_fixed
    sigma_slots = [base_slots + j for j in range(len(vk.perm_slots))]
    z_slots = [base_slots + len(sigma_slots) + c for c in range(len(vk.chunks))]
    x_slot = base_slots + len(sigma_slots) + len(z_slots)
    l0_slot, llast_slot = x_slot + 1, x_slot + 2
    n_lk = len(vk.lookups)
    lk_a_slots = [llast_slot + 1 + i for i in range(n_lk)]
    lk_s_slots = [llast_slot + 1 + n_lk + i for i in range(n_lk)]
    lk_z_slots = [llast_slot + 1 + 2 * n_lk + i for i in range(n_lk)]

    for i, p in enumerate(advice_polys):
        ev.set_coeffs(i, p)
    for i, vals in enumerate(instance_values):
        ev.set_coeffs(n_adv + i, domain.ifft_arr(vals))
    for i in range(len(pk.fixed_polys)):
        if pk.fixed_cosets:
            ev.set_values_ext(n_adv + n_inst + i, pk.fixed_cosets[i])
        else:
            ev.set_coeffs(n_adv + n_inst + i, pk.fixed_polys[i])
    for j in range(len(pk.sigma_polys)):
        if pk.sigma_cosets:
            ev.set_values_ext(sigma_slots[j], pk.sigma_cosets[j])
        else:
            ev.set_coeffs(sigma_slots[j], pk.sigma_polys[j])
    for c, p in enumerate(z_polys):
        ev.set_coeffs(z_slots[c], p)
    # Aux columns: X, l0, l_last on the coset.
    m = ev.m
    x_arr = _powers_arr(ev.ext.omega, m)
    shift_arr = np.broadcast_to(to_limbs([ev.shift]), (m, 4))
    x_out = np.empty((m, 4), dtype=np.uint64)
    _vec_mul_arr(x_arr, np.ascontiguousarray(shift_arr), x_out)
    ev.set_values_ext(x_slot, x_out)
    e0, elast = [0] * n, [0] * n
    e0[0] = 1
    elast[n - 1] = 1
    ev.set_coeffs(l0_slot, domain.ifft_arr(e0))
    ev.set_coeffs(llast_slot, domain.ifft_arr(elast))
    for i in range(n_lk):
        ev.set_coeffs(lk_a_slots[i], lk_ap_polys[i])
        ev.set_coeffs(lk_s_slots[i], lk_sp_polys[i])
        ev.set_coeffs(lk_z_slots[i], lk_z_polys[i])

    # y-combined constraint programs: one per gate, then permutation.
    programs: list[Sym] = []
    y_pow = 0
    for spec in vk.gates:
        combined = None
        for con in spec.constraints:
            term = Sym.const(pow(y, y_pow, R)) * con
            combined = term if combined is None else combined + term
            y_pow += 1
        programs.append(Sym.col(spec.sel_slot) * combined)
    for con in _perm_constraints(
        vk, beta, gamma, z_slots, sigma_slots, x_slot, l0_slot, llast_slot
    ):
        programs.append(Sym.const(pow(y, y_pow, R)) * con)
        y_pow += 1
    for con in _lookup_constraints(
        vk,
        theta,
        beta,
        gamma,
        lk_a_slots,
        lk_s_slots,
        lk_z_slots,
        l0_slot,
        llast_slot,
        n_adv + n_inst,
    ):
        programs.append(Sym.const(pow(y, y_pow, R)) * con)
        y_pow += 1

    # Refcount slots across programs for early frees (per unique slot
    # per program, matching the per-program decrement below).  Measured:
    # merging all programs into one evaluator pass is ~7% slower than
    # per-program passes (bigger working set per point), so keep them
    # separate.
    need: dict[int, int] = {}
    for prog in programs:
        for slot in {s for s, _ in prog.used_cols()}:
            need[slot] = need.get(slot, 0) + 1
    acc: np.ndarray | None = None
    for prog in programs:
        acc = ev.run(prog, acc)
        for slot in {s for s, _ in prog.used_cols()}:
            need[slot] -= 1
            if need[slot] == 0:
                ev.free(slot)

    # Divide by Z_H on the coset (E-periodic values).
    E = ev.E
    zh_period = [
        (pow(ev.shift, n, R) * pow(ev.ext.omega, (n * e) % m, R) - 1) % R
        for e in range(E)
    ]
    zh_inv = _batch_inv(zh_period)
    zh_tile = to_limbs_fast([zh_inv[i % E] for i in range(m)])
    if acc is None:
        acc = np.zeros((m, 4), dtype=np.uint64)
    _vec_mul_arr(acc, zh_tile, acc)
    t_arr = ev.ext.ntt_limbs(acc, ev.ext.omega_inv, True)
    shift_inv = pow(ev.shift, R - 2, R)
    sp_arr = _powers_arr(shift_inv, m)
    _vec_mul_arr(t_arr, sp_arr, t_arr)
    nz = np.nonzero(t_arr.any(axis=1))[0]
    t_limbs = t_arr[: int(nz[-1]) + 1] if nz.size else t_arr[:1]
    t_chunks = [t_limbs[i : i + n] for i in range(0, t_limbs.shape[0], n)]
    _quotient_stage.__exit__(None, None, None)
    with att.stage("commit"):
        for c in srs.commit_batch([np.ascontiguousarray(ch) for ch in t_chunks]):
            transcript.write_point(c)
    with att.stage("transcript"):
        x = transcript.squeeze_challenge()

    # Round 4: evaluations.
    entries = _opening_entries(vk, len(t_chunks))
    w = domain.omega

    def poly_of(kind: str, idx: int) -> np.ndarray:
        if kind == "advice":
            return advice_polys[idx]
        if kind == "fixed":
            return pk.fixed_polys[idx]
        if kind == "sigma":
            return pk.sigma_polys[idx]
        if kind == "z":
            return z_polys[idx]
        if kind == "lkA":
            return lk_ap_polys[idx]
        if kind == "lkS":
            return lk_sp_polys[idx]
        if kind == "lkZ":
            return lk_z_polys[idx]
        return t_chunks[idx]

    evals: dict[tuple[str, int, int], int] = {}
    with att.stage("open"):
        for kind, idx, rots in entries:
            p = poly_of(kind, idx)
            for rot in rots:
                pt = (
                    x * pow(w, rot, R) % R
                    if rot >= 0
                    else x * pow(domain.omega_inv, -rot, R) % R
                )
                val = _poly_eval_arr(p, pt)
                evals[(kind, idx, rot)] = val
                transcript.write_scalar(val)
    with att.stage("transcript"):
        v = transcript.squeeze_challenge()

    # Round 5: batched openings, one witness per rotation point.
    all_rots = sorted({rot for _, _, rots in entries for rot in rots})
    with att.stage("open"):
        for rot in all_rots:
            pt = (
                x * pow(w, rot, R) % R
                if rot >= 0
                else x * pow(domain.omega_inv, -rot, R) % R
            )
            group = [e for e in entries if rot in e[2]]
            max_len = max(poly_of(k, i).shape[0] for k, i, _ in group)
            agg = np.zeros((max_len, 4), dtype=np.uint64)
            v_pow = 1
            for kind, idx, _rots in group:
                _scale_add_arr(agg, poly_of(kind, idx), v_pow)
                v_pow = v_pow * v % R
            witness = _div_linear_arr(agg, pt)
            transcript.write_point(srs.commit(witness))

    att.attach()
    return transcript.finalize()


def _canon_instances(
    vk: VerifyingKey, instances: dict[str, list[int]] | list[int]
) -> dict[str, list[int]]:
    if isinstance(instances, dict):
        m = {k: [v % R for v in vals] for k, vals in instances.items()}
    else:
        assert len(vk.instance_names) <= 1, "multiple instance columns need a dict"
        m = {name: [v % R for v in instances] for name in vk.instance_names}
        if not vk.instance_names:
            assert not instances
    assert set(m) == set(vk.instance_names), "instance column mismatch"
    return m


# ---------------------------------------------------------------------------
# Verifier
# ---------------------------------------------------------------------------


def quotient_chunks(vk: VerifyingKey, proof_len: int) -> int:
    """Quotient-chunk count inferred from a proof's byte length — THE
    shared inference (Python verifier and EVM codegen must agree)."""
    pre_words = 2 * vk.n_advice + 6 * len(vk.lookups) + 2 * len(vk.chunks)
    entries_fixed = _opening_entries(vk, 0)
    n_evals_fixed = sum(len(rots) for _, _, rots in entries_fixed)
    rot_set = {rot for _, _, rots in entries_fixed for rot in rots}
    rot_set.add(0)
    remaining = proof_len - 32 * pre_words
    # Each t-chunk adds: 64 (commit) + 32 (eval). Fixed tail: evals + witnesses.
    fixed_tail = n_evals_fixed * 32 + len(rot_set) * 64
    return (remaining - fixed_tail) // 96


def verify(
    vk: VerifyingKey,
    instances: dict[str, list[int]] | list[int],
    proof: bytes,
    transcript: str = "poseidon",
) -> bool:
    _TRANSCRIPTS[transcript]  # unknown backend name must raise, not "invalid proof"
    try:
        return _verify_inner(vk, instances, proof, transcript) is True
    except (ValueError, AssertionError, IndexError, KeyError):
        return False


def verify_deferred(
    vk: VerifyingKey,
    instances: dict[str, list[int]] | list[int],
    proof: bytes,
    transcript: str = "poseidon",
):
    """Run every verifier check EXCEPT the final pairing; returns the
    accumulator pair (B, A) satisfying e(B, g2) == e(A, tau_g2) iff the
    proof is valid, or None when any non-pairing check fails.  The
    batch-verification primitive behind proof aggregation (the reference's
    snark-verifier NativeLoader accumulation, verifier/aggregator.rs)."""
    _TRANSCRIPTS[transcript]
    try:
        out = _verify_inner(vk, instances, proof, transcript, defer_pairing=True)
    except (ValueError, AssertionError, IndexError, KeyError):
        return None
    return out if isinstance(out, tuple) else None


def _verify_inner(
    vk, instances, proof, transcript: str = "poseidon", defer_pairing: bool = False
):
    k, n = vk.k, vk.n
    domain = Domain(k)
    w = domain.omega
    inst_map = _canon_instances(vk, instances)

    t = _TRANSCRIPTS[transcript][1](proof)
    t.common_scalar(vk.digest)
    for name in vk.instance_names:
        for v in inst_map[name]:
            t.common_scalar(v)

    advice_commits = [t.read_point() for _ in vk.advice_names]
    theta = t.squeeze_challenge() if vk.lookups else 0
    lk_ap_commits, lk_sp_commits = [], []
    for _ in vk.lookups:
        lk_ap_commits.append(t.read_point())
        lk_sp_commits.append(t.read_point())
    beta = t.squeeze_challenge()
    gamma = t.squeeze_challenge()
    z_commits = [t.read_point() for _ in vk.chunks]
    lk_z_commits = [t.read_point() for _ in vk.lookups]
    y = t.squeeze_challenge()

    # t-chunk count is bounded by the extension factor (plus blinding
    # spill); read points until the count the prover committed.  The
    # count is recoverable because it is the only variable-length
    # section: infer from remaining length after fixing the rest.
    n_t = quotient_chunks(vk, len(proof))
    if n_t < 1 or n_t > 4 * vk.ext_factor:
        return False
    t_commits = [t.read_point() for _ in range(n_t)]
    x = t.squeeze_challenge()
    if pow(x, n, R) == 1:
        return False  # challenge on the domain: openings would be degenerate

    entries = _opening_entries(vk, n_t)
    evals: dict[tuple[str, int, int], int] = {}
    for kind, idx, rots in entries:
        for rot in rots:
            evals[(kind, idx, rot)] = t.read_scalar()
    v = t.squeeze_challenge()
    all_rots = sorted({rot for _, _, rots in entries for rot in rots})
    witnesses = {rot: t.read_point() for rot in all_rots}
    u = t.squeeze_challenge()
    if t._off != len(proof):
        return False  # trailing bytes

    # -- constraint check at x -----------------------------------------
    n_adv, n_inst, n_fixed = (
        len(vk.advice_names),
        len(vk.instance_names),
        len(vk.fixed_names),
    )
    base_slots = n_adv + n_inst + n_fixed
    sigma_slots = [base_slots + j for j in range(len(vk.perm_slots))]
    z_slots = [base_slots + len(sigma_slots) + c for c in range(len(vk.chunks))]
    x_slot = base_slots + len(sigma_slots) + len(z_slots)
    l0_slot, llast_slot = x_slot + 1, x_slot + 2
    n_lk = len(vk.lookups)
    lk_a_slots = [llast_slot + 1 + i for i in range(n_lk)]
    lk_s_slots = [llast_slot + 1 + n_lk + i for i in range(n_lk)]
    lk_z_slots = [llast_slot + 1 + 2 * n_lk + i for i in range(n_lk)]

    zh = (pow(x, n, R) - 1) % R
    n_inv = pow(n, R - 2, R)

    def lagrange_at(i: int) -> int:
        wi = pow(w, i, R)
        return wi * zh % R * n_inv % R * pow((x - wi) % R, R - 2, R) % R

    l0_val, llast_val = lagrange_at(0), lagrange_at(n - 1)
    inst_evals = {}
    for ci, name in enumerate(vk.instance_names):
        vals = {i: val for i, val in enumerate(inst_map[name]) if val}
        inst_evals[ci] = _lagrange_eval(vals, x, k)

    def getval(slot: int, rot: int) -> int:
        if slot == x_slot:
            assert rot == 0
            return x
        if slot == l0_slot:
            return l0_val
        if slot == llast_slot:
            return llast_val
        if slot < n_adv:
            return evals[("advice", slot, rot)]
        if slot < n_adv + n_inst:
            assert rot == 0, "instance rotations unsupported"
            return inst_evals[slot - n_adv]
        if slot < base_slots:
            return evals[("fixed", slot - n_adv - n_inst, rot)]
        if slot in sigma_slots:
            return evals[("sigma", slot - base_slots, rot)]
        if slot in lk_a_slots:
            return evals[("lkA", lk_a_slots.index(slot), rot)]
        if slot in lk_s_slots:
            return evals[("lkS", lk_s_slots.index(slot), rot)]
        if slot in lk_z_slots:
            return evals[("lkZ", lk_z_slots.index(slot), rot)]
        c = z_slots.index(slot)
        return evals[("z", c, rot)]

    combined = 0
    y_pow = 0
    memo: dict = {}
    for spec in vk.gates:
        sel = getval(spec.sel_slot, 0)
        for con in spec.constraints:
            term = sel * sym_eval(con, getval, memo) % R
            combined = (combined + pow(y, y_pow, R) * term) % R
            y_pow += 1
    for con in _perm_constraints(
        vk, beta, gamma, z_slots, sigma_slots, x_slot, l0_slot, llast_slot
    ):
        combined = (combined + pow(y, y_pow, R) * sym_eval(con, getval, {})) % R
        y_pow += 1
    for con in _lookup_constraints(
        vk,
        theta,
        beta,
        gamma,
        lk_a_slots,
        lk_s_slots,
        lk_z_slots,
        l0_slot,
        llast_slot,
        n_adv + n_inst,
    ):
        combined = (combined + pow(y, y_pow, R) * sym_eval(con, getval, {})) % R
        y_pow += 1

    t_eval = 0
    xn = pow(x, n, R)
    for c in range(n_t - 1, -1, -1):
        t_eval = (t_eval * xn + evals[("t", c, 0)]) % R
    if combined != t_eval * zh % R:
        return False

    # -- KZG batch opening check ---------------------------------------
    def commit_of(kind: str, idx: int) -> G1:
        if kind == "advice":
            return advice_commits[idx]
        if kind == "fixed":
            return vk.fixed_commits[idx]
        if kind == "sigma":
            return vk.sigma_commits[idx]
        if kind == "z":
            return z_commits[idx]
        if kind == "lkA":
            return lk_ap_commits[idx]
        if kind == "lkS":
            return lk_sp_commits[idx]
        if kind == "lkZ":
            return lk_z_commits[idx]
        return t_commits[idx]

    from .fields import pairing_check

    A = G1(0, 0)  # sum u^g W_g
    B = G1(0, 0)  # sum u^g (F_g - E_g*G + x_g*W_g)
    u_pow = 1
    for rot in all_rots:
        pt = (
            x * pow(w, rot, R) % R
            if rot >= 0
            else x * pow(domain.omega_inv, -rot, R) % R
        )
        F_scalars, F_points = [], []
        E_val = 0
        v_pow = 1
        for kind, idx, rots in entries:
            if rot not in rots:
                continue
            F_scalars.append(v_pow)
            F_points.append(commit_of(kind, idx))
            E_val = (E_val + v_pow * evals[(kind, idx, rot)]) % R
            v_pow = v_pow * v % R
        W = witnesses[rot]
        F = msm(F_scalars, F_points)
        term = F.add(GENERATOR.mul((-E_val) % R)).add(W.mul(pt))
        B = B.add(term.mul(u_pow) if u_pow != 1 else term)
        A = A.add(W.mul(u_pow) if u_pow != 1 else W)
        u_pow = u_pow * u % R
    srs = vk.srs
    if defer_pairing:
        return (B, A)
    return pairing_check([(B, srs.g2), (A.neg(), srs.tau_g2)])
