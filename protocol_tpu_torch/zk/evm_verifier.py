"""EVM verifier contract generation for PLONK proofs.

The port of ``protocol_tpu/zk/evm_verifier.py``: the constraints compile
from this package's PLONK constraint functions (``zk.plonk``), and the runtime
bytes and the ``et_verifier.bin`` artifact format equal the
reference's, so ``data/et_verifier.bin`` loads in either package.

The analog of the reference's ``gen_evm_verifier_code`` →
``compile_yul`` → ``evm_verify`` pipeline (circuit/src/verifier/
mod.rs:94-134): given a compiled verifying key, emit runtime EVM
bytecode that verifies keccak-transcript proofs fully in-contract —
transcript replay with KECCAK256, point/scalar canonicality checks,
gate + permutation + lookup constraint evaluation at the challenge
(compiled straight from the same Sym constraint functions the Python
prover/verifier use, so the three can never diverge), the quotient
check, and the GWC batch-opening pairing check through precompiles
0x06/0x07/0x08 (field inverses via 0x05 modexp).

Calldata layout (matching the reference's EtVerifierWrapper forwarding
of ``pub_ins ‖ proof``, EtVerifierWrapper.sol:35-89): instance values
as 32-byte big-endian words in verifying-key column order, then the
proof bytes exactly as produced by ``plonk.prove(...,
transcript="keccak")``.  On acceptance the contract returns one word 1;
any malformed or invalid proof reverts.

The generated contract is straight-line (no loops), so large circuits
exceed mainnet's EIP-170 code-size cap — fine for the in-process EVM
this framework ships (and for gas measurement); a public-chain deploy
would need the looped/chunked layout.

Stack conventions (both this generator and the interpreter follow real
EVM semantics): binary ops consume the TOP as their first operand, so
``ADDMOD(a, b, m)`` is emitted as push-m, push-b, push-a; ``SUB``
computes top − next.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..evm.machine import asm
from .bn254 import GENERATOR
from .plonk import (
    R,
    Domain,
    Sym,
    VerifyingKey,
    _lookup_constraints,
    _opening_entries,
    _perm_constraints,
)
from .rns import FQ_MODULUS as Q

# -- static memory map -------------------------------------------------

M_R = 0x000
M_Q = 0x020
ECIN = 0x040  # 4 words: ecAdd input (ecMul uses 3)
ECOUT = 0x0C0  # 2 words
PAIR = 0x100  # 12 words
ACC_A = 0x280  # 2 words
ACC_B = 0x2C0  # 2 words
MODEXP_IN = 0x300  # 6 words
MODEXP_OUT = 0x3C0
T_STATE = 0x400
T_PEND = 0x420


def infer_n_t(vk: VerifyingKey, proof: bytes) -> int:
    """Quotient-chunk count from a sample proof's byte length — the
    Python verifier's own inference, re-exported for codegen callers."""
    from .plonk import quotient_chunks

    n_t = quotient_chunks(vk, len(proof))
    assert n_t >= 1, "proof too short"
    return n_t


@dataclass
class GeneratedVerifier:
    runtime: bytes
    n_t: int
    calldata_len: int

    MAGIC = b"ETVRFY01"

    def calldata(self, pub_ins: list[int], proof: bytes) -> bytes:
        out = b"".join((v % R).to_bytes(32, "big") for v in pub_ins)
        return out + proof

    def to_bytes(self) -> bytes:
        """The et_verifier.bin artifact format (data/et_verifier.bin
        analog): magic, n_t, expected calldata length, runtime code."""
        return (
            self.MAGIC
            + self.n_t.to_bytes(4, "little")
            + self.calldata_len.to_bytes(4, "little")
            + self.runtime
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "GeneratedVerifier":
        if data[:8] != cls.MAGIC:
            raise ValueError("bad verifier artifact magic")
        n_t = int.from_bytes(data[8:12], "little")
        calldata_len = int.from_bytes(data[12:16], "little")
        return cls(runtime=data[16:], n_t=n_t, calldata_len=calldata_len)


class _Gen:
    def __init__(self):
        self.items: list = []
        self.consts: dict[int, int] = {}  # raw 256-bit value -> blob index
        self._labels = 0
        self.slot_top = 0

    def emit(self, *items):
        self.items.extend(items)

    def label(self) -> str:
        self._labels += 1
        return f"L{self._labels}"

    def mload(self, off: int):
        self.emit(off, "MLOAD")

    def mstore(self, off: int):
        """Stack [value] -> mem[off]."""
        self.emit(off, "MSTORE")

    def cdload(self, off: int):
        self.emit(off, "CALLDATALOAD")

    def const(self, value: int):
        """Push a pooled constant via the data blob (raw, NOT reduced —
        the pool holds Fr scalars and Fq coordinates alike)."""
        assert 0 <= value < (1 << 256)
        idx = self.consts.setdefault(value, len(self.consts))
        self.emit(("cref", idx))

    def alloc_slot(self) -> int:
        off = self.slot_top
        self.slot_top += 32
        return off

    def require(self):
        """Stack [cond]: revert when zero."""
        ok = self.label()
        self.emit(("ref", ok), "JUMPI", 0, 0, "REVERT", ("label", ok))


def generate_evm_verifier(
    vk: VerifyingKey, n_t: int, n_instance_values: int, _debug: str | None = None
) -> GeneratedVerifier:
    """Emit runtime bytecode verifying this circuit's keccak-flow
    proofs; ``n_instance_values`` fixes the public-input word count.
    ``_debug``: name of an internal slot (e.g. "combined", "x") to
    RETURN right after constraint evaluation instead of verifying —
    codegen diagnosis only."""
    assert len(vk.instance_names) == 1, "expects exactly one instance column"
    g = _Gen()
    domain = Domain(vk.k)
    n, w, w_inv = vk.n, domain.omega, domain.omega_inv
    n_inv = pow(n, R - 2, R)

    entries = _opening_entries(vk, n_t)
    all_rots = sorted({rot for _, _, rots in entries for rot in rots})

    # ---- static calldata layout ---------------------------------------
    inst_words = n_instance_values
    off = 32 * inst_words
    layout: dict[tuple, int] = {}

    def take(words: int) -> int:
        nonlocal off
        o = off
        off += 32 * words
        return o

    for i in range(vk.n_advice):
        layout[("commit", "advice", i)] = take(2)
    for i in range(len(vk.lookups)):
        layout[("commit", "lkA", i)] = take(2)
        layout[("commit", "lkS", i)] = take(2)
    for c in range(len(vk.chunks)):
        layout[("commit", "z", c)] = take(2)
    for i in range(len(vk.lookups)):
        layout[("commit", "lkZ", i)] = take(2)
    for c in range(n_t):
        layout[("commit", "t", c)] = take(2)
    n_evals = 0
    for kind, idx, rots in entries:
        for rot in rots:
            layout[("eval", kind, idx, rot)] = take(1)
            n_evals += 1
    for rot in all_rots:
        layout[("commit", "W", rot)] = take(2)
    calldata_len = off

    # ---- slot allocation ----------------------------------------------
    max_pend = max(
        32 * (1 + inst_words) + 64 * vk.n_advice,  # digest+inst+advice run
        64 * 2 * len(vk.lookups),
        64 * (len(vk.chunks) + len(vk.lookups)),
        64 * n_t,
        32 * n_evals,
        64 * len(all_rots),
    )
    g.slot_top = T_PEND + max_pend + 32

    S = {
        name: g.alloc_slot()
        for name in (
            "theta", "beta", "gamma", "y", "x", "v", "u",
            "xn", "zh", "l0", "llast", "combined", "y_pow", "t_eval",
            "v_pow", "u_pow", "E", "x_g", "F", "F2", "term", "term2",
            "dbg_gates", "dbg_perm",
        )
    }
    assert S["F2"] == S["F"] + 32 and S["term2"] == S["term"] + 32
    inst_eval_slot = g.alloc_slot()

    # ---- init ---------------------------------------------------------
    g.emit(R)
    g.mstore(M_R)
    g.emit(Q)
    g.mstore(M_Q)
    g.emit(calldata_len, "CALLDATASIZE", "EQ")
    g.require()

    # ---- transcript replay --------------------------------------------
    pending = [0]

    def absorb(load):
        load()
        g.mstore(T_PEND + pending[0])
        pending[0] += 32

    def squeeze(dest: int):
        g.emit(32 + pending[0], T_STATE, "KECCAK256")
        g.emit("DUP1")
        g.mstore(T_STATE)
        g.mload(M_R)
        g.emit("SWAP1", "MOD")  # [R, digest] -> digest % R
        g.mstore(dest)
        pending[0] = 0

    def check_scalar(o: int):
        g.mload(M_R)
        g.cdload(o)
        g.emit("LT")  # top(x) < next(R)
        g.require()

    def check_point(o: int):
        g.mload(M_Q)
        g.cdload(o)
        g.emit("LT")
        g.mload(M_Q)
        g.cdload(o + 32)
        g.emit("LT", "AND")
        g.require()
        # y^2 == x^3 + 3 (mod Q), or (x, y) == (0, 0)
        g.mload(M_Q)
        g.emit(3)
        g.mload(M_Q)
        g.mload(M_Q)
        g.cdload(o)
        g.cdload(o)
        g.emit("MULMOD")  # x^2
        g.cdload(o)
        g.emit("MULMOD")  # x^3
        g.emit("ADDMOD")  # x^3 + 3
        g.mload(M_Q)
        g.cdload(o + 32)
        g.cdload(o + 32)
        g.emit("MULMOD")  # y^2
        g.emit("EQ")
        g.cdload(o)
        g.emit("ISZERO")
        g.cdload(o + 32)
        g.emit("ISZERO", "AND", "OR")
        g.require()

    def absorb_point(o: int):
        check_point(o)
        absorb(lambda: g.cdload(o))
        absorb(lambda: g.cdload(o + 32))

    absorb(lambda: g.const(vk.digest))
    for i in range(inst_words):
        check_scalar(32 * i)
        absorb(lambda o=32 * i: g.cdload(o))
    for i in range(vk.n_advice):
        absorb_point(layout[("commit", "advice", i)])
    if vk.lookups:
        squeeze(S["theta"])
        for i in range(len(vk.lookups)):
            absorb_point(layout[("commit", "lkA", i)])
            absorb_point(layout[("commit", "lkS", i)])
    squeeze(S["beta"])
    squeeze(S["gamma"])
    for c in range(len(vk.chunks)):
        absorb_point(layout[("commit", "z", c)])
    for i in range(len(vk.lookups)):
        absorb_point(layout[("commit", "lkZ", i)])
    squeeze(S["y"])
    for c in range(n_t):
        absorb_point(layout[("commit", "t", c)])
    squeeze(S["x"])
    for kind, idx, rots in entries:
        for rot in rots:
            o = layout[("eval", kind, idx, rot)]
            check_scalar(o)
            absorb(lambda o=o: g.cdload(o))
    squeeze(S["v"])
    for rot in all_rots:
        absorb_point(layout[("commit", "W", rot)])
    squeeze(S["u"])

    # ---- x^n, Z_H(x), l0, l_last, instance eval -----------------------
    g.mload(S["x"])
    for _ in range(vk.k):
        g.mload(M_R)
        g.emit("SWAP1", "DUP1", "MULMOD")  # [v] -> [v^2 mod R]
    g.emit("DUP1")
    g.mstore(S["xn"])
    # zh = (xn + (R-1)) % R; require != 0
    g.mload(M_R)
    g.emit("SWAP1")  # [R, xn]
    g.const(R - 1)
    g.emit("ADDMOD")  # (R-1 + xn) % R
    g.emit("DUP1")
    g.mstore(S["zh"])
    g.emit("ISZERO", "ISZERO")
    g.require()

    def f_inv_of(load_value):
        """Stack result: inverse of the loaded value (0x05 modexp)."""
        for i in range(3):
            g.emit(32)
            g.mstore(MODEXP_IN + 32 * i)
        load_value()
        g.mstore(MODEXP_IN + 96)
        g.const(R - 2)
        g.mstore(MODEXP_IN + 128)
        g.mload(M_R)
        g.mstore(MODEXP_IN + 160)
        g.emit(32, MODEXP_OUT, 192, MODEXP_IN, 0x05, "GAS", "STATICCALL")
        g.require()
        g.mload(MODEXP_OUT)

    def x_minus(wi: int):
        """Stack result: (x - wi) mod R."""
        g.mload(M_R)
        g.const((R - wi) % R)
        g.mload(S["x"])
        g.emit("ADDMOD")

    def lagrange_to(dest: int, wi: int):
        """dest = wi * n_inv * zh * inv(x - wi)."""
        f_inv_of(lambda: x_minus(wi))  # [inv]
        g.mload(M_R)
        g.emit("SWAP1")  # [R, inv]
        g.const(wi * n_inv % R)
        g.emit("MULMOD")  # [inv * c]
        g.mload(M_R)
        g.emit("SWAP1")
        g.mload(S["zh"])
        g.emit("MULMOD")
        g.mstore(dest)

    lagrange_to(S["l0"], 1)
    lagrange_to(S["llast"], pow(w, n - 1, R))

    g.emit(0)
    g.mstore(inst_eval_slot)
    for i in range(inst_words):
        f_inv_of(lambda i=i: x_minus(pow(w, i, R)))  # [inv]
        g.mload(M_R)
        g.emit("SWAP1")
        g.const(pow(w, i, R) * n_inv % R)
        g.emit("MULMOD")
        g.mload(M_R)
        g.emit("SWAP1")
        g.mload(S["zh"])
        g.emit("MULMOD")
        g.mload(M_R)
        g.emit("SWAP1")
        g.cdload(32 * i)
        g.emit("MULMOD")
        g.mload(M_R)
        g.emit("SWAP1")
        g.mload(inst_eval_slot)
        g.emit("ADDMOD")
        g.mstore(inst_eval_slot)

    # ---- constraint evaluation at x -----------------------------------
    n_adv, n_inst = vk.n_advice, len(vk.instance_names)
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
    CH = 1 << 40
    ch_theta, ch_beta, ch_gamma = CH, CH + 1, CH + 2

    def load_leaf(slot: int, rot: int):
        if slot == x_slot:
            return g.mload(S["x"])
        if slot == l0_slot:
            return g.mload(S["l0"])
        if slot == llast_slot:
            return g.mload(S["llast"])
        if slot == ch_theta:
            return g.mload(S["theta"])
        if slot == ch_beta:
            return g.mload(S["beta"])
        if slot == ch_gamma:
            return g.mload(S["gamma"])
        if slot < n_adv:
            return g.cdload(layout[("eval", "advice", slot, rot)])
        if slot < n_adv + n_inst:
            assert rot == 0, "instance rotations unsupported"
            return g.mload(inst_eval_slot)
        if slot < base_slots:
            return g.cdload(layout[("eval", "fixed", slot - n_adv - n_inst, rot)])
        if slot in sigma_slots:
            return g.cdload(layout[("eval", "sigma", slot - base_slots, rot)])
        if slot in lk_a_slots:
            return g.cdload(layout[("eval", "lkA", lk_a_slots.index(slot), rot)])
        if slot in lk_s_slots:
            return g.cdload(layout[("eval", "lkS", lk_s_slots.index(slot), rot)])
        if slot in lk_z_slots:
            return g.cdload(layout[("eval", "lkZ", lk_z_slots.index(slot), rot)])
        return g.cdload(layout[("eval", "z", z_slots.index(slot), rot)])

    memo: dict[int, int] = {}

    def emit_expr(sym: Sym):
        """Leave sym's value (mod R) on the stack."""
        if sym.op == "col":
            return load_leaf(*sym.args)
        if sym.op == "const":
            return g.const(sym.args[0])
        key = id(sym)
        if key in memo:
            return g.mload(memo[key])
        if sym.op == "neg":
            # (0 + (R - a)) % R
            g.mload(M_R)
            g.emit(0)
            emit_expr(sym.args[0])
            g.mload(M_R)
            g.emit("SUB")  # top(R) - next(a) = R - a
            g.emit("ADDMOD")
        elif sym.op == "sub":
            # (a + (R - b)) % R
            g.mload(M_R)
            emit_expr(sym.args[1])
            g.mload(M_R)
            g.emit("SUB")  # R - b
            emit_expr(sym.args[0])
            g.emit("ADDMOD")
        else:
            g.mload(M_R)
            emit_expr(sym.args[1])
            emit_expr(sym.args[0])
            g.emit("ADDMOD" if sym.op == "add" else "MULMOD")
        slot = g.alloc_slot()
        memo[key] = slot
        g.emit("DUP1")
        g.mstore(slot)

    # Build (and hold alive) every constraint list before any emission:
    # the expression memo is keyed by id(), so letting one list die
    # would let a later Sym reuse a freed id and alias a stale slot.
    perm_cons = _perm_constraints(
        vk,
        Sym.col(ch_beta),
        Sym.col(ch_gamma),
        z_slots,
        sigma_slots,
        x_slot,
        l0_slot,
        llast_slot,
    )
    lookup_cons = _lookup_constraints(
        vk,
        Sym.col(ch_theta),
        Sym.col(ch_beta),
        Sym.col(ch_gamma),
        lk_a_slots,
        lk_s_slots,
        lk_z_slots,
        l0_slot,
        llast_slot,
        n_adv + n_inst,
    )

    g.emit(0)
    g.mstore(S["combined"])
    g.emit(1)
    g.mstore(S["y_pow"])

    def add_constraint(emit_term):
        g.mload(M_R)  # for ADDMOD
        g.mload(M_R)  # for MULMOD
        emit_term()
        g.mload(S["y_pow"])
        g.emit("MULMOD")
        g.mload(S["combined"])
        g.emit("ADDMOD")
        g.mstore(S["combined"])
        g.mload(M_R)
        g.mload(S["y"])
        g.mload(S["y_pow"])
        g.emit("MULMOD")
        g.mstore(S["y_pow"])

    for spec in vk.gates:
        sel_off = layout[("eval", "fixed", spec.sel_slot - n_adv - n_inst, 0)]
        for con in spec.constraints:

            def term(con=con, sel_off=sel_off):
                g.mload(M_R)
                emit_expr(con)
                g.cdload(sel_off)
                g.emit("MULMOD")

            add_constraint(term)
    g.mload(S["combined"])
    g.mstore(S["dbg_gates"])
    for con in perm_cons:
        add_constraint(lambda con=con: emit_expr(con))
    g.mload(S["combined"])
    g.mstore(S["dbg_perm"])
    for con in lookup_cons:
        add_constraint(lambda con=con: emit_expr(con))

    if _debug is not None:
        g.mload(S[_debug])
        g.emit(0, "MSTORE", 32, 0, "RETURN")

    # ---- quotient check -----------------------------------------------
    g.emit(0)
    g.mstore(S["t_eval"])
    for c in range(n_t - 1, -1, -1):
        g.mload(M_R)
        g.mload(M_R)
        g.mload(S["xn"])
        g.mload(S["t_eval"])
        g.emit("MULMOD")
        g.cdload(layout[("eval", "t", c, 0)])
        g.emit("ADDMOD")
        g.mstore(S["t_eval"])
    g.mload(M_R)
    g.mload(S["zh"])
    g.mload(S["t_eval"])
    g.emit("MULMOD")
    g.mload(S["combined"])
    g.emit("EQ")
    g.require()

    # ---- GWC batch opening --------------------------------------------
    def ec_mul(load_point, load_scalar):
        """ECOUT = point * scalar (0x07)."""
        load_point(ECIN)
        load_scalar()
        g.mstore(ECIN + 64)
        g.emit(64, ECOUT, 96, ECIN, 0x07, "GAS", "STATICCALL")
        g.require()

    def ec_add_into(acc: int):
        """acc += ECOUT (0x06)."""
        for src, dst in (
            (acc, ECIN),
            (acc + 32, ECIN + 32),
            (ECOUT, ECIN + 64),
            (ECOUT + 32, ECIN + 96),
        ):
            g.mload(src)
            g.mstore(dst)
        g.emit(64, ECOUT, 128, ECIN, 0x06, "GAS", "STATICCALL")
        g.require()
        g.mload(ECOUT)
        g.mstore(acc)
        g.mload(ECOUT + 32)
        g.mstore(acc + 32)

    def commit_loader(kind: str, idx):
        if kind in ("fixed", "sigma"):
            pt = (vk.fixed_commits if kind == "fixed" else vk.sigma_commits)[idx]

            def load(dst, pt=pt):
                g.const(pt.x)
                g.mstore(dst)
                g.const(pt.y)
                g.mstore(dst + 32)

            return load
        o = layout[("commit", kind, idx)]

        def load(dst, o=o):
            g.cdload(o)
            g.mstore(dst)
            g.cdload(o + 32)
            g.mstore(dst + 32)

        return load

    for acc in (ACC_A, ACC_A + 32, ACC_B, ACC_B + 32):
        g.emit(0)
        g.mstore(acc)
    g.emit(1)
    g.mstore(S["u_pow"])

    for rot in all_rots:
        wr = pow(w, rot, R) if rot >= 0 else pow(w_inv, -rot, R)
        g.mload(M_R)
        g.const(wr)
        g.mload(S["x"])
        g.emit("MULMOD")
        g.mstore(S["x_g"])
        for acc in (S["F"], S["F2"]):
            g.emit(0)
            g.mstore(acc)
        g.emit(0)
        g.mstore(S["E"])
        g.emit(1)
        g.mstore(S["v_pow"])
        for kind, idx, rots in entries:
            if rot not in rots:
                continue
            ec_mul(commit_loader(kind, idx), lambda: g.mload(S["v_pow"]))
            ec_add_into(S["F"])
            g.mload(M_R)
            g.mload(M_R)
            g.cdload(layout[("eval", kind, idx, rot)])
            g.mload(S["v_pow"])
            g.emit("MULMOD")
            g.mload(S["E"])
            g.emit("ADDMOD")
            g.mstore(S["E"])
            g.mload(M_R)
            g.mload(S["v"])
            g.mload(S["v_pow"])
            g.emit("MULMOD")
            g.mstore(S["v_pow"])

        def load_G(dst):
            g.emit(GENERATOR.x)
            g.mstore(dst)
            g.emit(GENERATOR.y)
            g.mstore(dst + 32)

        def neg_E():
            # (0 + (R - E)) % R
            g.mload(M_R)
            g.emit(0)
            g.mload(S["E"])
            g.mload(M_R)
            g.emit("SUB")  # R - E
            g.emit("ADDMOD")

        # term = F + (-E)*G + x_g*W
        ec_mul(load_G, neg_E)
        for i in (0, 32):
            g.mload(S["F"] + i)
            g.mstore(S["term"] + i)
        ec_add_into(S["term"])
        ec_mul(commit_loader("W", rot), lambda: g.mload(S["x_g"]))
        ec_add_into(S["term"])

        def load_term(dst):
            g.mload(S["term"])
            g.mstore(dst)
            g.mload(S["term2"])
            g.mstore(dst + 32)

        ec_mul(load_term, lambda: g.mload(S["u_pow"]))
        ec_add_into(ACC_B)
        ec_mul(commit_loader("W", rot), lambda: g.mload(S["u_pow"]))
        ec_add_into(ACC_A)
        g.mload(M_R)
        g.mload(S["u"])
        g.mload(S["u_pow"])
        g.emit("MULMOD")
        g.mstore(S["u_pow"])

    # ---- pairing: e(B, g2) * e(-A, tau_g2) == 1 -----------------------
    def g2_words(pt):
        return [pt.x.coeffs[1], pt.x.coeffs[0], pt.y.coeffs[1], pt.y.coeffs[0]]

    g.mload(ACC_B)
    g.mstore(PAIR)
    g.mload(ACC_B + 32)
    g.mstore(PAIR + 32)
    for i, word in enumerate(g2_words(vk.srs.g2)):
        g.const(word)
        g.mstore(PAIR + 64 + 32 * i)
    g.mload(ACC_A)
    g.mstore(PAIR + 192)
    # -A.y = (Q - y) % Q  (identity stays identity)
    g.mload(M_Q)  # modulus for MOD
    g.mload(ACC_A + 32)
    g.mload(M_Q)
    g.emit("SUB", "MOD")  # (Q - y) % Q
    g.mstore(PAIR + 224)
    for i, word in enumerate(g2_words(vk.srs.tau_g2)):
        g.const(word)
        g.mstore(PAIR + 256 + 32 * i)
    g.emit(32, ECOUT, 384, PAIR, 0x08, "GAS", "STATICCALL")
    g.require()
    g.mload(ECOUT)
    g.emit(1, "EQ")
    g.require()
    g.emit(1, 0, "MSTORE", 32, 0, "RETURN")

    # ---- finalize: CODECOPY const blob, resolve crefs -----------------
    c_mem = g.slot_top
    blob_words = sorted(g.consts, key=g.consts.get)
    blob = b"".join(v.to_bytes(32, "big") for v in blob_words)
    blob_off = 0
    code = b""
    for _ in range(6):
        full_items: list = [len(blob), blob_off, c_mem, "CODECOPY"]
        for it in g.items:
            if isinstance(it, tuple) and it[0] == "cref":
                full_items.extend([c_mem + 32 * it[1], "MLOAD"])
            else:
                full_items.append(it)
        code = asm(*full_items)
        if len(code) == blob_off:
            break
        blob_off = len(code)
    assert len(code) == blob_off, "blob offset failed to converge"
    return GeneratedVerifier(
        runtime=code + blob, n_t=n_t, calldata_len=calldata_len
    )


def _revert_with(msg: bytes) -> list:
    """asm items: revert with Error(string) ABI encoding."""
    items: list = [0x08C379A0 << 224, 0, "MSTORE", 0x20, 4, "MSTORE", len(msg), 36, "MSTORE"]
    padded = msg.ljust((len(msg) + 31) // 32 * 32, b"\0")
    for i in range(0, len(padded), 32):
        items += [int.from_bytes(padded[i : i + 32], "big"), 68 + i, "MSTORE"]
    items += [4 + 64 + len(padded), 0, "REVERT"]
    return items


def generate_wrapper(verifier_addr: int) -> bytes:
    """The EtVerifierWrapper analog (EtVerifierWrapper.sol:35-89):
    forwards its entire calldata (pub_ins ‖ proof) to the raw verifier
    via STATICCALL, reverting "verifier-missing" when no code is
    deployed there and "verification-failed" when the proof is bad."""
    return asm(
        verifier_addr,
        "EXTCODESIZE",
        ("ref", "present"),
        "JUMPI",
        *_revert_with(b"verifier-missing"),
        ("label", "present"),
        "CALLDATASIZE", 0, 0, "CALLDATACOPY",
        32, 0, "CALLDATASIZE", 0, verifier_addr, "GAS", "STATICCALL",
        ("ref", "ok"),
        "JUMPI",
        *_revert_with(b"verification-failed"),
        ("label", "ok"),
        32, 0, "RETURN",
    )


def evm_verify(
    gen: GeneratedVerifier, pub_ins: list[int], proof: bytes, gas: int = 500_000_000
):
    """Deploy the generated verifier behind a wrapper in a fresh
    in-process EVM and verify — the reference's ``evm_verify``
    (verifier/mod.rs:117-134).  Returns (accepted, gas_used)."""
    from ..evm.machine import EVM

    evm = EVM()
    verifier = evm.deploy_runtime(gen.runtime)
    wrapper = evm.deploy_runtime(generate_wrapper(verifier))
    r = evm.call(wrapper, gen.calldata(pub_ins, proof), gas=gas)
    accepted = r.success and int.from_bytes(r.returndata, "big") == 1
    return accepted, r.gas_used
