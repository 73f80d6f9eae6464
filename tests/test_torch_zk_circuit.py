"""The port's constraint system and epoch statement against the reference
package's: ``prove_epoch_statement`` over the same signed attestations
at 2 and 5 peers builds the same system (rows, every column's
assignments, selectors, gates, lookups and copy constraints), both
satisfied, and both refuse the same tampered statements and witnesses.
The gadgets' own checks come first, at the size of one chip."""

import pytest

from protocol_tpu.crypto import calculate_message_hash as ref_message_hash
from protocol_tpu.crypto.eddsa import sign as ref_sign
from protocol_tpu.node.attestation import Attestation as RefAttestation
from protocol_tpu.node.bootstrap import keyset_from_raw as ref_keyset
from protocol_tpu.zk.circuit import prove_epoch_statement as ref_prove_statement
from protocol_tpu.zk.cs import ConstraintSystem as RefConstraintSystem
from protocol_tpu.zk.gadgets import Bits2NumChip as RefBits2Num
from protocol_tpu.zk.gadgets import PoseidonChip as RefPoseidonChip
from protocol_tpu.zk.gadgets import StdGate as RefStdGate
from protocol_tpu_torch.crypto import calculate_message_hash, field
from protocol_tpu_torch.crypto.eddsa import sign
from protocol_tpu_torch.crypto.poseidon import permute
from protocol_tpu_torch.node.attestation import Attestation
from protocol_tpu_torch.node.bootstrap import FIXED_SET, keyset_from_raw
from protocol_tpu_torch.trust.native import power_iterate
from protocol_tpu_torch.zk.circuit import prove_epoch_statement
from protocol_tpu_torch.zk.cs import ConstraintSystem
from protocol_tpu_torch.zk.gadgets import Bits2NumChip, PoseidonChip, StdGate

P = field.MODULUS

#: Score rows summing to SCALE; ``ROWS[n]`` for an ``n``-peer group.
ROWS = {
    2: [[300, 700], [600, 400]],
    5: [
        [0, 400, 300, 200, 100],
        [250, 0, 250, 250, 250],
        [500, 300, 0, 100, 100],
        [100, 200, 300, 0, 400],
        [200, 200, 200, 400, 0],
    ],
}
ITERS = {2: 1, 5: 10}


def statement(n):
    """The same signed statement in both packages: (port attestations,
    reference attestations, public scores)."""
    rows = ROWS[n]
    sks, pks = keyset_from_raw(FIXED_SET[:n])
    _, msgs = calculate_message_hash(pks, rows)
    ours = [Attestation(sig=sign(sk, pk, m), pk=pk, neighbours=list(pks), scores=list(r))
            for sk, pk, m, r in zip(sks, pks, msgs, rows)]
    rsks, rpks = ref_keyset(FIXED_SET[:n])
    _, rmsgs = ref_message_hash(rpks, rows)
    theirs = [RefAttestation(sig=ref_sign(sk, pk, m), pk=pk, neighbours=list(rpks),
                             scores=list(r))
              for sk, pk, m, r in zip(rsks, rpks, rmsgs, rows)]
    pub = power_iterate([1000] * n, rows, ITERS[n], 1000)
    return ours, theirs, pub


def params(n):
    return dict(num_neighbours=n, num_iter=ITERS[n], initial_score=1000, scale=1000)


def cell(c):
    return (c.column.name, c.column.kind, c.row)


def layout(cs):
    """Everything a constraint system holds, as plain data."""
    return {
        "n_rows": cs.n_rows,
        "columns": sorted((c.name, c.kind) for c in cs.columns.values()),
        "trace": {(c.name, c.kind): dict(rows) for c, rows in cs.trace.items()},
        "selectors": {k: sorted(v) for k, v in cs.selectors.items()},
        "gates": [(g.name, g.selector) for g in cs.gates],
        "lookups": [(lk.name, lk.selector, [c.name for c in lk.columns], sorted(lk.table))
                    for lk in cs.lookups],
        "copies": [(cell(a), cell(b)) for a, b in cs.copies],
        "stats": cs.stats(),
    }


class TestGadgets:
    def test_std_gate_layout_and_tamper(self):
        systems = []
        for cs_cls, std_cls in ((ConstraintSystem, StdGate), (RefConstraintSystem, RefStdGate)):
            cs = cs_cls()
            std = std_cls(cs)
            x, y = std.witness(3), std.witness(4)
            out = std.add(std.mul(x, y), std.witness(5))
            inst = cs.column("instance", "instance")
            cs.copy(cs.assign(inst, 0, 17), out)
            cs.assert_satisfied()
            systems.append(cs)
        assert layout(systems[0]) == layout(systems[1])
        for cs in systems:
            col = next(c for c in cs.trace if c.kind == "advice")
            cs.trace[col][0] = 9
        failures = [[(f.gate, f.row) for f in cs.verify()] for cs in systems]
        assert failures[0] and failures[0] == failures[1]

    def test_poseidon_and_bits2num_chips_equal(self):
        systems = []
        for cs_cls, std_cls, pos_cls, b2n_cls in (
            (ConstraintSystem, StdGate, PoseidonChip, Bits2NumChip),
            (RefConstraintSystem, RefStdGate, RefPoseidonChip, RefBits2Num),
        ):
            cs = cs_cls()
            std = std_cls(cs)
            outs = pos_cls(cs).permute([std.witness(i + 1) for i in range(5)])
            assert cs.value(outs[0].column, outs[0].row) == permute([1, 2, 3, 4, 5])[0]
            b2n_cls(cs).decompose(std.witness(0b101101), 8)
            cs.assert_satisfied()
            systems.append(cs)
        assert layout(systems[0]) == layout(systems[1])


class TestEpochStatement:
    @pytest.mark.parametrize("n", [2, 5])
    def test_same_system_in_both_packages(self, n):
        ours, theirs, pub = statement(n)
        cs = prove_epoch_statement(ours, pub, **params(n))
        ref_cs = ref_prove_statement(theirs, pub, **params(n))
        assert cs.verify() == [] and ref_cs.verify() == []
        mine, ref = layout(cs), layout(ref_cs)
        assert mine["n_rows"] == ref["n_rows"] > 0
        assert mine["columns"] == ref["columns"]
        for col in ref["trace"]:
            assert mine["trace"][col] == ref["trace"][col], col
        assert mine == ref

    @pytest.mark.parametrize("n", [2, 5])
    def test_wrong_public_scores_refused_by_both(self, n):
        ours, theirs, pub = statement(n)
        bad = [(pub[0] + 1) % P] + pub[1:]
        with pytest.raises(AssertionError, match="not satisfied"):
            prove_epoch_statement(ours, bad, **params(n))
        with pytest.raises(AssertionError, match="not satisfied"):
            ref_prove_statement(theirs, bad, **params(n))

    def test_tampered_witness_refused_by_both(self):
        ours, theirs, pub = statement(2)
        systems = [prove_epoch_statement(ours, pub, **params(2)),
                   ref_prove_statement(theirs, pub, **params(2))]
        for cs in systems:
            col = next(c for c in cs.trace if c.kind == "advice")
            row = max(cs.trace[col])
            cs.trace[col][row] = (cs.trace[col][row] + 1) % P
        failures = [[(f.gate, f.row) for f in cs.verify()] for cs in systems]
        assert failures[0] and failures[0] == failures[1]

    def test_tampered_score_row_fails_the_signature_in_both(self):
        ours, theirs, _ = statement(2)
        for atts, prove in ((ours, prove_epoch_statement), (theirs, ref_prove_statement)):
            atts[0].scores[0] += 1
            atts[0].scores[1] -= 1
            # The public scores follow the tampered rows, so only the
            # signatures over the original rows can fail.
            pub = power_iterate([1000] * 2, [a.scores for a in atts], ITERS[2], 1000)
            with pytest.raises(AssertionError, match="not satisfied"):
                prove(atts, pub, **params(2))
