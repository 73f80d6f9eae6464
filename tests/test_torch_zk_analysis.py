"""The analyzers' graft leg (``protocol_tpu_torch/analysis/zk_lowering.py``
and ``python -m protocol_tpu_torch.analysis --zk``) on the CPU, held
against the reference's registry (``protocol_tpu/analysis/zk_lowering.py``,
``tests/test_zk_graft.py::TestAnalyzerCoverage``).

- The registry: the same five kernel names; each declares a launch, a
  memory and a comm budget, and the gate fails without any of them.
- The recipes: their arguments hold exactly the resident bytes the
  budgets reckon; K13's one call is judged against its two names' sum.
- The rules: a boolean-mask write is a host read (the recorder), the
  point cache's masked fill gives the old bits with no host read, and
  the card-only rules (downloads, launches) fire on records shaped as
  the card gives them.
- A clean ``--zk --device cpu`` run: every graft kernel checked in the
  step, memory, comm and determinism sections, the entries reading
  nothing on the host, every digest equal in this process and in the
  fresh one, the card's rules listed as not run.
- The fixtures' command line: the card-only ones exit ``NOT_RUN``.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from protocol_tpu.analysis.zk_lowering import zk_kernel_names as ref_zk_kernel_names
from protocol_tpu.zk.graft import field as ref_field
from protocol_tpu.zk.graft import pippenger as ref_pippenger
from protocol_tpu_torch.analysis import zk_lowering
from protocol_tpu_torch.analysis.__main__ import NOT_RUN, main as analysis_main
from protocol_tpu_torch.analysis.budget import (
    COMM_INVARIANTS,
    MEM_INVARIANTS,
    ZK_INVARIANTS,
    expected_zk_host_copies,
)
from protocol_tpu_torch.analysis.comm.checker import run_zk_comm
from protocol_tpu_torch.analysis.memory.checker import MEASURED_RULES, summed_budget
from protocol_tpu_torch.analysis.record import OpRecord, Recording, record_ops
from protocol_tpu_torch.analysis.step import CARD_RULES, ZK_CARD_RULES, check_zk, registry_findings
from protocol_tpu_torch.zk.bn254 import GENERATOR, IDENTITY
from protocol_tpu_torch.zk.graft import field as gf
from protocol_tpu_torch.zk.graft import pippenger as gpp

CPU = torch.device("cpu")
NAMES = ref_zk_kernel_names()


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions run many small tensor operations: intra-op
    threads add nothing to them and contend with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


def test_kernel_names_are_the_references():
    assert zk_lowering.zk_kernel_names() == NAMES
    assert zk_lowering.ensure_budgets() == NAMES == zk_lowering.register()
    assert len(NAMES) == 5


@pytest.mark.parametrize("table", [ZK_INVARIANTS, MEM_INVARIANTS, COMM_INVARIANTS],
                         ids=["zk", "mem", "comm"])
def test_every_table_covers_the_graft_kernels(table):
    zk_lowering.ensure_budgets()
    assert set(NAMES) <= set(table)


@pytest.mark.parametrize("table, name, rule", [
    (ZK_INVARIANTS, "zk-graft-mulmod", "undeclared-zk-budget"),
    (MEM_INVARIANTS, "zk-graft-ntt-stage", "undeclared-mem-budget"),
    (COMM_INVARIANTS, "zk-graft-msm-bucket", "undeclared-comm-budget"),
], ids=["zk", "mem", "comm"])
def test_a_missing_graft_budget_is_an_error(monkeypatch, table, name, rule):
    registry_findings()  # every declaring module imported first
    monkeypatch.delitem(table, name)
    findings, _ = registry_findings()
    assert [(f.rule, f.backend, f.severity) for f in findings] == [(rule, name, "error")]


def test_graft_memory_and_comm_budgets_are_not_stale():
    findings, section = registry_findings()
    assert findings == []
    assert section["zk_kernels"] == NAMES


@pytest.mark.parametrize("entry, size, want", [
    ("ntt_limbs", dict(n=1024, inverse=False), [32 * 1024]),
    ("ntt_limbs", dict(n=1, inverse=True), []),
    ("msm_limbs", dict(n=33), [32 * 256 * 3 * 4 * 8]),
    ("msm_limbs", dict(n=0), []),
    ("point_cache", dict(n=2048), []),
])
def test_declared_host_copies(entry, size, want):
    assert expected_zk_host_copies(entry, **size) == want


# ---------------------------------------------------------------------------
# The recipes and their budgets
# ---------------------------------------------------------------------------

#: Bytes a lane (and a constant) of each kernel recipe's arguments, from
#: the wrappers' operands: (n, 4) int64 words are 32 B a lane, the NTT's
#: plan (n - 1, 4), K13's ds and perm (32, n) int32 and points (n, 3, 4).
RESIDENT = {
    "zk-graft-mulmod": (64, 0),
    "zk-graft-ntt-stage": (64, -32),
    "zk-graft-msm-window": (32, 0),
    zk_lowering.K13_LABEL: (352, 0),
}


@pytest.mark.parametrize("lanes", zk_lowering.ZK_LANES)
def test_recipe_arguments_are_the_budgets_residents(lanes):
    recipes = zk_lowering.kernel_recipes(CPU, lanes)
    assert [r.label for r in recipes] == list(RESIDENT)
    for recipe in recipes:
        per_lane, const = RESIDENT[recipe.label]
        held = sum(a.untyped_storage().nbytes() for a in recipe.args)
        assert held == per_lane * lanes + const, recipe.label
        # Within the formula by its 4,096 B constant (the plan's row short).
        budget = summed_budget(recipe.label, recipe.kernels)
        assert budget.max_resident(lanes, 0, 0, 0, 1) - held == 4096 - const, recipe.label


def test_k13_is_judged_against_the_sum_of_its_names():
    budget = summed_budget(zk_lowering.K13_LABEL, zk_lowering.K13_NAMES)
    assert (budget.resident_n, budget.transient_n) == (352.0, 384.0)
    assert budget.transient_const == 4096.0 + 32 * 256 * 3 * 4 * 8
    # The bucket grid at 1,024 lanes: 384 B a lane of pieces and the grid.
    assert budget.max_transient(1024, 0, 0) == 384 * 1024 + 786_432 + 4096


def test_entry_recipes_declare_their_launches_and_downloads():
    recipes = {r.entry: r for r in zk_lowering.entry_recipes(CPU, 1024)}
    assert list(recipes) == list(zk_lowering.ZK_ENTRIES)
    assert recipes["ntt_limbs"].launches == {"field_op": 0, "ntt_device": 2}
    assert recipes["ntt_limbs"].host_copies == [32 * 1024]
    assert recipes["msm_limbs"].launches == {"field_op": 0, "msm_window": 1, "msm_bucket": 2}
    assert recipes["msm_limbs"].host_copies == [786_432]
    assert recipes["point_cache"].launches == {"field_op": 2}
    assert recipes["point_cache"].host_copies == []
    assert set(recipes["msm_limbs"].kernels) == set(NAMES) - {"zk-graft-ntt-stage"}


def test_comm_leg_counts_the_recipes_itself_without_the_memory_leg(monkeypatch):
    """Without the memory pass the comm pass runs each kernel recipe at
    both sizes (here made small) and finds no collective."""
    monkeypatch.setattr(zk_lowering, "ZK_LANES", (16, 32))
    findings, section = run_zk_comm(CPU)
    assert findings == []
    assert sorted(section) == sorted(NAMES)
    for name, entry in section.items():
        assert entry["status"] == "checked" and entry["source"] == "comm", name
        assert entry["collectives"] == 0 and len(entry["scales"]) == 2, name


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------


def test_a_boolean_mask_write_is_a_host_read():
    one = torch.ones(8, 4, dtype=torch.int64)
    mask = torch.tensor([0, 1, 0, 0, 1, 0, 0, 0], dtype=torch.bool)

    def masked_write():
        out = one.clone()
        out[mask] = 0
        return out

    _, rec = record_ops(masked_write)
    assert [r.op for r in rec.host_syncs] == ["index_put_"]
    _, rec = record_ops(lambda: one.masked_fill(mask[:, None], 0))
    assert rec.host_syncs == []
    # A write through positions is no host read, a boolean value or not.
    flags = torch.zeros(8, dtype=torch.bool)
    _, rec = record_ops(lambda: flags.clone().index_put_((torch.tensor([1, 2]),),
                                                          torch.tensor(True)))
    assert rec.host_syncs == []


def test_point_cache_keeps_its_bits_and_reads_nothing_on_the_host():
    """``PointCache.build``'s masked fill gives the bits its boolean-mask
    write gave, the reference's cache limb for limb, the identities
    included; and no read of device data on the host."""
    rng = np.random.default_rng(41)
    points = [GENERATOR.mul(int(rng.integers(1, 1 << 62))) for _ in range(11)]
    points[1] = points[6] = IDENTITY
    cache, rec = record_ops(gpp.PointCache.build, points, CPU)
    assert [r for r in rec.host_syncs if r.in_kernel is None] == []
    raw = gpp._points_to_u64(points)
    raw = np.concatenate([raw, np.repeat(raw[:1], cache.padded - len(points), axis=0)])
    one = gf.FQ.const(gf.FQ.r, CPU).expand(cache.padded, 4).clone()
    one[torch.from_numpy(~raw.any(axis=1))] = 0  # the form before the repair
    assert torch.equal(cache.points[:, 2], one)
    ref = np.asarray(ref_pippenger.PointCache.build(points).points).reshape(-1, 16)
    assert torch.equal(cache.points.reshape(-1, 4),
                       gf.u64_to_tensor(ref_field.limbs_to_u64(ref), CPU))
    assert int((cache.points[:, 2] == 0).all(dim=1).sum()) == 2


def _copy(nbytes: int, line: int) -> OpRecord:
    """A device-to-host copy as the recorder sees one on the card."""
    return OpRecord(op="_to_copy", dtypes=("torch.int64",), devices=("cuda",),
                    out_devices=("cpu",), out_bytes=nbytes, moved_bytes=nbytes,
                    file="protocol_tpu_torch/zk/graft/field.py", line=line,
                    function="tensor_to_u64", in_kernel=None)


def _entry(host_copies, launches):
    return zk_lowering.ZkRecipe("ntt_limbs", ("zk-graft-ntt-stage",), "ntt_limbs", 1024, (),
                                lambda: None, launches, host_copies)


@pytest.mark.parametrize("copies, launches, rules", [
    ([32768], {"ntt_device": 2, "field_op": 0}, []),
    ([32768, 32768], {"ntt_device": 2, "field_op": 0}, ["zk-host-copy"]),
    ([], {"ntt_device": 2, "field_op": 0}, ["zk-host-copy"]),
    ([32768], {"ntt_device": 3, "field_op": 0}, ["zk-launch-budget"]),
    ([32768], {"ntt_device": 2, "field_op": 1}, ["zk-launch-budget"]),
], ids=["declared", "second-download", "no-download", "extra-pass", "stray-k10"])
def test_card_rules_on_card_shaped_records(copies, launches, rules):
    rec = Recording([_copy(b, 78 + i) for i, b in enumerate(copies)])
    found = check_zk(_entry([32768], {"ntt_device": 2, "field_op": 0}), rec, launches)
    assert [f.rule for f in found] == rules
    if rules == ["zk-host-copy"] and len(copies) > 1:
        assert found[0].line == 79  # anchored at the undeclared copy


def test_card_rules_are_not_run_without_launches():
    rec = Recording([_copy(32768, 78), _copy(32768, 79)])
    assert check_zk(_entry([32768], {"ntt_device": 2}), rec, None) == []


# ---------------------------------------------------------------------------
# A clean run of the command line
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def zk_report(tmp_path_factory):
    """``python -m protocol_tpu_torch.analysis --zk --device cpu``, once."""
    out = tmp_path_factory.mktemp("zk") / "ANALYSIS.json"
    rc = analysis_main(["--zk", "--device", "cpu", "--output", str(out)])
    return rc, json.loads(out.read_text())


def test_cli_zk_run_is_clean(zk_report):
    rc, report = zk_report
    assert rc == 0
    assert report["device"] == "cpu"
    assert (report["summary"]["error"], report["summary"]["warning"]) == (0, 0)
    assert report["summary"]["not_run"] == {"step": list(CARD_RULES) + list(ZK_CARD_RULES),
                                            "memory": list(MEASURED_RULES)}
    assert set(report["seconds"]) == {"step", "ast", "concurrency", "comm", "memory",
                                      "determinism"}


@pytest.mark.parametrize("name", NAMES)
def test_every_graft_kernel_checked_in_every_section(zk_report, name):
    _, report = zk_report
    step = report["step"]["zk"]["kernels"][name]
    assert step["status"] == "checked" and step["violations"] == 0
    assert step["host_reads"] == [] and step["f64_ops"] == 0
    assert step["not_run"] == list(ZK_CARD_RULES)
    memory = report["memory"]["backends"][name]
    assert memory["status"] == "checked" and memory["not_run"] == list(MEASURED_RULES)
    assert memory["collectives"] == 0 and memory["comm_violations"] == 0
    comm = report["comm"]["backends"][name]
    assert comm["status"] == "checked" and comm["collectives"] == 0
    assert [r["dims"]["n"] for r in comm["scales"]] == list(zk_lowering.ZK_LANES)
    assert report["determinism"]["zk"][name]["status"] == "checked"


@pytest.mark.parametrize("entry", zk_lowering.ZK_ENTRIES)
def test_entries_read_nothing_on_the_host(zk_report, entry):
    _, report = zk_report
    rec = report["step"]["zk"]["entries"][entry]
    assert rec["status"] == "checked" and rec["violations"] == 0
    assert rec["host_reads"] == [] and rec["ops_outside_kernels"] < 10


@pytest.mark.parametrize("name", [*NAMES, *zk_lowering.ZK_ENTRIES])
def test_replays_equal_in_process_and_in_a_fresh_process(zk_report, name):
    _, report = zk_report
    rec = report["determinism"]["zk"][name]
    assert rec["bit_equal"]
    assert rec["in_process"] == [rec["fresh_process"]] * 2


# ---------------------------------------------------------------------------
# The fixtures' command line
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name, kind, rule", [
    ("zk-second-download", "step", "zk-host-copy"),
    ("zk-extra-buffer", "mem", "o-e-live-temporary"),
])
def test_card_only_graft_fixtures_are_not_run_on_the_cpu(tmp_path, name, kind, rule):
    out = tmp_path / "fixture.json"
    assert analysis_main(["--fixture", name, "--device", "cpu", "--output", str(out)]) == NOT_RUN
    assert json.loads(out.read_text())["summary"]["not_run"] == {kind: [rule]}


@pytest.mark.parametrize("name", ["zk-item-read", "zk-unseeded"])
def test_graft_fixtures_fail_the_gate_on_the_cpu(tmp_path, name):
    out = tmp_path / "fixture.json"
    assert analysis_main(["--fixture", name, "--device", "cpu", "--output", str(out)]) == 1
