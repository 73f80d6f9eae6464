"""The port's memory pass (``protocol_tpu_torch.analysis.memory``) on the
CPU.  The peaks themselves are measured on the card (``chip_smoke.py``'s
``analysis`` phase); here:

- ``MemBudget``'s fields and formulas, and ``pod_budget_view``, equal the
  reference's for the same coefficients;
- the memory AST rules give the reference's findings on the same
  sources;
- ``check_mem_case`` on measurements that carry an O(E) temporary at the
  two scales (E x4, N x2) fires ``o-e-live-temporary`` at both, and a
  replicated edge operand ``shard-replicated-edges``;
- every card backend declares a budget whose resident formula holds its
  converge's arguments, computed from the tensors on the CPU at both
  scales;
- the waiver table: K9's lanes waived by name, ``Manager._hash_cache``
  live, a stale entry an error, and a measured rule's waiver never stale
  on a run that cannot measure.
"""

import dataclasses

import pytest

from protocol_tpu.analysis.budget import MemBudget as RefMemBudget
from protocol_tpu.analysis.fixtures import FIXTURES as REF_FIXTURES
from protocol_tpu.analysis.memory.checker import pod_budget_view as ref_pod_budget_view
from protocol_tpu.analysis.ast_rules import scan_source as ref_scan
from protocol_tpu_torch.analysis import ast_rules
from protocol_tpu_torch.analysis.budget import MEM_INVARIANTS, MemBudget
from protocol_tpu_torch.analysis.cases import build_case, card_backends, step_graph
from protocol_tpu_torch.analysis.concurrency.waivers import Waiver, apply_waivers
from protocol_tpu_torch.analysis.memory import (
    MEM_SCALES,
    MEM_WAIVERS,
    MemCase,
    check_mem_case,
    judge_peak,
    pod_budget_view,
    run_memory_pass,
)
from protocol_tpu_torch.analysis.memory.checker import MEASURED_RULES
from protocol_tpu_torch.trust.backend import registered_backends  # declares the budgets

COEFFS = dict(
    resident_edge_bytes=8.0, resident_n=16.0, resident_segments=9.0, resident_rows=8196.0,
    resident_const=4096.0, transient_n=24.0, transient_segments=12.0, transient_rows=4100.0,
    transient_const=262144.0, staging_n=4.0, staging_const=8.0,
)
DIMS = [(65536, 1048576, 2048, 1024, 1), (131072, 4194304, 8192, 4096, 8), (7, 9, 0, 0, 3)]


class TestFormulas:
    def test_fields_are_the_references(self):
        assert [f.name for f in dataclasses.fields(MemBudget)] == [
            f.name for f in dataclasses.fields(RefMemBudget)]

    @pytest.mark.parametrize("n, e, segs, rows, shards", DIMS)
    def test_formulas_equal_the_references(self, n, e, segs, rows, shards):
        port, ref = MemBudget("b", **COEFFS), RefMemBudget("b", **COEFFS)
        assert port.max_resident(n, e, segs, rows, shards) == ref.max_resident(n, e, segs, rows, shards)
        assert port.max_transient(n, segs, rows) == ref.max_transient(n, segs, rows)
        assert port.staging_cap(n) == ref.staging_cap(n)

    @pytest.mark.parametrize("n_hosts", [1, 2, 4])
    def test_pod_budget_view_equals_the_references(self, n_hosts):
        port, ref = MemBudget("b", **COEFFS), RefMemBudget("b", **COEFFS)
        kw = dict(n=4096, edges=1 << 20, n_segments=2048, rows=512, n_shards=8 * n_hosts,
                  n_hosts=n_hosts)
        assert pod_budget_view(port, **kw) == ref_pod_budget_view(ref, **kw)

    def test_transient_has_no_edge_term(self):
        budget = MemBudget("b", **COEFFS)
        assert budget.max_transient(1000, 10, 10) == budget.max_transient(1000, 10, 10)
        assert "edge" not in " ".join(f.name for f in dataclasses.fields(MemBudget)
                                      if f.name.startswith("transient"))


class TestAstParity:
    @pytest.mark.parametrize(
        "name", sorted(n for n, f in REF_FIXTURES.items() if f.kind == "mem-ast"))
    def test_reference_fixture_sources(self, name):
        source, rel_path = REF_FIXTURES[name].build()
        port_path = "protocol_tpu_torch/" + rel_path.split("/", 1)[1]
        ref = {(f.rule, f.line) for f in ref_scan(source, rel_path, mem_rules=True)}
        port = {(f.rule, f.line) for f in ast_rules.scan_source(source, port_path, mem_rules=True)}
        assert ref and port == ref


def case(n, e, transient, resident=None, backend="cuda-csr", shards=1, largest=None):
    budget = MEM_INVARIANTS[backend]
    if resident is None:
        resident = int(budget.max_resident(n, e, 0, 0, shards))
    return MemCase(backend, {"n": n, "edges": e, "n_shards": shards}, resident, transient,
                   largest=largest)


class TestChecker:
    @pytest.mark.parametrize("n, e", MEM_SCALES)
    def test_o_e_temporary_fires_at_both_scales(self, n, e):
        """Six N-vectors plus two float32 lanes an edge, K9's layout."""
        site = {"bytes": 4 * e, "op": "new_empty", "file": "protocol_tpu_torch/ops/sparse.py",
                "line": 419, "function": "gather_ds_cumsum"}
        findings, record = check_mem_case(MEM_INVARIANTS["cuda-csr"],
                                          case(n, e, 24 * n + 8 * e, largest=site))
        assert [(f.rule, f.file, f.line) for f in findings] == [
            ("o-e-live-temporary", "protocol_tpu_torch/ops/sparse.py", 419)]
        assert "in gather_ds_cumsum" in findings[0].message
        assert record["measured"]["transient_bytes"] > record["budget_transient_bytes"]

    @pytest.mark.parametrize("n, e", MEM_SCALES)
    def test_n_linear_transient_passes(self, n, e):
        findings, _ = check_mem_case(MEM_INVARIANTS["cuda-csr"], case(n, e, 24 * n))
        assert findings == []

    def test_slack_is_below_4_bytes_an_edge(self):
        """A live buffer of 4 B an edge busts the single-card budgets at
        both scales: no constant absorbs it."""
        for name in ("cuda-csr", "cuda-sparse", "cuda-windowed"):
            budget = MEM_INVARIANTS[name]
            for n, e in MEM_SCALES:
                assert budget.max_transient(n, 0, 0) < 4 * e, (name, n)

    def test_replicated_edges_fire(self):
        n, e = MEM_SCALES[0]
        budget = MEM_INVARIANTS["cuda-sharded:cuda-csr"]
        sharded = int(budget.max_resident(n, e, 0, 0, 2))
        findings, record = check_mem_case(
            budget, case(n, e, 0, resident=sharded + 8 * e // 2,
                         backend="cuda-sharded:cuda-csr", shards=2))
        assert [f.rule for f in findings] == ["shard-replicated-edges"]
        assert record["pod_projection"]["n_shards"] == 4

    def test_host_staging_over_cap_fires(self):
        n, e = MEM_SCALES[0]
        c = case(n, e, 0)
        c.host_transfers = [
            {"bytes": 4, "op": "_local_scalar_dense", "file": "f", "line": 1, "function": "g"},
            {"bytes": 4 * e, "op": "_to_copy", "file": "f", "line": 2, "function": "g"},
        ]
        findings, _ = check_mem_case(MEM_INVARIANTS["cuda-csr"], c)
        assert [(f.rule, f.line) for f in findings] == [("host-staging-over-cap", 2)]

    def test_judge_peak_waives_k9_lanes_by_name(self):
        n, e = 1_000_000, 50_000_000
        site = {"bytes": 4 * e, "op": "new_empty", "file": "protocol_tpu_torch/ops/sparse.py",
                "line": 419, "function": "gather_ds_cumsum"}
        dims = {"n": n, "edges": e, "n_shards": 1}
        resident = int(MEM_INVARIANTS["cuda-csr"].max_resident(n, e, 0, 0, 1))
        live, rec = judge_peak("cuda-csr", dims, resident_bytes=resident,
                               transient_bytes=8 * e, largest=site)
        assert live == [] and [w["symbol"] for w in rec["waived"]] == ["in gather_ds_cumsum"]
        assert rec["transient_margin_bytes"] < 0 <= rec["resident_margin_bytes"]
        elsewhere = dict(site, function="somewhere_else")
        live, _ = judge_peak("cuda-csr", dims, resident_bytes=resident,
                             transient_bytes=8 * e, largest=elsewhere)
        assert [f.rule for f in live] == ["o-e-live-temporary"]


class TestBudgets:
    def test_every_card_backend_declared(self):
        from protocol_tpu_torch.analysis.zk_lowering import ensure_budgets

        # The graft kernels declare theirs too, by their registry names.
        known = set(registered_backends()) | set(ensure_budgets())
        assert set(card_backends()) <= set(MEM_INVARIANTS) <= known
        for budget in MEM_INVARIANTS.values():
            assert budget.donated_args == ()  # torch donates no buffer

    @pytest.mark.parametrize("name", ["cuda-dense", "cuda-sparse", "cuda-csr", "cuda-windowed"])
    def test_resident_formula_holds_the_arguments(self, name):
        """The argument tensors of each converge entry, laid out on the
        CPU, within the resident formula (the card measures the same
        tensors' bytes)."""
        graph = step_graph(2048, 16384, seed=3) if name != "cuda-dense" else step_graph(256, 2048)
        c = build_case(name, graph, "cpu")
        d = c.dims
        allowed = MEM_INVARIANTS[name].max_resident(
            d["n"], d["edges"], d.get("n_segments", 0), d.get("n_rows", 0), 1)
        assert c.resident_bytes <= allowed
        assert allowed - c.resident_bytes <= MEM_INVARIANTS[name].resident_const


class TestPass:
    def test_cpu_run_reports_measurements_not_run(self):
        findings, section = run_memory_pass("cpu")
        assert findings == []
        for name in card_backends():
            rec = section["backends"][name]
            assert rec["status"] == "not-run"
            assert rec["not_run"] == list(MEASURED_RULES)
        assert [w["symbol"] for w in section["waived"]] == ["Manager._hash_cache"]
        assert section["stale_waivers"] == []

    def test_waiver_table_is_enumerated(self):
        assert [(w.rule, w.symbol) for w in MEM_WAIVERS] == [
            ("o-e-live-temporary", "in gather_ds_cumsum"),
            ("unbounded-cache-growth", "Manager._hash_cache"),
        ]

    def test_stale_waiver_is_an_error(self):
        bogus = Waiver("unbounded-cache-growth", "protocol_tpu_torch/node/pod.py", "X.y", "t")
        live, _, stale = apply_waivers([], MEM_WAIVERS + (bogus,), "memory",
                                       judged=set(MEASURED_RULES) | {"unbounded-cache-growth"})
        assert [s["symbol"] for s in stale] == [
            "in gather_ds_cumsum", "Manager._hash_cache", "X.y"]
        assert [f.rule for f in live] == ["stale-waiver"] * 3
