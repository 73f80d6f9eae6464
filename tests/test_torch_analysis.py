"""graftlint for the port (``protocol_tpu_torch.analysis``), held against
the reference's (``protocol_tpu.analysis``), on the CPU.

- The port's AST pass gives the reference's ``(rule, line)`` findings on
  the reference's own violating sources and on the reference's whole
  tree, where the reference's ``jit``/``shard_map`` decorators become the
  port's traced table.
- The port's seeded fixtures fire exactly their rule at their marked
  line; the card-only ones are reported as not run here.
- The traced table, the torch host reads, ``torch.cuda.synchronize``,
  the real tree clean under its enumerated waivers, stale waivers.
- The registry gate (every backend's kernel, memory and comm budgets,
  every graft kernel's).
- The step leg on the CPU for every card backend.
- The reference's ``TestHotPathContracts`` (``tests/test_obs.py:380``)
  re-targeted: the residual history adds no host sync and no gather,
  and changes no bit.
"""

import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import protocol_tpu.analysis.ast_rules as ref_ast
from protocol_tpu.analysis.fixtures import FIXTURES as REF_FIXTURES
import protocol_tpu_torch.analysis.fixtures as fixtures_mod
from protocol_tpu_torch.analysis import ast_rules
from protocol_tpu_torch.analysis.__main__ import NOT_RUN, main as analysis_main
from protocol_tpu_torch.analysis.budget import (
    COMM_INVARIANTS,
    HOST_BACKENDS,
    KERNEL_INVARIANTS,
    MEM_INVARIANTS,
    ZK_INVARIANTS,
    KernelBudget,
)
from protocol_tpu_torch.analysis.cases import single_rank_group
from protocol_tpu_torch.analysis.concurrency.waivers import Waiver
from protocol_tpu_torch.analysis.fixtures import FIXTURES, run_fixture
from protocol_tpu_torch.analysis.record import record_ops
from protocol_tpu_torch.analysis.step import CARD_RULES, registry_findings, run_step_pass
from protocol_tpu_torch.models.graphs import erdos_renyi
from protocol_tpu_torch.trust.backend import get_backend, registered_backends

REPO = Path(__file__).resolve().parent.parent
FIXTURES_PATH = Path(fixtures_mod.__file__)
SOURCE_KINDS = ("ast", "concurrency", "mem-ast", "det-ast", "det-atomics")


@pytest.fixture(autouse=True)
def one_thread():
    """These graphs are small: one intra-op thread, so a busy host's
    cores are not oversubscribed by many threads a worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def ported(rel_path: str) -> str:
    """A reference path as the port names it."""
    return "protocol_tpu_torch/" + rel_path.split("/", 1)[1]


def decorated(source: str) -> set[str]:
    """Qualnames of the functions the reference traces in ``source``:
    those with a ``jit`` or ``shard_map`` decorator (a function nested in
    one is traced by both passes through its parent)."""
    names = ref_ast._JIT_NAMES + ref_ast._SHARD_MAP_NAMES
    out: set[str] = set()

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                qual = prefix + (child.name,)
                if not isinstance(child, ast.ClassDef) and any(
                    ref_ast._is_traced_decorator(d, names) for d in child.decorator_list
                ):
                    out.add(".".join(qual))
                walk(child, qual)
            else:
                walk(child, prefix)

    walk(ast.parse(source), ())
    return out


def rule_lines(findings) -> set[tuple[str, int]]:
    return {(f.rule, f.line) for f in findings}


def marker_line(source: str, marker: str) -> int:
    """The line of the ``VIOLATION: <marker>`` comment (``#`` or ``//``)."""
    return next(i for i, line in enumerate(source.splitlines(), start=1)
                if re.search(rf"(#|//) VIOLATION: {re.escape(marker)}$", line))


def file_marker_line(marker: str) -> int:
    return marker_line(FIXTURES_PATH.read_text(), marker)


# ---------------------------------------------------------------------------
# AST parity with the reference
# ---------------------------------------------------------------------------

REF_AST_FIXTURES = sorted(n for n, f in REF_FIXTURES.items() if f.kind in ("ast", "mem-ast"))


class TestAstParity:
    @pytest.mark.parametrize("name", REF_AST_FIXTURES)
    def test_reference_fixture_sources(self, name):
        fixture = REF_FIXTURES[name]
        source, rel_path = fixture.build()
        mem = fixture.kind == "mem-ast"
        ref = ref_ast.scan_source(source, rel_path, mem_rules=mem)
        port = ast_rules.scan_source(source, ported(rel_path), mem_rules=mem,
                                     traced=decorated(source))
        assert ref, name
        assert rule_lines(port) == rule_lines(ref)
        assert {f.file for f in port} == {ported(rel_path)}

    @pytest.mark.parametrize("mem_rules", [False, True])
    def test_reference_tree(self, mem_rules):
        """Every file of the reference package: the same ``(rule, line)``
        findings from both scanners."""
        diffs = {}
        for path in sorted((REPO / "protocol_tpu").rglob("*.py")):
            source, rel = path.read_text(), str(path.relative_to(REPO))
            ref = rule_lines(ref_ast.scan_source(source, rel, mem_rules=mem_rules))
            port = rule_lines(ast_rules.scan_source(
                source, ported(rel), mem_rules=mem_rules, traced=decorated(source)))
            if ref != port:
                diffs[rel] = (sorted(ref - port), sorted(port - ref))
        assert diffs == {}


# ---------------------------------------------------------------------------
# The port's seeded fixtures
# ---------------------------------------------------------------------------

CPU_FIXTURES = sorted(n for n, f in FIXTURES.items() if f.kind != "comm")


class TestViolationFixtures:
    @pytest.mark.parametrize("name", CPU_FIXTURES)
    def test_fires_expected_rule_at_marked_line(self, name):
        fixture = FIXTURES[name]
        findings = run_fixture(name, "cpu")
        if fixture.card_only:
            assert findings is None  # not run here, never passed
            return
        errors = [f for f in findings if f.severity == "error"]
        assert {f.rule for f in errors} == {fixture.rule}
        if fixture.marker is None:
            return
        if fixture.kind in SOURCE_KINDS:
            source, rel_path = fixture.build()
            assert errors[0].file == rel_path
            assert errors[0].line == marker_line(source, fixture.marker)
        else:
            assert errors[0].file == str(FIXTURES_PATH.relative_to(REPO))
            assert errors[0].line == file_marker_line(fixture.marker)

    def test_every_card_only_fixture_is_a_runtime_one(self):
        card = {n for n, f in FIXTURES.items() if f.card_only}
        assert card == {"step-extra-launch", "mem-o-e-temporary", "zk-second-download",
                        "zk-extra-buffer"}

    def test_cli_exit_codes(self, tmp_path, capsys):
        out = tmp_path / "fixture.json"
        assert analysis_main(["--fixture", "time-in-jit", "--output", str(out)]) == 1
        report = json.loads(out.read_text())
        assert report["summary"]["error"] == 1
        assert report["findings"][0]["rule"] == "host-clock-in-jit"
        assert analysis_main(["--fixture", "bogus", "--output", str(out)]) == 2
        assert analysis_main(["--fixture", "step-extra-launch", "--device", "cpu",
                              "--output", str(out)]) == NOT_RUN
        assert json.loads(out.read_text())["summary"]["not_run"] == {"step": ["launch-budget"]}
        assert analysis_main(["--fixture", "step-f64", "--device", "cpu",
                              "--output", str(out)]) == 1
        assert analysis_main(["--list-fixtures"]) == 0
        listed = capsys.readouterr().out
        assert all(name in listed for name in FIXTURES)


# ---------------------------------------------------------------------------
# The traced table and the torch rules
# ---------------------------------------------------------------------------


def scan(source: str, rel: str = "protocol_tpu_torch/ops/_probe.py", traced=("step",)):
    return [(f.rule, f.line) for f in ast_rules.scan_source(source, rel, traced=set(traced))]


class TestTracedTable:
    def test_every_entry_resolves(self):
        assert ast_rules.stale_traced_entries() == []
        names = {e.partition("::")[2] for e in ast_rules.TRACED_FUNCTIONS}
        for name in ("damp", "run_power_iteration", "power_step_csr", "power_step_windowed",
                     "converge_windowed", "converge_csr", "converge_sparse", "sharded_step.step"):
            assert name in names

    def test_stale_entry_is_an_error(self):
        found = ast_rules.stale_traced_entries(table=(
            "protocol_tpu_torch/ops/sparse.py::no_such_step",
            "protocol_tpu_torch/ops/no_such_file.py::step",
            "protocol_tpu_torch/ops/sparse.py::damp",
        ))
        assert [(f.rule, f.severity) for f in found] == [("stale-traced-entry", "error")] * 2

    def test_table_names_this_file_only(self):
        assert ast_rules.traced_table("protocol_tpu_torch/parallel/sharded.py") >= {
            "sharded_step.step", "all_reduce_sum"}
        assert ast_rules.traced_table("protocol_tpu_torch/node/manager.py") == frozenset()

    def test_torch_host_reads_in_a_traced_function(self):
        source = (
            "def step(t):\n"
            "    a = t.item()\n"
            "    b = t.cpu()\n"
            "    c = t.numpy()\n"
            "    d = t.tolist()\n"
            "    e = float(t.sum())\n"
            "    f = bool(t.any())\n"
            "    g = int(3)\n"
            "    return a\n"
            "\n"
            "def host(t):\n"
            "    return t.item(), t.cpu(), float(t)\n"
        )
        assert scan(source) == [("host-op-in-jit", n) for n in (2, 3, 4, 5, 6, 7)]

    def test_nested_function_is_traced(self):
        source = (
            "def step(t):\n"
            "    def inner(x):\n"
            "        return x.item()\n"
            "    return inner(t)\n"
        )
        assert scan(source) == [("host-op-in-jit", 3)]
        assert scan(source, traced=()) == []

    def test_method_qualnames(self):
        source = (
            "class Problem:\n"
            "    def partial_ct(self, t):\n"
            "        return t.item()\n"
            "    def build(self, t):\n"
            "        return t.item()\n"
        )
        assert scan(source, traced=("Problem.partial_ct",)) == [("host-op-in-jit", 3)]

    def test_bare_cuda_synchronize(self):
        source = "import torch\n\ndef run(t):\n    torch.cuda.synchronize()\n    return t\n"
        assert scan(source, traced=()) == [("bare-sync", 4)]
        assert scan(source, rel="protocol_tpu_torch/bench/_probe.py", traced=()) == []

    def test_edge_materialization_by_cpu_and_numpy(self):
        source = "def device_stage(plan, t):\n    a = plan.seg_dst.cpu()\n    b = t.numpy()\n"
        found = ast_rules.scan_source(source, "protocol_tpu_torch/node/pipeline.py",
                                      mem_rules=True)
        assert [(f.rule, f.line) for f in found] == [("host-materialization-of-edges", 2)]

    def test_build_module_keeps_no_clock(self):
        """``ops/_build.py`` timed each nvcc from inside a kernel tree; the
        caller times the build now."""
        path = REPO / "protocol_tpu_torch" / "ops" / "_build.py"
        rel = str(path.relative_to(REPO))
        assert [f for f in ast_rules.scan_source(path.read_text(), rel)
                if f.rule == "clock-in-kernel-tree"] == []


class TestRealTree:
    def test_clean_under_its_waivers(self):
        live, section = ast_rules.run_ast_pass()
        assert live == [], [f.render() for f in live]
        assert section["stale_waivers"] == []
        used = {(w["rule"], w["symbol"]) for w in section["waived"]}
        assert used == {(w.rule, w.symbol) for w in ast_rules.AST_WAIVERS}
        assert section["files_scanned"] > 100

    def test_known_findings_are_the_waived_ones(self):
        """The B7 ``.item()``, the A4c ``row_run_ptr`` reads and the tools'
        clocks in ``parallel/`` are what the waivers cover."""
        _, section = ast_rules.run_ast_pass()
        by_file = {}
        for w in section["waived"]:
            by_file.setdefault(w["file"], set()).add(w["rule"])
        assert by_file == {
            "protocol_tpu_torch/ops/sparse.py": {"host-op-in-jit"},
            "protocol_tpu_torch/ops/gather_window.py": {"host-op-in-jit"},
            "protocol_tpu_torch/parallel/dryrun.py": {"clock-in-kernel-tree", "bare-sync"},
            "protocol_tpu_torch/parallel/dryrun_pod.py": {"clock-in-kernel-tree"},
            "protocol_tpu_torch/parallel/launch.py": {"clock-in-kernel-tree"},
        }

    def test_stale_waiver_is_an_error(self):
        bogus = Waiver("host-op-in-jit", "protocol_tpu_torch/ops/dense.py", "nothing", "test")
        live, section = ast_rules.run_ast_pass(waivers=ast_rules.AST_WAIVERS + (bogus,))
        assert [f.rule for f in live] == ["stale-waiver"]
        assert section["stale_waivers"] == [
            {"symbol": "nothing", "rule": "host-op-in-jit", "reason": "test"}]

    def test_cli_ast_pass(self, tmp_path):
        out = tmp_path / "ANALYSIS.json"
        assert analysis_main(["--pass", "ast", "--output", str(out)]) == 0
        report = json.loads(out.read_text())
        assert report["tool"] == "protocol_tpu_torch.analysis (graftlint)"
        assert report["device"] is None  # the AST pass needs no device
        assert report["ast"]["traced_functions"] == list(ast_rules.TRACED_FUNCTIONS)


# ---------------------------------------------------------------------------
# The registry gate and the step leg
# ---------------------------------------------------------------------------


class TestRegistryGate:
    def test_every_budget_declared(self):
        findings, section = registry_findings()
        assert findings == []
        card = [n for n in registered_backends() if n not in HOST_BACKENDS]
        assert set(card) <= set(KERNEL_INVARIANTS) & set(MEM_INVARIANTS)
        assert {n for n in card if n.startswith("cuda-sharded")} <= set(COMM_INVARIANTS)
        assert set(section["zk_kernels"]) <= set(ZK_INVARIANTS)

    @pytest.mark.parametrize("table, name, rule", [
        (KERNEL_INVARIANTS, "cuda-csr", "undeclared-backend"),
        (MEM_INVARIANTS, "cuda-windowed", "undeclared-mem-budget"),
        (COMM_INVARIANTS, "cuda-sharded:cuda-csr", "undeclared-comm-budget"),
        (ZK_INVARIANTS, "zk-graft-msm-window", "undeclared-zk-budget"),
    ])
    def test_a_missing_budget_is_an_error(self, monkeypatch, table, name, rule):
        registry_findings()  # every declaring module imported first
        monkeypatch.delitem(table, name)
        findings, _ = registry_findings()
        assert [(f.rule, f.backend, f.severity) for f in findings] == [(rule, name, "error")]

    def test_a_budget_nobody_registers_is_a_warning(self, monkeypatch):
        monkeypatch.setitem(KERNEL_INVARIANTS, "cuda-gone", KernelBudget("cuda-gone"))
        findings, _ = registry_findings()
        assert [(f.rule, f.severity) for f in findings] == [("stale-budget", "warning")]


@pytest.fixture(scope="module")
def step_pass():
    return run_step_pass("cpu")


class TestStepLeg:
    def test_every_card_backend_clean(self, step_pass):
        findings, section = step_pass
        assert findings == [], [f.render() for f in findings]
        for name in registered_backends():
            rec = section["backends"][name]
            if name in HOST_BACKENDS:
                assert rec["status"] == "skipped"
                continue
            assert rec["status"] == "checked"
            assert rec["not_run"] == list(CARD_RULES)  # the card's rules, not run here
            assert rec["capture"] is None and rec["launches"] is None
            assert rec["host_syncs"] == [] and rec["f64_ops"] == 0
            assert rec["gathers_outside_kernels"] == rec["scatters_outside_kernels"] == 0
            assert rec["ops"] > 0

    def test_plain_versions_run_inside_their_wrappers(self):
        """On the CPU a wrapper's plain version gathers (``index_select``);
        those ops count as the kernel's, not the step's."""
        from protocol_tpu_torch.analysis.cases import build_case, step_graph

        case = build_case("cuda-csr", step_graph(), "cpu")
        _, rec = record_ops(case.step, case.t)
        inside = [r for r in rec.ops if r.op == "index_select"]
        assert {r.in_kernel for r in inside} == {"gather_ds_cumsum", "rowsum_tail"}
        assert rec.gathers == []

    def test_windowed_dims(self, step_pass):
        _, section = step_pass
        dims = section["backends"]["cuda-windowed"]["dims"]
        assert dims["n"] == 1500 and dims["n_rows"] > 0 and dims["n_segments"] > 0


# ---------------------------------------------------------------------------
# The reference's TestHotPathContracts (tests/test_obs.py:380), re-targeted
# ---------------------------------------------------------------------------


class TestHotPathContracts:
    """The residual history must not change the step's access pattern,
    and an instrumented converge must be bit-identical."""

    BACKENDS = ("cuda-sparse", "cuda-csr", "cuda-windowed", "cuda-sharded")

    @pytest.mark.parametrize("name", BACKENDS)
    def test_instrumented_bit_identical(self, name):
        g = erdos_renyi(150, avg_degree=5.0, seed=3)

        def run(record):
            backend = get_backend(name, device="cpu")
            return backend.converge(g, alpha=0.1, tol=1e-9, max_iter=30, record_residuals=record)

        if name == "cuda-sharded":
            with single_rank_group("cpu"):
                on, off = run(True), run(False)
        else:
            on, off = run(True), run(False)
        assert np.array_equal(on.scores, off.scores)  # bit-identical
        assert off.residuals is None
        assert len(on.residuals) == on.iterations == off.iterations
        np.testing.assert_allclose(on.residuals[-1], on.residual, rtol=1e-6)

    @pytest.mark.parametrize("tol", [0.0, 1e-6])
    def test_residual_history_adds_no_host_sync_or_gather(self, tol):
        from protocol_tpu_torch.analysis.cases import build_case, step_graph
        from protocol_tpu_torch.ops.sparse import converge_csr

        case = build_case("cuda-csr", step_graph(100, 400, seed=5), "cpu")
        src, row_ptr, w, t0, p, dangling = case.args

        def counts(record):
            out, rec = record_ops(lambda: converge_csr(
                src, row_ptr, w, t0, p, dangling, alpha=0.1, tol=tol, max_iter=8,
                record_residuals=record))
            return out[0], len(rec.host_syncs), len(rec.gathers), len(rec.scatters)

        t_off, syncs_off, gathers_off, scatters_off = counts(False)
        t_on, syncs_on, gathers_on, scatters_on = counts(True)
        assert torch.equal(t_on, t_off)
        assert syncs_on == syncs_off
        assert gathers_on == gathers_off == 0
        assert scatters_on == scatters_off == 0
        # At tol 0 the loop reads nothing on the host; at tol > 0 one
        # residual a step (the B7 .item(), waived in the AST pass).
        assert syncs_off == (0 if tol == 0 else 8)


def test_report_sections_for_a_cpu_run(tmp_path):
    """``--pass step --pass memory --device cpu``: the card-only rules are
    listed as not run, and the report names its device."""
    out = tmp_path / "ANALYSIS.json"
    assert analysis_main(["--pass", "step", "--pass", "memory", "--device", "cpu",
                          "--output", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["device"] == "cpu"
    assert report["summary"]["not_run"] == {
        "step": list(CARD_RULES),
        "memory": ["shard-replicated-edges", "o-e-live-temporary", "host-staging-over-cap"],
    }
    assert set(report["seconds"]) == {"step", "memory"}
    assert report["launches"]["this_process"] == dict.fromkeys(
        report["launches"]["this_process"], 0)  # the plain versions launch nothing
