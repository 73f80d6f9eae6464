"""The port's determinism pass (``protocol_tpu_torch.analysis.determinism``)
on the CPU.

- ``scan_det_source`` gives the reference's findings on the same
  sources: the reference's seeded fixtures and every file of the
  reference's ``DET_TREES``.
- The runtime leg: every card backend's converge on the plain path,
  twice in this process and once in a fresh one, bit for bit; the
  run-order fixture caught.
- The atomics scan: a float ``atomicAdd`` is flagged, an integer one is
  not, and the kernels' sources (``ops/csrc``) are clean.
- The waiver table: live, and a stale entry an error.
"""

from pathlib import Path

import pytest
import torch

from protocol_tpu.analysis.determinism.ast_walk import DET_TREES as REF_DET_TREES
from protocol_tpu.analysis.determinism.ast_walk import scan_det_source as ref_scan
from protocol_tpu.analysis.fixtures import FIXTURES as REF_FIXTURES
from protocol_tpu_torch.analysis.concurrency.waivers import Waiver, apply_waivers
from protocol_tpu_torch.analysis.determinism import (
    DET_TREES,
    DET_WAIVERS,
    check_replays,
    digest,
    run_det_ast_pass,
    run_determinism_pass,
    scan_atomics,
    scan_atomics_source,
    scan_det_source,
)
from protocol_tpu_torch.analysis.determinism.checker import RUNTIME_RULES
from protocol_tpu_torch.analysis.fixtures import run_fixture
from protocol_tpu_torch.analysis.cases import card_backends

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def one_thread():
    """These graphs are small: one intra-op thread, so a busy host's
    cores are not oversubscribed by many threads a worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def ported(rel_path: str) -> str:
    return "protocol_tpu_torch/" + rel_path.split("/", 1)[1]


def rule_lines(findings) -> set[tuple[str, int]]:
    return {(f.rule, f.line) for f in findings}


class TestAstParity:
    @pytest.mark.parametrize(
        "name", sorted(n for n, f in REF_FIXTURES.items() if f.kind == "det-ast")
    )
    def test_reference_fixture_sources(self, name):
        source, rel_path = REF_FIXTURES[name].build()
        ref = ref_scan(source, rel_path)
        assert ref
        assert rule_lines(scan_det_source(source, ported(rel_path))) == rule_lines(ref)

    def test_reference_det_trees(self):
        assert DET_TREES == REF_DET_TREES
        diffs = {}
        for tree in REF_DET_TREES:
            for path in sorted((REPO / "protocol_tpu" / tree).rglob("*.py")):
                source, rel = path.read_text(), str(path.relative_to(REPO))
                ref = rule_lines(ref_scan(source, rel))
                port = rule_lines(scan_det_source(source, ported(rel)))
                if ref != port:
                    diffs[rel] = (sorted(ref - port), sorted(port - ref))
        assert diffs == {}

    def test_port_trees_clean_but_the_waived_rng(self):
        findings, n_files = run_det_ast_pass()
        assert n_files > 20
        assert [(f.rule, f.file) for f in findings] == [
            ("unseeded-rng", "protocol_tpu_torch/node/ethereum.py")]


@pytest.fixture(scope="module")
def det_pass():
    return run_determinism_pass("cpu")


class TestRuntimeLeg:
    def test_every_converge_bit_equal_across_runs_and_processes(self, det_pass):
        findings, section = det_pass
        assert findings == [], [f.render() for f in findings]
        assert sorted(section["backends"]) == sorted(card_backends())
        for name, rec in section["backends"].items():
            assert rec["bit_equal"], name
            assert len(rec["in_process"]) == 2
            assert rec["fresh_process"] == rec["in_process"][0], name
        assert section["stale_waivers"] == []
        assert [w["symbol"] for w in section["waived"]] == ["random.Random"]
        assert section["fresh_process_launches"] == dict.fromkeys(
            section["fresh_process_launches"], 0)  # the plain path launches nothing

    def test_run_order_fixture_caught(self):
        assert [f.rule for f in run_fixture("det-run-order", "cpu")] == [
            "nondeterministic-converge"]

    def test_digest_covers_bits_iterations_and_residual(self):
        t = torch.tensor([0.5, 0.25, 0.25])
        base = digest((t, 3, torch.tensor(1e-7)))
        assert digest((t.clone(), 3, torch.tensor(1e-7))) == base
        assert digest((torch.tensor([0.5, 0.25, 0.2500001]), 3, torch.tensor(1e-7))) != base
        assert digest((t, 4, torch.tensor(1e-7))) != base
        assert digest((t, 3, torch.tensor(2e-7))) != base
        assert digest((torch.tensor([0.0, -0.0]), 1, 0.0)) != digest(
            (torch.tensor([0.0, 0.0]), 1, 0.0))  # bits, not values

    def test_process_disagreement_is_its_own_rule(self):
        assert check_replays("x", ["a", "a"], "a") == []
        assert [f.rule for f in check_replays("x", ["a", "a"], "b")] == [
            "nondeterministic-process"]
        assert [f.rule for f in check_replays("x", ["a", "b"], None)] == [
            "nondeterministic-converge"]


class TestAtomicsScan:
    def test_float_atomic_flagged(self):
        src = (
            "__global__ void k(float* out, const float* v, const int* idx, int n) {\n"
            "  int i = threadIdx.x;\n"
            "  if (i < n) atomicAdd(&out[idx[i]], v[i]);\n"
            "}\n"
        )
        found = scan_atomics_source(src, "protocol_tpu_torch/ops/csrc/k.cu")
        assert [(f.rule, f.line) for f in found] == [("float-atomic", 3)]

    @pytest.mark.parametrize("call", [
        "atomicAdd((double*)p, 1.0)",
        "atomicAdd_block(&acc, x)",
        "unsafeAtomicAdd(reinterpret_cast<float*>(p), x)",
    ])
    def test_float_atomic_forms(self, call):
        src = f"__device__ double acc;\n__device__ void f(void* p, double x) {{ {call}; }}\n"
        assert [f.rule for f in scan_atomics_source(src, "k.cu")] == ["float-atomic"]

    def test_integer_atomic_is_quiet(self):
        src = (
            "__global__ void k(unsigned int* hist, const int* keys, int n) {\n"
            "  int i = threadIdx.x;\n"
            "  if (i < n) atomicAdd(&hist[keys[i]], 1u);\n"
            "}\n"
        )
        assert scan_atomics_source(src, "k.cu") == []

    def test_kernel_sources_clean(self):
        findings, n = scan_atomics()
        assert findings == []
        assert n == len([p for p in (REPO / "protocol_tpu_torch/ops/csrc").iterdir()
                         if p.suffix in (".cu", ".cuh")])
        assert n >= 15


class TestWaivers:
    def test_table_is_enumerated(self):
        assert [(w.rule, w.file, w.symbol) for w in DET_WAIVERS] == [
            ("unseeded-rng", "protocol_tpu_torch/node/ethereum.py", "random.Random")]

    def test_dead_waiver_is_an_error(self):
        findings, _ = run_det_ast_pass()
        bogus = Waiver("hash-ordering", "protocol_tpu_torch/node/wal.py", "hash(", "test")
        live, _, stale = apply_waivers(findings, DET_WAIVERS + (bogus,), "determinism")
        assert [f.rule for f in live] == ["stale-waiver"]
        assert [s["symbol"] for s in stale] == ["hash("]

    def test_unjudged_rule_cannot_go_stale(self):
        bogus = Waiver(RUNTIME_RULES[0], "x", "y", "test")
        live, _, stale = apply_waivers([], (bogus,), "determinism", judged=("unseeded-rng",))
        assert live == [] and stale == []
