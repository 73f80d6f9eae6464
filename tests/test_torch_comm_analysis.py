"""The port's comm pass (``protocol_tpu_torch.analysis.comm``) on the CPU:
both sharded composites on 2 gloo ranks at the reference's two scales
(E x4, N x2), the three comm fixtures caught on 2 ranks, and the
reference's ``TestPodAnalyzers`` (``tests/test_pod.py:194``) re-targeted
at the port's budgets.
"""

import pytest

from protocol_tpu_torch.analysis.budget import COMM_INVARIANTS, MEM_INVARIANTS, CommBudget
from protocol_tpu_torch.analysis.comm import (
    COMM_SCALES,
    COMM_WAIVERS,
    CommCase,
    check_comm_case,
    check_scaling,
    run_comm_pass,
)
from protocol_tpu_torch.analysis.comm.checker import COMM_RANKS
from protocol_tpu_torch.analysis.concurrency.waivers import Waiver, apply_waivers
from protocol_tpu_torch.analysis.fixtures import FIXTURES, run_fixture
from protocol_tpu_torch.analysis.memory import pod_budget_view
from protocol_tpu_torch.trust.backend import registered_backends  # declares the budgets

SHARDED = sorted(n for n in registered_backends() if n.startswith("cuda-sharded:"))


@pytest.fixture(scope="module")
def comm_pass():
    return run_comm_pass("cpu")


class TestRealComposites:
    def test_clean(self, comm_pass):
        findings, section = comm_pass
        assert findings == [], [f.render() for f in findings]
        assert section["stale_waivers"] == [] and COMM_WAIVERS == ()

    @pytest.mark.parametrize("name", SHARDED)
    def test_one_all_reduce_of_4n_bytes_a_step_at_both_scales(self, comm_pass, name):
        _, section = comm_pass
        recs = section["backends"][name]["scales"]
        assert len(recs) == COMM_RANKS * len(COMM_SCALES)
        for r in recs:
            assert r["calls_per_step"] == {"all_reduce_sum": 1.0}
            assert r["bytes_per_step"] == 4 * r["dims"]["n"] == r["budget_bytes_per_step"]
            assert r["subgroup_calls"] == 0
            assert r["dims"]["n_shards"] == COMM_RANKS
        by_rank = {}
        for r in recs:
            by_rank.setdefault(r["rank"], []).append(r)
        for rank_recs in by_rank.values():
            small, large = sorted(rank_recs, key=lambda r: r["dims"]["n"])
            assert large["dims"]["edges"] > 3.9 * small["dims"]["edges"]
            assert large["bytes_per_step"] == 2 * small["bytes_per_step"]  # N's growth, not E's


@pytest.mark.parametrize("name", sorted(n for n, f in FIXTURES.items() if f.kind == "comm"))
def test_comm_fixture_caught_on_two_ranks(name):
    findings = run_fixture(name, "cpu")
    assert {f.rule for f in findings} == {FIXTURES[name].rule}
    assert len(findings) == 2  # each rank's record


def rank_case(calls=2, nbytes=8192, subgroup=0, n=1024, e=4096, steps=2):
    return CommCase("cuda-sharded:cuda-windowed", {"n": n, "edges": e, "n_shards": 4}, steps,
                    {"all_reduce_sum": calls}, nbytes, subgroup)


class TestChecker:
    def test_on_budget(self):
        findings, record = check_comm_case(COMM_INVARIANTS["cuda-sharded:cuda-csr"], rank_case())
        assert findings == [] and record["bytes_per_step"] == 4096

    def test_edge_growth_is_flagged(self):
        first = rank_case(nbytes=2 * 4096, n=1024, e=4096)
        second = rank_case(nbytes=2 * 4 * 4096 * 4, n=2048, e=16384)  # bytes follow E
        assert [f.rule for f in check_scaling("b", first, second)] == ["comm-bytes-scaling"]
        assert check_scaling("b", first, rank_case(nbytes=2 * 8192, n=2048, e=16384)) == []

    def test_stale_waiver_is_an_error(self):
        bogus = Waiver("collective-count", "x", "y", "test")
        live, _, stale = apply_waivers([], COMM_WAIVERS + (bogus,), "comm")
        assert [f.rule for f in live] == ["stale-waiver"] and stale[0]["symbol"] == "y"


class TestPodAnalyzers:
    """``tests/test_pod.py:194`` re-targeted: the pod's per-shard memory
    view from the port's budgets, and the pod doctrine that the
    boundary-completing all-reduce covers the whole group."""

    def test_pod_budget_view_divides_edges_by_global_shards(self):
        budget = MEM_INVARIANTS["cuda-sharded:cuda-csr"]
        dims = dict(n=4096, edges=1 << 20, n_segments=0, rows=0)
        one = pod_budget_view(budget, n_shards=8, n_hosts=1, **dims)
        pod = pod_budget_view(budget, n_shards=32, n_hosts=4, **dims)
        assert pod["n_hosts"] == 4 and pod["n_shards"] == 32
        assert pod["resident_bytes"] < one["resident_bytes"]
        assert pod["transient_bytes"] == one["transient_bytes"]
        assert pod["peak_bytes"] == pod["resident_bytes"] + pod["transient_bytes"]

    def test_pod_budget_view_windowed_scales_with_per_host_plan(self):
        budget = MEM_INVARIANTS["cuda-sharded:cuda-windowed"]
        assert budget.resident_edge_bytes == 0.0
        one = pod_budget_view(budget, n=4096, edges=1 << 20, n_segments=2048, rows=512,
                              n_shards=8, n_hosts=1)
        pod = pod_budget_view(budget, n=4096, edges=1 << 20, n_segments=512, rows=128,
                              n_shards=32, n_hosts=4)
        assert pod["peak_bytes"] < one["peak_bytes"]

    def test_per_host_subgroup_all_reduce_is_rejected(self):
        budget = COMM_INVARIANTS["cuda-sharded:cuda-windowed"]
        findings, _ = check_comm_case(budget, rank_case(subgroup=2))
        assert [f.rule for f in findings] == ["replica-group-coverage"]

    def test_full_group_passes(self):
        budget = COMM_INVARIANTS["cuda-sharded:cuda-windowed"]
        findings, _ = check_comm_case(budget, rank_case(subgroup=0))
        assert "replica-group-coverage" not in [f.rule for f in findings]

    def test_fixture_budget_is_the_composites(self):
        fixture = CommBudget("fixture", {"all_reduce_sum": 1}, bytes_n=4.0)
        for name in SHARDED:
            b = COMM_INVARIANTS[name]
            assert (b.calls_per_step, b.bytes_n) == (fixture.calls_per_step, fixture.bytes_n)
