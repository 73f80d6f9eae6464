"""The port's sharded converge (``cuda-sharded:cuda-csr`` and
``:cuda-windowed``) on gloo ranks on the CPU, held against the reference.

The ranks are processes spawned by ``parallel.launch.run_ranks``, a few
module-scoped launches of 8, 4, 2 and 1 ranks; the reference runs in
this process on conftest's 8-device virtual mesh.  Tolerances:

- host layouts (``problem_arrays``, ``_partition_plan_arrays``): bit for
  bit against the reference's;
- sharded CSR against ``tpu-sharded:tpu-csr``: equal iterations, the
  residual history within rtol 1e-3 and atol 1e-7 (an L1 residual over n
  entries of ~1/n carries a float32 rounding floor of ~6e-8, which the
  late residuals near tol 1e-6 reach; ``tests/test_torch_converge.py``
  holds histories so), scores within rtol 1e-3 / atol 1e-8 (the
  reference's cross-backend tolerance);
- sharded windowed: L1 ≤ 1e-5 against the reference's single-device
  windowed converge (its sharded windowed converge raises on this tree's
  jax, ROADMAP §C R1), L1 ≤ 1e-6 against the port's ``cuda-windowed``;
- one rank against the single-device backends: bit for bit;
- every rank of a launch: the same bits.
"""

import json
import logging
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from protocol_tpu.parallel.mesh import default_mesh as jmesh
from protocol_tpu.parallel.sharded import ShardedTrustProblem as JProblem
from protocol_tpu.parallel.sharded import _partition_plan_arrays as j_partition
from protocol_tpu.ops.gather_window import build_window_plan as j_build_plan
from protocol_tpu.trust.backend import get_backend as jget
from protocol_tpu.trust.graph import TrustGraph as JGraph
from protocol_tpu_torch.analysis.budget import COMM_INVARIANTS, KERNEL_INVARIANTS
from protocol_tpu_torch.models.graphs import erdos_renyi, scale_free
from protocol_tpu_torch.node import manager as manager_mod
from protocol_tpu_torch.node.manager import Manager, ManagerConfig
from protocol_tpu_torch.ops.gather_window import WINDOW, build_window_plan
from protocol_tpu_torch.parallel import dryrun
from protocol_tpu_torch.parallel.launch import run_ranks
from protocol_tpu_torch.parallel.mesh import default_mesh
from protocol_tpu_torch.parallel.sharded import _partition_plan_arrays, problem_arrays
from protocol_tpu_torch.trust.backend import get_backend, registered_backends
from protocol_tpu_torch.trust.graph import TrustGraph

REPO = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT_S = 300
CSR_KW = dict(alpha=0.1, tol=1e-6, max_iter=60)
WIN_KW = dict(alpha=0.1, tol=1e-9, max_iter=40)
#: Score rows of the bootstrap group (each sums to SCALE, no self score).
ROWS = [
    [0, 400, 300, 200, 100],
    [250, 0, 250, 250, 250],
    [500, 300, 0, 100, 100],
    [100, 200, 300, 0, 400],
    [200, 200, 200, 400, 0],
]


def l1(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).sum())


def ref(g: TrustGraph) -> JGraph:
    return JGraph(g.n, g.src, g.dst, g.weight, g.pre_trusted)


def straddle_graph() -> TrustGraph:
    """``tests/test_windowed_pipeline.py``'s sharded windowed graph: N off
    the window size over several windows, enough rows for several shards,
    three peers made dangling."""
    g = scale_free(2 * WINDOW + 901, 70_000, seed=31)
    keep = ~np.isin(g.src, np.array([3, 700, 2948], np.int32))
    return TrustGraph(g.n, g.src[keep], g.dst[keep], g.weight[keep], g.pre_trusted)


def csr_graph() -> TrustGraph:
    return scale_free(1000, 8000, seed=5)


def padding_graph() -> TrustGraph:
    return erdos_renyi(50, avg_degree=3.1, seed=7)


def normalized_plan(g: TrustGraph):
    gd = g.drop_self_edges()
    w, _ = gd.row_normalized()
    return build_window_plan(gd.src, gd.dst, w, n=gd.n)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's in-process converges run one intra-op thread, as
    the ranks do: on a loaded host, thread pools in many processes stall
    one another (and the 1-rank comparisons stay like for like)."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def launch(size, jobs):
    return run_ranks(size, dryrun.jobs_rank, jobs, backend="gloo", device="cpu",
                     timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def eight():
    """One launch of 8 ranks: CSR on the reference's CSR graph, both
    kernels on the straddling graph (the windowed one also from a
    restored plan), both on the padding graph."""
    g = straddle_graph()
    return launch(8, [
        (dryrun.converge_rank, (csr_graph(), ("cuda-csr",), dict(CSR_KW, record_residuals=True))),
        (dryrun.converge_rank, (g, ("cuda-windowed", "cuda-csr"), WIN_KW)),
        (dryrun.converge_rank, (g, ("cuda-windowed",), WIN_KW, normalized_plan(g))),
        (dryrun.converge_rank, (padding_graph(), ("cuda-csr", "cuda-windowed"),
                                dict(alpha=0.2, tol=1e-6, max_iter=30))),
    ])


@pytest.fixture(scope="module")
def four():
    return launch(4, [(dryrun.converge_rank, (straddle_graph(), ("cuda-windowed",), WIN_KW))])


@pytest.fixture(scope="module")
def one():
    return launch(1, [(dryrun.converge_rank, (straddle_graph(), ("cuda-csr", "cuda-windowed"), WIN_KW))])


@pytest.fixture(scope="module")
def port_windowed():
    return get_backend("cuda-windowed", device="cpu").converge(straddle_graph(), **WIN_KW)


@pytest.fixture(scope="module")
def ref_windowed():
    return jget("tpu-windowed").converge(ref(straddle_graph()), **WIN_KW)


# ---------------------------------------------------------------------------
# Host layouts, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", [padding_graph, csr_graph, straddle_graph])
def test_problem_arrays_equal_the_reference(make):
    g = make()
    ours = problem_arrays(g, 8)
    theirs = JProblem.build(ref(g), jmesh(8))
    assert ours["src"].shape[0] % 8 == 0
    for key, j in (("src", theirs.src), ("w", theirs.w), ("row_ptr", theirs.row_ptr),
                   ("p", theirs.p), ("dangling", theirs.dangling)):
        a, b = ours[key], np.asarray(j)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), key


@pytest.mark.parametrize("n_shards", [8, 4, 1])
def test_partition_plan_arrays_equal_the_reference(n_shards):
    g = straddle_graph().drop_self_edges()
    w, _ = g.row_normalized()
    ours = _partition_plan_arrays(build_window_plan(g.src, g.dst, w, n=g.n), n_shards)
    theirs = j_partition(j_build_plan(g.src, g.dst, w, n=g.n), n_shards)
    assert ours.keys() == theirs.keys()
    for key in ours:
        a, b = np.asarray(ours[key]), np.asarray(theirs[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a, b), key
    if n_shards == 8:
        runs = ours["dst_ptr"][:, -1]
        assert (runs > 0).sum() >= 2, runs
        per_dst = np.diff(ours["dst_ptr"], axis=1)
        assert ((per_dst > 0).sum(axis=0) >= 2).sum() > 0
        assert ours["seg_end"].min() >= 0
        assert ours["seg_end"].max() < ours["rows_per_shard"] * 1024


def test_partition_forced_dimensions_keep_the_reference_checks():
    plan = normalized_plan(straddle_graph())
    base = _partition_plan_arrays(plan, 8)
    wide = _partition_plan_arrays(plan, 8, rows_per_shard=base["rows_per_shard"] + 64,
                                  s_max=base["s_max"] + 1024)
    assert wide["rows_per_shard"] == base["rows_per_shard"] + 64
    assert wide["s_max"] == base["s_max"] + 1024
    with pytest.raises(ValueError, match="rows_per_shard"):
        _partition_plan_arrays(plan, 8, rows_per_shard=base["rows_per_shard"] + 1)
    with pytest.raises(ValueError, match="s_max"):
        _partition_plan_arrays(plan, 8, s_max=base["s_max"] - 1024)


# ---------------------------------------------------------------------------
# Converges on 8, 4 and 1 ranks
# ---------------------------------------------------------------------------


def test_every_rank_holds_the_same_bits(eight, four):
    for results in (eight, four):
        for job in range(len(results[0])):
            for kernel, rec in results[0][job].items():
                if kernel == "loaded_forbidden":
                    continue
                for other in results[1:]:
                    assert np.array_equal(other[job][kernel]["scores"], rec["scores"]), kernel
                    assert other[job][kernel]["iterations"] == rec["iterations"]


def test_one_all_reduce_of_n_floats_a_step(eight):
    for job in eight[0]:
        for kernel, rec in job.items():
            if kernel == "loaded_forbidden":
                continue
            n = rec["scores"].shape[0]
            budget = COMM_INVARIANTS[f"cuda-sharded:{kernel}"]
            assert rec["all_reduce"] == {"calls": rec["iterations"], "bytes": rec["iterations"] * 4 * n}
            assert budget.expected(rec["iterations"], n) == {
                "all_reduce_sum": rec["iterations"], "bytes": rec["iterations"] * 4 * n,
            }
            # The plain versions count no kernel launch on the CPU.
            assert not any(rec["launches"].values())


def test_sharded_csr_matches_the_reference_sharded_csr(eight):
    ours = eight[0][0]["cuda-csr"]
    theirs = jget("tpu-sharded").converge(ref(csr_graph()), **CSR_KW)
    assert ours["backend"] == "cuda-sharded"
    assert ours["iterations"] == theirs.iterations
    np.testing.assert_allclose(ours["residuals"], theirs.residuals, rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(ours["scores"], theirs.scores, rtol=1e-3, atol=1e-8)


@pytest.mark.parametrize("size", [8, 4])
def test_sharded_windowed_matches_the_windowed_converges(size, eight, four, port_windowed,
                                                         ref_windowed):
    ours = (eight[0][1] if size == 8 else four[0][0])["cuda-windowed"]
    assert ours["backend"] == "cuda-sharded:cuda-windowed"
    assert l1(ours["scores"], ref_windowed.scores) <= 1e-5
    assert l1(ours["scores"], port_windowed.scores) <= 1e-6
    assert ours["iterations"] == port_windowed.iterations
    assert ours["scores"].sum() == pytest.approx(1.0, rel=1e-5)


def test_sharded_kernels_agree_on_the_straddling_graph(eight):
    rec = eight[0][1]
    assert l1(rec["cuda-windowed"]["scores"], rec["cuda-csr"]["scores"]) <= 1e-5


def test_padding_graph_converges_on_8_ranks(eight):
    for kernel, rec in eight[0][3].items():
        if kernel != "loaded_forbidden":
            assert rec["scores"].sum() == pytest.approx(1.0, rel=1e-5), kernel


def test_restored_plan_skips_the_rebuild(eight, port_windowed):
    """A fingerprint-valid plan handed to every rank is reused: no rank
    rebuilds it, and the converge equals the one that built its own."""
    for rank in eight:
        rec = rank[2]["cuda-windowed"]
        assert rec["plan_outcome"] == {"reuse": 1, "delta": 0, "rebuild": 0}
        assert rec["plan_reused"]
        assert rank[1]["cuda-windowed"]["plan_outcome"] == {"reuse": 0, "delta": 0, "rebuild": 1}
    assert np.array_equal(eight[0][2]["cuda-windowed"]["scores"], eight[0][1]["cuda-windowed"]["scores"])


@pytest.mark.parametrize("kernel,single", [("cuda-csr", "cuda-csr"), ("cuda-windowed", "cuda-windowed")])
def test_one_rank_equals_the_single_device_backend_bit_for_bit(one, kernel, single):
    ours = one[0][0][kernel]
    theirs = get_backend(single, device="cpu").converge(straddle_graph(), **WIN_KW)
    assert ours["iterations"] == theirs.iterations
    assert np.array_equal(ours["scores"], theirs.scores)
    assert np.array_equal(ours["residuals"], theirs.residuals)


def test_ranks_load_neither_jax_nor_the_reference(eight, one):
    assert all(job["loaded_forbidden"] == [] for results in (eight, one)
               for rank in results for job in rank)


# ---------------------------------------------------------------------------
# Registry, mesh and manager
# ---------------------------------------------------------------------------


def test_registry_expands_the_sharded_composites_in_the_reference_order():
    assert registered_backends() == [
        "native-cpu", "cuda-dense", "cuda-sparse", "cuda-csr", "cuda-windowed",
        "cuda-sharded:cuda-csr", "cuda-sharded:cuda-windowed",
    ]
    for name in registered_backends()[-2:]:
        assert name in KERNEL_INVARIANTS and name in COMM_INVARIANTS
    assert (KERNEL_INVARIANTS["cuda-sharded:cuda-csr"].launches_per_step
            == KERNEL_INVARIANTS["cuda-csr"].launches_per_step)
    assert (KERNEL_INVARIANTS["cuda-sharded:cuda-windowed"].launches_per_step
            == KERNEL_INVARIANTS["cuda-windowed"].launches_per_step)


def test_get_backend_parses_the_kernel_suffix():
    assert get_backend("cuda-sharded", device="cpu").kernel == "cuda-csr"
    assert get_backend("cuda-sharded:cuda-windowed", device="cpu").kernel == "cuda-windowed"
    with pytest.raises(ValueError, match="unknown sharded kernel"):
        get_backend("cuda-sharded:bogus", device="cpu")
    with pytest.raises(ValueError, match="unknown trust backend"):
        get_backend("cuda-csr:cuda-windowed", device="cpu")
    with pytest.raises(ValueError, match="unknown trust backend"):
        get_backend("tpu-sharded:tpu-csr", device="cpu")


def test_default_mesh_outside_a_group_raises():
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        default_mesh()
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        get_backend("cuda-sharded", device="cpu").converge(padding_graph())


def test_manager_warns_on_a_sharded_backend_without_a_comm_budget(monkeypatch, caplog):
    cfg = dict(device="cpu", prover="commitment", check_circuit=False)
    with caplog.at_level(logging.WARNING, logger=manager_mod.__name__):
        Manager(ManagerConfig(backend="cuda-sharded", **cfg))
        Manager(ManagerConfig(backend="cuda-sharded:cuda-windowed", **cfg))
    assert "COMM_INVARIANTS" not in caplog.text
    monkeypatch.delitem(COMM_INVARIANTS, "cuda-sharded:cuda-csr")
    with caplog.at_level(logging.WARNING, logger=manager_mod.__name__):
        Manager(ManagerConfig(backend="cuda-sharded", **cfg))
    assert "no COMM_INVARIANTS declaration" in caplog.text


def test_two_rank_node_matches_the_windowed_node():
    single = dryrun.run_node("cuda-windowed", "cpu", ROWS)
    ranks = run_ranks(2, dryrun.node_rank, "cuda-sharded:cuda-windowed", ROWS, backend="gloo",
                      device="cpu", timeout_s=TIMEOUT_S)
    assert [e["iterations"] for e in single] == [e["iterations"] for e in ranks[0]]
    for ours, theirs in zip(ranks[0], single):
        assert ours["backend"] == "cuda-sharded:cuda-windowed"
        assert l1(ours["scores"], theirs["scores"]) <= 1e-6
    for a, b in zip(ranks[0], ranks[1]):
        assert np.array_equal(a["scores"], b["scores"])


# ---------------------------------------------------------------------------
# The launcher and the dry run
# ---------------------------------------------------------------------------


def test_a_dead_rank_fails_the_launch_at_once():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited with code 3"):
        run_ranks(2, dryrun.stall_rank, 1, 0.0, backend="gloo", device="cpu", timeout_s=60)
    assert time.monotonic() - t0 < 30


def test_a_stalled_launch_is_killed_at_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still ran after"):
        run_ranks(1, dryrun.stall_rank, -1, 600.0, backend="gloo", device="cpu", timeout_s=4)
    assert time.monotonic() - t0 < 30


def test_the_launcher_takes_no_backend_it_was_not_given():
    with pytest.raises(TypeError):
        run_ranks(1, dryrun.loaded_modules, device="cpu", timeout_s=10)  # no backend
    with pytest.raises(ValueError, match="unknown collective backend"):
        run_ranks(1, dryrun.loaded_modules, backend="mpi", device="cpu", timeout_s=10)


def test_dryrun_on_8_cpu_ranks():
    out = subprocess.run(
        [sys.executable, "-m", "protocol_tpu_torch.parallel.dryrun", "--ranks", "8",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT_S,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["ranks"] == 8 and rec["windowed_l1_drift"] < 1e-4
    for kernel in ("cuda-csr", "cuda-windowed"):
        assert rec["kernels"][kernel]["all_reduce_calls_per_step"] == 1.0
        assert rec["kernels"][kernel]["all_reduce_bytes_per_step"] == 4 * 512
