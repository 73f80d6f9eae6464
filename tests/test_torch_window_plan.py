"""The port's host-built ``WindowPlan`` against the JAX package's.

The plan is numpy in both packages, so every field must be equal array
for array: the device tables (``_CORE``), the delta bookkeeping
(``_HOST``), the sizes (``_META``), the fingerprint and the
bucket↔edge maps — for dst-sorted and unsorted input, along a
multi-epoch ``try_plan_delta`` chain, and through the checkpoint
sidecar format, which must load in both directions.
"""

import numpy as np
import pytest

from protocol_tpu.models.churn import churn_cohort_dims, sender_centric_churn
from protocol_tpu.models.graphs import scale_free
from protocol_tpu.ops import gather_window as jgw
from protocol_tpu_torch.ops import gather_window as tgw

FIELDS = jgw.WindowPlan._CORE + jgw.WindowPlan._HOST


def same_plan(a, b) -> None:
    assert tgw.WindowPlan._CORE == jgw.WindowPlan._CORE
    assert tgw.WindowPlan._HOST == jgw.WindowPlan._HOST
    assert tgw.WindowPlan._META == jgw.WindowPlan._META
    for k in jgw.WindowPlan._META:
        assert getattr(a, k) == getattr(b, k), k
    for k in FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert a.fingerprint == b.fingerprint
    assert a.version == b.version == 3
    assert a.lineage == b.lineage
    for k in ("order", "out_pos"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=k)


def normalized(g):
    g = g.drop_self_edges()
    w, _ = g.row_normalized()
    return type(g)(g.n, g.src, g.dst, w, g.pre_trusted)


@pytest.fixture(scope="module", params=[(2500, 30_000), (4096, 60_000)], ids=["n2500", "n4096"])
def graph(request):
    n, e = request.param
    return normalized(scale_free(n, e, seed=5))


@pytest.mark.parametrize("dst_sorted", [True, False], ids=["dst-sorted", "unsorted"])
def test_build_window_plan_identical(graph, dst_sorted):
    g = graph.sorted_by_dst() if dst_sorted else graph
    args = (g.src, g.dst, g.weight)
    same_plan(tgw.build_window_plan(*args, n=g.n), jgw.build_window_plan(*args, n=g.n))


@pytest.mark.parametrize("spare_rows", [0, None, 200])
def test_bucket_by_window_identical(graph, spare_rows):
    kw = dict(table_size=graph.n, spare_rows=spare_rows)
    for extra in ({}, dict(dst=graph.dst, n_dst=graph.n)):
        t = tgw.bucket_by_window(graph.src, graph.weight, **kw, **extra)
        j = jgw.bucket_by_window(graph.src, graph.weight, **kw, **extra)
        assert t.keys() == j.keys()
        for k in j:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_bucket_by_window_rejects_bad_indices(graph):
    bad = graph.src.copy()
    bad[3] = graph.n
    with pytest.raises(ValueError, match="src index"):
        tgw.bucket_by_window(bad, graph.weight, table_size=graph.n)
    with pytest.raises(ValueError, match="n_dst"):
        tgw.bucket_by_window(graph.src, graph.weight, table_size=graph.n, dst=graph.dst)


def test_counting_sort_numpy_fallback_matches_scipy(monkeypatch):
    key = np.random.default_rng(1).integers(0, 50, 5000).astype(np.int32)
    payload = np.arange(5000, dtype=np.int64)
    fast = tgw._counting_sort(key, 50, payload)
    monkeypatch.setattr(tgw, "_scipy_sparsetools", None)
    slow = tgw._counting_sort(key, 50, payload)
    for a, b in zip(fast, slow):
        np.testing.assert_array_equal(a, b)


def test_graph_fingerprint_identical(graph):
    args = (graph.n, graph.src, graph.dst, graph.weight)
    assert tgw.graph_fingerprint(*args) == jgw.graph_fingerprint(*args)
    w2 = graph.weight.copy()
    w2[0] += 1.0
    assert tgw.graph_fingerprint(graph.n, graph.src, graph.dst, w2) != tgw.graph_fingerprint(*args)


def test_try_plan_delta_chain_identical():
    """Three epochs of sender-centric churn folded into each package's
    plan: the same outcomes (delta or None) and the same arrays."""
    g = scale_free(4096, 60_000, seed=9).drop_self_edges()
    gn = normalized(g)
    tplan = tgw.build_window_plan(gn.src, gn.dst, gn.weight, n=gn.n)
    jplan = jgw.build_window_plan(gn.src, gn.dst, gn.weight, n=gn.n)
    rng = np.random.default_rng(7)
    cohort, deg = churn_cohort_dims(g, 0.01)
    outcomes = []
    for _ in range(3):
        rows, g, _ = sender_centric_churn(rng, g, cohort_size=cohort, deg=deg)
        gn = normalized(g)
        fp = jgw.graph_fingerprint(gn.n, gn.src, gn.dst, gn.weight)
        args = (gn.src, gn.dst, gn.weight)
        tnew = tgw.try_plan_delta(tplan, *args, n=gn.n, rows=rows, fingerprint=fp)
        jnew = jgw.try_plan_delta(jplan, *args, n=gn.n, rows=rows, fingerprint=fp)
        assert (tnew is None) == (jnew is None)
        outcomes.append(jnew is not None)
        if jnew is not None:
            same_plan(tnew, jnew)
            tplan, jplan = tnew, jnew
    assert any(outcomes), "the chain never took the delta path"
    assert len(tplan.lineage) == sum(outcomes)


def test_apply_delta_errors_match():
    g = normalized(scale_free(2000, 15_000, seed=4))
    tplan = tgw.build_window_plan(g.src, g.dst, g.weight, n=g.n)
    with pytest.raises(tgw.PlanDeltaError, match="shrank"):
        tplan.apply_delta(None, None, n=g.n - 1, fingerprint="x")
    with pytest.raises(tgw.PlanDeltaError, match="absent"):
        tplan.apply_delta(None, (np.array([0]), np.array([0])), fingerprint="x")


def test_partition_delta_identical(graph):
    owner = (np.arange(graph.n) * 2654435761 % 3).astype(np.int32)
    rows = np.array([5, 17, 1000, 2047])
    for host in range(3):
        for r in (rows, None):
            t = tgw.partition_delta(r, graph.src, graph.dst, graph.weight, owner, host)
            j = jgw.partition_delta(r, graph.src, graph.dst, graph.weight, owner, host)
            for a, b in zip(t, j):
                if b is None:
                    assert a is None
                else:
                    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("core_only", [True, False])
def test_checkpoint_sidecar_cross_loads(graph, tmp_path, core_only):
    tplan = tgw.build_window_plan(graph.src, graph.dst, graph.weight, n=graph.n)
    jplan = jgw.build_window_plan(graph.src, graph.dst, graph.weight, n=graph.n)
    np.savez(tmp_path / "port.plan.npz", **tplan.to_arrays(core_only=core_only))
    np.savez(tmp_path / "ref.plan.npz", **jplan.to_arrays(core_only=core_only))
    with np.load(tmp_path / "port.plan.npz") as z:
        jload = jgw.WindowPlan.from_arrays(z)
    with np.load(tmp_path / "ref.plan.npz") as z:
        tload = tgw.WindowPlan.from_arrays(z)
    same_plan(tload, jload)
    if not core_only:
        same_plan(tload, tplan)


def test_stale_plan_version_raises(graph):
    arrays = tgw.build_window_plan(graph.src, graph.dst, graph.weight, n=graph.n).to_arrays()
    arrays["version"] = np.int64(2)
    with pytest.raises(ValueError, match="stale"):
        tgw.WindowPlan.from_arrays(arrays)
    del arrays["version"]
    with pytest.raises(ValueError, match="v1"):
        tgw.WindowPlan.from_arrays(arrays)
