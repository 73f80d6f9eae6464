"""Convergence parity of the PyTorch port against the JAX package, on
the CPU (the port's plain versions; the JAX windowed gather in Pallas
interpret mode, as tests/test_windowed_pipeline.py runs it).

Tolerances: iteration counts equal; scores L1 ≤ 1e-6; residual
histories rtol 1e-3 with atol 1e-7.  The epilogue's float32 sums run
in another order, so each step's scores differ by float32 rounding,
and an L1 residual over n entries of size ~1/n carries an absolute
rounding floor of about n · (1/n) · 2⁻²⁴ ≈ 6e-8 — late residuals near
tol=1e-6 agree only to that floor.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protocol_tpu.models.churn import churn_cohort_dims, sender_centric_churn
from protocol_tpu.models.graphs import erdos_renyi, scale_free
from protocol_tpu.obs.metrics import PLAN_OUTCOMES
from protocol_tpu.ops import gather_window as jgw
from protocol_tpu.ops import sparse as jsp
from protocol_tpu.trust.backend import get_backend as jget
from protocol_tpu_torch.models.eigentrust import EigenTrustModel
from protocol_tpu_torch.ops import gather_window as tgw
from protocol_tpu_torch.ops import sparse as tsp
from protocol_tpu_torch.trust.backend import get_backend as tget
from protocol_tpu_torch.trust.graph import TrustGraph

L1_TOL = 1e-6
RESID_RTOL, RESID_ATOL = 1e-3, 1e-7


def l1(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).sum())


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def agree(port, ref) -> None:
    """``(t, it, resid, hist)`` tuples from both packages agree."""
    assert int(port[1]) == int(ref[1])
    assert l1(port[0], ref[0]) <= L1_TOL
    it = int(ref[1])
    np.testing.assert_allclose(
        port[3].numpy()[:it], np.asarray(ref[3])[:it], rtol=RESID_RTOL, atol=RESID_ATOL
    )
    np.testing.assert_allclose(float(port[2]), float(ref[2]), rtol=RESID_RTOL, atol=RESID_ATOL)


@pytest.fixture(scope="module")
def problem():
    """Normalized dst-sorted scale-free graph over three windows (n not
    a multiple of 1024) with dangling rows, its plan and vectors."""
    g = scale_free(2500, 30_000, seed=21).drop_self_edges()
    keep = ~np.isin(g.src, [0, 1, 2499])
    g = TrustGraph(g.n, g.src[keep], g.dst[keep], g.weight[keep], g.pre_trusted)
    w, dangling = g.row_normalized()
    g = TrustGraph(g.n, g.src, g.dst, w, g.pre_trusted).sorted_by_dst()
    plan = jgw.build_window_plan(g.src, g.dst, g.weight, n=g.n)
    p = g.pre_trust_vector()
    warm = np.random.default_rng(3).random(g.n).astype(np.float32)
    warm /= warm.sum()
    return g, dangling.astype(np.float32), plan, p, warm


CASES = [(1e-6, 60, False), (0.0, 20, False), (1e-6, 60, True)]
CASE_IDS = ["tol1e-6", "tol0-20", "tol1e-6-warm"]


@pytest.mark.parametrize("tol, max_iter, warm", CASES, ids=CASE_IDS)
def test_converge_csr_matches_reference(problem, tol, max_iter, warm):
    g, d, _, p, w0 = problem
    t0 = w0 if warm else p
    args = (g.src, g.row_ptr_by_dst(), g.weight, t0, p, d)
    kw = dict(tol=tol, max_iter=max_iter, record_residuals=True)
    ref = jsp.converge_csr(*map(jnp.asarray, args), alpha=np.float32(0.1), **kw)
    port = tsp.converge_csr(*map(t, args), alpha=0.1, **kw)
    agree(port, ref)


@pytest.mark.parametrize("tol, max_iter, warm", CASES, ids=CASE_IDS)
def test_converge_windowed_matches_reference(problem, tol, max_iter, warm):
    _, d, plan, p, w0 = problem
    t0 = w0 if warm else p
    kw = dict(
        n_rows=plan.n_rows, table_entries=plan.table_entries, tol=tol,
        max_iter=max_iter, record_residuals=True,
    )
    ref = jgw.converge_windowed(
        *plan.device_args(), jnp.asarray(t0), jnp.asarray(p), jnp.asarray(d),
        alpha=jax.device_put(np.float32(0.1)), interpret=True, **kw,
    )
    tplan = tgw.WindowPlan.from_arrays(plan.to_arrays())
    port = tgw.converge_windowed(
        *tplan.device_args("cpu"), t(t0), t(p), t(d), alpha=0.1, **kw
    )
    agree(port, ref)


@pytest.mark.parametrize("tol", [1e-6, 0.0], ids=["tol1e-6", "tol0"])
def test_recording_leaves_scores_and_t0_unchanged(problem, tol):
    _, d, plan, p, w0 = problem
    tplan = tgw.WindowPlan.from_arrays(plan.to_arrays())
    args = tplan.device_args("cpu")
    kw = dict(n_rows=plan.n_rows, table_entries=plan.table_entries, tol=tol, max_iter=15)
    t0 = t(w0.copy())
    on = tgw.converge_windowed(*args, t0, t(p), t(d), record_residuals=True, **kw)
    off = tgw.converge_windowed(*args, t0, t(p), t(d), record_residuals=False, **kw)
    assert torch.equal(on[0], off[0]) and on[1] == off[1]
    assert torch.equal(on[2], off[2])
    assert on[3].shape == (15,)
    np.testing.assert_array_equal(t0.numpy(), w0)


def test_exit_rule_edges():
    """``max_iter = 0`` returns ``t0`` with residual inf; a huge ``tol``
    still runs the first step (``it == 0`` always steps)."""
    t0 = torch.tensor([0.5, 0.5])
    step = lambda x: x.flip(0) * 0.0 + torch.tensor([0.25, 0.75])  # noqa: E731
    x, it, resid = tsp.run_power_iteration(step, t0, tol=1e-6, max_iter=0)
    assert it == 0 and torch.equal(x, t0) and float(resid) == np.inf
    x, it, resid, hist = tsp.run_power_iteration(
        step, t0, tol=10.0, max_iter=5, record_residuals=True
    )
    assert it == 1 and float(resid) == pytest.approx(0.5)
    np.testing.assert_allclose(hist.numpy(), [0.5, 0, 0, 0, 0])


@pytest.mark.parametrize("name", ["csr", "windowed"])
def test_backends_match_reference(name):
    g = erdos_renyi(773, avg_degree=5.0, seed=1)
    kw = dict(alpha=0.1, tol=1e-6, max_iter=60)
    ref = jget(f"tpu-{name}").converge(g, **kw)
    port = tget(f"cuda-{name}", device="cpu").converge(g, **kw)
    assert port.backend == f"cuda-{name}"
    assert port.iterations == ref.iterations
    assert l1(port.scores, ref.scores) <= L1_TOL
    np.testing.assert_allclose(port.residuals, ref.residuals, rtol=RESID_RTOL, atol=RESID_ATOL)


def test_windowed_backend_epoch_replay_matches_reference():
    """Cold epoch plus three churned epochs with the ``delta_rows``
    hint and warm starts, through both registries: equal plan outcomes,
    equal plans, equal iterations, scores within L1 tolerance."""
    g = scale_free(4096, 50_000, seed=7).drop_self_edges()
    jb = jget("tpu-windowed")
    tb = tget("cuda-windowed", device="cpu")
    kw = dict(alpha=0.1, tol=1e-6, max_iter=60)
    rng = np.random.default_rng(7)
    cohort, deg = churn_cohort_dims(g, 0.01)
    jscores = tscores = None
    for epoch in range(4):
        if epoch:
            rows, g, _ = sender_centric_churn(rng, g, cohort_size=cohort, deg=deg)
            jb.delta_rows, tb.delta_rows = rows, rows
        before = {o: PLAN_OUTCOMES.value(outcome=o) for o in ("reuse", "delta", "rebuild")}
        t_before = dict(tb.plan_outcomes)
        jr = jb.converge(g, t0=jscores, **kw)
        tr = tb.converge(g, t0=tscores, **kw)
        for o in before:
            assert PLAN_OUTCOMES.value(outcome=o) - before[o] == tb.plan_outcomes[o] - t_before[o]
        assert tr.iterations == jr.iterations
        assert l1(tr.scores, jr.scores) <= L1_TOL
        for k in jgw.WindowPlan._CORE:
            np.testing.assert_array_equal(getattr(tb.last_plan, k), getattr(jb.last_plan, k))
        jscores, tscores = jr.scores, tr.scores
    assert tb.plan_outcomes["delta"] >= 1
    # The same graph again reuses the cached plan.
    tb.converge(g, t0=tscores, **kw)
    assert tb.plan_outcomes["reuse"] == 1


def test_eigentrust_model_on_cpu():
    g = erdos_renyi(500, avg_degree=6.0, seed=2)
    port = EigenTrustModel(g, device="cpu").converge()
    ref = jget("tpu-csr").converge(g, alpha=0.1, tol=1e-6, max_iter=50)
    assert l1(port.scores, ref.scores) <= 1e-5
    top = EigenTrustModel(g, device="cpu").top_k(port, k=3)
    assert [i for i, _ in top] == list(np.argsort(port.scores)[::-1][:3])
