"""The port's single-device backend ladder against the JAX package, on
the CPU: the reference suites of tests/test_trust_backends.py re-targeted
at ``native-cpu``, ``cuda-dense`` and ``cuda-sparse`` (device ``cpu``,
the plain versions) and at the dense kernels of ``ops/dense.py``.

Tolerances:

- ``native-cpu`` is exact rational arithmetic in both packages: scores,
  iterations and residual history identical.
- The dense kernels: rtol 1e-6 for the products (float32 matrix-vector
  products summed in another order), exact for the masks of
  ``filter_and_normalize``.
- ``cuda-dense`` and ``cuda-sparse``: the reference's cross-backend
  tolerance, scores rtol 1e-3 / atol 1e-8.  ``cuda-dense`` runs the same
  chunks, so its iterations and history length are equal at tol 1e-6 and
  0; ``cuda-sparse`` sums each dst segment in double-single where
  ``tpu-sparse`` sums in float32, so its iterations are held equal at
  tol 0 only (at tol 1e-9, below float32's residual floor, either may
  stop first).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from protocol_tpu.crypto.eddsa import PublicKey, SecretKey, Signature
from protocol_tpu.models.graphs import erdos_renyi, scale_free
from protocol_tpu.ops import dense as jd
from protocol_tpu.trust.backend import get_backend as jget
from protocol_tpu.trust.native import EigenTrustSet, Opinion, power_iterate_rational
from protocol_tpu_torch.models.graphs import sybil_mass, sybil_stress
from protocol_tpu_torch.ops import dense as td
from protocol_tpu_torch.ops import sparse as tsp
from protocol_tpu_torch.trust.backend import get_backend as tget
from protocol_tpu_torch.trust.backend import registered_backends
from protocol_tpu_torch.trust.graph import TrustGraph

RTOL, ATOL = 1e-3, 1e-8
F32 = np.float32


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def warm_start(n: int, seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).random(n).astype(F32)
    return x / x.sum()


# ---------------------------------------------------------------------------
# ops/dense.py against protocol_tpu/ops/dense.py
# ---------------------------------------------------------------------------


def stochastic_rows(n: int, seed: int) -> np.ndarray:
    """A row-stochastic (n, n) float32 matrix with a zero diagonal."""
    a = np.random.default_rng(seed).random((n, n)).astype(F32)
    np.fill_diagonal(a, 0.0)
    return (a / a.sum(axis=1, keepdims=True)).astype(F32)


def set_operands(n: int, seed: int):
    """``(ops, match, set_valid)`` with invalid slots, mismatched keys
    and all-zero rows, so every mask of ``filter_and_normalize`` acts."""
    rng = np.random.default_rng(seed)
    ops = rng.integers(0, 50, (n, n)).astype(F32)
    ops[rng.random(n) < 0.2] = 0.0
    match = rng.random((n, n)) < 0.8
    valid = rng.random(n) < 0.75
    valid[0] = True
    return ops, match, valid


def unsigned_opinion(pks, scores):
    return Opinion(sig=Signature.new(0, 0, 0), message_hash=0, scores=list(zip(pks, scores)))


def set_scenario():
    """tests/test_trust_backends.py's mixed EigenTrustSet: valid rows, a
    mismatched key, a self-score and a zero-sum opinion."""
    s = EigenTrustSet(num_neighbours=6, num_iterations=20, initial_score=1000)
    pks = [SecretKey.random().public() for _ in range(4)]
    for pk in pks[:3]:
        s.add_member(pk)
    null = PublicKey.null()
    padded = pks[:3] + [null, null, null]
    s.update_op(pks[0], unsigned_opinion([pks[0], pks[1], pks[2], null, null, pks[3]], [10, 10, 0, 0, 10, 5]))
    s.update_op(pks[1], unsigned_opinion(padded, [0, 0, 30, 0, 0, 0]))
    s.update_op(pks[2], unsigned_opinion(padded, [0, 0, 0, 0, 0, 0]))
    return s


class TestDenseKernels:
    @pytest.mark.parametrize("n, iters", [(4, 3), (7, 10), (300, 25)])
    def test_converge_dense(self, n, iters):
        ops_t = stochastic_rows(n, seed=n).T.copy()
        s0 = warm_start(n, seed=iters)
        ref = jd.converge_dense(jnp.asarray(ops_t), jnp.asarray(s0), iters)
        port = td.converge_dense(t(ops_t), t(s0), iters)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6)

    def test_converge_dense_matches_exact_rational(self):
        """converge_dense on the row-stochastic matrix equals native()'s
        unscaled rational result (circuit.rs:425-470 equivalence)."""
        rng = np.random.default_rng(3)
        n, iters, scale = 7, 10, 1000
        ops = np.zeros((n, n), dtype=np.int64)
        for i in range(n):
            cuts = np.sort(rng.integers(0, scale + 1, n - 1))
            ops[i] = np.diff(np.concatenate([[0], cuts, [scale]]))
            ops[i, i] = 0
            ops[i] = ops[i] * scale // max(ops[i].sum(), 1)
            ops[i, (i + 1) % n] += scale - ops[i].sum()
        init = [1000] * n
        exact = power_iterate_rational(init, ops.tolist(), iters, scale)
        out = td.converge_dense(t((ops.T / scale).astype(F32)), t(np.array(init, F32)), iters)
        np.testing.assert_allclose(out.numpy(), [float(x) for x in exact], rtol=2e-4)

    @pytest.mark.parametrize("n, seed", [(6, 0), (17, 1), (64, 2)])
    def test_filter_and_normalize_and_set_converge(self, n, seed):
        ops, match, valid = set_operands(n, seed)
        ref = jd.filter_and_normalize(jnp.asarray(ops), jnp.asarray(match), jnp.asarray(valid))
        port = td.filter_and_normalize(t(ops), t(match), t(valid))
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
        credits = np.where(valid, 1000.0, 0.0).astype(F32)
        np.testing.assert_allclose(
            td.set_converge_dense(port, t(credits), 20).numpy(),
            np.asarray(jd.set_converge_dense(ref, jnp.asarray(credits), 20)),
            rtol=1e-6,
        )

    def test_set_scenario_matches_reference_and_native(self):
        s = set_scenario()
        ops, match, valid, credits = s.to_arrays()
        # float64 host arrays, staged as float32 as jnp.asarray stages them.
        ops, credits = ops.astype(F32), credits.astype(F32)
        ref = jd.filter_and_normalize(jnp.asarray(ops), jnp.asarray(match), jnp.asarray(valid))
        port = td.filter_and_normalize(t(ops), t(match), t(valid))
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
        out = td.set_converge_dense(port, t(credits), 20).numpy()
        np.testing.assert_allclose(
            out, np.asarray(jd.set_converge_dense(ref, jnp.asarray(credits), 20)),
            rtol=1e-6,
        )
        # Native raw scores grow by INITIAL_SCORE^20; compare normalized.
        expected = np.array([float(x / 1000**20) for x in s.converge_rational()])
        np.testing.assert_allclose(out, expected, rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# The backends against the reference's
# ---------------------------------------------------------------------------


def seeded_graph():
    """A small graph with a pre-trusted set and dangling rows."""
    g = erdos_renyi(30, avg_degree=3.0, seed=5).drop_self_edges()
    keep = ~np.isin(g.src, [3, 11])
    pre = np.zeros(g.n, bool)
    pre[[0, 7, 19]] = True
    return TrustGraph(g.n, g.src[keep], g.dst[keep], g.weight[keep], pre)


NATIVE_CASES = {
    "er40-tol0": (lambda: erdos_renyi(40, avg_degree=4.0, seed=2), dict(alpha=0.15, tol=0, max_iter=25), None),
    "pretrusted-tol1e-6-warm": (seeded_graph, dict(alpha=0.1, tol=1e-6, max_iter=40), 4),
}


@pytest.mark.parametrize("case", list(NATIVE_CASES))
def test_native_cpu_matches_reference(case):
    make, kw, warm = NATIVE_CASES[case]
    g = make()
    t0 = None if warm is None else warm_start(g.n, warm)
    ref = jget("native-cpu").converge(g, t0=t0, **kw)
    port = tget("native-cpu").converge(g, t0=t0, **kw)
    assert port.backend == "native-cpu" and port.iterations == ref.iterations
    np.testing.assert_array_equal(port.scores, ref.scores)
    np.testing.assert_array_equal(port.residuals, ref.residuals)


def test_native_cpu_uniform_bootstrap_set():
    """BASELINE config 1: five peers scoring each other alike converge
    to uniform scores."""
    ops = np.full((5, 5), 200.0, F32)
    np.fill_diagonal(ops, 0.0)
    res = tget("native-cpu").converge(TrustGraph.from_dense(ops), alpha=0.0, tol=0.0, max_iter=10)
    assert res.iterations == 10
    np.testing.assert_allclose(res.scores, 0.2, atol=1e-12)


TOLS = {"tol1e-6": 1e-6, "tol0": 0.0}


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("tol", list(TOLS))
def test_dense_backend_matches_reference(tol, warm):
    g = erdos_renyi(200, avg_degree=6.0, seed=1)
    kw = dict(alpha=0.1, tol=TOLS[tol], max_iter=60, t0=warm_start(g.n, 9) if warm else None)
    ref = jget("tpu-dense").converge(g, **kw)
    port = tget("cuda-dense", device="cpu").converge(g, **kw)
    assert port.backend == "cuda-dense"
    assert port.iterations == ref.iterations
    assert port.residuals.shape == ref.residuals.shape
    np.testing.assert_allclose(port.scores, ref.scores, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("tol", ["tol1e-9", "tol0"])
def test_sparse_backend_matches_reference(tol, warm):
    g = scale_free(800, 6400, seed=9)
    kw = dict(alpha=0.1, tol=1e-9 if tol == "tol1e-9" else 0.0, max_iter=60,
              t0=warm_start(g.n, 10) if warm else None)
    ref = jget("tpu-sparse").converge(g, **kw)
    port = tget("cuda-sparse", device="cpu").converge(g, **kw)
    assert port.backend == "cuda-sparse"
    np.testing.assert_allclose(port.scores, ref.scores, rtol=RTOL, atol=ATOL)
    if kw["tol"] == 0:
        assert port.iterations == ref.iterations == 60
    # The same dst-sorted edges and the same step: cuda-csr's scores, bit for bit.
    csr = tget("cuda-csr", device="cpu").converge(g, **kw)
    np.testing.assert_array_equal(port.scores, csr.scores)
    assert port.iterations == csr.iterations


@pytest.mark.parametrize("name", ["cuda-dense", "cuda-sparse"])
def test_backend_matches_exact_native(name):
    g = erdos_renyi(40, avg_degree=4.0, seed=2)
    exact = tget("native-cpu").converge(g, alpha=0.15, tol=0, max_iter=25)
    res = tget(name, device="cpu").converge(g, alpha=0.15, tol=0, max_iter=25)
    np.testing.assert_allclose(res.scores, exact.scores, rtol=1e-3, atol=1e-7)


def test_sparse_backend_l1_normalized_and_fixed_iterations():
    g = scale_free(500, 4000, seed=3)
    res = tget("cuda-sparse", device="cpu").converge(g, alpha=0.1)
    assert res.scores.sum() == pytest.approx(1.0, rel=1e-5)
    # Zero-score peers carry the CSR formulation's differencing dust, about
    # 1e-16 (tpu-csr's scores on this graph carry it too); no score is
    # negative beyond it.
    assert (res.scores >= -1e-12).all()
    fixed = tget("cuda-sparse", device="cpu").converge(erdos_renyi(100, seed=4), alpha=0.1, tol=0, max_iter=7)
    assert fixed.iterations == 7


def test_sybil_damping_bounds_collective():
    """BASELINE config 5 semantics on cuda-sparse: pre-trust damping caps
    the trust mass a closed sybil collective can capture."""
    g = sybil_stress(2000, 16000, sybil_fraction=0.3, seed=8)
    b = tget("cuda-sparse", device="cpu")
    masses = [sybil_mass(b.converge(g, alpha=a, max_iter=80).scores, g.n, 0.3) for a in (0.01, 0.2, 0.5)]
    assert masses[0] > masses[1] > masses[2]
    assert masses[2] < 0.2


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def test_registry_names_follow_the_reference_ladder():
    assert registered_backends() == [
        "native-cpu", "cuda-dense", "cuda-sparse", "cuda-csr", "cuda-windowed",
        "cuda-sharded:cuda-csr", "cuda-sharded:cuda-windowed",
    ]


@pytest.mark.parametrize("name", ["gpu-magic", "tpu-sparse", "tpu-sharded", "cuda-csr:cuda-windowed"])
def test_unknown_backend(name):
    with pytest.raises(ValueError, match="unknown trust backend"):
        tget(name, device="cpu")


@pytest.mark.parametrize("name", registered_backends())
def test_every_named_backend_constructs(name):
    b = tget(name) if name == "native-cpu" else tget(name, device="cpu")
    # A sharded composite is the cuda-sharded backend on its kernel.
    base, _, kernel = name.partition(":")
    assert b.name == base and b.device == torch.device("cpu")
    assert getattr(b, "kernel", "") == kernel


# ---------------------------------------------------------------------------
# The steps go through the wrappers
# ---------------------------------------------------------------------------


@pytest.fixture
def spied(monkeypatch):
    """Count the calls of the kernels' wrappers where the steps look them up."""
    names = ("gather_ds_cumsum", "ds_cumsum_axis1", "block_total_scan", "rowsum_tail")
    calls = dict.fromkeys(names, 0)

    def spy(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    for name in names:
        monkeypatch.setattr(tsp, name, spy(name, getattr(tsp, name)))
    return calls


@pytest.mark.parametrize("step", ["csr", "coo"])
def test_step_calls_each_kernel_wrapper_once(spied, step):
    g = scale_free(2000, 20_000, seed=5).drop_self_edges()
    w, dangling = g.row_normalized()
    g = TrustGraph(g.n, g.src, g.dst, w, g.pre_trusted).sorted_by_dst()
    p = np.full(g.n, 1.0 / g.n, F32)
    vectors = (t(p), t(p), t(dangling.astype(F32)), torch.tensor(0.1))
    if step == "csr":
        tsp.power_step_csr(t(g.src), t(g.row_ptr_by_dst()), t(g.weight), *vectors)
    else:
        tsp.power_step_coo(t(g.src), t(g.dst), t(g.weight), *vectors, n=g.n)
    # The edge product and the block prefix are one kernel (K9); K5 is the
    # windowed step's alone.
    assert spied == {"gather_ds_cumsum": 1, "ds_cumsum_axis1": 0, "block_total_scan": 1, "rowsum_tail": 1}


def test_converge_sparse_derives_segments_once(monkeypatch):
    """The dst segments are derived before the loop, not a step."""
    calls = []
    real = tsp.dst_segments
    monkeypatch.setattr(tsp, "dst_segments", lambda *a, **k: calls.append(1) or real(*a, **k))
    g = erdos_renyi(300, seed=6).drop_self_edges()
    w, dangling = g.row_normalized()
    p = np.full(g.n, 1.0 / g.n, F32)
    out = tsp.converge_sparse(
        t(g.src), t(g.dst), t(w), t(p), t(p), t(dangling.astype(F32)),
        n=g.n, tol=0.0, max_iter=5, sorted_by_dst=False,
    )
    assert out[1] == 5 and calls == [1]
