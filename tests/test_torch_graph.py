"""The port's host-side graph layer against the JAX package: generators,
churn and ``TrustGraph`` normalisation are numpy in both, so every
array must be identical for the same seed (``np.array_equal``)."""

import numpy as np
import pytest

from protocol_tpu.models import churn as jchurn
from protocol_tpu.models import graphs as jgraphs
from protocol_tpu.trust.graph import TrustGraph as JGraph
from protocol_tpu_torch.models import churn as tchurn
from protocol_tpu_torch.models import graphs as tgraphs
from protocol_tpu_torch.trust.graph import TrustGraph as TGraph


def same_graph(a, b) -> None:
    assert a.n == b.n
    for k in ("src", "dst", "weight"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert getattr(a, k).dtype == getattr(b, k).dtype
    if a.pre_trusted is None:
        assert b.pre_trusted is None
    else:
        np.testing.assert_array_equal(a.pre_trusted, b.pre_trusted)


GENERATORS = [
    ("scale_free", dict(n=3000, nnz=40_000, seed=7)),
    ("scale_free", dict(n=4096, nnz=60_000, seed=0, exponent=1.0)),
    ("scale_free", dict(n=1000, nnz=9000, seed=2, chunk=2048)),
    ("erdos_renyi", dict(n=773, avg_degree=5.0, seed=1)),
    ("sybil_stress", dict(n=2000, nnz=20_000, seed=3)),
]


@pytest.mark.parametrize("name, kw", GENERATORS, ids=[f"{g}-{i}" for i, (g, _) in enumerate(GENERATORS)])
def test_generators_bit_identical(name, kw):
    same_graph(getattr(tgraphs, name)(**kw), getattr(jgraphs, name)(**kw))


def test_sybil_mass():
    scores = np.random.default_rng(0).random(1000)
    assert tgraphs.sybil_mass(scores, 1000, 0.3) == jgraphs.sybil_mass(scores, 1000, 0.3)


@pytest.fixture(scope="module")
def pair():
    kw = dict(n=3000, nnz=40_000, seed=11)
    return tgraphs.scale_free(**kw), jgraphs.scale_free(**kw)


def test_normalisation_identical(pair):
    tg, jg = pair
    same_graph(tg.drop_self_edges(), jg.drop_self_edges())
    tw, td = tg.drop_self_edges().row_normalized()
    jw, jd = jg.drop_self_edges().row_normalized()
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tg.pre_trust_vector(), jg.pre_trust_vector())
    ts, js = tg.sorted_by_dst(), jg.sorted_by_dst()
    same_graph(ts, js)
    np.testing.assert_array_equal(ts.row_ptr_by_dst(), js.row_ptr_by_dst())


def test_pre_trust_without_seed_set_and_dense_round_trip():
    ops = np.random.default_rng(4).integers(0, 3, (9, 9)).astype(np.float64)
    tg, jg = TGraph.from_dense(ops), JGraph.from_dense(ops)
    same_graph(tg, jg)
    np.testing.assert_array_equal(tg.pre_trust_vector(), jg.pre_trust_vector())
    np.testing.assert_array_equal(tg.to_dense(), jg.to_dense())
    assert tg.nnz == jg.nnz


def test_sender_centric_churn_stream_identical(pair):
    tg, jg = pair
    tg, jg = tg.drop_self_edges(), jg.drop_self_edges()
    assert tchurn.churn_cohort_dims(tg, 0.01) == jchurn.churn_cohort_dims(jg, 0.01)
    cohort, deg = tchurn.churn_cohort_dims(tg, 0.01)
    trng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        trows, tg, tnew = tchurn.sender_centric_churn(trng, tg, cohort_size=cohort, deg=deg)
        jrows, jg, jnew = jchurn.sender_centric_churn(jrng, jg, cohort_size=cohort, deg=deg)
        np.testing.assert_array_equal(trows, jrows)
        same_graph(tg, jg)
        for a, b in zip(tnew, jnew):
            np.testing.assert_array_equal(a, b)
