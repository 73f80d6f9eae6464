"""The port's graft prover kernels (``protocol_tpu_torch/zk/graft/``:
``field``, ``ntt``, ``pippenger``, and ``ops/segments.py``) against the
reference package's ``zk.graft`` and the native runtime, on the CPU,
where every wrapper runs its kernel's plain version: the field multiply
and the NTT bit for bit, the plain MSM's Jacobian buckets limb for limb
at one block (n = 33), the reference test's MSM edge cases, the
length-mismatch errors, ``commit_batch``, the phase table and the
attribution rows, the launch declarations of ``analysis/budget.py``,
and small PLONK proofs under ``use_zk_backend("graft", device="cpu")``
byte-identical to the reference's native proofs.  The kernels
themselves (K10-K13, ``ops/csrc/zk_*.cu``) run only on the card:
``chip_smoke.py``'s ``graft`` phase holds them against these plain
versions."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from protocol_tpu.zk import kzg as ref_kzg
from protocol_tpu.zk import plonk as ref_plonk
from protocol_tpu.zk.graft import field as ref_field
from protocol_tpu.zk.graft import ntt as ref_ntt
from protocol_tpu.zk.graft import pippenger as ref_pippenger
from protocol_tpu_torch.analysis.budget import ZK_INVARIANTS, expected_zk_launches
from protocol_tpu_torch.crypto.field import MODULUS as R
from protocol_tpu_torch.ops import segments
from protocol_tpu_torch.utils.limbs import to_limbs_fast
from protocol_tpu_torch.zk import chips, cs, gadgets, kzg, native, plonk
from protocol_tpu_torch.zk import graft as zk_graft
from protocol_tpu_torch.zk.bn254 import G1, GENERATOR, IDENTITY
from protocol_tpu_torch.zk.graft import field as gf
from protocol_tpu_torch.zk.graft import ntt as gntt
from protocol_tpu_torch.zk.graft import pippenger as gpp
from protocol_tpu_torch.zk.graft import use_zk_backend

CPU = torch.device("cpu")


def rand_scalar(rng) -> int:
    return int.from_bytes(rng.bytes(32), "little") % R


def rand_points(rng, n: int) -> list[G1]:
    return [GENERATOR.mul(rand_scalar(rng) or 1) for _ in range(n)]


def exact_msm(scalars, points) -> G1:
    return functools.reduce(G1.add, (p.mul(s % R) for s, p in zip(scalars, points)), IDENTITY)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain versions run many small tensor operations: intra-op
    threads add nothing to them and contend with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# ---------------------------------------------------------------------------
# Field (K10's plain version) against the reference's jit field
# ---------------------------------------------------------------------------


def field_inputs(F, n=40, seed=7):
    rng = np.random.default_rng(seed)
    edge = [0, 1, 2, F.p - 1, F.p - 2, (1 << 255) % F.p, F.r, F.r2]
    avals = edge + [int.from_bytes(rng.bytes(32), "little") % F.p for _ in range(n - len(edge))]
    return avals, list(reversed(avals))


@pytest.mark.parametrize("which", ["fr", "fq"])
def test_mulmod_equals_the_reference(which):
    F = gf.FR if which == "fr" else gf.FQ
    ref_F = ref_field.FR if which == "fr" else ref_field.FQ
    mulmod = gf.mulmod_fr if which == "fr" else gf.mulmod_fq
    ref_mulmod = ref_field.mulmod_fr if which == "fr" else ref_field.mulmod_fq
    avals, bvals = field_inputs(F)
    am = [F.to_mont_int(a) for a in avals]
    bm = [F.to_mont_int(b) for b in bvals]
    a16, b16 = ref_field.ints_to_limbs(am), ref_field.ints_to_limbs(bm)
    want = np.asarray(ref_mulmod(a16, b16))
    got = mulmod(gf.u64_to_tensor(to_limbs_fast(am), CPU), gf.u64_to_tensor(to_limbs_fast(bm), CPU))
    assert np.array_equal(gf.u64_to_limbs(gf.tensor_to_u64(got)), want)
    assert ref_F.p == F.p and np.array_equal(ref_F.r2_np, F.r2_np)
    assert np.array_equal(ref_F.nprime_np, F.nprime_np)


@pytest.mark.parametrize("op", ["add", "sub", "to_mont", "from_mont"])
@pytest.mark.parametrize("which", ["fr", "fq"])
def test_field_ops_equal_the_reference(which, op):
    import jax.numpy as jnp

    F = gf.FR if which == "fr" else gf.FQ
    ref_F = ref_field.FR if which == "fr" else ref_field.FQ
    avals, bvals = field_inputs(F, seed=11)
    a = gf.u64_to_tensor(to_limbs_fast(avals), CPU)
    b = gf.u64_to_tensor(to_limbs_fast(bvals), CPU)
    ja, jb = jnp.asarray(ref_field.ints_to_limbs(avals)), jnp.asarray(ref_field.ints_to_limbs(bvals))
    if op in ("add", "sub"):
        got, want = getattr(F, op)(a, b), getattr(ref_F, op)(ja, jb)
    else:
        got, want = getattr(F, op)(a), getattr(ref_F, op)(ja)
    assert np.array_equal(gf.u64_to_limbs(gf.tensor_to_u64(got)), np.asarray(want))


def test_host_limb_helpers_match_the_reference():
    rng = np.random.default_rng(3)
    vals = [rand_scalar(rng) for _ in range(9)]
    limbs = gf.ints_to_limbs(vals)
    assert np.array_equal(limbs, ref_field.ints_to_limbs(vals))
    assert gf.limbs_to_ints(limbs) == vals == ref_field.limbs_to_ints(limbs)
    words = to_limbs_fast(vals)
    assert np.array_equal(gf.u64_to_limbs(words), ref_field.u64_to_limbs(words))
    assert np.array_equal(gf.limbs_to_u64(limbs), words)
    t = gf.u64_to_tensor(words, CPU)
    assert t.dtype == torch.int64 and np.array_equal(gf.tensor_to_u64(t), words)
    assert torch.equal(gf.from16(gf.to16(t)), t)


def test_field_op_checks_its_operands():
    a = gf.u64_to_tensor(to_limbs_fast([1, 2, 3]), CPU)
    with pytest.raises(ValueError, match="unknown op"):
        gf.field_op(a, a, gf.FR, "div")
    with pytest.raises(ValueError, match="int64"):
        gf.field_op(a.to(torch.int32), a, gf.FR)
    with pytest.raises(ValueError, match="rows"):
        gf.field_op(a, a[:2], gf.FR)
    with pytest.raises(ValueError, match="not meta"):
        gf.field_op(a.to("meta"), a[:1].to("meta"), gf.FR)
    # b broadcast: one element against every row; no launch on the CPU.
    before = gf.field_op.launches
    one = gf.FR.const(gf.FR.r, CPU)
    assert torch.equal(gf.field_op(a, one, gf.FR), gf.FR.to_mont(gf.FR.from_mont(a)))
    assert gf.field_op.launches == before


# ---------------------------------------------------------------------------
# NTT (K11 and K10's plain versions) against the reference graft and native
# ---------------------------------------------------------------------------

NTT_K = 8  # the reference test's 256-point domain


def ntt_inputs(seed=11):
    d = plonk.Domain(NTT_K)
    rng = np.random.default_rng(seed)
    vals = [rand_scalar(rng) for _ in range(d.n)]
    vals[0], vals[1] = 0, R - 1
    return d, vals


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_limbs_equal_the_reference_graft_and_native(inverse):
    d, vals = ntt_inputs()
    root = d.omega_inv if inverse else d.omega
    native_out = d.ntt_limbs(to_limbs_fast(vals), root, inverse)
    ref_out = ref_ntt.ntt_limbs(to_limbs_fast(vals), root, inverse)
    with use_zk_backend("graft", device="cpu"):
        got = d.ntt_limbs(to_limbs_fast(vals), root, inverse)
    assert np.array_equal(got, native_out) and np.array_equal(got, ref_out)


def test_fft_matches_native_and_round_trips():
    d, vals = ntt_inputs(13)
    reference = d.fft(list(vals))
    with use_zk_backend("graft", device="cpu"):
        assert d.fft(list(vals)) == reference
        assert d.ifft(reference) == vals


def test_ntt_stage_plain_equals_the_reference_stage():
    n, half = 64, 8
    rng = np.random.default_rng(5)
    x = to_limbs_fast([rand_scalar(rng) for _ in range(n)])
    plan = gntt._twiddle_plan(n, plonk.Domain(6).omega)
    tw = plan[half - 1 : 2 * half - 1]
    assert np.array_equal(
        ref_field.u64_to_limbs(tw), ref_ntt._twiddle_plan(n, plonk.Domain(6).omega)[3]
    )
    want = ref_ntt._stage_fn()(ref_field.u64_to_limbs(x).reshape(n // 16, 16, 16),
                               ref_field.u64_to_limbs(tw))
    xt = gf.u64_to_tensor(x, CPU)
    gntt._stage_plain(xt, gf.u64_to_tensor(tw, CPU), half)
    assert np.array_equal(gf.u64_to_limbs(gf.tensor_to_u64(xt)), np.asarray(want).reshape(n, 16))
    assert np.array_equal(gntt._bitrev_perm(n), ref_ntt._bitrev_perm(n))


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("log_n", [1, 3, 6, 9])
def test_needed_multiplies_skip_exactly_the_unit_twiddles(log_n, inverse):
    """The NTT's operation count (``chip_smoke.py``'s K11 bound) is the
    butterflies whose twiddle is not 1 plus the inverse's scale: each
    stage's first twiddle is the Montgomery one, no other is."""
    n = 1 << log_n
    d = plonk.Domain(log_n)
    plan = gntt._twiddle_plan(n, d.omega_inv if inverse else d.omega)
    words = [int.from_bytes(row.tobytes(), "little") for row in plan]
    count, half = 0, 1
    while half < n:
        row = words[half - 1 : 2 * half - 1]
        assert row[0] == gf.FR.r and gf.FR.r not in row[1:]
        count += (n // (2 * half)) * (half - 1)
        half *= 2
    assert gntt.needed_multiplies(n, inverse) == count + (n if inverse else 0)


def test_ntt_rejects_sizes_and_stage_shapes():
    with pytest.raises(ValueError, match="power of two"):
        with use_zk_backend("graft", device="cpu"):
            zk_graft.ntt_limbs(to_limbs_fast([1, 2, 3]), plonk.Domain(2).omega, False)
    x = gf.u64_to_tensor(to_limbs_fast([1] * 8), CPU)
    with pytest.raises(ValueError, match="do not fit"):
        gntt.ntt_device(x, x[:3], False)
    with pytest.raises(ValueError, match="tile 13"):
        gntt.ntt_device(x, x[:7], False, tile=13)


@functools.cache
def ntt_references(log_n: int, inverse: bool):
    """Seeded inputs of 2^log_n points and their transforms by native
    ``zk_ntt`` and by the reference's graft ``ntt_limbs``."""
    d = plonk.Domain(log_n)
    rng = np.random.default_rng(100 + log_n)
    vals = [rand_scalar(rng) for _ in range(d.n)]
    vals[0], vals[-1] = R - 1, 0
    root = d.omega_inv if inverse else d.omega
    native_out = d.ntt_limbs(to_limbs_fast(vals), root, inverse)
    ref_out = ref_ntt.ntt_limbs(to_limbs_fast(vals), root, inverse)
    return d, root, vals, native_out, ref_out


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("log_tile", [2, 3])
@pytest.mark.parametrize("log_n", range(5, 11))
def test_two_pass_plain_ntt_at_small_tiles(log_n, log_tile, inverse):
    """K11's plain version at tiles of 4 and 8 points, so 2 to 5 passes:
    the bit-reverse by index, each pass's plain stages, the scale in the
    last, equal to native ``zk_ntt`` and to the reference's graft NTT."""
    d, root, vals, native_out, ref_out = ntt_references(log_n, inverse)
    assert np.array_equal(native_out, ref_out)
    x = gf.u64_to_tensor(to_limbs_fast(vals), CPU)
    plan = gntt._device_plan(d.n, root, CPU)
    got = gntt.ntt_device(x, plan, inverse, tile=log_tile)
    assert np.array_equal(gf.tensor_to_u64(got), native_out)
    stages = gntt.pass_stages(d.n, log_tile)
    assert [q for _, q in stages] == [log_tile] * (log_n // log_tile) + [log_n % log_tile] * (log_n % log_tile > 0)
    # The first pass alone: the bit-reversed input after the first log_tile stages.
    first = gntt.ntt_device(x, plan, inverse, tile=log_tile, max_passes=1)
    y = x[torch.from_numpy(gntt._bitrev_perm(d.n))]
    for j in range(log_tile):
        gntt._stage_plain(y, plan[(1 << j) - 1 : (2 << j) - 1], 1 << j)
    assert torch.equal(first, y)


# ---------------------------------------------------------------------------
# MSM (K12 and K13's plain versions) against the reference's kernels
# ---------------------------------------------------------------------------


def jacobian16(point: G1, z: int) -> torch.Tensor:
    """``point`` as Montgomery Jacobian (x z^2, y z^3, z) 16-bit limbs, (3, 16)."""
    from protocol_tpu_torch.zk.rns import FQ_MODULUS as Q

    xyz = (point.x * z * z % Q, point.y * z * z * z % Q, z) if z else (0, 0, 0)
    return torch.from_numpy(gf.ints_to_limbs([gf.FQ.to_mont_int(v) for v in xyz]).astype(np.int64))


def affine16(p: torch.Tensor):
    """A (3, 16) Montgomery Jacobian limb tensor as an affine (x, y), or None."""
    from protocol_tpu_torch.zk.rns import FQ_MODULUS as Q

    x, y, z = (gf.FQ.from_mont_int(v) for v in gf.limbs_to_ints(p.numpy()))
    if z == 0:
        return None
    zi = pow(z, Q - 2, Q)
    return (x * zi * zi % Q, y * zi * zi * zi % Q)


@pytest.mark.parametrize("case", ["random", "identity_cache_point", "identity_sum", "p_equals_q",
                                  "p_equals_minus_q"])
def test_madd_equals_jadd_and_the_reference_jadd(case):
    """K13's mixed add (plain ``_madd``) against the complete add, the
    port's and the reference's: a Jacobian ``p`` with Z != 1 plus a point
    of the point cache (Z the Montgomery one, or 0 for the identity)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(31)
    a, b = rand_points(rng, 2)
    z = rand_scalar(rng) or 1
    p_pt, q_pt, pz = {
        "random": (a, b, z),
        "identity_cache_point": (a, IDENTITY, z),
        "identity_sum": (IDENTITY, b, 0),
        "p_equals_q": (a, a, z),
        "p_equals_minus_q": (a, a.neg(), z),
    }[case]
    p = jacobian16(p_pt, pz)
    q = gf.to16(gpp.PointCache.build([q_pt], CPU).points[0])
    got = gpp._madd(p, q)
    assert affine16(got) == affine16(gpp._jadd(p, q))
    ref = np.asarray(ref_pippenger._jadd(jnp.asarray(p.numpy().astype(np.uint32)),
                                         jnp.asarray(q.numpy().astype(np.uint32))))
    assert affine16(got) == affine16(torch.from_numpy(ref.astype(np.int64)))
    want = p_pt.add(q_pt)
    assert affine16(got) == (None if want == IDENTITY else (want.x, want.y))


@pytest.fixture(scope="module")
def edge_batch():
    """The reference test's n = 33 batch (padded to 64): a zero scalar,
    r - 1, an identity point and a duplicated point."""
    rng = np.random.default_rng(17)
    scalars = [rand_scalar(rng) for _ in range(33)]
    points = rand_points(rng, 33)
    scalars[0], scalars[1] = 0, R - 1
    points[2] = IDENTITY
    points[4] = points[3]
    return scalars, points


def test_plain_buckets_equal_the_reference_kernels_at_n33(edge_batch):
    """At one block the plain MSM is the reference's: the same sorted
    digits and the same (32, 256, 3, 16) Jacobian buckets, limb for limb."""
    import jax.numpy as jnp

    scalars, points = edge_batch
    m = 64
    arr = np.concatenate([to_limbs_fast(scalars), np.zeros((m - 33, 4), np.uint64)])
    ref_cache = ref_pippenger.PointCache.build(points)
    k = ref_pippenger._kernels()
    digits = arr.view(np.uint8).reshape(m, 32).T
    ds_ref, pts_ref = k["window"](jnp.asarray(digits.astype(np.int32)), ref_cache.points[:m])
    dsb = ds_ref.reshape(32, 1, m)
    local, tails = k["fold"](pts_ref.reshape(32, 1, m, 3, 16), dsb)
    from protocol_tpu.ops.segments import block_boundary_flags as ref_flags

    c = k["carry"](tails, ref_flags(dsb))
    want = np.asarray(k["bucket"](local.reshape(32, m, 3, 16), ds_ref, dsb, c))

    cache = gpp.PointCache.build(points, CPU)
    assert torch.equal(
        cache.points.reshape(-1, 4),
        gf.u64_to_tensor(ref_field.limbs_to_u64(np.asarray(ref_cache.points).reshape(-1, 16)), CPU),
    )
    ds, perm = gpp.msm_window(gf.u64_to_tensor(arr, CPU))
    assert np.array_equal(ds.numpy(), np.asarray(ds_ref))
    grid = gpp.msm_bucket(ds, perm, cache.points[:m])
    got = gf.u64_to_limbs(gf.tensor_to_u64(grid).reshape(-1, 4)).reshape(32, 256, 3, 16)
    assert np.array_equal(got, want)
    assert gpp._finish(got) == exact_msm(scalars, points)


def test_msm_edge_batch_through_kzg(edge_batch):
    scalars, points = edge_batch
    reference = exact_msm(scalars, points)
    with use_zk_backend("graft", device="cpu"):
        assert kzg.msm(scalars, points) == reference
    assert kzg.msm(scalars, points) == reference


def test_single_term_zero_scalars_and_duplicates():
    rng = np.random.default_rng(19)
    p = rand_points(rng, 1)[0]
    s = rand_scalar(rng)
    with use_zk_backend("graft", device="cpu"):
        assert kzg.msm([s], [p]) == p.mul(s)
        assert kzg.msm([0], [p]) == IDENTITY
        assert kzg.msm([], []) == IDENTITY
        assert kzg.msm([3, 3], [p, p]) == p.mul(6)


@pytest.mark.parametrize("layout", ["run_fills_a_block", "zero_one", "random"])
def test_plain_msm_across_blocks_equals_native(layout):
    """m = 256, four 64-lane blocks.  ``run_fills_a_block``: window 0's
    digit 3 starts exactly at a block and fills it, after a block whose
    last run is digit 2; the reference's carry adds that digit-2 run into
    bucket 3 there (ROADMAP §C), the port's does not."""
    rng = np.random.default_rng(23)
    if layout == "run_fills_a_block":
        scalars = [1] * 60 + [2] * 4 + [3] * 96 + [4] * 96
    elif layout == "zero_one":
        scalars = [int(b) for b in rng.integers(0, 2, 256)]
    else:
        scalars = [rand_scalar(rng) for _ in range(256)]
    points = [GENERATOR.mul(int(rng.integers(1, 1 << 40))) for _ in range(256)]
    arr = to_limbs_fast(scalars)
    got = gpp.msm_limbs(arr, gpp.PointCache.build(points, CPU))
    assert got == native.msm_limbs(arr, native._points_to_limbs(points))


@pytest.mark.slow
def test_reference_block_carry_fault_r7():
    """ROADMAP §C R7 on the reference itself: the layout of
    ``run_fills_a_block`` makes the reference's graft MSM wrong (a
    minute of XLA compile on the CPU), while the port's equals the exact
    sum."""
    rng = np.random.default_rng(23)
    scalars = [1] * 60 + [2] * 4 + [3] * 96 + [4] * 96
    points = [GENERATOR.mul(int(rng.integers(1, 1 << 40))) for _ in range(256)]
    exact = exact_msm(scalars, points)
    assert gpp.msm_limbs(to_limbs_fast(scalars), gpp.PointCache.build(points, CPU)) == exact
    assert tuple(ref_pippenger.msm(scalars, points)) != tuple(exact)


class TestLengthMismatch:
    def test_graft_msm_raises(self):
        pts = rand_points(np.random.default_rng(4), 2)
        with pytest.raises(ValueError, match="length mismatch"):
            zk_graft.msm([1, 2, 3], pts)

    def test_graft_msm_limbs_raises(self):
        cache = gpp.PointCache.build(rand_points(np.random.default_rng(5), 2), CPU)
        with pytest.raises(ValueError, match="length mismatch"):
            zk_graft.msm_limbs(np.zeros((3, 4), np.uint64), cache)

    def test_kzg_msm_raises_under_graft(self):
        pts = rand_points(np.random.default_rng(3), 3)
        with use_zk_backend("graft", device="cpu"):
            with pytest.raises(ValueError, match="length mismatch"):
                kzg.msm([1, 2], pts)


def test_point_cache_pads_with_point_zero_and_marks_identities():
    rng = np.random.default_rng(29)
    points = rand_points(rng, 5)
    points[1] = IDENTITY
    cache = gpp.PointCache.build(points, CPU)
    assert (cache.n, cache.padded, tuple(cache.points.shape)) == (5, 8, (8, 3, 4))
    assert torch.equal(cache.points[5:], cache.points[:1].expand(3, 3, 4))
    z = cache.points[:, 2]
    assert bool((z[1] == 0).all()) and torch.equal(z[0], gf.FQ.const(gf.FQ.r, CPU)[0])
    with pytest.raises(ValueError, match="empty"):
        gpp.PointCache.build([], CPU)


def test_commit_batch_matches_serial_and_native_commits():
    srs = kzg.Setup.generate(4, seed=b"graft-test-srs")
    rng = np.random.default_rng(29)
    polys = [to_limbs_fast([rand_scalar(rng) for _ in range(ln)]) for ln in (4, 7, 16)]
    native_commits = [srs.commit_limbs(p) for p in polys]
    with use_zk_backend("graft", device="cpu"):
        serial = [srs.commit_limbs(p) for p in polys]
        assert srs.commit_batch(polys) == serial == native_commits
    assert list(srs._graft_points) == [CPU]


def test_segments_equal_the_reference():
    import jax.numpy as jnp

    from protocol_tpu.ops import segments as ref_segments

    ids = np.array([[0, 0, 1, 1, 1, 2, 5, 5], [3, 3, 3, 3, 3, 3, 3, 3]])
    assert np.array_equal(segments.run_end_mask(torch.from_numpy(ids)).numpy(),
                          np.asarray(ref_segments.run_end_mask(jnp.asarray(ids))))
    blocked = ids.reshape(2, 4, 2)
    assert np.array_equal(segments.block_boundary_flags(torch.from_numpy(blocked)).numpy(),
                          np.asarray(ref_segments.block_boundary_flags(jnp.asarray(blocked))))
    vals = np.arange(16, dtype=np.int64).reshape(2, 8)
    flags = np.array([[1, 0, 0, 1, 0, 0, 0, 1], [0, 0, 1, 0, 0, 0, 0, 0]], dtype=bool)
    got = segments.segmented_carry_scan(torch.from_numpy(vals), torch.from_numpy(flags),
                                        lambda a, b: a + b, axis=1)
    want = ref_segments.segmented_carry_scan(jnp.asarray(vals), jnp.asarray(flags),
                                             lambda a, b: a + b, axis=1)
    assert np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The knob, the phase table, the attribution and the declared launches
# ---------------------------------------------------------------------------


def test_knob_holds_the_graft_device_and_restores():
    assert zk_graft.zk_backend() == "native"
    with use_zk_backend("graft", device="cpu"):
        assert (zk_graft.zk_backend(), zk_graft.zk_device()) == ("graft", CPU)
        with use_zk_backend("native"):
            assert zk_graft.zk_backend() == "native"
        assert zk_graft.zk_device() == CPU
    assert zk_graft.zk_backend() == "native"


def test_graft_without_a_card_raises_and_keeps_the_knob(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with use_zk_backend("graft"):
            pass
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zk_graft.set_zk_backend("graft")
    assert zk_graft.zk_backend() == "native"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpp.PointCache.build(rand_points(np.random.default_rng(1), 2))


def test_graft_phase_table_counts_ntt_and_msm():
    zk_graft.reset_phase_stats()
    gpp.reset_finish_stats()
    d = plonk.Domain(6)
    with use_zk_backend("graft", device="cpu"):
        d.fft([1] * d.n)
        kzg.msm([5, 7], rand_points(np.random.default_rng(2), 2))
    stats = zk_graft.phase_stats()
    assert stats["ntt"]["calls"] >= 1 and stats["ntt"]["seconds"] > 0
    assert stats["msm"]["calls"] == 1
    finish = gpp.finish_stats()
    assert finish["calls"] == 1 and 0 < finish["seconds"] <= stats["msm"]["seconds"]


def test_attribution_bridges_graft_engine_rows():
    from protocol_tpu_torch.obs import TRACER

    zk_graft.reset_phase_stats()
    with TRACER.span("snark") as sp:
        att = plonk._ProveAttribution()
        d = plonk.Domain(6)
        with att.stage("quotient"), use_zk_backend("graft", device="cpu"):
            d.fft([2] * d.n)
        att.attach()
    children = {(c.name, c.attrs.get("engine")) for c in sp.children}
    assert ("ntt", "graft") in children, children
    assert ("quotient", "host") in children, children


def test_zk_registry_and_budget_tables_agree():
    from protocol_tpu.zk import graft as ref_graft

    names = set(zk_graft.registered_zk_kernels())
    assert names == set(ZK_INVARIANTS) == set(ref_graft.registered_zk_kernels())
    wrappers = {"field_op": gf.field_op, "ntt_device": gntt.ntt_device,
                "msm_window": gpp.msm_window, "msm_bucket": gpp.msm_bucket}
    for budget in ZK_INVARIANTS.values():
        assert isinstance(wrappers[budget.wrapper].launches, int), budget.wrapper


@pytest.mark.parametrize(
    "entry, size, want",
    [
        ("ntt_limbs", dict(n=1 << 14, inverse=False), dict(field_op=0, ntt_device=2)),
        ("ntt_limbs", dict(n=1 << 16, inverse=True), dict(field_op=0, ntt_device=2)),
        ("ntt_limbs", dict(n=1, inverse=True), dict(field_op=0, ntt_device=0)),
        ("ntt_limbs", dict(n=1 << 8, inverse=True), dict(field_op=0, ntt_device=1)),
        ("ntt_limbs", dict(n=1 << 17, inverse=False), dict(field_op=0, ntt_device=2)),
        ("ntt_limbs", dict(n=1 << 24, inverse=False), dict(field_op=0, ntt_device=2)),
        ("msm_limbs", dict(n=33), dict(field_op=0, msm_window=1, msm_bucket=2)),
        ("msm_limbs", dict(n=0), dict(field_op=0, msm_window=0, msm_bucket=0)),
        ("point_cache", dict(n=1 << 15), dict(field_op=2)),
    ],
)
def test_declared_launches(entry, size, want):
    assert expected_zk_launches(entry, **size) == want


# ---------------------------------------------------------------------------
# The slice whole: PLONK proofs under graft, byte-identical to native
# ---------------------------------------------------------------------------


def mul_add(cs_mod, gadgets_mod, chips_mod):
    """out = 3*4 + 5, bound to the public instance."""
    c = cs_mod.ConstraintSystem()
    std = gadgets_mod.StdGate(c)
    out = std.add(std.mul(std.witness(3), std.witness(4)), std.witness(5))
    c.copy(c.assign(c.column("instance", "instance"), 0, 17), out)
    return c, [17]


def range_lookup(cs_mod, gadgets_mod, chips_mod):
    c = cs_mod.ConstraintSystem()
    std = gadgets_mod.StdGate(c)
    rng = chips_mod.RangeCheckChip(c, word_bits=4)
    x = std.witness(13)
    rng.assert_word(x)
    rng.assert_range(std.witness(200), 2)
    c.copy(c.assign(c.column("instance", "instance"), 0, 13), x)
    return c, [13]


@pytest.mark.parametrize("circuit", [mul_add, range_lookup], ids=["mul_add", "range_lookup"])
def test_small_proofs_under_graft_equal_the_reference_native_proof(circuit):
    from protocol_tpu.zk import chips as ref_chips
    from protocol_tpu.zk import cs as ref_cs
    from protocol_tpu.zk import gadgets as ref_gadgets

    c, inst = circuit(cs, gadgets, chips)
    rc, _ = circuit(ref_cs, ref_gadgets, ref_chips)
    max_table = max((len(lk.table) for lk in c.lookups), default=0)
    k = (max(c.n_rows + 1, max_table + 1, 4) - 1).bit_length()
    seed = f"small-{circuit.__name__}".encode()
    pk = plonk.compile_circuit(c, srs=kzg.Setup.generate(k + 1, seed=seed))
    ref_pk = ref_plonk.compile_circuit(rc, srs=ref_kzg.Setup.generate(k + 1, seed=seed))
    ref_proof = ref_plonk.prove(ref_pk, rc, inst, seed=b"graft", transcript="keccak")
    zk_graft.reset_phase_stats()
    with use_zk_backend("graft", device="cpu"):
        proof = plonk.prove(pk, c, inst, seed=b"graft", transcript="keccak")
    assert proof == ref_proof
    assert ref_plonk.verify(ref_pk.vk, inst, proof, transcript="keccak")
    stats = zk_graft.phase_stats()
    assert stats["msm"]["calls"] > 0 and stats["ntt"]["calls"] > 0


@pytest.mark.slow
def test_two_peer_node_prove_under_graft_equals_the_reference():
    """The smallest epoch statement (2 peers, k = 13) on the committed
    SRS: the port's node under ``zk_backend="graft"`` on the CPU proves
    the reference node's native bytes."""
    import pathlib

    from protocol_tpu.node.epoch import Epoch as RefEpoch
    from protocol_tpu.node.manager import Manager as RefManager
    from protocol_tpu.node.manager import ManagerConfig as RefManagerConfig
    from protocol_tpu_torch.node.bootstrap import FIXED_SET
    from protocol_tpu_torch.node.epoch import Epoch
    from protocol_tpu_torch.node.manager import Manager, ManagerConfig

    srs = str(pathlib.Path(__file__).resolve().parent.parent / "data" / "srs-15.bin")
    group = dict(num_neighbours=2, num_iter=1, fixed_set=list(FIXED_SET[:2]), srs_path=srs)
    ours = Manager(ManagerConfig(backend="cuda-windowed", device="cpu", zk_backend="graft", **group))
    theirs = RefManager(RefManagerConfig(backend="tpu-windowed", **group))
    for m in (ours, theirs):
        m.generate_initial_attestations()
    ours.calculate_proofs(Epoch(1))
    theirs.calculate_proofs(RefEpoch(1))
    mine, ref = ours.get_proof(Epoch(1)), theirs.get_proof(RefEpoch(1))
    assert (mine.pub_ins, mine.proof) == (list(ref.pub_ins), ref.proof)
