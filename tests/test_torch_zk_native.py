"""The port's zk runtime (``zk/native.py``, built from ``native/zk_runtime.cpp``
and ``native/zk_ifma.cpp`` into ``build/protocol_tpu_torch/``) against its
own pure-Python fallbacks and against the reference package's runtime,
bit for bit: MSM, NTT, the gate bytecode evaluator (directly and through
``plonk._CosetEvaluator``), the vector field ops and the SRS ladder.  Both
runtimes export the same C names and live in this one process; each keeps
its own phase table.  The graft backend knob selects the card kernels
(ROADMAP A8, ``tests/test_torch_zk_graft.py``) on the device it holds;
each entry point runs here on the CPU."""

import random

import numpy as np
import pytest
import torch

from protocol_tpu.zk import kzg as ref_kzg
from protocol_tpu.zk import native as ref_native
from protocol_tpu.zk.bn254 import G1 as RefG1
from protocol_tpu_torch.crypto.field import MODULUS as R
from protocol_tpu_torch.utils.limbs import from_limbs, to_limbs
from protocol_tpu_torch.zk import graft, kzg, native, plonk
from protocol_tpu_torch.zk.bn254 import GENERATOR, IDENTITY

rnd = random.Random(0x5EED)


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    assert native.available(), "the port's zk runtime did not build"
    assert ref_native.available(), "the reference's zk runtime did not build"


def ref_points(points):
    return [RefG1(p.x, p.y) for p in points]


class TestLoader:
    def test_built_into_the_port_build_dir_keyed_by_sources_and_flags(self):
        path = native.library_path()
        assert path.parent == native.REPO / "build" / "protocol_tpu_torch"
        assert path.name.startswith("libzk_runtime-") and path.exists()
        assert {p.name for p in native.SOURCES} == {"zk_runtime.cpp", "zk_ifma.cpp"}
        assert {p.name for p in native.HEADERS} == {"constants.h", "zk_common.h"}
        assert "-march=native" not in native.CXX_FLAGS and "-fopenmp" not in native.CXX_FLAGS
        assert native._load().zk_abi_version() == native._ABI_VERSION == 4

    def test_a_separate_library_from_the_reference(self):
        assert native.library_path() != ref_native._LIB_PATH
        assert native._load()._name != ref_native._load()._name

    def test_phase_tables_stay_apart(self):
        scalars = [rnd.randrange(R) for _ in range(40)]
        points = [GENERATOR.mul(rnd.randrange(1, R)) for _ in range(40)]
        native.reset_phase_stats()
        ref_native.msm(scalars, ref_points(points))
        assert native.phase_stats()["msm"]["calls"] == 0
        before = ref_native.phase_stats()["msm"]["calls"]
        native.msm(scalars, points)
        assert native.phase_stats()["msm"]["calls"] == 1
        assert ref_native.phase_stats()["msm"]["calls"] == before
        assert set(native.phase_stats()) == set(native.PHASES) == set(ref_native.PHASES)


class TestMsm:
    @pytest.mark.parametrize("n", [32, 33, 100])
    def test_native_python_and_reference_agree(self, n):
        scalars = [rnd.randrange(R) for _ in range(n)]
        scalars[0], scalars[1], scalars[2] = 0, 1, R - 1
        points = [GENERATOR.mul(rnd.randrange(1, R)) for _ in range(n)]
        points[3] = IDENTITY
        got = native.msm(scalars, points)
        assert tuple(got) == tuple(kzg._msm_python(scalars, points))
        assert tuple(got) == tuple(ref_native.msm(scalars, ref_points(points)))
        assert tuple(kzg.msm(scalars, points)) == tuple(got)

    def test_limb_path_equal(self):
        n = 64
        srs = kzg.Setup.generate(6, seed=b"msm")
        coeffs = [rnd.randrange(R) for _ in range(n)]
        arr = to_limbs(coeffs)
        assert tuple(srs.commit_limbs(arr)) == tuple(kzg._msm_python(coeffs, srs.g1_powers))
        assert tuple(srs.commit_limbs(arr)) == tuple(
            ref_kzg.Setup.generate(6, seed=b"msm").commit_limbs(arr)
        )

    def test_length_mismatch_raises(self):
        with pytest.raises(ValueError, match="length mismatch"):
            native.msm([1, 2], [GENERATOR])


class TestNtt:
    @pytest.mark.parametrize("k", [1, 3, 4, 6, 10])
    @pytest.mark.parametrize("inverse", [False, True])
    def test_native_python_and_reference_agree(self, k, inverse):
        n = 1 << k
        vals = [rnd.randrange(R) for _ in range(n)]
        root = plonk.omega(k)
        if inverse:
            root = pow(root, R - 2, R)
        got = native.ntt(vals, root, inverse)
        assert got == plonk._py_ntt(vals, root, inverse)
        assert got == ref_native.ntt(vals, root, inverse)

    def test_domain_paths_agree(self, monkeypatch):
        d = plonk.Domain(7)
        coeffs = [rnd.randrange(R) for _ in range(100)]
        fast = d.fft(coeffs)
        arr = d.ifft_arr(fast)
        monkeypatch.setattr(plonk, "_native_lib", lambda: None)
        assert d.fft(coeffs) == fast
        assert from_limbs(d.ifft_arr(fast)) == from_limbs(arr)
        assert from_limbs(arr)[:100] == coeffs


def gate_expression():
    """A degree-4 gate over three columns with rotations, constants, a
    subtraction whose operands swap and a negation."""
    S = plonk.Sym
    a, b, c = S.col(0), S.col(1), S.col(2)
    return (a * b - S.const(7)) * S.col(0, 1) + (c - a * b * c) * S.const(R - 3) - (-S.col(1, -1))


class TestGateEvaluator:
    @pytest.mark.parametrize("m, stride", [(64, 8), (40, 1), (128, 4)])
    def test_eval_program_native_python_and_reference_agree(self, m, stride):
        sym = gate_expression()
        local = {0: 0, 1: 1, 2: 2}
        pool, code = {}, []
        plonk.linearize(sym, local, pool, code)
        consts = sorted(pool, key=pool.get)
        values = [[rnd.randrange(R) for _ in range(m)] for _ in range(3)]
        columns = np.stack([to_limbs(v) for v in values])
        got = native.eval_program(m, columns, stride, code, consts)
        want = [
            plonk.sym_eval(sym, lambda s, r, i=i: values[s][(i + r * stride) % m])
            for i in range(m)
        ]
        assert got == want
        assert got == ref_native.eval_program(m, columns, stride, code, consts)

    def test_malformed_program_raises(self):
        columns = np.zeros((1, 8, 4), dtype=np.uint64)
        with pytest.raises(ValueError, match="malformed"):
            native.eval_program(8, columns, 1, [2], [])

    def test_coset_evaluator_native_equal_to_fallback(self, monkeypatch):
        k, ext = 3, 4
        sym = gate_expression()
        coeffs = [[rnd.randrange(R) for _ in range(1 << k)] for _ in range(3)]

        def run():
            ev = plonk._CosetEvaluator(k, ext)
            for slot, c in enumerate(coeffs):
                ev.set_coeffs(slot, c)
            acc = ev.run(sym, None)
            return from_limbs(ev.run(sym, acc.copy()))

        fast = run()
        monkeypatch.setattr(plonk, "_native_lib", lambda: None)
        assert run() == fast


class TestFieldOps:
    def test_vector_ops_equal_python_and_reference(self):
        n = 37
        a = [rnd.randrange(R) for _ in range(n)]
        b = [rnd.randrange(R) for _ in range(n)]
        a[5] = 0
        assert native.vec_mul(a, b) == [x * y % R for x, y in zip(a, b)]
        assert native.vec_mul(a, b) == ref_native.vec_mul(a, b)
        assert native.batch_inv(a) == plonk._batch_inv(a) == ref_native.batch_inv(a)
        base = rnd.randrange(R)
        assert from_limbs(native.powers(base, n)) == plonk._powers(base, n)
        x = rnd.randrange(R)
        assert native.poly_eval_limbs(to_limbs(a), x) == kzg._eval_poly(a, x)
        y = kzg._eval_poly(a, x)
        assert from_limbs(native.div_linear_limbs(to_limbs(a), x)) == kzg._div_by_linear(a, x, y)
        acc = to_limbs(a)
        native.scale_add(acc, to_limbs(b), x)
        assert from_limbs(acc) == [(p + x * q) % R for p, q in zip(a, b)]

    def test_srs_ladder_equal(self):
        tau = rnd.randrange(R)
        got = native.srs_g1_powers(tau, 70)
        assert [tuple(p) for p in got[:4]] == [tuple(GENERATOR.mul(pow(tau, i, R))) for i in range(4)]
        assert [tuple(p) for p in got] == [tuple(p) for p in ref_native.srs_g1_powers(tau, 70)]


class TestGraftKnob:
    def test_native_is_the_default(self):
        assert graft.zk_backend() == "native"
        with graft.use_zk_backend("native"):
            assert graft.zk_backend() == "native"
        assert graft.zk_backend() == "native"

    @pytest.mark.parametrize("select", ["set", "use"])
    def test_graft_raises_naming_a8(self, select):
        """The graft kernels are ported (ROADMAP A8): ``set_zk_backend``
        and ``use_zk_backend`` select ``"graft"`` with its device, and the
        scoped form restores the native default."""
        cpu = torch.device("cpu")
        if select == "set":
            try:
                graft.set_zk_backend("graft", device="cpu")
                assert (graft.zk_backend(), graft.zk_device()) == ("graft", cpu)
            finally:
                graft.set_zk_backend("native")
        else:
            with graft.use_zk_backend("graft", device="cpu"):
                assert (graft.zk_backend(), graft.zk_device()) == ("graft", cpu)
        assert graft.zk_backend() == "native"

    def test_unknown_backend_is_a_value_error(self):
        with pytest.raises(ValueError, match="unknown zk_backend"):
            graft.set_zk_backend("cuda")

    @pytest.mark.parametrize(
        "entry, args",
        [("msm", ([5, 7, 0], 3)), ("msm_limbs", ([5, 7, 0], 3)), ("msm_limbs_batch", ([5, 7, 0], 3)),
         ("point_cache", ([], 3)), ("ntt_limbs", ([1, 2, 3, 4, 5, 6, 7, R - 1], 0))],
    )
    def test_entry_points_raise_naming_a8(self, entry, args):
        """Each graft entry point runs on the CPU (the kernels' plain
        versions) and agrees with the native engine."""
        values, npoints = args
        points = [GENERATOR.mul(i + 2) for i in range(npoints)]
        with graft.use_zk_backend("graft", device="cpu"):
            if entry == "ntt_limbs":
                d = plonk.Domain(3)
                got = graft.ntt_limbs(to_limbs(values), d.omega, False)
            elif entry == "point_cache":
                cache = graft.point_cache(points)
                got, want = (cache.n, cache.padded, cache.points.device.type), (3, 4, "cpu")
            else:
                cache = graft.point_cache(points)
                if entry == "msm":
                    got = graft.msm(values, points)
                elif entry == "msm_limbs":
                    got = graft.msm_limbs(to_limbs(values), cache)
                else:
                    got = graft.msm_limbs_batch([to_limbs(values), to_limbs(values[:1])], cache)
        if entry == "ntt_limbs":
            assert np.array_equal(got, d.ntt_limbs(to_limbs(values), d.omega, False))
        elif entry in ("msm", "msm_limbs"):
            assert got == kzg.msm(values, points)
        elif entry == "msm_limbs_batch":
            assert got == [kzg.msm(values, points), kzg.msm(values[:1], points[:1])]
        else:
            assert got == want

    def test_phase_table_has_the_native_shape(self):
        assert graft.PHASES == native.PHASES
        assert graft.phase_delta(graft.phase_stats(), graft.phase_stats()) == {
            p: {"calls": 0, "seconds": 0.0} for p in graft.PHASES
        }
