"""The double-single prefix passes of the step and their CUDA kernels.

``ds_cumsum_axis1`` (kernel ``csrc/ds_cumsum_rows.cu``) and
``compensated_cumsum`` (kernel ``csrc/compensated_scan.cu``) replace two
jit'd XLA passes of the reference, ``_ds_cumsum_axis1`` and
``_compensated_cumsum`` (``protocol_tpu/ops/sparse.py``).  The prefix
sums are bit-identical to the JAX package, so the kernels must equal
their plain versions bit for bit, op order and signed zeros included.

The kernels run only on a card, where ``chip_smoke.py`` holds them
against their plain versions.  Here:

- each kernel's schedule is written out as a numpy float32 emulation
  (K5's level-by-level double-buffered form with its per-thread float4
  reads, K6's iterative up- and down-sweep with the in-place levels and
  the ``+ 0.0`` interleave) and held bit-equal to the plain version, so
  a wrong iterative form shows on the CPU;
- both prefixes are held bit-equal to JAX on adversarial rows (signed
  zeros, ±1e30 beside 1e-30, exact cancellations); denormal rows are
  held against the plain version only, since XLA's CPU backend flushes
  denormals and PyTorch keeps them;
- the wrappers' CPU route, launch counters and argument checks;
- ``rowsum_sorted`` and ``windowed_ct`` go through the wrappers and stay
  bit-equal to the JAX package.

Bit equality is checked on the uint32 views: ``np.array_equal`` would
take ``-0.0`` for ``+0.0``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protocol_tpu.models.graphs import scale_free
from protocol_tpu.ops import gather_window as jgw
from protocol_tpu.ops import sparse as jsp
from protocol_tpu_torch.ops import gather_window as tgw
from protocol_tpu_torch.ops import sparse as tsp

j_ds_cumsum = jax.jit(jsp._ds_cumsum_axis1)
j_compensated = jax.jit(jsp._compensated_cumsum)
j_rowsum = jax.jit(jsp.rowsum_sorted)
j_windowed_ct = jax.jit(jgw.windowed_ct, static_argnames=("n_rows", "table_entries", "interpret"))

F32 = np.float32


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_bits_equal(port, ref) -> None:
    port = np.ascontiguousarray(np.asarray(port, F32))
    ref = np.ascontiguousarray(np.asarray(ref, F32))
    assert port.shape == ref.shape
    diff = np.flatnonzero(port.view(np.uint32) != ref.view(np.uint32))
    assert diff.size == 0, (
        f"{diff.size} elements differ, first at {diff[0]}: "
        f"{port.flat[diff[0]]!r} vs {ref.flat[diff[0]]!r}"
    )


# ---------------------------------------------------------------------------
# The kernels' schedules in numpy float32
# ---------------------------------------------------------------------------


def np_ds_add(ah, al, bh, bl):
    s = ah + bh
    v = s - ah
    e = (ah - (s - v)) + (bh - v)
    e = (e + al) + bl
    hi = s + e
    return hi, e - (hi - s)


def np_two_sum(ah, al, bh, bl):
    s = ah + bh
    bb = s - ah
    err = (ah - (s - bb)) + (bh - bb)
    return s, (al + bl) + err


def emulate_ds_cumsum_rows(x: np.ndarray):
    """``ds_cumsum_rows.cu`` as it runs: per row B/4 threads holding 4
    consecutive elements in registers ``(h, l)[row, thread, k]``; each
    level writes the registers to the level's buffer, then reads the
    i-s values from it — the aligned float4 of thread t - s/4 for
    s >= 4, thread t-1's float4 and the thread's own previous-level
    registers for s < 4, zeros where the source thread is below 0."""
    rows, b = x.shape
    n_threads = b // 4
    h = x.astype(F32).reshape(rows, n_threads, 4).copy()
    l = np.zeros_like(h)
    s = 1
    while s < b:
        buf_h, buf_l = h.copy(), l.copy()
        if s >= 4:
            q = s // 4
            pad = np.zeros((rows, q, 4), F32)
            bh = np.concatenate([pad, buf_h[:, : n_threads - q]], axis=1)
            bl = np.concatenate([pad, buf_l[:, : n_threads - q]], axis=1)
        else:
            pad = np.zeros((rows, 1, 4), F32)
            wh = np.concatenate([np.concatenate([pad, buf_h[:, :-1]], axis=1), buf_h], axis=2)
            wl = np.concatenate([np.concatenate([pad, buf_l[:, :-1]], axis=1), buf_l], axis=2)
            bh, bl = wh[:, :, 4 - s : 8 - s], wl[:, :, 4 - s : 8 - s]
        h, l = np_ds_add(h, l, bh, bl)
        s <<= 1
    return h.reshape(rows, b), l.reshape(rows, b)


def emulate_compensated_scan(x: np.ndarray):
    """``compensated_scan.cu`` as it runs: level 1 from x (lo = +0.0)
    into ``scratch`` at offset 0, level k+1 behind level k while level k
    has two pairs or more; then each level replaced in place by its scan
    (``+ 0.0`` on every output), top down, and level 0 into (hi, lo).
    Each level's reads come before its writes, as the barrier between
    levels and the kernel's disjoint read/write sets make them."""
    x = np.asarray(x, F32)
    n = x.shape[0]
    zero = F32(0.0)
    if n < 2:
        return x.copy(), np.zeros_like(x)
    scratch = np.empty((n, 2), F32)
    m = n // 2
    scratch[:m, 0], scratch[:m, 1] = np_two_sum(
        x[0 : 2 * m : 2], np.zeros(m, F32), x[1 : 2 * m : 2], np.zeros(m, F32)
    )
    off, levels = 0, 1
    while m >= 2:
        a = scratch[off : off + m]
        half = m // 2
        r = scratch[off + m : off + m + half]
        r[:, 0], r[:, 1] = np_two_sum(a[0 : 2 * half : 2, 0], a[0 : 2 * half : 2, 1],
                                      a[1 : 2 * half : 2, 0], a[1 : 2 * half : 2, 1])
        off += m
        m = half
        levels += 1

    def down(a_h, a_l, sup):
        """The scan of one level of ``len(a_h)`` pairs from the scan of
        the level above (``sup``)."""
        m = a_h.shape[0]
        n_even = (m + 1) // 2
        eh, el = a_h[0::2].copy(), a_l[0::2].copy()
        j = np.arange(1, n_even)
        eh[1:], el[1:] = np_two_sum(sup[j - 1, 0], sup[j - 1, 1], a_h[2 * j], a_l[2 * j])
        out = np.empty((m, 2), F32)
        out[0::2, 0], out[0::2, 1] = eh + zero, el + zero
        out[1::2] = sup[: m // 2] + zero
        return out

    for k in range(levels - 1, 0, -1):
        up = off
        m = n >> k
        off -= m
        a = scratch[off : off + m]
        a[:] = down(a[:, 0], a[:, 1], scratch[up : up + m // 2])
    assert off == 0
    out = down(x, np.zeros(n, F32), scratch[: n // 2])
    return out[:, 0].copy(), out[:, 1].copy()


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def adversarial_rows(b: int, denormals: bool = True) -> np.ndarray:
    """Rows that would show a reassociated, contracted, zero-dropping or
    flushing scan: all -0.0; ±1e30 beside 1e-30; exact cancellations;
    a mix of magnitudes; and, with ``denormals``, a row of denormals.

    XLA's CPU backend flushes denormals to zero, while PyTorch and the
    kernels (built without ``-ftz``) keep them, so the denormal row is
    held against the plain version only, not against JAX."""
    rng = np.random.default_rng(b)
    i = np.arange(b)
    big = np.where(i % 4 == 0, 1e30, np.where(i % 4 == 2, -1e30, 1e-30))
    pairs = rng.standard_normal(b // 2).astype(F32)
    cancel = np.stack([pairs, -pairs], axis=1).reshape(b)
    signed_zero = np.where(i % 3 == 0, -0.0, 0.0)
    denormal = rng.integers(-3, 4, b) * np.float32(1e-40)
    mixed = rng.standard_normal(b) * 10.0 ** rng.integers(-30, 30, b)
    rows = [np.full(b, -0.0), big, cancel, signed_zero, mixed] + ([denormal] if denormals else [])
    return np.stack(rows).astype(F32)


def adversarial_vectors(n: int, denormals: bool = True) -> list[np.ndarray]:
    return [row[:n] for row in adversarial_rows(max(n + n % 2, 4), denormals)]


# ---------------------------------------------------------------------------
# The schedules against the plain versions
# ---------------------------------------------------------------------------


class TestKernelSchedules:
    @pytest.mark.parametrize("b", [1024, 2048])
    def test_ds_cumsum_rows_schedule_on_random_rows(self, b):
        x = (np.random.default_rng(b).standard_normal((5, b)) * 1e3).astype(F32)
        eh, el = emulate_ds_cumsum_rows(x)
        ph, pl = tsp._ds_cumsum_axis1(t(x))
        assert_bits_equal(eh, ph)
        assert_bits_equal(el, pl)

    @pytest.mark.parametrize("b", [1024, 2048])
    def test_ds_cumsum_rows_schedule_on_adversarial_rows(self, b):
        x = adversarial_rows(b)
        eh, el = emulate_ds_cumsum_rows(x)
        ph, pl = tsp._ds_cumsum_axis1(t(x))
        assert_bits_equal(eh, ph)
        assert_bits_equal(el, pl)

    @pytest.mark.parametrize("n", list(range(1, 71)) + [1000, 5001, 8057])
    def test_compensated_scan_schedule(self, n):
        x = (np.random.default_rng(n).standard_normal(n) * 1e3).astype(F32)
        eh, el = emulate_compensated_scan(x)
        ph, pl = tsp._compensated_cumsum(t(x))
        assert_bits_equal(eh, ph)
        assert_bits_equal(el, pl)

    @pytest.mark.parametrize("n", [1, 2, 3, 64, 1000, 8057])
    def test_compensated_scan_schedule_on_adversarial_vectors(self, n):
        for x in adversarial_vectors(n):
            eh, el = emulate_compensated_scan(x)
            ph, pl = tsp._compensated_cumsum(t(x))
            assert_bits_equal(eh, ph)
            assert_bits_equal(el, pl)


# ---------------------------------------------------------------------------
# The prefixes against JAX, bit for bit
# ---------------------------------------------------------------------------


class TestAgainstJax:
    @pytest.mark.parametrize("b", [1024, 2048])
    def test_ds_cumsum_adversarial_rows(self, b):
        x = adversarial_rows(b, denormals=False)
        jh, jl = j_ds_cumsum(jnp.asarray(x))
        th, tl = tsp.ds_cumsum_axis1(t(x))
        assert_bits_equal(th, jh)
        assert_bits_equal(tl, jl)

    @pytest.mark.parametrize("n", [1, 2, 3, 1024, 2048, 8057])
    def test_compensated_cumsum_adversarial_vectors(self, n):
        for x in adversarial_vectors(n, denormals=False):
            jh, jl = j_compensated(jnp.asarray(x))
            th, tl = tsp.compensated_cumsum(t(x))
            assert_bits_equal(th, jh)
            assert_bits_equal(tl, jl)


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------


class TestWrappers:
    @pytest.mark.parametrize("shape", [(3, 1024), (2, 2048), (4, 100), (0, 1024)])
    def test_ds_cumsum_axis1_takes_plain_route_on_cpu_without_counting(self, shape):
        x = t(np.random.default_rng(sum(shape)).standard_normal(shape).astype(F32))
        before = tsp.ds_cumsum_axis1.launches
        hi, lo = tsp.ds_cumsum_axis1(x)
        assert tsp.ds_cumsum_axis1.launches == before == 0
        ph, pl = tsp._ds_cumsum_axis1(x)
        assert_bits_equal(hi, ph)
        assert_bits_equal(lo, pl)

    @pytest.mark.parametrize("n", [0, 1, 7, 8057])
    def test_compensated_cumsum_takes_plain_route_on_cpu_without_counting(self, n):
        x = t(np.random.default_rng(n).standard_normal(n).astype(F32))
        before = tsp.compensated_cumsum.launches
        hi, lo = tsp.compensated_cumsum(x)
        assert tsp.compensated_cumsum.launches == before == 0
        ph, pl = tsp._compensated_cumsum(x)
        assert_bits_equal(hi, ph)
        assert_bits_equal(lo, pl)

    @pytest.mark.parametrize(
        "arg, exc",
        [
            (torch.zeros(1024), ValueError),
            (torch.zeros(2, 1024, dtype=torch.float64), TypeError),
            (torch.zeros(1024, 2).t(), ValueError),
            (torch.zeros(2, 1024, device="meta"), ValueError),
        ],
        ids=["rank", "dtype", "non-contiguous", "meta-device"],
    )
    def test_ds_cumsum_axis1_rejects_bad_operands(self, arg, exc):
        with pytest.raises(exc):
            tsp.ds_cumsum_axis1(arg)

    @pytest.mark.parametrize(
        "arg, exc",
        [
            (torch.zeros(4, 4), ValueError),
            (torch.zeros(16, dtype=torch.float64), TypeError),
            (torch.zeros(32)[::2], ValueError),
            (torch.zeros(16, device="meta"), ValueError),
        ],
        ids=["rank", "dtype", "non-contiguous", "meta-device"],
    )
    def test_compensated_cumsum_rejects_bad_operands(self, arg, exc):
        with pytest.raises(exc):
            tsp.compensated_cumsum(arg)

    def test_meta_tensors_raise_instead_of_falling_back(self):
        with pytest.raises(ValueError, match="cpu or cuda"):
            tsp.ds_cumsum_axis1(torch.zeros(2, 1024, device="meta"))
        with pytest.raises(ValueError, match="cpu or cuda"):
            tsp.compensated_cumsum(torch.zeros(16, device="meta"))

    def test_kernel_widths_are_the_main_paths(self):
        assert tsp.DS_CUMSUM_WIDTHS == (tgw.ROW, tsp._ROWSUM_BLOCK) == (1024, 2048)


# ---------------------------------------------------------------------------
# The step's passes go through the wrappers
# ---------------------------------------------------------------------------


@pytest.fixture
def spied(monkeypatch):
    """Count the calls of both wrappers wherever the step looks them up."""
    calls = {"ds_cumsum_axis1": 0, "compensated_cumsum": 0}

    def spy(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    ds = spy("ds_cumsum_axis1", tsp.ds_cumsum_axis1)
    monkeypatch.setattr(tsp, "ds_cumsum_axis1", ds)
    scan = spy("compensated_cumsum", tsp.compensated_cumsum)
    monkeypatch.setattr(tsp, "compensated_cumsum", scan)
    return calls


class TestRoutedPasses:
    @pytest.mark.parametrize("e, n", [(5000, 300), (100_000, 4000), (2048, 1)])
    def test_rowsum_sorted(self, spied, e, n):
        rng = np.random.default_rng(e - n)
        contrib = rng.random(e).astype(F32)
        cuts = np.sort(rng.integers(0, e + 1, n - 1))
        row_ptr = np.concatenate([[0], cuts, [e]]).astype(np.int32)
        port = tsp.rowsum_sorted(t(contrib), t(row_ptr))
        assert spied == {"ds_cumsum_axis1": 1, "compensated_cumsum": 1}
        assert_bits_equal(port, j_rowsum(jnp.asarray(contrib), jnp.asarray(row_ptr)))
        assert_bits_equal(port, tsp.rowsum_sorted_plain(t(contrib), t(row_ptr)))

    def test_windowed_ct(self, spied):
        n, e = 3000, 40_000
        g = scale_free(n, e, seed=11).drop_self_edges()
        w, _ = g.row_normalized()
        g = type(g)(g.n, g.src, g.dst, w, g.pre_trusted).sorted_by_dst()
        plan = jgw.build_window_plan(g.src, g.dst, g.weight, n=n)
        x = np.random.default_rng(n).random(n).astype(F32)
        x /= x.sum()
        kw = dict(n_rows=plan.n_rows, table_entries=plan.table_entries)
        ref = j_windowed_ct(*plan.device_args(), jnp.asarray(x), interpret=True, **kw)
        port_plan = tgw.WindowPlan.from_arrays(plan.to_arrays(core_only=False))
        args = port_plan.device_args("cpu")
        run_ptr = tgw.row_run_ptr(args[3], args[4], plan.n_rows)
        port = tgw.windowed_ct(*args, t(x), run_ptr=run_ptr, **kw)
        # rowsum_sorted's blocks and block totals; prefix_bridge takes the
        # plan rows' prefix.
        assert spied == {"ds_cumsum_axis1": 1, "compensated_cumsum": 1}
        assert_bits_equal(port, ref)
