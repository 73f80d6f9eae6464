"""The double-single prefix passes of the step and their CUDA kernels.

``ds_cumsum_axis1`` (kernel ``csrc/ds_cumsum_rows.cu``) and
``block_total_scan`` (kernel ``csrc/compensated_scan.cu``) replace
jit'd XLA passes of the reference: ``_ds_cumsum_axis1``, and the block
totals ``wh[:, -1] + wl[:, -1]`` of ``rowsum_sorted`` with their
``_compensated_cumsum`` (``protocol_tpu/ops/sparse.py``).  The prefix
sums are bit-identical to the JAX package, so the kernels must equal
their plain versions bit for bit, op order and signed zeros included.

The kernels run only on a card, where ``chip_smoke.py`` holds them
against their plain versions.  Here:

- each kernel's schedule is written out as a numpy float32 emulation
  (K5's level-by-level double-buffered form with its per-thread float4
  reads; K6's: the totals read from the lanes, chunks of eight with
  their pair trees, the depth D of the chunks the lanes feed, the
  shared levels up and down in place, the ``pz`` chain of the element
  before a chunk and the ``+ 0.0`` interleave) and held bit-equal to
  the plain version, so a wrong iterative form shows on the CPU;
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
#: The reference's block-total scan in ``rowsum_sorted``
#: (``protocol_tpu/ops/sparse.py:120``): the totals, then their scan.
j_block_total_scan = jax.jit(lambda wh, wl: jsp._compensated_cumsum(wh[:, -1] + wl[:, -1]))
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


#: ``compensated_scan.cu``'s shape: a cluster of 8 blocks of 512 threads,
#: chunks of eight, at most 4,095 elements on the first shared level.
K6_CLUSTER, K6_THREADS, K6_SHARED_LEVEL = 8, 512, 4095


def k6_depth(n: int) -> int:
    """The kernel's depth D: chunks of 8**D totals feed the first shared level."""
    d = 1
    while (n >> (3 * d)) > K6_SHARED_LEVEL:
        d += 1
    return d


def pz(v):
    """The interleave's ``+ 0.0`` on both lanes."""
    return v[0] + F32(0.0), v[1] + F32(0.0)


def tree_up(a):
    """A chunk's pair tree from its eight elements ``a`` = (hi, lo), each
    (chunks, 8): levels of 4, 2 and 1, every pair computed."""
    t1 = np_two_sum(a[0][:, 0::2], a[1][:, 0::2], a[0][:, 1::2], a[1][:, 1::2])
    t2 = np_two_sum(t1[0][:, 0::2], t1[1][:, 0::2], t1[0][:, 1::2], t1[1][:, 1::2])
    t3 = np_two_sum(t2[0][:, 0], t2[1][:, 0], t2[0][:, 1], t2[1][:, 1])
    return t1, t2, t3


def level_down(a, before, sup, first, n_k):
    """``level_down`` of the kernel for every chunk: the scan of 2M
    elements ``a`` of a level with ``n_k`` elements from the scan ``sup``
    of their M pairs; ``before[:, e]`` is what even element 2e adds onto
    (the scan of the element before its pair); ``first`` marks the chunk
    that starts the level.  A level of fewer than two elements is its own
    scan."""
    if n_k < 2:
        return a[0].copy(), a[1].copy()
    h, l = np.empty_like(a[0]), np.empty_like(a[1])
    eh, el = pz(np_two_sum(before[0], before[1], a[0][:, 0::2], a[1][:, 0::2]))
    zh, zl = pz((a[0][:, 0], a[1][:, 0]))
    eh[:, 0], el[:, 0] = np.where(first, zh, eh[:, 0]), np.where(first, zl, el[:, 0])
    h[:, 0::2], l[:, 0::2] = eh, el
    h[:, 1::2], l[:, 1::2] = pz(sup)
    return h, l


def tree_down(a, tree, q, k, n, prev, own):
    """``tree_down``: the scan of chunks ``q``'s eight level-k elements
    from own = S_{k+3}[q] and prev = S_{k+3}[q-1], and ``before`` =
    S_k[8q - 1], which the recursion makes pz(prev) one level down, pz of
    that the next, and so on."""
    t1, t2, _ = tree
    first = q == 0
    col = lambda v: (v[0][:, None], v[1][:, None])  # noqa: E731
    s2 = level_down(t2, col(prev), col(own), first, n >> (k + 2))
    p2 = pz(prev)
    before = (np.stack([p2[0], s2[0][:, 0]], 1), np.stack([p2[1], s2[1][:, 0]], 1))
    s1 = level_down(t1, before, s2, first, n >> (k + 1))
    p1 = pz(p2)
    before = (np.concatenate([p1[0][:, None], s1[0][:, :3]], 1),
              np.concatenate([p1[1][:, None], s1[1][:, :3]], 1))
    return level_down(a, before, s1, first, n >> k), pz(p1)


def padded_chunks(v, count):
    """The first ``count * 8`` elements of ``v`` = (hi, lo) as (count, 8),
    +0.0 past its end (the kernel reads an absent element as +0.0)."""
    out = np.zeros((2, count * 8), F32)
    m = min(v[0].shape[0], count * 8)
    out[0, :m], out[1, :m] = v[0][:m], v[1][:m]
    return out[0].reshape(count, 8), out[1].reshape(count, 8)


def up_global(x, d, count):
    """``up<d>``: the level-3d element of chunks 0 .. count-1 of depth d
    (d = 0: the totals themselves, lo = +0.0)."""
    if d == 0:
        h = np.zeros(count, F32)
        h[: min(x.shape[0], count)] = x[:count]
        return h, np.zeros(count, F32)
    sub = up_global(x, d - 1, count * 8)
    return tree_up((sub[0].reshape(count, 8), sub[1].reshape(count, 8)))[2]


def down_global(x, d, q, n, prev, own, out):
    """``down<d>`` for chunks ``q`` of depth d, their trees built anew:
    depth 1 writes the scan to ``out``; deeper chunks pass each
    sub-chunk its own and previous element's scan (``before`` for the
    first) one depth down, where a sub-chunk holds a total."""
    a = up_global(x, d - 1, (int(q.max()) + 1) * 8)
    a = (a[0].reshape(-1, 8)[q], a[1].reshape(-1, 8)[q])
    s, before = tree_down(a, tree_up(a), q, 3 * (d - 1), n, prev, own)
    if d == 1:
        idx = (8 * q[:, None] + np.arange(8)).reshape(-1)
        keep = idx < n
        out[0][idx[keep]], out[1][idx[keep]] = s[0].reshape(-1)[keep], s[1].reshape(-1)[keep]
        return
    sub = (8 * q[:, None] + np.arange(8)).reshape(-1)
    sub_prev = (np.concatenate([before[0][:, None], s[0][:, :7]], 1).reshape(-1),
                np.concatenate([before[1][:, None], s[1][:, :7]], 1).reshape(-1))
    keep = sub * 8 ** (d - 1) < n
    down_global(x, d - 1, sub[keep], n, (sub_prev[0][keep], sub_prev[1][keep]),
                (s[0].reshape(-1)[keep], s[1].reshape(-1)[keep]), out)


def emulate_compensated_scan(wh: np.ndarray, wl: np.ndarray):
    """``compensated_scan.cu`` as it runs on the prefix lanes (n, B):
    the totals ``wh[:, -1] + wl[:, -1]`` read by the kernel; chunks of
    8**D totals shared out over the cluster's 8 blocks (at most one a
    thread), each chunk's tree held from step 1 to step 5; the level-3D
    elements in every block's shared memory; the shared passes up (each
    level behind the one below) and down (each chunk's scan in place),
    identical in every block; then each chunk's scan to the outputs from
    its tree, deeper chunks rebuilding their sub-chunks' trees."""
    x = np.asarray(wh, F32)[:, -1] + np.asarray(wl, F32)[:, -1]
    n = x.shape[0]
    d = k6_depth(n)
    chunks = -(-n // 8 ** d)
    per_block = -(-chunks // K6_CLUSTER)
    assert chunks <= K6_SHARED_LEVEL + 1 and per_block <= K6_THREADS
    # 1-2. Up from the lanes, one chunk a thread; level 3D to the shared copies.
    trees = up_global(x, d, chunks)
    n_top = n >> (3 * d)
    levels = [(trees[0][:n_top].copy(), trees[1][:n_top].copy())]
    # 3. Up in shared memory while a level holds two elements or more.
    while levels[-1][0].shape[0] >= 2:
        m = levels[-1][0].shape[0]
        top = tree_up(padded_chunks(levels[-1], -(-m // 8)))[2]
        levels.append((top[0][: m >> 3], top[1][: m >> 3]))
    # 4. Down in shared memory, top to bottom, each level in place.
    for j in range(len(levels) - 2, -1, -1):
        m = levels[j][0].shape[0]
        c = -(-m // 8)
        a = padded_chunks(levels[j], c)
        own = padded_chunks(levels[j + 1], -(-c // 8))
        own = (own[0].reshape(-1)[:c], own[1].reshape(-1)[:c])
        prev = (np.concatenate([[F32(0)], own[0][:-1]]), np.concatenate([[F32(0)], own[1][:-1]]))
        s, _ = tree_down(a, tree_up(a), np.arange(c), 3 * d + 3 * j, n, prev, own)
        levels[j] = (s[0].reshape(-1)[:m].copy(), s[1].reshape(-1)[:m].copy())
    # 5. Down to the outputs, prev and own read from the shared copy.
    own = padded_chunks(levels[0], -(-chunks // 8))
    own = (own[0].reshape(-1)[:chunks], own[1].reshape(-1)[:chunks])
    prev = (np.concatenate([[F32(0)], own[0][:-1]]), np.concatenate([[F32(0)], own[1][:-1]]))
    out = (np.full(n, np.nan, F32), np.full(n, np.nan, F32))
    down_global(x, d, np.arange(chunks), n, prev, own, out)
    return out


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


#: Lane width of the block-total tests: the scan reads the last column only.
LANE_WIDTH = 3
#: Block counts of the K6 schedule tests: every n to 70 (chunk tails,
#: odd counts), 2**j - 1, 2**j + 1, the windowed and CSR steps' counts,
#: one block over 1024 chunks of eight, and both sides of the depth
#: thresholds 32,768 and 262,144.
K6_SIZES = sorted(
    set(range(1, 71))
    | {2**j + e for j in range(7, 15) for e in (-1, 1)}
    | {1000, 5001, 8057, 8074, 24415, 8191, 8192, 8193, 8200}
    | {32767, 32768, 32769, 40000, 262143, 262144, 262145}
)


def random_lanes(n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Prefix lanes (n, LANE_WIDTH): hi of order 1e3, lo of order 1e-5."""
    rng = np.random.default_rng(n + seed)
    wh = (rng.standard_normal((n, LANE_WIDTH)) * 1e3).astype(F32)
    wl = (rng.standard_normal((n, LANE_WIDTH)) * 1e-5).astype(F32)
    return wh, wl


def adversarial_lanes(n: int, denormals: bool = True) -> list[tuple[np.ndarray, np.ndarray]]:
    """Lanes whose totals are exactly each adversarial vector (lo = -0.0,
    which adds nothing, not even to a -0.0), then lanes with an
    adversarial vector in both lanes, so the totals' add itself cancels
    and rounds."""
    cases = []
    vectors = adversarial_vectors(n, denormals)
    for i, v in enumerate(vectors):
        wh = np.zeros((n, LANE_WIDTH), F32)
        wh[:, -1] = v
        cases.append((wh, np.full((n, LANE_WIDTH), -0.0, F32)))
        other = vectors[(i + 1) % len(vectors)]
        wl = np.zeros((n, LANE_WIDTH), F32)
        wl[:, -1] = other * F32(1e-3)
        cases.append((wh.copy(), wl))
    return cases


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

    @pytest.mark.parametrize("n", K6_SIZES)
    def test_compensated_scan_schedule(self, n):
        wh, wl = random_lanes(n)
        eh, el = emulate_compensated_scan(wh, wl)
        ph, pl = tsp._block_total_scan(t(wh), t(wl))
        assert_bits_equal(eh, ph)
        assert_bits_equal(el, pl)

    @pytest.mark.parametrize("n", [1, 2, 3, 64, 1000, 8057, 32768])
    def test_compensated_scan_schedule_on_adversarial_vectors(self, n):
        for wh, wl in adversarial_lanes(n):
            eh, el = emulate_compensated_scan(wh, wl)
            ph, pl = tsp._block_total_scan(t(wh), t(wl))
            assert_bits_equal(eh, ph)
            assert_bits_equal(el, pl)

    @pytest.mark.parametrize("n", [1, 7, 8, 9, 4095 * 8, 4096 * 8, 4096 * 64 - 1, 4096 * 64])
    def test_compensated_scan_depth(self, n):
        """The first shared level holds at most 4,095 elements from at
        most 4,096 chunks, 512 a block of the cluster: depth 1 up to
        32,767 blocks, 2 up to 262,143, 3 above."""
        d = k6_depth(n)
        assert d == 1 + (n >= 4096 * 8) + (n >= 4096 * 64)
        chunks = -(-n // 8 ** d)
        assert (n >> 3 * d) <= K6_SHARED_LEVEL and chunks <= K6_CLUSTER * K6_THREADS

    def test_compensated_scan_schedule_reads_the_lane_ends(self):
        """The kernel adds the lanes' last column itself: a change
        anywhere else in the lanes does not reach the scan."""
        wh, wl = random_lanes(1000)
        other_h, other_l = wh.copy(), wl.copy()
        other_h[:, :-1], other_l[:, :-1] = 7.0, -3.0
        for a, b in zip(emulate_compensated_scan(wh, wl), emulate_compensated_scan(other_h, other_l)):
            assert_bits_equal(a, b)


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
            th, tl = tsp._compensated_cumsum(t(x))
            assert_bits_equal(th, jh)
            assert_bits_equal(tl, jl)

    @pytest.mark.parametrize("n", [1, 2, 3, 9, 1024, 8057, 32769])
    def test_block_total_scan_adversarial_lanes(self, n):
        """The entry point against the reference's composition, the
        totals' add included."""
        for wh, wl in adversarial_lanes(n, denormals=False):
            jh, jl = j_block_total_scan(jnp.asarray(wh), jnp.asarray(wl))
            th, tl = tsp.block_total_scan(t(wh), t(wl))
            assert_bits_equal(th, jh)
            assert_bits_equal(tl, jl)
            eh, el = emulate_compensated_scan(wh, wl)
            assert_bits_equal(eh, jh)
            assert_bits_equal(el, jl)


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

    @pytest.mark.parametrize("shape", [(0, 2048), (1, 1), (7, 3), (8057, 2), (3, 2048)])
    def test_block_total_scan_takes_plain_route_on_cpu_without_counting(self, shape):
        rng = np.random.default_rng(sum(shape))
        wh, wl = (t(rng.standard_normal(shape).astype(F32)) for _ in range(2))
        before = tsp.block_total_scan.launches
        hi, lo = tsp.block_total_scan(wh, wl)
        assert tsp.block_total_scan.launches == before == 0
        ph, pl = tsp._compensated_cumsum(wh[:, -1] + wl[:, -1])
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
        "wh, wl, exc",
        [
            (torch.zeros(16), torch.zeros(16), ValueError),
            (torch.zeros(4, 4), torch.zeros(16), ValueError),
            (torch.zeros(4, 4, dtype=torch.float64), torch.zeros(4, 4), TypeError),
            (torch.zeros(4, 4), torch.zeros(4, 4, dtype=torch.float16), TypeError),
            (torch.zeros(4, 8)[:, ::2], torch.zeros(4, 4), ValueError),
            (torch.zeros(4, 4), torch.zeros(4, 8)[:, ::2], ValueError),
            (torch.zeros(4, 4), torch.zeros(4, 5), ValueError),
            (torch.zeros(4, 4), torch.zeros(5, 4), ValueError),
            (torch.zeros(4, 0), torch.zeros(4, 0), ValueError),
            (torch.zeros(4, 4), torch.zeros(4, 4, device="meta"), ValueError),
            (torch.zeros(4, 4, device="meta"), torch.zeros(4, 4, device="meta"), ValueError),
        ],
        ids=["rank", "wl-rank", "wh-dtype", "wl-dtype", "wh-non-contiguous",
             "wl-non-contiguous", "widths-differ", "rows-differ", "zero-width",
             "mixed-device", "meta-device"],
    )
    def test_block_total_scan_rejects_bad_operands(self, wh, wl, exc):
        with pytest.raises(exc):
            tsp.block_total_scan(wh, wl)

    def test_meta_tensors_raise_instead_of_falling_back(self):
        with pytest.raises(ValueError, match="cpu or cuda"):
            tsp.ds_cumsum_axis1(torch.zeros(2, 1024, device="meta"))
        with pytest.raises(ValueError, match="cpu or cuda"):
            tsp.block_total_scan(torch.zeros(16, 4, device="meta"), torch.zeros(16, 4, device="meta"))

    def test_kernel_widths_are_the_main_paths(self):
        assert tsp.DS_CUMSUM_WIDTHS == (tgw.ROW, tsp._ROWSUM_BLOCK) == (1024, 2048)


# ---------------------------------------------------------------------------
# The step's passes go through the wrappers
# ---------------------------------------------------------------------------


@pytest.fixture
def spied(monkeypatch):
    """Count the calls of both wrappers wherever the step looks them up."""
    calls = {"ds_cumsum_axis1": 0, "block_total_scan": 0}

    def spy(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    ds = spy("ds_cumsum_axis1", tsp.ds_cumsum_axis1)
    monkeypatch.setattr(tsp, "ds_cumsum_axis1", ds)
    scan = spy("block_total_scan", tsp.block_total_scan)
    monkeypatch.setattr(tsp, "block_total_scan", scan)
    return calls


class TestRoutedPasses:
    @pytest.mark.parametrize("e, n", [(5000, 300), (100_000, 4000), (2048, 1)])
    def test_rowsum_sorted(self, spied, e, n):
        rng = np.random.default_rng(e - n)
        contrib = rng.random(e).astype(F32)
        cuts = np.sort(rng.integers(0, e + 1, n - 1))
        row_ptr = np.concatenate([[0], cuts, [e]]).astype(np.int32)
        port = tsp.rowsum_sorted(t(contrib), t(row_ptr))
        assert spied == {"ds_cumsum_axis1": 1, "block_total_scan": 1}
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
        assert spied == {"ds_cumsum_axis1": 1, "block_total_scan": 1}
        assert_bits_equal(port, ref)
