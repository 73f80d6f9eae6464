"""K9: the CSR and COO steps' edge product folded into the block prefix.

``gather_ds_cumsum(w, t, src)`` (kernel ``csrc/gather_ds_cumsum.cu``)
computes, in one pass, what the reference computes in two jit'd XLA
passes: the product ``w * t[src]`` of ``power_step_csr``
(``protocol_tpu/ops/sparse.py:147``) and the Hillis-Steele double-single
prefix ``_ds_cumsum_axis1`` over ``rowsum_sorted``'s zero-padded
2048-blocks (``:121-122``).  The lanes are bit-identical to the JAX
composition, so the kernel must equal its plain version bit for bit.

The kernel runs only on a card, where ``chip_smoke.py`` holds it against
its plain version.  Here:

- the plain version ``_gather_ds_cumsum`` against the JAX composition,
  both lanes bit for bit on uint32 views (-0.0 differs from +0.0), at
  edge counts about a block's end, with out-of-range sources and
  negative-zero weights.  The composition clamps every source to the
  table, as the kernel does.  For a source at or past the table's end
  that is the reference's own ``t[src]``; a negative source is not
  (JAX wraps -1 to ``t[n - 1]``, the port clamps it to ``t[0]``), and
  ``TestSourcesOutOfRange`` records both against ``t[src]`` itself;
- denormal weights against a numpy float32 emulation and the earlier
  two-pass route only: XLA's CPU backend flushes denormals, PyTorch and
  the kernel keep them;
- the kernel's load schedule (four consecutive edges a thread, one
  vector load where all four lie below E, the straddling thread's
  elements one by one, +0.0 past E) in numpy, feeding K5's scan
  emulation, held bit-equal to the plain version; it reads and gathers
  each edge once and nothing at or past E;
- ``gathered_rowsum`` (the CSR step's ``Cᵀt``) against the reference's
  ``rowsum_sorted(w * t[src], row_ptr)``, bit for bit;
- the wrapper's CPU route, launch counter and argument checks, and the
  one aligned copy that the CSR and COO steps and converges take of a
  ``w`` or ``src`` off a 16-byte boundary (the kernel's loads are
  16-byte; the wrapper refuses such a slice on the card).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protocol_tpu.ops import sparse as jsp
from protocol_tpu_torch.ops import sparse as tsp
from test_torch_prefix import assert_bits_equal, emulate_ds_cumsum_rows

F32 = np.float32
BLOCK = 2048
#: Edge counts about a block's end, and a ragged last block after three.
EDGE_COUNTS = [1, 2047, 2048, 2049, 3 * BLOCK + 17]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


j_gather_multiply = jax.jit(lambda w, x, src: w * x[jnp.clip(src, 0, x.shape[0] - 1)])


j_take = jax.jit(lambda w, x, src: w * x[src])


@jax.jit
def j_ds_cumsum_blocks(c):
    rows = -(-c.shape[0] // BLOCK)
    return jsp._ds_cumsum_axis1(jnp.pad(c, (0, rows * BLOCK - c.shape[0])).reshape(rows, BLOCK))


def j_gather_ds_cumsum(w, x, src, product=j_gather_multiply):
    """The reference's composition: the clamped edge product (or
    ``product``), zero-padded into rows of 2048, then
    ``_ds_cumsum_axis1``.  Two programs, so each product is rounded to
    float32 as the kernel rounds it: in one jitted program XLA's CPU
    backend may contract a product into the scan's first add (a fused
    multiply-add, one rounding), which it does where no padding
    separates them (E a multiple of 2048)."""
    return j_ds_cumsum_blocks(product(w, x, src))


j_rowsum = jax.jit(jsp.rowsum_sorted)


def edge_operands(e: int, n: int, seed: int, *, clamped: bool = False, denormals: bool = False):
    """Random ``(w, x, src)``: negative-zero weights planted; with
    ``clamped``, sources -1, n and n + 5 planted at both ends and in the
    middle; with ``denormals``, denormal weights beside normal ones."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(e).astype(F32)
    x = rng.standard_normal(n).astype(F32)
    src = rng.integers(0, n, e).astype(np.int32)
    w[::7] = -0.0
    if clamped:
        for i, bad in zip((0, e // 2, e - 1), (-1, n, n + 5)):
            src[i] = bad
    if denormals:
        w[1::3] = np.float32(1e-40) * rng.choice([-1, 1], w[1::3].shape).astype(F32)
        w[2::5] = np.float32(1e-39)
    return w, x, src


def emulate_gather_ds_cumsum(w, x, src, reads=None):
    """``gather_ds_cumsum.cu`` as it runs, in numpy float32: thread ``a``
    of the grid holds edges 4a .. 4a + 3; it loads them as one vector
    where all four lie below E, else one by one below E; it gathers
    ``x[clamp(src, 0, n - 1)]`` for each edge below E and multiplies;
    every slot at or past E is +0.0.  Then K5's row scan.  ``reads``, a
    list, receives every edge index loaded and gathered."""
    e, n = w.shape[0], x.shape[0]
    rows = -(-e // BLOCK)
    h = np.zeros(rows * BLOCK, F32)
    for a in range(rows * BLOCK // 4):
        first = 4 * a
        ks = range(4) if first + 4 <= e else [k for k in range(4) if first + k < e]
        for k in ks:
            i = first + k
            if reads is not None:
                reads.append(i)
            h[i] = w[i] * x[min(max(int(src[i]), 0), n - 1)]
    return emulate_ds_cumsum_rows(h.reshape(rows, BLOCK))


class TestAgainstJax:
    @pytest.mark.parametrize("clamped", [False, True], ids=["in-range", "clamped"])
    @pytest.mark.parametrize("e", EDGE_COUNTS)
    def test_plain_matches_jax_composition_bits(self, e, clamped):
        w, x, src = edge_operands(e, 300, seed=e, clamped=clamped and e >= 3)
        port = tsp._gather_ds_cumsum(t(w), t(x), t(src))
        ref = j_gather_ds_cumsum(w, x, src)
        assert port[0].shape == (-(-e // BLOCK), BLOCK)
        for p, r in zip(port, ref):
            assert_bits_equal(p, r)

    @pytest.mark.parametrize("e, n", [(5000, 300), (3 * BLOCK + 17, 1000), (2048, 1)])
    def test_gathered_rowsum_matches_reference_rowsum(self, e, n):
        """The CSR step's ``Cᵀt``: the reference's ``rowsum_sorted`` of
        the edge products, bit for bit."""
        w, x, src = edge_operands(e, n, seed=n)
        cuts = np.sort(np.random.default_rng(e).integers(0, e + 1, n - 1))
        row_ptr = np.concatenate([[0], cuts, [e]]).astype(np.int32)
        port = tsp.gathered_rowsum(t(w), t(x), t(src), t(row_ptr))
        assert_bits_equal(port, j_rowsum(jnp.asarray(w * x[src]), jnp.asarray(row_ptr)))


class TestDenormals:
    @pytest.mark.parametrize("e", EDGE_COUNTS)
    def test_denormal_weights_survive(self, e):
        """Denormal weights and products, against numpy float32 (the
        kernel's schedule) and the earlier route: the edge product, then
        K5's plain prefix of the padded copy."""
        w, x, src = edge_operands(e, 300, seed=e + 2, clamped=e >= 3, denormals=True)
        port = tsp._gather_ds_cumsum(t(w), t(x), t(src))
        earlier = tsp._ds_cumsum_blocks(tsp._gather_multiply(t(w), t(x), t(src)), BLOCK)
        for p, q, r in zip(port, earlier, emulate_gather_ds_cumsum(w, x, src)):
            assert_bits_equal(p, r)
            assert_bits_equal(q, r)
        if e > 1:
            assert np.any((np.abs(port[0].numpy()) < np.finfo(F32).tiny) & (port[0].numpy() != 0))


class TestKernelSchedule:
    @pytest.mark.parametrize("e", EDGE_COUNTS)
    def test_schedule_matches_plain(self, e):
        w, x, src = edge_operands(e, 500, seed=e + BLOCK, clamped=e >= 3, denormals=True)
        for p, r in zip(tsp._gather_ds_cumsum(t(w), t(x), t(src)),
                        emulate_gather_ds_cumsum(w, x, src)):
            assert_bits_equal(p, r)

    @pytest.mark.parametrize("e", EDGE_COUNTS)
    def test_schedule_reads_each_edge_once_and_nothing_past_e(self, e):
        w, x, src = edge_operands(e, 10, seed=e, clamped=e >= 3)
        reads: list[int] = []
        emulate_gather_ds_cumsum(w, x, src, reads=reads)
        assert sorted(reads) == list(range(e))

    def test_padding_is_positive_zero(self):
        """The slots past E are +0.0, not the product of a gathered value
        (a -0.0 weight there would otherwise leave its sign)."""
        w = np.full(5, -0.0, F32)
        x = np.full(3, 2.0, F32)
        hi, lo = tsp._gather_ds_cumsum(t(w), t(x), t(np.zeros(5, np.int32)))
        bits = hi.numpy().view(np.uint32)
        assert np.all(bits[0, 5:] == 0) and np.all(lo.numpy().view(np.uint32) == 0)


class TestWrapper:
    @pytest.mark.parametrize("e", [0, 1, 2049])
    def test_takes_plain_route_on_cpu_without_counting(self, e):
        w, x, src = map(t, edge_operands(e, 40, seed=e))
        before = tsp.gather_ds_cumsum.launches
        out = tsp.gather_ds_cumsum(w, x, src)
        assert tsp.gather_ds_cumsum.launches == before
        assert tuple(out[0].shape) == (-(-e // BLOCK), BLOCK)
        for p, r in zip(out, tsp._gather_ds_cumsum(w, x, src)):
            assert_bits_equal(p, r)

    @pytest.mark.parametrize(
        "mutate, exc",
        [
            (lambda a: dict(a, w=a["w"].double()), TypeError),
            (lambda a: dict(a, x=a["x"].half()), TypeError),
            (lambda a: dict(a, src=a["src"].long()), TypeError),
            (lambda a: dict(a, src=a["src"][:-1]), ValueError),
            (lambda a: dict(a, src=a["src"].reshape(2, 4)), ValueError),
            (lambda a: dict(a, x=a["x"].reshape(2, 2)), ValueError),
            (lambda a: dict(a, x=a["x"][:0]), ValueError),
            (lambda a: dict(a, x=a["x"].to("meta")), ValueError),
        ],
        ids=["w-dtype", "t-dtype", "src-dtype", "src-shape", "src-2d", "t-2d", "empty-table",
             "mixed-device"],
    )
    def test_rejects_bad_operands(self, mutate, exc):
        a = mutate(dict(w=torch.zeros(8), x=torch.zeros(4), src=torch.zeros(8, dtype=torch.int32)))
        with pytest.raises(exc):
            tsp.gather_ds_cumsum(a["w"], a["x"], a["src"])

    def test_no_edges_need_no_table(self):
        hi, lo = tsp.gather_ds_cumsum(torch.zeros(0), torch.zeros(0),
                                      torch.zeros(0, dtype=torch.int32))
        assert hi.shape == lo.shape == (0, BLOCK)

    def test_meta_tensors_raise_instead_of_falling_back(self):
        meta = dict(device="meta")
        with pytest.raises(ValueError, match="cpu or cuda"):
            tsp.gather_ds_cumsum(torch.zeros(8, **meta), torch.zeros(4, **meta),
                                 torch.zeros(8, dtype=torch.int32, **meta))


class TestSourcesOutOfRange:
    """The port clamps every source to the table; the reference's
    ``w * t[src]`` clamps a source past the end but wraps a negative one
    first.  Both recorded against the reference's own ``t[src]``."""

    @pytest.mark.parametrize("e", EDGE_COUNTS)
    def test_sources_past_the_end_match_reference_take(self, e):
        w, x, src = edge_operands(e, 300, seed=e + 3)
        src[:: max(1, e // 3)] = 300
        src[-1] = 305
        port = tsp._gather_ds_cumsum(t(w), t(x), t(src))
        for p, r in zip(port, j_gather_ds_cumsum(w, x, src, product=j_take)):
            assert_bits_equal(p, r)

    @pytest.mark.parametrize("bad", [-1, -2, -300, -301])
    def test_negative_sources_differ_from_reference_take(self, bad):
        """-n <= src < 0: JAX reads ``t[n + src]``, the port ``t[0]``
        (the same slot only at -n); src < -n: both ``t[0]``."""
        w, x, src = edge_operands(5, 300, seed=4)
        w[:] = 1.0
        src[2] = bad
        port = tsp._gather_multiply(t(w), t(x), t(src)).numpy()
        ref = np.asarray(j_take(w, x, src))
        assert_bits_equal(port[2], x[0])
        assert_bits_equal(ref[2], x[bad % 300] if bad >= -300 else x[0])
        assert_bits_equal(np.delete(port, 2), np.delete(ref, 2))


def csr_operands(e: int, n: int, seed: int):
    """A dst-sorted edge list ``(src, dst, w, row_ptr)`` and the step's
    vectors ``(t, p, dangling)``, as numpy arrays."""
    w, x, src = edge_operands(e, n, seed)
    w = np.abs(w)
    dst = np.sort(np.random.default_rng(seed + 1).integers(0, n, e)).astype(np.int32)
    row_ptr = np.searchsorted(dst, np.arange(n + 1)).astype(np.int32)
    t0 = np.abs(x) / np.abs(x).sum()
    dangling = (np.arange(n) % 5 == 0).astype(F32)
    return src, dst, w, row_ptr, t0.astype(F32), np.full(n, 1.0 / n, F32), dangling


def off_boundary(a: np.ndarray) -> torch.Tensor:
    """``a`` as a slice one element past a 16-byte boundary."""
    padded = torch.from_numpy(np.concatenate([a[:1], a]))
    assert padded.data_ptr() % 16 == 0
    return padded[1:]


class TestAlignedCopies:
    """``gather_ds_cumsum`` loads ``w`` and ``src`` 16 bytes at a time and
    refuses a slice off that boundary on the card; the steps and the
    converges take one aligned copy of such a slice first."""

    @pytest.mark.parametrize("offset", [0, 1, 2, 3, 4])
    def test_aligned_copies_only_off_the_boundary(self, offset):
        base = torch.arange(16, dtype=torch.float32)
        x = base[offset:]
        y = tsp._aligned(x)
        assert y.data_ptr() % 16 == 0
        assert (y is x) == (offset % 4 == 0)
        assert_bits_equal(y, x)

    @pytest.mark.parametrize("entry", ["power_step_csr", "power_step_coo", "converge_csr",
                                       "converge_sparse"])
    def test_slices_off_the_boundary_give_the_aligned_result(self, monkeypatch, entry):
        src, dst, w, row_ptr, t0, p, dangling = csr_operands(5000, 300, seed=11)
        seen, copies = [], []
        kernel, aligned_copy = tsp.gather_ds_cumsum, tsp._aligned

        def spy(w_, t_, src_):
            seen.append((w_.data_ptr(), src_.data_ptr()))
            return kernel(w_, t_, src_)

        def counted_copy(x):
            y = aligned_copy(x)
            if y is not x:
                copies.append(x.dtype)
            return y

        def run(w_, src_):
            vec = (t(t0), t(p), t(dangling))
            if entry == "power_step_csr":
                return tsp.power_step_csr(src_, t(row_ptr), w_, *vec, torch.tensor(0.1))
            if entry == "power_step_coo":
                return tsp.power_step_coo(src_, t(dst), w_, *vec, 0.1, n=300)
            fn, kw = ((tsp.converge_csr, dict()) if entry == "converge_csr"
                      else (tsp.converge_sparse, dict(n=300)))
            lead = (src_, t(row_ptr)) if entry == "converge_csr" else (src_, t(dst))
            return fn(*lead, w_, *vec, tol=0.0, max_iter=4, **kw)[0]

        aligned = run(t(w), t(src))
        monkeypatch.setattr(tsp, "gather_ds_cumsum", spy)
        monkeypatch.setattr(tsp, "_aligned", counted_copy)
        sliced = run(off_boundary(w), off_boundary(src))
        assert len(seen) == (1 if entry.startswith("power_step") else 4)
        assert all(wp % 16 == 0 and sp % 16 == 0 for wp, sp in seen)
        # One copy each of w and src a call, a converge's before its loop.
        assert sorted(map(str, copies)) == ["torch.float32", "torch.int32"]
        assert_bits_equal(sliced, aligned)
