"""Device-step parity of the PyTorch port against the JAX package.

Every pass up to Cᵀt repeats the reference's arithmetic op for op, so
each is held **bit-identical** (``np.array_equal``) to its JAX
counterpart on the same numpy inputs: the windowed gather's plain
version against the Pallas kernel in interpret mode, the double-single
prefix, the compensated scan, ``rowsum_sorted``, ``bridge_partials`` and
``windowed_ct``, and the CSR and COO steps' edge product ``w * t[src]``
(K9's plain version, on uint32 views, so -0.0 differs from +0.0).  The
damping epilogue sums in another order, so the CSR step is held to a
float32 tolerance instead (the whole windowed step is held through the
converge, tests/test_torch_converge.py).  The COO step is the CSR step
over the edges' dst segments: it is held to the reference's CSR step on
those segments at the same tolerance, and to the reference's COO step,
whose ``segment_sum`` sums in float32 where the port sums in
double-single, at the cross-backend tolerance (rtol 1e-3, atol 1e-8).

The CUDA kernels themselves (K1 ``gather_windowed``, K9
``gather_multiply``) run only on a card; ``chip_smoke.py`` holds them
against their plain versions there.  Here the wrappers' CPU route, their
launch counters and their argument checks are covered.
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


# The reference runs these passes under jit (its converge loop is one
# jitted program); jitting here also spares per-op eager dispatch.
j_ds_cumsum = jax.jit(jsp._ds_cumsum_axis1)
j_compensated = jax.jit(jsp._compensated_cumsum)
j_rowsum = jax.jit(jsp.rowsum_sorted)
j_bridge = jax.jit(jgw.bridge_partials)
j_windowed_ct = jax.jit(jgw.windowed_ct, static_argnames=("n_rows", "table_entries", "interpret"))
j_step_csr = jax.jit(jsp.power_step_csr)
j_gather_multiply = jax.jit(lambda w, x, src: w * x[src])
j_step_coo = jax.jit(jsp.power_step_coo, static_argnames=("n", "sorted_by_dst"))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def same(port, ref) -> None:
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


def same_bits(port, ref) -> None:
    """Equal float32 bit patterns: -0.0 differs from +0.0."""
    np.testing.assert_array_equal(
        np.asarray(port, np.float32).view(np.uint32), np.asarray(ref, np.float32).view(np.uint32)
    )


@pytest.fixture(scope="module")
def plan_case():
    """A normalized scale-free graph over three windows with a partial
    last one (n not a multiple of 1024), its plan, and a random score
    vector."""
    n, e = 2500, 30_000
    g = scale_free(n, e, seed=3).drop_self_edges()
    w, dangling = g.row_normalized()
    g = type(g)(g.n, g.src, g.dst, w, g.pre_trusted).sorted_by_dst()
    plan = jgw.build_window_plan(g.src, g.dst, g.weight, n=n)
    x = np.random.default_rng(n).random(n).astype(np.float32)
    x /= x.sum()
    return g, dangling, plan, x


def port_plan(plan) -> tgw.WindowPlan:
    """The same plan as the port's dataclass (the layouts are equal,
    tests/test_torch_window_plan.py)."""
    return tgw.WindowPlan.from_arrays(plan.to_arrays(core_only=False))


class TestGatherWindowed:
    def test_plain_matches_pallas_interpret(self, plan_case):
        _, _, plan, x = plan_case
        table = np.pad(x, (0, plan.table_entries - x.shape[0]))
        ref = jgw.gather_windowed(
            jnp.asarray(plan.wid), jnp.asarray(table), jnp.asarray(plan.local),
            jnp.asarray(plan.weight), n_rows=plan.n_rows, interpret=True,
        )
        port = tgw.gather_windowed_plain(t(plan.wid), t(table), t(plan.local), t(plan.weight))
        same(port, ref)

    def test_wrapper_takes_plain_route_on_cpu_without_counting(self, plan_case):
        _, _, plan, x = plan_case
        table = t(np.pad(x, (0, plan.table_entries - x.shape[0])))
        args = (t(plan.wid), table, t(plan.local), t(plan.weight))
        before = tgw.gather_windowed.launches
        out = tgw.gather_windowed(*args, n_rows=plan.n_rows)
        assert tgw.gather_windowed.launches == before
        assert torch.equal(out, tgw.gather_windowed_plain(*args))

    @pytest.mark.parametrize(
        "mutate, exc",
        [
            (lambda a: dict(a, n_rows=a["n_rows"] - 1), ValueError),
            (lambda a: dict(a, table=a["table"][:-1]), ValueError),
            (lambda a: dict(a, local=a["local"][:-8]), ValueError),
            (lambda a: dict(a, weight=a["weight"].double()), TypeError),
            (lambda a: dict(a, wid=a["wid"].long()), TypeError),
            (lambda a: dict(a, table=a["table"].to("meta")), ValueError),
        ],
        ids=["n_rows", "table-len", "local-shape", "weight-dtype", "wid-dtype", "mixed-device"],
    )
    def test_rejects_bad_operands(self, mutate, exc):
        n_rows = 64
        args = dict(
            wid=torch.zeros(n_rows, dtype=torch.int32),
            table=torch.zeros(2048),
            local=torch.zeros(n_rows * 8, 128, dtype=torch.int32),
            weight=torch.zeros(n_rows * 8, 128),
            n_rows=n_rows,
        )
        a = mutate(args)
        with pytest.raises(exc):
            tgw.gather_windowed(a["wid"], a["table"], a["local"], a["weight"], n_rows=a["n_rows"])

    def test_meta_tensors_raise_instead_of_falling_back(self):
        n_rows = 64
        meta = dict(device="meta")
        with pytest.raises(ValueError, match="cpu or cuda"):
            tgw.gather_windowed(
                torch.zeros(n_rows, dtype=torch.int32, **meta),
                torch.zeros(1024, **meta),
                torch.zeros(n_rows * 8, 128, dtype=torch.int32, **meta),
                torch.zeros(n_rows * 8, 128, **meta),
                n_rows=n_rows,
            )


class TestDoubleSingle:
    @pytest.mark.parametrize("shape", [(7, 1024), (5, 2048), (3, 100), (1, 1)])
    def test_ds_cumsum_axis1(self, shape):
        x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
        jh, jl = j_ds_cumsum(jnp.asarray(x))
        th, tl = tsp._ds_cumsum_axis1(t(x))
        same(th, jh)
        same(tl, jl)

    @pytest.mark.parametrize("n", [1, 2, 3, 17, 1000, 5001])
    def test_compensated_cumsum(self, n):
        x = np.random.default_rng(n).standard_normal(n).astype(np.float32) * 1e3
        jh, jl = j_compensated(jnp.asarray(x))
        th, tl = tsp._compensated_cumsum(t(x))
        same(th, jh)
        same(tl, jl)

    def test_ds_add(self):
        rng = np.random.default_rng(0)
        a = [rng.standard_normal(999).astype(np.float32) for _ in range(4)]
        for port, ref in zip(tsp._ds_add(*map(t, a)), jsp._ds_add(*map(jnp.asarray, a))):
            same(port, ref)

    @pytest.mark.parametrize("e, n", [(5000, 300), (4096, 1), (100_000, 4000), (1, 1)])
    def test_rowsum_sorted(self, e, n):
        rng = np.random.default_rng(e + n)
        contrib = rng.random(e).astype(np.float32)
        # Sorted pointers with empty rows and both ends pinned.
        cuts = np.sort(rng.integers(0, e + 1, n - 1))
        row_ptr = np.concatenate([[0], cuts, [e]]).astype(np.int32)
        same(
            tsp.rowsum_sorted(t(contrib), t(row_ptr)),
            j_rowsum(jnp.asarray(contrib), jnp.asarray(row_ptr)),
        )


class TestWindowedStep:
    def test_bridge_partials(self, plan_case):
        _, _, plan, _ = plan_case
        rng = np.random.default_rng(5)
        hi = rng.random(plan.n_rows * 1024).astype(np.float32)
        lo = (rng.standard_normal(plan.n_rows * 1024) * 1e-8).astype(np.float32)
        args = (hi, lo, plan.seg_end, plan.seg_first, plan.seg_perm)
        same(tgw.bridge_partials_plain(*map(t, args)), j_bridge(*map(jnp.asarray, args)))

    def test_windowed_ct(self, plan_case):
        _, _, plan, x = plan_case
        kw = dict(n_rows=plan.n_rows, table_entries=plan.table_entries)
        ref = j_windowed_ct(
            *plan.device_args(), jnp.asarray(x), interpret=True, **kw
        )
        args = port_plan(plan).device_args("cpu")
        run_ptr = tgw.row_run_ptr(args[3], args[4], plan.n_rows)
        port = tgw.windowed_ct(*args, t(x), run_ptr=run_ptr, **kw)
        same(port, ref)

    def test_power_step_csr(self, plan_case):
        g, dangling, _, x = plan_case
        p = np.full(g.n, 1.0 / g.n, np.float32)
        d = dangling.astype(np.float32)
        args = (g.src, g.row_ptr_by_dst(), g.weight, x, p, d)
        ref = j_step_csr(*map(jnp.asarray, args), np.float32(0.1))
        port = tsp.power_step_csr(*map(t, args), torch.tensor(0.1))
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-9)

    def test_device_args_dtypes_and_order(self, plan_case):
        _, _, plan, _ = plan_case
        args = port_plan(plan).device_args("cpu")
        assert [a.dtype for a in args] == [
            torch.int32, torch.int32, torch.float32, torch.int32, torch.bool,
            torch.int32, torch.int32,
        ]
        for a, k in zip(args, tgw.WindowPlan._CORE):
            same(a, getattr(plan, k))


def edge_operands(e: int, n: int, seed: int):
    """Random ``(w, x, src)`` for the edge product, with signed zeros
    planted on both sides (their products' signs must survive)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(e).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    w[::7] = -0.0
    x[::5] = 0.0
    return w, x, src


class TestGatherMultiply:
    @pytest.mark.parametrize("e, n", [(0, 5), (1, 1), (3, 7), (1021, 300), (30_001, 2500)])
    def test_plain_matches_reference_bits(self, e, n):
        w, x, src = edge_operands(e, n, seed=e + n)
        same_bits(tsp._gather_multiply(t(w), t(x), t(src)), j_gather_multiply(w, x, src))

    def test_wrapper_takes_plain_route_on_cpu_without_counting(self):
        w, x, src = map(t, edge_operands(5001, 400, seed=1))
        before = tsp.gather_multiply.launches
        out = tsp.gather_multiply(w, x, src)
        assert tsp.gather_multiply.launches == before
        same_bits(out, tsp._gather_multiply(w, x, src))
        # A slice at any element offset is taken as it is.
        same_bits(tsp.gather_multiply(w[1:], x, src[1:]), tsp._gather_multiply(w[1:], x, src[1:]))

    @pytest.mark.parametrize(
        "mutate, exc",
        [
            (lambda a: dict(a, w=a["w"].double()), TypeError),
            (lambda a: dict(a, x=a["x"].double()), TypeError),
            (lambda a: dict(a, src=a["src"].long()), TypeError),
            (lambda a: dict(a, src=a["src"][:-1]), ValueError),
            (lambda a: dict(a, w=a["w"].reshape(4, 2)), ValueError),
            (lambda a: dict(a, x=a["x"][:0]), ValueError),
            (lambda a: dict(a, x=a["x"].to("meta")), ValueError),
        ],
        ids=["w-dtype", "t-dtype", "src-dtype", "src-shape", "w-2d", "empty-table", "mixed-device"],
    )
    def test_rejects_bad_operands(self, mutate, exc):
        a = mutate(dict(w=torch.zeros(8), x=torch.zeros(4), src=torch.zeros(8, dtype=torch.int32)))
        with pytest.raises(exc):
            tsp.gather_multiply(a["w"], a["x"], a["src"])

    def test_meta_tensors_raise_instead_of_falling_back(self):
        meta = dict(device="meta")
        with pytest.raises(ValueError, match="cpu or cuda"):
            tsp.gather_multiply(
                torch.zeros(8, **meta), torch.zeros(4, **meta),
                torch.zeros(8, dtype=torch.int32, **meta),
            )


def coo_layout(g, layout: str, seed: int = 0):
    """``(src, dst, w, sorted_by_dst)`` of the dst-sorted graph ``g`` as
    given (``sorted``), shuffled (``unsorted``), or with zero-weight
    padding edges of random src and dst appended (``padded``; the
    reference's "pad edges with w=0", so the input claims an order it
    does not have)."""
    src, dst, w = g.src, g.dst, g.weight
    rng = np.random.default_rng(seed)
    if layout == "unsorted":
        order = rng.permutation(g.nnz)
        return src[order], dst[order], w[order], False
    if layout == "padded":
        pad = 37
        src = np.concatenate([src, rng.integers(0, g.n, pad).astype(np.int32)])
        dst = np.concatenate([dst, rng.integers(0, g.n, pad).astype(np.int32)])
        w = np.concatenate([w, np.zeros(pad, np.float32)])
    return src, dst, w, True


LAYOUTS = ["sorted", "unsorted", "padded"]


class TestCooStep:
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_power_step_coo(self, plan_case, layout):
        """The port's COO step is the CSR step over the dst segments: it
        meets the reference's CSR step on the same segments at the CSR
        step's tolerance, and the reference's COO step (a float32
        ``segment_sum``, where the port sums in double-single) at the
        cross-backend tolerance, rtol 1e-3 / atol 1e-8."""
        g, dangling, _, x = plan_case
        src, dst, w, is_sorted = coo_layout(g, layout)
        p = np.full(g.n, 1.0 / g.n, np.float32)
        d = dangling.astype(np.float32)
        port = tsp.power_step_coo(
            *map(t, (src, dst, w, x, p, d)), torch.tensor(0.1), n=g.n, sorted_by_dst=is_sorted
        ).numpy()
        segments = tsp.dst_segments(t(src), t(dst), t(w), n=g.n, sorted_by_dst=is_sorted)
        s_src, s_w, row_ptr = (a.numpy() for a in segments)
        csr = j_step_csr(*map(jnp.asarray, (s_src, row_ptr, s_w, x, p, d)), np.float32(0.1))
        np.testing.assert_allclose(port, np.asarray(csr), rtol=1e-5, atol=1e-9)
        coo = j_step_coo(
            *map(jnp.asarray, (src, dst, w, x, p, d)), np.float32(0.1),
            n=g.n, sorted_by_dst=is_sorted,
        )
        np.testing.assert_allclose(port, np.asarray(coo), rtol=1e-3, atol=1e-8)

    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_dst_segments_keep_every_edge_in_its_segment(self, plan_case, layout):
        """The edges come out in the stable dst order
        (``TrustGraph.sorted_by_dst``'s), and each segment holds exactly
        the real edges of its dst (the padding adds only zero weights),
        so a misordered input never moves a real edge to another
        segment."""
        g, *_ = plan_case
        src, dst, w, is_sorted = coo_layout(g, layout)
        s_src, s_w, row_ptr = tsp.dst_segments(t(src), t(dst), t(w), n=g.n, sorted_by_dst=is_sorted)
        order = np.argsort(dst, kind="stable")
        same(s_src, src[order])
        same(s_w, w[order])
        assert row_ptr.dtype == torch.int32
        same(row_ptr, np.searchsorted(dst[order], np.arange(g.n + 1)))
        seg = np.repeat(np.arange(g.n), np.diff(row_ptr.numpy()))
        real = s_w.numpy() != 0
        got = sorted(zip(seg[real], s_src.numpy()[real], s_w.numpy()[real]))
        want = sorted(zip(g.dst[g.weight != 0], g.src[g.weight != 0], g.weight[g.weight != 0]))
        assert got == want

    def test_dst_segments_sorted_input_is_not_moved(self, plan_case):
        g, *_ = plan_case
        src, dst, w = t(g.src), t(g.dst), t(g.weight)
        s_src, s_w, row_ptr = tsp.dst_segments(src, dst, w, n=g.n)
        assert s_src is src and s_w is w
        same(row_ptr, g.row_ptr_by_dst())

    def test_dst_outside_the_segments_is_dropped(self):
        """``segment_sum`` drops a dst outside ``[0, n)``; so does the COO step."""
        n = 4
        src = np.array([0, 1, 2, 3, 0], np.int32)
        dst = np.array([-1, 0, 1, 3, 4], np.int32)
        w = np.array([0.5, 1.0, 1.0, 1.0, 0.5], np.float32)
        x = np.full(n, 0.25, np.float32)
        d = np.zeros(n, np.float32)
        ref = j_step_coo(*map(jnp.asarray, (src, dst, w, x, x, d)), np.float32(0.0), n=n,
                         sorted_by_dst=False)
        port = tsp.power_step_coo(*map(t, (src, dst, w, x, x, d)), 0.0, n=n, sorted_by_dst=False)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6)
