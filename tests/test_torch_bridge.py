"""The windowed step's bridge and ``rowsum_sorted``'s pointer tail, and
their CUDA kernels.

``bridge_partials`` (kernel ``csrc/bridge_partials.cu``) replaces the
reference's jit'd ``bridge_partials`` (``protocol_tpu/ops/gather_window.py``)
and ``rowsum_tail`` (kernel ``csrc/rowsum_tail.cu``) the tail of its
``rowsum_sorted`` (``protocol_tpu/ops/sparse.py``).  Both are
bit-identical to the JAX package, so the kernels must equal their plain
versions bit for bit, signed zeros included.  ``ds_cumsum_axis1`` also
takes ``rowsum_sorted``'s contributions unpadded now (its kernel reads
the padding as +0.0).

The kernels run only on a card, where ``chip_smoke.py`` holds them
against their plain versions.  Here:

- each kernel's schedule is written out as a numpy float32 emulation
  (K7: one thread a run, the previous run's end from the neighbouring
  lane or, in lane 0, read again; K8: one thread a pointer, the C
  integer division and the ``blk - 1`` exclusive prefix, the next
  pointer's prefix from the next lane or, in lane 31, computed again)
  and held bit-equal to the plain version, denormal lanes included;
- the plain versions are held bit-equal to JAX on real plans and on
  adversarial lanes, tables and pointers (signed zeros, exact
  cancellations, a leading run not flagged, every run flagged, one run,
  odd lengths, empty rows); denormal lanes are held against the plain
  versions only, since XLA's CPU backend flushes denormals;
- the wrappers' CPU route, launch counters and argument checks;
- the step's passes go through the wrappers, once each.

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

j_bridge = jax.jit(jgw.bridge_partials)
j_rowsum = jax.jit(jsp.rowsum_sorted)

F32 = np.float32
B = tsp._ROWSUM_BLOCK
WARP = 32


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


def emulate_bridge(hi, lo, seg_end, seg_first, seg_perm):
    """``bridge_partials.cu`` as it runs: thread s reads its run end's
    lanes; the previous run's end comes from lane s-1 of the same warp
    by the shuffle, except in lane 0, which reads ``seg_end[s-1]`` and
    its lanes itself; +0.0 where s == 0 or the run is flagged.  Then the
    permutation gather out of the ``partial`` scratch."""
    s = np.arange(seg_end.shape[0])
    eh, el = hi[seg_end], lo[seg_end]
    lane = s % WARP
    ph, pl = np.empty_like(eh), np.empty_like(el)
    ph[1:], pl[1:] = eh[:-1], el[:-1]  # the shuffle, for lanes 1..31
    lead = lane == 0
    ph[lead], pl[lead] = eh[lead], el[lead]  # what the shuffle leaves lane 0
    lead &= s > 0
    ph[lead], pl[lead] = hi[seg_end[s[lead] - 1]], lo[seg_end[s[lead] - 1]]
    zero = (s == 0) | seg_first
    ph[zero], pl[zero] = F32(0.0), F32(0.0)
    partial = (eh - ph) + (el - pl)
    return partial[seg_perm]


def emulate_rowsum_tail(wh, wl, hi_in, lo_in, row_ptr):
    """``rowsum_tail.cu`` as it runs: thread j computes the prefix before
    pointer j with C's truncating division (i >= 0 there), ``min`` for
    the clamp and ``hi_in[blk - 1]`` (+0.0 for block 0) for the exclusive
    block prefix; the prefix at pointer j + 1 comes from the next lane,
    or lane 31 computes it again."""
    n_blocks, b = wh.shape

    def prefix(ptr):
        i = ptr.astype(np.int64) - 1
        live = i >= 0
        i = np.where(live, i, 0)
        blk = np.minimum(i // b, n_blocks - 1)
        at = blk * b + i % b
        h = np.where(blk > 0, hi_in[np.maximum(blk - 1, 0)], F32(0.0)).astype(F32)
        l = np.where(blk > 0, lo_in[np.maximum(blk - 1, 0)], F32(0.0)).astype(F32)
        h, l = np_ds_add(h, l, wh.reshape(-1)[at], wl.reshape(-1)[at])
        return np.where(live, h, F32(0.0)), np.where(live, l, F32(0.0))

    n = row_ptr.shape[0] - 1
    ph, pl = prefix(row_ptr)
    j = np.arange(n)
    qh, ql = ph[1:].copy(), pl[1:].copy()  # the shuffle
    last = j % WARP == WARP - 1
    qh[last], ql[last] = prefix(row_ptr[j[last] + 1])
    return (qh - ph[:-1]) + (ql - pl[:-1])


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def adversarial_values(n: int, kind: str, seed: int = 0) -> np.ndarray:
    """``n`` float32 values: all -0.0, signed zeros, ±1e30 beside 1e-30,
    exact cancellations (x, -x), runs of 8 equal values (equal
    neighbouring run ends), mixed magnitudes, random, or denormals."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    if kind == "neg_zero":
        v = np.full(n, -0.0)
    elif kind == "signed_zero":
        v = np.where(i % 3 == 0, -0.0, 0.0)
    elif kind == "big":
        v = np.where(i % 4 == 0, 1e30, np.where(i % 4 == 2, -1e30, 1e-30))
    elif kind == "cancel":
        x = rng.standard_normal(n)
        v = np.where(i % 2 == 0, x, -np.roll(x, 1))
    elif kind == "flat":
        v = np.repeat(rng.standard_normal(n // 8 + 1), 8)[:n]
    elif kind == "mixed":
        v = rng.standard_normal(n) * 10.0 ** rng.integers(-30, 30, n)
    elif kind == "random":
        v = rng.random(n)
    elif kind == "denormal":
        v = rng.integers(-3, 4, n) * np.float32(1e-40)
    else:
        raise ValueError(kind)
    return v.astype(F32)


LANE_KINDS = ["neg_zero", "signed_zero", "big", "cancel", "flat", "mixed", "random"]


def synthetic_tables(slots: int, runs: int, seed: int, flags: str = "random"):
    """Run tables like a plan's: strictly increasing ``seg_end`` below
    ``slots``, ``seg_first`` (random, all set, or random with run 0
    unset) and a permutation ``seg_perm``."""
    rng = np.random.default_rng(seed)
    seg_end = np.sort(rng.choice(slots, runs, replace=False)).astype(np.int32)
    if flags == "all":
        seg_first = np.ones(runs, bool)
    else:
        seg_first = rng.random(runs) < 0.2
        if flags == "lead_unset":
            seg_first[0] = False
    seg_perm = rng.permutation(runs).astype(np.int32)
    return seg_end, seg_first, seg_perm


@pytest.fixture(scope="module")
def plan():
    """A real plan over three windows with a partial last one."""
    g = scale_free(3000, 40_000, seed=13).drop_self_edges()
    w, _ = g.row_normalized()
    g = type(g)(g.n, g.src, g.dst, w, g.pre_trusted).sorted_by_dst()
    return jgw.build_window_plan(g.src, g.dst, g.weight, n=g.n)


def pointers(e: int, n: int, seed: int, kind: str = "random") -> np.ndarray:
    """Sorted int32 row pointers over ``e`` contributions, ``row_ptr[0]
    == 0`` and ``row_ptr[n] == e``: random cuts (with empty rows where
    cuts repeat), every row empty but the last, or cuts on and beside
    the block boundaries."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        cuts = np.sort(rng.integers(0, e + 1, n - 1))
    elif kind == "empty_rows":
        cuts = np.zeros(n - 1, np.int64)
    elif kind == "block_edges":
        edges = np.arange(0, e + 1, B)
        cuts = np.sort(np.clip(np.concatenate([edges - 1, edges, edges + 1]), 0, e))[: n - 1]
        cuts = np.sort(np.concatenate([cuts, rng.integers(0, e + 1, n - 1 - cuts.shape[0])]))
    else:
        raise ValueError(kind)
    return np.concatenate([[0], cuts, [e]]).astype(np.int32)


def plain_blocks(contrib: np.ndarray):
    """The block-local prefix lanes and the block-total scan that feed
    ``rowsum_sorted``'s tail, through the port's plain versions."""
    wh, wl = tsp._ds_cumsum_blocks(t(contrib), B)
    hi_in, lo_in = tsp._compensated_cumsum(wh[:, -1] + wl[:, -1])
    return wh, wl, hi_in, lo_in


# ---------------------------------------------------------------------------
# The schedules against the plain versions
# ---------------------------------------------------------------------------


class TestKernelSchedules:
    @pytest.mark.parametrize("kind", LANE_KINDS + ["denormal"])
    @pytest.mark.parametrize("runs, flags", [(1, "random"), (33, "all"), (1031, "lead_unset"),
                                             (4099, "random")])
    def test_bridge_schedule(self, kind, runs, flags):
        slots = 4 * runs + 7
        hi = adversarial_values(slots, kind, seed=runs)
        lo = adversarial_values(slots, kind, seed=runs + 1) * F32(1e-8)
        tables = synthetic_tables(slots, runs, seed=runs, flags=flags)
        port = tgw.bridge_partials_plain(t(hi), t(lo), *map(t, tables))
        assert_bits_equal(emulate_bridge(hi, lo, *tables), port)

    def test_bridge_schedule_on_a_real_plan(self, plan):
        rng = np.random.default_rng(1)
        hi = rng.random(plan.n_rows * 1024).astype(F32)
        lo = (rng.standard_normal(plan.n_rows * 1024) * 1e-8).astype(F32)
        tables = (plan.seg_end, plan.seg_first, plan.seg_perm)
        port = tgw.bridge_partials_plain(t(hi), t(lo), *map(t, tables))
        assert_bits_equal(emulate_bridge(hi, lo, *tables), port)

    @pytest.mark.parametrize("kind", LANE_KINDS + ["denormal"])
    @pytest.mark.parametrize("e, n, ptrs", [(1, 1, "random"), (2048, 5, "block_edges"),
                                            (5000, 300, "random"), (9000, 70, "empty_rows"),
                                            (20_000, 1000, "block_edges")])
    def test_rowsum_tail_schedule(self, kind, e, n, ptrs):
        lanes = plain_blocks(adversarial_values(e, kind, seed=e))
        row_ptr = pointers(e, n, seed=n, kind=ptrs)
        port = tsp._rowsum_tail(*lanes, t(row_ptr))
        assert_bits_equal(emulate_rowsum_tail(*(a.numpy() for a in lanes), row_ptr), port)

    def test_rowsum_tail_schedule_past_the_last_block(self):
        """Pointers at the block edges, at the end of an exactly full last
        block and past it, where the ``min(i / B, n_blocks - 1)`` clamp
        acts (as the reference's ``clip`` does)."""
        contrib = adversarial_values(2 * B, "random")
        lanes = plain_blocks(contrib)
        row_ptr = np.array([0, B - 1, B, B + 1, 2 * B, 2 * B + 5, 3 * B + 1], np.int32)
        port = tsp._rowsum_tail(*lanes, t(row_ptr))
        assert_bits_equal(emulate_rowsum_tail(*(a.numpy() for a in lanes), row_ptr), port)


# ---------------------------------------------------------------------------
# The plain versions against JAX, bit for bit
# ---------------------------------------------------------------------------


class TestAgainstJax:
    def test_bridge_on_a_real_plan(self, plan):
        rng = np.random.default_rng(2)
        hi = rng.random(plan.n_rows * 1024).astype(F32)
        lo = (rng.standard_normal(plan.n_rows * 1024) * 1e-8).astype(F32)
        args = (hi, lo, plan.seg_end, plan.seg_first, plan.seg_perm)
        assert_bits_equal(tgw.bridge_partials_plain(*map(t, args)), j_bridge(*args))

    @pytest.mark.parametrize("kind", LANE_KINDS)
    @pytest.mark.parametrize("runs, flags", [(1, "random"), (1, "lead_unset"), (33, "all"),
                                             (1031, "lead_unset"), (4099, "random")])
    def test_bridge_adversarial(self, kind, runs, flags):
        slots = 4 * runs + 7
        hi = adversarial_values(slots, kind, seed=runs)
        lo = adversarial_values(slots, kind, seed=runs + 1) * F32(1e-8)
        args = (hi, lo, *synthetic_tables(slots, runs, seed=runs, flags=flags))
        assert_bits_equal(tgw.bridge_partials(*map(t, args)), j_bridge(*args))

    @pytest.mark.parametrize("kind", LANE_KINDS)
    @pytest.mark.parametrize("e, n, ptrs", [(1, 1, "random"), (2048, 5, "block_edges"),
                                            (5000, 300, "random"), (9000, 70, "empty_rows"),
                                            (20_000, 1000, "block_edges")])
    def test_rowsum_sorted_adversarial(self, kind, e, n, ptrs):
        contrib = adversarial_values(e, kind, seed=e)
        row_ptr = pointers(e, n, seed=n, kind=ptrs)
        ref = j_rowsum(contrib, row_ptr)
        assert_bits_equal(tsp._rowsum_tail(*plain_blocks(contrib), t(row_ptr)), ref)
        assert_bits_equal(tsp.rowsum_sorted(t(contrib), t(row_ptr)), ref)
        assert_bits_equal(tsp.rowsum_sorted_plain(t(contrib), t(row_ptr)), ref)


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------


def bridge_operands(runs: int = 40, slots: int = 200) -> dict:
    rng = np.random.default_rng(runs)
    seg_end, seg_first, seg_perm = synthetic_tables(slots, runs, seed=runs)
    return dict(
        hi=t(rng.random(slots).astype(F32)), lo=t(rng.random(slots).astype(F32) * F32(1e-8)),
        seg_end=t(seg_end), seg_first=t(seg_first), seg_perm=t(seg_perm),
    )


def tail_operands(e: int = 5000, n: int = 300) -> dict:
    wh, wl, hi_in, lo_in = plain_blocks(adversarial_values(e, "random"))
    return dict(wh=wh, wl=wl, hi_in=hi_in, lo_in=lo_in, row_ptr=t(pointers(e, n, seed=n)))


class TestWrappers:
    def test_bridge_takes_plain_route_on_cpu_without_counting(self):
        a = bridge_operands()
        out = tgw.bridge_partials(**a)
        assert tgw.bridge_partials.launches == 0
        assert_bits_equal(out, tgw.bridge_partials_plain(**a))

    def test_rowsum_tail_takes_plain_route_on_cpu_without_counting(self):
        a = tail_operands()
        out = tsp.rowsum_tail(**a)
        assert tsp.rowsum_tail.launches == 0
        assert_bits_equal(out, tsp._rowsum_tail(**a))

    @pytest.mark.parametrize(
        "mutate, exc",
        [
            (lambda a: dict(a, hi=a["hi"].double()), TypeError),
            (lambda a: dict(a, seg_end=a["seg_end"].long()), TypeError),
            (lambda a: dict(a, seg_first=a["seg_first"].float()), TypeError),
            (lambda a: dict(a, seg_perm=a["seg_perm"].long()), TypeError),
            (lambda a: dict(a, lo=a["lo"][:-1]), ValueError),
            (lambda a: dict(a, seg_perm=a["seg_perm"][:-1]), ValueError),
            (lambda a: dict(a, seg_first=a["seg_first"][:-1]), ValueError),
            (lambda a: dict(a, hi=a["hi"].reshape(2, -1)), ValueError),
            (lambda a: dict(a, seg_end=a["seg_end"].to("meta")), ValueError),
            (lambda a: {k: v.to("meta") for k, v in a.items()}, ValueError),
        ],
        ids=["hi-dtype", "seg_end-int64", "seg_first-float", "seg_perm-int64", "lo-length",
             "seg_perm-length", "seg_first-length", "hi-rank", "mixed-device", "meta-device"],
    )
    def test_bridge_rejects_bad_operands(self, mutate, exc):
        with pytest.raises(exc):
            tgw.bridge_partials(**mutate(bridge_operands()))

    @pytest.mark.parametrize(
        "mutate, exc",
        [
            (lambda a: dict(a, row_ptr=a["row_ptr"].long()), TypeError),
            (lambda a: dict(a, wh=a["wh"].double()), TypeError),
            (lambda a: dict(a, lo_in=a["lo_in"].double()), TypeError),
            (lambda a: dict(a, wl=a["wl"][:-1]), ValueError),
            (lambda a: dict(a, hi_in=a["hi_in"][:-1]), ValueError),
            (lambda a: dict(a, wh=a["wh"].reshape(-1)), ValueError),
            (lambda a: dict(a, row_ptr=a["row_ptr"][:0]), ValueError),
            (lambda a: dict(a, row_ptr=a["row_ptr"].to("meta")), ValueError),
            (lambda a: {k: v.to("meta") for k, v in a.items()}, ValueError),
        ],
        ids=["row_ptr-int64", "wh-dtype", "lo_in-dtype", "wl-shape", "hi_in-length",
             "wh-rank", "row_ptr-empty", "mixed-device", "meta-device"],
    )
    def test_rowsum_tail_rejects_bad_operands(self, mutate, exc):
        with pytest.raises(exc):
            tsp.rowsum_tail(**mutate(tail_operands()))

    def test_meta_tensors_raise_instead_of_falling_back(self):
        meta = {k: v.to("meta") for k, v in bridge_operands().items()}
        with pytest.raises(ValueError, match="cpu or cuda"):
            tgw.bridge_partials(**meta)
        meta = {k: v.to("meta") for k, v in tail_operands().items()}
        with pytest.raises(ValueError, match="cpu or cuda"):
            tsp.rowsum_tail(**meta)

    @pytest.mark.parametrize("e", [0, 1, 2047, 2048, 2049, 10_001])
    def test_ds_cumsum_unpadded_form_is_the_padded_prefix(self, e):
        x = adversarial_values(e, "mixed", seed=e)
        hi, lo = tsp.ds_cumsum_axis1(t(x), B)
        assert tsp.ds_cumsum_axis1.launches == 0
        rows = -(-e // B)
        padded = np.zeros(rows * B, F32)
        padded[:e] = x
        ph, pl = tsp._ds_cumsum_axis1(t(padded.reshape(rows, B)))
        assert_bits_equal(hi, ph)
        assert_bits_equal(lo, pl)

    @pytest.mark.parametrize(
        "x, width",
        [(torch.zeros(2, 2048), 2048), (torch.zeros(16), 0), (torch.zeros(16), -2048)],
        ids=["2-D-with-width", "zero-width", "negative-width"],
    )
    def test_ds_cumsum_unpadded_form_rejects_bad_operands(self, x, width):
        with pytest.raises(ValueError):
            tsp.ds_cumsum_axis1(x, width)


# ---------------------------------------------------------------------------
# The step's passes go through the wrappers
# ---------------------------------------------------------------------------


@pytest.fixture
def spied(monkeypatch):
    """Count the calls of both wrappers wherever the steps look them up."""
    calls = {"bridge_partials": 0, "rowsum_tail": 0}

    def spy(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(tgw, "bridge_partials", spy("bridge_partials", tgw.bridge_partials))
    monkeypatch.setattr(tsp, "rowsum_tail", spy("rowsum_tail", tsp.rowsum_tail))
    return calls


class TestRoutedPasses:
    def test_windowed_ct_calls_each_wrapper_once(self, spied, plan):
        x = np.random.default_rng(4).random(plan.n).astype(F32)
        x /= x.sum()
        port_plan = tgw.WindowPlan.from_arrays(plan.to_arrays(core_only=False))
        tgw.windowed_ct(
            *port_plan.device_args("cpu"), t(x),
            n_rows=plan.n_rows, table_entries=plan.table_entries,
        )
        assert spied == {"bridge_partials": 1, "rowsum_tail": 1}

    def test_power_step_csr_calls_the_tail_once(self, spied):
        g = scale_free(2000, 20_000, seed=5).drop_self_edges()
        w, dangling = g.row_normalized()
        g = type(g)(g.n, g.src, g.dst, w, g.pre_trusted).sorted_by_dst()
        p = np.full(g.n, 1.0 / g.n, F32)
        tsp.power_step_csr(
            t(g.src), t(g.row_ptr_by_dst()), t(g.weight), t(p), t(p),
            t(dangling.astype(F32)), torch.tensor(0.1),
        )
        assert spied == {"bridge_partials": 0, "rowsum_tail": 1}

    def test_plain_route_calls_no_wrapper(self, spied):
        e, n = 5000, 300
        tsp.rowsum_sorted_plain(t(adversarial_values(e, "random")), t(pointers(e, n, seed=n)))
        assert spied == {"bridge_partials": 0, "rowsum_tail": 0}
