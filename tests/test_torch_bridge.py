"""The windowed step's row prefix and bridge, ``rowsum_sorted``'s pointer
tail, and their CUDA kernels.

``prefix_bridge`` (kernel ``csrc/prefix_bridge.cu``) replaces two jit'd
passes of the reference, the row prefix ``_ds_cumsum_axis1``
(``protocol_tpu/ops/sparse.py``) and ``bridge_partials``
(``protocol_tpu/ops/gather_window.py``), as ``windowed_ct`` composes
them; ``rowsum_tail`` (kernel ``csrc/rowsum_tail.cu``) replaces the tail
of its ``rowsum_sorted``.  Both are bit-identical to the JAX package, so
the kernels must equal their plain versions bit for bit, signed zeros
included.  ``ds_cumsum_axis1`` also takes ``rowsum_sorted``'s
contributions unpadded (its kernel reads the padding as +0.0).

The kernels run only on a card, where ``chip_smoke.py`` holds them
against their plain versions.  Here:

- each kernel's schedule is written out as a numpy float32 emulation
  (K7: the row prefix by K5's schedule, the run epilogue from the row's
  prefix and the four-wide permutation with its scalar tail, with the
  kernel's index clamps; K8: a warp's tile of 32 x 4 pointers, four
  slots a lane, the C integer division and the ``blk - 1`` exclusive
  prefix, the next pointer's prefix from the next lane, for lane 31
  from lane 0's next slot or its own extra read) and held
  bit-equal to the plain version, denormal rows included; broken
  pointer tables stay in bounds with the clamps and go out of bounds
  without them;
- the plain versions are held bit-equal to JAX on real plans and on
  adversarial rows, tables and pointers (signed zeros, exact
  cancellations, rows without runs, 1024 singleton runs in a row, pad
  runs, every run flagged, run counts not a multiple of 4, a leading
  run not flagged, odd lengths, empty rows); denormals are held against
  the plain versions only, since XLA's CPU backend flushes them;
- ``row_run_ptr`` against ``np.searchsorted`` and its precondition;
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
from test_torch_prefix import emulate_ds_cumsum_rows

j_bridge = jax.jit(jgw.bridge_partials)
j_rowsum = jax.jit(jsp.rowsum_sorted)


@jax.jit
def j_prefix_bridge(slots, seg_end, seg_first, seg_perm):
    """The reference's composition in ``windowed_ct``: the row prefix,
    then the bridge on the flattened lanes."""
    hi, lo = jsp._ds_cumsum_axis1(slots)
    return jgw.bridge_partials(hi.reshape(-1), lo.reshape(-1), seg_end, seg_first, seg_perm)


F32 = np.float32
B = tsp._ROWSUM_BLOCK
WARP = 32
ROW = tgw.ROW


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


def emulate_prefix_bridge(slots, seg_end, seg_first, seg_perm, run_ptr, clamp=True):
    """``prefix_bridge.cu`` as it runs.  Launch 1, block r: the row's
    prefix by K5's schedule (``ds_scan_row`` of ``ds_scan.cuh``, which
    ``ds_cumsum_rows.cu`` runs too), then the runs ``run_ptr[r] :
    run_ptr[r + 1]`` (both clamped into [0, S]; none where they cross),
    each run's end and its predecessor's masked into the row and read
    from the row's final prefix.  Launch 2: the permutation, four outputs
    a thread and a scalar tail, each index clamped into [0, S) as an
    unsigned ``min``.  Every table read is checked in bounds (numpy would
    wrap a negative index); ``clamp=False`` drops both clamps."""
    n_runs = seg_end.shape[0]
    fh, fl = emulate_ds_cumsum_rows(np.asarray(slots, F32))

    def read(a, i):
        assert i.size == 0 or (i.min() >= 0 and i.max() < a.shape[0]), "out of bounds"
        return a[i]

    partial = np.full(n_runs, np.nan, F32)  # the scratch
    for r in range(slots.shape[0]):
        first, end = int(run_ptr[r]), int(run_ptr[r + 1])
        if clamp:
            first, end = min(max(first, 0), n_runs), min(max(end, 0), n_runs)
        s = np.arange(first, end)
        e = read(seg_end, s) & (ROW - 1)
        ph, pl = np.zeros(s.size, F32), np.zeros(s.size, F32)
        take = (s != 0) & ~read(seg_first, s)
        prev = read(seg_end, s[take] - 1) & (ROW - 1)
        ph[take], pl[take] = fh[r, prev], fl[r, prev]
        read(partial, s)
        partial[s] = (fh[r, e] - ph) + (fl[r, e] - pl)

    idx = seg_perm.astype(np.int64)
    if clamp:
        idx = np.minimum(idx & 0xFFFFFFFF, n_runs - 1)
    out = np.empty(n_runs, F32)
    vec = n_runs // 4 * 4
    out[:vec] = read(partial, idx[:vec].reshape(-1, 4)).reshape(-1)
    for j in range(vec, n_runs):
        out[j] = read(partial, idx[j : j + 1])[0]
    return out


#: Pointers a thread of ``rowsum_tail.cu``.
K8_PER = 4


def emulate_rowsum_tail(wh, wl, hi_in, lo_in, row_ptr, per=K8_PER, reads=None):
    """``rowsum_tail.cu`` as it runs: warp w takes the tile of 32 * per
    pointers from w * 32 * per, lane l slot i the pointer j = tile +
    32 i + l where j <= n; each prefix with C's truncating division
    (i >= 0 there), ``min`` for the clamp and ``hi_in[blk - 1]`` (+0.0
    for block 0) for the exclusive block prefix, +0.0 for an absent or
    ``i < 0`` pointer; lane 31 also reads the first pointer of the next
    tile.  Output j takes P(j + 1) from the next lane's slot i by one
    shuffle, lane 31 from lane 0's slot i + 1 or, in the last slot, from
    its own extra prefix.  ``reads``, a list, gets every pointer index
    read, one array per slot and the extra reads last."""
    n_blocks, b = wh.shape
    n = row_ptr.shape[0] - 1
    tile = 32 * per
    tiles = (n + tile) // tile
    lane = np.arange(32)

    def prefix(idx, have):
        """(hi, lo) before the pointers at ``idx`` where ``have``."""
        if reads is not None:
            reads.append(idx[have])
        assert not have.any() or (idx[have].min() >= 0 and idx[have].max() <= n), "out of bounds"
        i = np.where(have, row_ptr[np.where(have, idx, 0)].astype(np.int64) - 1, -1)
        live = i >= 0
        i = np.where(live, i, 0)
        blk = np.minimum(i // b, n_blocks - 1)
        at = blk * b + i % b
        h = np.where(blk > 0, hi_in[np.maximum(blk - 1, 0)], F32(0.0)).astype(F32)
        l = np.where(blk > 0, lo_in[np.maximum(blk - 1, 0)], F32(0.0)).astype(F32)
        h, l = np_ds_add(h, l, wh.reshape(-1)[at], wl.reshape(-1)[at])
        return np.where(live, h, F32(0.0)), np.where(live, l, F32(0.0))

    # Registers (tiles, 32) of slots 0 .. per - 1, then lane 31's extra slot.
    j0 = np.arange(tiles)[:, None] * tile + lane[None, :]
    slots = [prefix(j0 + 32 * i, j0 + 32 * i <= n) for i in range(per)]
    nxt = j0 + tile - 31
    slots.append(prefix(nxt, (lane[None, :] == 31) & (nxt <= n)))
    out = np.full(n, np.nan, F32)
    for i in range(per):
        ph, pl = slots[i]
        qh, ql = np.zeros_like(ph), np.zeros_like(pl)
        qh[:, :31], ql[:, :31] = ph[:, 1:], pl[:, 1:]  # the shuffle down by one
        src = slots[i + 1]
        qh[:, 31], ql[:, 31] = (src[0][:, 0], src[1][:, 0]) if i + 1 < per else (src[0][:, 31], src[1][:, 31])
        j = j0 + 32 * i
        keep = j < n
        out[j[keep]] = ((qh - ph) + (ql - pl))[keep]
    return out


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


#: Run layouts over the rows of ``run_tables``.
LAYOUTS = ["random", "singletons", "all_flagged", "sparse", "pad_tail"]
#: Plan rows of the synthetic tables.
ROWS = 6


def run_tables(layout: str, seed: int = 0, rows: int = ROWS):
    """Run tables over ``rows`` plan rows that meet ``prefix_bridge``'s
    precondition (every row's first run flagged): ``random`` (0-40 runs
    a row, some rows without runs, 10 % of the other runs flagged),
    ``singletons`` (row 1 all 1024 slots singleton runs), ``all_flagged``
    (every run flagged), ``sparse`` (one run ending at slot 1023 in row
    1, one ending at slot 0 in row 4, every other row empty) or
    ``pad_tail`` (random data rows, then flagged singleton pad runs at
    the topmost slots across the last row boundary, their count making
    S % 4 == 3, as ``_pad_segment_tables`` lays them).  Returns
    ``(seg_end, seg_first, seg_perm)`` with a random ``seg_perm``."""
    rng = np.random.default_rng(seed)
    ends, firsts = [], []
    for r in range(rows):
        if layout == "sparse":
            local = {1: [1023], 4: [0]}.get(r, [])
        elif layout == "singletons" and r == 1:
            local = list(range(ROW))
        elif layout == "pad_tail" and r >= rows - 2:
            local = []
        else:
            count = 0 if r % 3 == 2 else int(rng.integers(1, 41))
            local = sorted(rng.choice(ROW, count, replace=False).tolist())
        first = rng.random(len(local)) < 0.1
        if local:
            first[0] = True
        ends += [r * ROW + e for e in local]
        firsts += first.tolist()
    seg_end = np.asarray(ends, np.int64)
    seg_first = np.asarray(firsts, bool)
    if layout == "all_flagged":
        seg_first[:] = True
    if layout == "pad_tail":
        pad = 1029 + (3 - seg_end.shape[0] - 1029) % 4
        total = rows * ROW
        seg_end = np.concatenate([seg_end, np.arange(total - pad, total)])
        seg_first = np.concatenate([seg_first, np.ones(pad, bool)])
    seg_perm = rng.permutation(seg_end.shape[0]).astype(np.int32)
    return seg_end.astype(np.int32), seg_first, seg_perm


def np_run_ptr(seg_end: np.ndarray, rows: int) -> np.ndarray:
    return np.searchsorted(seg_end, np.arange(rows + 1) * ROW).astype(np.int32)


def bridge_case(kind: str, layout: str):
    """Adversarial slots of ``kind`` over the ``layout`` run tables:
    ``(slots, seg_end, seg_first, seg_perm, run_ptr)`` in numpy."""
    tables = run_tables(layout, seed=LAYOUTS.index(layout))
    slots = adversarial_values(ROWS * ROW, kind, seed=len(kind)).reshape(ROWS, ROW)
    return (slots, *tables, np_run_ptr(tables[0], ROWS))


def plan_slots(plan, seed: int) -> np.ndarray:
    """Random slot values over a real plan's rows (the zero-weight
    padding included, as the gather leaves it)."""
    rng = np.random.default_rng(seed)
    return (rng.random((plan.n_rows, ROW)) * plan.weight.reshape(plan.n_rows, ROW)).astype(F32)


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
    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("kind", LANE_KINDS + ["denormal"])
    def test_prefix_bridge_schedule(self, kind, layout):
        slots, seg_end, seg_first, seg_perm, run_ptr = bridge_case(kind, layout)
        port = tgw.prefix_bridge_plain(*map(t, (slots, seg_end, seg_first, seg_perm)))
        assert_bits_equal(emulate_prefix_bridge(slots, seg_end, seg_first, seg_perm, run_ptr), port)

    def test_prefix_bridge_schedule_on_a_real_plan(self, plan):
        slots = plan_slots(plan, seed=1)
        tables = (plan.seg_end, plan.seg_first, plan.seg_perm)
        assert plan.seg_capacity > plan.n_segments  # pad runs
        port = tgw.prefix_bridge_plain(*map(t, (slots, *tables)))
        run_ptr = np_run_ptr(plan.seg_end, plan.n_rows)
        assert_bits_equal(emulate_prefix_bridge(slots, *tables, run_ptr), port)

    @pytest.mark.parametrize("clamp", [True, False])
    @pytest.mark.parametrize("bad", ["past_end", "negative", "other_plan", "seg_perm"])
    def test_prefix_bridge_schedule_stays_in_bounds(self, bad, clamp):
        """Pointer tables that break the precondition (a stale row
        pointer table, another plan's, a permutation entry out of range)
        give wrong partials but no out-of-bounds access, and without the
        kernel's clamps each of them would read out of bounds."""
        slots, seg_end, seg_first, seg_perm, run_ptr = bridge_case("random", "random")
        n_runs = seg_end.shape[0]
        if bad == "past_end":
            run_ptr = run_ptr + n_runs
        elif bad == "negative":
            run_ptr = run_ptr - n_runs
        elif bad == "other_plan":
            other = run_tables("singletons", seed=1)[0]
            run_ptr = np_run_ptr(other, ROWS)
            assert run_ptr[-1] > n_runs
        else:
            seg_perm = seg_perm.copy()
            seg_perm[[0, -1]] = [-1, n_runs + 5]
        if clamp:
            out = emulate_prefix_bridge(slots, seg_end, seg_first, seg_perm, run_ptr)
            assert out.shape == (n_runs,)
        else:
            with pytest.raises(AssertionError, match="out of bounds"):
                emulate_prefix_bridge(slots, seg_end, seg_first, seg_perm, run_ptr, clamp=False)

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

    @pytest.mark.parametrize("per", [1, 2, K8_PER, 8])
    @pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 31, 32, 33, 63, 126, 127, 128, 129, 130,
                                   131, 255, 256, 257, 383, 511, 512, 513])
    def test_rowsum_tail_schedule_pointer_counts(self, n, per):
        """Pointer counts n + 1 in every residue mod 4 and beside the
        multiples of a warp (32) and of a warp's tile (32 * per): the
        last tile's absent slots, lane 31's extra read and the shuffle
        from lane 0's next slot all meet the end of the pointers."""
        e = 3 * B + 17
        lanes = plain_blocks(adversarial_values(e, "mixed", seed=n))
        row_ptr = pointers(e, n, seed=n, kind="block_edges" if n > 8 else "random")
        port = tsp._rowsum_tail(*lanes, t(row_ptr))
        emulated = emulate_rowsum_tail(*(a.numpy() for a in lanes), row_ptr, per=per)
        assert_bits_equal(emulated, port)

    @pytest.mark.parametrize("n", [1, 126, 127, 128, 129, 1000])
    def test_rowsum_tail_schedule_reads_each_pointer_once(self, n):
        """Every pointer is read once by its own slot, and lane 31 reads
        one more, the first of the next tile, only where its last output
        needs it: one extra read per tile with a pointer after it."""
        e = 5000
        lanes = [a.numpy() for a in plain_blocks(adversarial_values(e, "random"))]
        reads = []
        emulate_rowsum_tail(*lanes, pointers(e, n, seed=n), reads=reads)
        own, extra = np.concatenate(reads[:K8_PER]), reads[K8_PER]
        np.testing.assert_array_equal(np.sort(own), np.arange(n + 1))
        tile = 32 * K8_PER
        np.testing.assert_array_equal(extra, np.arange(tile, n + 1, tile))


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
        assert_bits_equal(tgw.bridge_partials_plain(*map(t, args)), j_bridge(*args))

    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("kind", LANE_KINDS)
    def test_prefix_bridge_adversarial(self, kind, layout):
        args = bridge_case(kind, layout)[:4]
        assert_bits_equal(tgw.prefix_bridge_plain(*map(t, args)), j_prefix_bridge(*args))

    def test_prefix_bridge_on_a_real_plan(self, plan):
        args = (plan_slots(plan, seed=3), plan.seg_end, plan.seg_first, plan.seg_perm)
        assert_bits_equal(tgw.prefix_bridge_plain(*map(t, args)), j_prefix_bridge(*args))

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


class TestRowRunPtr:
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_matches_searchsorted(self, layout):
        seg_end, seg_first, _ = run_tables(layout, seed=LAYOUTS.index(layout))
        ptr = tgw.row_run_ptr(t(seg_end), t(seg_first), ROWS)
        assert ptr.dtype == torch.int32
        np.testing.assert_array_equal(ptr.numpy(), np_run_ptr(seg_end, ROWS))

    def test_matches_searchsorted_on_a_real_plan(self, plan):
        ptr = tgw.row_run_ptr(t(plan.seg_end), t(plan.seg_first), plan.n_rows)
        np.testing.assert_array_equal(ptr.numpy(), np_run_ptr(plan.seg_end, plan.n_rows))

    def test_raises_on_an_unflagged_row_lead(self):
        seg_end, seg_first, _ = run_tables("random")
        row_lead = np_run_ptr(seg_end, ROWS)[1]  # row 1's first run, not run 0
        seg_first[row_lead] = False
        with pytest.raises(ValueError, match="flagged"):
            tgw.row_run_ptr(t(seg_end), t(seg_first), ROWS)

    def test_run_0_needs_no_flag(self):
        seg_end, seg_first, _ = run_tables("random")
        seg_first[0] = False
        ptr = tgw.row_run_ptr(t(seg_end), t(seg_first), ROWS)
        np.testing.assert_array_equal(ptr.numpy(), np_run_ptr(seg_end, ROWS))

    @pytest.mark.parametrize("rows", [ROWS - 1, 0])
    def test_raises_on_runs_past_the_rows(self, rows):
        seg_end, seg_first, _ = run_tables("pad_tail")
        with pytest.raises(ValueError, match="outside"):
            tgw.row_run_ptr(t(seg_end), t(seg_first), rows)


def bridge_operands(layout: str = "random") -> dict:
    slots, seg_end, seg_first, seg_perm, run_ptr = bridge_case("random", layout)
    return dict(
        slots=t(slots), seg_end=t(seg_end), seg_first=t(seg_first), seg_perm=t(seg_perm),
        run_ptr=t(run_ptr),
    )


def tail_operands(e: int = 5000, n: int = 300) -> dict:
    wh, wl, hi_in, lo_in = plain_blocks(adversarial_values(e, "random"))
    return dict(wh=wh, wl=wl, hi_in=hi_in, lo_in=lo_in, row_ptr=t(pointers(e, n, seed=n)))


class TestWrappers:
    def test_prefix_bridge_takes_plain_route_on_cpu_without_counting(self):
        a = bridge_operands()
        out = tgw.prefix_bridge(**a)
        assert tgw.prefix_bridge.launches == 0
        plain = {k: v for k, v in a.items() if k != "run_ptr"}
        assert_bits_equal(out, tgw.prefix_bridge_plain(**plain))

    def test_rowsum_tail_takes_plain_route_on_cpu_without_counting(self):
        a = tail_operands()
        out = tsp.rowsum_tail(**a)
        assert tsp.rowsum_tail.launches == 0
        assert_bits_equal(out, tsp._rowsum_tail(**a))

    @pytest.mark.parametrize(
        "mutate, exc",
        [
            (lambda a: dict(a, slots=a["slots"].double()), TypeError),
            (lambda a: dict(a, seg_end=a["seg_end"].long()), TypeError),
            (lambda a: dict(a, seg_first=a["seg_first"].float()), TypeError),
            (lambda a: dict(a, seg_perm=a["seg_perm"].long()), TypeError),
            (lambda a: dict(a, run_ptr=a["run_ptr"].long()), TypeError),
            (lambda a: dict(a, slots=a["slots"].reshape(-1, 512)), ValueError),
            (lambda a: dict(a, slots=a["slots"].reshape(-1)), ValueError),
            (lambda a: dict(a, seg_perm=a["seg_perm"][:-1]), ValueError),
            (lambda a: dict(a, seg_first=a["seg_first"][:-1]), ValueError),
            (lambda a: dict(a, run_ptr=a["run_ptr"][:-1]), ValueError),
            (lambda a: dict(a, seg_end=a["seg_end"].reshape(1, -1)), ValueError),
            (lambda a: dict(a, seg_end=a["seg_end"].to("meta")), ValueError),
            (lambda a: {k: v.to("meta") for k, v in a.items()}, ValueError),
        ],
        ids=["slots-dtype", "seg_end-int64", "seg_first-float", "seg_perm-int64",
             "run_ptr-int64", "slots-512-wide", "slots-rank", "seg_perm-length",
             "seg_first-length", "run_ptr-length", "seg_end-rank", "mixed-device",
             "meta-device"],
    )
    def test_prefix_bridge_rejects_bad_operands(self, mutate, exc):
        with pytest.raises(exc):
            tgw.prefix_bridge(**mutate(bridge_operands()))

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
            tgw.prefix_bridge(**meta)
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
    """Count the calls of the step's wrappers wherever the steps look them up."""
    calls = {"prefix_bridge": 0, "ds_cumsum_axis1": 0, "rowsum_tail": 0}

    def spy(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(tgw, "prefix_bridge", spy("prefix_bridge", tgw.prefix_bridge))
    monkeypatch.setattr(tsp, "ds_cumsum_axis1", spy("ds_cumsum_axis1", tsp.ds_cumsum_axis1))
    monkeypatch.setattr(tsp, "rowsum_tail", spy("rowsum_tail", tsp.rowsum_tail))
    return calls


class TestRoutedPasses:
    def test_windowed_ct_calls_each_wrapper_once(self, spied, plan):
        x = np.random.default_rng(4).random(plan.n).astype(F32)
        x /= x.sum()
        port_plan = tgw.WindowPlan.from_arrays(plan.to_arrays(core_only=False))
        args = port_plan.device_args("cpu")
        tgw.windowed_ct(
            *args, t(x), n_rows=plan.n_rows, table_entries=plan.table_entries,
            run_ptr=tgw.row_run_ptr(args[3], args[4], plan.n_rows),
        )
        # The plan rows' prefix is inside prefix_bridge; ds_cumsum_axis1
        # takes rowsum_sorted's blocks.
        assert spied == {"prefix_bridge": 1, "ds_cumsum_axis1": 1, "rowsum_tail": 1}

    def test_power_step_csr_calls_the_tail_once(self, spied):
        g = scale_free(2000, 20_000, seed=5).drop_self_edges()
        w, dangling = g.row_normalized()
        g = type(g)(g.n, g.src, g.dst, w, g.pre_trusted).sorted_by_dst()
        p = np.full(g.n, 1.0 / g.n, F32)
        tsp.power_step_csr(
            t(g.src), t(g.row_ptr_by_dst()), t(g.weight), t(p), t(p),
            t(dangling.astype(F32)), torch.tensor(0.1),
        )
        # The CSR step's block prefix is gather_ds_cumsum's, not K5's.
        assert spied == {"prefix_bridge": 0, "ds_cumsum_axis1": 0, "rowsum_tail": 1}

    def test_plain_route_calls_no_wrapper(self, spied):
        e, n = 5000, 300
        tsp.rowsum_sorted_plain(t(adversarial_values(e, "random")), t(pointers(e, n, seed=n)))
        assert spied == {"prefix_bridge": 0, "ds_cumsum_axis1": 0, "rowsum_tail": 0}
