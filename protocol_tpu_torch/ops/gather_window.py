"""Windowed gather on Hopper and the fused fixed-slot pipeline built on it.

Port of ``protocol_tpu/ops/gather_window.py``.  The host side — window
bucketing, the ``WindowPlan`` layout with its delta updates, the plan
fingerprint — is the reference's numpy code, array for array, so a plan
built by either package is the other's plan (``PLAN_VERSION = 3``; the
checkpoint sidecar ``to_arrays``/``from_arrays`` loads both ways).

The device side runs one damped power step per iteration:

1. ``gather_windowed``: ``out = weight * table[wid*1024 + local]`` in
   bucket order — the hand-written CUDA kernel
   ``csrc/gather_window.cu`` on a card, its plain PyTorch version on
   the CPU;
2. ``prefix_bridge``: the row-local double-single prefix over the
   (n_rows, 1024) slots, the run partials at the bucket-order run ends
   and one ``n_segments`` permutation into dst order — two jit'd XLA
   passes of the reference (``_ds_cumsum_axis1``, ``bridge_partials``)
   as one CUDA kernel, ``csrc/prefix_bridge.cu``, on a card, which keeps
   the prefix on chip;
3. ``rowsum_sorted`` over the dst-delimited partials → dense Cᵀt (its
   passes on the CUDA kernels ``ds_cumsum_rows.cu``,
   ``compensated_scan.cu`` and ``rowsum_tail.cu``);
4. the shared damping epilogue, plain PyTorch.

Steps 2-4 are jit'd XLA in the reference, not Pallas.  Everything up to
Cᵀt is bit-identical to the reference.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from . import _build
from .sparse import _ds_cumsum_axis1, damp, rowsum_sorted, run_power_iteration

try:
    # The C two-pass kernel underneath scipy's COO→CSR conversion; the
    # coo_matrix wrapper around it re-validates indices with two extra
    # O(E) passes (~0.5 s at 50M edges on the bench host).
    from scipy.sparse import _sparsetools as _scipy_sparsetools
except ImportError:  # pragma: no cover - bench/prod images carry scipy
    _scipy_sparsetools = None

# The plan layout is the reference's (a "vreg-row" is one 1024-slot
# row, named after the TPU vector registers it was sized for), kept
# unchanged so plans cross-load; the CUDA kernel stages one window per
# row in shared memory.
#: Window width in table entries (4 KB of f32 scores).
WINDOW = 1024
#: Edge slots per vreg-row (must equal WINDOW: a row reads one window).
ROW = 1024
#: Row granularity of the padded plan (the reference's grid step).
BLOCK_ROWS = 64


#: log2(WINDOW): window ids and window-local indices are shifts/masks.
_WIN_BITS = 10


def _counting_sort(
    key: np.ndarray, n_keys: int, payload: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Stable counting sort by a small-domain non-negative integer key:
    returns ``(order, counts, sorted_payload)`` where ``order`` is the
    ``argsort(key, kind="stable")`` permutation and ``counts`` the
    per-key histogram.

    numpy's stable argsort costs ~8-10 s at 50M elements on the bench
    host — most of the old 34 s bucketing loop's replacement budget.
    scipy's COO→CSR conversion is the same counting sort as a two-pass
    C loop, O(E + n_keys): rows are the keys, columns the positions, so
    the CSR column indices come out key-grouped in stable position
    order, and the CSR data array carries ``payload`` through the sort
    without a separate O(E) random gather.  Falls back to numpy where
    scipy is missing.
    """
    e = key.shape[0]
    coo_tocsr = getattr(_scipy_sparsetools, "coo_tocsr", None)
    if coo_tocsr is None or e >= 2**31 or n_keys >= 2**31:  # pragma: no cover
        order = np.argsort(key, kind="stable")
        counts = np.bincount(key, minlength=n_keys)
        return order, counts, None if payload is None else payload[order]
    data = (
        np.ascontiguousarray(payload)
        if payload is not None
        else np.empty(e, np.int8)
    )
    key = np.ascontiguousarray(key, dtype=np.int32)
    indptr = np.empty(n_keys + 1, np.int32)
    order = np.empty(e, np.int32)
    sorted_data = np.empty(e, data.dtype)
    coo_tocsr(
        n_keys, e, e, key, np.arange(e, dtype=np.int32), data,
        indptr, order, sorted_data,
    )
    return order, np.diff(indptr), sorted_data if payload is not None else None


def _pack_lanes(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pack two equal-length 4-byte arrays into one int64 array
    (bit-preserving), so one counting-sort pass carries both payloads
    at once instead of paying two O(E) permutations."""
    lanes = np.empty((a.shape[0], 2), np.int32)
    lanes[:, 0] = a if a.dtype == np.int32 else a.view(np.int32)
    lanes[:, 1] = b if b.dtype == np.int32 else b.view(np.int32)
    return lanes.view(np.int64)[:, 0]


def _unpack_lanes(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Bit-exact int32 lane views of a ``_pack_lanes`` array."""
    v = packed.view(np.int32).reshape(-1, 2)
    return v[:, 0], v[:, 1]


def bucket_by_window(
    src: np.ndarray,
    w: np.ndarray,
    table_size: int | None = None,
    *,
    dst: np.ndarray | None = None,
    n_dst: int | None = None,
    spare_rows: int | None = 0,
) -> dict:
    """Group edges so each 1024-edge vreg-row shares one src window.

    Returns arrays shaped for ``gather_windowed`` plus the mapping back
    to input edges: for the k-th edge of the window-sorted order,
    ``contrib_input[order[k]] = contrib_bucketed[out_pos[k]]`` —
    ``out_pos`` accounts for the per-window padding, which carries
    weight 0.

    With ``dst`` (and ``n_dst``) given, edges are additionally sorted by
    destination *within* each window and the dict gains the static
    single-pass reduction plan (PERF.md §7-8): ``seg_end`` flat end
    slots of every per-(vreg-row, dst) run in *bucket order* (strictly
    increasing — the boundary read streams), ``seg_first`` flagging
    row-leading runs (whose start prefix is an exact zero),
    ``seg_perm`` the bucket→dst permutation of the run partials, and
    ``dst_ptr`` delimiting each destination's runs in permuted order —
    everything ``power_step_windowed`` needs to reduce bucket-order
    contributions to a dense Cᵀt with one n_segments-sized random pass.

    Fully vectorized: stable counting sorts (scipy COO→CSR, O(E)) plus
    cumulative-count placement — the previous per-window Python loop
    was ~34 s at 50M edges; this formulation is bounded by the sort's
    payload movement (<5 s measured, PERF.md §7).

    ``spare_rows`` reserves that many zero-weight vreg-rows past the
    packed data (on top of the BLOCK_ROWS grid rounding) — headroom
    ``WindowPlan.apply_delta`` allocates overflow rows from (and where
    the inert segment-table pads end), so a window outgrowing its
    original padding doesn't force a full rebuild (PERF.md §11).
    None sizes it adaptively: one grid block or ~6% of the data rows,
    whichever is larger.
    """
    e = src.shape[0]
    if e == 0:
        raise ValueError("no edges to bucket")
    src = np.asarray(src, dtype=np.int32)
    w = np.asarray(w, dtype=np.float32)
    smin, smax = int(src.min()), int(src.max())
    if smin < 0 or (table_size is not None and smax >= table_size):
        # Out-of-range (or negative) indices would be silently clamped
        # by the kernel's dynamic slice into a wrong but in-bounds
        # window; must survive python -O, so no assert.
        raise ValueError("src index outside [0, table_size)")
    n_src = table_size if table_size is not None else smax + 1
    n_windows = -(-n_src // WINDOW)

    if dst is None:
        o1, s1, w1, d1 = None, src, w, None
    else:
        if n_dst is None:
            raise ValueError("n_dst is required when dst is given")
        if int(dst.min()) < 0 or int(dst.max()) >= n_dst:
            raise ValueError("dst index outside [0, n_dst)")
        dst = np.asarray(dst, dtype=np.int32)
        # Within-window dst order = one stable counting sort by window
        # over a dst-sorted edge sequence.  The node/bench graphs arrive
        # dst-sorted (``TrustGraph.sorted_by_dst``), so the usual cost
        # is a single O(E) pass; unsorted input pays one extra
        # dst-keyed pass (LSD radix), with (src, w) riding the payload
        # lanes so no separate O(E) random gathers are needed.
        if np.any(dst[1:] < dst[:-1]):
            o1, dst_counts, packed = _counting_sort(
                dst, n_dst, payload=_pack_lanes(src, w)
            )
            if packed is None:  # pragma: no cover - numpy fallback
                s1, w1 = src[o1], w[o1]
            else:
                s1, w1raw = _unpack_lanes(packed)
                w1 = w1raw.view(np.float32)
            d1 = np.repeat(np.arange(n_dst, dtype=np.int32), dst_counts)
        else:
            o1, s1, w1, d1 = None, src, w, dst
    # The one window-keyed counting sort.  The small key domain
    # (E/1024 windows) matters: the placement pass advances one write
    # pointer per key, so with ~1000 keys the writes stream (measured
    # ~6× faster than a src-keyed pass whose 1M pointers scatter every
    # write to a cold cache line).  (local, w) ride the payload lanes;
    # ``order`` is the CSR column indices, for free.
    window = s1 >> _WIN_BITS
    order, counts, data = _counting_sort(
        window, n_windows, payload=_pack_lanes(s1 & (WINDOW - 1), w1)
    )
    if data is None:  # pragma: no cover - numpy fallback
        local_sorted = (s1 & (WINDOW - 1))[order]
        w_sorted = w1[order]
    else:
        local_sorted, wraw = _unpack_lanes(data)
        w_sorted = wraw.view(np.float32)
    ds = d1[order] if d1 is not None else None
    if o1 is not None:
        order = o1[order]

    # Rows per window, each padded to a full vreg-row; grid padded to
    # block granularity.  Windows with no edges contribute zero rows.
    rows_per = -(-counts // ROW)
    row_offset = np.concatenate([[0], np.cumsum(rows_per)]).astype(np.int64)
    n_data_rows = int(row_offset[-1])
    if spare_rows is None:
        spare_rows = max(BLOCK_ROWS, n_data_rows // 16)
    total_rows = -(-(n_data_rows + spare_rows) // BLOCK_ROWS) * BLOCK_ROWS
    # Flat slot of each window-sorted edge: consecutive within its
    # window, starting at the window's first (fresh) vreg-row.  One
    # repeat over the per-window pad shift; the scatter below is
    # monotonic (sorted destinations), so it streams.  int32 throughout:
    # slot count < 2³¹ is already implied by the int32 edge arrays, and
    # the narrower lanes halve this pass's memory traffic (measured 6×
    # on the bench host).
    win_off = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out_pos = np.repeat(
        (row_offset[:-1] * ROW - win_off).astype(np.int32), counts
    ) + np.arange(e, dtype=np.int32)
    local = np.zeros(total_rows * ROW, np.int32)
    weight = np.zeros(total_rows * ROW, np.float32)
    local[out_pos] = local_sorted
    weight[out_pos] = w_sorted
    wid = np.zeros(total_rows, np.int32)
    wid[:n_data_rows] = np.repeat(np.arange(n_windows, dtype=np.int32), rows_per)
    result = {
        "local": local.reshape(total_rows * 8, 128),
        "weight": weight.reshape(total_rows * 8, 128),
        "wid": wid,
        "order": order,
        "out_pos": out_pos,
        "n_rows": total_rows,
        "n_data_rows": n_data_rows,
        "row_offset": row_offset,
    }
    if ds is None:
        return result

    # -- static single-pass reduction plan (PERF.md §7-8) ---------------
    # Segments are maximal same-dst slot runs within one vreg-row: edges
    # are dst-sorted inside each window and packed into consecutive
    # slots, so a run breaks only at a dst change or a row boundary (a
    # window change always starts a fresh row, so it needs no term).
    brk = np.empty(e, bool)
    brk[0] = True
    brk[1:] = (ds[1:] != ds[:-1]) | (out_pos[1:] & (ROW - 1) == 0)
    end_mask = np.empty(e, bool)
    end_mask[-1] = True
    end_mask[:-1] = brk[1:]
    seg_dst = ds[brk]
    # The boundary table stays in BUCKET order: run end slots are then
    # strictly increasing, so the device's one boundary gather reads
    # monotonically (streams) instead of jumping dst-to-dst through the
    # prefix-sum array.  A run's start prefix is the previous run's end
    # prefix (runs are consecutive within a row) — an on-device shift —
    # except at row-leading runs, where it is an exact zero.
    seg_end = np.ascontiguousarray(out_pos[end_mask])
    seg_first = np.ascontiguousarray(out_pos[brk] & (ROW - 1) == 0)
    # Host-side dst sort of the segment table becomes a single stored
    # permutation: the device applies it once to the n_segments run
    # partials — the only data-randomly-addressed pass per iteration.
    seg_perm, seg_counts, _ = _counting_sort(seg_dst, n_dst)
    dst_ptr = np.zeros(n_dst + 1, np.int64)
    np.cumsum(seg_counts, out=dst_ptr[1:])
    result.update(
        seg_end=seg_end,
        seg_first=seg_first,
        seg_perm=seg_perm.astype(np.int32, copy=False),
        dst_ptr=dst_ptr.astype(np.int32),
        seg_dst=np.ascontiguousarray(seg_dst, dtype=np.int32),
        n_segments=int(seg_dst.shape[0]),
    )
    return result


def gather_windowed_plain(
    wid: torch.Tensor,
    table: torch.Tensor,
    local: torch.Tensor,
    weight: torch.Tensor,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel:
    ``table[wid.repeat_interleave(8)[:, None] * 1024 + local] * weight``.
    Used for CPU tensors, and on the card only to check the kernel."""
    idx = wid.repeat_interleave(8)[:, None] * WINDOW + local
    return table.index_select(0, idx.reshape(-1)).reshape(local.shape) * weight


def _check_operands(wid, table, local, weight, n_rows: int) -> None:
    if n_rows % BLOCK_ROWS:
        # bucket_by_window pads to this; the reference's grid leaves a
        # partial trailing block unwritten.
        raise ValueError(f"n_rows must be a multiple of {BLOCK_ROWS}, got {n_rows}")
    if table.dim() != 1 or table.shape[0] % WINDOW:
        raise ValueError(f"table must be 1-D with a multiple of {WINDOW} entries")
    if tuple(wid.shape) != (n_rows,):
        raise ValueError(f"wid must have shape ({n_rows},), got {tuple(wid.shape)}")
    for name, a in (("local", local), ("weight", weight)):
        if tuple(a.shape) != (n_rows * 8, 128):
            raise ValueError(f"{name} must have shape ({n_rows * 8}, 128), got {tuple(a.shape)}")
    for name, a, dtype in (
        ("wid", wid, torch.int32),
        ("table", table, torch.float32),
        ("local", local, torch.int32),
        ("weight", weight, torch.float32),
    ):
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")


def gather_windowed(
    wid: torch.Tensor,
    table: torch.Tensor,
    local: torch.Tensor,
    weight: torch.Tensor,
    *,
    n_rows: int,
) -> torch.Tensor:
    """``out[r, j] = weight[r, j] * table[wid[r//8]*1024 + local[r, j]]``
    over the plan's ``(n_rows*8, 128)`` slots.

    On CUDA tensors this launches the hand-written kernel
    (``csrc/gather_window.cu``, which replaces the reference's Pallas
    ``_kernel``) and adds one to ``gather_windowed.launches``; a launch
    the card refuses raises.  On CPU tensors it is the plain version.
    Any other mix raises — there is no silent fallback."""
    _check_operands(wid, table, local, weight, n_rows)
    devices = {a.device for a in (wid, table, local, weight)}
    if len(devices) != 1:
        raise ValueError(f"operands must share one device, got {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return gather_windowed_plain(wid, table, local, weight)
    if device.type != "cuda":
        raise ValueError(f"gather_windowed runs on cpu or cuda, not {device.type}")
    for name, a in (("wid", wid), ("table", table), ("local", local), ("weight", weight)):
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    lib = _build.load("gather_window")
    out = torch.empty_like(weight)
    with torch.cuda.device(device):
        rc = lib.gather_window(
            wid.data_ptr(),
            table.data_ptr(),
            local.data_ptr(),
            weight.data_ptr(),
            out.data_ptr(),
            n_rows,
            table.shape[0],
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"gather_window kernel launch failed: cudaError {rc}")
    gather_windowed.launches += 1
    return out


#: Kernel launches in this process (the plain version does not count).
gather_windowed.launches = 0  # type: ignore[attr-defined]


# ---------------------------------------------------------------------------
# The fused fixed-slot pipeline (reference PERF.md §7)
# ---------------------------------------------------------------------------


#: WindowPlan on-disk/in-memory layout version.  v1 stored dst-sorted
#: ``seg_start``/``seg_end`` boundary pairs (4 random gathers per
#: iteration); v2 is the interleaved single-pass layout (bucket-order
#: ``seg_end`` + row-leading mask + folded dst permutation, PERF.md §8);
#: v3 adds the host-side delta-update bookkeeping (bucket-order
#: ``seg_dst``, per-window ``row_offset``, the live-row watermark, and
#: the fingerprint lineage chain, PERF.md §11).  Checkpoint-restored
#: plans of any other version are discarded and rebuilt — the same
#: path a fingerprint mismatch takes.
PLAN_VERSION = 3

#: Ancestor fingerprints a delta-updated plan remembers (checkpoint
#: forensics: how many epochs of churn separate this layout from its
#: last from-scratch build).
LINEAGE_DEPTH = 16

#: Device segment tables are padded to a multiple of this, with at
#: least SEG_HEADROOM free entries, so per-epoch deltas that grow the
#: run count slightly keep every device array shape — and therefore
#: the compiled convergence kernel — stable.  Pad runs are inert: they
#: end in the zero-weight spare tail (partial ≡ 0) and the dst
#: permutation parks them beyond ``dst_ptr[n]``, so ``rowsum_sorted``
#: never differences them into any destination (the same trick the
#: sharded partition uses for its per-shard padding).
SEG_QUANTUM = 1024
SEG_HEADROOM = 256


class PlanDeltaError(ValueError):
    """The requested delta cannot be applied to this plan (peer set
    shrank, a deleted edge is absent, or the overflow headroom is
    exhausted) — callers fall back to a full ``build_window_plan``."""


def _pad_segment_tables(
    seg_end: np.ndarray,
    seg_first: np.ndarray,
    seg_dst: np.ndarray,
    *,
    capacity: int,
    n: int,
    n_rows: int,
    n_data_rows: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad the live bucket-order run tables to ``capacity`` device
    entries and fold the dst sort: pad runs end at the topmost
    zero-weight spare slots (strictly above every live run, so the
    boundary read stays sorted and their partials are exact zeros) and
    carry sentinel dst ``n``, which the counting sort parks beyond
    ``dst_ptr[n]`` — never reduced into any destination.  Returns
    ``(seg_end, seg_first, seg_perm, dst_ptr)`` at device capacity."""
    s = int(seg_end.shape[0])
    pad = capacity - s
    if pad < 0 or pad > (n_rows - n_data_rows) * ROW:
        raise PlanDeltaError(
            f"segment capacity {capacity} does not fit the spare-slot headroom"
        )
    total_slots = n_rows * ROW
    end = np.concatenate(
        [
            seg_end.astype(np.int64),
            np.arange(total_slots - pad, total_slots, dtype=np.int64),
        ]
    )
    first = np.concatenate([seg_first.astype(bool), np.ones(pad, bool)])
    key = np.concatenate([seg_dst.astype(np.int64), np.full(pad, n, np.int64)])
    perm, counts, _ = _counting_sort(np.ascontiguousarray(key, np.int32), n + 1)
    dst_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts[:n], out=dst_ptr[1:])
    return (
        end.astype(np.int32),
        first,
        np.asarray(perm, np.int32),
        dst_ptr.astype(np.int32),
    )


def _segment_capacity(s: int, max_pad_slots: int) -> int:
    """Quantized device capacity for ``s`` live runs: proportional
    growth headroom (churn fragments hub runs into singletons, so the
    live count drifts up by roughly the per-epoch rewire count —
    ~12.5% absorbs several epochs between regrowths), rounded to
    SEG_QUANTUM, clamped to the spare-tail slots actually available
    for pad runs."""
    slack = max(SEG_HEADROOM, s // 8)
    return min(-(-(s + slack) // SEG_QUANTUM) * SEG_QUANTUM, s + max_pad_slots)


@dataclass
class WindowPlan:
    """Static per-graph layout for the fused windowed power step.

    Built once on the host (``build_window_plan``), reused every
    iteration and across epochs while the graph fingerprint matches;
    persisted by ``node/checkpoint.py`` so a node reboot doesn't re-pay
    construction.  Small per-epoch edge churn is folded in by
    ``apply_delta`` (touched windows repacked in place, everything else
    shared) instead of a full rebuild — the ``lineage`` chain records
    the ancestor fingerprints of such delta-updated plans.
    ``order``/``out_pos`` map bucket slots back to input edges — needed
    only by tests and diagnostics, so checkpoints omit them
    (``to_arrays(core_only=True)``); delta-updated plans drop them.
    """

    n: int  # peers (dense output length)
    n_rows: int  # padded vreg-rows
    table_entries: int  # score table padded to a WINDOW multiple
    n_segments: int  # per-(row, dst) runs crossing the bridge
    n_data_rows: int  # live vreg-rows (original packing + delta overflow)
    n_edges: int  # live edges encoded (delta-integrity tripwire)
    wid: np.ndarray  # (n_rows,) int32 window id per vreg-row
    local: np.ndarray  # (n_rows*8, 128) int32 window-local indices
    weight: np.ndarray  # (n_rows*8, 128) f32 slot weights (0 = padding)
    seg_end: np.ndarray  # (S,) int32 last slot of each run, bucket order
    seg_first: np.ndarray  # (S,) bool run is row-leading (start prefix = 0)
    seg_perm: np.ndarray  # (S,) int32 bucket→dst permutation of partials
    dst_ptr: np.ndarray  # (n+1,) int32 run range per destination
    seg_dst: np.ndarray  # (S,) int32 run destination, bucket order (host-side)
    row_offset: np.ndarray  # (n_windows+1,) int64 original rows per window
    fingerprint: str  # graph identity for safe reuse
    version: int = PLAN_VERSION  # layout version (see PLAN_VERSION)
    #: Fingerprints of the plans this one was delta-derived from,
    #: oldest first, capped at LINEAGE_DEPTH; empty for a from-scratch
    #: build.  Persisted with checkpoints (delta provenance).
    lineage: tuple[str, ...] = ()
    order: np.ndarray | None = None  # (E,) bucket position k ← edge order[k]
    out_pos: np.ndarray | None = None  # (E,) slot of edge order[k]

    #: Device operands, in ``converge_windowed`` order — exactly what
    #: crosses the host→HBM boundary.
    _CORE = ("wid", "local", "weight", "seg_end", "seg_first", "seg_perm", "dst_ptr")
    #: Host-only bookkeeping for ``apply_delta`` (persisted, never
    #: shipped to the device).
    _HOST = ("seg_dst", "row_offset")
    _META = ("n", "n_rows", "table_entries", "n_segments", "n_data_rows", "n_edges")

    @property
    def compression(self) -> float:
        """Edge contributions per bridge partial (E / n_segments) —
        how much the run-level reduction shrinks the random-access
        volume vs a per-edge bucket→dst permutation."""
        return self.n_edges / max(self.n_segments, 1)

    @property
    def seg_capacity(self) -> int:
        """Device length of the segment tables: ``n_segments`` live
        runs plus inert pad runs (shape-stability headroom for
        ``apply_delta`` — see SEG_QUANTUM)."""
        return int(self.seg_end.shape[0])

    def device_args(self, device) -> tuple:
        """Core arrays as tensors on ``device``, in ``converge_windowed``
        order.  Every index array stays int32 (``index_select`` takes
        int32 indices, so none is widened); ``seg_first`` is bool."""
        return tuple(
            torch.from_numpy(np.ascontiguousarray(getattr(self, k))).to(device)
            for k in self._CORE
        )

    def to_arrays(self, *, core_only: bool = True) -> dict:
        """npz-ready mapping (checkpoint format)."""
        out = {k: np.int64(getattr(self, k)) for k in self._META}
        out["version"] = np.int64(self.version)
        out["fingerprint"] = np.bytes_(self.fingerprint.encode())
        out["lineage"] = np.array(list(self.lineage), dtype="S64")
        for k in self._CORE + self._HOST:
            out[k] = getattr(self, k)
        if not core_only and self.order is not None:
            out["order"] = self.order
            out["out_pos"] = self.out_pos
        return out

    @classmethod
    def from_arrays(cls, z) -> "WindowPlan":
        """Rehydrate a persisted plan; raises ``ValueError`` on a stale
        layout version (pre-v2 plans lack ``version`` entirely) so
        callers fall back to a rebuild instead of feeding the device
        mis-shaped boundary arrays."""
        version = int(z["version"]) if "version" in z else 1
        if version != PLAN_VERSION:
            raise ValueError(
                f"window plan layout v{version} is stale (current v{PLAN_VERSION}); rebuild"
            )
        return cls(
            **{k: int(z[k]) for k in cls._META},
            **{k: np.asarray(z[k]) for k in cls._CORE + cls._HOST},
            fingerprint=bytes(z["fingerprint"]).decode(),
            version=version,
            lineage=tuple(bytes(x).decode() for x in z["lineage"])
            if "lineage" in z
            else (),
            order=np.asarray(z["order"]) if "order" in z else None,
            out_pos=np.asarray(z["out_pos"]) if "out_pos" in z else None,
        )

    # -- delta updates (PERF.md §11) ------------------------------------

    def _window_vreg_rows(self, window: int) -> np.ndarray:
        """Live vreg-rows carrying ``window``'s slots, ascending: the
        original contiguous block plus any delta-appended overflow rows
        (overflow lives past ``row_offset[-1]``, identified by wid)."""
        n_orig = int(self.row_offset[-1])
        if window + 1 < len(self.row_offset):
            rows = np.arange(
                self.row_offset[window], self.row_offset[window + 1], dtype=np.int64
            )
        else:
            rows = np.empty(0, np.int64)
        if self.n_data_rows > n_orig:
            tail = np.arange(n_orig, self.n_data_rows, dtype=np.int64)
            rows = np.concatenate([rows, tail[self.wid[tail] == window]])
        return rows

    def _segments_of_rows(self, rows: np.ndarray) -> np.ndarray:
        """Indices into the bucket-order segment table of every run
        living in ``rows`` — seg_end is strictly increasing, so each
        row's runs are one searchsorted slice."""
        end = self.seg_end.astype(np.int64)
        lo = np.searchsorted(end, rows * ROW, side="left")
        hi = np.searchsorted(end, (rows + 1) * ROW - 1, side="right")
        parts = [np.arange(a, b, dtype=np.int64) for a, b in zip(lo, hi) if b > a]
        if not parts:
            return np.empty(0, np.int64)
        return np.concatenate(parts)

    def _edges_of_segments(
        self, idx: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Recover ``(src, dst, w)`` of the edges inside the given runs
        by expanding each run's slot range — the inverse of the packing
        ``bucket_by_window`` performed."""
        if idx.size == 0:
            z = np.empty(0, np.int32)
            return z, z, np.empty(0, np.float32)
        end = self.seg_end.astype(np.int64)
        start = np.where(
            self.seg_first[idx],
            (end[idx] // ROW) * ROW,
            end[np.maximum(idx, 1) - 1] + 1,
        )
        lens = end[idx] - start + 1
        total = int(lens.sum())
        run_of = np.repeat(np.cumsum(lens) - lens, lens)
        slots = np.repeat(start, lens) + (np.arange(total, dtype=np.int64) - run_of)
        dst = np.repeat(self.seg_dst[idx], lens)
        rows = slots // ROW
        src = (
            self.wid[rows].astype(np.int64) * WINDOW
            + self.local.reshape(-1)[slots]
        ).astype(np.int32)
        return src, dst, self.weight.reshape(-1)[slots]

    def recovered_edges(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The full ``(src, dst, w)`` edge list this plan encodes, in
        slot (bucket) order — the layout-semantics ground truth the
        delta property tests compare against a from-scratch rebuild."""
        return self._edges_of_segments(np.arange(self.n_segments, dtype=np.int64))

    def apply_delta(
        self,
        inserts: tuple[np.ndarray, np.ndarray, np.ndarray] | None,
        deletes: tuple[np.ndarray, np.ndarray] | None,
        *,
        n: int | None = None,
        fingerprint: str,
    ) -> "WindowPlan":
        """Incrementally fold an edge delta into the layout, returning a
        NEW plan (arrays are copied where touched, shared elsewhere —
        the old plan stays valid for the in-flight epoch).

        ``inserts`` is ``(src, dst, w)`` of edges to add (normalized
        weights), ``deletes`` is ``(src, dst)`` of edges to remove; ``n``
        grows the peer set (new peers join with no plan presence until
        an insert names them).  Host-side cost: O(Δ log Δ) sorting over
        the delta plus a repack of the touched windows' slots, then two
        streaming O(S) passes (segment-table splice + the dst counting
        sort behind ``seg_perm``/``dst_ptr``) — far below the full
        rebuild's O(E) counting sorts.  The result's ``fingerprint`` is
        the caller-supplied identity of the post-delta graph and the
        predecessor chain lands in ``lineage``.

        Raises :class:`PlanDeltaError` when the delta cannot be folded
        (peer set shrank, a deleted edge is absent, or a window outgrew
        the spare-row headroom) — callers fall back to
        ``build_window_plan``.
        """
        empty_i = (np.empty(0, np.int32),) * 2 + (np.empty(0, np.float32),)
        ins_src, ins_dst, ins_w = (
            tuple(np.asarray(a) for a in inserts) if inserts is not None else empty_i
        )
        del_src, del_dst = (
            tuple(np.asarray(a, np.int64) for a in deletes)
            if deletes is not None
            else (np.empty(0, np.int64),) * 2
        )
        ins_src = np.asarray(ins_src, np.int64)
        ins_dst = np.asarray(ins_dst, np.int64)
        ins_w = np.asarray(ins_w, np.float32)
        n_new = self.n if n is None else int(n)
        if n_new < self.n:
            raise PlanDeltaError("peer set shrank; rebuild the plan")
        for a in (ins_src, ins_dst, del_src, del_dst):
            if a.size and (int(a.min()) < 0 or int(a.max()) >= n_new):
                raise PlanDeltaError("delta edge index outside [0, n)")
        table_entries = -(-n_new // WINDOW) * WINDOW
        n_windows = table_entries // WINDOW
        row_offset = self.row_offset
        if n_windows + 1 > len(row_offset):
            # New windows own no original rows; overflow allocation
            # below serves them like any outgrown window.
            row_offset = np.concatenate(
                [
                    row_offset,
                    np.full(n_windows + 1 - len(row_offset), row_offset[-1], np.int64),
                ]
            )

        touched = np.unique(np.concatenate([ins_src, del_src]) >> _WIN_BITS)
        wid = self.wid.copy()
        local = self.local.reshape(-1).copy()
        weight = self.weight.reshape(-1).copy()
        n_data_rows = self.n_data_rows

        # Segments whose rows stay untouched survive verbatim; the
        # touched windows' runs are rebuilt below.  Only live runs
        # participate — the inert device pads are regenerated at exit.
        row_window = wid.astype(np.int64).copy()
        row_window[self.n_data_rows :] = -1
        end_live = self.seg_end.astype(np.int64)[: self.n_segments]
        first_live = self.seg_first[: self.n_segments]
        seg_win = row_window[end_live // ROW]
        keep = ~np.isin(seg_win, touched)
        new_end: list[np.ndarray] = [end_live[keep]]
        new_first: list[np.ndarray] = [first_live[keep]]
        new_dst: list[np.ndarray] = [self.seg_dst.astype(np.int64)[keep]]

        iw = ins_src >> _WIN_BITS
        dw = del_src >> _WIN_BITS
        for w in touched.tolist():
            rows_w = self._window_vreg_rows(int(w))
            osrc, odst, ow = self._edges_of_segments(self._segments_of_rows(rows_w))
            # Delete by (src, dst) identity; duplicate edges are a
            # multiset — each delete consumes one instance.
            dm = dw == w
            if dm.any():
                okey = osrc.astype(np.int64) << 32 | odst.astype(np.int64)
                dkey = np.sort(del_src[dm] << 32 | del_dst[dm])
                order = np.argsort(okey, kind="stable")
                sk = okey[order]
                pos = np.searchsorted(sk, dkey, side="left")
                # The i-th duplicate of a delete key consumes the i-th
                # plan instance of that edge.
                grp = np.concatenate([[True], dkey[1:] != dkey[:-1]])
                first = np.nonzero(grp)[0][np.cumsum(grp) - 1]
                take = pos + (np.arange(len(dkey)) - first)
                if take.size and (
                    int(take.max()) >= len(sk) or not (sk[take] == dkey).all()
                ):
                    raise PlanDeltaError("delete names an edge absent from the plan")
                drop = np.zeros(len(okey), bool)
                drop[order[take]] = True
                osrc, odst, ow = osrc[~drop], odst[~drop], ow[~drop]
            im = iw == w
            if im.any():
                osrc = np.concatenate([osrc, ins_src[im].astype(np.int32)])
                odst = np.concatenate([odst, ins_dst[im].astype(np.int32)])
                ow = np.concatenate([ow, ins_w[im]])
            count = osrc.shape[0]
            # Zero the window's slots, then repack dst-sorted from the
            # first row — the run differencing needs gap-free packing.
            if rows_w.size:
                slots_w = (rows_w[:, None] * ROW + np.arange(ROW)[None, :]).reshape(-1)
                local[slots_w] = 0
                weight[slots_w] = 0.0
            if count > rows_w.size * ROW:
                extra = -(-(count - rows_w.size * ROW) // ROW)
                if n_data_rows + extra > self.n_rows:
                    raise PlanDeltaError(
                        f"window {w} outgrew the spare-row headroom; rebuild"
                    )
                grown = np.arange(n_data_rows, n_data_rows + extra, dtype=np.int64)
                wid[grown] = w
                n_data_rows += extra
                rows_w = np.concatenate([rows_w, grown])
            if count == 0:
                continue
            order = np.argsort(odst, kind="stable")
            d = odst[order].astype(np.int64)
            slots = rows_w[np.arange(count) // ROW] * ROW + np.arange(count) % ROW
            local[slots] = (osrc[order] & (WINDOW - 1)).astype(np.int32)
            weight[slots] = ow[order]
            lead = np.arange(count) % ROW == 0
            brk = np.empty(count, bool)
            brk[0] = True
            brk[1:] = (d[1:] != d[:-1]) | lead[1:]
            endm = np.empty(count, bool)
            endm[-1] = True
            endm[:-1] = brk[1:]
            new_end.append(slots[endm])
            new_first.append(lead[brk])
            new_dst.append(d[brk])

        all_end = np.concatenate(new_end)
        order = np.argsort(all_end, kind="stable")
        live_end = all_end[order]
        if live_end.size > 1 and not (np.diff(live_end) > 0).all():
            raise AssertionError("delta produced overlapping runs (plan bug)")
        live_first = np.concatenate(new_first)[order]
        seg_dst = np.concatenate(new_dst)[order].astype(np.int32)
        # Keep the device capacity (and so every array shape + the
        # compiled kernel) whenever the new run count still fits; grow
        # by whole quanta otherwise — one recompile, then stable again.
        s_new = int(seg_dst.shape[0])
        max_pad = (self.n_rows - n_data_rows) * ROW
        capacity = self.seg_capacity
        if s_new > capacity or capacity - s_new > max_pad:
            capacity = _segment_capacity(s_new, max_pad)
        seg_end, seg_first, seg_perm, dst_ptr = _pad_segment_tables(
            live_end,
            live_first,
            seg_dst,
            capacity=capacity,
            n=n_new,
            n_rows=self.n_rows,
            n_data_rows=n_data_rows,
        )
        return WindowPlan(
            n=n_new,
            n_rows=self.n_rows,
            table_entries=table_entries,
            n_segments=int(seg_dst.shape[0]),
            n_data_rows=n_data_rows,
            n_edges=self.n_edges - int(del_src.size) + int(ins_src.size),
            wid=wid,
            local=local.reshape(self.local.shape),
            weight=weight.reshape(self.weight.shape),
            seg_end=seg_end.astype(np.int32),
            seg_first=seg_first,
            seg_perm=seg_perm.astype(np.int32, copy=False),
            dst_ptr=dst_ptr.astype(np.int32),
            seg_dst=seg_dst,
            row_offset=row_offset,
            fingerprint=fingerprint,
            lineage=(self.lineage + (self.fingerprint,))[-LINEAGE_DEPTH:],
        )

    def replace_rows(
        self,
        rows: np.ndarray,
        new_src: np.ndarray,
        new_dst: np.ndarray,
        new_w: np.ndarray,
        *,
        n: int | None = None,
        fingerprint: str,
    ) -> "WindowPlan":
        """Replace every out-edge of the given source peers with the
        supplied (normalized) edges — the natural delta unit, because
        row normalization makes any change to a peer's attestation
        rewrite that peer's whole out-row.  Deletes are recovered from
        the plan itself, so callers need no copy of the previous edge
        list.  Raises :class:`PlanDeltaError` like ``apply_delta``."""
        rows = np.unique(np.asarray(rows, np.int64))
        new_src = np.asarray(new_src, np.int64)
        if new_src.size and not np.isin(new_src, rows).all():
            raise PlanDeltaError("replacement edge outside the replaced rows")
        parts = [
            self._edges_of_segments(
                self._segments_of_rows(self._window_vreg_rows(int(w)))
            )
            for w in np.unique(rows >> _WIN_BITS).tolist()
        ]
        if parts:
            osrc = np.concatenate([p[0] for p in parts])
            odst = np.concatenate([p[1] for p in parts])
            m = np.isin(osrc.astype(np.int64), rows)
            deletes = (osrc[m], odst[m])
        else:
            deletes = None
        return self.apply_delta(
            (new_src, new_dst, new_w), deletes, n=n, fingerprint=fingerprint
        )


def graph_fingerprint(n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray) -> str:
    """Cheap identity for plan-reuse validation: exact (n, nnz) plus a
    sha1 over strided samples of the edge arrays (hashing all 600 MB at
    bench scale would cost a meaningful fraction of plan construction;
    a strided digest catches every realistic graph change)."""
    h = hashlib.sha1()
    h.update(np.asarray([n, src.shape[0]], np.int64).tobytes())
    stride = max(1, src.shape[0] // (1 << 20))
    for a in (src, dst, w):
        h.update(np.ascontiguousarray(a[::stride]).tobytes())
    return h.hexdigest()


def build_window_plan(
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray,
    *,
    n: int,
    spare_rows: int | None = None,
) -> WindowPlan:
    """One-time host construction of the fused-pipeline layout for a
    row-normalized, self-edge-free edge list.  ``spare_rows`` of
    zero-weight tail headroom (adaptive by default: one grid block or
    ~6% of the data rows) lets ``apply_delta`` absorb window growth —
    and segment-table fragmentation — across epochs without a rebuild
    or a device-shape change."""
    b = bucket_by_window(
        src, w, table_size=n, dst=dst, n_dst=n, spare_rows=spare_rows
    )
    # Device segment tables at quantized capacity: the inert pads give
    # apply_delta shape-stability headroom (no recompile per epoch).
    max_pad = (b["n_rows"] - b["n_data_rows"]) * ROW
    seg_end, seg_first, seg_perm, dst_ptr = _pad_segment_tables(
        b["seg_end"],
        b["seg_first"],
        b["seg_dst"],
        capacity=_segment_capacity(b["n_segments"], max_pad),
        n=n,
        n_rows=b["n_rows"],
        n_data_rows=b["n_data_rows"],
    )
    return WindowPlan(
        n=n,
        n_rows=b["n_rows"],
        table_entries=-(-n // WINDOW) * WINDOW,
        n_segments=b["n_segments"],
        n_data_rows=b["n_data_rows"],
        n_edges=int(src.shape[0]),
        wid=b["wid"],
        local=b["local"],
        weight=b["weight"],
        seg_end=seg_end,
        seg_first=seg_first,
        seg_perm=seg_perm,
        dst_ptr=dst_ptr,
        seg_dst=b["seg_dst"],
        row_offset=b["row_offset"],
        fingerprint=graph_fingerprint(n, src, dst, w),
        order=b["order"],
        out_pos=b["out_pos"],
    )


def try_plan_delta(
    plan: WindowPlan,
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray,
    *,
    n: int,
    rows: np.ndarray,
    fingerprint: str,
) -> WindowPlan | None:
    """Fold per-epoch churn into a cached plan: replace the out-edges of
    the hinted ``rows`` (every source peer whose attestation changed
    since the plan's graph — row normalization rewrites exactly those
    rows) with their slice of the new normalized edge list
    ``(src, dst, w)``.  Returns the delta-updated plan, or None when the
    delta cannot be applied (overflow, shrink), when it would not pay
    (churn spread over too many windows — past the measured crossover
    a full rebuild's vectorized counting sorts beat the per-window
    repack, PERF.md §11), or when it fails the edge-count tripwire (a
    stale/incomplete ``rows`` hint would stamp the new fingerprint
    onto a layout that doesn't encode the new graph — in that case the
    caller must rebuild).
    """
    rows = np.unique(np.asarray(rows, np.int64))
    if rows.size == 0:
        return None
    # Delta-vs-rebuild crossover: the repack loop costs ~constant per
    # touched window while the rebuild is one vectorized O(E) pass, so
    # window-spread churn (every window touched) runs ~5x SLOWER as a
    # delta.  The measured crossover sits near a quarter of the data
    # windows; the 64-window floor keeps small graphs (few windows
    # total, trivially all touched) on the delta path where the
    # absolute cost is noise.
    data_windows = max(1, int(np.count_nonzero(np.diff(plan.row_offset))))
    touched_windows = int(np.unique(rows >> _WIN_BITS).size)
    if touched_windows > max(64, data_windows // 4):
        return None
    mask = np.isin(src, rows.astype(src.dtype))
    try:
        new_plan = plan.replace_rows(
            rows, src[mask], dst[mask], w[mask], n=n, fingerprint=fingerprint
        )
    except PlanDeltaError:
        return None
    if new_plan.n_edges != src.shape[0]:
        # The hint missed a changed row: the delta edge count disagrees
        # with the target graph.  Never serve a mislabeled layout.
        return None
    return new_plan


def partition_delta(
    rows: np.ndarray | None,
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray,
    owner: np.ndarray,
    host: int,
) -> tuple[np.ndarray | None, np.ndarray, np.ndarray, np.ndarray]:
    """Clip a churn hint and a row-normalized edge list to one pod
    host's partition (``owner[i]`` = host owning source peer ``i``,
    from ``parallel.partition.HostPartition``).

    Edges are owned by their **source** peer, so a dirty row (one
    sender's rewritten out-edges) is dirty on exactly one host: the
    returned ``owned_rows`` feed :func:`try_plan_delta` against that
    host's *local* plan, and hosts owning none of the churn keep their
    plan verbatim — steady-state churn never forces a cross-host
    rebuild.  Returns ``(owned_rows, local_src, local_dst, local_w)``;
    ``owned_rows`` is None when the caller passed no hint (forcing
    fingerprint-only revalidation, same contract as the global path).
    """
    owner = np.asarray(owner)
    mask = owner[src] == host
    owned_rows = None
    if rows is not None:
        rows = np.unique(np.asarray(rows, np.int64))
        owned_rows = rows[owner[rows] == host]
    return owned_rows, src[mask], dst[mask], w[mask]


def bridge_partials_plain(
    hi: torch.Tensor,
    lo: torch.Tensor,
    seg_end: torch.Tensor,
    seg_first: torch.Tensor,
    seg_perm: torch.Tensor,
) -> torch.Tensor:
    """The reference's ``bridge_partials`` in plain PyTorch: run
    partials from the flattened row-prefix lanes at the bucket-order run
    ends, permuted into dst order.  The second half of
    ``prefix_bridge_plain``."""
    eh = hi.index_select(0, seg_end)
    el = lo.index_select(0, seg_end)
    zero = eh.new_zeros(1)
    prev_h = torch.where(seg_first, 0.0, torch.cat([zero, eh[:-1]]))
    prev_l = torch.where(seg_first, 0.0, torch.cat([zero, el[:-1]]))
    # Difference hi/lo lanes separately so the hi cancellation stays
    # exact (Sterbenz), matching rowsum_sorted's row differencing.
    partial = (eh - prev_h) + (el - prev_l)
    return partial.index_select(0, seg_perm)


def prefix_bridge_plain(
    slots: torch.Tensor,
    seg_end: torch.Tensor,
    seg_first: torch.Tensor,
    seg_perm: torch.Tensor,
) -> torch.Tensor:
    """The plain PyTorch version of ``prefix_bridge``: the reference's
    row prefix ``_ds_cumsum_axis1`` over the (n_rows, 1024) slots, then
    ``bridge_partials_plain`` on the flattened lanes.  Used for CPU
    tensors, and on the card only to check the kernel."""
    hi, lo = _ds_cumsum_axis1(slots)
    return bridge_partials_plain(hi.reshape(-1), lo.reshape(-1), seg_end, seg_first, seg_perm)


def row_run_ptr(seg_end: torch.Tensor, seg_first: torch.Tensor, n_rows: int) -> torch.Tensor:
    """``(n_rows + 1,)`` int32: ``row_run_ptr[r]`` is the first
    bucket-order run that ends in plan row ``r`` (the runs of row ``r``
    are ``row_run_ptr[r] : row_run_ptr[r + 1]``), on ``seg_end``'s device.

    Checks what ``prefix_bridge``'s kernel takes for granted and raises
    ``ValueError`` otherwise: every run ends inside the plan's
    ``n_rows * 1024`` slots, and every row's first run is run 0 or is
    flagged in ``seg_first`` (its start prefix is then an exact zero, so
    no row reads another's prefix).  Every plan meets both by
    construction.  The checks read three values on the host, so a
    converge calls this once, before its loop."""
    bounds = torch.arange(n_rows + 1, dtype=torch.int64, device=seg_end.device) * ROW
    ptr = torch.searchsorted(seg_end, bounds, out_int32=True)
    if int(ptr[0]) != 0 or int(ptr[-1]) != seg_end.shape[0]:
        raise ValueError(f"run ends lie outside the plan's {n_rows} rows of {ROW} slots")
    lead = ptr[:-1][ptr[:-1] < ptr[1:]]
    if not bool((seg_first[lead] | (lead == 0)).all()):
        raise ValueError("a row's first run is neither run 0 nor flagged in seg_first")
    return ptr


def _check_prefix_bridge_operands(slots, seg_end, seg_first, seg_perm, run_ptr) -> None:
    for name, a, dim, dtype in (
        ("slots", slots, 2, torch.float32),
        ("seg_end", seg_end, 1, torch.int32),
        ("seg_first", seg_first, 1, torch.bool),
        ("seg_perm", seg_perm, 1, torch.int32),
        ("row_run_ptr", run_ptr, 1, torch.int32),
    ):
        if a.dim() != dim:
            raise ValueError(f"prefix_bridge: {name} must be {dim}-D, got shape {tuple(a.shape)}")
        if a.dtype != dtype:
            raise TypeError(f"prefix_bridge: {name} must be {dtype}, got {a.dtype}")
    if slots.shape[1] != ROW:
        raise ValueError(f"prefix_bridge: slots must be {ROW} wide, got {slots.shape[1]}")
    for name, a in (("seg_first", seg_first), ("seg_perm", seg_perm)):
        if a.shape != seg_end.shape:
            raise ValueError(
                f"prefix_bridge: {name} has {a.shape[0]} runs, seg_end {seg_end.shape[0]}"
            )
    if run_ptr.shape[0] != slots.shape[0] + 1:
        raise ValueError(
            f"prefix_bridge: row_run_ptr must hold {slots.shape[0] + 1} pointers, "
            f"got {run_ptr.shape[0]}"
        )


def prefix_bridge(
    slots: torch.Tensor,
    seg_end: torch.Tensor,
    seg_first: torch.Tensor,
    seg_perm: torch.Tensor,
    run_ptr: torch.Tensor,
) -> torch.Tensor:
    """The gathered ``(n_rows, 1024)`` float32 plan slots reduced to
    dst-sorted per-(row, dst) run partials: each row's double-single
    prefix, the run partials at the bucket-order run ends (the previous
    run's end as each run's start prefix, an exact zero where the run
    is flagged in ``seg_first``), and the one ``seg_perm`` permutation
    into dst order.  ``seg_end``/``seg_perm`` are int32 and ``seg_first``
    bool, of one length; ``run_ptr`` is ``row_run_ptr(seg_end,
    seg_first, n_rows)``.  The kernel clamps every index it reads from
    these tables into range, so a stale ``run_ptr`` (another plan's)
    gives wrong partials, never an out-of-bounds access.

    On CUDA tensors this launches ``csrc/prefix_bridge.cu`` (each row's
    prefix kept on chip and read at its run ends, then the permutation)
    and adds one to ``prefix_bridge.launches``; a launch the card
    refuses raises.  On CPU tensors it is the plain version.  Mixed or
    other devices raise."""
    _check_prefix_bridge_operands(slots, seg_end, seg_first, seg_perm, run_ptr)
    device = _build.operand_device(
        "prefix_bridge", slots=slots, seg_end=seg_end, seg_first=seg_first,
        seg_perm=seg_perm, row_run_ptr=run_ptr,
    )
    if device.type == "cpu":
        return prefix_bridge_plain(slots, seg_end, seg_first, seg_perm)
    s = seg_end.shape[0]
    partial, out = slots.new_empty(s), slots.new_empty(s)
    if s:
        _build.launch(
            "prefix_bridge", device, slots.data_ptr(), seg_end.data_ptr(), seg_first.data_ptr(),
            seg_perm.data_ptr(), run_ptr.data_ptr(), partial.data_ptr(), out.data_ptr(),
            slots.shape[0], s,
        )
        prefix_bridge.launches += 1
    return out


#: Kernel launches in this process (the plain version does not count).
prefix_bridge.launches = 0  # type: ignore[attr-defined]


def windowed_ct(
    wid: torch.Tensor,
    local: torch.Tensor,
    weight: torch.Tensor,
    seg_end: torch.Tensor,
    seg_first: torch.Tensor,
    seg_perm: torch.Tensor,
    dst_ptr: torch.Tensor,
    t: torch.Tensor,
    *,
    n_rows: int,
    table_entries: int,
    run_ptr: torch.Tensor,
) -> torch.Tensor:
    """Dense Cᵀt over the plan's slot set — the fused pipeline minus
    damping: windowed gather, row prefix and bridge, row sums.
    ``run_ptr`` is ``row_run_ptr(seg_end, seg_first, n_rows)``, derived
    once a plan (it syncs with the host)."""
    n = t.shape[0]
    table = torch.nn.functional.pad(t, (0, table_entries - n))
    out = gather_windowed(wid, table, local, weight, n_rows=n_rows)
    partial = prefix_bridge(out.reshape(n_rows, ROW), seg_end, seg_first, seg_perm, run_ptr)
    return rowsum_sorted(partial, dst_ptr)


def power_step_windowed(
    wid: torch.Tensor,
    local: torch.Tensor,
    weight: torch.Tensor,
    seg_end: torch.Tensor,
    seg_first: torch.Tensor,
    seg_perm: torch.Tensor,
    dst_ptr: torch.Tensor,
    t: torch.Tensor,
    p: torch.Tensor,
    dangling: torch.Tensor,
    alpha: torch.Tensor,
    *,
    n_rows: int,
    table_entries: int,
    run_ptr: torch.Tensor,
) -> torch.Tensor:
    """One damped step of the fused pipeline: ``windowed_ct`` then the
    shared damping + dangling redistribution + L1 renorm."""
    ct = windowed_ct(
        wid, local, weight, seg_end, seg_first, seg_perm, dst_ptr, t,
        n_rows=n_rows, table_entries=table_entries, run_ptr=run_ptr,
    )
    return damp(ct, t, p, dangling, alpha)


def converge_windowed(
    wid: torch.Tensor,
    local: torch.Tensor,
    weight: torch.Tensor,
    seg_end: torch.Tensor,
    seg_first: torch.Tensor,
    seg_perm: torch.Tensor,
    dst_ptr: torch.Tensor,
    t0: torch.Tensor,
    p: torch.Tensor,
    dangling: torch.Tensor,
    *,
    n_rows: int,
    table_entries: int,
    alpha: torch.Tensor | float = 0.1,
    tol: float = 1e-6,
    max_iter: int = 50,
    record_residuals: bool = False,
) -> tuple:
    """Fused-pipeline analog of ``converge_csr`` on the same
    ``run_power_iteration`` loop: returns ``(t, iterations, residual)``
    plus the device residual history with ``record_residuals``.  The
    plan tensors come from ``WindowPlan.device_args``; ``t0`` is not
    written to.  The rows' run pointers are derived once, before the
    loop, so a ``tol <= 0`` loop makes no host sync."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=t0.device)
    run_ptr = row_run_ptr(seg_end, seg_first, n_rows)
    return run_power_iteration(
        lambda t: power_step_windowed(
            wid, local, weight, seg_end, seg_first, seg_perm, dst_ptr, t, p,
            dangling, alpha, n_rows=n_rows, table_entries=table_entries, run_ptr=run_ptr,
        ),
        t0,
        tol=tol,
        max_iter=max_iter,
        record_residuals=record_residuals,
    )
