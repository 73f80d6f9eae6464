#!/usr/bin/env python3
"""Drive the PyTorch port (``protocol_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
the windowed gather (K1) against its plain PyTorch version on the card,
runs the windowed EigenTrust convergence at the headline size (1M peers
/ 50M edges, 40 power iterations) through the port's entry points,
checks the result against the CSR formulation and the CSR formulation
against the COO one (``cuda-sparse``, bit for bit), holds the edge
gather-multiply of the CSR and COO steps (K9 ``gather_multiply``) at the
headline's and the 65,536-peer graph's operands, holds the step's
double-single prefix kernels (K5 ``ds_cumsum_rows``, K6
``compensated_scan``, which scans the block totals it reads from K5's
lanes), the row prefix and bridge (K7 ``prefix_bridge``) and the row
sums' pointer tail (K8 ``rowsum_tail``) against their plain versions at
the shapes the windowed and the CSR step give them (K7 also on the
65,536-peer plan, K5 also at the plan rows, which K7 now covers, K6
also at 1, 3 and 8,200 blocks and past its two depth thresholds, and K8
also at pointer counts about the end of a warp's tile), times
the earlier forms of K6 and K8 (``protocol_tpu_torch.bench.yardsticks``)
beside them and one empty launch, and holds the kernel route of the
windowed, CSR and COO steps against their plain route, bit for bit.
Then the card against the CPU, a churned epoch replay against a cold
converge, and BASELINE ladder configs 1-3 through ``native-cpu``,
``cuda-dense`` and ``cuda-sparse`` (``backends``).  Last it runs the
reference's gather/transpose probes (``protocol_tpu_torch.bench``) at
their own shapes, which hold the probe kernels K2-K4 against their plain
versions and library calls bit for bit, with event and trace times, K2
beside its earlier form; then K2 and K3 at their edge shapes
(``probe_edges``).

Every phase prints one JSON line.  Before the last line come the card's
``nvidia-smi`` name and power limit and one ``{"kernels": [...]}`` line
(per kernel: launches on its path — the windowed headline converge for
K1 and K5-K8, the CSR headline converge for K9, the probes phase for
K2-K4 — and on the main path, agreement with the plain version, its
time, the plain version's and the library call's times and the least
time the card could take).  The last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before that line.  Imports nothing of JAX
or of the ``protocol_tpu`` reference package.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent

HEADLINE = dict(n=1_000_000, nnz=50_000_000, seed=7, iters=40)
SMALL = dict(n=65_536, nnz=1_048_576, seed=0)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def main() -> None:
    import numpy as np
    import torch

    # -- 1. env ------------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    sys.path.insert(0, str(HERE))
    try:
        import protocol_tpu_torch
    except ImportError as exc:
        fail(f"the port package is not beside this script: {exc}")
    if pathlib.Path(protocol_tpu_torch.__file__).resolve().parent.parent != HERE:
        fail(f"protocol_tpu_torch was imported from {protocol_tpu_torch.__file__}, not {HERE}")
    from protocol_tpu_torch.bench import probe_fused_primitives as pfp
    from protocol_tpu_torch.bench import probe_mosaic_gather as pmg
    from protocol_tpu_torch.bench import yardsticks as ys
    from protocol_tpu_torch.bench._timing import (
        F32_OPS_PER_S, REPS, WARMUP, bound_by, bound_ms, kernel_vs_plain, same_bits, time_ms,
        trace_ms,
    )
    from protocol_tpu_torch.models.churn import churn_cohort_dims, sender_centric_churn
    from protocol_tpu_torch.models.graphs import erdos_renyi, scale_free
    from protocol_tpu_torch.ops import _build
    from protocol_tpu_torch.ops import dense as dn
    from protocol_tpu_torch.ops import gather_window as gw
    from protocol_tpu_torch.ops import sparse as sp
    from protocol_tpu_torch.trust.backend import get_backend
    from protocol_tpu_torch.trust.graph import TrustGraph

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    emit(
        "env", nvidia_smi=smi, device=kind, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0],
        host_cpus=os.cpu_count(),
    )

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    report = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in r["log"].splitlines() if "registers" in ln or "smem" in ln]
        for name, r in report.items()
    }
    emit("build", seconds=build_s, built=sorted(report), ptxas=ptxas)

    def prepared(n, nnz, seed):
        graph = scale_free(n, nnz, seed=seed)
        g = graph.drop_self_edges()
        w, dangling = g.row_normalized()
        g = TrustGraph(g.n, g.src, g.dst, w, graph.pre_trusted).sorted_by_dst()
        return graph, g, dangling, graph.pre_trust_vector()

    def k1_vs_plain(plan, args, x):
        """K1 against its plain version on one plan (a difference
        raises): max abs error, both times and the bound of the call."""
        table = torch.nn.functional.pad(x, (0, plan.table_entries - x.shape[0]))
        wid, local, weight = args[0], args[1], args[2]
        slots = plan.n_rows * gw.ROW
        res = kernel_vs_plain(
            lambda: gw.gather_windowed(wid, table, local, weight, n_rows=plan.n_rows),
            lambda: gw.gather_windowed_plain(wid, table, local, weight),
            wrapper=gw.gather_windowed,
            # local and weight read, out written; wid and the table once.
            nbytes=12 * slots + 4 * plan.n_rows + 4 * plan.table_entries,
            ops=slots,  # one multiply per slot
        )
        return dict(res, n_rows=plan.n_rows)

    def device_busy(fn, steps=20, launches=None):
        """Device time a call of ``fn`` by kernel name, in ms, from a
        ``torch.profiler`` trace over ``steps`` calls; with a dict
        ``launches``, also the kernels launched a call, by name."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
        by_name, counts = {}, {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
                counts[e.name] = counts.get(e.name, 0) + 1
        if launches is not None:
            launches.update({name: c / steps for name, c in counts.items()})
        return by_name

    # -- 3. kernel on a 65,536-peer plan -----------------------------------
    _, gs, _, _ = prepared(**SMALL)
    plan_s = gw.build_window_plan(gs.src, gs.dst, gs.weight, n=gs.n)
    x_s = np.random.default_rng(1).random(gs.n).astype(np.float32)
    res = k1_vs_plain(plan_s, plan_s.device_args(dev), torch.from_numpy(x_s / x_s.sum()).to(dev))
    emit("kernel", plan=f"{SMALL['n']}/{SMALL['nnz']}", **res)

    # -- 4. headline: 1M / 50M, 40 iterations ------------------------------
    graph, g, dangling, p = prepared(HEADLINE["n"], HEADLINE["nnz"], HEADLINE["seed"])
    t0 = time.perf_counter()
    plan = gw.build_window_plan(g.src, g.dst, g.weight, n=g.n)
    plan_seconds = time.perf_counter() - t0
    args = plan.device_args(dev)
    p_d = torch.from_numpy(p).to(dev)
    dang_d = torch.from_numpy(dangling.astype(np.float32)).to(dev)
    iters = HEADLINE["iters"]

    def run_windowed():
        t_init = torch.from_numpy(p).to(dev)
        t, _, _ = gw.converge_windowed(
            *args, t_init, p_d, dang_d, n_rows=plan.n_rows,
            table_entries=plan.table_entries, alpha=0.1, tol=0.0, max_iter=iters,
        )
        return t.cpu().numpy()

    run_windowed()  # warm-up: kernel load, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # Every kernel's count set to 0 just before the main path, read just after.
    wrappers = (
        gw.gather_windowed, sp.ds_cumsum_axis1, sp.block_total_scan, gw.prefix_bridge,
        sp.rowsum_tail, sp.gather_multiply, pmg.take_along_axis, pmg.transpose2d,
        pfp.gather_region,
    )

    def counted(fn):
        """``fn()``'s result, seconds and kernel launches: every count set
        to 0 just before the call and read just after."""
        for w in wrappers:
            w.launches = 0
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0, {w.__name__: w.launches for w in wrappers}

    scores, seconds, main_launches = counted(run_windowed)
    launches = main_launches["gather_windowed"]
    peak = torch.cuda.max_memory_allocated()
    total = float(scores.astype(np.float64).sum())

    src_d = torch.from_numpy(g.src).to(dev)
    ptr_d = torch.from_numpy(g.row_ptr_by_dst()).to(dev)
    w_d = torch.from_numpy(g.weight).to(dev)

    def run_csr():
        t, _, _ = sp.converge_csr(
            src_d, ptr_d, w_d, torch.from_numpy(p).to(dev), p_d, dang_d,
            alpha=0.1, tol=0.0, max_iter=iters,
        )
        return t.cpu().numpy()

    run_csr()
    torch.cuda.synchronize()
    csr_scores, csr_seconds, csr_launches = counted(run_csr)
    l1_csr = float(np.abs(scores.astype(np.float64) - csr_scores).sum())
    emit(
        "headline", peers=g.n, edges=g.nnz, iterations=iters, plan_seconds=plan_seconds,
        n_rows=plan.n_rows, n_segments=plan.n_segments, seg_capacity=plan.seg_capacity,
        compression=plan.compression, seconds=seconds, ms_per_iter=seconds / iters * 1e3,
        max_memory_allocated=peak, k1_launches=launches, launches=main_launches,
        sum_scores=total, csr_seconds=csr_seconds, csr_launches=csr_launches, l1_vs_csr=l1_csr,
    )
    # A windowed step runs K1 once, K7 once (the plan rows' prefix and the
    # bridge), K5 once (rowsum_sorted's blocks), K6 once (the block
    # totals' scan) and K8 once (the pointer tail); a CSR step K9 once
    # (the edge product), then K5, K6 and K8 once each.
    no_launch = dict.fromkeys((w.__name__ for w in wrappers), 0)
    expected = dict(
        no_launch, gather_windowed=iters, ds_cumsum_axis1=iters, block_total_scan=iters,
        prefix_bridge=iters, rowsum_tail=iters,
    )
    check(
        main_launches == expected,
        f"the {iters}-iteration converge launched {main_launches}, expected {expected}",
    )
    expected_csr = dict(
        no_launch, gather_multiply=iters, ds_cumsum_axis1=iters, block_total_scan=iters,
        rowsum_tail=iters,
    )
    check(
        csr_launches == expected_csr,
        f"the {iters}-iteration CSR converge launched {csr_launches}, expected {expected_csr}",
    )

    # cuda-sparse at the headline: the COO converge on the same dst-sorted
    # edges derives the same row pointers on the card, then runs the CSR
    # step, so its scores are the CSR converge's, bit for bit.
    dst_d = torch.from_numpy(g.dst).to(dev)

    def run_sparse():
        t, _, _ = sp.converge_sparse(
            src_d, dst_d, w_d, torch.from_numpy(p).to(dev), p_d, dang_d, n=g.n,
            alpha=0.1, tol=0.0, max_iter=iters,
        )
        return t.cpu().numpy()

    run_sparse()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sparse_scores, sparse_seconds, sparse_launches = counted(run_sparse)
    sparse_peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    via_backend = get_backend("cuda-sparse").converge(graph, alpha=0.1, tol=0.0, max_iter=iters)
    backend_seconds = time.perf_counter() - t0
    sparse_equal = {
        "converge_sparse": bool(np.array_equal(sparse_scores.view(np.uint32), csr_scores.view(np.uint32))),
        "backend": bool(np.array_equal(via_backend.scores, csr_scores.astype(np.float64))),
    }
    emit(
        "sparse_headline", peers=g.n, edges=g.nnz, iterations=iters, seconds=sparse_seconds,
        ms_per_iter=sparse_seconds / iters * 1e3, csr_seconds=csr_seconds,
        max_memory_allocated=sparse_peak, launches=sparse_launches,
        backend_seconds=backend_seconds, backend_iterations=via_backend.iterations,
        bit_equal_to_csr=sparse_equal,
    )
    check(all(sparse_equal.values()), f"cuda-sparse differs from cuda-csr at the headline: {sparse_equal}")
    check(
        sparse_launches == expected_csr,
        f"the {iters}-iteration COO converge launched {sparse_launches}, expected {expected_csr}",
    )
    del via_backend
    check(abs(total - 1.0) < 1e-3, f"scores sum to {total}")
    check(bool(np.isfinite(scores).all()) and scores.shape == (g.n,), "non-finite or mis-shaped scores")
    check(l1_csr <= 1e-5, f"windowed vs CSR L1 {l1_csr} > 1e-5")

    # K1 on the full plan.
    t_d = torch.from_numpy(scores.astype(np.float32)).to(dev)
    full = k1_vs_plain(plan, args, t_d)
    emit("kernel", plan=f"{HEADLINE['n']}/{HEADLINE['nnz']}", **full)
    table = torch.nn.functional.pad(t_d, (0, plan.table_entries - g.n))
    alpha = torch.tensor(0.1, device=dev)
    wid, local, weight, seg_end, seg_first, seg_perm, dst_ptr = args
    kw = dict(n_rows=plan.n_rows, table_entries=plan.table_entries)
    out = gw.gather_windowed(wid, table, local, weight, n_rows=plan.n_rows)
    slots = out.reshape(plan.n_rows, gw.ROW)
    t0 = time.perf_counter()
    run_ptr = gw.row_run_ptr(seg_end, seg_first, plan.n_rows)
    run_ptr_seconds = time.perf_counter() - t0
    part = gw.prefix_bridge(slots, seg_end, seg_first, seg_perm, run_ptr)
    ct = sp.rowsum_sorted(part, dst_ptr)
    contrib = sp._gather_multiply(w_d, t_d, src_d)

    def k9_vs_plain(w, x, src):
        """K9 against its plain version (a difference raises).  Bytes:
        src and w read and the product written (12 B an edge), the table
        read once; operations: one multiply an edge.  The trace time is
        the kernel's device time without the launch."""
        e, n = src.shape[0], x.shape[0]
        nbytes = 12 * e + 4 * n
        res = kernel_vs_plain(
            lambda: sp.gather_multiply(w, x, src), lambda: sp._gather_multiply(w, x, src),
            wrapper=sp.gather_multiply, nbytes=nbytes, ops=e,
        )
        return dict(res, shape=[e], table=n, bound_by=bound_by(nbytes, e),
                    trace_ms=trace_ms(lambda: sp.gather_multiply(w, x, src)))

    # K9 at the CSR step's headline operands and at the 65,536-peer graph's.
    x_small = torch.from_numpy(x_s / x_s.sum()).to(dev)
    k9 = {
        "headline": k9_vs_plain(w_d, t_d, src_d),
        "small": k9_vs_plain(
            torch.from_numpy(gs.weight).to(dev), x_small, torch.from_numpy(gs.src).to(dev)
        ),
    }
    for where, rec in k9.items():
        emit("kernel", kernel="gather_multiply", input=where, **rec)
    # Slices at an odd element offset (4-byte aligned only) and an empty
    # edge list go through the same kernel, bit for bit.
    check(
        same_bits(sp.gather_multiply(w_d[1:], t_d, src_d[1:]),
                  sp._gather_multiply(w_d[1:], t_d, src_d[1:])),
        "gather_multiply differs from its plain version on slices at an odd offset",
    )
    check(sp.gather_multiply(w_d[:0], t_d, src_d[:0]).shape == (0,), "gather_multiply of no edges")
    del x_small

    # K5 and K6 at the shapes the two steps give them, bit for bit.
    block = sp._ROWSUM_BLOCK

    def k5_vs_plain(x, width=None):
        """K5 on the 2-D ``x``, or, with ``width``, on the unpadded 1-D
        ``x`` (rowsum_sorted's blocks) against the plain prefix of the
        zero-padded copy."""
        if width is None:
            rows, b = x.shape
            kernel, plain = lambda: sp.ds_cumsum_axis1(x), lambda: sp._ds_cumsum_axis1(x)
        else:
            rows, b = -(-x.shape[0] // width), width
            kernel = lambda: sp.ds_cumsum_axis1(x, width)  # noqa: E731
            plain = lambda: sp._ds_cumsum_axis1(sp._blocks(x, width))  # noqa: E731
        levels = b.bit_length() - 1
        # x read, hi and lo written; ds_add: 11 adds a level.
        nbytes, ops = 4 * x.numel() + 8 * rows * b, 11 * levels * rows * b
        res = kernel_vs_plain(kernel, plain, wrapper=sp.ds_cumsum_axis1, nbytes=nbytes, ops=ops)
        return dict(res, shape=[rows, b], elements=x.numel(), ops=ops,
                    bound_by=bound_by(nbytes, ops))

    def scan_ops(n):
        """Float adds of the block-total scan: 8 a TwoSum combine, 2 an
        interleaved output (its + 0.0 on both lanes), level by level."""
        sizes, m = [], n
        while m >= 2:
            sizes.append(m)
            m //= 2
        combines = sum(m // 2 + (m + 1) // 2 - 1 for m in sizes)
        return 8 * combines + 2 * sum(sizes)

    def k6_vs_plain(bh, bl):
        """K6 on prefix lanes ``(bh, bl)``: the block totals read from
        their last column, then scanned.  Bytes: 4 B of each lane a
        block read, hi and lo written; operations: the totals' adds and
        the scan's.  Beside it, the earlier form (the totals' PyTorch
        add, then the device-memory pyramid kernel), held bit-equal too."""
        n = bh.shape[0]
        nbytes, ops = 16 * n, n + scan_ops(n)
        res = kernel_vs_plain(
            lambda: sp.block_total_scan(bh, bl), lambda: sp._block_total_scan(bh, bl),
            wrapper=sp.block_total_scan, nbytes=nbytes, ops=ops,
        )
        earlier = lambda: ys.compensated_scan_global(bh[:, -1] + bl[:, -1])  # noqa: E731
        totals = bh[:, -1] + bl[:, -1]
        check(
            all(same_bits(a, b) for a, b in zip(earlier(), sp._block_total_scan(bh, bl))),
            f"the earlier block-total scan differs from the plain version at {n} blocks",
        )
        return dict(
            res, shape=[n], ops=ops, bound_by=bound_by(nbytes, ops), earlier_ms=time_ms(earlier),
            earlier_kernel_ms=time_ms(lambda: ys.compensated_scan_global(totals)),
        )

    def k8_vs_plain(wh, wl, hi_in, lo_in, ptr):
        """K8 on one step's blocks and pointers.  Bytes: the n + 1
        pointers and the n outputs (4 B each), both lanes at each
        distinct pointer (8 B), the block scans (8 B a block); counted
        in 32-byte sectors, each distinct lane sector read on both lanes.
        Beside it, the earlier form (one thread a pointer), held
        bit-equal too."""
        n = ptr.shape[0] - 1
        i = ptr.long() - 1
        i = i[i >= 0]
        fixed = 4 * (n + 1) + 4 * n + 8 * hi_in.shape[0]
        nbytes = fixed + 8 * int(torch.unique(i).numel())
        sector_bytes = fixed + 2 * 32 * int(torch.unique(i // 8).numel())
        res = kernel_vs_plain(
            lambda: sp.rowsum_tail(wh, wl, hi_in, lo_in, ptr),
            lambda: sp._rowsum_tail(wh, wl, hi_in, lo_in, ptr),
            wrapper=sp.rowsum_tail, nbytes=nbytes,
        )
        earlier = lambda: ys.rowsum_tail_scalar(wh, wl, hi_in, lo_in, ptr)  # noqa: E731
        check(
            same_bits(earlier(), sp._rowsum_tail(wh, wl, hi_in, lo_in, ptr)),
            f"the earlier pointer tail differs from the plain version at {n} pointers",
        )
        return dict(res, shape=list(wh.shape), pointers=n + 1, bound_by="bytes",
                    bytes_sectors=sector_bytes, bound_ms_sectors=bound_ms(sector_bytes),
                    earlier_ms=time_ms(earlier))

    # One empty launch: the floor under the small kernels' times.
    launch_floor_ms = time_ms(lambda: ys.empty_kernel(dev))
    emit("launch_floor", ms=launch_floor_ms, nvidia_smi=smi)

    k5, k6, k8, tails = {}, {}, {}, {}
    for where, x, width in (
        ("plan_rows", slots, None), ("windowed_blocks", part, block), ("csr_blocks", contrib, block),
    ):
        k5[where] = k5_vs_plain(x, width)
        emit("kernel", kernel="ds_cumsum_rows", input=where, **k5[where])
        if where != "plan_rows":
            bh, bl = sp.ds_cumsum_axis1(x, width)
            k6[where] = k6_vs_plain(bh, bl)
            emit("kernel", kernel="compensated_scan", input=where, **k6[where])
            tails[where] = (bh, bl, *sp.block_total_scan(bh, bl))
            k8[where] = k8_vs_plain(*tails[where], dst_ptr if where == "windowed_blocks" else ptr_d)
            emit("kernel", kernel="rowsum_tail", input=where, **k8[where])
            del bh, bl
    # K6 at the recursion's smallest cases, one block past 1024 chunks of
    # eight, and past the two depth thresholds (4,097 * 8 and 4,097 * 64
    # blocks), on seeded random lanes of 4-element blocks.
    gen = torch.Generator(device=dev)
    for n_blocks in (1, 3, 1025 * 8, 40_000, 300_000):
        gen.manual_seed(n_blocks)
        lh = torch.randn((n_blocks, 4), generator=gen, device=dev) * 1e3
        ll = torch.randn((n_blocks, 4), generator=gen, device=dev) * 1e-5
        k6[f"blocks_{n_blocks}"] = k6_vs_plain(lh, ll)
        emit("kernel", kernel="compensated_scan", input=f"blocks_{n_blocks}", **k6[f"blocks_{n_blocks}"])
        del lh, ll
    # K8 where the pointer count meets the end of a warp's tile of 128:
    # evenly spread pointers over the CSR step's blocks, bit for bit.
    k8_counts = (2, 3, 5, 128, 129, 130, 131, 4002)
    for n_ptr in k8_counts:
        few = torch.linspace(0, contrib.shape[0], n_ptr, device=dev).round().int()
        check(
            same_bits(sp.rowsum_tail(*tails["csr_blocks"], few),
                      sp._rowsum_tail(*tails["csr_blocks"], few)),
            f"rowsum_tail differs from its plain version at {n_ptr} pointers",
        )
    emit("kernel_edges", kernel="rowsum_tail", pointer_counts=list(k8_counts), same_bits=True)

    # K7 at the headline's and the 65k plan's slots and run tables.
    def k7_smem_bytes(rows_with_runs, runs, unflagged):
        """Bytes prefix_bridge.cu moves through shared memory: per row
        with runs, at each level every thread's (hi, lo) float4 pair
        written and its partner's read (64 B a thread), then the row's
        final prefix (8 KB); per run both prefixes at its end, and at the
        previous run's end where the run is not flagged."""
        threads, levels = gw.ROW // 4, gw.ROW.bit_length() - 1
        per_row = levels * threads * 64 + 8 * gw.ROW
        return rows_with_runs * per_row + 8 * runs + 8 * unflagged

    def k7_vs_plain(n_rows, slots, seg_end, seg_first, seg_perm, run_ptr):
        """K7 against its plain version (a difference raises).  Bytes:
        the slots of the rows with runs (no other row's prefix reaches
        the output), seg_end, seg_perm and out 4 B a run, seg_first 1 B,
        the row pointers; operations: ds_add's 11 adds a slot a level
        over those rows, 3 a run."""
        runs = seg_end.shape[0]
        rows_with_runs = int((run_ptr[1:] > run_ptr[:-1]).sum())
        unflagged = int((~seg_first).sum()) - int(runs > 0 and not bool(seg_first[0]))
        levels = gw.ROW.bit_length() - 1
        nbytes = 4 * rows_with_runs * gw.ROW + 13 * runs + 4 * (n_rows + 1)
        ops = 11 * levels * rows_with_runs * gw.ROW + 3 * runs
        res = kernel_vs_plain(
            lambda: gw.prefix_bridge(slots, seg_end, seg_first, seg_perm, run_ptr),
            lambda: gw.prefix_bridge_plain(slots, seg_end, seg_first, seg_perm),
            wrapper=gw.prefix_bridge, nbytes=nbytes, ops=ops,
        )
        smem = k7_smem_bytes(rows_with_runs, runs, unflagged)
        try:
            launch_ms = device_busy(
                lambda: gw.prefix_bridge(slots, seg_end, seg_first, seg_perm, run_ptr)
            )
        except Exception as exc:  # noqa: BLE001 - reported, not a check
            launch_ms = {"not measured": repr(exc)}
        return dict(
            res, shape=[n_rows, gw.ROW], runs=runs, rows_with_runs=rows_with_runs, ops=ops,
            bound_by=bound_by(nbytes, ops),
            # Adds issue at one a lane a clock, half the fused multiply-add rate.
            add_issue_ms=2 * ops / F32_OPS_PER_S * 1e3,
            smem_bytes=smem, smem_ms_at_28_TBps=smem / 28e12 * 1e3, launch_ms=launch_ms,
        )

    k7 = {"headline": k7_vs_plain(plan.n_rows, slots, seg_end, seg_first, seg_perm, run_ptr)}
    emit("kernel", kernel="prefix_bridge", input="headline", **k7["headline"])
    args_s = plan_s.device_args(dev)
    table_s = torch.nn.functional.pad(
        torch.from_numpy(x_s / x_s.sum()).to(dev), (0, plan_s.table_entries - gs.n)
    )
    slots_s = gw.gather_windowed(
        args_s[0], table_s, args_s[1], args_s[2], n_rows=plan_s.n_rows
    ).reshape(plan_s.n_rows, gw.ROW)
    k7["small"] = k7_vs_plain(
        plan_s.n_rows, slots_s, *args_s[3:6], gw.row_run_ptr(args_s[3], args_s[4], plan_s.n_rows)
    )
    emit("kernel", kernel="prefix_bridge", input=f"{SMALL['n']}/{SMALL['nnz']}", **k7["small"])
    del args_s, table_s, slots_s

    # The card refuses what the kernels do not take, and the wrapper says so.
    odd = torch.zeros(4, 512, device=dev)
    try:
        sp.ds_cumsum_axis1(odd)
        fail("ds_cumsum_axis1 took a 512-wide row on the card")
    except ValueError:
        pass
    try:
        _build.launch(
            "ds_cumsum_rows", dev, odd.data_ptr(), odd.data_ptr(), odd.data_ptr(), 4, 512, 4 * 512
        )
        fail("a ds_cumsum_rows launch the kernel refused did not raise")
    except RuntimeError:
        pass
    del odd
    lane = torch.zeros(1, block, device=dev)
    one = torch.zeros(1, device=dev)
    try:
        sp.rowsum_tail(lane, lane, one, one, torch.zeros(2, dtype=torch.int64, device=dev))
        fail("rowsum_tail took int64 row pointers on the card")
    except TypeError:
        pass
    try:
        sp.block_total_scan(lane, lane[:, :4].contiguous())
        fail("block_total_scan took lanes of two shapes on the card")
    except ValueError:
        pass
    idx = torch.zeros(1, dtype=torch.int32, device=dev)
    ptr2 = torch.zeros(2, dtype=torch.int32, device=dev)
    row = torch.zeros(1, gw.ROW, device=dev)
    try:
        gw.prefix_bridge(row, idx, one, idx, ptr2)
        fail("prefix_bridge took a float seg_first on the card")
    except TypeError:
        pass
    try:
        gw.prefix_bridge(lane, idx, idx.bool(), idx, ptr2)
        fail(f"prefix_bridge took {block}-wide slots on the card")
    except ValueError:
        pass
    del lane, one, idx, ptr2, row

    # The kernel route of both steps against their plain route.
    def windowed_step_plain(t):
        tab = torch.nn.functional.pad(t, (0, plan.table_entries - g.n))
        o = gw.gather_windowed_plain(wid, tab, local, weight)
        h, l = sp._ds_cumsum_axis1(o.reshape(plan.n_rows, gw.ROW))
        q = gw.bridge_partials_plain(h.reshape(-1), l.reshape(-1), seg_end, seg_first, seg_perm)
        return sp.damp(sp.rowsum_sorted_plain(q, dst_ptr), t, p_d, dang_d, alpha)

    def csr_step_plain(t):
        c = sp._gather_multiply(w_d, t, src_d)
        return sp.damp(sp.rowsum_sorted_plain(c, ptr_d), t, p_d, dang_d, alpha)

    def windowed_step():
        return gw.power_step_windowed(*args, t_d, p_d, dang_d, alpha, run_ptr=run_ptr, **kw)

    def csr_step():
        return sp.power_step_csr(src_d, ptr_d, w_d, t_d, p_d, dang_d, alpha)

    def coo_step():
        return sp.power_step_coo(src_d, dst_d, w_d, t_d, p_d, dang_d, alpha, n=g.n)

    routes = {
        "windowed": same_bits(windowed_step(), windowed_step_plain(t_d)),
        "csr": same_bits(csr_step(), csr_step_plain(t_d)),
        "coo": same_bits(coo_step(), csr_step_plain(t_d)),
    }
    emit("route_equality", **routes)
    check(all(routes.values()), f"kernel route differs from the plain route: {routes}")

    # The step pass by pass: the kernel route, and the plain passes beside it.
    step_fns = {
        "prefix_bridge": lambda: gw.prefix_bridge(slots, seg_end, seg_first, seg_perm, run_ptr),
        "prefix_bridge_plain": lambda: gw.prefix_bridge_plain(slots, seg_end, seg_first, seg_perm),
        "block_total_scan": lambda: sp.block_total_scan(*tails["windowed_blocks"][:2]),
        "block_total_scan_plain": lambda: sp._block_total_scan(*tails["windowed_blocks"][:2]),
        "rowsum_tail": lambda: sp.rowsum_tail(*tails["windowed_blocks"], dst_ptr),
        "rowsum_tail_plain": lambda: sp._rowsum_tail(*tails["windowed_blocks"], dst_ptr),
        "rowsum_sorted": lambda: sp.rowsum_sorted(part, dst_ptr),
        "rowsum_sorted_plain": lambda: sp.rowsum_sorted_plain(part, dst_ptr),
        "epilogue": lambda: sp.damp(ct, t_d, p_d, dang_d, alpha),
        "whole_step": windowed_step,
        "whole_step_plain": lambda: windowed_step_plain(t_d),
        # The CSR step's two passes (ops/sparse.py::power_step_csr), beside K1.
        "csr_gather_multiply": lambda: sp.gather_multiply(w_d, t_d, src_d),
        "csr_gather_multiply_plain": lambda: sp._gather_multiply(w_d, t_d, src_d),
        "csr_block_total_scan": lambda: sp.block_total_scan(*tails["csr_blocks"][:2]),
        "csr_rowsum_tail": lambda: sp.rowsum_tail(*tails["csr_blocks"], ptr_d),
        "csr_rowsum_tail_plain": lambda: sp._rowsum_tail(*tails["csr_blocks"], ptr_d),
        "csr_rowsum_sorted": lambda: sp.rowsum_sorted(contrib, ptr_d),
        "csr_rowsum_sorted_plain": lambda: sp.rowsum_sorted_plain(contrib, ptr_d),
        "csr_whole_step": csr_step,
        "csr_whole_step_plain": lambda: csr_step_plain(t_d),
        # The COO step: its dst segments (a host read of the order check),
        # then the CSR step.
        "coo_whole_step": coo_step,
    }
    passes = {"gather_k1": full["ms"]}
    passes.update({name: time_ms(fn, reps=10) for name, fn in step_fns.items()})
    # Once a converge, before its loop, with three host reads: outside the step.
    passes["row_run_ptr_once_a_converge"] = time_ms(
        lambda: gw.row_run_ptr(seg_end, seg_first, plan.n_rows), reps=10
    )
    passes["row_run_ptr_host_seconds"] = run_ptr_seconds
    emit("step_passes_ms", **passes)

    # Device busy time a step, from a profiler trace, beside the converges'
    # unprofiled wall time an iteration: 1 - busy / wall is the device's idle
    # share.  A measurement, not a check: where the trace holds no device
    # time, or the profiler fails, the line says "not measured".  Where it
    # does, the checks: the step's rowsum_sorted launches K5, K6 and K8 once
    # each and nothing else (K6 reads the block totals from the lanes, so no
    # PyTorch add builds them), and the CSR step launches K9 once, the
    # windowed step never.
    profiles = {}
    rowsum_kernels = ("ds_cumsum_rows_kernel", "compensated_scan_kernel", "rowsum_tail_kernel")
    for name, fn, wall_ms, rowsum in (
        ("windowed", windowed_step, seconds / iters * 1e3, lambda: sp.rowsum_sorted(part, dst_ptr)),
        ("csr", csr_step, csr_seconds / iters * 1e3, lambda: sp.rowsum_sorted(contrib, ptr_d)),
    ):
        step_launches, rowsum_launches = {}, {}
        try:
            by_name = device_busy(fn, launches=step_launches)
            device_busy(rowsum, launches=rowsum_launches)
        except Exception as exc:  # noqa: BLE001 - reported, not a check
            profiles[name] = {"busy_ms": "not measured", "error": repr(exc)}
            continue
        if not by_name:
            profiles[name] = {"busy_ms": "not measured", "error": "no device events in the trace"}
            continue
        busy = sum(by_name.values())
        k9_a_step = sum(c for kn, c in step_launches.items() if "gather_multiply_kernel" in kn)
        profiles[name] = {
            "busy_ms": busy, "wall_ms_per_iter": wall_ms, "idle_share": 1.0 - busy / wall_ms,
            "top_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12]),
            "kernels_a_step": sum(step_launches.values()),
            "gather_multiply_a_step": k9_a_step,
            "rowsum_sorted_kernels": rowsum_launches,
        }
        check(
            k9_a_step == (1.0 if name == "csr" else 0.0),
            f"the {name} step launched gather_multiply {k9_a_step} times a step",
        )
        check(
            sorted(rowsum_launches.values()) == [1.0, 1.0, 1.0]
            and all(any(k in kn for kn in rowsum_launches) for k in rowsum_kernels),
            f"the {name} step's rowsum_sorted launched {rowsum_launches}, not K5, K6 and K8 once each",
        )
    emit("step_profile", **profiles)
    del out, slots, part, ct, step_fns, src_d, ptr_d, w_d, dst_d, contrib, tails, run_ptr

    def step_entry(name, wrapper, source, replaces, runs, main, **more):
        """A ``kernels`` entry for a kernel of the step: the main path's
        input (``main``) for the times, every input's measurement under
        ``shapes``.  No one PyTorch call computes any of them."""
        extra = {
            k: runs[main][k]
            for k in ("bound_ms_sectors", "earlier_ms", "earlier_kernel_ms")
            if k in runs[main]
        }
        return {
            "name": name,
            "wrapper": wrapper,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "path": "headline",
            "launches": main_launches[wrapper],
            "main_path_launches": main_launches[wrapper],
            "csr_path_launches": csr_launches[wrapper],
            "sparse_path_launches": sparse_launches[wrapper],
            "shape": runs[main]["shape"],
            "max_abs_err": max(r["max_abs_err"] for r in runs.values()),
            "ms": runs[main]["ms"],
            "plain_ms": runs[main]["plain_ms"],
            "bound_ms": runs[main]["bound_ms"],
            "bound_by": runs[main]["bound_by"],
            "library_ms": None,
            **extra,
            **more,
            "shapes": {
                where: {k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bytes",
                                          "bound_ms_sectors", "earlier_ms", "max_abs_err")
                        if k in r}
                for where, r in runs.items()
            },
        }

    kernels = [
        {
            "name": "gather_window",
            "route": "cuda",
            "source": "protocol_tpu_torch/ops/csrc/gather_window.cu",
            "replaces": "protocol_tpu/ops/gather_window.py:318",
            "path": "headline",
            "launches": launches,
            "main_path_launches": launches,
            "max_abs_err": full["max_abs_err"],
            "ms": full["ms"],
            "plain_ms": full["plain_ms"],
            "bound_ms": full["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        },
        step_entry("ds_cumsum_rows", "ds_cumsum_axis1",
                   "protocol_tpu_torch/ops/csrc/ds_cumsum_rows.cu",
                   "protocol_tpu/ops/sparse.py:80", k5, "windowed_blocks"),
        # K6 and K8 beside their earlier forms (bench/yardsticks.py) and
        # one empty launch, all timed in this run.
        step_entry("compensated_scan", "block_total_scan",
                   "protocol_tpu_torch/ops/csrc/compensated_scan.cu",
                   "protocol_tpu/ops/sparse.py:41 + :120", k6, "windowed_blocks",
                   launch_floor_ms=launch_floor_ms),
        # K7 replaced K5's launch over the plan rows and a two-pass bridge
        # kernel; the first is still measured above, on the same slots.
        step_entry("prefix_bridge", "prefix_bridge",
                   "protocol_tpu_torch/ops/csrc/prefix_bridge.cu",
                   "protocol_tpu/ops/sparse.py:80 + protocol_tpu/ops/gather_window.py:1007",
                   k7, "headline", earlier_ms={"ds_cumsum_rows_plan_rows": k5["plan_rows"]["ms"]}),
        step_entry("rowsum_tail", "rowsum_tail",
                   "protocol_tpu_torch/ops/csrc/rowsum_tail.cu",
                   "protocol_tpu/ops/sparse.py:94", k8, "windowed_blocks",
                   launch_floor_ms=launch_floor_ms),
    ]

    # -- 5. card vs CPU at 65,536 peers ------------------------------------
    g_small = scale_free(SMALL["n"], SMALL["nnz"], seed=SMALL["seed"])
    kw5 = dict(alpha=0.1, tol=1e-6, max_iter=60)
    step_wrappers = (
        gw.gather_windowed, sp.ds_cumsum_axis1, sp.block_total_scan, gw.prefix_bridge,
        sp.rowsum_tail,
    )
    before = {w.__name__: w.launches for w in step_wrappers}
    on_card = get_backend("cuda-windowed").converge(g_small, **kw5)
    card_launches = {w.__name__: w.launches - before[w.__name__] for w in step_wrappers}
    on_cpu = get_backend("cuda-windowed", device="cpu").converge(g_small, **kw5)
    l1_cpu = float(np.abs(on_card.scores - on_cpu.scores).sum())
    emit(
        "card_vs_cpu", iterations_card=on_card.iterations, iterations_cpu=on_cpu.iterations,
        l1=l1_cpu, k1_launches=card_launches["gather_windowed"], launches=card_launches,
    )
    check(on_card.iterations == on_cpu.iterations, "card and CPU ran different iteration counts")
    check(l1_cpu <= 1e-6, f"card vs CPU L1 {l1_cpu} > 1e-6")
    it = on_card.iterations
    check(
        card_launches == dict(
            gather_windowed=it, ds_cumsum_axis1=it, block_total_scan=it,
            prefix_bridge=it, rowsum_tail=it,
        ),
        f"the card converge's {it} iterations launched {card_launches}",
    )

    # -- 6. epochs: cold + churned epochs at 1% churn ----------------------
    rng = np.random.default_rng(HEADLINE["seed"])
    cur = graph.drop_self_edges()
    del graph, g, plan, args
    kw6 = dict(alpha=0.1, tol=1e-6, max_iter=60)
    b = get_backend("cuda-windowed")
    w, _ = cur.row_normalized()
    t0 = time.perf_counter()
    b.plan = gw.build_window_plan(cur.src, cur.dst, w, n=cur.n)
    epoch_plan_seconds = time.perf_counter() - t0
    per_epoch = []
    cohort, deg = churn_cohort_dims(cur, 0.01)
    ep_scores = None
    for epoch in range(3):
        if epoch:
            rows, cur, _ = sender_centric_churn(rng, cur, cohort_size=cohort, deg=deg)
            b.delta_rows = rows
        before = dict(b.plan_outcomes)
        t0 = time.perf_counter()
        res = b.converge(cur, t0=ep_scores, **kw6)
        dt = time.perf_counter() - t0
        outcome = [k for k in b.plan_outcomes if b.plan_outcomes[k] != before[k]]
        ep_scores = res.scores
        per_epoch.append(
            {"epoch": epoch, "seconds": dt, "iterations": res.iterations, "plan": outcome}
        )
    cold = get_backend("cuda-windowed").converge(cur, **kw6)
    warm_vs_cold = float(np.abs(ep_scores - cold.scores).sum())
    emit(
        "epochs", churn=0.01, plan_seconds=epoch_plan_seconds, per_epoch=per_epoch,
        plan_outcomes=b.plan_outcomes, cold_iterations=cold.iterations,
        warm_vs_cold_l1=warm_vs_cold,
    )
    check(b.plan_outcomes["delta"] >= 1, "no churned epoch took the plan-delta path")
    check(warm_vs_cold <= 1e-4, f"warm vs cold L1 {warm_vs_cold} > 1e-4")
    del b, cold, cur

    # -- 7. backends: BASELINE ladder configs 1-3 (bench.py:410-449) --------
    ladder = {}
    # Config 1: the 5-peer bootstrap set scoring each other alike, exact.
    ops1 = np.full((5, 5), 200.0, np.float32)
    np.fill_diagonal(ops1, 0.0)
    t0 = time.perf_counter()
    res1 = get_backend("native-cpu").converge(
        TrustGraph.from_dense(ops1), alpha=0.0, tol=0.0, max_iter=10
    )
    ladder["1-native-cpu-5"] = dict(
        seconds=time.perf_counter() - t0, iterations=res1.iterations,
        max_dev_from_uniform=float(np.abs(res1.scores - 0.2).max()),
    )
    check(res1.iterations == 10 and np.allclose(res1.scores, 0.2, atol=1e-12),
          f"native-cpu on the uniform 5-peer set gave {res1.scores}")
    # Configs 2 and 3 through cuda-dense and cuda-sparse, each held against
    # cuda-csr on the same graph at the reference's cross-backend tolerance.
    kw7 = dict(alpha=0.1, tol=0.0, max_iter=40)
    for key, name, make in (
        ("2-cuda-dense-10k", "cuda-dense", lambda: erdos_renyi(10_000, avg_degree=100.0, seed=11)),
        ("3-cuda-sparse-100k", "cuda-sparse", lambda: scale_free(100_000, 2_000_000, seed=13)),
    ):
        gk = make()
        b = get_backend(name)
        b.converge(gk, **kw7)  # warm-up: kernel load, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res, secs, k_launches = counted(lambda: b.converge(gk, **kw7))
        ref = get_backend("cuda-csr").converge(gk, **kw7)
        ladder[key] = dict(
            peers=gk.n, edges=gk.nnz, seconds=secs, iterations=res.iterations,
            max_memory_allocated=torch.cuda.max_memory_allocated(), launches=k_launches,
            max_abs_vs_csr=float(np.abs(res.scores - ref.scores).max()),
            bit_equal_to_csr=bool(np.array_equal(res.scores, ref.scores)),
        )
        check(res.iterations == 40 and bool(np.isfinite(res.scores).all()),
              f"{name} ran {res.iterations} iterations or gave non-finite scores")
        check(np.allclose(res.scores, ref.scores, rtol=1e-3, atol=1e-8),
              f"{name} differs from cuda-csr beyond rtol 1e-3, atol 1e-8")
        del gk, b, res, ref
    # The dense steps are matrix-vector products, which cuBLAS runs without
    # TF32: a converge with TF32 allowed equals one without, bit for bit.
    gen.manual_seed(11)
    m = torch.rand((10_000, 10_000), generator=gen, device=dev)
    m /= m.sum(dim=0, keepdim=True)
    s0 = torch.full((10_000,), 1e-4, device=dev)
    tf32_was = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        no_tf32 = dn.converge_dense(m, s0, 40)
        torch.backends.cuda.matmul.allow_tf32 = True
        with_tf32 = dn.converge_dense(m, s0, 40)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_was
    ladder["dense_tf32_allowed_bit_equal"] = same_bits(no_tf32, with_tf32)
    emit("backends", nvidia_smi=smi, **ladder)
    check(ladder["dense_tf32_allowed_bit_equal"], "converge_dense changed when TF32 was allowed")
    del m, s0, no_tf32, with_tf32

    # -- 8. probes: K2-K4 at the reference probes' shapes ------------------
    # Each run() holds every kernel launch against its plain version (and
    # its library call, where there is one) bit for bit and raises on a
    # difference; each measured shape launches its kernel 1 + WARMUP + REPS
    # times.
    probe_kernels = {
        "take_along_axis": (pmg.take_along_axis, "protocol_tpu_torch/ops/csrc/take_along_axis.cu",
                            "bench/probe_mosaic_gather.py:75"),
        "transpose2d": (pmg.transpose2d, "protocol_tpu_torch/ops/csrc/transpose2d.cu",
                        "bench/probe_mosaic_gather.py:107"),
        "gather_region": (pfp.gather_region, "protocol_tpu_torch/ops/csrc/gather_region.cu",
                          "bench/probe_fused_primitives.py:93"),
    }
    for w, _, _ in probe_kernels.values():
        w.launches = 0
    t0 = time.perf_counter()
    records = pmg.run() + pfp.run()
    probe_seconds = time.perf_counter() - t0
    probe_launches = {name: w.launches for name, (w, _, _) in probe_kernels.items()}
    for rec in records:
        emit("probe", **rec)
    # K2 and K3 records also count the launches of their traces
    # (``launches_total``); ``launches`` stays the timed comparison's.
    per_shape = 1 + WARMUP + REPS
    for name, (_, source, replaces) in probe_kernels.items():
        shapes = [r for r in records if r.get("kernel") == name]
        check(bool(shapes), f"the probes measured no shape of {name}")
        check(all(r["launches"] == per_shape for r in shapes),
              f"{name}'s timed comparisons did not launch it {per_shape} times each")
        made = sum(r.get("launches_total", per_shape) for r in shapes)
        check(
            probe_launches[name] == made,
            f"{name} counted {probe_launches[name]} launches, the probes made {made}",
        )
        largest = max(shapes, key=lambda r: r["bytes"])
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "path": "probes",
                "launches": probe_launches[name],
                "main_path_launches": main_launches[name],
                "shape": largest["shape"],
                "max_abs_err": max(r["max_abs_err"] for r in shapes),
                "ms": largest["ms"],
                "plain_ms": largest["plain_ms"],
                "bound_ms": largest["bound_ms"],
                "bound_by": "bytes",
                "library_ms": largest["library_ms"],
                **{k: largest[k] for k in ("trace_ms", "earlier_ms", "earlier_trace_ms", "regime")
                   if k in largest},
            }
        )
    emit("probes", seconds=probe_seconds, measurements=len(records), launches=probe_launches,
         launch_floor_ms=launch_floor_ms, nvidia_smi=smi)
    # K2 and its earlier form at the regimes' limits, with indices at both
    # ends of the range and outside it; K3 at ragged and unaligned shapes.
    # A difference raises.
    t0 = time.perf_counter()
    edges = pmg.check_edges()
    emit("probe_edges", seconds=time.perf_counter() - t0, **edges)

    # K9, beside its second bound: the random 4-byte reads of the table at
    # the rate this run's K2 read a 4 MB row at random from L2 (its trace
    # time at (8, 1048576), else its event time).
    k2_row = next(r for r in records
                  if r.get("kernel") == "take_along_axis" and r["shape"] == [8, 1_048_576])
    k2_ms = k2_row.get("trace_ms") or k2_row["ms"]
    l2_reads_per_ms = 8 * 1_048_576 / k2_ms
    head = k9["headline"]
    kernels.append(
        {
            "name": "gather_multiply",
            "wrapper": "gather_multiply",
            "route": "cuda",
            "source": "protocol_tpu_torch/ops/csrc/gather_multiply.cu",
            "replaces": "protocol_tpu/ops/sparse.py:147 + :257",
            "path": "csr_headline",
            "launches": csr_launches["gather_multiply"],
            "main_path_launches": main_launches["gather_multiply"],
            "csr_path_launches": csr_launches["gather_multiply"],
            "sparse_path_launches": sparse_launches["gather_multiply"],
            "shape": head["shape"],
            "max_abs_err": max(r["max_abs_err"] for r in k9.values()),
            "ms": head["ms"],
            "trace_ms": head["trace_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": None,
            "bound_ms_l2_reads": head["shape"][0] / l2_reads_per_ms,
            "l2_reads_gelem_per_s": l2_reads_per_ms / 1e6,
            "shapes": {
                where: {k: r[k] for k in ("shape", "table", "ms", "trace_ms", "plain_ms",
                                          "bound_ms", "bytes", "max_abs_err")}
                for where, r in k9.items()
            },
        }
    )
    print(json.dumps({"kernels": kernels}), flush=True)
    print(
        json.dumps(
            {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
