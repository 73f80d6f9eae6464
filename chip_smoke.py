#!/usr/bin/env python3
"""Drive the PyTorch port (``protocol_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
the windowed gather (K1) against its plain PyTorch version on the card,
runs the windowed EigenTrust convergence at the headline size (1M peers
/ 50M edges, 40 power iterations) through the port's entry points,
checks the result against the CSR formulation, the card against the
CPU, and a churned epoch replay against a cold converge.  Then it runs
the reference's gather/transpose probes (``protocol_tpu_torch.bench``)
at their own shapes, which hold the probe kernels K2-K4 against their
plain versions and library calls bit for bit.

Every phase prints one JSON line.  Before the last line come the card's
``nvidia-smi`` name and power limit and one ``{"kernels": [...]}`` line
(per kernel: launches on its path — the headline converge for K1, the
probes phase for K2-K4 — and on the main path, agreement with the plain
version, its time, the plain version's and the library call's times and
the least time the card could take).  The last line is
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
    from protocol_tpu_torch.bench._timing import REPS, WARMUP, kernel_vs_plain, time_ms
    from protocol_tpu_torch.models.churn import churn_cohort_dims, sender_centric_churn
    from protocol_tpu_torch.models.graphs import scale_free
    from protocol_tpu_torch.ops import _build
    from protocol_tpu_torch.ops import gather_window as gw
    from protocol_tpu_torch.ops.sparse import _ds_cumsum_axis1, converge_csr, damp, rowsum_sorted
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
    wrappers = (gw.gather_windowed, pmg.take_along_axis, pmg.transpose2d, pfp.gather_region)
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    scores = run_windowed()
    seconds = time.perf_counter() - t0
    main_launches = {w.__name__: w.launches for w in wrappers}
    launches = main_launches["gather_windowed"]
    peak = torch.cuda.max_memory_allocated()
    total = float(scores.astype(np.float64).sum())

    src_d = torch.from_numpy(g.src).to(dev)
    ptr_d = torch.from_numpy(g.row_ptr_by_dst()).to(dev)
    w_d = torch.from_numpy(g.weight).to(dev)

    def run_csr():
        t, _, _ = converge_csr(
            src_d, ptr_d, w_d, torch.from_numpy(p).to(dev), p_d, dang_d,
            alpha=0.1, tol=0.0, max_iter=iters,
        )
        return t.cpu().numpy()

    run_csr()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    csr_scores = run_csr()
    csr_seconds = time.perf_counter() - t0
    l1_csr = float(np.abs(scores.astype(np.float64) - csr_scores).sum())
    emit(
        "headline", peers=g.n, edges=g.nnz, iterations=iters, plan_seconds=plan_seconds,
        n_rows=plan.n_rows, n_segments=plan.n_segments, seg_capacity=plan.seg_capacity,
        compression=plan.compression, seconds=seconds, ms_per_iter=seconds / iters * 1e3,
        max_memory_allocated=peak, k1_launches=launches, sum_scores=total,
        csr_seconds=csr_seconds, l1_vs_csr=l1_csr,
    )
    check(launches == iters, f"K1 launched {launches} times in a {iters}-iteration converge")
    check(
        sum(main_launches.values()) == launches,
        f"a probe kernel launched on the main path: {main_launches}",
    )
    check(abs(total - 1.0) < 1e-3, f"scores sum to {total}")
    check(bool(np.isfinite(scores).all()) and scores.shape == (g.n,), "non-finite or mis-shaped scores")
    check(l1_csr <= 1e-5, f"windowed vs CSR L1 {l1_csr} > 1e-5")

    # K1 on the full plan, and the plain step pass by pass.
    t_d = torch.from_numpy(scores.astype(np.float32)).to(dev)
    full = k1_vs_plain(plan, args, t_d)
    emit("kernel", plan=f"{HEADLINE['n']}/{HEADLINE['nnz']}", **full)
    table = torch.nn.functional.pad(t_d, (0, plan.table_entries - g.n))
    alpha = torch.tensor(0.1, device=dev)
    wid, local, weight, seg_end, seg_first, seg_perm, dst_ptr = args
    out = gw.gather_windowed(wid, table, local, weight, n_rows=plan.n_rows)
    slots = out.reshape(plan.n_rows, gw.ROW)
    hi, lo = _ds_cumsum_axis1(slots)
    hi, lo = hi.reshape(-1), lo.reshape(-1)
    part = gw.bridge_partials(hi, lo, seg_end, seg_first, seg_perm)
    ct = rowsum_sorted(part, dst_ptr)
    kw = dict(n_rows=plan.n_rows, table_entries=plan.table_entries)
    contrib = w_d * t_d.index_select(0, src_d)
    step_fns = {
        "ds_cumsum_axis1": lambda: _ds_cumsum_axis1(slots),
        "bridge_partials": lambda: gw.bridge_partials(hi, lo, seg_end, seg_first, seg_perm),
        "rowsum_sorted": lambda: rowsum_sorted(part, dst_ptr),
        "epilogue": lambda: damp(ct, t_d, p_d, dang_d, alpha),
        "whole_step": lambda: gw.power_step_windowed(*args, t_d, p_d, dang_d, alpha, **kw),
        # The CSR step's two passes (ops/sparse.py::power_step_csr), beside K1.
        "csr_gather_multiply": lambda: w_d * t_d.index_select(0, src_d),
        "csr_rowsum_sorted": lambda: rowsum_sorted(contrib, ptr_d),
    }
    passes = {"gather_k1": full["ms"]}
    passes.update({name: time_ms(fn, reps=10) for name, fn in step_fns.items()})
    emit("step_passes_ms", **passes)
    del out, slots, hi, lo, part, ct, step_fns, src_d, ptr_d, w_d, contrib
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
        }
    ]

    # -- 5. card vs CPU at 65,536 peers ------------------------------------
    g_small = scale_free(SMALL["n"], SMALL["nnz"], seed=SMALL["seed"])
    kw5 = dict(alpha=0.1, tol=1e-6, max_iter=60)
    before = gw.gather_windowed.launches
    on_card = get_backend("cuda-windowed").converge(g_small, **kw5)
    card_launches = gw.gather_windowed.launches - before
    on_cpu = get_backend("cuda-windowed", device="cpu").converge(g_small, **kw5)
    l1_cpu = float(np.abs(on_card.scores - on_cpu.scores).sum())
    emit(
        "card_vs_cpu", iterations_card=on_card.iterations, iterations_cpu=on_cpu.iterations,
        l1=l1_cpu, k1_launches=card_launches,
    )
    check(on_card.iterations == on_cpu.iterations, "card and CPU ran different iteration counts")
    check(l1_cpu <= 1e-6, f"card vs CPU L1 {l1_cpu} > 1e-6")
    check(card_launches == on_card.iterations, "the card converge did not launch K1 each iteration")

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

    # -- 7. probes: K2-K4 at the reference probes' shapes ------------------
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
    per_shape = 1 + WARMUP + REPS
    for name, (_, source, replaces) in probe_kernels.items():
        shapes = [r for r in records if r.get("kernel") == name]
        check(bool(shapes), f"the probes measured no shape of {name}")
        made = per_shape * len(shapes)
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
            }
        )
    emit("probes", seconds=probe_seconds, measurements=len(records), launches=probe_launches)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(
        json.dumps(
            {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
