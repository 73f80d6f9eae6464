#!/usr/bin/env python3
"""Drive the PyTorch port (``protocol_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
the windowed gather (K1) against its plain PyTorch version on the card,
runs the windowed EigenTrust convergence at the headline size (1M peers
/ 50M edges, 40 power iterations) through the port's entry points,
checks the result against the CSR formulation and the CSR formulation
against the COO one (``cuda-sparse``, bit for bit), holds the CSR and
COO steps' edge product folded into their row sums' block prefix (K9
``gather_ds_cumsum``) at the headline's and the 65,536-peer graph's
operands and at a ragged edge count with out-of-range sources, beside
the earlier pair it replaced (the edge product
``bench/yardsticks.py::gather_multiply``, then K5), holds the step's
double-single prefix kernels (K5 ``ds_cumsum_rows``, K6
``compensated_scan``, which scans the block totals it reads from K5's
lanes), the row prefix and bridge (K7 ``prefix_bridge``) and the row
sums' pointer tail (K8 ``rowsum_tail``) against their plain versions at
the shapes the windowed and the CSR step give them (K7 also on the
65,536-peer plan, K5 also at the plan rows, which K7 now covers, K6
also at 1, 3 and 8,200 blocks and past its two depth thresholds, and K8
also at pointer counts about the end of a warp's tile), times
the earlier forms of K6, K8 and K9 (``protocol_tpu_torch.bench.yardsticks``)
beside them and one empty launch, and holds the kernel route of the
windowed, CSR and COO steps against their plain route, bit for bit.
Then the card against the CPU, a churned epoch replay against a cold
converge, and BASELINE ladder configs 1-3 through ``native-cpu``,
``cuda-dense`` and ``cuda-sparse`` (``backends``).  Between the two,
the sharded converge (``sharded``): ``cuda-sharded:cuda-csr`` and
``:cuda-windowed`` on 4 ranks (processes) that share the card at the
headline and on 8 at 65,536 peers, their all-reduce on ``gloo`` (NCCL
refuses two ranks on one card), held against the single-card converges,
the ranks against each other bit for bit, each rank's launches and
all-reduces against the declared budgets, each shard's kernel route
against its plain route, and the 8 card ranks against 8 CPU ranks.
Last it runs the
reference's gather/transpose probes (``protocol_tpu_torch.bench``) at
their own shapes, which hold the probe kernels K2-K4 against their plain
versions and library calls bit for bit, with event and trace times, K2
beside its earlier form; then K2 and K3 at their edge shapes
(``probe_edges``).  Then the single-device node (``node``): the
reference's bootstrap group of 5 and a seeded group of 64, each through
three ``EpochPipeline`` epochs, a commitment proof, a checkpoint, a
recovery and a warm-started epoch on ``cuda-windowed`` and on
``cuda-csr`` (``protocol_tpu_torch.node``), held against direct
converges on the card, the same node on the CPU and the kernel budgets
the backends declare (launch counts and a profiler trace), with each
stage's seconds.  Last the PLONK prover stack (``plonk``): the zk
runtime (``native/zk_runtime.cpp``, ``zk_ifma.cpp``, built with g++
beside the kernels) loaded, a cold keygen of the default 5-member
statement from the committed ``data/srs-15.bin``, the committed epoch
proof ``data/et_proof.json`` verifying and its tampered copies refused,
and the reference's default node configuration (``prover="plonk"``,
``check_circuit=True``) on ``cuda-windowed``: two ``EpochPipeline``
epochs on the card, launches against the backend's budget, the circuit
check, the KZG PLONK proof of the last epoch and its verify, with the
prove's native phase table, and the same node on the CPU proving the
same bytes.  Then the graft prover kernels (``graft``): K10
``zk_mulmod``, K11 ``zk_ntt``, K12 ``zk_msm_window`` and K13
``zk_msm_bucket`` against their plain versions, K11 and K13 beside
their first forms (``bench/yardsticks.py``: ``ntt_stages``,
``msm_bucket_chunked``), the graft NTT and MSM against the native
runtime's, and the same default epoch proved under
``zk_backend="graft"`` on the card, its bytes equal to the native
proof's, every graft call's launches on its declared budget.  Last the
two planes (``planes``): the node cell's 64-member group admitted
through ``IngestPlane`` with 0 and 2 spawned verify workers and on the
CPU (a burst past the submit queue, re-attestations with rising nonces,
a replay, a stale nonce, a bad signature, a structurally invalid item),
every verdict equal across the runs and to the direct
``add_attestations_bulk``, sigs/s, the admitted group converged on the
card; then the plonk cell's default node ticking as the reference's
server does in async mode, 3 ticks at its 10 s epoch interval, each
proof proved by one spawned, prewarmed worker of ``ProvingPlane`` —
under ``native`` and under ``graft``, where the worker launches K10-K13
in its own CUDA context — every landed proof equal to the sync proof's
bytes and verifying, no job failed, with the ticks' wall seconds, proof
lag, the worker's prove seconds and the share of them inside the tick
loop.  Last the node server (``server``): the reference's default node
(``data/protocol-config.json``) on ``cuda-windowed`` with the async
proving plane, booted in this process with ``Node.start`` on a free
local port and its chain events from a fixture of the plonk cell's
attestations: the boot order (the socket answers ``recovering`` before
the loops start), ``POST /attestation`` verdicts, 3 ticks of its
wall-clock epoch loop (none failed or dropped, K1 and K5-K8 launched for
exactly the ticks' iterations, a ``torch.profiler`` trace each), every
``GET`` route's status and latency, each landed proof verifying and the
last equal to a CPU manager's prove of the same attestations, the
converges equal to the CPU's; then ``python -m
protocol_tpu_torch.node.server`` in a subprocess on the same checkpoint
directory, serving the checkpointed proof and exiting on SIGTERM with
its flight dump.

Every phase prints its JSON lines.  Before the last line come the card's
``nvidia-smi`` name and power limit and one ``{"kernels": [...]}`` line
(per kernel: launches on its path — the windowed headline converge for
K1 and K5-K8 (K5 launches on no other path), the CSR headline converge
for K9, the probes phase for
K2-K4, the graft prove for K10-K13 (``graft_launches``) — on the main path, on the node's card converges by backend
(``node_launches``), on the PLONK node's card converges
(``plonk_launches``), on the planes phase's converges and in its graft
worker (``planes_launches``), on the server's ticks
(``server_launches``), on each rank of the sharded headline
converges by backend (``sharded_launches``), agreement with the plain version, its
time, the plain version's and the library call's times and the least
time the card could take).  The last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before that line.  Imports nothing of JAX
or of the ``protocol_tpu`` reference package.
"""

from __future__ import annotations

import concurrent.futures
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


NODE = dict(groups=(5, 64), seed=3, epochs=3, backends=("cuda-windowed", "cuda-csr"))
NODE_KW = dict(alpha=0.1, tol=1e-6, max_iter=50)


def node_group(n: int, seed: int):
    """The group's bs58 secret-key pairs (the reference's bootstrap set
    at 5, else ``n`` seeded members), every member's attestation (score
    rows summing to SCALE, no self-score) and sender 0's re-attestation."""
    import random

    import numpy as np

    from protocol_tpu_torch.crypto import calculate_message_hash
    from protocol_tpu_torch.crypto.eddsa import SecretKey, sign
    from protocol_tpu_torch.node.attestation import Attestation
    from protocol_tpu_torch.node.bootstrap import FIXED_SET, SCALE, keyset_from_raw
    from protocol_tpu_torch.utils.codec import b58encode

    fixed_set = list(FIXED_SET) if n == len(FIXED_SET) else [
        tuple(b58encode(part) for part in SecretKey.random(random.Random(seed * 1000 + i)).to_raw())
        for i in range(n)
    ]
    rng = np.random.default_rng(seed + n)

    def row(i):
        w = rng.integers(0, 8, n)
        w[i] = 0
        w[(i + 1) % n] += 1
        r = w * SCALE // w.sum()
        r[(i + 1) % n] += SCALE - r.sum()
        return [int(x) for x in r]

    rows = [(i, row(i)) for i in range(n)] + [(0, row(0))]
    sks, pks = keyset_from_raw(fixed_set)
    _, msgs = calculate_message_hash(pks, [r for _, r in rows])
    atts = [
        Attestation(sig=sign(sks[i], pks[i], m), pk=pks[i], neighbours=list(pks), scores=r)
        for (i, r), m in zip(rows, msgs)
    ]
    return fixed_set, atts[:-1], atts[-1]


def run_node(fixed_set, atts, reattestation, backend, device, workdir, wrappers):
    """One node's life on ``backend``: ingest, three epochs through the
    ``EpochPipeline`` (sender 0 re-attests before the third, so it takes
    the delta plan), the commitment proof, a checkpoint, recovery into a
    fresh manager and a warm-started fourth epoch.  Per epoch, from the
    device stage: the graph, seed and plan it ran on, its iterations and
    scores, the launches of every counted kernel wrapper (set to 0 just
    before its converge, read just after), its plan outcome, the kernel
    libraries built during it, and whether it ran on the card's default
    stream.  Stage seconds beside them."""
    import shutil
    import time

    import torch

    from protocol_tpu_torch.node.checkpoint import CheckpointStore
    from protocol_tpu_torch.node.epoch import Epoch
    from protocol_tpu_torch.node.manager import Manager, ManagerConfig
    from protocol_tpu_torch.node.pipeline import EpochPipeline
    from protocol_tpu_torch.node.wal import AttestationWAL, recover
    from protocol_tpu_torch.obs import RECOMPILES
    from protocol_tpu_torch.obs.metrics import PLAN_OUTCOMES

    shutil.rmtree(workdir, ignore_errors=True)
    config = ManagerConfig(
        backend=backend, device=device, prover="commitment", check_circuit=False,
        fixed_set=list(fixed_set), num_neighbours=len(fixed_set), plan_delta_max_churn=0.25,
    )
    stages = {k: 0.0 for k in ("ingest", "wal_flush", "prepare", "converge", "prove",
                               "checkpoint", "restore")}
    epochs = []

    def timed_flush(flush):
        def run():
            t0 = time.perf_counter()
            flush()
            stages["wal_flush"] += time.perf_counter() - t0
        return run

    def ingest(m, batch):
        t0 = time.perf_counter()
        verdicts = m.add_attestations_bulk(batch)
        stages["ingest"] += time.perf_counter() - t0
        return [v.reason for v in verdicts if not v.accepted]

    def device_stage(m):
        def stage(prepared):
            on_card = m.device is not None and m.device.type == "cuda"
            default_stream = (
                torch.cuda.current_stream(m.device) == torch.cuda.default_stream(m.device)
                if on_card else None
            )
            outcomes = {k: PLAN_OUTCOMES.value(outcome=k) for k in ("reuse", "delta", "rebuild")}
            builds = RECOMPILES.snapshot()
            for w in wrappers:
                w.launches = 0
            t0 = time.perf_counter()
            result = m.converge_prepared(prepared, **NODE_KW)
            seconds = time.perf_counter() - t0
            launches = {w.__name__: w.launches for w in wrappers}
            after = RECOMPILES.snapshot()
            stages["converge"] += seconds
            epochs.append(dict(
                epoch=prepared.epoch.number, graph=prepared.graph, t0=prepared.t0,
                plan=m.window_plan, iterations=result.iterations, scores=result.scores,
                launches=launches, seconds=seconds, warm=prepared.t0 is not None,
                delta_hint=prepared.delta_rows is not None,
                outcome=[k for k, v in outcomes.items() if PLAN_OUTCOMES.value(outcome=k) > v],
                builds={k: v - builds.get(k, 0) for k, v in after.items() if v > builds.get(k, 0)},
                default_stream=default_stream,
            ))
            return result
        return stage

    def tick(m, numbers, before=None):
        with EpochPipeline(m, device_stage=device_stage(m)) as pipe:
            for k in numbers:
                if before is not None and k in before:
                    rejected = ingest(m, [before[k]])
                    if rejected:
                        raise RuntimeError(f"re-attestation rejected: {rejected}")
                t0 = time.perf_counter()
                pipe.submit(Epoch(k))
                stages["prepare"] += time.perf_counter() - t0
                if not pipe.drain(120):
                    raise RuntimeError(f"epoch {k} did not finish")
        failed = {k: repr(o.error) for k, o in pipe.outcomes.items() if o.error is not None}
        if failed:
            raise RuntimeError(f"epochs failed on {backend}: {failed}")

    m = Manager(config)
    m.wal = AttestationWAL(workdir / "wal")
    m.wal.flush = timed_flush(m.wal.flush)
    rejected = ingest(m, atts)
    if rejected:
        raise RuntimeError(f"attestations rejected: {rejected}")
    tick(m, range(NODE["epochs"]), before={NODE["epochs"] - 1: reattestation})
    last = Epoch(NODE["epochs"] - 1)
    t0 = time.perf_counter()
    m.calculate_proofs(last)
    stages["prove"] = time.perf_counter() - t0
    proof = m.get_proof(last)
    store = CheckpointStore(workdir / "ckpt")
    t0 = time.perf_counter()
    store.save(
        last, m.last_graph, m.last_scores, proof.to_raw("commitment").to_json(),
        plan=m.window_plan, peer_hashes=m.last_peer_hashes, wal_seq=m.checkpoint_watermark(),
        attestations=m.snapshot_attestations(),
    )
    m.wal.truncate_through(store.retained_wal_floor())
    stages["checkpoint"] = time.perf_counter() - t0
    m.wal.close()
    fresh = Manager(config)
    t0 = time.perf_counter()
    report = recover(fresh, store, AttestationWAL(workdir / "wal"))
    stages["restore"] = time.perf_counter() - t0
    tick(fresh, [NODE["epochs"]])
    shutil.rmtree(workdir, ignore_errors=True)
    return dict(epochs=epochs, pub_ins=proof.pub_ins, proof=proof.proof, stages=stages,
                recovery=report, restored=fresh.get_proof(last).proof == proof.proof)


#: The CUDA functions the converge kernels' wrappers launch, by name in
#: a profiler trace, with the wrapper of each (K7's wrapper runs two).
PROFILED = {
    "gather_window_kernel": "gather_windowed", "prefix_rows_kernel": "prefix_bridge",
    "permute4_kernel": "prefix_bridge", "ds_cumsum_rows_kernel": "ds_cumsum_axis1",
    "compensated_scan_kernel": "block_total_scan", "rowsum_tail_kernel": "rowsum_tail",
    "gather_ds_cumsum_kernel": "gather_ds_cumsum",
}


def traced_budget(budget, iterations) -> dict:
    """Each profiled function's launches that ``iterations`` steps of a
    backend with ``budget`` (``analysis/budget.py``) make."""
    return {k: budget.launches_per_step.get(w, 0) * iterations
            for k, w in PROFILED.items() if budget.launches_per_step.get(w, 0)}


def node_phase(wrappers, check, emit, smi) -> dict:
    """The single-device node on the card: for the bootstrap group of 5
    and a seeded group of 64, on ``cuda-windowed`` and on ``cuda-csr``,
    ``run_node`` on the card (``device=None``) under a profiler trace and
    on the CPU.  Each card epoch's scores equal a direct converge of its
    graph from its seed on the card bit for bit, and the CPU run's within
    L1 1e-6 at the same iterations and plan outcomes; the commitment
    proofs are equal; each converge launched every kernel its backend
    declares (``analysis/budget.py``) iterations times per step and no
    other, and so does the trace; the warm delta epoch built no kernel
    library.  Returns, per backend, each wrapper's launches over the
    node's card converges."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from protocol_tpu_torch.analysis.budget import KERNEL_INVARIANTS
    from protocol_tpu_torch.bench._timing import device_events, settle_trace
    from protocol_tpu_torch.crypto import native as cnative
    from protocol_tpu_torch.trust.backend import get_backend

    check(cnative.available(), "the crypto runtime (native/protocol_native.cpp) did not build")
    workdir = HERE / "build" / "chip_smoke_node"

    def traced_node(fixed_set, atts, reattestation, backend):
        """``run_node`` on the card under a profiler trace, settled before
        the node starts (``settle_trace``), and each profiled kernel's
        launches in the trace.  The trace is a measurement beside the
        counters: where the profiler fails, its count says "not measured"."""
        traced, prof = {}, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        try:
            prof.__enter__()
            settle_trace()
        except Exception as exc:  # noqa: BLE001 - reported, not a check
            traced, prof = {"not measured": repr(exc)}, None
        try:
            card = run_node(fixed_set, atts, reattestation, backend, None, workdir, wrappers)
        finally:
            if prof is not None:
                torch.cuda.synchronize()
                try:
                    prof.__exit__(None, None, None)
                except Exception as exc:  # noqa: BLE001 - reported, not a check
                    traced, prof = {"not measured": repr(exc)}, None
        if prof is not None:
            for e in device_events(prof):
                for kernel in PROFILED:
                    if kernel in e.name:
                        traced[kernel] = traced.get(kernel, 0) + 1
        return card, traced

    totals = {b: {w.__name__: 0 for w in wrappers} for b in NODE["backends"]}
    records = {}
    t_phase = time.perf_counter()
    for n in NODE["groups"]:
        t0 = time.perf_counter()
        fixed_set, atts, reattestation = node_group(n, NODE["seed"])
        group_seconds = time.perf_counter() - t0
        for backend in NODE["backends"]:
            budget = KERNEL_INVARIANTS[backend]
            card, traced = traced_node(fixed_set, atts, reattestation, backend)
            iterations = sum(c["iterations"] for c in card["epochs"])
            want_traced = traced_budget(budget, iterations)
            traced_ok = None if "not measured" in traced else traced == want_traced
            cpu = run_node(fixed_set, atts, reattestation, backend, "cpu", workdir, wrappers)
            key = f"{n}/{backend}"
            ce, pe = card["epochs"], cpu["epochs"]
            check(len(ce) == len(pe) == NODE["epochs"] + 1, f"{key}: epochs ran {len(ce)}, {len(pe)}")
            direct_equal, l1, launches_ok = [], [], []
            for c, p in zip(ce, pe):
                b = get_backend(backend, **({"plan": c["plan"]} if backend == "cuda-windowed" else {}))
                direct = b.converge(c["graph"], t0=c["t0"], **NODE_KW)
                direct_equal.append(bool(np.array_equal(direct.scores, c["scores"]))
                                    and direct.iterations == c["iterations"])
                l1.append(float(np.abs(c["scores"] - p["scores"]).sum()))
                want = {w.__name__: 0 for w in wrappers}
                want.update(budget.expected_launches(c["iterations"]))
                launches_ok.append(c["launches"] == want)
                for w, k in c["launches"].items():
                    totals[backend][w] += k
            rec = dict(
                peers=n, group_seconds=group_seconds,
                iterations=[c["iterations"] for c in ce],
                cpu_iterations=[p["iterations"] for p in pe],
                plan_outcomes=[c["outcome"] for c in ce], cpu_plan_outcomes=[p["outcome"] for p in pe],
                warm=[c["warm"] for c in ce], delta_hint=[c["delta_hint"] for c in ce],
                l1_vs_cpu=l1, bit_equal_to_direct=direct_equal,
                launches_per_epoch=[c["launches"] for c in ce], launches_match_budget=launches_ok,
                traced_kernels=traced, traced_match_budget=traced_ok,
                builds=[c["builds"] for c in ce], default_stream=[c["default_stream"] for c in ce],
                epoch_converge_seconds=[c["seconds"] for c in ce],
                stage_seconds=card["stages"], cpu_stage_seconds=cpu["stages"],
                proof_equal=card["proof"] == cpu["proof"] and card["pub_ins"] == cpu["pub_ins"],
                proof_restored=card["restored"], recovery=card["recovery"],
            )
            records[key] = rec
            check(all(direct_equal), f"node {key}: an epoch differs from a direct converge: {direct_equal}")
            check(rec["iterations"] == rec["cpu_iterations"], f"node {key}: card vs CPU iterations {rec}")
            check(max(l1) <= 1e-6, f"node {key}: card vs CPU L1 {l1} > 1e-6")
            check(rec["plan_outcomes"] == rec["cpu_plan_outcomes"], f"node {key}: plan outcomes differ")
            check(rec["warm"] == [False, True, True, True], f"node {key}: warm starts {rec['warm']}")
            # Only the windowed backend keeps a plan, so only its
            # re-attested epoch gets a delta hint and takes the delta plan.
            if backend == "cuda-windowed":
                check(rec["delta_hint"] == [False, False, True, False],
                      f"node {key}: delta hints {rec['delta_hint']}")
                check(rec["plan_outcomes"] == [["rebuild"], ["reuse"], ["delta"], ["reuse"]],
                      f"node {key}: plan outcomes {rec['plan_outcomes']}")
            else:
                check(not any(rec["delta_hint"]) and not any(rec["plan_outcomes"]),
                      f"node {key}: a plan outcome on {backend}: {rec['plan_outcomes']}")
            check(all(launches_ok), f"node {key}: launches {rec['launches_per_epoch']} off budget")
            check(traced_ok is not False, f"node {key}: the trace counted {traced}")
            check(rec["builds"][2] == {}, f"node {key}: the warm re-attested epoch built {rec['builds'][2]}")
            check(all(rec["default_stream"]), f"node {key}: a converge left the default stream")
            check(rec["proof_equal"] and rec["proof_restored"], f"node {key}: proofs differ")
    emit("node", nvidia_smi=smi, seconds=time.perf_counter() - t_phase, **records)
    return totals


PLONK = dict(backend="cuda-windowed", epochs=2, srs="data/srs-15.bin", proof="data/et_proof.json")


def run_plonk_node(config, prover, atts, wrappers):
    """The reference's default node (the bootstrap group of 5,
    ``prover="plonk"``, ``check_circuit=True``) on ``config``'s backend
    and device, with ``prover`` handed in: ingest, ``PLONK["epochs"]``
    epochs through the ``EpochPipeline`` (each wrapper's launches set to
    0 just before each converge and read just after), then the last
    epoch's circuit check and PLONK proof under one span, whose children
    time the check and the prove and carry the prove's native phase
    table (``plonk._ProveAttribution``)."""
    from protocol_tpu_torch.node.epoch import Epoch
    from protocol_tpu_torch.node.manager import Manager
    from protocol_tpu_torch.node.pipeline import EpochPipeline
    from protocol_tpu_torch.obs import TRACER

    epochs = []

    def stage(prepared):
        for w in wrappers:
            w.launches = 0
        t0 = time.perf_counter()
        result = m.converge_prepared(prepared, **NODE_KW)
        epochs.append(dict(iterations=result.iterations, seconds=time.perf_counter() - t0,
                           launches={w.__name__: w.launches for w in wrappers}))
        return result

    m = Manager(config, prover=prover)
    rejected = [v.reason for v in m.add_attestations_bulk(atts) if not v.accepted]
    if rejected:
        raise RuntimeError(f"attestations rejected: {rejected}")
    with EpochPipeline(m, device_stage=stage) as pipe:
        for k in range(PLONK["epochs"]):
            pipe.submit(Epoch(k))
            if not pipe.drain(120):
                raise RuntimeError(f"epoch {k} did not finish")
    failed = {k: repr(o.error) for k, o in pipe.outcomes.items() if o.error is not None}
    if failed:
        raise RuntimeError(f"epochs failed: {failed}")
    last = Epoch(PLONK["epochs"] - 1)
    with TRACER.span("plonk_epoch") as span:
        m.calculate_proofs(last)
    proof = m.get_proof(last)
    snark = span.find("snark")
    return dict(
        epochs=epochs, pub_ins=proof.pub_ins, proof=proof.proof,
        circuit_check_s=span.find("circuit_check").duration_s, snark_s=snark.duration_s,
        prove_phases={c.name: {"calls": c.attrs.get("calls"), "seconds": c.duration_s,
                               "engine": c.attrs.get("engine")} for c in snark.children},
    )


def plonk_phase(wrappers, check, emit, smi) -> tuple[dict, dict]:
    """The PLONK prover stack on the card's host: the port's zk runtime
    built and loaded; a cold keygen of the default 5-member statement
    (k = 14) from the committed SRS on a fresh key cache; the committed
    epoch proof verifying under that key and its tampered copies
    refused; a default-configuration node on ``cuda-windowed`` on the
    card (``run_plonk_node``), its converges' launches equal to the
    backend's declared budget, its epoch proof verifying; and the same
    node on the CPU, whose public inputs and proof bytes equal the card
    node's.  Returns each wrapper's launches over the card node's
    converges, and what the ``graft`` phase reuses: the prover, the
    node's inputs and the card node's result."""
    import shutil

    from protocol_tpu_torch.analysis.budget import KERNEL_INVARIANTS
    from protocol_tpu_torch.crypto import field
    from protocol_tpu_torch.node.manager import ManagerConfig
    from protocol_tpu_torch.zk import native as znative
    from protocol_tpu_torch.zk.proof import PlonkEpochProver, ProofRaw

    check(znative.available(), "the zk runtime (native/zk_runtime.cpp, zk_ifma.cpp) did not build")
    ifma = znative.ifma_available()
    t_phase = time.perf_counter()
    keys = HERE / "build" / "chip_smoke_plonk" / "keys"
    shutil.rmtree(keys, ignore_errors=True)
    srs = str(HERE / PLONK["srs"])
    t0 = time.perf_counter()
    prover = PlonkEpochProver(srs_path=srs, cache_dir=str(keys))
    keygen_s = time.perf_counter() - t0
    check(prover.vk.k == 14, f"plonk: the default statement compiled at k={prover.vk.k}, not 14")

    committed = ProofRaw.from_json((HERE / PLONK["proof"]).read_text()).to_proof()
    t0 = time.perf_counter()
    committed_ok = prover.verify(committed.pub_ins, committed.proof)
    committed_verify_s = time.perf_counter() - t0
    bad_ins = [(committed.pub_ins[0] + 1) % field.MODULUS] + committed.pub_ins[1:]
    flipped = bytearray(committed.proof)
    flipped[7] ^= 1
    check(committed_ok, "plonk: the committed epoch proof does not verify")
    check(not prover.verify(bad_ins, committed.proof), "plonk: a wrong public input verified")
    check(not prover.verify(committed.pub_ins, bytes(flipped)), "plonk: a flipped proof byte verified")

    _, atts, _ = node_group(5, NODE["seed"])
    config = dict(backend=PLONK["backend"], srs_path=srs, plan_delta_max_churn=0.25)
    defaults = ManagerConfig(**config)
    check((defaults.prover, defaults.check_circuit, defaults.num_neighbours) == ("plonk", True, 5),
          "plonk: the node's defaults are not the reference's")
    card = run_plonk_node(defaults, prover, atts, wrappers)
    cpu = run_plonk_node(ManagerConfig(device="cpu", **config), prover, atts, wrappers)
    t0 = time.perf_counter()
    card_ok = prover.verify(card["pub_ins"], card["proof"])
    verify_s = time.perf_counter() - t0

    budget = KERNEL_INVARIANTS[PLONK["backend"]]
    totals = {w.__name__: 0 for w in wrappers}
    launches_ok = []
    for e in card["epochs"]:
        want = {w.__name__: 0 for w in wrappers}
        want.update(budget.expected_launches(e["iterations"]))
        launches_ok.append(e["launches"] == want)
        for w, k in e["launches"].items():
            totals[w] += k
    rec = dict(
        zk_runtime=str(znative.library_path().name), ifma=ifma,
        keygen_s=keygen_s, k=prover.vk.k, committed_verify_s=committed_verify_s,
        circuit_check_s=card["circuit_check_s"], snark_s=card["snark_s"], verify_s=verify_s,
        prove_phases=card["prove_phases"],
        cpu_node=dict(circuit_check_s=cpu["circuit_check_s"], snark_s=cpu["snark_s"]),
        iterations=[e["iterations"] for e in card["epochs"]],
        cpu_iterations=[e["iterations"] for e in cpu["epochs"]],
        converge_s=[e["seconds"] for e in card["epochs"]],
        launches=[e["launches"] for e in card["epochs"]], launches_match_budget=launches_ok,
        pub_ins=[str(x) for x in card["pub_ins"]], proof_bytes=len(card["proof"]),
        proof_equal=card["proof"] == cpu["proof"] and card["pub_ins"] == cpu["pub_ins"],
    )
    check(card_ok, "plonk: the card node's epoch proof does not verify")
    check(all(launches_ok), f"plonk: launches {rec['launches']} off the {PLONK['backend']} budget")
    check(all(e["iterations"] > 0 for e in card["epochs"]), "plonk: a converge ran no step")
    check(rec["proof_equal"], "plonk: the card node's proof differs from the CPU node's")
    total = sum(card["pub_ins"]) % field.MODULUS
    check(total == 5 * 1000, f"plonk: public scores sum to {total} in the field, not 5000")
    emit("plonk", nvidia_smi=smi, seconds=time.perf_counter() - t_phase, **rec)
    # The key cache stays for the planes phase's prover workers and the
    # server phase's node, which removes it.
    return totals, dict(prover=prover, atts=atts, config=config, card=card, trust_wrappers=wrappers,
                        keys=keys)


GRAFT = dict(k10_n=1 << 20, msm_n=1 << 14, rate_sizes=(1 << 10, 1 << 12, 1 << 14), rate_reps=3,
             plain_reps=3, seed=13,
             # K12's sweep: every size and skew checked; the powers of two in
             # k12_timed timed at random and {0, 1} scalars.  Past 2^17 a block's
             # share of a window spans more than one round.
             k12_sizes=(1, 33, 1000, 1 << 10, 1 << 14, 1 << 15, 1 << 17, (1 << 17) + 3, (1 << 20) + 5),
             k12_skews=("random", "zero_one", "zero", "repeated"), k12_timed=(1 << 10, 1 << 14, 1 << 17))
#: 32-bit multiply-adds of one Montgomery multiply (CIOS, eight 32-bit
#: limbs): two for each of the 128 full 32x32 -> 64-bit products of a * b
#: and m * p, one for each of the eight m, of which only the low word is used.
IMADS_A_MUL = 2 * 128 + 8
#: A mixed Jacobian add of an affine point (madd-2007-bl, Z2 = 1): 11 multiplies.
IMADS_A_MADD = 11 * IMADS_A_MUL


def graft_wrappers():
    """The graft kernels' wrappers: K10, K11, K12, K13."""
    from protocol_tpu_torch.zk.graft import field, ntt, pippenger

    return (field.field_op, ntt.ntt_device, pippenger.msm_window, pippenger.msm_bucket)


class GraftCalls:
    """While ``recording()``, every call of a graft entry (``ntt_limbs``,
    ``msm_limbs``, ``PointCache.build``) is logged with its size and its
    launches by wrapper, and held against ``expected_zk_launches``
    (``analysis/budget.py``); ``off_budget`` keeps the calls that differ."""

    def __init__(self):
        self.calls: list[tuple[str, dict]] = []
        self.off_budget: list[dict] = []

    def recording(self):
        import contextlib

        from protocol_tpu_torch.analysis.budget import expected_zk_launches
        from protocol_tpu_torch.zk.graft import ntt, pippenger

        wrappers = graft_wrappers()

        def wrap(entry, fn, size):
            def counted(*args, **kwargs):
                before = {w.__name__: w.launches for w in wrappers}
                out = fn(*args, **kwargs)
                got = {w.__name__: w.launches - before[w.__name__] for w in wrappers}
                sz = size(*args, **kwargs)
                want = {name: 0 for name in got}
                want.update(expected_zk_launches(entry, **sz))
                self.calls.append((entry, sz))
                if got != want:
                    self.off_budget.append(dict(entry=entry, size=sz, launches=got, declared=want))
                return out

            return counted

        @contextlib.contextmanager
        def session():
            saved = (ntt.ntt_limbs, pippenger.msm_limbs, pippenger.PointCache.__dict__["build"])
            ntt.ntt_limbs = wrap("ntt_limbs", saved[0], lambda arr, root, inverse: dict(
                n=int(arr.shape[0]), inverse=bool(inverse)))
            pippenger.msm_limbs = wrap("msm_limbs", saved[1], lambda s, cache: dict(n=int(s.shape[0])))
            pippenger.PointCache.build = classmethod(wrap(
                "point_cache", saved[2].__func__, lambda cls, pts, device=None: dict(n=len(pts))))
            try:
                yield self
            finally:
                ntt.ntt_limbs, pippenger.msm_limbs = saved[:2]
                pippenger.PointCache.build = saved[2]

        return session()


def normalized_buckets(grid) -> dict:
    """A (32, 256, 3, 4) int64 bucket grid (canonical Jacobian Fq) as
    {(window, digit): affine (x, y)} over its non-empty buckets, digit >= 1."""
    import numpy as np

    from protocol_tpu_torch.zk.rns import FQ_MODULUS as Q

    words = grid.cpu().numpy().view(np.uint64).reshape(32, 256, 3, 4)
    out = {}
    ws, ds = np.nonzero(words[:, 1:, 2, :].any(axis=-1))
    for w, d in zip(ws.tolist(), (ds + 1).tolist()):
        x, y, z = (int.from_bytes(words[w, d, k].tobytes(), "little") for k in range(3))
        zi = pow(z, Q - 2, Q)
        zi2 = zi * zi % Q
        out[(w, d)] = (x * zi2 % Q, y * zi2 % Q * zi % Q)
    return out


def graft_phase(plonk_ctx, check, emit, smi) -> list[dict]:
    """The graft prover kernels on the card (K10-K13): each held against
    its plain version on the card at the prove's shapes (K10 bit for bit
    on 2^20 random elements of each field with the edge values first;
    K11's first pass and whole NTT at 2^k and the extended domain,
    forward and inverse, bit for bit; K12's sorted
    digits and order bit for bit, and equal to a stable ``torch.sort`` of
    the scalars' bytes, at every size and skew of its sweep; K13's
    buckets equal as affine points, bucket 0 empty, at 2^14 random and
    {0, 1} scalars and the n = 33 edge batch), K11, K12 and K13 timed beside
    their first forms (``earlier_ms``), each rated against a bound that
    counts what the data needs; ``ntt_limbs`` under graft against
    the native ``zk_ntt`` at 2^k and at the extended size, forward,
    inverse and round trip; ``msm_limbs`` under graft against native at
    2^14 random and {0, 1} scalars and at the reference test's n = 33
    edge batch (against the exact sum too); then, with ``plonk_ctx``
    (the ``plonk`` phase's prover, whose SRS and domain sizes the checks
    above use, node inputs and card proof), the default 5-member epoch
    proved on the card under ``zk_backend="graft"``: its bytes and public inputs equal the native
    card proof's and verify, every graft call's launches equal the
    declared budget, and the phase table, ``finish_s`` and the launches
    are kept; last the MSM and NTT rates of both engines.  Returns the
    ``kernels`` entries of K10-K13."""
    import functools
    import statistics

    import numpy as np
    import torch

    from protocol_tpu_torch.bench._timing import INT32_OPS_PER_S, bound_by, bound_ms, time_ms
    from protocol_tpu_torch.crypto.field import MODULUS as R
    from protocol_tpu_torch.utils.limbs import to_limbs_fast
    from protocol_tpu_torch.zk import native as znative
    from protocol_tpu_torch.zk import plonk
    from protocol_tpu_torch.zk.bn254 import GENERATOR, IDENTITY, G1
    from protocol_tpu_torch.zk.graft import field as gf
    from protocol_tpu_torch.zk.graft import ntt as gntt
    from protocol_tpu_torch.zk.graft import pippenger as gpp
    from protocol_tpu_torch.zk.graft import use_zk_backend
    from protocol_tpu_torch.bench import yardsticks as ys

    t_phase = time.perf_counter()
    vk = plonk_ctx["prover"].vk
    srs, k, ext_k = vk.srs, vk.k, vk.k + vk.ext_factor.bit_length() - 1
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(GRAFT["seed"])
    rec: dict = {}
    calls = GraftCalls()

    def canonical_words(n):
        """(n, 4) u64 words below 2^252, so canonical in Fr and Fq."""
        w = rng.integers(0, np.iinfo(np.uint64).max, size=(n, 4), dtype=np.uint64, endpoint=True)
        w[:, 3] &= np.uint64((1 << 60) - 1)
        return w

    def k12_scalars(m, skew):
        """(m, 4) u64 scalar words for K12: ``random`` canonical words,
        ``zero_one`` scalars 0 or 1, ``zero`` all 0, ``repeated`` one
        random word m times (every window's digits in one bin)."""
        if skew == "random":
            return canonical_words(m)
        out = np.zeros((m, 4), np.uint64)
        if skew == "zero_one":
            out[:, 0] = rng.integers(0, 2, size=m, dtype=np.uint64)
        elif skew == "repeated":
            out[:] = canonical_words(1)
        elif skew != "zero":
            raise ValueError(f"unknown skew {skew!r}")
        return out

    def entry(name, wrapper, replaces, res, **more):
        return dict(
            name=name, wrapper=wrapper, route="cuda",
            source=f"protocol_tpu_torch/ops/csrc/{name}.cu", replaces=replaces, path="graft",
            max_abs_err=0.0, ms=res["ms"], plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
            bound_by=res["bound_by"], library_ms=res.get("library_ms"), shape=res["shape"], **more,
        )

    def bounds(nbytes, ops):
        return dict(bound_ms=bound_ms(nbytes, ops, INT32_OPS_PER_S),
                    bound_by=bound_by(nbytes, ops, INT32_OPS_PER_S), bytes=nbytes, imads=ops)

    # -- K10: both fields, the three operations, the edge values first ---
    n = GRAFT["k10_n"]
    k10 = {}
    for F in (gf.FR, gf.FQ):
        wa, wb = canonical_words(n), canonical_words(n)
        edge = [0, 1, F.p - 1, F.r, F.r2]
        wa[: len(edge)] = to_limbs_fast(edge)
        wb[: len(edge)] = to_limbs_fast(edge[::-1])
        wb[len(edge) : 2 * len(edge)] = to_limbs_fast(edge)
        a, b = gf.u64_to_tensor(wa, dev), gf.u64_to_tensor(wb, dev)
        same = {op: torch.equal(gf.field_op(a, b, F, op), gf._plain(a, b, F, op))
                for op in ("mul", "add", "sub")}
        same["to_mont"] = torch.equal(F.to_mont(a), gf._plain(a, F.const(F.r2, dev), F, "mul"))
        check(all(same.values()), f"graft: K10 ({F.name}) differs from its plain version: {same}")
        k10[F.name] = dict(
            shape=[n, 4], equal=same,
            ms=time_ms(lambda: gf.field_op(a, b, F)),
            plain_ms=time_ms(lambda: gf._plain(a, b, F, "mul"), reps=GRAFT["plain_reps"], warmup=1),
            broadcast_ms=time_ms(lambda: F.to_mont(a)),
            **bounds(96 * n, IMADS_A_MUL * n),
        )
    rec["k10"] = k10

    # -- K11 at 2^k and the extended domain; ntt_limbs vs native -----------
    # Both passes against the plain version's, bit for bit: the first pass
    # alone, then the whole NTT, forward and inverse; beside them the first
    # NTT's stages in a row (the yardstick) on the same elements.
    k11 = {}
    for kk in (k, ext_k):
        d = plonk.Domain(kk)
        x = gf.u64_to_tensor(canonical_words(d.n), dev)
        row = {}
        for inverse in (False, True):
            plan = gntt._device_plan(d.n, d.omega_inv if inverse else d.omega, dev)
            first = torch.equal(gntt.ntt_device(x, plan, inverse, max_passes=1),
                                gntt._ntt_plain(x, plan, inverse, None, 1))
            whole = torch.equal(gntt.ntt_device(x, plan, inverse), gntt._ntt_plain(x, plan, inverse))
            check(first and whole, f"graft: K11 at 2^{kk} (inverse {inverse}) differs from its "
                  f"plain version: first pass {first}, whole {whole}")
            z = x.clone()
            # A whole NTT reads its input and twiddles once and writes its
            # output once, and needs a multiply for each butterfly whose
            # twiddle is not 1 (and the inverse's 1/n products).
            row["inverse" if inverse else "forward"] = dict(
                ms=time_ms(lambda: gntt.ntt_device(x, plan, inverse)),
                plain_ms=time_ms(lambda: gntt._ntt_plain(x, plan, inverse),
                                 reps=GRAFT["plain_reps"], warmup=1),
                earlier_ms=time_ms(lambda: ys.ntt_stages(z, plan)),
                **bounds(64 * d.n + 32 * (d.n - 1),
                         IMADS_A_MUL * gntt.needed_multiplies(d.n, inverse)),
            )
        k11[f"2^{kk}"] = dict(
            shape=[d.n, 4], passes=gntt.passes(d.n), earlier_launches=kk, **row["forward"],
            inverse=row["inverse"],
        )
    ntt_parity = {}
    with calls.recording():
        for kk in sorted({k, ext_k}):
            d = plonk.Domain(kk)
            vals = canonical_words(d.n)
            vals[0], vals[1] = 0, to_limbs_fast([R - 1])[0]
            fwd = d.ntt_limbs(vals.copy(), d.omega, False)
            inv = d.ntt_limbs(vals.copy(), d.omega_inv, True)
            with use_zk_backend("graft", dev):
                g_fwd = d.ntt_limbs(vals.copy(), d.omega, False)
                g_inv = d.ntt_limbs(vals.copy(), d.omega_inv, True)
                back = d.ntt_limbs(g_fwd.copy(), d.omega_inv, True)
            ntt_parity[kk] = dict(forward=bool(np.array_equal(g_fwd, fwd)),
                                  inverse=bool(np.array_equal(g_inv, inv)),
                                  round_trip=bool(np.array_equal(back, vals)))
    check(all(all(v.values()) for v in ntt_parity.values()),
          f"graft: ntt_limbs differs from native zk_ntt: {ntt_parity}")
    for row in k11.values():
        for r in (row, row["inverse"]):
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
            r["earlier_share_of_bound"] = r["bound_ms"] / r["earlier_ms"]
    rec["k11"], rec["ntt_vs_native"] = k11, ntt_parity

    # -- K12 across sizes and skews, against its plain version bit for bit --
    # The library call: one stable torch.sort of each window's bytes.
    def library(st):
        return torch.sort(st.view(torch.uint8).reshape(st.shape[0], 32).t(), dim=-1, stable=True)

    k12 = {}
    for m in GRAFT["k12_sizes"]:
        for skew in GRAFT["k12_skews"]:
            st = gf.u64_to_tensor(k12_scalars(m, skew), dev)
            ds, perm = gpp.msm_window(st)
            ds_p, perm_p = gpp._window_plain(st)
            lib = library(st)
            e_ds, _ = ys.msm_window_atomic(st)
            check(torch.equal(ds, ds_p) and torch.equal(perm, perm_p),
                  f"graft: K12 at m = {m} ({skew}) differs from its plain version")
            check(torch.equal(lib.values.to(torch.int32), ds) and torch.equal(lib.indices.to(torch.int32), perm),
                  f"graft: K12 at m = {m} ({skew}) differs from its library call")
            check(torch.equal(e_ds, ds_p), f"graft: K12's first form at m = {m} ({skew}) differs "
                  f"from the plain version's digits")
            if m in GRAFT["k12_timed"] and skew in ("random", "zero_one"):
                # Reads each scalar's 32 bytes once, writes ds and perm.
                k12[f"2^{m.bit_length() - 1} {skew}"] = dict(
                    shape=[m, 4], ms=time_ms(lambda: gpp.msm_window(st)),
                    earlier_ms=time_ms(lambda: ys.msm_window_atomic(st)),
                    plain_ms=time_ms(lambda: gpp._window_plain(st)),
                    library_ms=time_ms(lambda: library(st)), **bounds(32 * m + 8 * 32 * m, 0))
    for row in k12.values():
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["earlier_share_of_bound"] = row["bound_ms"] / row["earlier_ms"]

    # -- K13 and msm_limbs at 2^14: random, {0, 1}; the n = 33 batch --
    mn = GRAFT["msm_n"]
    with calls.recording():
        with use_zk_backend("graft", dev):
            cache = srs._graft_cache()
    native_points = znative._points_to_limbs(srs.g1_powers[:mn])
    pts = cache.points[:mn]
    cases = {"random": canonical_words(mn),
             "zero_one": np.zeros((mn, 4), np.uint64)}
    cases["zero_one"][:, 0] = rng.integers(0, 2, size=mn, dtype=np.uint64)
    msm_parity, k13 = {}, {}
    for name, words in cases.items():
        st = gf.u64_to_tensor(words, dev)
        ds, perm = gpp.msm_window(st)
        ds_p, perm_p = gpp._window_plain(st)
        check(torch.equal(ds, ds_p) and torch.equal(perm, perm_p),
              f"graft: K12 ({name}) differs from its plain version")
        grid = gpp.msm_bucket(ds, perm, pts)
        grid_p = gpp._buckets_plain(ds_p, perm_p, pts)
        buckets_ok = normalized_buckets(grid) == normalized_buckets(grid_p)
        check(buckets_ok and bool((grid[:, 0] == 0).all()),
              f"graft: K13 ({name}) buckets differ from the plain buckets as points")
        with calls.recording():
            got = gpp.msm_limbs(words, cache)
        want = znative.msm_limbs(words, native_points)
        msm_parity[name] = got == want
        # What this data needs, whatever computes it: a mixed add (the
        # cache's points are affine) for each non-zero lane past the first
        # of its bucket.
        nz = int((ds != 0).sum())
        filled = sum(len(set(row[row != 0].tolist())) for row in ds.cpu())
        madds = nz - filled
        k13[name] = dict(shape=[32, mn], nonzero_lanes=nz, nonempty_buckets=filled,
                         mixed_adds=madds,
                         ms=time_ms(lambda: gpp.msm_bucket(ds, perm, pts)),
                         earlier_ms=time_ms(lambda: ys.msm_bucket_chunked(ds, perm, pts)),
                         plain_ms=time_ms(lambda: gpp._buckets_plain(ds_p, perm_p, pts),
                                          reps=GRAFT["plain_reps"], warmup=1),
                         # reads the digits, the order and each point once,
                         # writes the grid.
                         **bounds(8 * 32 * mn + 96 * mn + 32 * 256 * 96, IMADS_A_MADD * madds))
        k13[name]["share_of_bound"] = k13[name]["bound_ms"] / k13[name]["ms"]
        k13[name]["earlier_share_of_bound"] = k13[name]["bound_ms"] / k13[name]["earlier_ms"]
    # The reference test's edge batch: n = 33 (padded to 64), a zero
    # scalar, r - 1, an identity point and a duplicated point.
    e_scalars = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(33)]
    e_points = [GENERATOR.mul(int.from_bytes(rng.bytes(32), "little") % R or 1) for _ in range(33)]
    e_scalars[0], e_scalars[1] = 0, R - 1
    e_points[2] = IDENTITY
    e_points[4] = e_points[3]
    exact = functools.reduce(G1.add, (p.mul(s) for s, p in zip(e_scalars, e_points)), IDENTITY)
    e_cache = gpp.PointCache.build(e_points, dev)
    e_words = np.zeros((64, 4), np.uint64)
    e_words[:33] = to_limbs_fast(e_scalars)
    e_ds, e_perm = gpp.msm_window(gf.u64_to_tensor(e_words, dev))
    e_ds_p, e_perm_p = gpp._window_plain(gf.u64_to_tensor(e_words, dev))
    check(torch.equal(e_ds, e_ds_p) and torch.equal(e_perm, e_perm_p),
          "graft: K12 (the n = 33 edge batch) differs from its plain version")
    e_grid = gpp.msm_bucket(e_ds, e_perm, e_cache.points[:64])
    e_plain = gpp._buckets_plain(e_ds, e_perm, e_cache.points[:64])
    check(normalized_buckets(e_grid) == normalized_buckets(e_plain) and bool((e_grid[:, 0] == 0).all()),
          "graft: K13 (the n = 33 edge batch) buckets differ from the plain buckets as points")
    k13["edge_33"] = dict(shape=[32, 64], equal=True)
    with calls.recording():
        with use_zk_backend("graft", dev):
            from protocol_tpu_torch.zk import kzg

            edge_got = kzg.msm(e_scalars, e_points)
    edge_native = znative.msm_limbs(to_limbs_fast(e_scalars), znative._points_to_limbs(e_points))
    msm_parity["edge_33"] = edge_got == exact and edge_native == exact
    check(all(msm_parity.values()), f"graft: msm_limbs differs from native: {msm_parity}")
    rec.update(msm_vs_native=msm_parity, k12=k12, k13=k13,
               k12_checked=[[m, skew] for m in GRAFT["k12_sizes"] for skew in GRAFT["k12_skews"]])

    # -- the default epoch proved under graft, against the native card proof --
    from protocol_tpu_torch.node.manager import ManagerConfig

    wrappers = graft_wrappers()
    # The prove builds its SRS's point cache on the card, as a node's first
    # graft prove does (K10's launches on the path).
    srs._graft_points.clear()
    for w in wrappers:
        w.launches = 0
    finish0 = gpp.finish_stats()
    with calls.recording():
        g = run_plonk_node(ManagerConfig(zk_backend="graft", **plonk_ctx["config"]),
                           plonk_ctx["prover"], plonk_ctx["atts"], plonk_ctx["trust_wrappers"])
    launches = {w.__name__: w.launches for w in wrappers}
    finish1 = gpp.finish_stats()
    native = plonk_ctx["card"]
    t0 = time.perf_counter()
    ok = plonk_ctx["prover"].verify(g["pub_ins"], g["proof"])
    rec["prove"] = dict(
        snark_s=g["snark_s"], native_snark_s=native["snark_s"], verify_s=time.perf_counter() - t0,
        circuit_check_s=g["circuit_check_s"], prove_phases=g["prove_phases"],
        native_prove_phases=native["prove_phases"], launches=launches,
        finish_calls=finish1["calls"] - finish0["calls"],
        finish_s=finish1["seconds"] - finish0["seconds"],
        proof_equal=g["proof"] == native["proof"] and g["pub_ins"] == native["pub_ins"],
    )
    check(ok, "graft: the graft-proved epoch does not verify")
    check(rec["prove"]["proof_equal"], "graft: the graft proof differs from the native card proof")
    check(all(v > 0 for v in launches.values()), f"graft: a kernel did not launch: {launches}")
    engines = {(name, row.get("engine")) for name, row in g["prove_phases"].items()}
    check({("msm", "graft"), ("ntt", "graft")} <= engines,
          f"graft: the prove's phase table has no graft msm/ntt rows: {sorted(engines)}")
    rec["budget_calls"] = len(calls.calls)
    check(not calls.off_budget, f"graft: calls off their declared launches: {calls.off_budget[:5]}")

    # -- rates: bench/msm_bench.py's metrics, both engines --------------------
    rates = {}
    for size in GRAFT["rate_sizes"]:
        words = canonical_words(size)
        d = plonk.Domain(size.bit_length() - 1)

        def wall(fn):
            times = []
            for _ in range(GRAFT["rate_reps"]):
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)
            return statistics.median(times)

        def ntt_graft():
            with use_zk_backend("graft", dev):
                d.ntt_limbs(words.copy(), d.omega, False)

        native_msm = wall(lambda: znative.msm_limbs(words, native_points[:size]))
        graft_msm = wall(lambda: gpp.msm_limbs(words, cache))
        native_ntt = wall(lambda: d.ntt_limbs(words.copy(), d.omega, False))
        graft_ntt = wall(ntt_graft)
        butterflies = size // 2 * (size.bit_length() - 1)
        rates[size] = dict(
            native=dict(msm_points_per_s=size / native_msm, ntt_butterflies_per_s=butterflies / native_ntt),
            graft=dict(msm_points_per_s=size / graft_msm, ntt_butterflies_per_s=butterflies / graft_ntt),
        )
    rec["rates"] = rates
    emit("graft", nvidia_smi=smi, seconds=time.perf_counter() - t_phase, **rec)

    return [
        entry("zk_mulmod", "field_op", "protocol_tpu/zk/graft/field.py:266 + :271",
              k10["fq"], launches=launches["field_op"],
              graft_launches=launches["field_op"], fr=k10["fr"]),
        entry("zk_ntt", "ntt_device",
              "protocol_tpu/zk/graft/ntt.py:77 (+ :100, :129)", k11[f"2^{ext_k}"],
              launches=launches["ntt_device"], graft_launches=launches["ntt_device"],
              earlier_ms=k11[f"2^{ext_k}"]["earlier_ms"],
              earlier_source="protocol_tpu_torch/bench/csrc/zk_ntt_stage.cu",
              sizes=k11),
        entry("zk_msm_window", "msm_window", "protocol_tpu/zk/graft/pippenger.py:142",
              k12["2^14 random"], launches=launches["msm_window"],
              graft_launches=launches["msm_window"], earlier_ms=k12["2^14 random"]["earlier_ms"],
              earlier_source="protocol_tpu_torch/bench/csrc/zk_msm_window_atomic.cu",
              skew=k12["2^14 zero_one"], sizes=k12),
        entry("zk_msm_bucket", "msm_bucket",
              "protocol_tpu/zk/graft/pippenger.py:150 + :166 + :171", k13["random"],
              launches=launches["msm_bucket"], graft_launches=launches["msm_bucket"],
              launches_a_call=["piece", "join"], earlier_ms=k13["random"]["earlier_ms"],
              earlier_source="protocol_tpu_torch/bench/csrc/zk_msm_bucket_chunked.cu",
              skew=k13["zero_one"]),
    ]


PLANES = dict(
    # Admission: the node cell's seeded group, verify pools of 0 and 2
    # spawned workers, then rounds of the group's attestations for sigs/s.
    group=64, batch_size=16, verify_workers=(0, 2), rounds=8,
    # Async proving: the plonk cell's default node, one spawned prewarmed
    # prover worker, ticks paced at the reference's epoch_interval
    # (protocol_tpu/node/config.py:16), under each proving engine.
    ticks=3, interval_s=10.0, zk_backends=("native", "graft"), prove_timeout_s=600.0,
)


def reset_worker_launches() -> int:
    """Run in a prover worker: every graft wrapper's count set to 0.
    Returns the worker's pid."""
    for w in graft_wrappers():
        w.launches = 0
    return os.getpid()


def read_worker_launches() -> tuple[int, dict]:
    """Run in a prover worker: its pid and each graft wrapper's count."""
    return os.getpid(), {w.__name__: w.launches for w in graft_wrappers()}


def pool_processes(pool) -> list:
    """The live worker processes of a verify or prover pool."""
    _, executor = pool._snapshot()
    return list(getattr(executor, "_processes", {}).values()) if executor is not None else []


def join_processes(procs) -> None:
    """Wait for a closed pool's workers to exit; terminate stragglers."""
    for p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.terminate()
            p.join(timeout=10)


def admission_stream(fixed_set, atts):
    """The admission cell's submissions, ``(pre, post)``, each a list of
    ``(attestation, nonce)``: ``pre`` goes in before the plane starts,
    the group's attestations (nonce 1), which fill a submit queue of the
    group's size, then a burst of 4 fresh re-attestations past it; after
    the start, ``post``: 4 re-attestations of member 0 with rising
    nonces, a replay, a stale nonce, a bad signature and a structurally
    invalid item."""
    from protocol_tpu_torch.crypto import calculate_message_hash
    from protocol_tpu_torch.crypto.eddsa import sign
    from protocol_tpu_torch.node.attestation import Attestation
    from protocol_tpu_torch.node.bootstrap import keyset_from_raw

    sks, pks = keyset_from_raw(fixed_set)
    n = len(pks)

    def moved(i, step):
        """Member i's row with ``step`` units moved from its largest
        score to a neighbour's: still summing to SCALE, no self-score."""
        row = list(atts[i].scores)
        k = max((j for j in range(n) if j != i), key=lambda j: row[j])
        m = (i + 1) % n if k != (i + 1) % n else (i + 2) % n
        row[k] -= step
        row[m] += step
        return row

    def signed(i, scores, signed_scores=None):
        _, msgs = calculate_message_hash(pks, [signed_scores or scores])
        return Attestation(sig=sign(sks[i], pks[i], msgs[0]), pk=pks[i], neighbours=list(pks),
                           scores=scores)

    pre = [(a, 1) for a in atts] + [(signed(i, moved(i, 1)), 2) for i in range(4, 8)]
    post = [(signed(0, moved(0, s)), 1 + s) for s in range(1, 5)]
    mismatch = signed(6, moved(6, 2))
    post += [
        (atts[10], 1),                                   # replay
        (signed(0, moved(0, 5)), 3),                     # stale nonce
        (signed(5, moved(5, 2), atts[5].scores), 2),     # bad signature
        (Attestation(sig=mismatch.sig, pk=mismatch.pk, neighbours=list(reversed(pks)),
                     scores=mismatch.scores), None),     # group mismatch
    ]
    return pre, post


def verify_split(fixed_set, atts) -> dict:
    """Host milliseconds an item of the group's attestations spends in
    each step of admission, one batch of the whole group each: the wire
    form intake digests, the message hash (a Poseidon sponge over the
    score row), the native batch EdDSA, and ``verify_batch`` whole."""
    from protocol_tpu_torch.crypto import group_pks_hash, message_hash_batch
    from protocol_tpu_torch.crypto import native as cnative
    from protocol_tpu_torch.ingest.workers import verify_batch
    from protocol_tpu_torch.node.attestation import AttestationData
    from protocol_tpu_torch.node.bootstrap import keyset_from_raw

    _, pks = keyset_from_raw(fixed_set)
    pks_hash = group_pks_hash(pks)
    items = [(a.sig.big_r.x, a.sig.big_r.y, a.sig.s, a.pk.point.x, a.pk.point.y, tuple(a.scores))
             for a in atts]

    def ms(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3 / len(items)

    _, wire = ms(lambda: [AttestationData.from_attestation(a).to_bytes() for a in atts])
    msgs, hashing = ms(lambda: message_hash_batch(pks_hash, [list(a.scores) for a in atts]))
    ok, eddsa = ms(lambda: cnative.eddsa_verify_batch(*([it[k] for it in items] for k in range(5)), msgs))
    whole_ok, whole = ms(lambda: verify_batch(pks_hash, items))
    check(all(ok) and all(whole_ok), "planes: the group's signatures do not verify")
    return dict(wire_form=wire, message_hash=hashing, eddsa=eddsa, verify_batch=whole)


def run_admission(config, pre, post, workers, rounds, wrappers):
    """The stream through an ``IngestPlane`` in front of a fresh manager
    of ``config`` with ``workers`` spawned verify workers (an injected
    clock and an open rate gate, so every verdict is a function of the
    stream), then ``rounds`` of the group's attestations for sigs/s (two
    epoch rotations before each, so the dedup cache has forgotten them),
    then one epoch converged from what the plane admitted."""
    from protocol_tpu_torch.ingest import IngestPlane, IngestPlaneConfig
    from protocol_tpu_torch.ingest.ratelimit import AdmissionPolicy, RateLimitConfig
    from protocol_tpu_torch.node.epoch import Epoch
    from protocol_tpu_torch.node.manager import Manager

    group = [a for a, _ in pre[:PLANES["group"]]]
    manager = Manager(config)
    rate = RateLimitConfig(rate=1e6, burst=1e6)
    plane = IngestPlane(manager, IngestPlaneConfig(
        workers=workers, batch_size=PLANES["batch_size"], submit_queue_max=len(group), rate=rate))
    plane.policy = AdmissionPolicy(rate, clock=lambda: 0.0)
    procs = []
    try:
        t0 = time.perf_counter()
        futures = [plane.submit(att, nonce=nonce) for att, nonce in pre]
        plane.start()
        check(plane.drain(120), f"planes: the admission stream did not drain ({workers} workers)")
        futures += [plane.submit(att, nonce=nonce) for att, nonce in post]
        check(plane.drain(120), f"planes: the admission stream did not drain ({workers} workers)")
        stream_s = time.perf_counter() - t0
        verdicts = [(f.result().accepted, f.result().reason) for f in futures]
        cache = sorted((h, tuple(a.scores)) for h, a in manager.attestations.items())
        # Verify workers apply their batches as they finish, so the cache's
        # insertion order, which numbers the graph's peers, varies between
        # runs; the converge takes the admitted cache in sender-hash order.
        apply_order = list(manager.attestations)
        manager.attestations = dict(sorted(manager.attestations.items()))
        for w in wrappers:
            w.launches = 0
        result = manager.converge_epoch(Epoch(0), **NODE_KW)
        launches = {w.__name__: w.launches for w in wrappers}
        accepted0 = plane.stats()["accepted"]
        t0 = time.perf_counter()
        for _ in range(rounds):
            plane.advance_epoch()
            plane.advance_epoch()
            for att in group:
                plane.submit(att)
            check(plane.drain(120), f"planes: a throughput round did not drain ({workers} workers)")
        rounds_s = time.perf_counter() - t0
        stats = plane.stats()
        procs = pool_processes(plane.pool)
    finally:
        plane.close()
        join_processes(procs)
    sigs = stats["accepted"] - accepted0
    check(sigs == rounds * len(group), f"planes: {sigs} of {rounds * len(group)} round items accepted")
    return dict(verdicts=verdicts, stream_s=stream_s, sigs=sigs, rounds_s=rounds_s,
                sigs_per_s=sigs / rounds_s if sigs else None, worker_processes=len(procs),
                stats=stats, iterations=result.iterations, scores=result.scores,
                launches=launches, cache=cache, apply_order=apply_order)


def run_async(plonk_ctx, zk_backend, wrappers, check):
    """The plonk cell's default node ticking in async mode through the
    server's own tick (``Node._epoch_tick``): each tick converges on the
    card under the epoch's trace root, then enqueues ``build_proof_job``
    on a ``ProvingPlane`` with one spawned prover worker (prewarmed after
    the parent's disk key cache, under ``graft`` with the point cache on
    the card too), whose ``on_proved`` installs each landed proof.  The
    node is built on a manager of the given engine (``Node`` takes a
    manager), and no loop of it is started: ``PLANES["ticks"]`` ticks
    paced at ``interval_s``, then a drain.  Each wrapper's launches: the
    parent's converges (set to 0 before the first tick, read after the
    drain) and the worker's graft kernels (set to 0 before its prewarm)."""
    from protocol_tpu_torch.node.config import ProtocolConfig
    from protocol_tpu_torch.node.epoch import Epoch
    from protocol_tpu_torch.node.manager import Manager, ManagerConfig
    from protocol_tpu_torch.node.server import Node
    from protocol_tpu_torch.obs import TIMELINE, TRACER
    from protocol_tpu_torch.obs.metrics import PROOF_LAG_EPOCHS
    from protocol_tpu_torch.prover import ProvingPlane, ProvingPlaneConfig

    m = Manager(ManagerConfig(zk_backend=zk_backend, **plonk_ctx["config"]), prover=plonk_ctx["prover"])
    rejected = [v.reason for v in m.add_attestations_bulk(plonk_ctx["atts"]) if not v.accepted]
    check(not rejected, f"planes: attestations rejected: {rejected}")
    cfg = m.config
    node = Node(config=ProtocolConfig(
        epoch_interval=int(PLANES["interval_s"]), trust_backend=cfg.backend, prover=cfg.prover,
        srs_path=cfg.srs_path, async_prover=True, prover_workers=1, prover_queue_max=1,
        prove_timeout_s=PLANES["prove_timeout_s"]), manager=m)
    landed = {}

    def on_proved(result):
        landed[result.epoch] = dict(t=time.perf_counter(), result=result)
        m.install_proof(result.epoch, result.pub_ins, result.proof)

    params = (cfg.num_neighbours, cfg.num_iter, cfg.initial_score, cfg.scale)
    job0 = m.build_proof_job(Epoch(0))
    plane = ProvingPlane(ProvingPlaneConfig(workers=1, queue_depth=1,
                                            prove_timeout_s=PLANES["prove_timeout_s"]),
                         on_proved=on_proved).start()
    node._prover_plane = plane
    procs = []
    try:
        _, executor = plane.pool._snapshot()
        t0 = time.perf_counter()
        pid = executor.submit(reset_worker_launches).result(timeout=300)
        spawn_s = time.perf_counter() - t0
        procs = pool_processes(plane.pool)
        generation = plane.pool.generation
        t0 = time.perf_counter()
        plane.prewarm(params, cfg.prover, cfg.srs_path, zk_backend=zk_backend, zk_device=job0.zk_device)
        prewarm_s = time.perf_counter() - t0
        for w in wrappers:
            w.launches = 0
        ticks = []
        t_loop = time.perf_counter()
        for k in range(PLANES["ticks"]):
            wait = t_loop + k * PLANES["interval_s"] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            t0 = time.perf_counter()
            node._epoch_tick(Epoch(k))
            t1 = time.perf_counter()
            phases = (TIMELINE.get(k) or {}).get("phases", {})
            ticks.append(dict(epoch=k, started_s=t0 - t_loop, tick_s=t1 - t0,
                              converge_s=phases.get("converge"), enqueue_s=phases.get("prove_enqueue"),
                              iterations=m.cached_results[Epoch(k)].iterations,
                              state_after_tick=plane.status(k).state,
                              lag_epochs=PROOF_LAG_EPOCHS.value()))
        loop_end = t_loop + PLANES["ticks"] * PLANES["interval_s"]
        time.sleep(max(0.0, loop_end - time.perf_counter()))
        t0 = time.perf_counter()
        drained = plane.drain(PLANES["prove_timeout_s"])
        drain_s = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in wrappers}
        worker_pid, worker_launches = executor.submit(read_worker_launches).result(timeout=60)
        stats = plane.stats()
        restarts = plane.pool.generation - generation
        lag_epochs_after = PROOF_LAG_EPOCHS.value()
        lag_s = {e: plane.status(e).lag_seconds for e in range(PLANES["ticks"])}
    finally:
        plane.close()
        join_processes(procs)
    check(drained, f"planes {zk_backend}: the proving plane did not drain")
    check(pid == worker_pid and restarts == 0,
          f"planes {zk_backend}: the prover worker was replaced ({pid} -> {worker_pid}, {restarts} restarts)")
    # Proving time inside the tick loop's window, from each landed
    # proof's prove seconds ending when it landed.
    proving, hidden = 0.0, 0.0
    for rec in landed.values():
        end, seconds = rec["t"], rec["result"].prove_seconds
        proving += seconds
        hidden += max(0.0, min(end, loop_end) - max(end - seconds, t_loop))
    return dict(
        manager=m, landed=landed, stats=stats, ticks=ticks, spawn_s=spawn_s, prewarm_s=prewarm_s,
        drain_s=drain_s, loop_s=loop_end - t_loop, lag_epochs_after_drain=lag_epochs_after,
        lag_s=lag_s, launches=launches, worker_launches=worker_launches, worker_pid=worker_pid,
        zk_device=job0.zk_device, overlap_share=hidden / proving if proving else None,
        prove_s={e: landed[e]["result"].prove_seconds for e in sorted(landed)},
        tick_traces={e: TRACER.get_trace(e) for e in range(PLANES["ticks"])},
    )


def planes_phase(plonk_ctx, trust_wrappers, check, emit, smi) -> dict:
    """The admission plane and the async proving plane on the card.

    Admission: ``admission_stream`` over the node cell's 64-member group
    through ``IngestPlane`` in front of a ``cuda-windowed`` manager on
    the card with 0 and with 2 spawned verify workers, and on the CPU
    with 0: every verdict and reason equal across the three and to the
    direct ``Manager.add_attestations_bulk`` wherever the plane's own
    gates (dedup, nonce, rate, queue) let the item reach the checks the
    direct path makes; sigs/s for each pool; an epoch converged from
    what each plane admitted, the card runs bit-equal, the CPU run
    within L1 1e-6 at the same iterations.

    Async proving: ``run_async`` under ``native`` and under ``graft``
    (the worker proves on the card, in its own CUDA context): no job
    failed, every landed proof equal to the sync prove's bytes for its
    statement and verifying, the worker's grafted span tree holding
    ``snark`` with its phases (graft's msm and ntt rows under graft),
    the graft worker's kernels launched, the parent's converges on the
    backend's budget.  Returns each wrapper's launches on the phase's
    path: the converges in this process, the graft kernels in the
    worker."""
    import numpy as np

    from protocol_tpu_torch.analysis.budget import KERNEL_INVARIANTS
    from protocol_tpu_torch.node.epoch import Epoch
    from protocol_tpu_torch.node.manager import Manager, ManagerConfig
    from protocol_tpu_torch.zk.proof import CACHE_ENV

    t_phase = time.perf_counter()
    plane_only = {"duplicate", "stale-nonce", "rate-limited", "spam-score", "queue-full"}

    # -- admission ------------------------------------------------------------
    t0 = time.perf_counter()
    fixed_set, atts, _ = node_group(PLANES["group"], NODE["seed"])
    pre, post = admission_stream(fixed_set, atts)
    stream_build_s = time.perf_counter() - t0
    base = dict(backend="cuda-windowed", prover="commitment", check_circuit=False,
                fixed_set=list(fixed_set), num_neighbours=len(fixed_set))
    runs = {}
    for workers in PLANES["verify_workers"]:
        runs[f"card/{workers}"] = run_admission(ManagerConfig(**base), pre, post, workers,
                                                PLANES["rounds"], trust_wrappers)
    runs["cpu/0"] = run_admission(ManagerConfig(device="cpu", **base), pre, post, 0,
                                  PLANES["rounds"], trust_wrappers)
    direct = Manager(ManagerConfig(**base))
    t0 = time.perf_counter()
    direct_verdicts = [(v.accepted, v.reason) for v in direct.add_attestations_bulk(
        [a for a, _ in pre + post])]
    direct_s = time.perf_counter() - t0
    split = verify_split(fixed_set, atts)
    want = ([(True, None)] * PLANES["group"] + [(False, "queue-full")] * 4 + [(True, None)] * 4
            + [(False, "duplicate"), (False, "stale-nonce"), (False, "bad-signature"),
               (False, "group-mismatch")])
    card0, card2, cpu = runs["card/0"], runs[f"card/{PLANES['verify_workers'][-1]}"], runs["cpu/0"]
    compared = [(p, d) for p, d in zip(card0["verdicts"], direct_verdicts) if p[1] not in plane_only]
    budget = KERNEL_INVARIANTS["cuda-windowed"]
    admission = dict(
        stream_items=len(pre) + len(post), stream_build_s=stream_build_s,
        verdicts_equal_across_runs=all(r["verdicts"] == card0["verdicts"] for r in runs.values()),
        verdicts_as_designed=card0["verdicts"] == want,
        direct_compared=len(compared), direct_equal=all(p == d for p, d in compared),
        direct_items_per_s=len(pre + post) / direct_s, host_ms_per_item=split,
        reasons={r: sum(1 for _, why in card0["verdicts"] if why == r)
                 for r in sorted({why for _, why in card0["verdicts"]}, key=str)},
        caches_equal=all(r["cache"] == card0["cache"] for r in runs.values()),
        apply_order_equal={k: r["apply_order"] == card0["apply_order"] for k, r in runs.items()},
        converge_bit_equal=bool(np.array_equal(card0["scores"], card2["scores"])),
        converge_l1_vs_cpu=float(np.abs(card0["scores"] - cpu["scores"]).sum()),
        iterations={k: r["iterations"] for k, r in runs.items()},
        launches_match_budget={
            k: r["launches"] == {**{w.__name__: 0 for w in trust_wrappers},
                                 **budget.expected_launches(r["iterations"])}
            for k, r in runs.items() if k.startswith("card")
        },
        runs={k: {f: r[f] for f in ("stream_s", "sigs", "rounds_s", "sigs_per_s", "worker_processes",
                                    "stats", "iterations", "launches")} for k, r in runs.items()},
    )
    check(admission["verdicts_equal_across_runs"],
          f"planes: verdicts differ between runs: {[(k, r['verdicts'][-8:]) for k, r in runs.items()]}")
    check(admission["verdicts_as_designed"], f"planes: verdicts {card0['verdicts'][-12:]}, want {want[-12:]}")
    check(admission["direct_equal"] and len(compared) == len(want) - 6,
          f"planes: the plane and the direct path disagree: {compared}")
    check(admission["caches_equal"], "planes: the admitted caches differ between runs")
    check(admission["converge_bit_equal"], "planes: the card converges after 0 and 2 workers differ")
    check(card0["iterations"] == cpu["iterations"] and admission["converge_l1_vs_cpu"] <= 1e-6,
          f"planes: card vs CPU converge {admission['iterations']}, L1 {admission['converge_l1_vs_cpu']}")
    check(all(admission["launches_match_budget"].values()),
          f"planes: admission converges off budget: {admission['runs']}")
    # The executor spawns its processes as the load asks, up to the pool's size.
    check(1 <= card2["worker_processes"] <= PLANES["verify_workers"][-1],
          f"planes: {card2['worker_processes']} verify workers ran")
    emit("planes_admission", nvidia_smi=smi, **admission)

    # -- async proving --------------------------------------------------------
    # The workers load the key the plonk phase's cold keygen wrote.
    os.environ[CACHE_ENV] = str(plonk_ctx["keys"])
    prover = plonk_ctx["prover"]
    sync_ms = Manager(ManagerConfig(**plonk_ctx["config"]), prover=prover)
    sync_ms.add_attestations_bulk(plonk_ctx["atts"])
    sync = {PLONK["epochs"] - 1: plonk_ctx["card"]["proof"]}
    sync_tick_s = plonk_ctx["card"]["epochs"][-1]["seconds"] + plonk_ctx["card"]["circuit_check_s"] \
        + plonk_ctx["card"]["snark_s"]
    graft_names = [w.__name__ for w in graft_wrappers()]
    totals = {w.__name__: 0 for w in trust_wrappers}
    totals.update({name: 0 for name in graft_names})
    proving = {}
    for zk_backend in PLANES["zk_backends"]:
        r = run_async(plonk_ctx, zk_backend, trust_wrappers, check)
        stats, ticks = r["stats"], r["ticks"]
        states = {e: s["state"] for e, s in stats["states"].items()}
        check(stats["failed"] == 0 and all(s in ("proved", "superseded") for s in states.values()),
              f"planes {zk_backend}: a proof job failed or crashed: {stats['states']}")
        check(states.get(PLANES["ticks"] - 1) == "proved",
              f"planes {zk_backend}: the newest epoch was not proved: {states}")
        equal, verified, spans = {}, {}, {}
        for e, rec in sorted(r["landed"].items()):
            res = rec["result"]
            if e not in sync:
                sync_ms.calculate_proofs(Epoch(e))
                sync[e] = sync_ms.get_proof(Epoch(e)).proof
            equal[e] = res.proof == sync[e]
            verified[e] = prover.verify(list(res.pub_ins), res.proof)
            trace = r["tick_traces"][e] or {}
            prove = next((c for c in trace.get("children", ()) if c["name"] == "prove"), {})
            snark = next((c for c in prove.get("children", ()) if c["name"] == "snark"), {})
            spans[e] = {c["name"]: (c.get("attrs") or {}).get("engine")
                        for c in snark.get("children", ())}
        check(all(equal.values()) and all(verified.values()),
              f"planes {zk_backend}: landed proofs equal the sync bytes {equal}, verify {verified}")
        check(all({"msm", "ntt"} <= set(s) for s in spans.values()),
              f"planes {zk_backend}: grafted snark spans lack their phases: {spans}")
        if zk_backend == "graft":
            check(all(s["msm"] == "graft" and s["ntt"] == "graft" for s in spans.values()),
                  f"planes graft: the worker's msm/ntt rows are not graft's: {spans}")
            check(all(v > 0 for v in r["worker_launches"].values()),
                  f"planes graft: a kernel did not launch in the worker: {r['worker_launches']}")
            check(r["zk_device"] is not None and r["zk_device"].startswith("cuda"),
                  f"planes graft: the job's device is {r['zk_device']}")
        else:
            check(not any(r["worker_launches"].values()),
                  f"planes native: the worker launched graft kernels: {r['worker_launches']}")
        iterations = sum(t["iterations"] for t in ticks)
        want_launches = {w.__name__: 0 for w in trust_wrappers}
        want_launches.update(budget.expected_launches(iterations))
        check(r["launches"] == want_launches,
              f"planes {zk_backend}: tick converges launched {r['launches']}, budget {want_launches}")
        for name, k in r["launches"].items():
            totals[name] += k
        for name, k in r["worker_launches"].items():
            totals[name] += k
        prove_s = r["prove_s"]
        first = min(prove_s) if prove_s else None
        proving[zk_backend] = dict(
            zk_device=r["zk_device"], worker_spawn_s=r["spawn_s"], prewarm_s=r["prewarm_s"],
            ticks=ticks, tick_s=[t["tick_s"] for t in ticks], sync_tick_s=sync_tick_s,
            loop_s=r["loop_s"], drain_s=r["drain_s"],
            landed=sorted(r["landed"]), completed=stats["completed"],
            superseded=stats["superseded"], failed=stats["failed"],
            states=states, lag_epochs_after_tick=[t["lag_epochs"] for t in ticks],
            lag_epochs_after_drain=r["lag_epochs_after_drain"], lag_s=r["lag_s"],
            prove_s=prove_s, first_prove_s=prove_s.get(first),
            later_prove_s=[s for e, s in prove_s.items() if e != first],
            overlap_share=r["overlap_share"], proofs_equal_sync=equal, proofs_verify=verified,
            grafted_snark_phases=spans, converge_launches=r["launches"],
            worker_launches=r["worker_launches"],
        )
        emit("planes_proving", zk_backend=zk_backend, nvidia_smi=smi, **proving[zk_backend])
    emit("planes", nvidia_smi=smi, seconds=time.perf_counter() - t_phase,
         admission_sigs_per_s={k: r["sigs_per_s"] for k, r in runs.items()},
         overlap_share={b: p["overlap_share"] for b, p in proving.items()},
         launches=totals)
    return totals


SERVER = dict(
    # The reference's default node (data/protocol-config.json: a 10 s
    # epoch, the PLONK prover on data/srs-15.bin, the bootstrap group of
    # 5) on the card backend, proving through one spawned worker.
    ticks=3, interval_s=10, prover_workers=1, wait_s=300.0,
    drain_timeout_s=600.0, sigterm_exit_s=30.0,
    routes=("/score", "/proof/latest", "/proof/{last}", "/status", "/metrics",
            "/metrics/fleet", "/slo", "/healthz", "/timeline/{last}", "/scores/drift",
            "/debug/flight?n=50", "/trace/{last}", "/trace/pod", "/aggregate?epochs=x"),
)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def http_request(port: int, method: str, path: str, body: bytes = b""):
    """One HTTP/1.1 exchange with a node: (status, headers, body, seconds);
    status None when the node closed the connection unanswered."""
    import asyncio

    t0 = time.perf_counter()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    head = f"{method} {path} HTTP/1.1\r\nhost: smoke\r\n"
    if body:
        head += f"content-length: {len(body)}\r\n"
    writer.write((head + "\r\n").encode() + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    seconds = time.perf_counter() - t0
    if not raw:
        return None, {}, b"", seconds
    top, _, payload = raw.partition(b"\r\n\r\n")
    lines = top.decode("latin1").split("\r\n")
    return int(lines[0].split()[1]), dict(ln.split(": ", 1) for ln in lines[1:]), payload, seconds


def event_fixture(path, atts) -> None:
    """The attestations as the AttestationCreated events a chain replay
    delivers, one JSON line each."""
    from protocol_tpu_torch.node.attestation import AttestationData
    from protocol_tpu_torch.node.ethereum import AttestationCreatedEvent

    path.write_text("".join(
        AttestationCreatedEvent(
            creator=f"0x{i + 1:040x}", about="0x" + "00" * 20, key=bytes(32),
            val=AttestationData.from_attestation(a).to_bytes(),
        ).to_json() + "\n"
        for i, a in enumerate(atts)
    ))


def trace_kernels(directory) -> dict:
    """What the ``torch.profiler`` trace a tick wrote holds
    (``<profile_dir>/epoch_<n>/*.pt.trace.json``, the files the node's
    ``profile_dir`` sessions leave): each profiled kernel's launches
    (``PROFILED``, matched by substring as the node phase matches them),
    and the other kernels' launches by name."""
    counts: dict = {}
    others: dict = {}
    files = sorted(pathlib.Path(directory).glob("*.pt.trace.json"))
    for f in files:
        for ev in json.loads(f.read_text()).get("traceEvents", ()):
            if ev.get("cat") == "kernel":
                name = ev.get("name", "")
                ours = [k for k in PROFILED if k in name]
                for k in ours:
                    counts[k] = counts.get(k, 0) + 1
                if not ours:
                    others[name[:48]] = others.get(name[:48], 0) + 1
    return dict(files=[f.name for f in files], kernels=counts, other_kernels=others)


def run_server_node(config, atts, reattestation, wrappers, check) -> dict:
    """Part 1 of the ``server`` phase: ``Node.from_config(config)`` under
    ``asyncio.run`` on this thread, its epoch loop on the wall clock.
    The boot is held to the reference's order (recovery is watched from
    its executor thread: the socket answers ``recovering`` and no loop
    runs yet; then ``ok`` and both loops).  Once the fixture is admitted,
    ``POST /attestation`` takes a re-attestation (200), its replay (400)
    and a malformed payload (400); each wrapper's launches are set to 0;
    ``SERVER["ticks"]`` ticks pass (then the epoch loop is cancelled, so
    no further tick starts), the proving plane drains, every route is
    read, the checkpoint directory the ticks wrote is copied aside, the
    last epoch is checkpointed again now that its proof landed (the async
    tick checkpoints before it), and the node stops."""
    import asyncio
    import shutil

    from protocol_tpu_torch.node.attestation import AttestationData
    from protocol_tpu_torch.node.checkpoint import CheckpointStore
    from protocol_tpu_torch.node.epoch import Epoch
    from protocol_tpu_torch.node.server import Node
    from protocol_tpu_torch.obs import JOURNAL, TIMELINE
    from protocol_tpu_torch.obs import metrics as om

    node = Node.from_config(config)
    rec = dict(posts={}, routes={})

    async def scenario():
        loop = asyncio.get_running_loop()
        recover = node._recover_state

        def watched_recover():
            port = node._server.sockets[0].getsockname()[1]
            status, _, body, _ = asyncio.run_coroutine_threadsafe(
                http_request(port, "GET", "/healthz"), loop).result(60)
            rec["during_recovery"] = dict(
                status=status, recovery=json.loads(body)["components"]["recovery"]["state"],
                loops=len(node._tasks))
            recover()

        node._recover_state = watched_recover
        try:
            epochs0, dropped0 = om.EPOCHS_TOTAL.value(), om.EPOCH_TICKS_DROPPED.value()
            t_boot = time.perf_counter()
            await node.start()
            rec["start_s"] = time.perf_counter() - t_boot
            port = node._server.sockets[0].getsockname()[1]
            status, _, body, _ = await http_request(port, "GET", "/healthz")
            health = json.loads(body)
            rec["boot_to_healthz_ok_s"] = time.perf_counter() - t_boot
            rec["after_start"] = dict(status=status, recovery=health["components"]["recovery"]["state"],
                                      loops=len(node._tasks), verdict=health["status"])
            want = sorted(tuple(a.scores) for a in atts)
            deadline = time.monotonic() + 60
            while sorted(tuple(a.scores) for a in node.manager.attestations.values()) != want:
                check(time.monotonic() < deadline, "server: the fixture was not admitted in 60 s")
                await asyncio.sleep(0.05)
            rec["fixture_admitted_s"] = time.perf_counter() - t_boot
            payload = AttestationData.from_attestation(reattestation).to_bytes()
            for name, path, data in (("reattestation", "/attestation?nonce=1", payload),
                                     ("replay", "/attestation?nonce=1", payload),
                                     ("malformed", "/attestation", b"\x00" * 31)):
                status, _, body, seconds = await http_request(port, "POST", path, data)
                rec["posts"][name] = dict(status=status, body=json.loads(body), ms=seconds * 1e3)
            for w in wrappers:
                w.launches = 0
            t_ticks = time.perf_counter()
            while om.EPOCHS_TOTAL.value() - epochs0 < SERVER["ticks"]:
                check(time.perf_counter() - t_ticks < SERVER["wait_s"],
                      f"server: {SERVER['ticks']} ticks did not pass in {SERVER['wait_s']} s")
                await asyncio.sleep(0.02)
            node._tasks[0].cancel()
            rec["ticks_wall_s"] = time.perf_counter() - t_ticks
            rec["launches"] = {w.__name__: w.launches for w in wrappers}
            rec["epochs_ticked"] = om.EPOCHS_TOTAL.value() - epochs0
            rec["ticks_dropped"] = om.EPOCH_TICKS_DROPPED.value() - dropped0
            t0 = time.perf_counter()
            rec["drained"] = await loop.run_in_executor(
                None, node._prover_plane.drain, SERVER["drain_timeout_s"])
            rec["drain_s"] = time.perf_counter() - t0
            epochs = sorted(e.number for e in node.manager.cached_results)[-SERVER["ticks"]:]
            last = epochs[-1]
            rec["epochs"] = epochs
            rec["states"] = {e: node._prover_plane.status(e).to_dict() for e in epochs}
            rec["lag_epochs_after_drain"] = om.PROOF_LAG_EPOCHS.value()
            for template in SERVER["routes"]:
                path = template.format(last=last)
                status, headers, body, seconds = await http_request(port, "GET", path)
                rec["routes"][template] = dict(status=status, ms=seconds * 1e3, bytes=len(body),
                                               content_type=headers.get("content-type"), body=body)
            rec["tick_checkpoint_proofs"] = {}
            store = CheckpointStore(config.checkpoint_dir)
            for e in epochs:
                snap = store.load(Epoch(e)) if e in store.epochs() else None
                rec["tick_checkpoint_proofs"][e] = None if snap is None else snap.proof_json is not None
            # What the ticks left (checkpoints written before their
            # proofs landed) is kept for part 2 as it is, then the last
            # epoch is checkpointed again with its landed proof.
            rec["tick_checkpoint_dir"] = pathlib.Path(config.checkpoint_dir).with_name("ckpt_tick")
            shutil.copytree(config.checkpoint_dir, rec["tick_checkpoint_dir"])
            await loop.run_in_executor(
                None, node._checkpoint_epoch, Epoch(last), node.manager.cached_results[Epoch(last)].scores)
            t0 = time.perf_counter()
            await node.stop()
            rec["stop_s"] = time.perf_counter() - t0
            rec["timeline"] = {e: TIMELINE.get(e) for e in epochs}
            rec["failed_ticks"] = [ev for ev in JOURNAL.tail() if ev.get("what") == "epoch-tick-failed"]
        finally:
            # A failed check exits through here: the node and its
            # workers stop either way.
            if node._server is not None and node._server.is_serving():
                await node.stop()

    asyncio.run(scenario())
    rec["node"] = node
    return rec


def run_server_process(config_path, port, timeout_s) -> dict:
    """Part 2 of the ``server`` phase: ``python -m
    protocol_tpu_torch.node.server --config <file>`` in a subprocess.
    Once ``/healthz`` shows recovery ``ok``, read ``/score`` and
    ``/status``, then SIGTERM it and wait for its exit."""
    import asyncio
    import signal

    log = pathlib.Path(config_path).with_suffix(".log")
    t0 = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "protocol_tpu_torch.node.server", "--config", str(config_path)],
            cwd=HERE, stdout=out, stderr=subprocess.STDOUT,
        )
    rec = {}
    try:
        health = None
        while proc.poll() is None and time.perf_counter() - t0 < timeout_s:
            try:
                status, _, body, _ = asyncio.run(http_request(port, "GET", "/healthz"))
                health = json.loads(body)
                if health["components"]["recovery"]["state"] == "ok":
                    break
            except OSError:
                pass
            time.sleep(0.1)
        rec["boot_to_healthz_ok_s"] = time.perf_counter() - t0
        rec["recovery"] = health and health["components"]["recovery"]
        if proc.poll() is None and health is not None:
            for path in ("/score", "/status"):
                status, _, body, seconds = asyncio.run(http_request(port, "GET", path))
                rec[path] = dict(status=status, body=body, ms=seconds * 1e3)
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        try:
            rec["exit_code"] = proc.wait(timeout=SERVER["sigterm_exit_s"])
        except subprocess.TimeoutExpired:
            rec["exit_code"] = None
        rec["sigterm_to_exit_s"] = time.perf_counter() - t1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    rec["log_tail"] = log.read_text()[-3000:]
    return rec


def server_phase(plonk_ctx, trust_wrappers, check, emit, smi) -> dict:
    """The node server on the card: the reference's default node
    (``data/protocol-config.json``: a 10 s epoch, the PLONK prover on the
    committed SRS, the bootstrap group of 5, circuit check on) with
    ``trust_backend="cuda-windowed"`` and ``async_prover`` with one
    spawned prover worker, its checkpoints, journal and profiler traces
    in a work directory, its chain events from a fixture carrying the
    plonk cell's attestations, reusing the plonk phase's disk key cache.

    Part 1 (``run_server_node``): the node in this process, 3 ticks of
    its wall-clock epoch loop.  Checks: the boot order; the POST
    verdicts; every route's status; no tick failed or dropped; each
    tick converged on the card with K1 and K5-K8 launched for exactly
    the ticks' iterations (the backend's budget); each tick's profiler
    trace holds its converge's launches, warm ticks' too; each landed
    proof verifies; a CPU manager fed the same
    attestations converges the same epochs to the same iterations and
    scores (rtol 1e-3, atol 1e-8), its graph equals the checkpointed
    one, and its prove of the last epoch equals the served proof bytes.

    Part 2 (``run_server_process``): ``python -m
    protocol_tpu_torch.node.server`` on the same checkpoint directory
    with a clock that does not tick: it recovers and serves part 1's
    checkpointed proof byte for byte (the last epoch checkpointed again
    after its proof landed), names ``cuda-windowed``, and on SIGTERM
    exits within 30 s leaving its flight dump.  At the same time a
    second one on the checkpoints the ticks wrote themselves: it
    recovers the last epoch and answers ``/score`` with the reference's
    400 ``InvalidQuery`` for a cache without a proof, since an async
    tick checkpoints before its proof lands.

    Returns each wrapper's launches over part 1's ticks."""
    import dataclasses
    import shutil

    import numpy as np

    from protocol_tpu_torch.analysis.budget import KERNEL_INVARIANTS
    from protocol_tpu_torch.node.checkpoint import CheckpointStore
    from protocol_tpu_torch.node.config import ProtocolConfig
    from protocol_tpu_torch.node.epoch import Epoch
    from protocol_tpu_torch.node.manager import Manager, ManagerConfig
    from protocol_tpu_torch.zk.proof import CACHE_ENV, ProofRaw

    t_phase = time.perf_counter()
    work = HERE / "build" / "chip_smoke_server"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    os.environ[CACHE_ENV] = str(plonk_ctx["keys"])
    _, atts, reattestation = node_group(5, NODE["seed"])
    event_fixture(work / "events.jsonl", atts)
    srs = str(HERE / PLONK["srs"])
    defaults = ProtocolConfig.load(HERE / "data" / "protocol-config.json")
    config = ProtocolConfig.from_json(json.dumps(dict(
        epoch_interval=defaults.epoch_interval, endpoint=[[127, 0, 0, 1], free_port()],
        prover=defaults.prover, srs_path=srs, trust_backend="cuda-windowed",
        async_prover=True, prover_workers=SERVER["prover_workers"],
        checkpoint_dir=str(work / "ckpt"), journal_path=str(work / "journal.jsonl"),
        profile_dir=str(work / "profile"), event_fixture=str(work / "events.jsonl"),
    )))
    check((defaults.epoch_interval, defaults.prover, defaults.srs_path) == (SERVER["interval_s"],
          "plonk", PLONK["srs"]), f"server: data/protocol-config.json changed: {defaults}")
    budget = KERNEL_INVARIANTS["cuda-windowed"]
    r = run_server_node(config, atts, reattestation, trust_wrappers, check)
    node, epochs = r["node"], r["epochs"]
    last = epochs[-1]
    m = node.manager
    # Each tick's seconds by phase (its timeline record: the epoch root
    # span's children), printed before any check reads them.
    traces = {e: trace_kernels(work / "profile" / f"epoch_{e}") for e in epochs}
    ticks = {}
    for e in epochs:
        tl = r["timeline"][e] or {}
        phases = tl.get("phases", {})
        ticks[e] = dict(tick_s=tl.get("tick_seconds"), phases=phases,
                        converge_s=phases.get("converge"), checkpoint_s=phases.get("checkpoint"),
                        enqueue_s=phases.get("prove_enqueue"), iterations=m.cached_results[Epoch(e)].iterations,
                        trace=traces[e]["kernels"], trace_other_kernels=traces[e]["other_kernels"],
                        trace_files=len(traces[e]["files"]))
    emit("server_ticks", nvidia_smi=smi, ticks=ticks, ticks_wall_s=r["ticks_wall_s"],
         epochs_ticked=r["epochs_ticked"], ticks_dropped=r["ticks_dropped"],
         failed_ticks=r["failed_ticks"], launches=r["launches"])
    check(m.config.check_circuit and m.config.num_neighbours == 5 and str(m.device).startswith("cuda"),
          f"server: the node is not the default cell on the card: {m.config}, {m.device}")

    # -- part 1 checks ---------------------------------------------------------
    during, after = r["during_recovery"], r["after_start"]
    check(during == dict(status=200, recovery="recovering", loops=0),
          f"server: the socket did not answer 'recovering' before the loops: {during}")
    check(after["recovery"] == "ok" and after["loops"] == 2,
          f"server: after start, recovery {after['recovery']} and {after['loops']} loops")
    posts = {k: (v["status"], v["body"].get("reason")) for k, v in r["posts"].items()}
    check(posts == {"reattestation": (200, None), "replay": (400, "duplicate"),
                    "malformed": (400, "malformed-payload")}, f"server: POST verdicts {posts}")
    statuses = {k: v["status"] for k, v in r["routes"].items()}
    want_status = {k: 200 for k in SERVER["routes"]}
    want_status.update({"/trace/pod": 404, "/aggregate?epochs=x": 400})
    check(statuses == want_status, f"server: route statuses {statuses}")
    check(r["routes"]["/metrics"]["content_type"].startswith("text/plain; version=0.0.4"),
          f"server: /metrics content type {r['routes']['/metrics']['content_type']}")
    status_doc = json.loads(r["routes"]["/status"]["body"])
    check(status_doc["backend"] == "cuda-windowed", f"server: /status backend {status_doc['backend']}")
    check(r["epochs_ticked"] == SERVER["ticks"] and len(epochs) == SERVER["ticks"]
          and epochs == list(range(epochs[0], epochs[0] + SERVER["ticks"])),
          f"server: ticked {r['epochs_ticked']} epochs {epochs}")
    check(r["ticks_dropped"] == 0 and not r["failed_ticks"],
          f"server: dropped {r['ticks_dropped']} ticks, failed {r['failed_ticks']}")
    results = {e: m.cached_results[Epoch(e)] for e in epochs}
    check(all(res.backend == "cuda-windowed" and res.iterations > 0 for res in results.values()),
          f"server: converges {[(res.backend, res.iterations) for res in results.values()]}")
    iterations = sum(res.iterations for res in results.values())
    want_launches = {w.__name__: 0 for w in trust_wrappers}
    want_launches.update(budget.expected_launches(iterations))
    check(r["launches"] == want_launches,
          f"server: tick launches {r['launches']}, {SERVER['ticks']} converges' budget {want_launches}")
    check(all(t["files"] for t in traces.values()), f"server: a tick left no profiler trace: {traces}")
    # Each tick's trace, warm ticks of one iteration too, holds every
    # launch of its converge that the counters show (the budget for its
    # iterations, which the counters' sum is held to above).
    want_traced = {e: traced_budget(budget, results[e].iterations) for e in epochs}
    check(all(traces[e]["kernels"] == want_traced[e] for e in epochs),
          f"server: tick traces hold {[traces[e]['kernels'] for e in epochs]}, want {want_traced}")
    check(r["drained"], "server: the proving plane did not drain")
    states = {e: s["state"] for e, s in r["states"].items()}
    check(states[last] == "proved" and all(s in ("proved", "superseded") for s in states.values()),
          f"server: proof states {states}")
    prover = plonk_ctx["prover"]
    landed = sorted(e.number for e in m.cached_proofs)
    verified = {e: prover.verify(m.get_proof(Epoch(e)).pub_ins, m.get_proof(Epoch(e)).proof)
                for e in landed}
    check(landed and all(verified.values()), f"server: landed proofs verify {verified}")
    served = ProofRaw.from_json(r["routes"]["/proof/{last}"]["body"].decode()).to_proof()

    # The same attestations on a CPU manager: the same epochs converge to
    # the same iterations and scores; the last epoch proves to the served bytes.
    cpu = Manager(ManagerConfig(backend="cuda-windowed", device="cpu", srs_path=srs), prover=prover)
    cpu.add_attestations_bulk(atts)
    check(cpu.add_attestation(reattestation).accepted, "server: the CPU manager refused the re-attestation")
    cache = {h: tuple(a.scores) for h, a in m.attestations.items()}
    check(cache == {h: tuple(a.scores) for h, a in cpu.attestations.items()},
          "server: the node's attestation cache is not the fixture plus the re-attestation")
    agree = {}
    for e in epochs:
        c = cpu.converge_epoch(Epoch(e), alpha=0.1)
        agree[e] = dict(iterations=(results[e].iterations, c.iterations),
                        max_abs=float(np.abs(np.asarray(results[e].scores) - c.scores).max()),
                        close=bool(np.allclose(results[e].scores, c.scores, rtol=1e-3, atol=1e-8)))
    check(all(a["iterations"][0] == a["iterations"][1] and a["close"] for a in agree.values()),
          f"server: card vs CPU converges {agree}")
    snap = CheckpointStore(work / "ckpt").load_latest()
    check(snap.epoch.number == last and snap.proof_json is not None,
          f"server: latest checkpoint epoch {snap.epoch.number}, proof {snap.proof_json is not None}")
    graph_equal = all(np.array_equal(a, b) for a, b in (
        (snap.graph.src, cpu.last_graph.src), (snap.graph.dst, cpu.last_graph.dst),
        (snap.graph.weight, cpu.last_graph.weight)))
    check(graph_equal and np.allclose(snap.scores, cpu.last_scores, rtol=1e-3, atol=1e-8),
          "server: the checkpointed graph or scores differ from the CPU converge")
    t0 = time.perf_counter()
    cpu.calculate_proofs(Epoch(last))
    cpu_prove_s = time.perf_counter() - t0
    cpu_proof = cpu.get_proof(Epoch(last))
    check((served.pub_ins, served.proof) == (cpu_proof.pub_ins, cpu_proof.proof),
          "server: the served proof differs from the CPU manager's prove of the same epoch")

    # -- part 2: the entry point in a subprocess ---------------------------------
    # Part 1's configuration but for a clock that does not tick, a fresh
    # journal and no fixture (whose replay would overwrite the recovered
    # re-attestation with the older row, as a chain replay does): one
    # process on the directory with the last epoch checkpointed again,
    # and at once one on the copy of what the ticks wrote, which is what
    # a node restarted after its own ticks recovers.
    ports = []
    while len(ports) < 2:
        port = free_port()
        ports += [port] if port not in ports else []
    entries = {}
    for (name, ckpt), port in zip((("journal2", work / "ckpt"), ("journal_tick", r["tick_checkpoint_dir"])),
                                  ports):
        entries[name] = (work / f"{name}.json", port)
        entries[name][0].write_text(json.dumps({
            **dataclasses.asdict(config), "epoch_interval": 3600, "endpoint": [[127, 0, 0, 1], port],
            "checkpoint_dir": str(ckpt), "journal_path": str(work / f"{name}.jsonl"),
            "event_fixture": None, "profile_dir": None,
        }))
    with concurrent.futures.ThreadPoolExecutor(len(entries)) as pool:
        running = {name: pool.submit(run_server_process, path, port, SERVER["wait_s"])
                   for name, (path, port) in entries.items()}
        p2, p_tick = running["journal2"].result(), running["journal_tick"].result()
    # No proof in the cache: /score answers the reference's 400 InvalidQuery.
    check((p_tick.get("/score", {}).get("status"), p_tick.get("/score", {}).get("body")) == (400, b"InvalidQuery")
          and (p_tick["recovery"] or {}).get("checkpoint_epoch") == last,
          f"server: on the ticks' own checkpoints the entry point recovered {p_tick['recovery']} and "
          f"answered /score {p_tick.get('/score')}, not 400 InvalidQuery {p_tick['log_tail']}")
    check(json.loads(p_tick["/status"]["body"])["backend"] == "cuda-windowed"
          and p_tick["exit_code"] is not None and p_tick["sigterm_to_exit_s"] < SERVER["sigterm_exit_s"]
          and (work / "journal_tick.jsonl.dump").exists(),
          f"server: the entry point on the ticks' checkpoints: {p_tick}")
    check(p2.get("/score", {}).get("status") == 200,
          f"server: the entry point did not serve /score: {p2.get('/score')} {p2['log_tail']}")
    check(p2["/score"]["body"].decode() == snap.proof_json == r["routes"]["/score"]["body"].decode(),
          "server: the entry point's /score is not part 1's checkpointed proof")
    check(json.loads(p2["/status"]["body"])["backend"] == "cuda-windowed",
          f"server: the entry point's /status {p2['/status']}")
    check(p2["exit_code"] is not None and p2["sigterm_to_exit_s"] < SERVER["sigterm_exit_s"],
          f"server: the entry point did not exit on SIGTERM in {SERVER['sigterm_exit_s']} s")
    check((work / "journal2.jsonl.dump").exists(), "server: the entry point left no flight dump")

    # -- record ----------------------------------------------------------------
    for e in epochs:
        ticks[e]["launches"] = budget.expected_launches(results[e].iterations)
    rec = dict(
        epochs=epochs, ticks=ticks, ticks_wall_s=r["ticks_wall_s"],
        boot=dict(start_s=r["start_s"], boot_to_healthz_ok_s=r["boot_to_healthz_ok_s"],
                  fixture_admitted_s=r["fixture_admitted_s"], during_recovery=during,
                  after_start=after),
        posts={k: dict(status=v["status"], reason=v["body"].get("reason"), ms=v["ms"])
               for k, v in r["posts"].items()},
        route_ms={k: v["ms"] for k, v in r["routes"].items()},
        route_bytes={k: v["bytes"] for k, v in r["routes"].items()},
        proof_states=r["states"], proof_lag_s={e: s.get("lag_seconds") for e, s in r["states"].items()},
        prove_s={e: s.get("prove_seconds") for e, s in r["states"].items()},
        lag_epochs_after_drain=r["lag_epochs_after_drain"], drain_s=r["drain_s"],
        stop_s=r["stop_s"], landed=landed, proofs_verify=verified,
        tick_checkpoints_hold_proof=r["tick_checkpoint_proofs"],
        card_vs_cpu=agree, cpu_prove_s=cpu_prove_s, launches=r["launches"],
        launches_match_budget=r["launches"] == want_launches,
        recheckpointed_epoch=last,
        entry_point=dict(boot_to_healthz_ok_s=p2["boot_to_healthz_ok_s"],
                         recovery=p2["recovery"], score_ms=p2["/score"]["ms"],
                         exit_code=p2["exit_code"], sigterm_to_exit_s=p2["sigterm_to_exit_s"]),
        entry_point_on_tick_checkpoints=dict(
            boot_to_healthz_ok_s=p_tick["boot_to_healthz_ok_s"], recovery=p_tick["recovery"],
            score_status=p_tick["/score"]["status"], score_ms=p_tick["/score"]["ms"],
            exit_code=p_tick["exit_code"], sigterm_to_exit_s=p_tick["sigterm_to_exit_s"]),
    )
    os.environ.pop(CACHE_ENV, None)
    shutil.rmtree(plonk_ctx["keys"].parent, ignore_errors=True)
    shutil.rmtree(work, ignore_errors=True)
    emit("server", nvidia_smi=smi, seconds=time.perf_counter() - t_phase, **rec)
    return r["launches"]


SHARDED = dict(ranks=4, small_ranks=8, kw=dict(alpha=0.1, tol=0.0, max_iter=HEADLINE["iters"]),
               small_kw=dict(alpha=0.1, tol=1e-6, max_iter=60), timeout_s=600)


def sharded_phase(graph, single, check, emit, smi) -> dict:
    """The sharded converge (``cuda-sharded:cuda-csr`` and
    ``:cuda-windowed``) on ranks that share the one card, ``gloo``
    all-reducing CUDA tensors through the host (NCCL refuses two ranks on
    one device).  The headline graph and its window plan are built once
    here and mapped by every rank (``share_arrays``); the plan is each
    rank's candidate, so no rank rebuilds it.

    4 ranks at the headline (tol 0, 40 iterations): every rank's scores
    the same bits; each kernel within L1 1e-5 of the single-card converge
    of its formulation (``single``: scores and peak memory by kernel) and
    of the other kernel; per rank, the launches of the declared budget
    times 40 and no other, 40 all-reduces of 4n bytes
    (``COMM_INVARIANTS``), peak memory under the single-card converge's;
    then a step's kernel route against its plain route on every shard,
    bit for bit, and a step's wall time split into the shard's kernels,
    the all-reduce and ``damp``, with rank 0's profiler trace.  8 ranks
    at 65,536 peers (tol 1e-6): the same checks of bits, launches and
    all-reduces, the routes, and the card against the same 8 ranks on the
    CPU, the same iterations and L1 ≤ 1e-6.  Returns each rank's headline
    launches by kernel, for the ``kernels`` line."""
    import shutil

    import numpy as np

    from protocol_tpu_torch.analysis.budget import COMM_INVARIANTS, KERNEL_INVARIANTS
    from protocol_tpu_torch.models.graphs import scale_free
    from protocol_tpu_torch.ops import gather_window as gw
    from protocol_tpu_torch.parallel import dryrun
    from protocol_tpu_torch.parallel.launch import run_ranks, share_arrays

    kernels = ("cuda-csr", "cuda-windowed")
    t_phase = time.perf_counter()
    work = HERE / "build" / "chip_smoke_sharded"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    gd = graph.drop_self_edges()
    w, _ = gd.row_normalized()
    plan = gw.build_window_plan(gd.src, gd.dst, w, n=gd.n)
    plan_seconds = time.perf_counter() - t0
    graph_paths = share_arrays(work / "graph", dict(
        n=np.int64(graph.n), src=graph.src, dst=graph.dst, weight=graph.weight,
        pre_trusted=graph.pre_trusted,
    ))
    plan_paths = share_arrays(work / "plan", plan.to_arrays())
    del gd, w, plan
    stage_seconds = time.perf_counter() - t0

    def launch(size, jobs, device="cuda"):
        t0 = time.perf_counter()
        out = run_ranks(size, dryrun.jobs_rank, jobs, backend="gloo", device=device,
                        timeout_s=SHARDED["timeout_s"])
        return out, time.perf_counter() - t0

    def converged(results, kw, where, on_card=True):
        """Checks common to both sizes and devices (on the CPU the plain
        versions launch no kernel); per kernel, rank 0's record."""
        head = {}
        for kernel in kernels:
            recs = [r[0][kernel] for r in results]
            head[kernel] = r0 = recs[0]
            it, n = r0["iterations"], r0["scores"].shape[0]
            check(all(np.array_equal(r["scores"], r0["scores"]) for r in recs),
                  f"sharded {where} {kernel}: the ranks' scores differ")
            check(all(r["iterations"] == it for r in recs), f"sharded {where} {kernel}: iterations differ")
            check(kw["tol"] > 0 or it == kw["max_iter"], f"sharded {where} {kernel}: ran {it} steps")
            want = dict.fromkeys(recs[0]["launches"], 0)
            if on_card:
                want.update(KERNEL_INVARIANTS[f"cuda-sharded:{kernel}"].expected_launches(it))
            comm = COMM_INVARIANTS[f"cuda-sharded:{kernel}"].expected(it, n)
            for rank, r in enumerate(recs):
                check(r["launches"] == want,
                      f"sharded {where} {kernel} rank {rank} launched {r['launches']}, expected {want}")
                check(r["all_reduce"] == {"calls": comm["all_reduce_sum"], "bytes": comm["bytes"]},
                      f"sharded {where} {kernel} rank {rank} all-reduced {r['all_reduce']}, "
                      f"expected {comm}")
            check(bool(np.isfinite(r0["scores"]).all()) and abs(float(r0["scores"].sum()) - 1.0) < 1e-3,
                  f"sharded {where} {kernel}: non-finite scores or a sum off 1")
        check(all(r[0]["loaded_forbidden"] == [] for r in results),
              f"sharded {where}: a rank loaded jax or the reference package")
        l1 = float(np.abs(head["cuda-windowed"]["scores"] - head["cuda-csr"]["scores"]).sum())
        check(l1 <= 1e-5, f"sharded {where}: windowed vs CSR L1 {l1} > 1e-5")
        return head, l1

    def routes(results, where):
        eq = [r[1][k]["routes_equal"] for r in results for k in kernels]
        check(all(all(e.values()) for e in eq),
              f"sharded {where}: a shard's kernel route differs from its plain route: {eq}")
        return {k: [r[1][k]["routes_equal"] for r in results] for k in kernels}

    # -- headline: 4 ranks, 1M / 50M, 40 steps, both kernels ---------------
    kw = SHARDED["kw"]
    results, head_seconds = launch(SHARDED["ranks"], [
        (dryrun.converge_rank, (graph_paths, kernels, kw, plan_paths)),
        (dryrun.step_rank, (graph_paths, kernels, plan_paths, 20, True)),
    ])
    head, head_l1 = converged(results, kw, "headline")
    record = {"ranks": SHARDED["ranks"], "backend": "gloo", "peers": graph.n, "edges": graph.nnz,
              "iterations": kw["max_iter"], "plan_seconds": plan_seconds,
              "stage_seconds": stage_seconds, "launch_seconds": head_seconds,
              "windowed_vs_csr_l1": head_l1, "routes_equal": routes(results, "headline")}
    for kernel in kernels:
        recs = [r[0][kernel] for r in results]
        l1 = float(np.abs(head[kernel]["scores"] - single[kernel]["scores"]).sum())
        peaks = [r["max_memory_allocated"] for r in recs]
        record[kernel] = {
            "l1_vs_single_card": l1,
            "converge_seconds": [r["converge_seconds"] for r in recs],
            "backend_seconds": [r["seconds"] for r in recs],
            "plan_span_seconds": [r["plan_seconds"] for r in recs],
            "plan_outcomes": [r["plan_outcome"] for r in recs],
            "max_memory_allocated": peaks,
            "single_card_max_memory_allocated": single[kernel]["peak"],
            "single_card_seconds": single[kernel]["seconds"],
            "step_wall_ms": [r[1][kernel]["wall_ms"] for r in results],
            "step_device_ms_rank0": results[0][1][kernel]["device_ms"],
            "step_device_split_ms_rank0": results[0][1][kernel]["device_split_ms"],
            "shard_runs": [r[1][kernel]["runs"] for r in results],
            "shard_edges": [r[1][kernel]["edges"] for r in results],
        }
        check(l1 <= 1e-5, f"sharded headline {kernel} vs the single-card converge: L1 {l1} > 1e-5")
        check(max(peaks) < single[kernel]["peak"],
              f"sharded headline {kernel}: a rank's peak {max(peaks)} is not under the single "
              f"card's {single[kernel]['peak']}")
        if kernel == "cuda-windowed":
            check(all(r["plan_outcome"] == {"reuse": 1, "delta": 0, "rebuild": 0} and r["plan_reused"]
                      for r in recs), f"sharded headline: a rank did not reuse the plan: "
                      f"{[r['plan_outcome'] for r in recs]}")
    sharded_launches = {
        f"cuda-sharded:{k}": [r[0][k]["launches"] for r in results] for k in kernels
    }
    del results
    shutil.rmtree(work, ignore_errors=True)

    # -- 65,536 peers: 8 ranks on the card and on the CPU ------------------
    small = scale_free(SMALL["n"], SMALL["nnz"], seed=SMALL["seed"])
    kw = SHARDED["small_kw"]
    card, card_seconds = launch(SHARDED["small_ranks"], [
        (dryrun.converge_rank, (small, kernels, kw)),
        (dryrun.step_rank, (small, kernels, None, 10, False)),
    ])
    cpu, cpu_seconds = launch(SHARDED["small_ranks"], [(dryrun.converge_rank, (small, kernels, kw))],
                              device="cpu")
    on_card, card_l1 = converged(card, kw, "65k card")
    on_cpu, cpu_l1 = converged(cpu, kw, "65k cpu", on_card=False)
    small_rec = {"ranks": SHARDED["small_ranks"], "peers": small.n, "edges": small.nnz,
                 "card_seconds": card_seconds, "cpu_seconds": cpu_seconds,
                 "windowed_vs_csr_l1": {"card": card_l1, "cpu": cpu_l1},
                 "routes_equal": routes(card, "65k")}
    for kernel in kernels:
        l1 = float(np.abs(on_card[kernel]["scores"] - on_cpu[kernel]["scores"]).sum())
        small_rec[kernel] = {
            "iterations": on_card[kernel]["iterations"], "cpu_iterations": on_cpu[kernel]["iterations"],
            "card_vs_cpu_l1": l1, "converge_seconds": on_card[kernel]["converge_seconds"],
            "step_wall_ms_rank0": card[0][1][kernel]["wall_ms"],
        }
        check(on_card[kernel]["iterations"] == on_cpu[kernel]["iterations"],
              f"sharded 65k {kernel}: card and CPU ran {on_card[kernel]['iterations']} and "
              f"{on_cpu[kernel]['iterations']} iterations")
        check(l1 <= 1e-6, f"sharded 65k {kernel}: card vs CPU L1 {l1} > 1e-6")
    emit("sharded", nvidia_smi=smi, seconds=time.perf_counter() - t_phase, headline=record,
         small=small_rec)
    return sharded_launches


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
        device_events, trace_ms, trace_session,
    )
    from protocol_tpu_torch.bench.headline_converge import prepared
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
    # The node's crypto runtime (g++) builds beside the kernels (nvcc).
    import threading

    from protocol_tpu_torch.crypto import native as cnative

    crypto_build = {}

    def build_crypto():
        t = time.perf_counter()
        try:
            crypto_build["library"] = str(cnative.build())
            crypto_build["ok"] = cnative.available()
        except OSError as exc:
            crypto_build["ok"], crypto_build["error"] = False, str(exc)
        crypto_build["seconds"] = time.perf_counter() - t

    from protocol_tpu_torch.zk import native as znative

    zk_build = {}

    def build_zk():
        t = time.perf_counter()
        try:
            zk_build["library"] = str(znative.build())
            zk_build["ok"] = znative.available()
            zk_build["ifma"] = znative.ifma_available()
        except OSError as exc:
            zk_build["ok"], zk_build["error"] = False, str(exc)
        zk_build["seconds"] = time.perf_counter() - t

    host_threads = [threading.Thread(target=build_crypto), threading.Thread(target=build_zk)]
    for thread in host_threads:
        thread.start()
    t0 = time.perf_counter()
    report = _build.build()
    build_s = time.perf_counter() - t0
    for thread in host_threads:
        thread.join()
    ptxas = {
        name: [ln.strip() for ln in r["log"].splitlines()
               if "registers" in ln or "smem" in ln or "spill" in ln]
        for name, r in report.items()
    }
    emit("build", seconds=build_s, built=sorted(report), ptxas=ptxas, crypto_runtime=crypto_build,
         zk_runtime=zk_build)
    check(crypto_build.get("ok", False),
          f"the crypto runtime (native/protocol_native.cpp) did not build: {crypto_build}")
    check(zk_build.get("ok", False),
          f"the zk runtime (native/zk_runtime.cpp, zk_ifma.cpp) did not build: {zk_build}")

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
        fn()
        torch.cuda.synchronize()
        with trace_session() as prof:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
        by_name, counts = {}, {}
        for e in device_events(prof):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
            counts[e.name] = counts.get(e.name, 0) + 1
        if launches is not None:
            launches.update({name: c / steps for name, c in counts.items()})
        return by_name

    # -- 3. kernel on a 65,536-peer plan -----------------------------------
    _, gs, dangling_s, p_s = prepared(**SMALL)
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
        sp.rowsum_tail, sp.gather_ds_cumsum, pmg.take_along_axis, pmg.transpose2d,
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
    torch.cuda.reset_peak_memory_stats()
    csr_scores, csr_seconds, csr_launches = counted(run_csr)
    csr_peak = torch.cuda.max_memory_allocated()
    l1_csr = float(np.abs(scores.astype(np.float64) - csr_scores).sum())
    emit(
        "headline", peers=g.n, edges=g.nnz, iterations=iters, plan_seconds=plan_seconds,
        n_rows=plan.n_rows, n_segments=plan.n_segments, seg_capacity=plan.seg_capacity,
        compression=plan.compression, seconds=seconds, ms_per_iter=seconds / iters * 1e3,
        max_memory_allocated=peak, k1_launches=launches, launches=main_launches,
        sum_scores=total, csr_seconds=csr_seconds, csr_launches=csr_launches, l1_vs_csr=l1_csr,
        csr_max_memory_allocated=csr_peak,
    )
    # A windowed step runs K1 once, K7 once (the plan rows' prefix and the
    # bridge), K5 once (rowsum_sorted's blocks), K6 once (the block
    # totals' scan) and K8 once (the pointer tail); a CSR step K9 once
    # (the edge product and its block prefix), then K6 and K8 once each,
    # and K5 never.
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
        no_launch, gather_ds_cumsum=iters, block_total_scan=iters, rowsum_tail=iters,
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

    block = sp._ROWSUM_BLOCK

    def k9_earlier(w, x, src):
        """The pair K9 replaced: the edge product written out
        (``bench/yardsticks.py::gather_multiply``), then K5 over it."""
        return sp.ds_cumsum_axis1(ys.gather_multiply(w, x, src), block)

    def k9_same(w, x, src):
        """K9, its plain version and the earlier pair: both lanes bit for bit."""
        out = sp.gather_ds_cumsum(w, x, src)
        return all(
            same_bits(a, b) and same_bits(a, c)
            for a, b, c in zip(out, sp._gather_ds_cumsum(w, x, src), k9_earlier(w, x, src))
        )

    def k9_vs_plain(w, x, src):
        """K9 against its plain version, both lanes (a difference raises).
        Bytes: src and w read (8 B an edge), both lanes written (8 B a
        slot), the table read once; operations: one multiply an edge and
        ds_add's 11 adds a slot a level.  Beside it the earlier pair, held
        bit-equal too, and the earlier product alone; the trace time (the
        kernel's device time without the launch) last."""
        e, n = src.shape[0], x.shape[0]
        rows, levels = -(-e // block), block.bit_length() - 1
        nbytes, ops = 8 * e + 8 * rows * block + 4 * n, e + 11 * levels * rows * block
        res = kernel_vs_plain(
            lambda: sp.gather_ds_cumsum(w, x, src), lambda: sp._gather_ds_cumsum(w, x, src),
            wrapper=sp.gather_ds_cumsum, nbytes=nbytes, ops=ops,
        )
        check(
            all(same_bits(a, b) for a, b in zip(k9_earlier(w, x, src), sp._gather_ds_cumsum(w, x, src))),
            f"the earlier edge product and K5 differ from K9's plain version at {e} edges",
        )
        return dict(
            res, shape=[rows, block], edges=e, table=n, ops=ops, bound_by=bound_by(nbytes, ops),
            earlier_ms=time_ms(lambda: k9_earlier(w, x, src)),
            earlier_gather_multiply_ms=time_ms(lambda: ys.gather_multiply(w, x, src)),
            trace_ms=trace_ms(lambda: sp.gather_ds_cumsum(w, x, src)),
        )

    # K9 at the CSR step's headline operands and at the 65,536-peer graph's.
    x_small = torch.from_numpy(x_s / x_s.sum()).to(dev)
    w_small, src_small = torch.from_numpy(gs.weight).to(dev), torch.from_numpy(gs.src).to(dev)
    k9 = {"headline": k9_vs_plain(w_d, t_d, src_d), "small": k9_vs_plain(w_small, x_small, src_small)}
    for where, rec in k9.items():
        emit("kernel", kernel="gather_ds_cumsum", input=where, **rec)
    # At edges: a ragged last row with sources -1, n and n + 5 (clamped to
    # the table), a table at an odd element offset (its reads are 4-byte)
    # and no edges, bit for bit; streams at an odd offset (its loads are
    # 16-byte) are refused by the wrapper, while the CSR and COO steps and
    # converges take one aligned copy of them and give the aligned result
    # bit for bit.
    ragged = 3 * block + 17
    bad_src = src_small[:ragged].clone()
    bad_src[0], bad_src[ragged // 2], bad_src[-1] = -1, gs.n, gs.n + 5
    k9_edges = {
        "ragged_clamped": k9_same(w_small[:ragged], x_small, bad_src),
        "table_offset_1": k9_same(w_small, x_small[1:], src_small),
        "no_edges": sp.gather_ds_cumsum(w_d[:0], t_d, src_d[:0])[0].shape == (0, block),
    }
    try:
        sp.gather_ds_cumsum(w_d[1:], t_d, src_d[1:])
        k9_edges["misaligned_refused"] = False
    except ValueError:
        k9_edges["misaligned_refused"] = True

    def offset_1(a):
        """``a``'s values in a slice one element past a 16-byte boundary."""
        return torch.cat([a[:1], a])[1:]

    ptr_small, dst_small = torch.from_numpy(gs.row_ptr_by_dst()).to(dev), torch.from_numpy(gs.dst).to(dev)
    dang_small = torch.from_numpy(dangling_s.astype(np.float32)).to(dev)
    p_small = torch.from_numpy(p_s).to(dev)
    for name, run_small in {
        "csr_step": lambda w, src: sp.power_step_csr(src, ptr_small, w, x_small, p_small, dang_small, alpha),
        "coo_step": lambda w, src: sp.power_step_coo(
            src, dst_small, w, x_small, p_small, dang_small, alpha, n=gs.n),
        "converge_csr": lambda w, src: sp.converge_csr(
            src, ptr_small, w, x_small, p_small, dang_small, tol=0.0, max_iter=8)[0],
        "converge_sparse": lambda w, src: sp.converge_sparse(
            src, dst_small, w, x_small, p_small, dang_small, n=gs.n, tol=0.0, max_iter=8)[0],
    }.items():
        k9_edges[f"{name}_offset_1"] = same_bits(
            run_small(offset_1(w_small), offset_1(src_small)), run_small(w_small, src_small)
        )
    emit("kernel_edges", kernel="gather_ds_cumsum", **k9_edges)
    check(all(k9_edges.values()), f"gather_ds_cumsum at its edges: {k9_edges}")
    del x_small, w_small, src_small, bad_src, ptr_small, dst_small, dang_small, p_small

    # K5 and K6 at the shapes the two steps gave them, bit for bit (K5 at
    # the CSR edges is the earlier pair's second half now).

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
        # The CSR step's passes (ops/sparse.py::gathered_rowsum, then damp).
        "csr_gather_ds_cumsum": lambda: sp.gather_ds_cumsum(w_d, t_d, src_d),
        "csr_gather_ds_cumsum_plain": lambda: sp._gather_ds_cumsum(w_d, t_d, src_d),
        "csr_block_total_scan": lambda: sp.block_total_scan(*tails["csr_blocks"][:2]),
        "csr_rowsum_tail": lambda: sp.rowsum_tail(*tails["csr_blocks"], ptr_d),
        "csr_rowsum_tail_plain": lambda: sp._rowsum_tail(*tails["csr_blocks"], ptr_d),
        "csr_gathered_rowsum": lambda: sp.gathered_rowsum(w_d, t_d, src_d, ptr_d),
        # The earlier route's row sums: K5, K6, K8 over the written products.
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
    # does, the checks: each step's row sums launch their three kernels
    # once each and nothing else (the windowed step's rowsum_sorted K5, K6
    # and K8; the CSR step's gathered_rowsum K9, K6 and K8; K6 reads the
    # block totals from the lanes, so no PyTorch add builds them), and the
    # step launches those three once each and none of the other path's:
    # the CSR step no K5 and no earlier edge product, the windowed step no K9.
    profiles = {}
    k9_kernels = ("gather_ds_cumsum_kernel", "gather_multiply_kernel")
    for name, fn, wall_ms, rowsum, kernels_of, absent in (
        ("windowed", windowed_step, seconds / iters * 1e3, lambda: sp.rowsum_sorted(part, dst_ptr),
         ("ds_cumsum_rows_kernel", "compensated_scan_kernel", "rowsum_tail_kernel"), k9_kernels),
        ("csr", csr_step, csr_seconds / iters * 1e3,
         lambda: sp.gathered_rowsum(w_d, t_d, src_d, ptr_d),
         ("gather_ds_cumsum_kernel", "compensated_scan_kernel", "rowsum_tail_kernel"),
         ("ds_cumsum_rows_kernel", "gather_multiply_kernel")),
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
        a_step = {k: sum(c for kn, c in step_launches.items() if k in kn) for k in kernels_of + absent}
        profiles[name] = {
            "busy_ms": busy, "wall_ms_per_iter": wall_ms, "idle_share": 1.0 - busy / wall_ms,
            "top_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12]),
            "kernels_a_step": sum(step_launches.values()),
            "row_sum_kernels_a_step": a_step,
            "rowsum_sorted_kernels": rowsum_launches,
        }
        check(
            all(a_step[k] == 1.0 for k in kernels_of) and not any(a_step[k] for k in absent),
            f"the {name} step launched {a_step} a step",
        )
        check(
            sorted(rowsum_launches.values()) == [1.0, 1.0, 1.0]
            and all(any(k in kn for kn in rowsum_launches) for k in kernels_of),
            f"the {name} step's row sums launched {rowsum_launches}, not {kernels_of} once each",
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
            "wrapper": "gather_windowed",
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

    # -- 5b. sharded: the sharded converge on ranks sharing the card -------
    single = {"cuda-windowed": {"scores": scores, "peak": peak, "seconds": seconds},
              "cuda-csr": {"scores": csr_scores, "peak": csr_peak, "seconds": csr_seconds}}
    sharded_launches = sharded_phase(graph, single, check, emit, smi)

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

    # -- 9. node: the single-device node's epoch path ----------------------
    node_launches = node_phase(wrappers, check, emit, smi)

    # -- 10. plonk: a default-configuration node proves its epoch -----------
    plonk_launches, plonk_ctx = plonk_phase(wrappers, check, emit, smi)

    # -- 11. graft: the prover's kernels K10-K13, the epoch proved on them --
    kernels.extend(graft_phase(plonk_ctx, check, emit, smi))

    # -- 12. planes: admission through verify workers, async proving -------
    planes_launches = planes_phase(plonk_ctx, wrappers, check, emit, smi)

    # -- 13. server: the node daemon over the card converge and the planes -
    server_launches = server_phase(plonk_ctx, wrappers, check, emit, smi)

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
            "name": "gather_ds_cumsum",
            "wrapper": "gather_ds_cumsum",
            "route": "cuda",
            "source": "protocol_tpu_torch/ops/csrc/gather_ds_cumsum.cu",
            "replaces": "protocol_tpu/ops/sparse.py:147 + :257 + :80",
            "path": "csr_headline",
            "launches": csr_launches["gather_ds_cumsum"],
            "main_path_launches": main_launches["gather_ds_cumsum"],
            "csr_path_launches": csr_launches["gather_ds_cumsum"],
            "sparse_path_launches": sparse_launches["gather_ds_cumsum"],
            "shape": head["shape"],
            "max_abs_err": max(r["max_abs_err"] for r in k9.values()),
            "ms": head["ms"],
            "trace_ms": head["trace_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": None,
            "bound_ms_l2_reads": head["edges"] / l2_reads_per_ms,
            "l2_reads_gelem_per_s": l2_reads_per_ms / 1e6,
            # The pair it replaced (the edge product, then K5), this run.
            "earlier_ms": head["earlier_ms"],
            "earlier_gather_multiply_ms": head["earlier_gather_multiply_ms"],
            "shapes": {
                where: {k: r[k] for k in ("shape", "edges", "table", "ms", "trace_ms", "plain_ms",
                                          "bound_ms", "bytes", "earlier_ms", "max_abs_err")}
                for where, r in k9.items()
            },
        }
    )
    # Each kernel's launches over the node phase's card converges, by
    # backend, and over the sharded headline converges, by backend and rank.
    for entry in kernels:
        wrapper = entry.get("wrapper", entry["name"])
        entry["node_launches"] = {b: node_launches[b].get(wrapper, 0) for b in NODE["backends"]}
        entry["plonk_launches"] = plonk_launches.get(wrapper, 0)
        entry["planes_launches"] = planes_launches.get(wrapper, 0)
        entry["server_launches"] = server_launches.get(wrapper, 0)
        entry["sharded_launches"] = {
            b: [ranks.get(wrapper, 0) for ranks in per_rank] for b, per_rank in sharded_launches.items()
        }
    print(json.dumps({"kernels": kernels}), flush=True)
    print(
        json.dumps(
            {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
