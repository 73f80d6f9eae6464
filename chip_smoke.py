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
proof's, every graft call's launches on its declared budget.

Every phase prints one JSON line.  Before the last line come the card's
``nvidia-smi`` name and power limit and one ``{"kernels": [...]}`` line
(per kernel: launches on its path — the windowed headline converge for
K1 and K5-K8 (K5 launches on no other path), the CSR headline converge
for K9, the probes phase for
K2-K4, the graft prove for K10-K13 (``graft_launches``) — on the main path, on the node's card converges by backend
(``node_launches``), on the PLONK node's card converges
(``plonk_launches``), on each rank of the sharded headline converges by
backend (``sharded_launches``), agreement with the plain version, its
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

    profiled = {
        "gather_window_kernel": "gather_windowed", "prefix_rows_kernel": "prefix_bridge",
        "permute4_kernel": "prefix_bridge", "ds_cumsum_rows_kernel": "ds_cumsum_axis1",
        "compensated_scan_kernel": "block_total_scan", "rowsum_tail_kernel": "rowsum_tail",
        "gather_ds_cumsum_kernel": "gather_ds_cumsum",
    }
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
                for kernel in profiled:
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
            want_traced = {
                k: budget.launches_per_step.get(w, 0) * iterations
                for k, w in profiled.items() if budget.launches_per_step.get(w, 0)
            }
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
    shutil.rmtree(keys.parent, ignore_errors=True)
    emit("plonk", nvidia_smi=smi, seconds=time.perf_counter() - t_phase, **rec)
    return totals, dict(prover=prover, atts=atts, config=config, card=card, trust_wrappers=wrappers)


GRAFT = dict(k10_n=1 << 20, msm_n=1 << 14, rate_sizes=(1 << 10, 1 << 12, 1 << 14), rate_reps=3,
             plain_reps=3, seed=13)
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
    digits equal, and equal to ``torch.sort``'s of the scalars' bytes, and
    its order a permutation that sorts them; K13's
    buckets equal as affine points, bucket 0 empty, at 2^14 random and
    {0, 1} scalars and the n = 33 edge batch), K11 and K13 timed beside
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

    # -- K12, K13 and msm_limbs at 2^14: random, {0, 1}; the n = 33 batch --
    mn = GRAFT["msm_n"]
    with calls.recording():
        with use_zk_backend("graft", dev):
            cache = srs._graft_cache()
    native_points = znative._points_to_limbs(srs.g1_powers[:mn])
    pts = cache.points[:mn]
    cases = {"random": canonical_words(mn),
             "zero_one": np.zeros((mn, 4), np.uint64)}
    cases["zero_one"][:, 0] = rng.integers(0, 2, size=mn, dtype=np.uint64)
    msm_parity, k12, k13 = {}, {}, {}
    for name, words in cases.items():
        st = gf.u64_to_tensor(words, dev)
        ds, perm = gpp.msm_window(st)
        ds_p, perm_p = gpp._window_plain(st)
        digits = gpp._digits(st)
        perm_ok = bool(torch.equal(torch.sort(perm.long(), dim=-1).values,
                                   torch.arange(mn, device=dev).expand(32, mn)))
        sorted_ok = bool(torch.equal(digits.gather(1, perm.long()), ds.long()))
        # The library call: one unstable torch.sort of each window's bytes.
        def library():
            return torch.sort(st.view(torch.uint8).reshape(mn, 32).t(), dim=-1)

        library_ok = bool(torch.equal(library().values.to(torch.int32), ds))
        check(torch.equal(ds, ds_p) and perm_ok and sorted_ok and library_ok,
              f"graft: K12 ({name}) differs from its plain version or its library call")
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
        k12[name] = dict(shape=[mn, 4], ms=time_ms(lambda: gpp.msm_window(st)),
                         plain_ms=time_ms(lambda: gpp._window_plain(st)),
                         library_ms=time_ms(library), library_equal=library_ok,
                         **bounds(32 * mn + 8 * 32 * mn, 0))
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
    rec.update(msm_vs_native=msm_parity, k12=k12, k13=k13)

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
              k12["random"], launches=launches["msm_window"],
              graft_launches=launches["msm_window"], skew=k12["zero_one"]),
        entry("zk_msm_bucket", "msm_bucket",
              "protocol_tpu/zk/graft/pippenger.py:150 + :166 + :171", k13["random"],
              launches=launches["msm_bucket"], graft_launches=launches["msm_bucket"],
              launches_a_call=["piece", "join"], earlier_ms=k13["random"]["earlier_ms"],
              earlier_source="protocol_tpu_torch/bench/csrc/zk_msm_bucket_chunked.cu",
              skew=k13["zero_one"]),
    ]


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
