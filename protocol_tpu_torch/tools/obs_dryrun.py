"""One-epoch node dryrun + observability scrape.

Boots the port's node (``Node.from_config``: the commitment prover, the
``cuda-sparse`` open-graph backend) on a loopback port, POSTs a handful
of signed attestations through the admission plane (lineage-sampled at
1:1), lets epoch ticks land until their lineage completes end to end,
then scrapes the observability surface over the HTTP socket:

- ``GET /metrics``  -> ``METRICS_scrape.txt`` (Prometheus text format)
- ``GET /trace/latest`` -> ``TRACE_epoch0.json`` (the epoch's span tree)
- ``GET /timeline/latest`` -> ``TIMELINE_latest.json`` (the epoch's
  joined record: watermarks, phases, proof lifecycle, freshness)
- ``GET /slo`` -> ``SLO.json`` (every objective green, or exit 1)
- ``GET /healthz`` (ok/degraded verdict with component state)
- ``GET /metrics/fleet`` (the process-labeled fleet-merged scrape)

and checks the acceptance shapes: metrics parse, residual count >=
iterations, the span tree roots at ``epoch_tick`` with every span
closed, end-to-end freshness observed (``stage="proof_landed"``), the
timeline joins phase and proof fragments, every SLO objective holds,
and the fleet scrape carries ``process`` labels.  Every check is an
explicit one (``python -O`` keeps them); a failed check exits 1 after
the artifacts are written.  ``--seed-slo-violation`` registers an
objective that cannot pass: the run must then exit 1, the self-check
that a regressing objective fails the gate.

The node converges on the card (``--device`` unset, raising where there
is none) or, with ``--device cpu``, on the backend's plain versions.
Beside the reference's artifacts it writes ``DRYRUN.json``: the device,
the card's name and power limit, the kernel launches of this process by
wrapper, the failed checks and the violating objectives.

Run: ``python -m protocol_tpu_torch.tools.obs_dryrun [--out-dir DIR] [--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from pathlib import Path

#: The objectives the dryrun requires by name (the node's default set
#: holds them and more; every registered one must be green).
REQUIRED_OBJECTIVES = (
    "freshness-p99",
    "proof-lag-p99",
    "epoch-cadence",
    "shed-rate",
    "residual-stall",
)

#: The admission plane's backpressure families, scrapeable from boot.
INGEST_FAMILIES = (
    ("eigentrust_ingest_queue_depth", "gauge"),
    ("eigentrust_ingest_shed_total", "counter"),
    ("eigentrust_ingest_verify_batches_total", "counter"),
    ("eigentrust_ingest_worker_restarts_total", "counter"),
)

#: Lineage hops that must each carry at least one freshness sample.
FRESHNESS_STAGES = ("admitted", "verified", "applied", "included", "proof_landed")


async def _http_get(port: int, path: str) -> tuple[str, str]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nhost: dryrun\r\n\r\n".encode())
    await writer.drain()
    response = (await reader.read()).decode()
    writer.close()
    head, _, body = response.partition("\r\n\r\n")
    return head, body


async def _http_post(port: int, path: str, payload: bytes) -> tuple[str, str]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(
        (
            f"POST {path} HTTP/1.1\r\nhost: dryrun\r\n"
            f"content-length: {len(payload)}\r\n\r\n"
        ).encode()
        + payload
    )
    await writer.drain()
    response = (await reader.read()).decode()
    writer.close()
    head, _, body = response.partition("\r\n\r\n")
    return head, body


def _json(body: str):
    try:
        return json.loads(body)
    except json.JSONDecodeError:
        return None


def parse_samples(metrics_body: str) -> dict[str, float]:
    """Prometheus text -> {sample name with labels: value}."""
    samples: dict[str, float] = {}
    for line in metrics_body.strip().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        name, _, value = line.rpartition(" ")
        samples[name] = float(value)
    return samples


def span_faults(node, path="epoch_tick") -> list[str]:
    """Span-tree integrity: every span closed (an orphaned span
    serializes ``duration_s=None``) and every span's end >= start."""
    faults = []
    dur = node.get("duration_s")
    if dur is None:
        faults.append(f"orphaned (never-closed) span: {path}")
    elif dur < 0:
        faults.append(f"span end < start at {path}: {dur}")
    if node.get("start_offset_s", -1) < 0:
        faults.append(f"negative start offset at {path}: {node.get('start_offset_s')}")
    for child in node.get("children", ()):
        faults.extend(span_faults(child, f"{path}/{child.get('name')}"))
    return faults


async def _dryrun(
    out_dir: Path,
    epoch_interval: int,
    timeout_s: float,
    device: str,
    seed_slo_violation: bool = False,
) -> int:
    from ..analysis.cases import launch_counts
    from ..node.attestation import AttestationData
    from ..node.config import ProtocolConfig
    from ..node.server import Node
    from ..obs import TRACER, configure_logging
    from ..obs.metrics import FRESHNESS_SECONDS
    from . import card_name_and_limit
    from .crash_matrix import warm_kernels

    t_run = time.perf_counter()
    configure_logging()
    backend = "cuda-sparse"
    warm_kernels(device, backend)
    cfg = ProtocolConfig(
        epoch_interval=epoch_interval,
        endpoint=((127, 0, 0, 1), 0),
        prover="commitment",
        trust_backend=backend,
        device=device,
        # Sample every accepted attestation so the handful POSTed below
        # all carry lineage through to proof_landed.
        lineage_sample_every=1,
    )
    node = Node.from_config(cfg)
    await node.start()
    if seed_slo_violation:
        from ..obs.slo import seed_violation

        seed_violation()
        print("obs_dryrun: seeded an always-violating SLO objective")
    port = node._server.sockets[0].getsockname()[1]
    print(f"obs_dryrun: node on 127.0.0.1:{port}, interval {epoch_interval}s, device {device}")

    failures: list[str] = []

    def need(cond, msg) -> None:
        if not cond:
            failures.append(str(msg))

    # Feed the admission plane a few signed attestations (the node's own
    # boot-time self-attestations, re-POSTed over the socket) so lineage
    # sampling has an end-to-end stream to follow.
    posted = 0
    for att in list(node.manager.attestations.values()):
        payload = AttestationData.from_attestation(att).to_bytes()
        _, body = await _http_post(port, "/attestation", payload)
        verdict = _json(body) or {}
        need(verdict.get("accepted"), f"attestation not accepted: {body[:200]}")
        posted += 1
    print(f"obs_dryrun: posted {posted} attestations through the plane")

    # Wait until (a) an epoch tick landed AND (b) the posted lineage
    # completed end to end (its including epoch's proof landed): up to
    # two ticks when the first boundary races the POSTs.
    def freshness_done() -> bool:
        return FRESHNESS_SECONDS.count(stage="proof_landed") >= 1

    waited = 0.0
    while TRACER.latest_epoch() is None or not freshness_done():
        if waited > timeout_s:
            print(
                "obs_dryrun: no epoch tick / lineage completion within "
                f"timeout (traced={TRACER.epochs()}, "
                f"proof_landed={FRESHNESS_SECONDS.count(stage='proof_landed')})",
                file=sys.stderr,
            )
            await node.stop()
            return 1
        await asyncio.sleep(0.25)
        waited += 0.25
    first_landed_s = time.perf_counter() - t_run

    metrics_head, metrics_body = await _http_get(port, "/metrics")
    trace_head, trace_body = await _http_get(port, "/trace/latest")
    latest = TRACER.latest_epoch()
    _, trace_by_number = await _http_get(port, f"/trace/{latest}")
    drift_head, drift_body = await _http_get(port, "/scores/drift")
    flight_head, flight_body = await _http_get(port, "/debug/flight")
    timeline_head, timeline_body = await _http_get(port, "/timeline/latest")
    _, timeline_by_number = await _http_get(port, f"/timeline/{latest}")
    slo_head, slo_body = await _http_get(port, "/slo")
    health_head, health_body = await _http_get(port, "/healthz")
    fleet_head, fleet_body = await _http_get(port, "/metrics/fleet")
    await node.stop()

    need("200 OK" in metrics_head, metrics_head)
    need("text/plain; version=0.0.4" in metrics_head, metrics_head)
    need("200 OK" in trace_head, trace_head)
    need("200 OK" in drift_head, drift_head)
    need("200 OK" in flight_head, flight_head)

    # /trace/latest must be BYTE-identical to /trace/<epoch> for the
    # newest epoch: the same serialized tree, not a re-render.
    need(trace_body == trace_by_number, f"/trace/latest diverges from /trace/{latest}")

    # -- acceptance shape ----------------------------------------------
    samples = parse_samples(metrics_body)
    iterations = samples.get("eigentrust_convergence_iterations", 0.0)
    residual_count = samples.get("eigentrust_convergence_residual_count", 0.0)
    epochs = samples.get("eigentrust_epochs_total", 0.0)
    need(epochs >= 1, f"no epochs counted: {epochs}")
    # One observation per iteration per epoch.
    need(residual_count >= iterations >= 1, f"residuals {residual_count}, iterations {iterations}")

    # Admission-plane backpressure surface: the queue-depth gauges and
    # shed counters are scrapeable from boot (HELP/TYPE advertised, the
    # per-stage rows materialized at zero), so a dashboard can alert on
    # shed > 0 without waiting for traffic.
    for name, kind in INGEST_FAMILIES:
        need(f"# TYPE {name} {kind}" in metrics_body, f"no # TYPE {name} {kind}")
        need(f"# HELP {name} " in metrics_body, f"no # HELP {name}")
    for stage in ("submit", "verify"):
        key = f'eigentrust_ingest_queue_depth{{stage="{stage}"}}'
        need(key in samples, f"no sample {key}")
    shed_key = 'eigentrust_ingest_shed_total{stage="submit"}'
    need(shed_key in samples, f"no sample {shed_key}")
    need(samples.get(shed_key, 0) == 0, "dryrun shed ingest traffic with no load")
    need("eigentrust_ingest_admission_seconds_count" in samples,
         "no eigentrust_ingest_admission_seconds_count")

    tree = _json(trace_body) or {}
    need(tree.get("name") == "epoch_tick", f"trace root {tree.get('name')}")
    child_names = [c.get("name") for c in tree.get("children", ())]
    need("prove" in child_names and "converge" in child_names, f"trace phases {child_names}")
    failures.extend(span_faults(tree))

    # Drift endpoint: one epoch has landed, so the monitor has a summary
    # (no previous fixed point yet -> l1/linf are null).
    drift = _json(drift_body) or {}
    need(drift.get("epoch") == tree.get("attrs", {}).get("epoch"), f"drift {drift}")
    need("stalled" in drift, f"drift {drift}")

    # Flight recorder: the tail replays the tick's event sequence, spans
    # (the epoch root included) and the plan/converge phases.
    flight = [json.loads(line) for line in flight_body.splitlines() if line]
    kinds = {e.get("kind") for e in flight}
    need("span" in kinds, f"flight kinds {kinds}")
    span_names = {e.get("name") for e in flight if e.get("kind") == "span"}
    need("epoch_tick" in span_names and "converge" in span_names, f"flight spans {span_names}")

    # -- fleet-plane surfaces --------------------------------------------
    need("200 OK" in timeline_head, timeline_head)
    need("200 OK" in slo_head, slo_head)
    need("200 OK" in fleet_head, fleet_head)
    need("text/plain; version=0.0.4" in fleet_head, fleet_head)

    # Timeline: the joined epoch record (phase durations from the span
    # tree, the ingest watermark from the host stage, the proof
    # lifecycle), and /timeline/latest == /timeline/<epoch>.
    need(timeline_body == timeline_by_number, "timeline latest diverges")
    timeline = _json(timeline_body) or {}
    need(timeline.get("epoch") == latest, f"timeline epoch {timeline.get('epoch')} != {latest}")
    need("converge" in timeline.get("phases", {}), f"timeline phases {timeline.get('phases')}")
    need(timeline.get("graph", {}).get("peers", 0) >= 1, f"timeline graph {timeline.get('graph')}")
    need(timeline.get("proof", {}).get("state") == "proved", f"timeline proof {timeline.get('proof')}")
    need(timeline.get("converge", {}).get("iterations", 0) >= 1,
         f"timeline converge {timeline.get('converge')}")

    # End-to-end freshness: the POSTed lineage completed, so every hop
    # histogram has samples and proof_landed is the headline.
    for stage in FRESHNESS_STAGES:
        key = f'eigentrust_freshness_seconds_count{{stage="{stage}"}}'
        need(samples.get(key, 0) >= 1, f"no freshness sample at {stage}")

    # SLO engine: every objective evaluated and green (a seeded violation
    # flips this and the dryrun exits 1: the self-check that the gate can
    # fail).
    slo = _json(slo_body) or {}
    objectives = slo.get("objectives", {})
    for required in REQUIRED_OBJECTIVES:
        need(required in objectives, f"objective {required} missing: {sorted(objectives)}")
    violating = sorted(k for k, o in objectives.items() if not o.get("ok"))
    slo_ok = bool(slo.get("ok")) and not violating

    # Health: the node just served an epoch, so the verdict is ok (or
    # degraded only by an SLO violation when one was seeded).
    health = _json(health_body) or {}
    need(health.get("status") in ("ok", "degraded"), f"health {health.get('status')}")
    need("200 OK" in health_head, health_head)
    need(health.get("components", {}).get("epoch", {}).get("latest") == latest,
         f"health epoch {health.get('components', {}).get('epoch')}")
    if not seed_slo_violation:
        need(health.get("status") == "ok", f"health {health.get('status')}")

    # Fleet scrape: one coherent exposition with per-process labels (the
    # node process at minimum; spawned workers add their own rows).
    need('process="node"' in fleet_body, f"fleet scrape: {fleet_body[:400]}")
    fleet_names = {
        line.split("{", 1)[0]
        for line in fleet_body.splitlines()
        if line and not line.startswith("#")
    }
    need("eigentrust_epochs_total" in fleet_names, "fleet scrape lacks eigentrust_epochs_total")

    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "METRICS_scrape.txt").write_text(metrics_body)
    (out_dir / "TRACE_epoch0.json").write_text(json.dumps(tree, indent=2) + "\n")
    (out_dir / "FLIGHT_tail.jsonl").write_text(flight_body)
    (out_dir / "TIMELINE_latest.json").write_text(json.dumps(timeline, indent=2) + "\n")
    (out_dir / "SLO.json").write_text(json.dumps(slo, indent=2) + "\n")
    landed = samples.get('eigentrust_freshness_seconds_count{stage="proof_landed"}', 0)
    (out_dir / "DRYRUN.json").write_text(json.dumps({
        "device": device,
        "nvidia_smi": card_name_and_limit(device),
        "backend": backend,
        "epoch_interval": epoch_interval,
        "epoch": latest,
        "iterations": iterations,
        "residual_count": residual_count,
        "lineage_completions": landed,
        "first_landed_s": first_landed_s,
        "seconds": time.perf_counter() - t_run,
        "health": health.get("status"),
        "slo_ok": slo_ok,
        "violating": violating,
        "seeded_violation": seed_slo_violation,
        "failed_checks": failures,
        "launches": launch_counts(),
    }, indent=2) + "\n")
    print(
        f"obs_dryrun: epoch {tree.get('attrs', {}).get('epoch')}, "
        f"{int(iterations)} iterations, {int(residual_count)} residuals, "
        f"phases {child_names}, {len(flight)} flight events, "
        f"{int(landed)} lineage completions, "
        f"health={health.get('status')}; artifacts in {out_dir}/"
    )
    if failures:
        print(f"obs_dryrun: FAILED checks: {failures}", file=sys.stderr)
        return 1
    if not slo_ok:
        print(
            f"obs_dryrun: SLO VIOLATION: objectives {violating} not met (see SLO.json)",
            file=sys.stderr,
        )
        return 1
    print("obs_dryrun: OK: all SLO objectives green")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=".", help="artifact directory (default: cwd)")
    ap.add_argument("--epoch-interval", type=int, default=2, help="epoch length, seconds")
    ap.add_argument("--timeout", type=float, default=120.0, help="max wait for the tick")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the node converges; unset means the card")
    ap.add_argument(
        "--seed-slo-violation",
        action="store_true",
        help="register an always-violating SLO objective; the dryrun "
        "must then exit non-zero (the gate's self-check)",
    )
    args = ap.parse_args(argv)
    from .. import resolve_device

    # --device unset means the card, and raises here where there is none.
    device = resolve_device(args.device).type
    return asyncio.run(
        _dryrun(
            Path(args.out_dir),
            args.epoch_interval,
            args.timeout,
            device,
            seed_slo_violation=args.seed_slo_violation,
        )
    )


if __name__ == "__main__":
    sys.exit(main())
