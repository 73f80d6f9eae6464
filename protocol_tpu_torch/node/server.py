"""The node daemon: HTTP API + epoch timer + chain-event ingestion.

The port of ``protocol_tpu/node/server.py`` (a rebuild of
server/src/main.rs:121-187): the same routes, status codes and bodies,
over the port's ``Manager``, whose epochs converge on the card backends
(``trust_backend`` a ``cuda-*`` rung, ``device`` unset for the card),
and the port's admission and proving planes.  The same three-way event
loop as asyncio tasks instead of tokio ``select!``:

- an HTTP listener serving ``GET /score`` → latest ProofRaw JSON
  (main.rs:85-119), keep-alive disabled like the reference;
- an epoch ticker with *Skip* missed-tick semantics (main.rs:129-131): a
  proof run longer than the interval drops ticks instead of backlogging;
- an AttestationCreated stream feeding ``Manager.add_attestation``.

Run: ``python -m protocol_tpu_torch.node.server --config <config.json>``
"""

from __future__ import annotations

import argparse
import asyncio
import logging
from dataclasses import dataclass, field

import json

from .. import chaos
from ..obs import (
    DRIFT,
    JOURNAL,
    LINEAGE,
    SLO_ENGINE,
    TIMELINE,
    TRACER,
    configure_logging,
    fleet_prometheus_text,
    prometheus_text,
)
from ..obs import metrics as obs_metrics
from ..obs.export import PROMETHEUS_CONTENT_TYPE, profile_session
from ..trust.backend import backend_class
from ..utils.telemetry import TELEMETRY
from .config import ProtocolConfig
from .epoch import Epoch
from .errors import EigenError
from .ethereum import FixtureEventSource
from .manager import Manager, ManagerConfig

log = logging.getLogger("protocol_tpu_torch.node")

chaos.declare("checkpoint.post_save", "snapshot landed, before the WAL truncates")

BAD_REQUEST = 400
NOT_FOUND = 404
TOO_MANY_REQUESTS = 429
INTERNAL_SERVER_ERROR = 500
SERVICE_UNAVAILABLE = 503

_STATUS_TEXT = {
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    429: "Too Many Requests",
    500: "Internal Server Error",
    503: "Service Unavailable",
}

#: Largest accepted POST body (an attestation payload is a few KiB).
_MAX_BODY = 1 << 20


def _backend_tag(manager: Manager) -> str:
    """Wire tag for the proof backend, declared by the Prover class
    itself — so clients dispatch on an explicit field instead of
    sniffing proof bytes.  Unknown provers serve an empty tag and
    clients fall back to shape detection."""
    return getattr(manager.prover, "wire_tag", "")


#: /healthz verdicts, in severity order (the gauge value is the index).
HEALTH_VERDICTS = ("ok", "degraded", "failed")


def node_health(node: "Node | None") -> tuple[int, dict]:
    """Aggregate component state into the load-balancer verdict:

    - ``ok``      → 200: epochs ticking, planes up, SLOs green;
    - ``degraded``→ 200: serving, but warming up (no epoch yet), an
      SLO is violating, or a plane shows backpressure/failures —
      readable by dashboards, still in rotation;
    - ``failed``  → 503: the epoch loop stalled past 3 intervals, or a
      configured plane never started — pull this node.

    Works without a node (``handle_request`` in tests/tools): the
    epoch-cadence and SLO components still evaluate from the
    process-global timeline/engine; plane components report absent."""
    problems: list[str] = []
    degraded: list[str] = []
    interval = float(node.config.epoch_interval) if node is not None else None
    since = TIMELINE.seconds_since_last_tick()
    latest = TIMELINE.latest_epoch()
    epoch_comp: dict = {
        "latest": latest,
        "seconds_since_last_tick": round(since, 3) if since is not None else None,
        "interval": interval,
    }
    if latest is None:
        degraded.append("no-epoch-yet")
    elif interval is not None and since is not None and since > 3.0 * interval:
        problems.append("epoch-loop-stalled")
    components: dict = {"epoch": epoch_comp}

    slo = SLO_ENGINE.last()
    components["slo"] = {
        "ok": bool(slo.get("ok", True)),
        "violating": sorted(
            name
            for name, o in slo.get("objectives", {}).items()
            if not o.get("ok", True)
        ),
    }
    if not components["slo"]["ok"]:
        degraded.append("slo-violating")

    if node is not None:
        # Boot recovery (node/wal.py): "recovering" while the WAL tail
        # replays — the load balancer keeps the node out of rotation's
        # hard-fail path but dashboards see exactly where boot is.
        recovering = node._recovery.get("state") == "recovering"
        components["recovery"] = dict(node._recovery)
        if recovering:
            degraded.append("recovering")
        ingest = node._ingest
        components["ingest"] = {
            "configured": bool(node.config.ingest_plane),
            "started": ingest is not None,
            "pending": ingest.stats()["pending"] if ingest is not None else None,
        }
        if (
            node.config.ingest_plane
            and ingest is None
            and node._server is not None
            and not recovering
        ):
            problems.append("ingest-plane-not-started")
        plane = node._prover_plane
        if plane is not None:
            stats = plane.stats()
            components["prover"] = {
                "configured": True,
                "generation": plane.pool.generation,
                "queue_depth": stats["queue_depth"],
                "pending": stats["pending"],
                "failed": stats["failed"],
                "lag_epochs": obs_metrics.PROOF_LAG_EPOCHS.value(),
            }
            if stats["failed"] > 0:
                degraded.append("proof-jobs-failed")
        else:
            components["prover"] = {"configured": bool(node.config.async_prover)}
        components["pipeline"] = {
            "configured": bool(node.config.epoch_pipeline),
            "queue_depth": obs_metrics.PIPELINE_QUEUE_DEPTH.value(),
        }
        if node.config.fleet_dir:
            # Pod heartbeat check: stamp our own snapshot
            # (the heartbeat other hosts' TTL reads) and re-scan the
            # exchange with the staleness TTL, so a silently dead
            # sibling degrades THIS host's /healthz before any gloo
            # collective hangs waiting for it.
            import os as _os

            from ..obs.fleet import FLEET, load_directory, publish_snapshot

            try:
                publish_snapshot(node.config.fleet_dir, _os.getpid())
                load_directory(
                    node.config.fleet_dir,
                    skip_pid=_os.getpid(),
                    max_age_s=node.config.fleet_stale_after_s or None,
                )
            except OSError:
                pass
            stale = FLEET.stale()
            components["fleet"] = {
                "configured": True,
                "sources": FLEET.sources(),
                "stale": {s: round(a, 3) for s, a in sorted(stale.items())},
            }
            if stale:
                degraded.append("fleet-stale-sources")

    if problems:
        verdict = "failed"
    elif degraded:
        verdict = "degraded"
    else:
        verdict = "ok"
    obs_metrics.HEALTH_STATUS.set(HEALTH_VERDICTS.index(verdict))
    status = SERVICE_UNAVAILABLE if verdict == "failed" else 200
    return status, {
        "status": verdict,
        "problems": problems,
        "degraded": degraded,
        "components": components,
    }


def handle_request(
    method: str, path: str, manager: Manager, plane=None, node=None
) -> tuple[int, str]:
    """Route one request (main.rs:85-119 + the rebuild's observability
    surface).  Returns (status, body).  ``plane`` is the node's async
    :class:`~protocol_tpu_torch.prover.plane.ProvingPlane` (or None in
    sequential-prove mode) — the ``/proof`` lifecycle source; ``node``
    is the owning :class:`Node` for the component-state surfaces
    (``/healthz``, the fleet scrape's directory exchange) and may be
    None for manager-only embedding."""
    if method == "GET" and path.startswith("/proof/"):
        # /proof/<epoch> (or /proof/latest): the proof itself when it
        # landed, else the job's lifecycle state (queued / proving /
        # failed / superseded) — the async proving plane's contract
        # that every epoch resolves explicitly, never silently.
        arg = path.removeprefix("/proof/")
        if arg == "latest":
            cached = manager.cached_proofs
            if cached:
                arg = str(max(cached, key=lambda e: e.number).number)
            elif plane is not None and plane.latest_epoch() is not None:
                arg = str(plane.latest_epoch())
            else:
                return NOT_FOUND, json.dumps({"error": "no proofs yet"})
        try:
            epoch_number = int(arg)
        except ValueError:
            return BAD_REQUEST, "InvalidQuery"
        proof = manager.cached_proofs.get(Epoch(epoch_number))
        status_obj = plane.status(epoch_number) if plane is not None else None
        if proof is not None:
            body = json.loads(
                proof.to_raw(backend=_backend_tag(manager)).to_json()
            )
            body["epoch"] = epoch_number
            body["state"] = "proved"
            if status_obj is not None:
                body.update(status_obj.to_dict())
            return 200, json.dumps(body)
        if status_obj is not None:
            return 200, json.dumps(status_obj.to_dict())
        return NOT_FOUND, json.dumps(
            {"epoch": epoch_number, "error": "no proof or proof job"}
        )
    if method == "GET" and path == "/score":
        try:
            proof = manager.get_last_proof()
        except EigenError as e:
            log.info("score query failed: %s", e)
            return BAD_REQUEST, "InvalidQuery"
        return 200, proof.to_raw(backend=_backend_tag(manager)).to_json()
    if method == "GET" and path.split("?", 1)[0] == "/aggregate":
        # /aggregate?epochs=3,7 — one-pairing batch verification of
        # cached epoch SNARKs (the aggregator surface the reference
        # never finished wiring).
        from urllib.parse import parse_qs, urlsplit

        try:
            qs = parse_qs(urlsplit(path).query)
            epochs = [
                Epoch(int(x))
                for x in qs.get("epochs", [""])[0].split(",")
                if x != ""
            ]
            if not epochs:
                return BAD_REQUEST, "InvalidQuery"
            ok, acc = manager.aggregate_proofs(epochs)
        except (EigenError, ValueError) as e:
            log.info("aggregate query failed: %s", e)
            return BAD_REQUEST, "InvalidQuery"
        body = {
            "ok": bool(ok),
            "epochs": [e.number for e in epochs],
            "accumulator": acc.to_bytes().hex() if acc is not None else None,
        }
        return 200, json.dumps(body)
    if method == "GET" and path == "/status":
        status = {
            "attestations": len(manager.attestations),
            "cached_proofs": len(manager.cached_proofs),
            "latest_epoch": max(
                (e.number for e in manager.cached_proofs), default=None
            ),
            "backend": manager.config.backend,
            "telemetry": TELEMETRY.snapshot(),
            "traced_epochs": TRACER.epochs(),
        }
        return 200, json.dumps(status)
    if method == "GET" and path == "/metrics":
        # Prometheus exposition format; _handle_conn switches the
        # content type to text/plain for this path.  Never touches
        # device state — purely the host-side registry snapshot.
        return 200, prometheus_text()
    if method == "GET" and path == "/metrics/fleet":
        # The fleet-merged exposition: this process's registry plus
        # every aggregated worker snapshot (and, with a configured
        # fleet_dir, every sibling process in a multi-process run),
        # each series stamped with a `process` label.
        if node is not None and node.config.fleet_dir:
            import os as _os

            from ..obs.fleet import load_directory, publish_snapshot

            publish_snapshot(node.config.fleet_dir, _os.getpid())
            load_directory(
                node.config.fleet_dir,
                skip_pid=_os.getpid(),
                max_age_s=node.config.fleet_stale_after_s or None,
            )
        return 200, fleet_prometheus_text()
    if method == "GET" and path == "/slo":
        # Evaluate-on-scrape: the engine also evaluates at every epoch
        # tick, so the burn windows advance with or without scrapers.
        return 200, json.dumps(SLO_ENGINE.evaluate())
    if method == "GET" and path == "/healthz":
        status, body = node_health(node)
        return status, json.dumps(body)
    if method == "GET" and path.startswith("/timeline/"):
        # /timeline/<epoch> (or /timeline/latest): the epoch's joined
        # record — ingest watermarks, phase durations, converge stats,
        # proof lifecycle, freshness summary — merged at write time by
        # every subsystem that touched the epoch.
        arg = path.removeprefix("/timeline/")
        if arg == "latest":
            latest = TIMELINE.latest_epoch()
            if latest is None:
                return NOT_FOUND, json.dumps({"error": "no epochs yet"})
            arg = str(latest)
        try:
            epoch_number = int(arg)
        except ValueError:
            return BAD_REQUEST, "InvalidQuery"
        record = TIMELINE.get(epoch_number)
        if record is None:
            return NOT_FOUND, json.dumps(
                {
                    "error": f"no timeline for epoch {epoch_number}",
                    "epochs": TIMELINE.epochs(),
                }
            )
        return 200, json.dumps(record)
    if method == "GET" and path == "/scores/drift":
        # Score-integrity surface (obs/watchers.py): L1/L∞ drift of
        # the last landed fixed point vs its predecessor, top movers,
        # and the residual-stall flag.  Empty object before the first
        # converged epoch.
        return 200, json.dumps(DRIFT.last())
    if method == "GET" and path.split("?", 1)[0] == "/debug/flight":
        # Flight-recorder tail: /debug/flight?n=200 (default: the full
        # in-memory ring) as a JSONL body, newest last — the same
        # format the crash dump writes, so tooling reads both.
        from urllib.parse import parse_qs, urlsplit

        try:
            qs = parse_qs(urlsplit(path).query)
            n = int(qs.get("n", ["-1"])[0])
        except ValueError:
            return BAD_REQUEST, "InvalidQuery"
        events = JOURNAL.tail(None if n < 0 else n)
        return 200, "".join(json.dumps(e) + "\n" for e in events)
    if method == "GET" and path.startswith("/trace/pod"):
        # /trace/pod/<epoch> (or /trace/pod[/latest]): the stitched
        # pod epoch trace — N hosts' span trees clock-aligned onto one
        # timeline with per-phase skew, barrier-arrival spread, and
        # phase attribution (obs/podtrace.py).  Serves the stitch
        # store; a miss with a configured fleet_dir stitches on demand
        # from the published per-host files (any host can answer, not
        # just the host that stitched at tick time).
        from ..obs import podtrace

        arg = path.removeprefix("/trace/pod").lstrip("/")
        fleet_dir = (
            node.config.fleet_dir
            if node is not None and node.config.fleet_dir
            else None
        )
        if arg in ("", "latest"):
            # "latest" is the newer of the local stitch store and the
            # published exchange — a host whose store lags (it is not
            # the tick-time stitcher) must not serve a stale epoch.
            latest = podtrace.POD_TRACES.latest_epoch()
            if fleet_dir is not None:
                published = podtrace.directory_epochs(fleet_dir)
                if published and (latest is None or published[-1] > latest):
                    latest = published[-1]
            if latest is None:
                return NOT_FOUND, json.dumps({"error": "no pod epochs stitched yet"})
            arg = str(latest)
        try:
            epoch_number = int(arg)
        except ValueError:
            return BAD_REQUEST, "InvalidQuery"
        stitched = podtrace.POD_TRACES.get(epoch_number)
        if stitched is None and fleet_dir is not None:
            stitched = podtrace.stitch_epoch(fleet_dir, epoch_number)
        if stitched is None:
            return NOT_FOUND, json.dumps(
                {"error": f"no pod trace for epoch {epoch_number}",
                 "stitched_epochs": podtrace.POD_TRACES.epochs()}
            )
        return 200, json.dumps(stitched)
    if method == "GET" and path.startswith("/trace/"):
        # /trace/<epoch> (or /trace/latest): the epoch's span tree as
        # nested JSON (epoch_tick → prove/build_graph/plan/converge/
        # checkpoint), serialized once at tick end — serving it is a
        # dict copy, no sync with the epoch executor.
        arg = path.removeprefix("/trace/")
        if arg == "latest":
            latest = TRACER.latest_epoch()
            if latest is None:
                return NOT_FOUND, json.dumps({"error": "no epochs traced yet"})
            arg = str(latest)
        try:
            epoch_number = int(arg)
        except ValueError:
            return BAD_REQUEST, "InvalidQuery"
        trace = TRACER.get_trace(epoch_number)
        if trace is None:
            return NOT_FOUND, json.dumps(
                {"error": f"no trace for epoch {epoch_number}",
                 "traced_epochs": TRACER.epochs()}
            )
        return 200, json.dumps(trace)
    return NOT_FOUND, "InvalidRequest"


@dataclass
class Node:
    config: ProtocolConfig
    manager: Manager
    _server: asyncio.AbstractServer | None = field(default=None, repr=False)
    _tasks: list = field(default_factory=list, repr=False)
    #: Double-buffered epoch engine (config.epoch_pipeline): host
    #: stages of epoch k+1 overlap device converge + proving of epoch
    #: k; None in sequential mode.
    _pipeline: object | None = field(default=None, repr=False)
    #: Admission plane (config.ingest_plane, on by default): bounded
    #: intake + sharded dedup + rate limits + the verify worker pool in
    #: front of the Manager; POST /attestation and the chain-event
    #: stream both route through it.  None = legacy direct ingest.
    _ingest: object | None = field(default=None, repr=False)
    #: Async proving plane (config.async_prover): epoch ticks enqueue
    #: the SNARK; a spawn-based prover pool drains it and landed proofs
    #: install into the Manager's cache from a dispatcher thread.
    #: None = the sequential prove-per-tick path.
    _prover_plane: object | None = field(default=None, repr=False)
    #: Write-ahead attestation log (config.wal + checkpoint_dir); also
    #: reachable as ``manager.wal`` once recovery attaches it.
    _wal: object | None = field(default=None, repr=False)
    #: Boot-recovery state machine surfaced as the /healthz
    #: ``recovery`` component: ``disabled`` (no checkpoint dir),
    #: ``recovering`` (checkpoint load + WAL replay in flight — the
    #: HTTP socket is already up so the walk is scrapeable), ``ok``
    #: (plus the recovery report: checkpoint epoch, fallbacks, records
    #: replayed, seconds).
    _recovery: dict = field(
        default_factory=lambda: {"state": "disabled"}, repr=False
    )

    @classmethod
    def from_config(cls, config: ProtocolConfig) -> "Node":
        """Build the node's manager: ``config.device`` None means the
        card, and a card backend raises where there is none; a
        ``tpu-*`` backend name raises ``get_backend``'s ValueError."""
        backend_class(config.trust_backend)
        manager = Manager(
            ManagerConfig(
                backend=config.trust_backend,
                device=config.device,
                prover=config.prover,
                srs_path=config.srs_path,
                warm_start=config.warm_start,
                plan_delta_max_churn=config.plan_delta_max_churn,
            )
        )
        return cls(config=config, manager=manager)

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            request_line = await asyncio.wait_for(reader.readline(), timeout=10)
            parts = request_line.decode("latin1").split()
            if len(parts) < 2:
                status, body = BAD_REQUEST, "InvalidRequest"
            else:
                # Drain headers (connection: close semantics), bounded
                # against slow-loris: at most 100 header lines within
                # one 10s total deadline.  content-length is the one
                # header the ingest POST route needs.
                async def drain_headers() -> int:
                    length = 0
                    for _ in range(100):
                        line = await reader.readline()
                        if line in (b"\r\n", b"\n", b""):
                            return length
                        name, _, value = line.decode("latin1").partition(":")
                        if name.strip().lower() == "content-length":
                            try:
                                length = int(value.strip())
                            except ValueError:
                                length = 0
                    return length

                content_length = await asyncio.wait_for(drain_headers(), timeout=10)
                if parts[0] == "POST" and parts[1].split("?", 1)[0] == "/attestation":
                    # Admission-plane intake: bounded body read, then a
                    # non-blocking submit whose verdict (or 429 shed)
                    # is awaited without holding the event loop.
                    payload_in = b""
                    if 0 < content_length <= _MAX_BODY:
                        payload_in = await asyncio.wait_for(
                            reader.readexactly(content_length), timeout=10
                        )
                    status, body = await self._handle_ingest_post(parts[1], payload_in)
                elif parts[1].split("?", 1)[0] == "/aggregate":
                    # Aggregation runs verify_deferred per member plus a
                    # pairing — seconds of crypto that must not stall the
                    # event loop (reference stance: heavy work off-loop,
                    # like _epoch_tick).
                    status, body = await asyncio.get_running_loop().run_in_executor(
                        None,
                        handle_request,
                        parts[0],
                        parts[1],
                        self.manager,
                        self._prover_plane,
                        self,
                    )
                else:
                    status, body = handle_request(
                        parts[0], parts[1], self.manager, self._prover_plane, self
                    )
            payload = body.encode()
            content_type = (
                PROMETHEUS_CONTENT_TYPE
                if len(parts) >= 2
                and parts[1].split("?", 1)[0] in ("/metrics", "/metrics/fleet")
                else "application/json"
            )
            writer.write(
                (
                    f"HTTP/1.1 {status} {_STATUS_TEXT.get(status, 'Unknown')}\r\n"
                    f"content-type: {content_type}\r\n"
                    f"content-length: {len(payload)}\r\n"
                    f"connection: close\r\n\r\n"
                ).encode()
                + payload
            )
            await writer.drain()
        except (asyncio.TimeoutError, asyncio.IncompleteReadError, ConnectionError) as e:
            log.warning("error serving connection: %r", e)
        finally:
            writer.close()

    async def _handle_ingest_post(self, path: str, payload: bytes) -> tuple[int, str]:
        """POST /attestation[?nonce=N]: decode the wire payload and
        route it through the admission plane.  Verdict → status: 200
        accepted, 400 rejected (reason in the body), 429 shed (the
        submit queue is full — back off and retry).  Without a plane
        (config.ingest_plane=false) the legacy direct path runs in an
        executor so signature checks never block the event loop."""
        from urllib.parse import parse_qs, urlsplit

        from .attestation import AttestationData

        n = self.manager.config.num_neighbours
        try:
            qs = parse_qs(urlsplit(path).query)
            nonce = int(qs["nonce"][0]) if "nonce" in qs else None
            att = AttestationData.from_bytes(payload, n).to_attestation(n)
        except (ValueError, KeyError, IndexError):
            return BAD_REQUEST, json.dumps(
                {"accepted": False, "reason": "malformed-payload"}
            )
        if self._ingest is None:
            result = await asyncio.get_running_loop().run_in_executor(
                None, self.manager.add_attestation, att
            )
        else:
            from ..ingest.plane import SHED_REASON

            future = self._ingest.submit(att, nonce=nonce, raw=payload)
            try:
                result = await asyncio.wait_for(asyncio.wrap_future(future), timeout=30)
            except asyncio.TimeoutError:
                return INTERNAL_SERVER_ERROR, json.dumps(
                    {"accepted": False, "reason": "verdict-timeout"}
                )
            if not result.accepted and result.reason == SHED_REASON:
                return TOO_MANY_REQUESTS, json.dumps(
                    {"accepted": False, "reason": result.reason}
                )
        status = 200 if result.accepted else BAD_REQUEST
        return status, json.dumps(
            {"accepted": result.accepted, "reason": result.reason}
        )

    def _epoch_tick(self, epoch: Epoch) -> None:
        """One epoch of work: the fixed-set proof (reference parity) and,
        on a card backend, open-graph convergence at scale; snapshots the
        assembled graph + scores when a checkpoint dir is configured.

        The whole tick runs under the epoch's trace root
        (``epoch_tick`` → prove → build_graph → plan → converge →
        checkpoint): spans open and close only at these host
        boundaries, so the tree costs a few context-manager entries per
        epoch and nothing inside the device loop.

        It runs on the event loop's default executor, not on the thread
        that built the manager: the manager resolved its device once at
        construction (``Manager.device``, e.g. ``cuda:0``), so the
        converge lands on the node's card from any thread."""
        with TRACER.epoch(epoch.number):
            if self._prover_plane is None:
                # Sequential semantics prove the cache as of tick
                # start — bind the lineage cohort now so this tick's
                # proof completes exactly what it attests to.
                LINEAGE.bind_epoch(epoch.number)
                self._prove_or_enqueue(epoch)
            scores = None
            if self.manager.config.backend != "native-cpu":
                # Opt-in torch.profiler session (ProtocolConfig.profile_dir):
                # a device-timeline capture of exactly the convergence
                # region, epoch-tagged subdirectories so ticks don't
                # overwrite each other.
                profile_dir = (
                    f"{self.config.profile_dir}/epoch_{epoch.number}"
                    if self.config.profile_dir
                    else None
                )
                with TELEMETRY.timer("epoch.converge_open_graph"):
                    with profile_session(profile_dir, self.manager.device):
                        result = self.manager.converge_epoch(epoch, alpha=0.1)
                scores = result.scores
                log.info(
                    "epoch %s: open graph n=%d converged in %d iters (resid %.2e) on %s",
                    epoch,
                    len(result.scores),
                    result.iterations,
                    result.residual,
                    result.backend,
                )
            self._checkpoint_epoch(epoch, scores)
            if self._prover_plane is not None:
                # Async mode enqueues at tick END: the job snapshot is
                # the tick's final state, and the prove starts once the
                # tick's own CPU burst (converge + checkpoint) is done
                # — on a small host the worker gets the inter-tick gap
                # instead of time-slicing against converge.
                self._prove_or_enqueue(epoch)
        TELEMETRY.count("epochs")
        obs_metrics.EPOCHS_TOTAL.inc()
        # Continuous SLO evaluation: every landed tick advances the
        # burn windows (scrapes of GET /slo evaluate too).
        SLO_ENGINE.evaluate()
        if self._ingest is not None:
            # Epoch-aligned dedup eviction: "recent" replays are those
            # inside the horizon that could still perturb convergence.
            self._ingest.advance_epoch()

    def _prove_or_enqueue(self, epoch: Epoch) -> None:
        """The epoch tick's proof step.  Sequential mode runs the full
        prove inline (reference semantics: a proof per tick before the
        tick ends).  With the async proving plane, the tick only
        *snapshots* the statement and enqueues it — microseconds — and
        the SNARK runs in a prover worker while the epoch loop moves
        on; the landed proof installs into the cache from a dispatcher
        thread and its attribution grafts back into this epoch's
        trace."""
        if self._prover_plane is None:
            with TELEMETRY.timer("epoch.calculate_proofs"), TRACER.span("prove"):
                self.manager.calculate_proofs(epoch)
            return
        with TRACER.span("prove_enqueue"):
            if chaos.ACTIVE:
                chaos.fire("prover.pre_enqueue")
            status = self._prover_plane.submit(self.manager.build_proof_job(epoch))
        log.info("epoch %s: proof job enqueued (state=%s)", epoch, status.state)

    def _checkpoint_epoch(self, epoch: Epoch, scores) -> None:
        """Snapshot the epoch (graph + scores + proof + windowed plan +
        the peer-hash column that keys the warm-start remap) when a
        checkpoint dir is configured; shared by the sequential tick and
        the pipelined device stage."""
        if not self.config.checkpoint_dir:
            return
        from .checkpoint import CheckpointStore

        # Persist exactly the graph the scores were computed on
        # (ingest keeps mutating the attestation cache concurrently;
        # a rebuilt graph could have more peers than scores).  The WAL
        # watermark pairs with the graph: for a converged epoch it is
        # the one read before that graph's assembly; for the fixed-set
        # path it is read before the fresh build below.
        wal = self.manager.wal
        if scores is not None:
            graph = self.manager.last_graph
            wal_seq = self.manager.checkpoint_watermark()
        else:
            wal_seq = wal.applied_watermark() if wal is not None else None
            graph = self.manager.build_graph()
        # Async proving: the proof usually hasn't landed by checkpoint
        # time (that's the point) — snapshot without it; the proof is
        # re-derivable from the attestation stream and served from the
        # cache once the plane lands it.
        try:
            proof_json = (
                self.manager.get_proof(epoch)
                .to_raw(backend=_backend_tag(self.manager))
                .to_json()
            )
        except EigenError:
            proof_json = None
        with TELEMETRY.timer("epoch.checkpoint"), TRACER.span("checkpoint"):
            store = CheckpointStore(self.config.checkpoint_dir)
            store.save(
                epoch,
                graph,
                scores,
                proof_json,
                # cuda-windowed only: the one-time bucketing plan, so
                # a reboot revalidates instead of rebuilding it.
                plan=self.manager.window_plan,
                peer_hashes=(
                    self.manager.last_peer_hashes if scores is not None else None
                ),
                wal_seq=wal_seq,
                # The cache itself (senders' last wire rows): the
                # recovery state graph columns can't reconstruct, and
                # the truncated WAL no longer holds.  A superset of
                # the graph's inputs is safe; the WAL tail replays the
                # rest idempotently.
                attestations=self.manager.snapshot_attestations(),
            )
            if chaos.ACTIVE:
                # Snapshot landed, WAL not yet truncated: a crash here
                # must replay idempotently (the dedup'd cache absorbs
                # re-applied records the snapshot already holds).
                chaos.fire("checkpoint.post_save")
            if wal is not None:
                # Truncate through the OLDEST retained snapshot's
                # watermark, not this epoch's: a torn latest snapshot
                # falls back epoch by epoch, and the fallback target
                # must still find every record it lacks in the log.
                floor = store.retained_wal_floor()
                if floor is not None:
                    wal.truncate_through(floor)

    def _pipeline_device_stage(self, prepared):
        """Device half of a pipelined epoch: prove → converge (from the
        prepared graph/warm seed) → checkpoint, under the epoch's trace
        root.  Host assembly already happened in
        ``Manager.prepare_epoch`` on the submit side — by the time this
        runs, the next epoch's host stage may already be executing."""
        epoch = prepared.epoch
        with TRACER.epoch(epoch.number):
            if self._prover_plane is None:
                LINEAGE.bind_epoch(epoch.number)
                self._prove_or_enqueue(epoch)
            scores = None
            result = None
            if self.manager.config.backend != "native-cpu":
                profile_dir = (
                    f"{self.config.profile_dir}/epoch_{epoch.number}"
                    if self.config.profile_dir
                    else None
                )
                with TELEMETRY.timer("epoch.converge_open_graph"):
                    with profile_session(profile_dir, self.manager.device):
                        result = self.manager.converge_prepared(prepared, alpha=0.1)
                scores = result.scores
                log.info(
                    "epoch %s: open graph n=%d converged in %d iters (resid %.2e) on %s%s",
                    epoch,
                    len(result.scores),
                    result.iterations,
                    result.residual,
                    result.backend,
                    " [warm]" if prepared.t0 is not None else "",
                )
            self._checkpoint_epoch(epoch, scores)
            if self._prover_plane is not None:
                # Tick-end enqueue (see _epoch_tick): the prove gets
                # the inter-tick gap, never this tick's core budget.
                self._prove_or_enqueue(epoch)
        TELEMETRY.count("epochs")
        obs_metrics.EPOCHS_TOTAL.inc()
        SLO_ENGINE.evaluate()
        if self._ingest is not None:
            self._ingest.advance_epoch()
        return result

    async def _epoch_loop(self, warm=None):
        if warm is not None:
            await warm  # boot keygen must land before the first prove
        interval = self.config.epoch_interval
        last_epoch: int | None = None
        while True:
            await asyncio.sleep(Epoch.secs_until_next_epoch(interval))
            epoch = Epoch.current_epoch(interval)
            # Skip semantics drop boundaries a long tick overran; make
            # the drops countable instead of silent (the gap between
            # consecutively processed epochs is exactly the drop count).
            if last_epoch is not None and epoch.number > last_epoch + 1:
                dropped = epoch.number - last_epoch - 1
                obs_metrics.EPOCH_TICKS_DROPPED.inc(dropped)
                log.warning(
                    "epoch %s: dropped %d epoch tick(s) (previous tick overran)",
                    epoch,
                    dropped,
                )
            last_epoch = epoch.number
            try:
                if self._pipeline is not None:
                    # Pipelined: only the host stage (graph assembly,
                    # warm remap, plan delta) runs here; the device
                    # stage overlaps with the NEXT boundary's host
                    # work.  A busy device coalesces queued epochs
                    # instead of dropping ticks.
                    await asyncio.get_running_loop().run_in_executor(
                        None, self._pipeline.submit, epoch
                    )
                    log.info("epoch %s: submitted to pipeline", epoch)
                else:
                    # Proving may outlast the interval; the next sleep
                    # targets the *next* boundary from now = Skip
                    # semantics.
                    await asyncio.get_running_loop().run_in_executor(
                        None, self._epoch_tick, epoch
                    )
                    log.info("epoch %s: proof cached", epoch)
            except Exception as e:
                log.error("epoch %s: %r", epoch, e)
                JOURNAL.record(
                    "anomaly", what="epoch-tick-failed", epoch=epoch.number,
                    error=repr(e),
                )

    def _event_source(self):
        if self.config.event_fixture:
            return FixtureEventSource(self.config.event_fixture)
        from .ethereum import Web3EventSource, have_web3

        if have_web3():
            return Web3EventSource(
                self.config.ethereum_node_url, self.config.as_contract_address
            )
        log.info("no event fixture configured and web3 not installed; ingest idle")
        return None

    async def _event_loop(self):
        from .ethereum import ChainEventSource

        source = self._event_source()
        if source is None:
            return
        stream_kwargs = {}
        if isinstance(source, ChainEventSource) and self.config.checkpoint_dir:
            # Resumable replay: the block cursor rides the checkpoint
            # manifest, so a restart resumes the chain replay where it
            # left off instead of from block 0 (the WAL already holds
            # everything accepted since the last snapshot).
            from .checkpoint import CheckpointStore

            store = CheckpointStore(self.config.checkpoint_dir)
            stream_kwargs = {
                "cursor": store.block_cursor(),
                "on_advance": store.save_block_cursor,
            }
        async for event in source.stream(**stream_kwargs):
            try:
                from .attestation import AttestationData

                att_data = AttestationData.from_bytes(
                    event.val, self.manager.config.num_neighbours
                )
                att = att_data.to_attestation(self.manager.config.num_neighbours)
                if self._ingest is not None:
                    # Non-blocking: the plane owns dedup/rate/verify;
                    # the verdict lands in a callback so a verify
                    # backlog never stalls the event stream.
                    future = self._ingest.submit(att, raw=event.val)
                    future.add_done_callback(
                        lambda f, creator=event.creator: self._log_ingest(f, creator)
                    )
                else:
                    result = self.manager.add_attestation(att)
                    if result.accepted:
                        log.info("attestation ingested from %s", event.creator)
                    else:
                        log.warning(
                            "rejected attestation event: %s", result.reason
                        )
            except (EigenError, ValueError) as e:
                log.warning("rejected attestation event: %s", e)

    @staticmethod
    def _log_ingest(future, creator: str) -> None:
        result = future.result()
        if result.accepted:
            log.info("attestation ingested from %s", creator)
        else:
            log.warning(
                "rejected attestation event from %s: %s", creator, result.reason
            )

    def _wal_dir(self) -> str:
        return self.config.wal_dir or f"{self.config.checkpoint_dir}/wal"

    def _recover_state(self) -> None:
        """Boot recovery (node/wal.py): newest *valid* checkpoint (torn
        or corrupt snapshots fall back epoch by epoch) → warm state →
        WAL tail replayed through ``apply_verified`` → WAL attached so
        new accepts append.  Runs in an executor while the HTTP socket
        already serves — /healthz reports the ``recovering`` component
        state until this returns.  The chain replay (the source of
        truth, main.rs:139-143) still runs afterwards, resuming from
        the persisted block cursor, and overwrites as it catches up."""
        from .checkpoint import CheckpointStore
        from .wal import AttestationWAL, recover

        store = CheckpointStore(self.config.checkpoint_dir)
        wal = None
        if self.config.wal:
            wal = AttestationWAL(
                self._wal_dir(),
                segment_max_bytes=self.config.wal_segment_bytes,
                fsync=self.config.wal_fsync,
            )
        report = recover(self.manager, store, wal)
        self._wal = wal
        self._recovery = {"state": "ok", **report}
        log.info(
            "recovered: checkpoint epoch %s (%d fallback(s)), %d WAL "
            "record(s) replayed (%d torn-tail dropped) in %.3fs",
            report["checkpoint_epoch"],
            report["checkpoint_fallbacks"],
            report["wal_replayed"],
            report["wal_dropped_tail"],
            report["seconds"],
        )

    def _flight_dump_path(self) -> str:
        """Where the flight-recorder ring lands on crash/SIGTERM."""
        if self.config.journal_path:
            return str(self.config.journal_path) + ".dump"
        return "FLIGHT_dump.jsonl"

    def dump_flight_recorder(self, reason: str) -> None:
        """Persist the flight-recorder ring for a post-mortem; never
        raises (this runs on the way down)."""
        try:
            path = JOURNAL.dump(self._flight_dump_path(), reason=reason)
            log.warning("flight recorder dumped to %s (%s)", path, reason)
        except Exception:  # noqa: BLE001 - dying anyway; don't mask the cause
            log.exception("flight recorder dump failed")

    async def start(self) -> None:
        if self.config.journal_path:
            JOURNAL.configure(self.config.journal_path)
        # Fault-injection schedule (chaos tooling only): the env var
        # wins — it is how the crash matrix drives a node it spawns.
        if self.config.chaos and not chaos.ACTIVE:
            chaos.configure(self.config.chaos)
        # Fleet-plane boot: lineage sampling period and the standing
        # SLO objectives (cadence target derives from the configured
        # epoch interval).
        LINEAGE.configure(self.config.lineage_sample_every)
        from ..obs.slo import install_defaults

        install_defaults(
            epoch_interval_s=self.config.epoch_interval,
            freshness_p99_s=self.config.slo_freshness_p99_s,
            proof_lag_p99_s=self.config.slo_proof_lag_p99_s,
        )
        # Pod objectives only where a pod exchange exists: a
        # single-process node must not carry objectives over signals
        # it can never produce (they would read None forever).
        if self.config.fleet_dir:
            from ..obs.slo import install_pod_defaults
            from ..obs.watchers import STRAGGLERS

            install_pod_defaults(
                phase_skew_p99_s=self.config.slo_pod_skew_p99_s,
                heartbeat_max_age_s=self.config.fleet_stale_after_s,
            )
            STRAGGLERS.configure(
                ratio=self.config.straggler_ratio,
                k=self.config.straggler_epochs,
            )
        # SIGTERM post-mortem: dump the event ring before the process
        # dies, so "what was the node doing" survives an orchestrator
        # kill.  Best-effort — platforms without add_signal_handler
        # (or non-main-thread loops) skip it.
        try:
            import signal

            loop = asyncio.get_running_loop()
            loop.add_signal_handler(
                signal.SIGTERM,
                lambda: (
                    self.dump_flight_recorder("SIGTERM"),
                    loop.call_soon(asyncio.ensure_future, self.stop()),
                ),
            )
        except (NotImplementedError, RuntimeError, ValueError):
            pass
        # The HTTP socket comes up BEFORE recovery so /healthz can
        # report the walk: recovering (checkpoint load + WAL replay in
        # an executor, the loop stays responsive) → ok.  The epoch and
        # event loops start strictly after recovery lands.
        self._server = await asyncio.start_server(
            self._handle_conn, self.config.host, self.config.port
        )
        # Initial self-attestations first: the WAL replay below then
        # overwrites any fixed-set row with the newer accepted state
        # (never the reverse — recovery must not resurrect defaults).
        self.manager.generate_initial_attestations()
        if self.config.checkpoint_dir:
            self._recovery = {"state": "recovering"}
            await asyncio.get_running_loop().run_in_executor(
                None, self._recover_state
            )
        if self.config.ingest_plane:
            from ..ingest import IngestPlane, IngestPlaneConfig
            from ..ingest.ratelimit import RateLimitConfig

            # The EigenTrust pre-trust set is the spam anchor: its
            # members bypass rate/spam gates (dedup still applies).
            whitelist = (
                frozenset(
                    (pk.point.x, pk.point.y) for pk in self.manager._group_pks
                )
                if self.config.ingest_whitelist_pretrusted
                else frozenset()
            )
            self._ingest = IngestPlane(
                self.manager,
                IngestPlaneConfig(
                    workers=self.config.ingest_workers,
                    batch_size=self.config.ingest_batch_size,
                    submit_queue_max=self.config.ingest_queue_max,
                    rate=RateLimitConfig(
                        rate=self.config.ingest_rate_rps,
                        burst=self.config.ingest_rate_burst,
                        whitelist=whitelist,
                    ),
                ),
            ).start()
        if self.config.epoch_pipeline:
            from .pipeline import EpochPipeline

            self._pipeline = EpochPipeline(
                self.manager, device_stage=self._pipeline_device_stage
            ).start()
        if self.config.async_prover:
            from ..prover import ProvingPlane, ProvingPlaneConfig

            manager = self.manager

            def _install(result) -> None:
                manager.install_proof(result.epoch, result.pub_ins, result.proof)

            self._prover_plane = ProvingPlane(
                ProvingPlaneConfig(
                    workers=self.config.prover_workers,
                    queue_depth=self.config.prover_queue_max,
                    prove_timeout_s=self.config.prove_timeout_s,
                    omp_threads=self.config.prover_omp_threads,
                ),
                on_proved=_install,
            ).start()
            # Worker SRS/proving-key prewarm runs off-loop with the
            # parent keygen below: the parent writes the disk key cache
            # first (so every worker loads the SAME key), then each
            # worker warms from it — steady-state jobs pay no setup.
            cfg = self.manager.config
            plane = self._prover_plane
            asyncio.get_running_loop().run_in_executor(
                None,
                lambda: (
                    manager.warm_prover(),
                    plane.prewarm(
                        (
                            cfg.num_neighbours,
                            cfg.num_iter,
                            cfg.initial_score,
                            cfg.scale,
                        ),
                        cfg.prover,
                        cfg.srs_path,
                    ),
                ),
            )
        # Boot-time keygen, like the reference's MANAGER_STORE init
        # (server/src/main.rs:70-83): runs in an executor so the HTTP
        # socket comes up while the (cached ~0.7 s / cold ~13 s) PLONK
        # key loads; the epoch loop awaits it before the first tick so
        # proving never pays keygen.
        warm = asyncio.get_running_loop().run_in_executor(
            None, self.manager.warm_prover
        )
        self._tasks = [
            asyncio.create_task(self._epoch_loop(warm)),
            asyncio.create_task(self._event_loop()),
        ]
        log.info("listening on http://%s:%s", self.config.host, self.config.port)

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        if self._ingest is not None:
            # Give in-flight admissions a bounded window to land, then
            # resolve stragglers with reason="shutdown" — off-loop so a
            # saturated verify tier can't stall stop().
            await asyncio.get_running_loop().run_in_executor(
                None, lambda: self._ingest.close(drain=True, timeout=5.0)
            )
        if self._pipeline is not None:
            # Let in-flight device work land (bounded), then stop the
            # worker; run off-loop so a slow prover can't stall stop().
            await asyncio.get_running_loop().run_in_executor(
                None, lambda: self._pipeline.close(drain=True, timeout=30.0)
            )
        if self._prover_plane is not None:
            # Queued/in-flight proofs get a bounded window to land;
            # stragglers resolve with an explicit terminal state.
            await asyncio.get_running_loop().run_in_executor(
                None, lambda: self._prover_plane.close(drain=True, timeout=30.0)
            )
        if self._server:
            self._server.close()
            await self._server.wait_closed()
        if self._wal is not None:
            # Seal the active segment (flush + rotate) — a clean stop
            # leaves no unflushed tail for the next boot to drop.
            self._wal.close()
        # Flush the journal's pending batch so the on-disk JSONL is
        # complete through the stop (the ring itself stays queryable).
        JOURNAL.flush()

    async def run_forever(self) -> None:
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="protocol_tpu_torch node")
    parser.add_argument("--config", required=True)
    args = parser.parse_args(argv)
    # Single logging entry point (obs.configure_logging): installs the
    # span-aware handler only when the embedding application hasn't
    # configured the root logger already, and stamps every record with
    # the current epoch/span ids either way.
    configure_logging(level=logging.INFO)
    config = ProtocolConfig.load(args.config)
    node = Node.from_config(config)
    try:
        asyncio.run(node.run_forever())
    except (Exception, KeyboardInterrupt):
        # Crash post-mortem: the last thing the process does is
        # persist the flight-recorder ring, then re-raise so the exit
        # code and traceback are unchanged.
        node.dump_flight_recorder("crash")
        raise


if __name__ == "__main__":
    main()
