"""Thread-safe metrics registry: counters, gauges, histograms.

The node's scrapeable state (``GET /metrics``), recorded from executor
threads (epoch ticks), the asyncio event loop (ingest), and read by
concurrent HTTP scrapes — one registry lock serializes every mutation
and snapshot, and all record calls are O(labels) dict work, so nothing
here belongs anywhere near a device loop.

Metric shapes follow the Prometheus data model so
the Prometheus exporter renders them without
translation: counters are monotonic (``_total`` names), gauges are
set-to-current, histograms are cumulative-bucket with ``_sum`` and
``_count`` series.  The per-iteration convergence residuals — written
on the device each step and fetched once after convergence — land in :data:`CONVERGENCE_RESIDUAL`, whose per-epoch
observation count therefore equals the iteration count.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Iterable

LabelValues = tuple[str, ...]


class Metric:
    """Base: name, help text, label names, per-labelset values."""

    kind = "untyped"

    def __init__(
        self,
        name: str,
        help_text: str,
        labelnames: tuple[str, ...],
        lock: threading.Lock,
    ):
        self.name = name
        self.help = help_text
        self.labelnames = labelnames
        self._lock = lock

    def _label_key(self, labels: dict[str, Any]) -> LabelValues:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}"
            )
        return tuple(str(labels[k]) for k in self.labelnames)

    def samples(self) -> list[tuple[LabelValues, float]]:
        raise NotImplementedError

    def to_dict(self) -> dict[str, Any]:
        raise NotImplementedError


class Counter(Metric):
    """Monotonic counter, optionally labelled (e.g. rejection reason)."""

    kind = "counter"

    def __init__(self, name, help_text, labelnames, lock):
        super().__init__(name, help_text, labelnames, lock)
        self._values: dict[LabelValues, float] = {}

    def inc(self, n: float = 1, **labels: Any) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (n={n})")
        key = self._label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def value(self, **labels: Any) -> float:
        key = self._label_key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def samples(self):
        with self._lock:
            return sorted(self._values.items())

    def to_dict(self):
        with self._lock:
            if not self.labelnames:
                return {"value": self._values.get((), 0.0)}
            return {
                "values": {
                    ",".join(k): v for k, v in sorted(self._values.items())
                }
            }


class Gauge(Metric):
    """Set-to-current value (iterations of the last epoch, graph size)."""

    kind = "gauge"

    def __init__(self, name, help_text, labelnames, lock):
        super().__init__(name, help_text, labelnames, lock)
        self._values: dict[LabelValues, float] = {}

    def set(self, value: float, **labels: Any) -> None:
        key = self._label_key(labels)
        with self._lock:
            self._values[key] = float(value)

    def value(self, **labels: Any) -> float:
        key = self._label_key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def samples(self):
        with self._lock:
            return sorted(self._values.items())

    def to_dict(self):
        return Counter.to_dict(self)  # same shape


class _HistState:
    __slots__ = ("bucket_counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.bucket_counts = [0] * n_buckets
        self.sum = 0.0
        self.count = 0


class Histogram(Metric):
    """Cumulative-bucket histogram (Prometheus semantics): ``observe``
    increments every bucket whose upper bound is >= the value, plus
    ``_sum``/``_count``."""

    kind = "histogram"

    def __init__(self, name, help_text, labelnames, lock, buckets: Iterable[float]):
        super().__init__(name, help_text, labelnames, lock)
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError(f"{self.name}: histogram needs buckets")
        if bounds[-1] != math.inf:
            bounds.append(math.inf)
        self.bucket_bounds: tuple[float, ...] = tuple(bounds)
        self._states: dict[LabelValues, _HistState] = {}

    def observe(self, value: float, **labels: Any) -> None:
        value = float(value)
        key = self._label_key(labels)
        with self._lock:
            state = self._states.get(key)
            if state is None:
                state = self._states[key] = _HistState(len(self.bucket_bounds))
            for i, bound in enumerate(self.bucket_bounds):
                if value <= bound:
                    state.bucket_counts[i] += 1
            state.sum += value
            state.count += 1

    def count(self, **labels: Any) -> int:
        key = self._label_key(labels)
        with self._lock:
            state = self._states.get(key)
            return state.count if state is not None else 0

    def quantile(self, q: float, **labels: Any) -> float | None:
        """Estimate the q-quantile (0 < q <= 1) from the cumulative
        buckets — linear interpolation inside the covering bucket, the
        standard Prometheus ``histogram_quantile`` shape.  Returns None
        with no observations; values past the last finite bound clamp
        to it (the +Inf bucket has no interpolable width)."""
        key = self._label_key(labels)
        with self._lock:
            state = self._states.get(key)
            if state is None or state.count == 0:
                return None
            counts = list(state.bucket_counts)
            total = state.count
        rank = q * total
        prev_bound, prev_count = 0.0, 0
        for bound, cum in zip(self.bucket_bounds, counts):
            if cum >= rank:
                if bound == math.inf:
                    # No width to interpolate over: the best estimate
                    # is the largest finite bound.
                    return self.bucket_bounds[-2]
                width = cum - prev_count
                if width <= 0:
                    return bound
                return prev_bound + (bound - prev_bound) * (rank - prev_count) / width
            prev_bound, prev_count = bound, cum
        return self.bucket_bounds[-2]

    def snapshot(self) -> dict[LabelValues, dict[str, Any]]:
        with self._lock:
            return {
                k: {
                    "buckets": list(s.bucket_counts),
                    "sum": s.sum,
                    "count": s.count,
                }
                for k, s in sorted(self._states.items())
            }

    def samples(self):  # _count series, for uniform JSON summaries
        with self._lock:
            return sorted((k, float(s.count)) for k, s in self._states.items())

    def to_dict(self):
        return {
            "buckets": [b if b != math.inf else "+Inf" for b in self.bucket_bounds],
            "values": {",".join(k): v for k, v in self.snapshot().items()},
        }


class MetricsRegistry:
    """Registry with idempotent constructors: calling ``counter(name)``
    twice returns the same instance (so instrumented modules don't need
    import-order coordination), but re-registering a name as a
    different kind is an error."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}

    def _register(self, cls, name: str, help_text: str, labelnames, **kw) -> Any:
        labelnames = tuple(labelnames)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or existing.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}{existing.labelnames}"
                    )
                return existing
            metric = cls(name, help_text, labelnames, self._lock, **kw)
            self._metrics[name] = metric
            return metric

    def counter(
        self, name: str, help_text: str = "", labelnames: Iterable[str] = ()
    ) -> Counter:
        return self._register(Counter, name, help_text, labelnames)

    def gauge(
        self, name: str, help_text: str = "", labelnames: Iterable[str] = ()
    ) -> Gauge:
        return self._register(Gauge, name, help_text, labelnames)

    def histogram(
        self,
        name: str,
        help_text: str = "",
        labelnames: Iterable[str] = (),
        buckets: Iterable[float] = (),
    ) -> Histogram:
        return self._register(
            Histogram, name, help_text, labelnames, buckets=buckets or TIME_BUCKETS
        )

    def collect(self) -> list[Metric]:
        with self._lock:
            return list(self._metrics.values())

    def reset(self) -> None:
        """Zero every metric (tests).  Registrations survive — only the
        recorded values clear."""
        for metric in self.collect():
            with self._lock:
                if isinstance(metric, Histogram):
                    metric._states.clear()
                else:
                    metric._values.clear()  # type: ignore[attr-defined]


#: Span/phase durations in seconds (node epoch phases, sig-verify, ...).
TIME_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
#: Convergence residuals: log-spaced around typical tol values.
RESIDUAL_BUCKETS = (
    1e-9, 1e-8, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0,
)
#: End-to-end freshness (attestation accepted -> proven servable
#: score): sub-second ingest hops up through multi-epoch proof lag.
FRESHNESS_BUCKETS = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 20.0,
    30.0, 60.0, 120.0, 300.0, 600.0,
)

#: Process-global registry (the node's /metrics source).
METRICS = MetricsRegistry()

# -- the node's metric catalog (README "Observability") ---------------------

ATTESTATIONS_ACCEPTED = METRICS.counter(
    "eigentrust_attestations_accepted_total",
    "Attestations that passed structural + signature checks",
)
ATTESTATIONS_REJECTED = METRICS.counter(
    "eigentrust_attestations_rejected_total",
    "Attestations rejected at ingest, by reason",
    labelnames=("reason",),
)
SIGS_VERIFIED = METRICS.counter(
    "eigentrust_signatures_verified_total",
    "EdDSA signatures checked (accepted or not)",
)
SIG_VERIFY_SECONDS = METRICS.histogram(
    "eigentrust_sig_verify_seconds",
    "Wall-clock of signature verification calls (batched or single)",
    buckets=TIME_BUCKETS,
)
CONVERGENCE_ITERATIONS = METRICS.gauge(
    "eigentrust_convergence_iterations",
    "Power iterations the last open-graph convergence took",
)
CONVERGENCE_RESIDUAL = METRICS.histogram(
    "eigentrust_convergence_residual",
    "Per-iteration L1 residuals, captured device-side in the loop "
    "carry and fetched once after convergence",
    buckets=RESIDUAL_BUCKETS,
)
LAST_RESIDUAL = METRICS.gauge(
    "eigentrust_last_residual",
    "Final L1 residual of the last open-graph convergence",
)
GRAPH_PEERS = METRICS.gauge(
    "eigentrust_graph_peers", "Peers in the last assembled trust graph"
)
GRAPH_EDGES = METRICS.gauge(
    "eigentrust_graph_edges", "Edges in the last assembled trust graph"
)
EPOCHS_TOTAL = METRICS.counter(
    "eigentrust_epochs_total", "Epoch ticks completed"
)
EPOCH_TICKS_DROPPED = METRICS.counter(
    "eigentrust_epoch_ticks_dropped_total",
    "Epoch boundaries skipped because the previous tick overran "
    "(Skip missed-tick semantics)",
)
CHECKPOINT_SAVES = METRICS.counter(
    "eigentrust_checkpoint_saves_total", "Checkpoint snapshots written"
)
CHECKPOINT_RESTORES = METRICS.counter(
    "eigentrust_checkpoint_restores_total", "Checkpoint snapshots loaded"
)
PLAN_REBUILDS = METRICS.counter(
    "eigentrust_window_plan_rebuilds_total",
    "WindowPlan constructions (cold, fingerprint miss, or stale layout)",
)
PLAN_REUSES = METRICS.counter(
    "eigentrust_window_plan_reuses_total",
    "Converges that reused a cached/restored WindowPlan",
)
PLAN_OUTCOMES = METRICS.counter(
    "eigentrust_window_plan_outcomes_total",
    "Per-converge WindowPlan resolution by outcome: reuse (fingerprint "
    "hit), delta (churn folded in via apply_delta), rebuild (full "
    "host construction)",
    labelnames=("outcome",),
)
EPOCH_TICKS_COALESCED = METRICS.counter(
    "eigentrust_epoch_ticks_coalesced_total",
    "Epoch ticks superseded by a newer one while waiting in the "
    "pipeline queue (backpressure: a slow device stage coalesces "
    "pending epochs into the latest instead of dropping them)",
)
PIPELINE_QUEUE_DEPTH = METRICS.gauge(
    "eigentrust_pipeline_queue_depth",
    "Prepared epochs waiting for the device stage (bounded queue)",
)
WARM_START_APPLIED = METRICS.counter(
    "eigentrust_warm_start_applied_total",
    "Epoch convergences seeded from the previous epoch's fixed point",
)
PHASE_SECONDS = METRICS.histogram(
    "eigentrust_phase_seconds",
    "Span durations by phase name (every closed obs span lands here)",
    labelnames=("phase",),
    buckets=TIME_BUCKETS,
)
JIT_RECOMPILES = METRICS.counter(
    "eigentrust_jit_recompiles_total",
    "Kernel libraries built or loaded during a converge, by library "
    "(ops/_build.py) — a steady-state delta epoch that builds one broke "
    "the warm-process guarantee",
    labelnames=("fn",),
)
SCORE_DRIFT_L1 = METRICS.gauge(
    "eigentrust_score_drift_l1",
    "L1 distance between consecutive epochs' fixed points (surviving "
    "peers aligned by hash)",
)
SCORE_DRIFT_LINF = METRICS.gauge(
    "eigentrust_score_drift_linf",
    "L-infinity distance between consecutive epochs' fixed points",
)
RESIDUAL_STALLS = METRICS.counter(
    "eigentrust_residual_stalls_total",
    "Epochs whose residual trajectory was non-monotone past the "
    "stall threshold (convergence health anomaly)",
)
DEVICE_MEMORY_DELTA = METRICS.gauge(
    "eigentrust_device_memory_delta_bytes",
    "bytes_in_use growth across the last closed span, by phase "
    "(memory_stats watermark watcher; absent on platforms without "
    "allocator stats)",
    labelnames=("phase",),
)
CONVERGE_PEAK_BYTES = METRICS.gauge(
    "eigentrust_converge_peak_bytes",
    "Peak device bytes across the converge phase, by backend: the "
    "memory_stats watermark where the platform reports allocator "
    "stats, else the compiled executable's buffer-assignment peak "
    "(the static view, recorded by tools/mem_probe "
    "and the watermark watcher)",
    labelnames=("backend",),
)
JOURNAL_EVENTS = METRICS.counter(
    "eigentrust_journal_events_total",
    "Flight-recorder events recorded, by kind",
    labelnames=("kind",),
)
JOURNAL_DROPPED = METRICS.counter(
    "eigentrust_journal_dropped_total",
    "Flight-recorder events evicted from the bounded ring before "
    "reaching disk (journal backpressure)",
)
INGEST_QUEUE_DEPTH = METRICS.gauge(
    "eigentrust_ingest_queue_depth",
    "Envelopes (stage=submit) or verify batches (stage=verify) waiting "
    "between admission-plane stages (bounded queues; depth at the bound "
    "means the next submit sheds)",
    labelnames=("stage",),
)
INGEST_SHED = METRICS.counter(
    "eigentrust_ingest_shed_total",
    "Submissions shed by admission-plane backpressure, by stage (a full "
    "submit queue answers 429 instead of queueing unboundedly)",
    labelnames=("stage",),
)
INGEST_ADMISSION_SECONDS = METRICS.histogram(
    "eigentrust_ingest_admission_seconds",
    "Wall-clock from admission-plane submit to the per-item verdict "
    "(accept or reject), the ingest-storm p99 headline",
    buckets=TIME_BUCKETS,
)
INGEST_VERIFY_BATCHES = METRICS.counter(
    "eigentrust_ingest_verify_batches_total",
    "Verify-worker batches by outcome: ok (completed), retried "
    "(resubmitted after a worker crash), failed (rejected with "
    "reason=verify-crashed after retries)",
    labelnames=("outcome",),
)
INGEST_WORKER_RESTARTS = METRICS.counter(
    "eigentrust_ingest_worker_restarts_total",
    "Verify worker-pool rebuilds after a worker process died",
)
PROOF_LAG_EPOCHS = METRICS.gauge(
    "eigentrust_proof_lag_epochs",
    "Newest submitted epoch minus newest proved epoch in the async "
    "proving plane — 0 when proving keeps up with the epoch cadence, "
    "growing when the prover falls behind (the decoupling's health "
    "headline: a slow prover is lag here, never epoch latency)",
)
PROOF_QUEUE_DEPTH = METRICS.gauge(
    "eigentrust_proof_queue_depth",
    "Proof jobs waiting between an epoch tick's enqueue and a prover "
    "dispatcher (bounded; at the bound the oldest queued job is "
    "superseded, latest-wins)",
)
PROVE_SECONDS = METRICS.histogram(
    "eigentrust_prove_seconds",
    "Wall-clock of one epoch proof (power_iterate + circuit check + "
    "SNARK) inside a prover worker",
    buckets=TIME_BUCKETS,
)
PROOFS_COMPLETED = METRICS.counter(
    "eigentrust_proofs_completed_total",
    "Proof jobs that reached state=proved (proof installed and served)",
)
PROOFS_FAILED = METRICS.counter(
    "eigentrust_proofs_failed_total",
    "Proof jobs that reached state=failed (prover crashed or timed "
    "out past its retries; reason=prover-crashed)",
)
PROOFS_SUPERSEDED = METRICS.counter(
    "eigentrust_proofs_superseded_total",
    "Queued proof jobs displaced by a newer epoch under proving-plane "
    "backpressure (latest-wins coalescing; explicit, never a silent "
    "drop)",
)
PROVER_WORKER_RESTARTS = METRICS.counter(
    "eigentrust_prover_worker_restarts_total",
    "Prover worker-pool rebuilds after a worker process died or hung "
    "past the per-job timeout",
)
FRESHNESS_SECONDS = METRICS.histogram(
    "eigentrust_freshness_seconds",
    "Elapsed wall-clock since intake for each lineage-sampled "
    "attestation at every hop of its life (stage label: admitted, "
    "verified, applied, included, converged, proof_landed) — "
    "stage=proof_landed is the end-to-end freshness headline: how long "
    "from POST /attestation to its effect in a proven, servable score",
    labelnames=("stage",),
    buckets=FRESHNESS_BUCKETS,
)
LINEAGE_SAMPLED = METRICS.counter(
    "eigentrust_lineage_sampled_total",
    "Attestations that drew a lineage ID at intake (the sampled "
    "fraction; unsampled submissions pay zero tracker state)",
)
LINEAGE_COMPLETED = METRICS.counter(
    "eigentrust_lineage_completed_total",
    "Lineage-sampled attestations that reached proof_landed (their "
    "including epoch's SNARK is served)",
)
LINEAGE_DROPPED = METRICS.counter(
    "eigentrust_lineage_dropped_total",
    "Lineage entries abandoned before proof_landed, by reason: "
    "rejected (the attestation failed admission/verify), evicted "
    "(tracker capacity), shutdown",
    labelnames=("reason",),
)
PROOF_LAG_SECONDS = METRICS.histogram(
    "eigentrust_proof_lag_seconds",
    "Submit-to-proved wall-clock per proof job (the per-job component "
    "of the proof-lag headline; the SLO engine gates its p99)",
    buckets=FRESHNESS_BUCKETS,
)
SLO_OK = METRICS.gauge(
    "eigentrust_slo_ok",
    "Per-objective SLO verdict at the last evaluation: 1 = meeting "
    "the objective (or no data yet), 0 = violating",
    labelnames=("objective",),
)
SLO_BURN_RATE = METRICS.gauge(
    "eigentrust_slo_burn_rate",
    "Fraction of the objective's recent evaluation window spent in "
    "violation (0 = healthy, 1 = burning the whole window)",
    labelnames=("objective",),
)
SLO_VIOLATIONS = METRICS.counter(
    "eigentrust_slo_violations_total",
    "ok->violating transitions per objective (each one is journaled "
    "with the violating value)",
    labelnames=("objective",),
)
HEALTH_STATUS = METRICS.gauge(
    "eigentrust_health_status",
    "GET /healthz verdict as a number: 0 = ok, 1 = degraded, "
    "2 = failed (load balancers read the HTTP status instead)",
)
FLEET_SOURCES = METRICS.gauge(
    "eigentrust_fleet_sources",
    "Worker/process metric snapshots currently merged into the fleet "
    "scrape (GET /metrics/fleet), beyond the node process itself",
)
WORKER_SNAPSHOT_MERGES = METRICS.counter(
    "eigentrust_worker_metric_merges_total",
    "Per-worker metric snapshots shipped back across the spawn "
    "boundary and merged into the fleet aggregator, by pool",
    labelnames=("pool",),
)
WAL_APPENDED = METRICS.counter(
    "eigentrust_wal_appended_total",
    "Attestation records appended to the write-ahead log (every "
    "accepted attestation lands here before its ingest verdict "
    "returns — the crash-consistency boundary, node/wal.py)",
)
WAL_REPLAYED = METRICS.counter(
    "eigentrust_wal_replayed_total",
    "WAL records re-applied through the apply_verified fast path "
    "during boot recovery (the tail past the newest valid "
    "checkpoint's wal_seq watermark)",
)
CHECKPOINT_FALLBACKS = METRICS.counter(
    "eigentrust_checkpoint_fallbacks_total",
    "Snapshots skipped during load because they were torn, corrupt "
    "(per-column sha256 mismatch), or unreadable — recovery fell back "
    "to the previous epoch (journaled with the failure)",
)
RECOVERY_SECONDS = METRICS.gauge(
    "eigentrust_recovery_seconds",
    "Wall-clock of the last boot recovery (checkpoint load + warm "
    "state restore + WAL tail replay); /healthz reports component "
    "state recovering while this is in progress",
)
RPC_RETRIES = METRICS.counter(
    "eigentrust_rpc_retries_total",
    "Chain RPC calls retried by the event-stream retry wall "
    "(exponential backoff + jitter + per-call timeout), by operation",
    labelnames=("op",),
)
POD_HOSTS = METRICS.gauge(
    "eigentrust_pod_hosts",
    "Hosts (processes) in this node's pod — 1 on a "
    "single-host deployment; the peer→host rendezvous partition "
    "(parallel/partition.py) is keyed on this count",
)
POD_HOST_ID = METRICS.gauge(
    "eigentrust_pod_host_id",
    "This process's host id inside the pod's rendezvous partition",
)
POD_OWNED_PEERS = METRICS.gauge(
    "eigentrust_pod_owned_peers",
    "Peers whose out-edges (and WAL/checkpoint shard rows) this host "
    "owns under the pod partition — tracks n/n_hosts when the "
    "rendezvous hash is balanced",
)
POD_LOCAL_EDGES = METRICS.gauge(
    "eigentrust_pod_local_edges",
    "Edges in this host's partition (source peer owned here) — the "
    "host's plan-build and WAL-volume source; the pod total is the "
    "graph's edge count",
)
POD_PLAN_BUILD_SECONDS = METRICS.gauge(
    "eigentrust_pod_plan_build_seconds",
    "Wall-clock of this host's last LOCAL window-plan resolution "
    "(delta or rebuild over owned edges only; 0 on verbatim reuse) — "
    "the pod's plan-build critical path is the max across hosts, vs "
    "the serial full-graph build it replaces",
)
POD_PLAN_REUSED = METRICS.counter(
    "eigentrust_pod_plan_reused_total",
    "Epochs whose churn was entirely owned by other hosts, so this "
    "host revalidated its local fingerprint and reused its plan "
    "verbatim — the partition-locality win, by outcome "
    "(reuse/delta/rebuild)",
    labelnames=("outcome",),
)
POD_EPOCH_SECONDS = METRICS.gauge(
    "eigentrust_pod_epoch_seconds",
    "Steady-state wall-clock of the last pod epoch (plan resolution + "
    "sharded converge + durability stamp) as this host measured it — "
    "the flat-vs-single-host headline series",
)
POD_MANIFESTS_SEALED = METRICS.counter(
    "eigentrust_pod_manifests_sealed_total",
    "Pod manifests sealed by this host (sealer role only): epochs "
    "whose complete per-host shard stamp set was atomically bound "
    "into pod_manifest_e<N>.json (node/pod.py)",
)
POD_PHASE_SKEW_SECONDS = METRICS.histogram(
    "eigentrust_pod_phase_skew_seconds",
    "Per-phase pod skew: max minus median host duration for one "
    "stitched pod epoch phase (plan/converge/checkpoint/wal_flush), "
    "observed by the stitching host (obs/podtrace.py) — the "
    "straggler-attribution signal behind the pod-phase-skew-p99 SLO",
    labelnames=("phase",),
    buckets=TIME_BUCKETS,
)
POD_BARRIER_WAIT_SECONDS = METRICS.gauge(
    "eigentrust_pod_barrier_wait_seconds",
    "Pre-collective barrier-arrival spread of the last stitched pod "
    "epoch: latest minus earliest host arrival at the plan "
    "dimension-agreement allgather (clock-aligned across hosts) — a "
    "fast host pays exactly this long waiting inside the collective",
)
POD_STITCH_SECONDS = METRICS.gauge(
    "eigentrust_pod_stitch_seconds",
    "Wall-clock the stitching host spent aligning clocks and merging "
    "the per-host span trees of the last pod epoch trace "
    "(GET /trace/pod) — obs-plane overhead, budgeted <1% of the epoch",
)
POD_STRAGGLER = METRICS.gauge(
    "eigentrust_pod_straggler",
    "1 while the StragglerWatcher flags this host: its phase time "
    "exceeded the pod median by the configured ratio for k consecutive "
    "epochs (journaled as an anomaly on the flagging transition)",
    labelnames=("host",),
)
FLEET_STALE_SOURCES = METRICS.gauge(
    "eigentrust_fleet_stale_sources",
    "Fleet snapshot sources evicted from the merged scrape because "
    "their newest snapshot aged past the staleness TTL — a silently "
    "dead pod host shows up here (and degrades /healthz) before any "
    "collective hangs on it",
)
LOCK_WAIT_SECONDS = METRICS.histogram(
    "eigentrust_lock_wait_seconds",
    "Lock-acquisition wait time by allocation site — recorded only "
    "under the opt-in lock-witness debug mode "
    "(analysis/concurrency/witness.py); absent on a production node",
    labelnames=("site",),
    buckets=(1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0),
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "METRICS",
    "Metric",
    "MetricsRegistry",
    "FRESHNESS_BUCKETS",
    "RESIDUAL_BUCKETS",
    "TIME_BUCKETS",
    "ATTESTATIONS_ACCEPTED",
    "ATTESTATIONS_REJECTED",
    "SIGS_VERIFIED",
    "SIG_VERIFY_SECONDS",
    "CONVERGENCE_ITERATIONS",
    "CONVERGENCE_RESIDUAL",
    "LAST_RESIDUAL",
    "GRAPH_PEERS",
    "GRAPH_EDGES",
    "EPOCHS_TOTAL",
    "EPOCH_TICKS_DROPPED",
    "CHECKPOINT_SAVES",
    "CHECKPOINT_RESTORES",
    "PLAN_REBUILDS",
    "PLAN_REUSES",
    "PLAN_OUTCOMES",
    "EPOCH_TICKS_COALESCED",
    "PIPELINE_QUEUE_DEPTH",
    "WARM_START_APPLIED",
    "PHASE_SECONDS",
    "JIT_RECOMPILES",
    "SCORE_DRIFT_L1",
    "SCORE_DRIFT_LINF",
    "RESIDUAL_STALLS",
    "DEVICE_MEMORY_DELTA",
    "CONVERGE_PEAK_BYTES",
    "JOURNAL_EVENTS",
    "JOURNAL_DROPPED",
    "INGEST_QUEUE_DEPTH",
    "INGEST_SHED",
    "INGEST_ADMISSION_SECONDS",
    "INGEST_VERIFY_BATCHES",
    "INGEST_WORKER_RESTARTS",
    "PROOF_LAG_EPOCHS",
    "PROOF_QUEUE_DEPTH",
    "PROVE_SECONDS",
    "PROOFS_COMPLETED",
    "PROOFS_FAILED",
    "PROOFS_SUPERSEDED",
    "PROVER_WORKER_RESTARTS",
    "FRESHNESS_SECONDS",
    "LINEAGE_SAMPLED",
    "LINEAGE_COMPLETED",
    "LINEAGE_DROPPED",
    "PROOF_LAG_SECONDS",
    "SLO_OK",
    "SLO_BURN_RATE",
    "SLO_VIOLATIONS",
    "HEALTH_STATUS",
    "FLEET_SOURCES",
    "WORKER_SNAPSHOT_MERGES",
    "WAL_APPENDED",
    "WAL_REPLAYED",
    "CHECKPOINT_FALLBACKS",
    "RECOVERY_SECONDS",
    "RPC_RETRIES",
    "POD_HOSTS",
    "POD_HOST_ID",
    "POD_OWNED_PEERS",
    "POD_LOCAL_EDGES",
    "POD_PLAN_BUILD_SECONDS",
    "POD_PLAN_REUSED",
    "POD_EPOCH_SECONDS",
    "POD_MANIFESTS_SEALED",
    "POD_PHASE_SKEW_SECONDS",
    "POD_BARRIER_WAIT_SECONDS",
    "POD_STITCH_SECONDS",
    "POD_STRAGGLER",
    "FLEET_STALE_SOURCES",
    "LOCK_WAIT_SECONDS",
]
