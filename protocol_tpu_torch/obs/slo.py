"""Declarative SLO engine: objectives evaluated continuously.

The port of ``protocol_tpu/obs/slo.py``; verdicts, burn rates and the
evaluation document are the reference's.  Metrics make a failure
*visible*; an objective makes one *binding*: a registry of service-level
objectives — each a name, a value source over the metrics registry, a
target, and a direction — evaluated continuously (every epoch tick and
every ``GET /slo`` scrape).  Each evaluation updates:

- ``eigentrust_slo_ok{objective}`` (1/0 verdict),
- ``eigentrust_slo_burn_rate{objective}`` (fraction of the recent
  evaluation window spent violating — the paging signal: a transient
  blip burns little, a sustained regression burns toward 1),
- ``eigentrust_slo_violations_total{objective}`` on every
  ok→violating transition, with the transition journaled to the
  flight recorder (value, target, burn state) so a post-mortem shows
  *when* the objective went red, not just that it is.

The default objective set covers the fleet-plane headline and the
convergence-health invariants (residual-stall gets its footing from
the Absolute Trust convergence analysis, arXiv:1603.00589 — a
well-posed trust operator contracts, so a rising residual trajectory
means the operator changed under the iteration):

- ``freshness-p99``: end-to-end attestation→proven-score p99,
- ``proof-lag-p99``: submit→proved p99 of the async proving plane,
- ``epoch-cadence``: wall seconds since the last landed tick,
- ``shed-rate``: fraction of admission traffic shed with 429,
- ``residual-stall``: count of non-monotone convergence trajectories.

``seed_violation`` registers an objective that cannot pass, so a gate
built on ``evaluate()["ok"]`` can be shown to fail.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field as dc_field
from typing import Any, Callable

from . import metrics as _metrics
from .journal import JOURNAL
from .timeline import TIMELINE

#: Objective directions: the measured value must stay at-or-under
#: (``max``) or at-or-over (``min``) the target.
MAX = "max"
MIN = "min"


@dataclass(frozen=True)
class SLObjective:
    """One declarative objective.

    ``value_fn`` reads current state (metrics registry, timeline) and
    returns the measured value — or None for "no data yet", which
    counts as meeting the objective (a node that has never ingested
    traffic is not violating its shed-rate SLO)."""

    name: str
    description: str
    target: float
    value_fn: Callable[[], float | None]
    direction: str = MAX
    #: Evaluations kept for the burn-rate window.
    window: int = 60
    #: Measurement unit, for the /slo surface.
    unit: str = ""

    def ok(self, value: float | None) -> bool:
        if value is None:
            return True
        if self.direction == MIN:
            return value >= self.target
        return value <= self.target


@dataclass
class _State:
    objective: SLObjective
    history: collections.deque = dc_field(
        default_factory=lambda: collections.deque(maxlen=60)
    )
    ok: bool = True
    last_value: float | None = None
    last_eval_unix: float | None = None

    def __post_init__(self) -> None:
        self.history = collections.deque(maxlen=self.objective.window)


class SLOEngine:
    """Objective registry + evaluator (see module doc)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._states: dict[str, _State] = {}

    # -- registry ----------------------------------------------------------

    def register(self, objective: SLObjective) -> SLObjective:
        """Install (or replace) one objective; its burn window resets."""
        with self._lock:
            self._states[objective.name] = _State(objective)
        return objective

    def unregister(self, name: str) -> None:
        with self._lock:
            self._states.pop(name, None)

    def objectives(self) -> list[str]:
        with self._lock:
            return sorted(self._states)

    def reset(self) -> None:
        with self._lock:
            self._states.clear()

    # -- evaluation --------------------------------------------------------

    def evaluate(self) -> dict[str, Any]:
        """Evaluate every objective now; returns the /slo document.
        Transitions to violating are counted and journaled; gauges
        update on every evaluation."""
        with self._lock:
            states = list(self._states.values())
        results: dict[str, Any] = {}
        all_ok = True
        for state in states:
            obj = state.objective
            try:
                value = obj.value_fn()
            except Exception:  # noqa: BLE001 - observability never throws
                value = None
            ok = obj.ok(value)
            with self._lock:
                was_ok = state.ok
                state.ok = ok
                state.last_value = value
                state.last_eval_unix = time.time()
                state.history.append(0 if ok else 1)
                burn = sum(state.history) / max(len(state.history), 1)
            _metrics.SLO_OK.set(1.0 if ok else 0.0, objective=obj.name)
            _metrics.SLO_BURN_RATE.set(burn, objective=obj.name)
            if was_ok and not ok:
                _metrics.SLO_VIOLATIONS.inc(objective=obj.name)
                JOURNAL.record(
                    "slo-violation",
                    objective=obj.name,
                    value=value,
                    target=obj.target,
                    direction=obj.direction,
                    burn_rate=round(burn, 4),
                )
            elif not was_ok and ok:
                JOURNAL.record(
                    "slo-recovered", objective=obj.name, value=value
                )
            all_ok = all_ok and ok
            results[obj.name] = {
                "description": obj.description,
                "target": obj.target,
                "direction": obj.direction,
                "unit": obj.unit,
                "value": value,
                "ok": ok,
                "burn_rate": round(burn, 4),
                "window": obj.window,
                "evaluations": len(state.history),
            }
        return {"ok": all_ok, "objectives": results}

    def last(self) -> dict[str, Any]:
        """The last verdicts without re-evaluating (tests/cheap reads)."""
        with self._lock:
            return {
                "ok": all(s.ok for s in self._states.values()),
                "objectives": {
                    name: {
                        "ok": s.ok,
                        "value": s.last_value,
                        "target": s.objective.target,
                    }
                    for name, s in sorted(self._states.items())
                },
            }


# ---------------------------------------------------------------------------
# Default objective set
# ---------------------------------------------------------------------------


def _freshness_p99() -> float | None:
    return _metrics.FRESHNESS_SECONDS.quantile(0.99, stage="proof_landed")


def _proof_lag_p99() -> float | None:
    return _metrics.PROOF_LAG_SECONDS.quantile(0.99)


def _shed_rate() -> float | None:
    shed = sum(v for _, v in _metrics.INGEST_SHED.samples())
    accepted = _metrics.ATTESTATIONS_ACCEPTED.value()
    rejected = sum(v for _, v in _metrics.ATTESTATIONS_REJECTED.samples())
    total = shed + accepted + rejected
    if total <= 0:
        return None
    return shed / total


def _residual_stalls() -> float | None:
    return _metrics.RESIDUAL_STALLS.value()


def _score_drift_linf() -> float | None:
    # 0.0 before any epoch pair — that reads as "no drift", which is
    # correct (nothing has moved).
    return _metrics.SCORE_DRIFT_LINF.value()


def default_objectives(
    *,
    epoch_interval_s: float = 10.0,
    freshness_p99_s: float = 120.0,
    proof_lag_p99_s: float = 60.0,
    shed_rate_max: float = 0.01,
    cadence_factor: float = 3.0,
    drift_linf_max: float = 0.5,
) -> list[SLObjective]:
    """The node's standing objectives, parameterized by the deployment
    cadence.  ``install_defaults`` registers them on the global
    engine."""
    return [
        SLObjective(
            name="freshness-p99",
            description=(
                "p99 end-to-end freshness: attestation accepted -> its "
                "effect in a proven, servable score"
            ),
            target=float(freshness_p99_s),
            value_fn=_freshness_p99,
            unit="seconds",
        ),
        SLObjective(
            name="proof-lag-p99",
            description="p99 submit-to-proved lag of the async proving plane",
            target=float(proof_lag_p99_s),
            value_fn=_proof_lag_p99,
            unit="seconds",
        ),
        SLObjective(
            name="epoch-cadence",
            description=(
                "wall seconds since the last landed epoch tick (a stuck "
                "epoch loop violates within a few intervals)"
            ),
            target=float(cadence_factor) * float(epoch_interval_s),
            value_fn=TIMELINE.seconds_since_last_tick,
            unit="seconds",
        ),
        SLObjective(
            name="shed-rate",
            description=(
                "fraction of admission traffic shed with 429 "
                "(queue-full backpressure)"
            ),
            target=float(shed_rate_max),
            value_fn=_shed_rate,
            unit="fraction",
        ),
        SLObjective(
            name="residual-stall",
            description=(
                "epochs whose residual trajectory was non-monotone "
                "(convergence-health invariant: a contracting trust "
                "operator never raises its residual, arXiv:1603.00589)"
            ),
            target=0.0,
            value_fn=_residual_stalls,
            unit="count",
        ),
        SLObjective(
            name="score-drift-linf",
            description=(
                "L-infinity drift between consecutive fixed points "
                "(a whole-score jump means the graph — or a bug — "
                "moved someone's trust mass wholesale)"
            ),
            target=float(drift_linf_max),
            value_fn=_score_drift_linf,
            unit="score",
        ),
    ]


def install_defaults(engine: "SLOEngine | None" = None, **kwargs: Any) -> None:
    """Register the default objective set (node boot / tools)."""
    engine = engine if engine is not None else SLO_ENGINE
    for objective in default_objectives(**kwargs):
        engine.register(objective)


# ---------------------------------------------------------------------------
# Pod objective set (multi-host runs only — a single-host node must not
# carry objectives over signals it can never produce)
# ---------------------------------------------------------------------------


def _pod_phase_skew_p99() -> float | None:
    """Worst per-phase skew p99 across the four stitched epoch phases
    (None until the first stitch feeds the histogram)."""
    from .podtrace import SKEW_PHASES

    values = [
        _metrics.POD_PHASE_SKEW_SECONDS.quantile(0.99, phase=phase)
        for phase in SKEW_PHASES
    ]
    values = [v for v in values if v is not None]
    return max(values) if values else None


def _pod_stitch_missing() -> float | None:
    """Hosts missing from the newest stitched pod trace (None before
    any stitch)."""
    from .podtrace import POD_TRACES

    missing = POD_TRACES.last_missing_hosts()
    return None if missing is None else float(missing)


def _fleet_heartbeat_age() -> float | None:
    """Age of the *stalest* fleet snapshot currently merged — per-host
    heartbeat freshness (None with no sources; already-evicted stale
    sources surface through the stale-sources gauge and /healthz)."""
    from .fleet import FLEET

    now = time.time()
    ages = [
        now - float(snap["taken_unix"])
        for snap in FLEET.snapshots().values()
        if isinstance(snap.get("taken_unix"), (int, float))
    ]
    return max(ages) if ages else None


def pod_objectives(
    *,
    phase_skew_p99_s: float = 1.0,
    heartbeat_max_age_s: float = 30.0,
) -> list[SLObjective]:
    """The pod-level objectives: skew, stitch
    completeness, heartbeat freshness.  ``install_pod_defaults``
    registers them alongside (not instead of) the node defaults."""
    return [
        SLObjective(
            name="pod-phase-skew-p99",
            description=(
                "p99 of the per-phase pod skew (max - median host "
                "duration, worst phase of plan/converge/checkpoint/"
                "wal_flush) — a straggling host burns the whole pod's "
                "collective time"
            ),
            target=float(phase_skew_p99_s),
            value_fn=_pod_phase_skew_p99,
            unit="seconds",
        ),
        SLObjective(
            name="pod-stitch-completeness",
            description=(
                "hosts missing from the newest stitched pod epoch "
                "trace — every live host must publish its span tree"
            ),
            target=0.0,
            value_fn=_pod_stitch_missing,
            unit="hosts",
        ),
        SLObjective(
            name="pod-heartbeat-freshness",
            description=(
                "age of the stalest per-host metric snapshot in the "
                "fleet exchange — a silently dead host violates here "
                "before any gloo collective hangs on it"
            ),
            target=float(heartbeat_max_age_s),
            value_fn=_fleet_heartbeat_age,
            unit="seconds",
        ),
    ]


def install_pod_defaults(
    engine: "SLOEngine | None" = None, **kwargs: Any
) -> None:
    """Register the pod objective set (multi-host boot / pod dryrun)."""
    engine = engine if engine is not None else SLO_ENGINE
    for objective in pod_objectives(**kwargs):
        engine.register(objective)


def seed_violation(engine: "SLOEngine | None" = None) -> SLObjective:
    """Register an objective that cannot pass — the CI self-check that
    a violating objective actually fails the dryrun gate."""
    engine = engine if engine is not None else SLO_ENGINE
    return engine.register(
        SLObjective(
            name="seeded-violation",
            description=(
                "CI self-check: always-violating objective proving the "
                "SLO gate can fail"
            ),
            target=-1.0,
            value_fn=lambda: 0.0,
            unit="count",
        )
    )


#: Process-global engine (the node's /slo source).  Empty until the
#: node (or a tool/test) installs objectives — a bare library import
#: must not impose deployment targets.
SLO_ENGINE = SLOEngine()


__all__ = [
    "MAX",
    "MIN",
    "SLOEngine",
    "SLObjective",
    "SLO_ENGINE",
    "default_objectives",
    "install_defaults",
    "install_pod_defaults",
    "pod_objectives",
    "seed_violation",
]
