"""zk.graft — the proving-kernel backend knob and the phase table of the
accelerated prover backend.

The reference package's ``zk.graft`` runs the prover's inner loops
(field multiply, NTT stage, Pippenger MSM) as jit kernels beside the
native runtime.  Those kernels are not ported yet (ROADMAP A8); this
module keeps their call sites: ``zk.kzg.msm``, ``Setup.commit_limbs``,
``Setup.commit_batch`` and ``plonk.Domain``'s NTTs ask :func:`zk_backend`
which engine runs, and ``plonk._ProveAttribution`` folds this table
into the prove's span tree beside the native one.  ``"native"`` works;
selecting ``"graft"`` raises ``NotImplementedError`` naming A8, and
nothing falls back to the native engine in its place.
"""

from __future__ import annotations

import contextlib
import threading

#: Where the graft kernels stand.
NOT_PORTED = "ROADMAP A8 (the prover's graft kernels on Hopper, queue B's B8-B10)"

#: The reference's graft kernels, by their registry names; each still
#: to be written for the card (ROADMAP A8).
ZK_KERNELS = (
    "zk-graft-mulmod",
    "zk-graft-ntt-stage",
    "zk-graft-msm-window",
    "zk-graft-msm-scan",
    "zk-graft-msm-bucket",
)


def registered_zk_kernels() -> list[str]:
    """Kernel names the graft backend will register."""
    return list(ZK_KERNELS)


# ---------------------------------------------------------------------------
# Backend knob
# ---------------------------------------------------------------------------

#: Process-wide default; per-thread overrides via use_zk_backend.
_DEFAULT_BACKEND = "native"
_local = threading.local()

VALID_BACKENDS = ("native", "graft")


def _check(name: str) -> None:
    if name not in VALID_BACKENDS:
        raise ValueError(
            f"unknown zk_backend {name!r}; expected one of {VALID_BACKENDS}"
        )
    if name == "graft":
        raise NotImplementedError(
            f"zk_backend='graft' is not ported to protocol_tpu_torch yet ({NOT_PORTED}); "
            "use zk_backend='native'"
        )


def zk_backend() -> str:
    """The active proving-kernel backend: ``native`` (the ctypes
    runtime with its pure-Python fallback)."""
    return getattr(_local, "backend", _DEFAULT_BACKEND)


def set_zk_backend(name: str) -> None:
    _check(name)
    _local.backend = name


@contextlib.contextmanager
def use_zk_backend(name: str):
    """Scoped backend selection, so a caller never leaks the knob."""
    _check(name)
    prev = getattr(_local, "backend", None)
    _local.backend = name
    try:
        yield
    finally:
        if prev is None:
            del _local.backend
        else:
            _local.backend = prev


# ---------------------------------------------------------------------------
# Phase timers — same table shape as zk.native.phase_stats(), so
# plonk._ProveAttribution folds both engines into the same
# snark -> {msm, ntt, ...} span children.  Nothing bumps it until the
# graft kernels land: its rows stay zero.
# ---------------------------------------------------------------------------

PHASES = ("msm", "ntt", "gate_eval", "field_ops", "srs")

_phase_lock = threading.Lock()
_phase_table: dict[str, dict[str, float]] = {
    p: {"calls": 0, "seconds": 0.0} for p in PHASES
}


def phase_stats() -> dict[str, dict[str, float]]:
    """Snapshot of the graft backend's per-phase host wall time."""
    with _phase_lock:
        return {p: dict(row) for p, row in _phase_table.items()}


def reset_phase_stats() -> None:
    with _phase_lock:
        for row in _phase_table.values():
            row["calls"] = 0
            row["seconds"] = 0.0


def phase_delta(before, after):
    """Per-phase difference of two snapshots (mirrors
    ``zk.native.phase_delta`` so attribution code treats both tables
    uniformly)."""
    out = {}
    for p in PHASES:
        b = before.get(p, {"calls": 0, "seconds": 0.0})
        a = after.get(p, {"calls": 0, "seconds": 0.0})
        out[p] = {
            "calls": a["calls"] - b["calls"],
            "seconds": a["seconds"] - b["seconds"],
        }
    return out


# ---------------------------------------------------------------------------
# Kernel entry points: the reference's graft call sites, raising until
# the kernels are written for the card.
# ---------------------------------------------------------------------------


def _not_ported(entry: str):
    raise NotImplementedError(
        f"zk.graft.{entry} is not ported to protocol_tpu_torch yet ({NOT_PORTED})"
    )


def msm(scalars, points):
    """Graft MSM over affine G1 points."""
    _not_ported("msm")


def msm_limbs(arr, cache):
    """Graft MSM over a prepared point cache with (n, 4) u64 canonical
    scalar limbs (the ``Setup.commit_limbs`` fast path)."""
    _not_ported("msm_limbs")


def msm_limbs_batch(arrs, cache):
    _not_ported("msm_limbs_batch")


def point_cache(points):
    """The device-side point preprocessing, once per SRS."""
    _not_ported("point_cache")


def ntt_limbs(arr, root, inverse):
    """NTT over (n, 4) u64 canonical Fr limbs."""
    _not_ported("ntt_limbs")


__all__ = [
    "NOT_PORTED",
    "PHASES",
    "VALID_BACKENDS",
    "ZK_KERNELS",
    "msm",
    "msm_limbs",
    "msm_limbs_batch",
    "ntt_limbs",
    "phase_delta",
    "phase_stats",
    "point_cache",
    "registered_zk_kernels",
    "reset_phase_stats",
    "set_zk_backend",
    "use_zk_backend",
    "zk_backend",
]
