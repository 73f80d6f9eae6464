"""zk.graft — the prover's inner loops on the card: the backend knob,
the phase table and the lazy entry points of the graft kernels.

The port of ``protocol_tpu/zk/graft/``.  ``zk.kzg.msm``,
``Setup.commit_limbs``, ``Setup.commit_batch`` and ``plonk.Domain``'s
NTTs ask :func:`zk_backend` which engine runs: ``"native"`` (the host
runtime, ``zk/native.py``) or ``"graft"``, the hand-written CUDA
kernels K10-K13 (``ops/csrc/zk_*.cu``) behind :mod:`.field`,
:mod:`.ntt` and :mod:`.pippenger`, on the device that the knob holds
beside the name (:func:`zk_device`).  ``None`` there means the card
and raises where there is none (``protocol_tpu_torch.resolve_device``);
``"cpu"`` runs the kernels' plain versions, as the tests do.  Nothing
falls back to the native engine or to the CPU.  Both engines prove the
same bytes: MSM and NTT results are exact group elements and field
vectors, and ``plonk._ProveAttribution`` folds this module's phase
table into the prove's span tree beside the native one.

This module imports no torch: the kernel modules load on the first
graft call.
"""

from __future__ import annotations

import contextlib
import threading

#: The reference's graft kernels, by their registry names; each has a
#: launch declaration in ``analysis/budget.py``'s ``ZK_INVARIANTS``
#: (``field.py``, ``ntt.py`` and ``pippenger.py`` declare them).
ZK_KERNELS = (
    "zk-graft-mulmod",
    "zk-graft-ntt-stage",
    "zk-graft-msm-window",
    "zk-graft-msm-scan",
    "zk-graft-msm-bucket",
)


def registered_zk_kernels() -> list[str]:
    """Kernel names the launch budgets must cover."""
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


def _resolve(name: str, device):
    """The graft device for ``name``: resolved now for ``"graft"``
    (``None`` is the card, a ``RuntimeError`` where there is none);
    ``"native"`` takes none."""
    if name != "graft":
        return None
    from ... import resolve_device

    return resolve_device(device)


def zk_backend() -> str:
    """The active proving-kernel backend: ``native`` (the ctypes
    runtime with its pure-Python fallback) or ``graft``."""
    return getattr(_local, "backend", _DEFAULT_BACKEND)


def zk_device():
    """The ``torch.device`` the graft kernels run on in this thread:
    the one selected with ``"graft"``, else the card (raising where
    there is none)."""
    device = getattr(_local, "device", None)
    if device is None:
        from ... import resolve_device

        device = resolve_device(None)
    return device


def set_zk_backend(name: str, device=None) -> None:
    """Select the backend for this thread; with ``"graft"``, on
    ``device`` (``None``: the card)."""
    _check(name)
    resolved = _resolve(name, device)
    _local.backend = name
    _local.device = resolved


@contextlib.contextmanager
def use_zk_backend(name: str, device=None):
    """Scoped backend (and graft device) selection, so a caller never
    leaks the knob."""
    _check(name)
    resolved = _resolve(name, device)
    prev = (getattr(_local, "backend", None), getattr(_local, "device", None))
    _local.backend = name
    _local.device = resolved
    try:
        yield
    finally:
        if prev[0] is None:
            del _local.backend
        else:
            _local.backend = prev[0]
        _local.device = prev[1]


# ---------------------------------------------------------------------------
# Phase timers — same table shape as zk.native.phase_stats(), so
# plonk._ProveAttribution folds both engines into the same
# snark -> {msm, ntt, ...} span children (attribution survives a
# backend switch).
# ---------------------------------------------------------------------------

PHASES = ("msm", "ntt", "gate_eval", "field_ops", "srs")

_phase_lock = threading.Lock()
_phase_table: dict[str, dict[str, float]] = {
    p: {"calls": 0, "seconds": 0.0} for p in PHASES
}


def phase_stats() -> dict[str, dict[str, float]]:
    """Snapshot of the graft backend's per-phase host wall time (each
    entry brings its result back to the host, so wall time includes the
    device work)."""
    with _phase_lock:
        return {p: dict(row) for p, row in _phase_table.items()}


def reset_phase_stats() -> None:
    with _phase_lock:
        for row in _phase_table.values():
            row["calls"] = 0
            row["seconds"] = 0.0


def _bump_phase(phase: str, seconds: float) -> None:
    with _phase_lock:
        row = _phase_table[phase]
        row["calls"] += 1
        row["seconds"] += seconds


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
# Lazy kernel entry points (torch and the kernels load on first graft call)
# ---------------------------------------------------------------------------


def msm(scalars, points):
    """Graft MSM over affine G1 points; exact, identity-aware."""
    from . import pippenger as _msm

    return _msm.msm(scalars, points)


def msm_limbs(arr, cache):
    """Graft MSM over a prepared :class:`~.pippenger.PointCache` with (n, 4)
    u64 canonical scalar limbs (the ``Setup.commit_limbs`` fast path)."""
    from . import pippenger as _msm

    return _msm.msm_limbs(arr, cache)


def msm_limbs_batch(arrs, cache):
    from . import pippenger as _msm

    return _msm.msm_limbs_batch(arrs, cache)


def point_cache(points):
    """The device-side point preprocessing on the graft device (the
    caller caches it, one a device)."""
    from . import pippenger as _msm

    return _msm.PointCache.build(points)


def ntt_limbs(arr, root, inverse):
    """In-place NTT over (n, 4) u64 canonical Fr limbs."""
    from . import ntt as _ntt

    return _ntt.ntt_limbs(arr, root, inverse)


__all__ = [
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
    "zk_device",
]
