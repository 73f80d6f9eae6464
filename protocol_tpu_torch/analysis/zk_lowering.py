"""The analyzers' recipes for the graft prover's kernels: the port's
counterpart of ``protocol_tpu/analysis/zk_lowering.py``.

Nothing is lowered in the port.  The reference traces and compiles each
of its five graft kernels at fixed shapes and walks the jaxpr and the
HLO; the port has neither, so the runtime legs run the kernels instead,
and this module supplies what they run: **recipes**, each a call of a
kernel wrapper or of a graft entry on device tensors made from a numpy
seed at a given lane count.

- **Kernel recipes**, one for each registry name
  (``zk.graft.ZK_KERNELS``): ``zk-graft-mulmod`` is ``field.mulmod_fr(a,
  b)`` (K10); ``zk-graft-ntt-stage`` is ``ntt.ntt_device(x, plan,
  inverse=True)`` (K11) with the plan, a module-level cache, made first
  and counted as resident; ``zk-graft-msm-window`` is
  ``pippenger.msm_window(scalars)`` (K12); ``zk-graft-msm-scan`` and
  ``zk-graft-msm-bucket`` share one ``pippenger.msm_bucket(ds, perm,
  points)`` call (K13), judged against the sum of the two names'
  budgets.
- **Entry recipes**, for the three graft entries the node calls:
  ``ntt_limbs`` and ``msm_limbs`` on the numpy limbs a prove hands them,
  and ``point_cache`` (``PointCache.build``) on affine points.

Every recipe runs at the same two sizes, ``ZK_LANES`` (1,024 and 2,048
lanes, a factor 2 apart).  The reference cut its MSM recipes to an
eighth of the lanes because XLA compiles are slow; the port compiles
nothing at run time, so it does not.  The step leg (``step.py``) records
each recipe's ops once at ``RECORD_LANES``; the memory leg measures each
kernel recipe at both sizes; the determinism leg digests every recipe's
output (``digest_output``).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

#: The two sizes every recipe runs at, a factor 2 apart.
ZK_LANES: tuple[int, ...] = (1024, 2048)
#: The size the step and determinism legs run the recipes at.
RECORD_LANES = 1024
#: The numpy seed of every recipe's inputs.
ZK_SEED = 2
#: K13's two registry names, which share its one call.
K13_NAMES = ("zk-graft-msm-scan", "zk-graft-msm-bucket")
#: The label of that call (a kernel recipe's label is its names joined by ``+``).
K13_LABEL = "+".join(K13_NAMES)
#: The graft entries with a recipe, by the name ``ZkKernelBudget.per_call`` uses.
ZK_ENTRIES = ("ntt_limbs", "msm_limbs", "point_cache")


@dataclass
class ZkRecipe:
    """One call of a graft kernel wrapper or entry, ready to run."""

    #: A kernel recipe's registry names joined by ``+``, or the entry's name.
    label: str
    #: The registry names whose budgets judge this recipe (for an entry,
    #: those that declare its launches).
    kernels: tuple[str, ...]
    #: The entry's name (``ZK_ENTRIES``), or None for a kernel recipe.
    entry: str | None
    lanes: int
    #: The tensors the call holds throughout (the memory leg's resident bytes).
    args: tuple[Any, ...]
    #: The call itself; returns the output the determinism leg digests.
    call: Callable[[], Any]
    #: Launches the call makes on the card, by wrapper.
    launches: dict[str, int] = field(default_factory=dict)
    #: Bytes of each device-to-host copy the call declares.
    host_copies: list[int] = field(default_factory=list)


def _zk_modules():
    """The kernel modules (importing them declares their budgets)."""
    from ..zk.graft import field as gf, ntt, pippenger

    return gf, ntt, pippenger


def zk_kernel_names() -> list[str]:
    """The registry slice this module covers (``zk.graft.registered_zk_kernels``)."""
    from ..zk.graft import registered_zk_kernels

    return registered_zk_kernels()


def ensure_budgets() -> list[str]:
    """Import the kernel modules so that their launch, memory and comm
    budgets are declared; returns the kernel names."""
    _zk_modules()
    return zk_kernel_names()


def register() -> list[str]:
    """The reference's entry to its recipe tables.  The port's legs ask
    this module for recipes directly (``kernel_recipes``,
    ``entry_recipes``), so there is no table to merge into: this declares
    the budgets and returns the kernel names."""
    return ensure_budgets()


# -- inputs, from a numpy seed --------------------------------------------------


def _canonical(rng: np.random.Generator, n: int, modulus: int) -> np.ndarray:
    """``n`` random canonical field elements as (n, 4) u64 limbs."""
    raw = rng.integers(0, 1 << 64, size=(n, 4), dtype=np.uint64, endpoint=False)
    vals = [int.from_bytes(row.tobytes(), "little") % modulus for row in raw]
    return np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals),
                         dtype=np.uint64).reshape(n, 4).copy()


def _points(rng: np.random.Generator, n: int) -> list:
    """``n`` affine G1 points: ``k G, (k + 1) G, ...`` from a seeded ``k``,
    with the identity at lane 1 (the point cache's Z = 0 path)."""
    from ..zk.bn254 import GENERATOR, IDENTITY

    p = GENERATOR.mul(int(rng.integers(1, 1 << 62)))
    out = []
    for _ in range(n):
        out.append(p)
        p = p.add(GENERATOR)
    if n > 1:
        out[1] = IDENTITY
    return out


def _root(n: int) -> int:
    """A primitive ``n``-th root of unity of Fr (5 generates Fr*)."""
    from ..crypto.field import MODULUS as R

    return pow(5, (R - 1) // n, R)


def kernel_recipes(device, lanes: int, seed: int = ZK_SEED) -> list[ZkRecipe]:
    """One recipe for each registry name (K13's two names share one) on
    ``device`` at ``lanes`` lanes, their inputs made from ``seed``."""
    import torch

    from ..crypto.field import MODULUS as R

    gf, ntt, pip = _zk_modules()
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    a = gf.u64_to_tensor(_canonical(rng, lanes, R), device)
    b = gf.u64_to_tensor(_canonical(rng, lanes, R), device)
    x = gf.u64_to_tensor(_canonical(rng, lanes, R), device)
    plan = ntt._device_plan(lanes, _root(lanes), device)
    scalars = gf.u64_to_tensor(_canonical(rng, lanes, R), device)
    ds, perm = pip.msm_window(scalars)
    points = pip.PointCache.build(_points(rng, lanes), device).points
    return [
        ZkRecipe("zk-graft-mulmod", ("zk-graft-mulmod",), None, lanes, (a, b),
                 lambda: gf.mulmod_fr(a, b), {"field_op": 1}),
        ZkRecipe("zk-graft-ntt-stage", ("zk-graft-ntt-stage",), None, lanes, (x, plan),
                 lambda: ntt.ntt_device(x, plan, True), {"ntt_device": ntt.passes(lanes)}),
        ZkRecipe("zk-graft-msm-window", ("zk-graft-msm-window",), None, lanes, (scalars,),
                 lambda: pip.msm_window(scalars), {"msm_window": 1}),
        ZkRecipe(K13_LABEL, K13_NAMES, None, lanes,
                 (ds, perm, points), lambda: pip.msm_bucket(ds, perm, points),
                 {"msm_bucket": pip._k13_an_msm(lanes)}),
    ]


def entry_recipes(device, lanes: int, seed: int = ZK_SEED) -> list[ZkRecipe]:
    """``ntt_limbs``, ``msm_limbs`` and ``point_cache`` on ``device`` at
    ``lanes`` lanes, on the host inputs a prove hands them (made from
    ``seed``); the MSM's point cache is built first."""
    import torch

    from ..crypto.field import MODULUS as R
    from ..zk.graft import use_zk_backend
    from .budget import ZK_INVARIANTS, expected_zk_host_copies, expected_zk_launches

    gf, ntt, pip = _zk_modules()
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    coeffs = _canonical(rng, lanes, R)
    scalars = _canonical(rng, lanes, R)
    points = _points(rng, lanes)
    cache = pip.PointCache.build(points, device)
    root = _root(lanes)
    ntt._device_plan(lanes, root, device)  # the prove's first NTT of this size made it

    def ntt_limbs():
        with use_zk_backend("graft", device):
            return ntt.ntt_limbs(coeffs.copy(), root, False)

    sizes = {"ntt_limbs": dict(n=lanes, inverse=False), "msm_limbs": dict(n=lanes),
             "point_cache": dict(n=lanes)}
    calls = {
        "ntt_limbs": ntt_limbs,
        "msm_limbs": lambda: pip.msm_limbs(scalars, cache),
        "point_cache": lambda: pip.PointCache.build(points, device),
    }
    return [
        ZkRecipe(entry, tuple(k for k, b in ZK_INVARIANTS.items() if entry in b.per_call),
                 entry, lanes, (), calls[entry], expected_zk_launches(entry, **sizes[entry]),
                 expected_zk_host_copies(entry, **sizes[entry]))
        for entry in ZK_ENTRIES
    ]


def digest_output(out: Any) -> str:
    """One hex digest of a recipe's output, bit for bit: tensors and
    numpy arrays by their bytes (K13's grid limb for limb), a point by
    its coordinates, a point cache by its points, tuples in order."""
    import torch

    h = hashlib.sha256()

    def feed(o):
        if isinstance(o, torch.Tensor):
            h.update(o.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
        elif isinstance(o, np.ndarray):
            h.update(np.ascontiguousarray(o).tobytes())
        elif isinstance(o, tuple) and not hasattr(o, "_fields"):
            for part in o:
                feed(part)
        elif hasattr(o, "points"):  # a PointCache
            feed(o.points)
        else:  # a G1 point
            h.update(repr(tuple(o)).encode())

    feed(out)
    return h.hexdigest()


__all__ = [
    "K13_LABEL",
    "K13_NAMES",
    "RECORD_LANES",
    "ZK_ENTRIES",
    "ZK_LANES",
    "ZK_SEED",
    "ZkRecipe",
    "digest_output",
    "ensure_budgets",
    "entry_recipes",
    "kernel_recipes",
    "register",
    "zk_kernel_names",
]
