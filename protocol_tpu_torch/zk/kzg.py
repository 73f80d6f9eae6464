"""KZG polynomial commitments over Bn254 (the reference's commitment
scheme: halo2 `ParamsKZG` + GWC proving, circuit/src/utils.rs:198-303).

An SRS is the powers-of-tau ladder (tau^i G1 for i < n, plus tau G2).
`Setup.generate` derives tau from a seed — an insecure *test* setup,
exactly like the reference's `generate_params` which builds its SRS
from a local RNG (circuit/src/utils.rs:198-205); production would load
a ceremony transcript instead.

Commit is an MSM over the G1 ladder (native Pippenger via
zk.native when available, Python windowed fallback), open is the
quotient-witness commitment, verify is the standard two-pairing check.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..crypto.field import MODULUS as R
from . import graft as zk_graft
from . import native as zk_native
from .bn254 import G1, GENERATOR, IDENTITY
from .fields import G2, G2_GENERATOR, pairing_check


def msm(scalars: list[int], points: list[G1]) -> G1:
    """Multi-scalar multiplication; dispatches on the ``zk_backend``
    knob — ``graft`` routes to the card Pippenger (``zk.graft``, on the
    knob's device), ``native`` to the C++ kernel when built, else a
    Python windowed (4-bit bucket) method.

    Lengths must match exactly: callers that used to rely on the old
    silent ``points[: len(scalars)]`` truncation slice the ladder
    themselves now, so a mismatched call is always a bug upstream.
    """
    if len(scalars) != len(points):
        raise ValueError(
            f"msm length mismatch: {len(scalars)} scalars vs "
            f"{len(points)} points"
        )
    if zk_graft.zk_backend() == "graft":
        return zk_graft.msm(scalars, points)
    if zk_native.available() and len(scalars) >= 32:
        return zk_native.msm(scalars, points)
    return _msm_python(scalars, points)


def _msm_python(scalars: list[int], points: list[G1], window: int = 4) -> G1:
    buckets_per = 1 << window
    n_windows = (R.bit_length() + window - 1) // window
    total = IDENTITY
    for w in range(n_windows - 1, -1, -1):
        for _ in range(window):
            total = total.double()
        buckets = [IDENTITY] * buckets_per
        shift = w * window
        for s, p in zip(scalars, points):
            digit = (s >> shift) & (buckets_per - 1)
            if digit:
                buckets[digit] = buckets[digit].add(p)
        # Running-sum bucket reduction.
        acc = IDENTITY
        part = IDENTITY
        for b in reversed(buckets[1:]):
            acc = acc.add(b)
            part = part.add(acc)
        total = total.add(part)
    return total


@dataclass
class Setup:
    """The SRS: g1_powers[i] = tau^i G1; g2 generator and tau G2."""

    k: int
    g1_powers: list[G1]
    g2: G2
    tau_g2: G2

    @property
    def n(self) -> int:
        return 1 << self.k

    @classmethod
    def generate(cls, k: int, seed: bytes = b"protocol-tpu-srs") -> "Setup":
        tau = (
            int.from_bytes(hashlib.blake2b(seed, digest_size=64).digest(), "little") % R
        )
        n = 1 << k
        if zk_native.available() and n >= 64:
            powers = zk_native.srs_g1_powers(tau, n)
        else:
            powers = []
            acc = 1
            for _ in range(n):
                powers.append(GENERATOR.mul(acc))
                acc = acc * tau % R
        return cls(k, powers, G2_GENERATOR, G2_GENERATOR.mul(tau))

    def shrink(self, k: int) -> "Setup":
        """A lower-degree SRS is a prefix of a higher one (same tau) —
        the reference generates params-9..17 in one run this way."""
        assert k <= self.k
        return Setup(k, self.g1_powers[: 1 << k], self.g2, self.tau_g2)

    # -- serialization (data/params-{k}.bin equivalent) -----------------

    MAGIC = b"PTPUSRS1"

    def to_bytes(self) -> bytes:
        out = bytearray(self.MAGIC)
        out += self.k.to_bytes(4, "little")
        for p in self.g1_powers:
            out += p.x.to_bytes(32, "little") + p.y.to_bytes(32, "little")
        for pt in (self.g2, self.tau_g2):
            for coord in (pt.x, pt.y):
                for c in coord.coeffs:
                    out += c.to_bytes(32, "little")
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Setup":
        from .bn254 import is_on_curve
        from .fields import FQ2, g2_in_subgroup, g2_is_on_curve

        if data[:8] != cls.MAGIC:
            raise ValueError("bad SRS magic")
        k = int.from_bytes(data[8:12], "little")
        if k > 28:
            raise ValueError(f"implausible SRS degree k={k}")
        expected = 12 + 64 * (1 << k) + 2 * 128
        if len(data) != expected:
            raise ValueError(f"SRS length {len(data)} != expected {expected}")
        from .rns import FQ_MODULUS

        off = 12
        powers = []
        for i in range(1 << k):
            x = int.from_bytes(data[off : off + 32], "little")
            y = int.from_bytes(data[off + 32 : off + 64], "little")
            # Canonicality mirrors transcript.read_point: a coordinate
            # >= Fq aliases another point mod Q and breaks affine
            # arithmetic / native limb packing downstream.
            if x >= FQ_MODULUS or y >= FQ_MODULUS:
                raise ValueError(f"SRS G1 power {i} non-canonical")
            p = G1(x, y)
            if not is_on_curve(p):
                raise ValueError(f"SRS G1 power {i} not on curve")
            powers.append(p)
            off += 64
        g2pts = []
        for _ in range(2):
            coords = []
            for _ in range(2):
                for word_off in (off, off + 32):
                    if (
                        int.from_bytes(data[word_off : word_off + 32], "little")
                        >= FQ_MODULUS
                    ):
                        raise ValueError("SRS G2 coordinate non-canonical")
                c0 = int.from_bytes(data[off : off + 32], "little")
                c1 = int.from_bytes(data[off + 32 : off + 64], "little")
                coords.append(FQ2([c0, c1]))
                off += 64
            pt = G2(coords[0], coords[1])
            if not (g2_is_on_curve(pt) and g2_in_subgroup(pt)):
                raise ValueError("SRS G2 point invalid (curve/subgroup)")
            g2pts.append(pt)
        return cls(k, powers, g2pts[0], g2pts[1])

    # -- commitment scheme ----------------------------------------------

    def commit(self, coeffs) -> G1:
        """Commit to a coefficient-form polynomial (list of ints or an
        (n,4) canonical-limb array)."""
        import numpy as np

        if isinstance(coeffs, np.ndarray):
            return self.commit_limbs(coeffs)
        assert len(coeffs) <= self.n, "polynomial exceeds SRS degree"
        return msm([c % R for c in coeffs], self.g1_powers[: len(coeffs)])

    def _graft_cache(self):
        """Per-SRS point cache on the graft device: the once-per-prove
        bucket setup the graft Pippenger amortizes across every
        commit/open MSM.  One a device, so one prover serves a card
        node and a CPU node side by side."""
        caches = getattr(self, "_graft_points", None)
        if caches is None:
            caches = {}
            object.__setattr__(self, "_graft_points", caches)
        device = zk_graft.zk_device()
        cache = caches.get(device)
        if cache is None:
            cache = caches[device] = zk_graft.point_cache(self.g1_powers)
        return cache

    def commit_limbs(self, arr) -> G1:
        """Zero-conversion commitment: (n,4) canonical scalar limbs
        against a cached limb form of the G1 powers."""
        from . import native as zk_native

        assert arr.shape[0] <= self.n, "polynomial exceeds SRS degree"
        if zk_graft.zk_backend() == "graft":
            return zk_graft.msm_limbs(arr, self._graft_cache())
        cache = getattr(self, "_point_limbs", None)
        if cache is None:
            cache = zk_native._points_to_limbs(self.g1_powers)
            object.__setattr__(self, "_point_limbs", cache)
        return zk_native.msm_limbs(arr, cache[: arr.shape[0]])

    def commit_batch(self, arrs) -> list[G1]:
        """Commit a batch of (n_i, 4) canonical-limb polynomials.

        Under ``native`` this is exactly a loop of :meth:`commit_limbs`
        (byte-identical transcripts, trivially); under ``graft`` the
        batch shares one :class:`~.graft.pippenger.PointCache`, which is
        where the per-prove bucket-setup amortization lives."""
        if zk_graft.zk_backend() == "graft":
            return zk_graft.msm_limbs_batch(arrs, self._graft_cache())
        return [self.commit(a) for a in arrs]

    def open(self, coeffs: list[int], z: int) -> tuple[int, G1]:
        """Evaluation y = p(z) and witness commitment W = [(p - y)/(X - z)]."""
        y = _eval_poly(coeffs, z)
        q = _div_by_linear(coeffs, z, y)
        return y, self.commit(q)

    def verify(self, commitment: G1, z: int, y: int, witness: G1) -> bool:
        """e(C - y G1, G2) == e(W, tau G2 - z G2)."""
        lhs = commitment.add(GENERATOR.mul((-y) % R))
        rhs_g2 = self.tau_g2.add(self.g2.mul((-z) % R))
        return pairing_check([(lhs, self.g2), (witness.neg(), rhs_g2)])


def _eval_poly(coeffs: list[int], z: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % R
    return acc


def _div_by_linear(coeffs: list[int], z: int, y: int) -> list[int]:
    """(p(X) - y) / (X - z) by synthetic division: q_i = c_{i+1} + z q_{i+1},
    asserting the remainder matches the claimed evaluation."""
    quotient = [0] * max(len(coeffs) - 1, 0)
    acc = 0
    for i in range(len(coeffs) - 1, 0, -1):
        acc = (coeffs[i] + z * acc) % R
        quotient[i - 1] = acc
    rem = (coeffs[0] + z * acc) % R if coeffs else 0
    assert rem == y % R, "division remainder mismatch"
    return quotient
