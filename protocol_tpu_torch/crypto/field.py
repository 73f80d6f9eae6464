"""Bn254 scalar-field (Fr) arithmetic.

Field elements are plain Python integers in ``[0, MODULUS)``.  The
reference represents them as 4x64-bit limbs behind halo2curves' ``Fr``
(used all over circuit/src); arbitrary-precision integers are the idiomatic
Python equivalent and are exact, which matters because the trust kernel's
field semantics (power iteration with SCALE-multiplied integer scores,
circuit/src/circuit.rs:425-470) must be reproduced bit-exactly on the
native path.  The device path computes in floating point with documented
tolerance and reconciles at the proof boundary.
"""

from __future__ import annotations

# Bn254 (alt_bn128) scalar field modulus — the order of the G1 group;
# halo2curves bn256::Fr.
MODULUS = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001

#: Number of bits in the modulus (Fr::NUM_BITS).
NUM_BITS = 254


def add(a: int, b: int) -> int:
    return (a + b) % MODULUS


def sub(a: int, b: int) -> int:
    return (a - b) % MODULUS


def neg(a: int) -> int:
    return (-a) % MODULUS


def mul(a: int, b: int) -> int:
    return (a * b) % MODULUS


def square(a: int) -> int:
    return (a * a) % MODULUS


def inv(a: int) -> int:
    """Multiplicative inverse; raises ZeroDivisionError on 0 like
    ``Fr::invert().unwrap()`` panics in the reference."""
    if a % MODULUS == 0:
        raise ZeroDivisionError("inverse of zero field element")
    return pow(a, -1, MODULUS)


def pow5(a: int) -> int:
    """x^5 S-box (params/poseidon sbox_f)."""
    a2 = (a * a) % MODULUS
    a4 = (a2 * a2) % MODULUS
    return (a4 * a) % MODULUS


def from_u128(v: int) -> int:
    return v % MODULUS


def to_le_bytes(a: int) -> bytes:
    """Canonical 32-byte little-endian representation (Fr::to_bytes)."""
    return (a % MODULUS).to_bytes(32, "little")


def from_le_bytes(b: bytes) -> int:
    """Parse a canonical 32-byte little-endian repr (Fr::from_bytes /
    from_repr).  Raises ValueError for non-canonical values, mirroring the
    reference's ``.unwrap()`` on a failed CtOption."""
    if len(b) != 32:
        raise ValueError(f"expected 32 bytes, got {len(b)}")
    v = int.from_bytes(b, "little")
    if v >= MODULUS:
        raise ValueError("non-canonical field representation")
    return v


def from_wide_bytes(b: bytes) -> int:
    """Reduce up to 64 little-endian bytes mod the field
    (Fr::from_bytes_wide over a zero-padded buffer, utils.rs to_wide)."""
    if len(b) > 64:
        raise ValueError(f"expected at most 64 bytes, got {len(b)}")
    return int.from_bytes(b, "little") % MODULUS


def from_hex(s: str) -> int:
    """Parse a 0x-prefixed big-endian hex string, reducing mod the field
    (params/mod.rs hex_to_field)."""
    return int(s, 16) % MODULUS


def to_bits(b: bytes) -> list[bool]:
    """LSB-first bit expansion of a byte string (utils.rs to_bits)."""
    out = []
    for i in range(len(b) * 8):
        out.append(bool(b[i // 8] & (1 << (i % 8))))
    return out


def field_to_bits(a: int, n_bits: int = NUM_BITS) -> list[int]:
    """First ``n_bits`` LSB-first bits of the canonical repr as 0/1 ints
    (utils.rs field_to_bits_vec)."""
    bits = to_bits(to_le_bytes(a))
    return [int(x) for x in bits[:n_bits]]
