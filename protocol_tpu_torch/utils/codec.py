"""Byte-level codecs: base58 and fixed-width buffer helpers.

Mirrors the reference's bs58 usage (server/src/utils.rs:21-24,
manager/mod.rs:96-99) and the to_wide/to_short padding helpers
(circuit/src/utils.rs:176-188, server/src/utils.rs:7-18).
"""

from __future__ import annotations

_B58_ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_B58_INDEX = {c: i for i, c in enumerate(_B58_ALPHABET)}


def b58encode(data: bytes) -> str:
    """Bitcoin-alphabet base58 (the bs58 crate's default)."""
    n = int.from_bytes(data, "big")
    out = []
    while n:
        n, rem = divmod(n, 58)
        out.append(_B58_ALPHABET[rem])
    # Leading zero bytes encode as '1's.
    n_leading = len(data) - len(data.lstrip(b"\x00"))
    return "1" * n_leading + "".join(reversed(out))


def b58decode(s: str) -> bytes:
    n = 0
    for c in s:
        if c not in _B58_INDEX:
            raise ValueError(f"invalid base58 character {c!r}")
        n = n * 58 + _B58_INDEX[c]
    body = n.to_bytes((n.bit_length() + 7) // 8, "big") if n else b""
    n_leading = len(s) - len(s.lstrip("1"))
    return b"\x00" * n_leading + body


def to_wide(b: bytes) -> bytes:
    """Zero-pad to 64 bytes (circuit/src/utils.rs:176-180)."""
    assert len(b) <= 64
    return b + b"\x00" * (64 - len(b))


def to_short(b: bytes) -> bytes:
    """Zero-pad (or pass through) to 32 bytes
    (circuit/src/utils.rs:183-188)."""
    assert len(b) <= 32
    return b + b"\x00" * (32 - len(b))
