"""Keccak-256 (the Ethereum variant: original Keccak padding 0x01, not
NIST SHA-3's 0x06).

Needed for chain interop — event topics, ABI function selectors,
contract addresses (the reference gets these via ethers-rs).  hashlib
only ships NIST SHA-3, so the sponge is implemented here.
"""

from __future__ import annotations

_ROUND_CONSTANTS = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

_ROTATIONS = (
    (0, 36, 3, 41, 18),
    (1, 44, 10, 45, 2),
    (62, 6, 43, 15, 61),
    (28, 55, 25, 21, 56),
    (27, 20, 39, 8, 14),
)

_MASK = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK


def _keccak_f(state: list[int]) -> None:
    """keccak-f[1600] on a 5x5 lane state (column-major: state[x*5+y])."""
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [
            state[x * 5]
            ^ state[x * 5 + 1]
            ^ state[x * 5 + 2]
            ^ state[x * 5 + 3]
            ^ state[x * 5 + 4]
            for x in range(5)
        ]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                state[x * 5 + y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y * 5 + (2 * x + 3 * y) % 5] = _rotl(state[x * 5 + y], _ROTATIONS[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                state[x * 5 + y] = b[x * 5 + y] ^ (
                    (~b[((x + 1) % 5) * 5 + y]) & b[((x + 2) % 5) * 5 + y]
                )
        # iota
        state[0] ^= rc


def keccak256(data: bytes) -> bytes:
    rate = 136  # 1088-bit rate for 256-bit output
    state = [0] * 25

    # Pad: 0x01 ... 0x80 (multi-rate padding with Keccak domain bit).
    pad_len = rate - (len(data) % rate)
    padded = (
        data + b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"
        if pad_len >= 2
        else data + b"\x81"
    )

    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[i * 8 : (i + 1) * 8], "little")
            x, y = i % 5, i // 5
            state[x * 5 + y] ^= lane
        _keccak_f(state)

    out = bytearray()
    for i in range(4):  # 32 bytes from the first 4 lanes
        x, y = i % 5, i // 5
        out += state[x * 5 + y].to_bytes(8, "little")
    return bytes(out)


def selector(signature: str) -> bytes:
    """4-byte ABI function selector, e.g. selector("attest((address,
    bytes32,bytes)[])") == 0x5eb5ea10 (client/src/att_station.rs:54)."""
    return keccak256(signature.encode())[:4]


def event_topic(signature: str) -> bytes:
    """32-byte event topic hash."""
    return keccak256(signature.encode())
