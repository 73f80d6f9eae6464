"""BLAKE-512 (the SHA-3 finalist, not BLAKE2).

The reference derives EdDSA secret keys by hashing a random field element
with BLAKE-512 via the `blake` crate (circuit/src/eddsa/native.rs:20-24,
47-56), which wraps the reference C implementation of the SHA-3-final
BLAKE.  hashlib has no BLAKE-1, so the compression function is implemented
here from the specification: 16 rounds of the ChaCha-derived G function on
a 4x4 matrix of 64-bit words, constants from the hex digits of pi,
big-endian word encoding, and the 0x80..0x01 + 128-bit length padding.
"""

from __future__ import annotations

MASK64 = (1 << 64) - 1

# First 512 bits of the fractional part of pi (BLAKE-512 constants).
_C = (
    0x243F6A8885A308D3, 0x13198A2E03707344, 0xA4093822299F31D0, 0x082EFA98EC4E6C89,
    0x452821E638D01377, 0xBE5466CF34E90C6C, 0xC0AC29B7C97C50DD, 0x3F84D5B5B5470917,
    0x9216D5D98979FB1B, 0xD1310BA698DFB5AC, 0x2FFD72DBD01ADFB7, 0xB8E1AFED6A267E96,
    0xBA7C9045F12C7F99, 0x24A19947B3916CF7, 0x0801F2E2858EFC16, 0x636920D871574E69,
)

# SHA-512 initial values (BLAKE-512 IV).
_IV = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)

_SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)

# G-function targets per round: 4 column steps then 4 diagonal steps.
_IDX = (
    (0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
    (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14),
)


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (64 - n))) & MASK64


def _compress(h: list[int], block: bytes, t: int, salt=(0, 0, 0, 0)) -> list[int]:
    m = [int.from_bytes(block[i * 8 : (i + 1) * 8], "big") for i in range(16)]
    v = h[:] + [
        salt[0] ^ _C[0], salt[1] ^ _C[1], salt[2] ^ _C[2], salt[3] ^ _C[3],
        (t & MASK64) ^ _C[4], (t & MASK64) ^ _C[5],
        (t >> 64) ^ _C[6], (t >> 64) ^ _C[7],
    ]
    for rnd in range(16):
        s = _SIGMA[rnd % 10]
        for g, (ia, ib, ic, id_) in enumerate(_IDX):
            a, b, c, d = v[ia], v[ib], v[ic], v[id_]
            a = (a + b + (m[s[2 * g]] ^ _C[s[2 * g + 1]])) & MASK64
            d = _rotr(d ^ a, 32)
            c = (c + d) & MASK64
            b = _rotr(b ^ c, 25)
            a = (a + b + (m[s[2 * g + 1]] ^ _C[s[2 * g]])) & MASK64
            d = _rotr(d ^ a, 16)
            c = (c + d) & MASK64
            b = _rotr(b ^ c, 11)
            v[ia], v[ib], v[ic], v[id_] = a, b, c, d
    return [
        h[i] ^ salt[i % 4] ^ v[i] ^ v[i + 8] for i in range(8)
    ]


def blake512(data: bytes) -> bytes:
    """Digest of ``data`` (64 bytes)."""
    h = list(_IV)
    bit_len = len(data) * 8

    # Padding: a 1 bit (0x80), zeros to 112 bytes mod 128, a final 1 bit
    # OR'd into the last padding byte, then the 128-bit big-endian bit
    # length.  When the message length is 111 mod 128 both marker bits
    # share one byte (0x81).
    pad = bytearray(data)
    pad.append(0x80)
    while len(pad) % 128 != 112:
        pad.append(0)
    pad[-1] |= 0x01
    pad += bit_len.to_bytes(16, "big")
    assert len(pad) % 128 == 0

    for i in range(len(pad) // 128):
        # The counter t is the number of *message* (unpadded) bits hashed
        # through this block; a block containing no message bits uses 0.
        if i * 1024 >= bit_len:
            t = 0
        else:
            t = min((i + 1) * 1024, bit_len)
        h = _compress(h, bytes(pad[i * 128 : (i + 1) * 128]), t)

    return b"".join(x.to_bytes(8, "big") for x in h)
