"""Shared 4x64-bit limb packing for the ctypes bindings to the C++
runtimes (crypto.native and zk.native): Python ints <-> (n, 4) uint64
little-endian limb arrays, plus the pointer cast helper."""

from __future__ import annotations

import ctypes

import numpy as np

U64P = ctypes.POINTER(ctypes.c_uint64)
_MASK = (1 << 64) - 1


def to_limbs(values) -> np.ndarray:
    """ints -> (n, 4) u64 canonical little-endian limb array."""
    out = np.empty((len(values), 4), dtype=np.uint64)
    for i, v in enumerate(values):
        out[i, 0] = v & _MASK
        out[i, 1] = (v >> 64) & _MASK
        out[i, 2] = (v >> 128) & _MASK
        out[i, 3] = (v >> 192) & _MASK
    return out


def from_limbs(arr: np.ndarray) -> list[int]:
    arr = arr.astype(object)
    return [
        int(r[0]) | int(r[1]) << 64 | int(r[2]) << 128 | int(r[3]) << 192 for r in arr
    ]


def to_limbs_fast(values) -> np.ndarray:
    """Bulk ints -> (n, 4) limb array via one byte buffer (the per-int
    numpy indexing in ``to_limbs`` dominates at 2^18-point domains)."""
    buf = b"".join(v.to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, dtype=np.uint64).reshape(-1, 4).copy()


def from_limbs_fast(arr: np.ndarray) -> list[int]:
    buf = np.ascontiguousarray(arr, dtype=np.uint64).tobytes()
    return [
        int.from_bytes(buf[i : i + 32], "little") for i in range(0, len(buf), 32)
    ]


def ptr(arr: np.ndarray):
    return arr.ctypes.data_as(U64P)
