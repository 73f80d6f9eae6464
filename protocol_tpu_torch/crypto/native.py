"""ctypes bindings for the repository's C++ crypto runtime.

Batch Poseidon, pk-hash and EdDSA verification from
``native/protocol_native.cpp`` (the sources the reference package builds
with ``make -C native``), compiled here at first use with the host C++
compiler into ``build/protocol_tpu_torch/`` at the repository root
(listed in ``.gitignore``).  The library's file name carries a digest
of the source, its header and the flags, so an edited source is rebuilt
and never served stale.  ``available()`` gates use: every caller has a
pure-Python path, and the parity tests hold both bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

from ..utils.limbs import from_limbs as _from_limbs
from ..utils.limbs import ptr as _ptr
from ..utils.limbs import to_limbs as _to_limbs

REPO = pathlib.Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "protocol_native.cpp"
HEADERS = (REPO / "native" / "constants.h",)
BUILD_DIR = REPO / "build" / "protocol_tpu_torch"
#: The Makefile's flags without ``-march=native`` and ``-fopenmp``: the
#: library is plain 64-bit integer code, so a portable build computes
#: the same bits, and without OpenMP its batch loops run serially (the
#: same bits again) and need no ``libgomp`` from the host compiler.
CXX_FLAGS = ("-O3", "-funroll-loops", "-shared", "-fPIC", "-std=c++17")
ABI_VERSION = 1

#: None = untried, False = the build or load failed (a compiler-less
#: host does not re-run the compiler per call), else the CDLL.
_lib = None
_LOCK = threading.Lock()


def library_path() -> pathlib.Path:
    """Where the library lives once built."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    for header in HEADERS:
        digest.update(header.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libprotocol_native-{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the library unless it is built already; raises with the
    compiler's output if the compile fails."""
    so = library_path()
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise OSError("no C++ compiler (g++ or $CXX) to build the crypto runtime")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, f"-I{SOURCE.parent}", str(SOURCE), "-o", str(tmp)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise OSError(f"{cxx} failed for {SOURCE.name} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _LOCK:
        if _lib is False:
            raise OSError("the crypto runtime is unavailable (its build failed)")
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except OSError:
            _lib = False
            raise
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.poseidon5_permute_batch.argtypes = [u64p, u64p, ctypes.c_int64]
        lib.pk_hash_batch.argtypes = [u64p, u64p, u64p, ctypes.c_int64]
        lib.eddsa_verify_batch.argtypes = [u64p] * 6 + [u8p, ctypes.c_int64]
        lib.protocol_native_abi_version.restype = ctypes.c_int64
        if lib.protocol_native_abi_version() != ABI_VERSION:
            _lib = False
            raise OSError("the crypto runtime's ABI version is not 1")
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library is built (building it now if need be) and
    loaded."""
    try:
        _load()
        return True
    except OSError:
        return False


def poseidon_permute_batch(inputs: list[list[int]]) -> list[list[int]]:
    """Batch width-5 permutations; bit-identical to
    ``crypto.poseidon.permute``."""
    lib = _load()
    n = len(inputs)
    flat = _to_limbs([x for row in inputs for x in row])
    out = np.empty((n * 5, 4), dtype=np.uint64)
    lib.poseidon5_permute_batch(_ptr(flat), _ptr(out), n)
    values = _from_limbs(out)
    return [values[i * 5 : (i + 1) * 5] for i in range(n)]


def pk_hash_batch(xs: list[int], ys: list[int]) -> list[int]:
    """Batch Poseidon(x, y, 0, 0, 0)[0]."""
    lib = _load()
    n = len(xs)
    xs_l, ys_l = _to_limbs(xs), _to_limbs(ys)
    out = np.empty((n, 4), dtype=np.uint64)
    lib.pk_hash_batch(_ptr(xs_l), _ptr(ys_l), _ptr(out), n)
    return _from_limbs(out)


def eddsa_verify_batch(
    rx: list[int], ry: list[int], s: list[int], pkx: list[int], pky: list[int], msg: list[int]
) -> np.ndarray:
    """Batch signature verification; returns a bool array."""
    lib = _load()
    n = len(rx)
    arrs = [_to_limbs(v) for v in (rx, ry, s, pkx, pky, msg)]
    ok = np.zeros(n, dtype=np.uint8)
    lib.eddsa_verify_batch(
        *(_ptr(a) for a in arrs), ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n
    )
    return ok.astype(bool)
