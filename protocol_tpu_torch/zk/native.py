"""ctypes bindings for the repository's C++ ZK proving runtime.

NTT, Pippenger MSM, SRS ladder, vectorized field ops, and the gate
bytecode evaluator from ``native/zk_runtime.cpp`` and
``native/zk_ifma.cpp`` (the hot loops of KZG/PLONK proving, the analog
of halo2's Rust backend behind create_proof, circuit/src/utils.rs:259-281).
Compiled here at first use with the host C++ compiler into
``build/protocol_tpu_torch/`` at the repository root, as
``crypto.native`` builds its runtime: the library's file name carries a
digest of the sources, their headers and the flags, so an edited source
is rebuilt and never served stale, and nothing is written under
``native/``.  Every caller has a pure-Python fallback gated on
``available()``; the parity tests hold both bit for bit.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

from ..crypto.field import MODULUS as R
from ..utils.limbs import (
    U64P as _U64P,
    from_limbs,
    ptr as _ptr,
    to_limbs,
    to_limbs_fast,
)
from .bn254 import G1

REPO = pathlib.Path(__file__).resolve().parents[2]
SOURCES = (REPO / "native" / "zk_runtime.cpp", REPO / "native" / "zk_ifma.cpp")
HEADERS = (REPO / "native" / "constants.h", REPO / "native" / "zk_common.h")
BUILD_DIR = REPO / "build" / "protocol_tpu_torch"
#: The Makefile's flags without ``-march=native`` and ``-fopenmp``:
#: without OpenMP the parallel loops run serially (the same bits) and
#: need no ``libgomp`` from the host compiler.
CXX_FLAGS = ("-O3", "-funroll-loops", "-shared", "-fPIC", "-std=c++17")
#: Flags of one source only.  The IFMA engine's functions carry their
#: own target attributes and run only where ``zk_ifma_available()``
#: says the CPU has the instructions, but the file must also be
#: compiled for them: without ``-mavx512f`` GCC lays ``__m512i`` out at
#: 16-byte alignment, so the engine's ``std::vector<V8>`` buffers come
#: back 16-byte aligned and its aligned 64-byte loads fault.  The only
#: function of that file that runs on any CPU is ``zk_ifma_available``,
#: the dispatch check itself.
SOURCE_FLAGS = {"zk_ifma.cpp": ("-mavx512f", "-mavx512vl", "-mavx512dq", "-mavx512ifma")}

_lib = None  # None = untried, False = failed, else CDLL
#: One-time loader guard: the first ``_load()`` may race from several
#: threads; the double-checked fast path keeps steady-state calls
#: lock-free.
_load_lock = threading.Lock()

_I64P = ctypes.POINTER(ctypes.c_int64)


#: zk_abi_version() of the sources the loader binds; a library that
#: reports another is refused.
_ABI_VERSION = 4

#: Phase-timer table order — must match the ZkPhase enum in
#: native/zk_runtime.cpp.
PHASES = ("msm", "ntt", "gate_eval", "field_ops", "srs")


def library_path() -> pathlib.Path:
    """Where the library lives once built."""
    digest = hashlib.sha256()
    for path in SOURCES + HEADERS:
        digest.update(path.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    digest.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    return BUILD_DIR / f"libzk_runtime-{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the library unless it is built already; raises with the
    compiler's output if the compile fails.  The two sources compile in
    parallel, then link; an advisory lock on the build directory makes
    concurrent first users (test workers, ranks) wait for one build."""
    so = library_path()
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise OSError("no C++ compiler (g++ or $CXX) to build the zk runtime")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".libzk_runtime.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so
        tag = f"{so.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
        procs = [
            subprocess.Popen(
                [cxx, *CXX_FLAGS, *SOURCE_FLAGS.get(src.name, ()), f"-I{src.parent}",
                 "-c", str(src), "-o", str(obj)],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            )
            for src, obj in zip(SOURCES, objs)
        ]
        errors = [p.communicate()[1] for p in procs]
        tmp = BUILD_DIR / f"{tag}.tmp"
        try:
            for src, p, err in zip(SOURCES, procs, errors):
                if p.returncode != 0:
                    raise OSError(f"{cxx} failed for {src.name} (exit {p.returncode}):\n{err}")
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, *map(str, objs), "-o", str(tmp)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise OSError(f"{cxx} failed to link {so.name} (exit {proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, so)
        finally:
            for path in (*objs, tmp):
                path.unlink(missing_ok=True)
    return so


def _load():
    global _lib
    # Lock-free fast path: after the one-time publish, _lib is a
    # fully-initialized CDLL and readers never contend.
    if _lib is False:
        raise OSError("the zk runtime is unavailable (its build or load failed)")
    if _lib is not None:
        return _lib
    with _load_lock:
        return _load_locked()


def _load_locked():
    """The slow path, serialized: build/ABI-check/bind exactly once —
    callers re-check ``_lib`` under the lock (double-checked init).
    ctypes opens the library ``RTLD_LOCAL``, so another runtime that
    exports the same C names in this process (the reference package's
    ``native/libzk_runtime.so``) never serves a call of this one."""
    global _lib
    if _lib is False:
        raise OSError("the zk runtime is unavailable (its build or load failed)")
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
        lib.zk_abi_version.restype = ctypes.c_int64
        abi = lib.zk_abi_version()
    except (OSError, AttributeError):
        _lib = False
        raise
    if abi != _ABI_VERSION:
        _lib = False
        raise OSError(f"the zk runtime's ABI version is {abi}, not {_ABI_VERSION}")
    lib.zk_ntt.argtypes = [_U64P, ctypes.c_int64, _U64P, ctypes.c_int]
    lib.zk_vec_mul.argtypes = [_U64P, _U64P, _U64P, ctypes.c_int64]
    lib.zk_vec_add.argtypes = [_U64P, _U64P, _U64P, ctypes.c_int64]
    lib.zk_vec_sub.argtypes = [_U64P, _U64P, _U64P, ctypes.c_int64]
    lib.zk_batch_inv.argtypes = [_U64P, _U64P, ctypes.c_int64]
    lib.zk_msm.argtypes = [_U64P, _U64P, ctypes.c_int64, _U64P]
    lib.zk_srs_powers.argtypes = [_U64P, ctypes.c_int64, _U64P]
    lib.zk_eval_program.argtypes = [
        ctypes.c_int64,
        ctypes.c_int64,
        _U64P,
        ctypes.c_int64,
        _I64P,
        ctypes.c_int64,
        _U64P,
        ctypes.c_int64,
        _U64P,
    ]
    lib.zk_eval_program.restype = ctypes.c_int64
    lib.zk_eval_program2.argtypes = [
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int64,
        _I64P,
        ctypes.c_int64,
        _U64P,
        ctypes.c_int64,
        _U64P,
    ]
    lib.zk_eval_program2.restype = ctypes.c_int64
    lib.zk_powers.argtypes = [_U64P, ctypes.c_int64, _U64P]
    lib.zk_scale_add.argtypes = [_U64P, _U64P, _U64P, ctypes.c_int64]
    lib.zk_poly_eval.argtypes = [_U64P, ctypes.c_int64, _U64P, _U64P]
    lib.zk_div_linear.argtypes = [_U64P, ctypes.c_int64, _U64P, _U64P]
    lib.zk_phase_count.restype = ctypes.c_int64
    lib.zk_phase_stats.argtypes = [_I64P]
    lib.zk_phase_reset.argtypes = []
    lib.zk_ifma_available.restype = ctypes.c_int64
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


def ifma_available() -> bool:
    """Whether the runtime dispatches to its AVX-512 IFMA engine on this
    CPU (False where the runtime is unavailable)."""
    return available() and bool(_load().zk_ifma_available())


def _iptr(arr: np.ndarray):
    return arr.ctypes.data_as(_I64P)


# -- phase attribution -------------------------------------------------


def phase_stats() -> dict[str, dict[str, float]]:
    """Cumulative engine phase table (deep attribution): phase name ->
    ``{"calls": int, "seconds": float}``.  Monotonic since process
    start (or the last :func:`reset_phase_stats`); the prover snapshots
    it around a prove and bridges the delta into the epoch span tree.
    Returns all-zero rows when the native runtime is unavailable, so
    callers need no availability guard."""
    if not available():
        return {p: {"calls": 0, "seconds": 0.0} for p in PHASES}
    lib = _load()
    n = int(lib.zk_phase_count())
    out = np.zeros((n, 2), dtype=np.int64)
    lib.zk_phase_stats(_iptr(out))
    stats: dict[str, dict[str, float]] = {}
    for i, name in enumerate(PHASES):
        calls, ns = (int(out[i, 0]), int(out[i, 1])) if i < n else (0, 0)
        stats[name] = {"calls": calls, "seconds": ns / 1e9}
    return stats


def reset_phase_stats() -> None:
    """Zero the engine phase table (tests and bench harnesses)."""
    if available():
        _load().zk_phase_reset()


def phase_delta(
    before: dict[str, dict[str, float]], after: dict[str, dict[str, float]]
) -> dict[str, dict[str, float]]:
    """Per-phase (calls, seconds) difference between two snapshots —
    the attribution for one timed region (e.g. one SNARK prove)."""
    return {
        name: {
            "calls": after[name]["calls"] - before.get(name, {}).get("calls", 0),
            "seconds": round(
                after[name]["seconds"] - before.get(name, {}).get("seconds", 0.0),
                9,
            ),
        }
        for name in after
    }


# -- public ops --------------------------------------------------------


def ntt(values: list[int], root: int, inverse: bool = False) -> list[int]:
    """In-place radix-2 NTT; `root` must be a primitive len(values)-th
    root of unity in Fr (pass the inverse root with inverse=True)."""
    lib = _load()
    n = len(values)
    assert n & (n - 1) == 0, "NTT size must be a power of two"
    data = to_limbs(values)
    root_l = to_limbs([root])
    lib.zk_ntt(_ptr(data), n, _ptr(root_l), 1 if inverse else 0)
    return from_limbs(data)


def vec_mul(a: list[int], b: list[int]) -> list[int]:
    lib = _load()
    al, bl = to_limbs(a), to_limbs(b)
    out = np.empty_like(al)
    lib.zk_vec_mul(_ptr(al), _ptr(bl), _ptr(out), len(a))
    return from_limbs(out)


def batch_inv(a: list[int]) -> list[int]:
    lib = _load()
    al = to_limbs(a)
    out = np.empty_like(al)
    lib.zk_batch_inv(_ptr(al), _ptr(out), len(a))
    return from_limbs(out)


def _points_to_limbs(points: list[G1]) -> np.ndarray:
    buf = b"".join(
        p.x.to_bytes(32, "little") + p.y.to_bytes(32, "little") for p in points
    )
    return np.frombuffer(buf, dtype=np.uint64).reshape(-1, 8).copy()


def _limbs_to_point(arr: np.ndarray) -> G1:
    vals = arr.astype(object)
    x = int(vals[0]) | int(vals[1]) << 64 | int(vals[2]) << 128 | int(vals[3]) << 192
    y = int(vals[4]) | int(vals[5]) << 64 | int(vals[6]) << 128 | int(vals[7]) << 192
    return G1(x, y)


def msm(scalars: list[int], points: list[G1]) -> G1:
    if len(scalars) != len(points):
        raise ValueError(
            f"msm length mismatch: {len(scalars)} scalars vs "
            f"{len(points)} points"
        )
    lib = _load()
    n = len(scalars)
    s = to_limbs_fast([x % R for x in scalars])
    p = _points_to_limbs(points)
    out = np.zeros(8, dtype=np.uint64)
    lib.zk_msm(_ptr(s), _ptr(p), n, _ptr(out))
    return _limbs_to_point(out)


def msm_limbs(scalars: np.ndarray, point_limbs: np.ndarray) -> G1:
    """MSM with (n,4) canonical scalar limbs and pre-converted (n,8)
    point limbs — the zero-conversion hot path for commitments."""
    if scalars.shape[0] != point_limbs.shape[0]:
        raise ValueError(
            f"msm_limbs length mismatch: {scalars.shape[0]} scalars vs "
            f"{point_limbs.shape[0]} point rows"
        )
    lib = _load()
    n = scalars.shape[0]
    s = np.ascontiguousarray(scalars, dtype=np.uint64)
    out = np.zeros(8, dtype=np.uint64)
    lib.zk_msm(_ptr(s), _ptr(point_limbs), n, _ptr(out))
    return _limbs_to_point(out)


def powers(base: int, n: int) -> np.ndarray:
    """(n,4) canonical limbs of base^0 .. base^(n-1)."""
    lib = _load()
    b = to_limbs([base % R])
    out = np.empty((n, 4), dtype=np.uint64)
    lib.zk_powers(_ptr(b), n, _ptr(out))
    return out


def scale_add(acc: np.ndarray, p: np.ndarray, scalar: int) -> None:
    """acc[i] += scalar * p[i] over min(len) rows, in place (canonical)."""
    lib = _load()
    n = min(acc.shape[0], p.shape[0])
    s = to_limbs([scalar % R])
    lib.zk_scale_add(_ptr(acc), _ptr(np.ascontiguousarray(p[:n])), _ptr(s), n)


def poly_eval_limbs(coeffs: np.ndarray, x: int) -> int:
    lib = _load()
    xl = to_limbs([x % R])
    out = np.empty(4, dtype=np.uint64)
    lib.zk_poly_eval(_ptr(np.ascontiguousarray(coeffs)), coeffs.shape[0], _ptr(xl), _ptr(out))
    return int(out[0]) | int(out[1]) << 64 | int(out[2]) << 128 | int(out[3]) << 192


def div_linear_limbs(coeffs: np.ndarray, z: int) -> np.ndarray:
    """(p - p(z)) / (X - z) on (n,4) canonical limbs -> (n-1,4)."""
    lib = _load()
    n = coeffs.shape[0]
    zl = to_limbs([z % R])
    out = np.empty((max(n - 1, 1), 4), dtype=np.uint64)
    if n <= 1:
        out[:] = 0
        return out
    lib.zk_div_linear(_ptr(np.ascontiguousarray(coeffs)), n, _ptr(zl), _ptr(out))
    return out


def srs_g1_powers(tau: int, n: int) -> list[G1]:
    lib = _load()
    t = to_limbs([tau % R])
    out = np.empty((n, 8), dtype=np.uint64)
    lib.zk_srs_powers(_ptr(t), n, _ptr(out))
    return [_limbs_to_point(out[i]) for i in range(n)]


def eval_program(
    m: int,
    columns: np.ndarray,
    rot_stride: int,
    code: list[int],
    consts: list[int],
) -> list[int]:
    """Run the gate bytecode over all m points.  ``columns`` is an
    (n_cols, m, 4) uint64 array of canonical limbs."""
    lib = _load()
    n_cols = columns.shape[0] if columns.size else 0
    cols = np.ascontiguousarray(columns, dtype=np.uint64)
    code_arr = np.asarray(code, dtype=np.int64)
    consts_arr = to_limbs(consts) if consts else np.zeros((1, 4), dtype=np.uint64)
    out = np.empty((m, 4), dtype=np.uint64)
    rc = lib.zk_eval_program(
        m,
        n_cols,
        _ptr(cols),
        rot_stride,
        _iptr(code_arr),
        len(code_arr),
        _ptr(consts_arr),
        len(consts) if consts else 0,
        _ptr(out),
    )
    if rc != 0:
        raise ValueError(
            "malformed gate program (stack depth, operand index, or truncation)"
        )
    return from_limbs(out)
