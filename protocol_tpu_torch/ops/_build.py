"""Build, load and launch the port's CUDA kernels.

Each ``csrc/<name>.cu`` exports one C function of the same name, as
does each source ``protocol_tpu_torch/bench/csrc/<name>.cu`` (yardsticks
and probes that ``chip_smoke.py`` and ``bench/`` time beside the port's
kernels; the port never calls them).  At
first use it is compiled with ``nvcc`` for ``sm_90a`` into a shared
library under ``build/protocol_tpu_torch/`` at the repository root
(listed in ``.gitignore``) and loaded with ``ctypes``.  The library's
file name carries a digest of the source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source or header is rebuilt and
never mistaken for a stale build.  Nothing here
runs at import: the CPU test machines have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BENCH_CSRC = pathlib.Path(__file__).resolve().parents[1] / "bench" / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "protocol_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: ``(argtypes, restype)`` of each kernel source's C function.  Every
#: pointer and the stream are ``c_void_p``: without argtypes ctypes
#: would pass a Python int as a 32-bit C int and cut the pointer.
SIGNATURES = {
    "gather_window": (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p],
        ctypes.c_int,
    ),
    # (t, idx, out, rows, cols, axis, regime, parts, per, stream)
    "take_along_axis": (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    # (t, out, rows, cols, stream)
    "transpose2d": (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    # (wid, table, local, out, n_rows, stream)
    "gather_region": (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p],
        ctypes.c_int,
    ),
    # (x, hi, lo, rows, cols, n, stream)
    "ds_cumsum_rows": (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    # (wh, wl, hi, lo, n, block, stream)
    "compensated_scan": (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    # (slots, seg_end, seg_first, seg_perm, row_run_ptr, partial, out, n_rows, s, stream)
    "prefix_bridge": (
        [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    # (wh, wl, hi_in, lo_in, row_ptr, out, n_blocks, block, n, stream)
    "rowsum_tail": (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    # (w, t, src, hi, lo, e, n, stream)
    "gather_ds_cumsum": (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    # The graft prover's kernels (K10-K13), over ``csrc/bn254_field.cuh``.
    # (a, b, out, n, b_full, field, op, stream)
    "zk_mulmod": (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    # (x, y, plan, scale, n, log_tile, max_passes, stream)
    "zk_ntt": (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    # (scalars, ds, perm, m, stream)
    "zk_msm_window": (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p],
        ctypes.c_int,
    ),
    # (ds, perm, points, head, tail, out, m, stream)
    "zk_msm_bucket": (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p],
        ctypes.c_int,
    ),
    # Yardsticks (bench/csrc).  (x, hi, lo, scratch, n, stream)
    "compensated_scan_global": (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p],
        ctypes.c_int,
    ),
    # (wh, wl, hi_in, lo_in, row_ptr, out, n_blocks, block, n, stream)
    "rowsum_tail_scalar": (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    # (stream)
    "empty_kernel": ([ctypes.c_void_p], ctypes.c_int),
    # (t, idx, out, rows, cols, axis, stream)
    "take_along_axis_ldg": (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    # (wh, wl, hi_in, lo_in, row_ptr, out, n_blocks, block, n, per, resident, layout, stream)
    "rowsum_tail_forms": (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    # (w, t, src, out, e, n, stream)
    "gather_multiply": (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    # The first K11 and K13.  (x, tw, n, half, stream)
    "zk_ntt_stage": (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    # (ds, perm, points, tails, flags, loc, carry_from, out, m, ch, stream)
    "zk_msm_bucket_chunked": (
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    # The first K12.  (scalars, ds, perm, m, stream)
    "zk_msm_window_atomic": (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p],
        ctypes.c_int,
    ),
}

#: The sources under ``bench/csrc``: yardsticks and probes, which may
#: include a kernel source of ``csrc``.
BENCH_KERNELS = (
    "compensated_scan_global", "rowsum_tail_scalar", "empty_kernel", "rowsum_tail_forms",
    "take_along_axis_ldg", "gather_multiply", "zk_ntt_stage", "zk_msm_bucket_chunked",
    "zk_msm_window_atomic",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
#: Per source, how many times this process compiled its library or
#: loaded it for the first time (``obs/watchers.py::RecompileTracker``
#: diffs these around each epoch's converge).
_LOADS: dict[str, int] = {}


def load_counts() -> dict[str, int]:
    """Compiles and first loads so far in this process, by source."""
    with _COUNT_LOCK:
        return dict(_LOADS)


def _count(name: str) -> None:
    with _COUNT_LOCK:
        _LOADS[name] = _LOADS.get(name, 0) + 1


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def source(name: str) -> pathlib.Path:
    """Kernel ``name``'s CUDA source."""
    return (BENCH_CSRC if name in BENCH_KERNELS else CSRC) / f"{name}.cu"


def library_path(name: str) -> pathlib.Path:
    """Where ``name``'s shared library lives once built."""
    digest = hashlib.sha256(source(name).read_bytes())
    deps = sorted(CSRC.glob("*.cuh"))
    if name in BENCH_KERNELS:  # they may include a kernel source
        deps += sorted(CSRC.glob("*.cu"))
    for dep in deps:
        digest.update(dep.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=tuple(SIGNATURES)) -> dict[str, dict]:
    """Compile every named source that is not built yet, one ``nvcc``
    per source, all started together.  Returns, per source built, the
    compiler's output (``-Xptxas=-v`` register and shared-memory use);
    raises with the output if a compile fails.  The caller times the
    build: this module keeps no clock."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp), str(source(name))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, so)
    report = {}
    for name, (proc, tmp, so) in running.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
        os.replace(tmp, so)
        _count(name)
        report[name] = {"log": out}
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source ``name``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = SIGNATURES[name]
            _LIBS[name] = lib
            _count(name)
        return lib


def operand_device(name: str, *, align: int = 16, **operands: torch.Tensor) -> torch.device:
    """The one device that kernel ``name``'s operands share: ``cpu``
    (the wrapper then takes the plain version) or ``cuda``, where every
    operand must also be contiguous and ``align``-byte aligned (16 for
    the kernels' vector loads; a kernel of 4-byte accesses takes 4).
    Mixed or other devices raise: there is no silent fallback."""
    devices = {a.device for a in operands.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands must share one device, got {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {device.type}")
    if device.type == "cuda":
        for arg, a in operands.items():
            if not a.is_contiguous() or a.data_ptr() % align:
                raise ValueError(f"{name}: {arg} must be contiguous and {align}-byte aligned")
    return device


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel ``name``'s C function with ``args`` and the current
    stream of ``device``; raise if the card refused the launch."""
    lib = load(name)
    with torch.cuda.device(device):
        rc = getattr(lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
