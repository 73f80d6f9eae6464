"""The graft prover's bucket sums (K13) and NTT (K11) on the card, launch by launch.

    python -m protocol_tpu_torch.bench.probe_graft_forms [--sections a,b,...]

Sections (all by default), each one JSON line on stdout:

- ``build``: every graft source built with ``nvcc -Xptxas=-v``; each
  kernel's registers, stack frame, spill bytes and shared memory.
- ``k13_earlier``: the first bucket sums (``bench/yardsticks.py::msm_bucket_chunked``,
  three launches) at 2^14 random and {0, 1} scalars over the first 2^14
  points of ``data/srs-15.bin``: event time of a call and, from a
  settled ``torch.profiler`` trace, each launch's median device time.
- ``k11_earlier``: the first NTT (``yardsticks.ntt_stages``) at 2^14 and
  2^17: each stage alone (event time), the stages in a row (event time,
  a stage's share), and from a trace each stage's device time and an
  NTT's span from its first stage's start to its last one's end.
- ``ntt_host_earlier``: one 2^17 inverse ``ntt_limbs`` as the first NTT ran it,
  part by part on the host clock, each part ending in a synchronize:
  the numpy bit-reverse, the upload, ``to_mont`` (K10), the stages, the
  ``1/n`` scale (K10), ``from_mont`` (K10), the download and copy back.
- ``k13``: the bucket sums on the path (``zk/graft/pippenger.py::msm_bucket``)
  beside the first form at the same inputs: equal as affine points,
  event times, each launch's trace time.
- ``k11``: the NTT on the path (``zk/graft/ntt.py::ntt_device``) at
  2^14 and 2^17 at each tile ``--tiles`` (log2), forward and inverse,
  bit-equal to its plain version and to the first NTT, event times per
  NTT and each pass's trace time, beside the first NTT's stages in a row.
- ``ntt_host``: one 2^17 inverse ``ntt_limbs`` on the path, part by part:
  the upload, the kernel's passes, the download and copy back.

Each line names the card (``nvidia-smi`` name and power limit); with
``--out PATH`` the lines are also appended to that file.
Importing it runs nothing; ``run()`` raises without a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import time

import numpy as np
import torch

from .. import resolve_device
from ..ops import _build
from ..zk import plonk
from ..zk.graft import field as gf
from ..zk.graft import ntt as gntt
from ..zk.graft import pippenger as gpp
from . import yardsticks as ys
from ._timing import device_events, time_ms, trace_session

ROOT = pathlib.Path(__file__).resolve().parents[2]
SRS = ROOT / "data" / "srs-15.bin"
SECTIONS = ("build", "k13_earlier", "k11_earlier", "ntt_host_earlier", "k13", "k11", "ntt_host")
GRAFT_SOURCES = ("zk_mulmod", "zk_msm_window", "zk_msm_bucket", "zk_ntt",
                 "zk_msm_bucket_chunked", "zk_ntt_stage")
MSM_N = 1 << 14
NTT_KS = (14, 17)
#: Calls in a trace session; host-clock repetitions of the host split.
CALLS = 20
HOST_REPS = 7
SEED = 14


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def srs_points(n: int) -> np.ndarray:
    """The first ``n`` affine points of ``data/srs-15.bin`` as (n, 8) u64 words."""
    raw = np.frombuffer(SRS.read_bytes(), dtype=np.uint8, offset=12, count=64 * n)
    return raw.view(np.uint64).reshape(n, 8).copy()


def canonical_words(rng, n: int) -> np.ndarray:
    """(n, 4) u64 words below 2^252, so canonical in Fr and Fq."""
    w = rng.integers(0, np.iinfo(np.uint64).max, size=(n, 4), dtype=np.uint64, endpoint=True)
    w[:, 3] &= np.uint64((1 << 60) - 1)
    return w


def ptxas_table(log: str) -> dict:
    """Per kernel in an ``nvcc -Xptxas=-v`` log: registers, stack frame,
    spill stores and loads (bytes) and shared memory."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            name = line.split("'")[1] if "'" in line else line.split()[-1]
            out.setdefault(name, {})
        elif name and "stack frame" in line:
            nums = [int(t) for t in line.replace(",", " ").split() if t.isdigit()]
            out[name].update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif name and "registers" in line:
            toks = line.replace(",", " ").split()
            out[name]["registers"] = int(toks[toks.index("registers") - 1])
            if "smem" in toks:
                out[name]["smem"] = int(toks[toks.index("smem") - 2])
    return out


def _short(name: str) -> str:
    """A kernel's name without its namespace and parameters."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].split("::")[-1]


def traced(fn, calls: int = CALLS) -> dict:
    """Device records of ``calls`` calls of ``fn`` in a settled trace:
    per kernel name its launches and median device time (ms), and the
    median span of one call (first record's start to last one's end),
    ms; ``fn`` must launch the same kernels each call."""
    fn()
    torch.cuda.synchronize()
    with trace_session() as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = sorted(device_events(prof), key=lambda e: e.time_range.start)
    by_name: dict[str, list[float]] = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    per_call = len(events) // calls if calls else 0
    spans = []
    if per_call and len(events) == per_call * calls:
        for c in range(calls):
            chunk = events[c * per_call : (c + 1) * per_call]
            spans.append((chunk[-1].time_range.end - chunk[0].time_range.start) / 1e3)
    return dict(
        kernels={_short(name): dict(launches=len(t), ms=statistics.median(t))
                 for name, t in by_name.items()},
        records=len(events), span_ms=statistics.median(spans) if spans else None,
        records_in_order=[_short(e.name) for e in events[:per_call]],
        durations_in_order=[e.time_range.elapsed_us() / 1e3 for e in events[:per_call]],
    )


def msm_inputs(dev, rng):
    cache = gpp.PointCache.build(srs_points(MSM_N), dev)
    cases = {"random": canonical_words(rng, MSM_N), "zero_one": np.zeros((MSM_N, 4), np.uint64)}
    cases["zero_one"][:, 0] = rng.integers(0, 2, size=MSM_N, dtype=np.uint64)
    out = {}
    for name, words in cases.items():
        ds, perm = gpp.msm_window(gf.u64_to_tensor(words, dev))
        out[name] = (ds, perm)
    return cache.points[:MSM_N], out


def k13_earlier(dev, rng) -> dict:
    pts, cases = msm_inputs(dev, rng)
    rec = {}
    for name, (ds, perm) in cases.items():
        rec[name] = dict(
            ms=time_ms(lambda: ys.msm_bucket_chunked(ds, perm, pts)),
            trace=traced(lambda: ys.msm_bucket_chunked(ds, perm, pts)),
        )
    return rec


def ntt_operands(dev, rng, k: int):
    d = plonk.Domain(k)
    x = gf.u64_to_tensor(canonical_words(rng, d.n), dev)
    return d, x, gntt._device_plan(d.n, d.omega, dev)


def k11_earlier(dev, rng) -> dict:
    rec = {}
    for k in NTT_KS:
        d, x, plan = ntt_operands(dev, rng, k)
        y = x.clone()
        halves = [1 << j for j in range(k)]
        alone = [time_ms(lambda h=h: ys.ntt_stage(y, plan[h - 1 : 2 * h - 1], h)) for h in halves]
        in_a_row = time_ms(lambda: ys.ntt_stages(y, plan))
        rec[f"2^{k}"] = dict(
            stage_alone_ms=alone, in_a_row_ms=in_a_row, in_a_row_stage_ms=in_a_row / k,
            trace=traced(lambda: ys.ntt_stages(y, plan)),
        )
    return rec


def _host_parts(parts: dict[str, list[float]]) -> dict:
    med = {name: statistics.median(t) * 1e3 for name, t in parts.items()}
    med["total"] = sum(med.values())
    return {f"{name}_ms": v for name, v in med.items()}


def ntt_host_earlier(dev, rng) -> dict:
    """The first ``ntt_limbs`` (inverse) at 2^17, part by part."""
    d = plonk.Domain(NTT_KS[-1])
    n = d.n
    plan = gntt._device_plan(n, d.omega_inv, dev)
    ninv = gf.FR.const(gf.FR.to_mont_int(pow(n, gf.FR.p - 2, gf.FR.p)), dev)
    vals = canonical_words(rng, n)
    parts: dict[str, list[float]] = {}

    def tick(name, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        parts.setdefault(name, []).append(t1 - t0)
        return t1

    for _ in range(HOST_REPS):
        arr = vals.copy()
        torch.cuda.synchronize()
        t = time.perf_counter()
        src = arr[gntt._bitrev_perm(n)]
        t = tick("bitrev", t)
        x = gf.u64_to_tensor(src, dev)
        t = tick("upload", t)
        x = gf.FR.to_mont(x)
        t = tick("to_mont", t)
        ys.ntt_stages(x, plan)
        t = tick("stages", t)
        x = gf.FR.mont_mul(x, ninv)
        t = tick("scale", t)
        x = gf.FR.from_mont(x)
        t = tick("from_mont", t)
        arr[:] = gf.tensor_to_u64(x)
        tick("download", t)
    return dict(n=n, inverse=True, **_host_parts(parts))


def affine(grid) -> dict:
    """A (32, 256, 3, 4) bucket grid as {(window, digit): affine point}
    over its buckets with Z != 0, digit >= 1 (the plain version sums
    bucket 0, which the kernels leave empty)."""
    from ..zk.rns import FQ_MODULUS as Q

    words = grid.cpu().numpy().view(np.uint64).reshape(32, 256, 3, 4)
    out = {}
    for w, dd in zip(*np.nonzero(words[:, :, 2, :].any(axis=-1))):
        if dd == 0:
            continue
        x, y, z = (int.from_bytes(words[w, dd, c].tobytes(), "little") for c in range(3))
        zi = pow(z, Q - 2, Q)
        out[(int(w), int(dd))] = (x * zi * zi % Q, y * zi * zi * zi % Q)
    return out


def k13(dev, rng) -> dict:
    pts, cases = msm_inputs(dev, rng)
    rec = {}
    for name, (ds, perm) in cases.items():
        grid = gpp.msm_bucket(ds, perm, pts)
        earlier = ys.msm_bucket_chunked(ds, perm, pts)
        if affine(grid) != affine(earlier) or bool((grid[:, 0] != 0).any()):
            raise RuntimeError(f"k13 ({name}): the bucket sums differ from the first form's")
        rec[name] = dict(
            ms=time_ms(lambda: gpp.msm_bucket(ds, perm, pts)),
            earlier_ms=time_ms(lambda: ys.msm_bucket_chunked(ds, perm, pts)),
            trace=traced(lambda: gpp.msm_bucket(ds, perm, pts)),
        )
    return rec


def k11(dev, rng, tiles) -> dict:
    rec = {}
    for k in NTT_KS:
        d = plonk.Domain(k)
        words = canonical_words(rng, d.n)
        row = {}
        for inverse in (False, True):
            root = d.omega_inv if inverse else d.omega
            plan = gntt._device_plan(d.n, root, dev)
            x = gf.u64_to_tensor(words, dev)
            plain = gntt._ntt_plain(x.cpu(), plan.cpu(), inverse)
            # The first NTT on the same input: bit-reverse, to_mont, stages,
            # the scale and from_mont, by K10 and the yardstick.
            y = gf.FR.to_mont(x[torch.from_numpy(gntt._bitrev_perm(d.n)).to(dev)])
            ys.ntt_stages(y, plan)
            if inverse:
                y = gf.FR.mont_mul(y, gf.FR.const(gf.FR.to_mont_int(pow(d.n, gf.FR.p - 2, gf.FR.p)), dev))
            y = gf.FR.from_mont(y)
            by_tile = {}
            for t in tiles:
                out = gntt.ntt_device(x, plan, inverse, tile=t)
                if not (torch.equal(out.cpu(), plain) and torch.equal(out, y)):
                    raise RuntimeError(f"k11 2^{k} tile 2^{t}: differs from the plain or the first NTT")
                by_tile[t or gntt.log_tile(d.n)] = dict(
                    passes=gntt.passes(d.n, t),
                    ms=time_ms(lambda t=t: gntt.ntt_device(x, plan, inverse, tile=t)),
                    trace=traced(lambda t=t: gntt.ntt_device(x, plan, inverse, tile=t)),
                )
            z = x.clone()
            row["inverse" if inverse else "forward"] = dict(
                tiles=by_tile, earlier_stages_ms=time_ms(lambda: ys.ntt_stages(z, plan)))
        rec[f"2^{k}"] = row
    return rec


def ntt_host(dev, rng) -> dict:
    """``ntt_limbs`` (inverse) at 2^17 on the path, part by part."""
    d = plonk.Domain(NTT_KS[-1])
    plan = gntt._device_plan(d.n, d.omega_inv, dev)
    vals = canonical_words(rng, d.n)
    parts: dict[str, list[float]] = {}
    for _ in range(HOST_REPS):
        arr = vals.copy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = gf.u64_to_tensor(arr, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        y = gntt.ntt_device(x, plan, True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        arr[:] = gf.tensor_to_u64(y)
        t3 = time.perf_counter()
        for name, dt in (("upload", t1 - t0), ("passes", t2 - t1), ("download", t3 - t2)):
            parts.setdefault(name, []).append(dt)
    return dict(n=d.n, inverse=True, **_host_parts(parts))


def run(sections=SECTIONS, tiles=(None,), out=None) -> list[dict]:
    dev = resolve_device(None)
    smi = _smi()
    rng = np.random.default_rng(SEED)
    if out is not None:
        out = pathlib.Path(out)
        out.parent.mkdir(parents=True, exist_ok=True)
    lines = []

    def emit(section, **fields):
        line = dict(section=section, nvidia_smi=smi, **fields)
        print(json.dumps(line), flush=True)
        if out is not None:
            with out.open("a") as f:
                f.write(json.dumps(line) + "\n")
        lines.append(line)

    t0 = time.perf_counter()
    report = _build.build([s for s in GRAFT_SOURCES if _build.source(s).exists()])
    if "build" in sections:
        emit("build", seconds=time.perf_counter() - t0,
             ptxas={name: ptxas_table(r["log"]) for name, r in report.items()})
    jobs = dict(k13_earlier=k13_earlier, k11_earlier=k11_earlier,
                ntt_host_earlier=ntt_host_earlier, k13=k13,
                k11=lambda d, r: k11(d, r, tiles), ntt_host=ntt_host)
    for name in SECTIONS[1:]:
        if name in sections:
            t0 = time.perf_counter()
            rec = jobs[name](dev, rng)
            emit(name, seconds=time.perf_counter() - t0, **rec)
    return lines


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sections", default=",".join(SECTIONS))
    ap.add_argument("--tiles", default="", help="log2 tiles of the NTT, comma-separated "
                    "(default: zk/graft/ntt.py::log_tile's)")
    ap.add_argument("--out", default=None, help="a file to append the JSON lines to as well")
    args = ap.parse_args()
    ints = lambda text: tuple(int(t) for t in text.split(","))  # noqa: E731
    run(tuple(args.sections.split(",")), ints(args.tiles) if args.tiles else (None,), args.out)


if __name__ == "__main__":
    main()
