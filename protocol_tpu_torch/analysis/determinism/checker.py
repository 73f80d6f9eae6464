"""Pass 13 — the determinism wall.

The pod and the durability plane stake correctness on bit-identical
state: per-epoch residuals and score digests must match across hosts
before host 0 seals a pod manifest, a WAL replay must reconverge to the
same fixed point, and pooled proofs must equal in-process ones.  Three
legs hold that:

- **AST** (``ast_walk.py``): divergence-feasible Python sources over the
  trees that feed bit-identity sinks — see that module for its rules.
- **Runtime**, the counterpart of the reference's double-compile check
  (``check_recompile``): every card backend converges the synthetic
  graph twice in this process and once more in a fresh one
  (``replay.py``), and the three digests of the scores' bits, the
  iterations and the residual must be equal
  (``nondeterministic-converge`` within a process,
  ``nondeterministic-process`` across processes).  Under ``--zk`` every
  graft recipe of ``zk_lowering`` (its four kernel recipes and three
  entries) is held to the same two rules at 1,024 lanes from one seed,
  its output digested bit for bit: K13's bucket grid limb for limb, as
  two runs of the same kernel must agree (only against the plain
  version are its buckets equal as points alone).
- **Static**, the counterpart of the reference's nondeterministic-scatter
  scan: no floating-point atomic in the kernels' sources
  (``protocol_tpu_torch/ops/csrc/*.cu`` and ``*.cuh``): an ``atomicAdd``
  on a float or a double adds in whatever order the threads arrive, so
  two runs can legally produce different sums (``float-atomic``).

The reference's ``hlo-reduce-precision`` has nothing to read in the
port: no pass between the source and the kernel lowers precision.
Findings route through the enumerated, stale-tested
``waivers.DET_WAIVERS``.
"""

from __future__ import annotations

import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Any, Callable

from ..concurrency.waivers import apply_waivers
from ..report import Finding
from .ast_walk import DET_AST_RULES, run_det_ast_pass
from .waivers import DET_WAIVERS

#: The kernels' sources the atomics scan reads.
KERNEL_SOURCES = ("protocol_tpu_torch/ops/csrc",)
#: Steps a replayed converge may run, and its tolerance.
REPLAY_MAX_ITER = 30
REPLAY_TOL = 1e-6
#: Rules of the runtime and static legs.
RUNTIME_RULES = ("nondeterministic-converge", "nondeterministic-process")
STATIC_RULES = ("float-atomic",)

_ATOMIC = re.compile(r"\b(atomicAdd(?:_block|_system)?|unsafeAtomicAdd)\s*\(")
_FLOAT_TYPES = r"(?:float|double|__half|__nv_bfloat16|half|float2|float4|__half2)"


def _finding(rule: str, message: str, backend: str | None = None,
             file: str | None = None, line: int | None = None,
             severity: str = "error") -> Finding:
    return Finding(
        pass_name="determinism", rule=rule, severity=severity, message=message,
        backend=backend, file=file, line=line,
    )


# -- static: floating-point atomics -----------------------------------------


def _first_arg(text: str, start: int) -> str:
    """The first argument of the call whose ``(`` is at ``start``."""
    depth, i = 0, start
    while i < len(text):
        c = text[i]
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
            if depth == 0:
                break
        elif c == "," and depth == 1:
            break
        i += 1
    return text[start + 1 : i].strip()


def scan_atomics_source(source: str, rel_path: str) -> list[Finding]:
    """``float-atomic`` for each atomic add whose target is a floating
    type: a cast to one in the call, or a name (or ``&name[...]``)
    declared with one in the file."""
    findings = []
    for m in _ATOMIC.finditer(source):
        arg = _first_arg(source, m.end() - 1)
        floating = re.search(_FLOAT_TYPES + r"\s*\*", arg) is not None
        if not floating:
            name = re.sub(r"^[&(\s]*", "", arg)
            name = re.split(r"[\[\s+)-]", name, maxsplit=1)[0]
            if name and re.search(
                r"\b" + _FLOAT_TYPES + r"\s*(?:\*\s*)?(?:__restrict__\s*)?"
                + re.escape(name) + r"\b",
                source,
            ):
                floating = True
        if floating:
            line = source.count("\n", 0, m.start()) + 1
            findings.append(_finding(
                "float-atomic",
                f"{m.group(1)}({arg}, ...) adds floating-point values in the order "
                "the threads arrive: two runs, or two hosts, can sum the same "
                "operands to different bits; reduce in a fixed order instead",
                file=rel_path, line=line,
            ))
    return findings


def scan_atomics(root: str | Path | None = None) -> tuple[list[Finding], int]:
    """The atomics scan over ``KERNEL_SOURCES``; ``(findings, files)``."""
    root = Path(root) if root is not None else Path(__file__).resolve().parents[3]
    findings, n = [], 0
    for tree in KERNEL_SOURCES:
        for path in sorted((root / tree).iterdir()):
            if path.suffix in (".cu", ".cuh"):
                n += 1
                findings.extend(scan_atomics_source(path.read_text(), str(path.relative_to(root))))
    return findings, n


# -- runtime: replays ---------------------------------------------------------


def digest(out: tuple) -> str:
    """A converge's ``(t, iterations, residual)`` as one hex digest of
    the scores' bits, the iterations and the residual's bits."""
    import torch

    t, it, resid = out[:3]
    h = hashlib.sha256()
    h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    h.update(str(int(it)).encode())
    r = torch.as_tensor(resid, dtype=torch.float32).reshape(1).cpu()
    h.update(r.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def check_replays(name: str, digests: list[str], fresh: str | None,
                  what: str = "converge") -> list[Finding]:
    """Judge one backend's (or graft recipe's: ``what``) digests: in this
    process, then a fresh one."""
    findings = []
    if len(set(digests)) > 1:
        findings.append(_finding(
            "nondeterministic-converge",
            f"{len(digests)} {what}s of the same inputs in one process gave "
            f"{len(set(digests))} different results: the bits depend on run order",
            name,
        ))
    if fresh is not None and digests and fresh != digests[0]:
        findings.append(_finding(
            "nondeterministic-process",
            f"a {what} of the same inputs in a fresh process gave other bits than "
            "this process's: two hosts could seal different digests",
            name,
        ))
    return findings


def zk_replays(in_process: dict[str, list[str]], fresh: dict[str, str]) -> dict[str, dict]:
    """Each graft recipe's digests judged (``check_replays``), keyed by
    the registry names each kernel recipe stands for (K13's two share
    one: a kernel recipe's label is its names joined by ``+``) and by
    entry name; each entry keeps its ``findings`` for the caller to take."""
    out: dict[str, dict] = {}
    for label, digests in in_process.items():
        found = check_replays(label, digests, fresh.get(label), what="run")
        entry = {"status": "checked", "recipe": label, "in_process": digests,
                 "fresh_process": fresh.get(label), "bit_equal": not found}
        for i, name in enumerate(label.split("+")):
            out[name] = dict(entry, findings=found if i == 0 else [])
    return out


def replay_in_process(converge: Callable[[], tuple], runs: int = 2) -> list[str]:
    """``runs`` digests of ``converge()``."""
    return [digest(converge()) for _ in range(runs)]


def start_fresh_process(device: str, zk: bool = False) -> subprocess.Popen:
    """Start the replays in a fresh interpreter
    (``python -m protocol_tpu_torch.analysis.determinism.replay``, with
    ``--zk`` where ``zk``)."""
    root = Path(__file__).resolve().parents[3]
    return subprocess.Popen(
        [sys.executable, "-m", "protocol_tpu_torch.analysis.determinism.replay",
         "--device", device, *(["--zk"] if zk else [])],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def fresh_process_result(proc: subprocess.Popen, timeout_s: float = 300) -> dict:
    """The started replay process's ``{"digests": ..., "launches": ...}``;
    it is killed at the timeout."""
    try:
        out, err = proc.communicate(timeout=timeout_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"the replay process exited {proc.returncode}:\n{err}")
    return json.loads(out.strip().splitlines()[-1])


def run_determinism_pass(device, child: subprocess.Popen | None = None, zk: bool = False
                         ) -> tuple[list[Finding], dict[str, Any]]:
    """The runtime leg on ``device`` (the card, or the plain path with
    ``device="cpu"``), with ``zk`` the graft recipes' replays too (the
    section's ``zk``), the atomics scan and the AST leg, through
    ``DET_WAIVERS``.  ``child`` is the fresh replay process if the caller
    started it early (``start_fresh_process``, with the same ``zk``).
    Returns ``(findings, determinism section)``."""
    import torch

    from .replay import converge_digests, zk_digests

    device = torch.device(device)
    findings: list[Finding] = []
    section: dict[str, Any] = {"device": str(device), "backends": {}}
    # On the card the fresh process replays while this one converges its
    # own two; on the CPU the two would contend for the cores, so it runs
    # first.
    if child is None:
        child = start_fresh_process(str(device), zk)
    if device.type == "cpu":
        result = fresh_process_result(child)
    try:
        in_process = converge_digests(device, runs=2)
        in_process_zk = zk_digests(device, runs=2) if zk else {}
    finally:
        if device.type != "cpu":
            result = fresh_process_result(child)
    fresh = result["digests"]
    section["fresh_process_launches"] = result["launches"]
    for name, digests in in_process.items():
        case_findings = check_replays(name, digests, fresh.get(name))
        findings.extend(case_findings)
        section["backends"][name] = {
            "status": "checked",
            "in_process": digests,
            "fresh_process": fresh.get(name),
            "bit_equal": not case_findings,
        }
    if zk:
        section["zk"] = zk_replays(in_process_zk, result.get("zk_digests", {}))
        findings.extend(f for entry in section["zk"].values() for f in entry.pop("findings"))
    atomics, n_sources = scan_atomics()
    findings.extend(atomics)
    section["kernel_sources_scanned"] = n_sources
    ast_findings, n_files = run_det_ast_pass()
    findings.extend(ast_findings)
    section["files_scanned"] = n_files
    judged = set(DET_AST_RULES) | set(RUNTIME_RULES) | set(STATIC_RULES)
    live, waived, stale = apply_waivers(findings, DET_WAIVERS, "determinism", judged=judged)
    section["waived"] = waived
    section["stale_waivers"] = stale
    return live, section


__all__ = [
    "KERNEL_SOURCES",
    "check_replays",
    "digest",
    "fresh_process_result",
    "replay_in_process",
    "run_determinism_pass",
    "scan_atomics",
    "scan_atomics_source",
    "start_fresh_process",
    "zk_replays",
]
