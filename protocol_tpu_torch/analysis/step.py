"""The step leg, in place of the reference's jaxpr pass
(``protocol_tpu/analysis/invariants.py`` over ``jaxpr_walk.py``).

The reference traces each registered backend's step to a closed jaxpr
and walks it.  The port has no trace, so this leg runs one step of each
card backend on the reference's synthetic graph (``cases.step_graph``)
and records what it dispatched (``record.record_ops``):

- **on any device**: no float64 tensor (``f64-dtype``), no read of a
  device value on the host (``host-sync-in-step``: a scalar read, a
  data-dependent shape, a copy to the CPU), no more scatter-family ops
  (``scatter-budget``) or gather-family ops (``gather-budget``) outside
  the kernels than ``KernelBudget`` declares.  Ops inside a kernel
  wrapper are not counted, the reference's rule for ops inside a
  ``pallas_call``.
- **on the card only**: the step is captured in a ``torch.cuda.CUDAGraph``
  (``capture-failed`` otherwise: a host sync or a host-side decision
  inside the step cannot be captured); the kernels it launches while
  being captured, by wrapper, equal ``KernelBudget.launches_per_step``
  (``launch-budget``; counted at capture, since a replay calls no
  wrapper); one replay equals the eager step bit for bit
  (``replay-mismatch``).  The sharded composites run in a process group
  of one rank (``cases.single_rank_group``: NCCL on the card, whose
  all-reduce a graph can hold).

With ``device="cpu"`` the card-only rules are reported as not run, never
as passed.

**The registry gate** (with ``zk_lowering.ensure_budgets``'s part): every
registered backend has a ``KernelBudget`` and a ``MemBudget`` or sits in
``HOST_BACKENDS``; every sharded backend has a ``CommBudget``; every
``zk.graft.ZK_KERNELS`` name has a ``ZkKernelBudget``; a budget for a
name nobody registers is a warning.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from .budget import (
    COMM_INVARIANTS,
    HOST_BACKENDS,
    KERNEL_INVARIANTS,
    MEM_INVARIANTS,
    ZK_INVARIANTS,
    KernelBudget,
)
from .record import OpRecord, Recording, record_ops
from .report import Finding

#: Rules only a card can judge.
CARD_RULES = ("launch-budget", "capture-failed", "replay-mismatch")


def _finding(rule: str, message: str, backend: str | None, site: OpRecord | None = None,
             severity: str = "error") -> Finding:
    return Finding(
        pass_name="step", rule=rule, severity=severity, message=message, backend=backend,
        file=site.file if site else None, line=site.line if site else None,
    )


@dataclass
class StepResult:
    """What one step of one backend did."""

    backend: str
    device: str
    dims: dict[str, int] = field(default_factory=dict)
    recording: Recording = field(default_factory=Recording)
    #: Kernel launches of the eager step, by wrapper (the card only).
    launches: dict[str, int] | None = None
    #: The CUDA-graph capture: its launches by wrapper, whether one
    #: replay equals the eager step bit for bit, or the capture's error.
    capture: dict[str, Any] | None = None

    def to_dict(self) -> dict[str, Any]:
        rec = self.recording
        return {
            "status": "checked",
            "device": self.device,
            "dims": self.dims,
            "ops": len(rec.ops),
            "gathers_outside_kernels": len(rec.gathers),
            "scatters_outside_kernels": len(rec.scatters),
            "host_syncs": [r.to_dict() for r in rec.host_syncs],
            "f64_ops": len(rec.wide),
            "launches": self.launches,
            "capture": self.capture,
            "not_run": [] if self.capture is not None else list(CARD_RULES),
        }


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()


def _capture(step: Callable, t: torch.Tensor, eager: torch.Tensor) -> dict[str, Any]:
    """Capture ``step(t)`` in a CUDA graph on a side stream (after two
    warm steps there), count the launches the capture makes, replay it
    once and compare its output with the eager step's bits."""
    from .cases import launch_counts, launches_since

    stream = torch.cuda.Stream(device=t.device)
    stream.wait_stream(torch.cuda.current_stream(t.device))
    try:
        with torch.cuda.stream(stream):
            for _ in range(2):
                step(t)
        torch.cuda.current_stream(t.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with torch.cuda.graph(graph):
            out = step(t)
        launches = launches_since(before)
        graph.replay()  # on the current stream, which _bits reads after
    except Exception as exc:  # noqa: BLE001 - a failed capture is the finding
        return {"captured": False, "error": repr(exc)}
    return {
        "captured": True,
        "launches": launches,
        "replay_bit_equal": _bits(out) == _bits(eager),
    }


def run_step(backend: str, step: Callable, t: torch.Tensor, *, dims=None) -> StepResult:
    """One step of ``backend`` from ``t``: its ops recorded, and on the
    card its launches, capture and replay."""
    from .cases import launch_counts, launches_since

    res = StepResult(backend=backend, device=str(t.device), dims=dict(dims or {}))
    if t.device.type == "cuda":
        step(t)  # load the kernels' libraries, warm the allocator
    before = launch_counts()
    eager, res.recording = record_ops(step, t)
    if t.device.type == "cuda":
        res.launches = launches_since(before)
        res.capture = _capture(step, t, eager)
    return res


def check_step(budget: KernelBudget, res: StepResult) -> list[Finding]:
    """Judge one step against its backend's budget."""
    findings: list[Finding] = []
    name, rec = res.backend, res.recording
    wide = rec.wide
    if wide:
        findings.append(_finding(
            "f64-dtype",
            f"{len(wide)} op(s) of the step touch float64 ({wide[0].op} in "
            f"{wide[0].function}): the step keeps the double-single (hi, lo) "
            "float32 form instead",
            name, wide[0],
        ))
    syncs = rec.host_syncs
    if syncs:
        findings.append(_finding(
            "host-sync-in-step",
            f"{len(syncs)} op(s) of the step read device data on the host "
            f"({syncs[0].op} in {syncs[0].function}): one host round trip a "
            "step, and no CUDA graph can hold it",
            name, syncs[0],
        ))
    scatters = rec.scatters
    if len(scatters) > budget.max_scatters:
        findings.append(_finding(
            "scatter-budget",
            f"{len(scatters)} scatter op(s) outside the kernels a step exceed the "
            f"declared budget of {budget.max_scatters} ({scatters[-1].op} in "
            f"{scatters[-1].function})",
            name, scatters[-1],
        ))
    gathers = rec.gathers
    if len(gathers) > budget.max_gathers:
        findings.append(_finding(
            "gather-budget",
            f"{len(gathers)} gather op(s) outside the kernels a step exceed the "
            f"declared budget of {budget.max_gathers} ({gathers[-1].op} in "
            f"{gathers[-1].function})",
            name, gathers[-1],
        ))
    if res.capture is None:
        return findings
    expected = {w: budget.launches_per_step.get(w, 0) for w in res.launches or {}}
    for label, launches in (("eager", res.launches), ("captured", res.capture.get("launches"))):
        if launches is not None and launches != expected:
            findings.append(_finding(
                "launch-budget",
                f"the {label} step launched {launches}, the budget declares {expected}",
                name,
            ))
    if not res.capture.get("captured"):
        findings.append(_finding(
            "capture-failed",
            f"the step could not be captured in a CUDA graph: {res.capture.get('error')}",
            name,
        ))
    elif not res.capture.get("replay_bit_equal"):
        findings.append(_finding(
            "replay-mismatch",
            "one replay of the captured step differs from the eager step's bits",
            name,
        ))
    return findings


def registry_findings() -> tuple[list[Finding], dict[str, Any]]:
    """The registry gate: every registered backend's budgets declared,
    every graft kernel's, and no budget for an unregistered name."""
    # The registry imports the kernel modules and parallel/sharded.py,
    # which declare their budgets.
    from ..trust.backend import registered_backends
    from ..zk import graft
    from ..zk.graft import field as _f, ntt as _n, pippenger as _p  # noqa: F401  (declare)

    registry = registered_backends()
    findings: list[Finding] = []

    def err(rule, message, name, severity="error"):
        findings.append(Finding(pass_name="step", rule=rule, severity=severity,
                                message=message, backend=name))

    for name in registry:
        if name in HOST_BACKENDS:
            continue
        if name not in KERNEL_INVARIANTS:
            err("undeclared-backend", f"registered backend {name!r} declares no KernelBudget "
                "next to its class", name)
        if name not in MEM_INVARIANTS:
            err("undeclared-mem-budget", f"registered backend {name!r} declares no MemBudget",
                name)
        if name.startswith("cuda-sharded") and name not in COMM_INVARIANTS:
            err("undeclared-comm-budget", f"sharded backend {name!r} declares no CommBudget",
                name)
    for kernel in graft.registered_zk_kernels():
        if kernel not in ZK_INVARIANTS:
            err("undeclared-zk-budget", f"graft kernel {kernel!r} declares no ZkKernelBudget",
                kernel)
    known = set(registry)
    for table, label in ((KERNEL_INVARIANTS, "kernel"), (MEM_INVARIANTS, "memory"),
                         (COMM_INVARIANTS, "comm")):
        for name in sorted(set(table) - known):
            err("stale-budget", f"{label} budget declared for {name!r}, which is not a "
                "registered backend", name, severity="warning")
    for kernel in sorted(set(ZK_INVARIANTS) - set(graft.registered_zk_kernels())):
        err("stale-budget", f"graft budget declared for {kernel!r}, which is not in "
            "zk.graft.ZK_KERNELS", kernel, severity="warning")
    section = {
        "registered": registry,
        "host_backends": sorted(HOST_BACKENDS),
        "zk_kernels": list(graft.registered_zk_kernels()),
    }
    return findings, section


def run_step_pass(device) -> tuple[list[Finding], dict[str, Any]]:
    """The registry gate, then one step of every card backend on
    ``device`` (``"cuda"`` or ``"cpu"``).  Returns ``(findings, step
    section)``; the section's ``backends`` feed ANALYSIS.json's."""
    from .cases import build_case, card_backends, host_threads, single_rank_group, step_graph

    device = torch.device(device)
    findings, section = registry_findings()
    section["device"] = str(device)
    section["backends"] = {}
    graph = step_graph()
    names = card_backends()
    single = [n for n in names if not n.startswith("cuda-sharded")]
    sharded = [n for n in names if n.startswith("cuda-sharded")]

    def one(name):
        budget = KERNEL_INVARIANTS.get(name)
        if budget is None:
            section["backends"][name] = {"status": "undeclared"}
            return
        t0 = time.perf_counter()
        case = build_case(name, graph, device)
        res = run_step(name, case.step, case.t, dims=case.dims)
        case_findings = check_step(budget, res)
        findings.extend(case_findings)
        section["backends"][name] = dict(
            res.to_dict(), violations=len(case_findings), seconds=time.perf_counter() - t0,
            budget={"launches_per_step": budget.launches_per_step,
                    "max_gathers": budget.max_gathers, "max_scatters": budget.max_scatters},
        )

    with host_threads(device):
        for name in single:
            one(name)
        if sharded:
            with single_rank_group(device):
                for name in sharded:
                    one(name)
    for name in HOST_BACKENDS:
        section["backends"][name] = {"status": "skipped", "reason": "host backend"}
    return findings, section


__all__ = [
    "CARD_RULES",
    "StepResult",
    "check_step",
    "registry_findings",
    "run_step",
    "run_step_pass",
]
