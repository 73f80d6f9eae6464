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

**The graft leg** (``--zk``; ``zk=True``): each recipe of
``zk_lowering`` (the four kernel recipes and the three graft entries) run
once at ``RECORD_LANES`` lanes under the recorder, judged against the
budgets of the names it reaches:

- **on any device**: no float64 outside the kernel wrappers
  (``f64-dtype``); gathers and scatters outside them within
  ``ZkKernelBudget.max_gathers`` / ``max_scatters`` (``gather-budget``,
  ``scatter-budget``); no read of device data on the host but the
  declared downloads (``zk-host-read``: a scalar read, a boolean index, a
  data-dependent shape);
- **on the card only**: the downloads are exactly the declared ones, by
  count and bytes (``zk-host-copy``: ``ntt_limbs`` one of 32 n B,
  ``msm_limbs`` one of the bucket grid, the rest none), and the launches
  by wrapper are the declared ones (``zk-launch-budget``; an entry's are
  ``budget.expected_zk_launches``).

It runs behind ``--zk``: on the CPU the plain K13 dispatches ~158,000 ops
at 1,024 lanes, half a minute under the recorder.

**The registry gate** (with ``zk_lowering.ensure_budgets``'s part): every
registered backend has a ``KernelBudget`` and a ``MemBudget`` or sits in
``HOST_BACKENDS``; every sharded backend has a ``CommBudget``; every
``zk.graft.ZK_KERNELS`` name has a ``ZkKernelBudget``, a ``MemBudget``
and a ``CommBudget``; a budget for a name nobody registers is a warning.
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
from .record import COPY_OPS, OpRecord, Recording, record_ops
from .report import Finding

#: Rules only a card can judge.
CARD_RULES = ("launch-budget", "capture-failed", "replay-mismatch")
#: The graft leg's rules that only a card can judge.
ZK_CARD_RULES = ("zk-launch-budget", "zk-host-copy")


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


def record_zk(recipe, device) -> tuple[Recording, dict[str, int] | None]:
    """One call of a graft recipe (``zk_lowering.ZkRecipe``) on ``device``
    under the recorder, after a warm call on the card (libraries, plans,
    constants); and on the card its launches by wrapper."""
    from .cases import launch_counts, launches_since

    on_card = torch.device(device).type == "cuda"
    if on_card:
        recipe.call()
    before = launch_counts()
    _, rec = record_ops(recipe.call)
    return rec, launches_since(before) if on_card else None


def check_zk(recipe, rec: Recording, launches: dict[str, int] | None) -> list[Finding]:
    """Judge one graft recipe's recording against the budgets of the
    names it reaches: its ops outside the kernel wrappers, and on the card
    (``launches`` given) its downloads and launches."""
    findings: list[Finding] = []
    name = recipe.label
    budgets = [ZK_INVARIANTS[k] for k in recipe.kernels if k in ZK_INVARIANTS]
    outside = [r for r in rec.ops if r.in_kernel is None]
    wide = [r for r in outside if r.wide]
    if wide:
        findings.append(_finding(
            "f64-dtype",
            f"{len(wide)} op(s) outside the graft kernels touch float64 ({wide[0].op} in "
            f"{wide[0].function})", name, wide[0],
        ))
    for rule, ops, cap, what in (
        ("gather-budget", rec.gathers, sum(b.max_gathers for b in budgets), "gather"),
        ("scatter-budget", rec.scatters, sum(b.max_scatters for b in budgets), "scatter"),
    ):
        if len(ops) > cap:
            findings.append(_finding(
                rule,
                f"{len(ops)} {what} op(s) outside the graft kernels exceed the declared "
                f"budget of {cap} ({ops[-1].op} in {ops[-1].function})", name, ops[-1],
            ))
    reads = [r for r in rec.host_syncs if r.in_kernel is None]
    copies = [r for r in reads if r.op in COPY_OPS]
    others = [r for r in reads if r.op not in COPY_OPS]
    if others:
        findings.append(_finding(
            "zk-host-read",
            f"{len(others)} read(s) of device data on the host outside the declared "
            f"downloads ({others[0].op} in {others[0].function}): a sync on the card",
            name, others[0],
        ))
    if launches is None:
        return findings
    moved = [r.host_bytes for r in copies]
    if moved != recipe.host_copies:
        site = copies[len(recipe.host_copies)] if len(copies) > len(recipe.host_copies) else (
            copies[0] if copies else None)
        findings.append(_finding(
            "zk-host-copy",
            f"the call copied {moved} B to the host; its budgets declare "
            f"{recipe.host_copies}", name, site,
        ))
    expected = {w: recipe.launches.get(w, 0) for w in launches}
    if launches != expected:
        findings.append(_finding(
            "zk-launch-budget",
            f"the call launched {launches}, the budgets declare {expected}", name,
        ))
    return findings


def run_zk_leg(device) -> tuple[list[Finding], dict[str, Any]]:
    """The graft leg: every ``zk_lowering`` recipe on ``device`` at
    ``RECORD_LANES`` lanes, recorded once and judged (``check_zk``).
    Returns ``(findings, section)``: each registry name's record under
    ``kernels`` (K13's two names share one), each entry's under
    ``entries``."""
    from .zk_lowering import RECORD_LANES, entry_recipes, kernel_recipes

    device = torch.device(device)
    findings: list[Finding] = []
    section: dict[str, Any] = {"lanes": RECORD_LANES, "kernels": {}, "entries": {}}
    recipes = kernel_recipes(device, RECORD_LANES) + entry_recipes(device, RECORD_LANES)
    for recipe in recipes:
        t0 = time.perf_counter()
        rec, launches = record_zk(recipe, device)
        found = check_zk(recipe, rec, launches)
        findings.extend(found)
        outside = [r for r in rec.ops if r.in_kernel is None]
        record = {
            "status": "checked",
            "recipe": recipe.label,
            "device": str(device),
            "ops": len(rec.ops),
            "ops_outside_kernels": len(outside),
            "gathers_outside_kernels": len(rec.gathers),
            "scatters_outside_kernels": len(rec.scatters),
            "f64_ops": sum(1 for r in outside if r.wide),
            "host_reads": [r.to_dict() for r in rec.host_syncs if r.in_kernel is None],
            "host_copies": [r.host_bytes for r in rec.host_syncs
                            if r.in_kernel is None and r.op in COPY_OPS],
            "declared_host_copies": recipe.host_copies,
            "launches": launches,
            "declared_launches": recipe.launches,
            "violations": len(found),
            "seconds": time.perf_counter() - t0,
            "not_run": [] if launches is not None else list(ZK_CARD_RULES),
        }
        if recipe.entry is None:
            for kernel in recipe.kernels:
                section["kernels"][kernel] = record
        else:
            section["entries"][recipe.entry] = record
    return findings, section


def registry_findings() -> tuple[list[Finding], dict[str, Any]]:
    """The registry gate: every registered backend's budgets declared,
    every graft kernel's, and no budget for an unregistered name."""
    # The registry imports the kernel modules and parallel/sharded.py,
    # which declare their budgets; ensure_budgets the graft kernels'.
    from ..trust.backend import registered_backends
    from .zk_lowering import ensure_budgets

    registry = registered_backends()
    zk_names = ensure_budgets()
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
    for kernel in zk_names:
        if kernel not in ZK_INVARIANTS:
            err("undeclared-zk-budget", f"graft kernel {kernel!r} declares no ZkKernelBudget",
                kernel)
        if kernel not in MEM_INVARIANTS:
            err("undeclared-mem-budget", f"graft kernel {kernel!r} declares no MemBudget",
                kernel)
        if kernel not in COMM_INVARIANTS:
            err("undeclared-comm-budget", f"graft kernel {kernel!r} declares no CommBudget",
                kernel)
    for table, label, known in ((KERNEL_INVARIANTS, "kernel", set(registry)),
                                (MEM_INVARIANTS, "memory", set(registry) | set(zk_names)),
                                (COMM_INVARIANTS, "comm", set(registry) | set(zk_names))):
        for name in sorted(set(table) - known):
            err("stale-budget", f"{label} budget declared for {name!r}, which is not a "
                "registered backend", name, severity="warning")
    for kernel in sorted(set(ZK_INVARIANTS) - set(zk_names)):
        err("stale-budget", f"graft budget declared for {kernel!r}, which is not in "
            "zk.graft.ZK_KERNELS", kernel, severity="warning")
    section = {
        "registered": registry,
        "host_backends": sorted(HOST_BACKENDS),
        "zk_kernels": list(zk_names),
    }
    return findings, section


def run_step_pass(device, zk: bool = False) -> tuple[list[Finding], dict[str, Any]]:
    """The registry gate, then one step of every card backend on
    ``device`` (``"cuda"`` or ``"cpu"``), then with ``zk`` the graft leg
    (``run_zk_leg``, the section's ``zk``).  Returns ``(findings, step
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
        if zk:
            zk_findings, section["zk"] = run_zk_leg(device)
            findings.extend(zk_findings)
    for name in HOST_BACKENDS:
        section["backends"][name] = {"status": "skipped", "reason": "host backend"}
    return findings, section


__all__ = [
    "CARD_RULES",
    "StepResult",
    "ZK_CARD_RULES",
    "check_step",
    "check_zk",
    "record_zk",
    "registry_findings",
    "run_step",
    "run_step_pass",
    "run_zk_leg",
]
