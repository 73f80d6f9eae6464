"""Pass 12 — the peak-memory analyzer, measured.

The reference reads each compiled converge's buffer assignment
(``compiled.memory_analysis()``, a live-range walk as fallback) and
judges it against ``MEM_INVARIANTS``.  The port has no compiled module,
so it measures: each card backend's converge entry
(``cases.build_case``) runs 3 steps on the card at two scales where E
grows 4x while N grows 2x (``MEM_SCALES``, the ratio of the reference's
``COMM_SCALES``), the sharded composites on 2 ranks of one card
(``run_ranks``, gloo), and

- **resident bytes** are the converge's argument tensors;
- **transient bytes** are the caching allocator's peak after
  ``reset_peak_memory_stats``, less what was allocated when the converge
  started (its arguments), in the bytes the converge's tensors requested
  (``requested_bytes`` of ``torch.cuda.memory_stats``).  The allocator
  hands out blocks rounded up (512 B, and up to 1 MiB more where a
  large segment's tail is too small to split), by an amount that depends
  on what its cache held before (``max_memory_allocated`` less the same
  start moved by ~0.7 MB for one converge when only what ran before it
  differed); it is recorded beside (``allocated_transient_bytes``);
- the converge runs under ``record.record_ops``, which names the
  largest fresh allocation and every device-to-host copy.

The rules, the reference's names:

- **shard-replicated-edges** — resident bytes over the allowance whose
  edge term is ``E / n_shards``;
- **o-e-live-temporary** — transient bytes over the N / segments /
  rows-linear allowance, which has no edge coefficient; anchored at the
  largest fresh allocation's source line;
- **host-staging-over-cap** — one device-to-host copy over the staging
  cap.

The reference's ``donation-peak-doubled`` has no counterpart: torch
donates no buffer, so every N-vector a converge holds is counted in
``transient_n`` (ROADMAP §C).  Under ``--zk`` the pass also measures
each of ``zk_lowering``'s graft kernel recipes on the card at both of
its sizes (``ZK_LANES``, 1,024 and 2,048 lanes) in the same way, judges
them against their names' ``MEM_INVARIANTS`` budgets (K13's one call
against the sum of the scan's and the bucket's), and reads the
collective counters around each recipe, judged against the names'
``CommBudget`` (``run_zk_memory``).  ``judge_peak`` holds a peak measured
elsewhere (``chip_smoke.py``'s headline converges at 1M/50M) to the same
formulas.  On the CPU the measurements are not run (there is no
allocator peak to read), and the pass reports them so; its AST leg
(``ast_rules.run_mem_ast_pass``) runs anywhere.  Findings route through
the enumerated, stale-tested ``waivers.MEM_WAIVERS``.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
from dataclasses import dataclass, field
from typing import Any

from ..budget import MEM_INVARIANTS, MemBudget
from ..concurrency.waivers import apply_waivers
from ..report import Finding
from .waivers import MEM_WAIVERS

#: (n_peers, n_edges) of each measured scale: E x4, N x2 between them.
MEM_SCALES: tuple[tuple[int, int], ...] = ((65536, 1048576), (131072, 4194304))
#: ``cuda-dense``'s scales (its edge dimension is N^2): E x4, N x2.
DENSE_SCALES: tuple[int, ...] = (2048, 4096)
#: Ranks the sharded composites run on.
MEM_RANKS = 2
#: Steps a measured converge runs (tol 0).
MEM_STEPS = 3
#: Rules only a measurement on the card can judge.
MEASURED_RULES = ("shard-replicated-edges", "o-e-live-temporary", "host-staging-over-cap")


def _finding(rule: str, message: str, backend: str | None = None,
             file: str | None = None, line: int | None = None,
             severity: str = "error") -> Finding:
    return Finding(
        pass_name="memory", rule=rule, severity=severity, message=message,
        backend=backend, file=file, line=line,
    )


@dataclass
class MemCase:
    """One backend's converge measured at one scale."""

    backend: str
    #: n, edges, n_segments, n_rows, n_shards (the budget's dimensions).
    dims: dict[str, int]
    resident_bytes: int
    transient_bytes: int
    #: The largest fresh allocation: bytes, op, file, line, function.
    largest: dict[str, Any] | None = None
    #: Each device-to-host copy: bytes, op, file, line, function.
    host_transfers: list[dict[str, Any]] = field(default_factory=list)
    source: str = "card"
    meta: dict[str, Any] = field(default_factory=dict)


def pod_budget_view(
    budget: MemBudget,
    *,
    n: int,
    edges: int,
    n_segments: int,
    rows: int,
    n_shards: int,
    n_hosts: int = 1,
) -> dict:
    """The per-shard allowance at a pod scale: ``n_shards`` is the
    GLOBAL shard count (``n_hosts`` x local devices), ``n_segments`` and
    ``rows`` the per-host plan's — pod partitioning divides the edge set
    per host before the local device cut, so the resident edge term
    divides by the global shard count while the replicated-vector terms
    stay O(N) per device.  ``check_mem_case`` records the 2-host
    projection of every sharded backend with it."""
    resident = budget.max_resident(n, edges, n_segments, rows, n_shards)
    transient = budget.max_transient(n, n_segments, rows)
    return {
        "n_hosts": n_hosts,
        "n_shards": n_shards,
        "resident_bytes": resident,
        "transient_bytes": transient,
        "peak_bytes": resident + transient,
    }


def check_mem_case(budget: MemBudget, case: MemCase) -> tuple[list[Finding], dict]:
    """Judge one backend at one scale against its memory budget.
    Returns ``(findings, scale record)`` for the ``memory`` section."""
    findings: list[Finding] = []
    dims = case.dims
    n = dims.get("n", 0)
    edges = dims.get("edges", 0)
    segs = dims.get("n_segments", 0)
    rows = dims.get("n_rows", 0)
    shards = dims.get("n_shards", 1)
    scale = f"N={n}/E={edges}"
    max_resident = budget.max_resident(n, edges, segs, rows, shards)
    max_transient = budget.max_transient(n, segs, rows)

    if case.resident_bytes > max_resident:
        findings.append(_finding(
            "shard-replicated-edges",
            f"resident bytes {case.resident_bytes} at {scale} exceed the "
            f"E/n_shards-scaled allowance of {max_resident:.0f} B "
            f"(resident_edge_bytes={budget.resident_edge_bytes}/{shards} shards, "
            f"resident_n={budget.resident_n}, resident_segments="
            f"{budget.resident_segments}, resident_rows={budget.resident_rows}) — "
            "an edge-sized operand is replicated instead of sharded",
            case.backend,
        ))
    if case.transient_bytes > max_transient:
        site = case.largest or {}
        where = (
            f"{site.get('bytes', '?')} B {site.get('op', '')} in {site.get('function')}"
            if site else "?"
        )
        findings.append(_finding(
            "o-e-live-temporary",
            f"transient live bytes {case.transient_bytes} at {scale} exceed the "
            f"N/n_segments/rows-linear allowance of {max_transient:.0f} B "
            f"(transient_n={budget.transient_n}, transient_segments="
            f"{budget.transient_segments}, transient_rows={budget.transient_rows}, "
            f"transient_const={budget.transient_const}) — an edge-scale buffer is "
            f"live beyond the resident arguments; largest temp: {where}",
            case.backend, site.get("file"), site.get("line"),
        ))
    cap = budget.staging_cap(n)
    for t in case.host_transfers:
        if t["bytes"] > cap:
            findings.append(_finding(
                "host-staging-over-cap",
                f"device-to-host {t['op']} of {t['bytes']} B in {t.get('function')} at "
                f"{scale}, over the staging cap of {cap:.0f} B — edge-scale bytes "
                "crossing to the host inside a converge",
                case.backend, t.get("file"), t.get("line"),
            ))

    record = {
        "scale": scale,
        "dims": dims,
        "source": case.source,
        "measured": {
            "resident_bytes": case.resident_bytes,
            "transient_bytes": case.transient_bytes,
            "peak_bytes": case.resident_bytes + case.transient_bytes,
            "largest": case.largest,
        },
        "budget_resident_bytes": max_resident,
        "budget_transient_bytes": max_transient,
        "budget_peak_bytes": max_resident + max_transient,
        "staging_cap_bytes": cap,
        "host_transfers": case.host_transfers,
        "violations": len(findings),
        **({"meta": case.meta} if case.meta else {}),
    }
    if shards > 1:
        # The same budget with the shard count a 2-host pod doubles to:
        # the edge term halves per shard, everything O(N) stays.
        record["pod_projection"] = pod_budget_view(
            budget, n=n, edges=edges, n_segments=segs, rows=rows,
            n_shards=shards * 2, n_hosts=2,
        )
    return findings, record


def judge_peak(
    backend: str,
    dims: dict[str, int],
    *,
    resident_bytes: int,
    transient_bytes: int,
    largest: dict[str, Any] | None = None,
) -> tuple[list[Finding], dict]:
    """A peak measured elsewhere held to ``backend``'s formulas, through
    the pass's waivers: ``(live findings, record)``, the record carrying
    the waived findings and the margins (budget less measured)."""
    budget = MEM_INVARIANTS[backend]
    case = MemCase(backend, dims, resident_bytes, transient_bytes, largest, source="headline")
    findings, record = check_mem_case(budget, case)
    live, waived, _ = apply_waivers(findings, MEM_WAIVERS, "memory", judged=())
    record["waived"] = waived
    record["resident_margin_bytes"] = record["budget_resident_bytes"] - resident_bytes
    record["transient_margin_bytes"] = record["budget_transient_bytes"] - transient_bytes
    return live, record


def measure_case(case, steps: int = MEM_STEPS) -> MemCase:
    """``case``'s converge entry (``cases.BackendCase``) measured on the
    card: one warm converge (libraries, workspaces), then one from a
    reset peak, under the op recorder.  The caching allocator keeps its
    statistics on the host as it serves each tensor, so they need no
    device sync."""
    import torch

    from ..record import record_ops

    dev = case.t.device
    case.converge(steps, 0.0)
    gc.collect()
    base = torch.cuda.memory_allocated(dev)
    base_requested = torch.cuda.memory_stats(dev)["requested_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats(dev)
    out, rec = record_ops(case.converge, steps, 0.0)
    peak = torch.cuda.max_memory_allocated(dev)
    peak_requested = torch.cuda.memory_stats(dev)["requested_bytes.all.peak"]
    del out
    big = rec.largest()
    return MemCase(
        backend=case.backend,
        dims=dict(case.dims),
        resident_bytes=case.resident_bytes,
        transient_bytes=int(peak_requested - base_requested),
        largest=None if big is None else {
            "bytes": big.out_bytes, "op": big.op, "file": big.file, "line": big.line,
            "function": big.function,
        },
        host_transfers=[
            {"bytes": r.host_bytes, "op": r.op, "file": r.file, "line": r.line,
             "function": r.function}
            for r in rec.host_syncs
        ],
        meta={"baseline_bytes": int(base), "peak_bytes": int(peak),
              "allocated_transient_bytes": int(peak - base), **case.meta},
    )


def _scale_graphs(scales):
    from ..cases import step_graph

    return [step_graph(n, e, seed=3) for n, e in scales]


def sharded_rank(mesh, scales, kernels) -> dict:
    """A rank program (``run_ranks``): each sharded composite measured
    on this rank at each scale.  Returns the ``MemCase`` fields of each
    (``cases``) and the rank's kernel launches (``launches``)."""
    from ..cases import build_case, launch_counts

    out = []
    for graph in _scale_graphs(scales):
        for kernel in kernels:
            case = build_case(f"cuda-sharded:{kernel}", graph, mesh.device)
            out.append(measure_case(case).__dict__)
            del case
    return {"cases": out, "launches": launch_counts()}


class RankRun:
    """The sharded composites measured on their ranks (``run_ranks``,
    gloo), started in a thread so the ranks run beside other work; each
    process reads its own allocator.  ``result()`` joins it."""

    def __init__(self, device):
        from ..cases import card_backends
        from ...parallel.launch import run_ranks

        kernels = [n.partition(":")[2] for n in card_backends()
                   if n.startswith("cuda-sharded:")]
        self._out: dict[str, Any] = {}

        def launch():
            try:
                self._out["ranks"] = run_ranks(MEM_RANKS, sharded_rank, MEM_SCALES, kernels,
                                               backend="gloo", device=str(device),
                                               timeout_s=600) if kernels else []
            except BaseException as exc:  # noqa: BLE001 - raised in result()
                self._out["error"] = exc

        self._thread = threading.Thread(target=launch, name="memory-ranks")
        self._thread.start()

    def result(self) -> list[dict]:
        """Each rank's ``{"cases": [...], "launches": {...}}``."""
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["ranks"]


def measure_all(device, ranked: RankRun | None = None) -> tuple[list[MemCase], list[dict]]:
    """Every card backend measured at every scale on ``device`` (a card),
    the sharded composites on their ranks (``ranked``, started here when
    not given) beside the single-device measurements.  Returns the cases
    and each rank's kernel launches."""
    from ..cases import build_case, card_backends, step_graph

    names = card_backends()
    cases: list[MemCase] = []
    if ranked is None:
        ranked = RankRun(device)
    for n in DENSE_SCALES:
        cases.append(measure_case(build_case("cuda-dense", step_graph(n, 8 * n, seed=3), device)))
    for graph in _scale_graphs(MEM_SCALES):
        for name in ("cuda-sparse", "cuda-csr", "cuda-windowed"):
            if name in names:
                case = build_case(name, graph, device)
                cases.append(measure_case(case))
                del case
                gc.collect()
    rank_launches = []
    for rank in ranked.result():
        cases.extend(MemCase(**fields) for fields in rank["cases"])
        rank_launches.append(rank["launches"])
    return cases, rank_launches


def summed_budget(label: str, names) -> MemBudget:
    """One ``MemBudget`` whose every coefficient is the sum of ``names``'
    (a call that two registry names share is judged against both)."""
    budgets = [MEM_INVARIANTS[n] for n in names]
    coefficients = {f.name: sum(getattr(b, f.name) for b in budgets)
                    for f in dataclasses.fields(MemBudget) if f.type == "float"}
    return MemBudget(label, notes=" | ".join(b.notes for b in budgets if b.notes), **coefficients)


def measure_zk(recipe) -> MemCase:
    """A graft kernel recipe (``zk_lowering.ZkRecipe``) measured on the
    card as ``measure_case`` measures a converge: its arguments resident,
    its call's requested peak transient."""
    from ..cases import BackendCase

    case = BackendCase(recipe.label, {"n": recipe.lanes, "n_shards": 1}, recipe.args,
                       recipe.args[0], lambda t: t, lambda steps, tol: recipe.call(),
                       meta={"lanes": recipe.lanes})
    return measure_case(case)


def run_zk_memory(device) -> tuple[list[Finding], dict[str, Any], dict[str, list[dict]]]:
    """Each graft kernel recipe at both ``ZK_LANES`` sizes on ``device``:
    on the card measured (``measure_zk``) and judged against its names'
    summed ``MemBudget``; anywhere, the collective counters read around
    the call and judged against each name's ``CommBudget``.  Returns
    ``(findings, {name: memory section entry}, {name: comm records})``."""
    import torch

    from ..budget import COMM_INVARIANTS
    from ..cases import host_threads
    from ..comm.checker import judge_zk_collectives, read_counters, reset_counters
    from ..zk_lowering import ZK_LANES, kernel_recipes

    device = torch.device(device)
    on_card = device.type == "cuda"
    findings: list[Finding] = []
    backends: dict[str, Any] = {}
    comm: dict[str, list[dict]] = {}
    with host_threads(device):
        for lanes in ZK_LANES:
            for recipe in kernel_recipes(device, lanes):
                names = [n for n in recipe.kernels if n in MEM_INVARIANTS]
                reset_counters()
                if on_card:
                    measured = measure_zk(recipe)
                else:
                    recipe.call()
                found, recs = judge_zk_collectives(recipe.label, recipe.kernels, lanes,
                                                   read_counters())
                findings.extend(found)
                for name, rec in recs.items():
                    comm.setdefault(name, []).append(rec)
                record = None
                if on_card and names:
                    budget = summed_budget(recipe.label, names)
                    found, record = check_mem_case(budget, measured)
                    findings.extend(found)
                    record["recipe"] = recipe.label
                for name in recipe.kernels:
                    entry = backends.setdefault(name, {
                        "status": "checked" if name in MEM_INVARIANTS else "undeclared",
                        "recipe": recipe.label, "scales": [], "violations": 0,
                        "shared_with": [n for n in recipe.kernels if n != name],
                    })
                    if record is not None:
                        entry["scales"].append(record)
                        entry["violations"] += record["violations"]
    for name, entry in backends.items():
        entry["collectives"] = sum(sum(r["calls_per_step"].values()) for r in comm.get(name, ()))
        entry["comm_violations"] = sum(r["violations"] for r in comm.get(name, ()))
        if name in MEM_INVARIANTS:
            entry["budget"] = {k: v for k, v in MEM_INVARIANTS[name].__dict__.items()
                               if k != "backend"}
        if name in COMM_INVARIANTS:
            entry["comm_budget"] = {"calls_per_step": COMM_INVARIANTS[name].calls_per_step,
                                    "bytes_n": COMM_INVARIANTS[name].bytes_n}
        if not on_card:
            entry["not_run"] = list(MEASURED_RULES)
            entry["reason"] = "peak memory is measured on the card; the collectives were counted"
    return findings, backends, comm


def run_memory_pass(device, ranked: RankRun | None = None, zk: bool = False
                    ) -> tuple[list[Finding], dict[str, Any]]:
    """The measured leg on the card (``device`` a card; ``ranked``, the
    sharded ranks if the caller started them early) or its report as not
    run (``device="cpu"``), with ``zk`` the graft kernels' leg
    (``run_zk_memory``; its comm records in the section's ``zk_comm``),
    then the AST leg, through ``MEM_WAIVERS``.  Returns ``(findings,
    memory section)``."""
    import torch

    from ..ast_rules import MEM_AST_RULES, run_mem_ast_pass
    from ..cases import card_backends

    device = torch.device(device)
    findings: list[Finding] = []
    section: dict[str, Any] = {"device": str(device), "backends": {}}
    names = card_backends()
    judged = set(MEM_AST_RULES)
    if device.type == "cuda":
        judged |= set(MEASURED_RULES)
        by_backend: dict[str, list] = {}
        cases, section["rank_launches"] = measure_all(device, ranked=ranked)
        for case in cases:
            budget = MEM_INVARIANTS.get(case.backend)
            if budget is None:
                continue  # the step leg's registry gate reports it
            case_findings, record = check_mem_case(budget, case)
            findings.extend(case_findings)
            by_backend.setdefault(case.backend, []).append(record)
        for name in names:
            records = by_backend.get(name, [])
            section["backends"][name] = {
                "status": "checked" if records else "undeclared",
                "scales": records,
                "violations": sum(r["violations"] for r in records),
            }
    else:
        for name in names:
            section["backends"][name] = {
                "status": "not-run",
                "reason": "peak memory is measured on the card",
                "not_run": list(MEASURED_RULES),
            }
    for name in names:
        budget = MEM_INVARIANTS.get(name)
        if budget is not None:
            section["backends"][name]["budget"] = {
                k: v for k, v in budget.__dict__.items() if k != "backend"
            }
    if zk:
        zk_findings, zk_backends, section["zk_comm"] = run_zk_memory(device)
        findings.extend(zk_findings)
        section["backends"].update(zk_backends)
    ast_findings, n_files = run_mem_ast_pass()
    findings.extend(ast_findings)
    section["files_scanned"] = n_files
    live, waived, stale = apply_waivers(findings, MEM_WAIVERS, "memory", judged=judged)
    section["waived"] = waived
    section["stale_waivers"] = stale
    return live, section


__all__ = [
    "DENSE_SCALES",
    "MEASURED_RULES",
    "MEM_SCALES",
    "MemCase",
    "RankRun",
    "check_mem_case",
    "judge_peak",
    "measure_all",
    "measure_case",
    "measure_zk",
    "pod_budget_view",
    "run_memory_pass",
    "run_zk_memory",
    "summed_budget",
]
