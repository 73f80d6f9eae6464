"""Pass 8 — the communication analyzer, on ranks.

The reference compiles each sharded composite under its 8-device CPU
mesh and walks the partitioned HLO for collectives.  The port's
composites are SPMD processes (``parallel/sharded.py``), so this pass
runs them: ``run_ranks`` starts ``COMM_RANKS`` ranks on the device the
caller names (gloo; on the CPU in the tests), each converges both
sharded composites for ``COMM_STEPS`` steps at the reference's two
``COMM_SCALES`` (E x4 while N x2), and reads the counters of the one
collective wrapper, ``all_reduce_sum`` (``calls``, ``bytes``,
``subgroup_calls``).  Each rank's record is judged against the
composite's ``COMM_INVARIANTS`` budget:

- **collective-count** — all-reduces a step, by wrapper, other than the
  budget's ``calls_per_step``;
- **comm-bytes-budget** — bytes a step over ``bytes_n * N``: the budget
  has no edge term;
- **comm-bytes-scaling** — bytes a step growing faster than N from the
  first scale to the second, where E grew 4x: an O(E) volume cannot
  hide in a constant;
- **replica-group-coverage** — an all-reduce over a sub-group of the
  ranks: it completes only the rows of that sub-group.

Under ``--zk`` the pass also lists each graft kernel
(``zk.graft.ZK_KERNELS``), single-device by construction, held to its
``CommBudget`` of no collective: the counters read around each of
``zk_lowering``'s kernel recipes at both of its sizes, by the memory
pass when it ran (``memory.checker.run_zk_memory``), else here, in this
process (``run_zk_comm``).

The reference's host-round-trip and donation rules have no counterpart:
gloo stages a CUDA all-reduce through the host by design, and torch
donates no buffer (ROADMAP §C).  Findings route through the enumerated,
stale-tested ``waivers.COMM_WAIVERS``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..budget import COMM_INVARIANTS, CommBudget
from ..concurrency.waivers import apply_waivers
from ..report import Finding
from .waivers import COMM_WAIVERS

#: (n_peers, n_edges) per scale: E x4, N x2 between the two (the
#: reference's ``protocol_tpu/analysis/comm/lowering.py:30``).
COMM_SCALES: tuple[tuple[int, int], ...] = ((1024, 4096), (2048, 16384))
#: Ranks a comm run starts.
COMM_RANKS = 2
#: Steps each composite runs (tol 0).
COMM_STEPS = 2


def _finding(rule: str, message: str, backend: str | None = None,
             severity: str = "error") -> Finding:
    return Finding(pass_name="comm", rule=rule, severity=severity, message=message,
                   backend=backend)


@dataclass
class CommCase:
    """One rank's collectives over ``steps`` steps of one composite."""

    backend: str
    dims: dict[str, int]
    steps: int
    calls: dict[str, int]
    bytes: int
    subgroup_calls: int = 0
    rank: int = 0


def read_counters() -> dict[str, int]:
    from ...parallel.sharded import all_reduce_sum

    return {"calls": all_reduce_sum.calls, "bytes": all_reduce_sum.bytes,
            "subgroup_calls": all_reduce_sum.subgroup_calls}


def reset_counters() -> None:
    from ...parallel.sharded import all_reduce_sum

    all_reduce_sum.calls = all_reduce_sum.bytes = all_reduce_sum.subgroup_calls = 0


def counted(backend: str, dims: dict, steps: int, rank: int, fn) -> CommCase:
    """``fn()`` run between a reset and a read of ``all_reduce_sum``'s
    counters, as a ``CommCase`` of ``steps`` steps."""
    reset_counters()
    fn()
    c = read_counters()
    return CommCase(backend, dict(dims), steps, {"all_reduce_sum": c["calls"]}, c["bytes"],
                    c["subgroup_calls"], rank)


def comm_rank(mesh, scales, kernels, steps) -> list[dict]:
    """A rank program (``run_ranks``): each sharded composite converged
    ``steps`` steps at each scale on this rank, its collectives counted."""
    from ..cases import build_case, step_graph

    out = []
    for n, e in scales:
        graph = step_graph(n, e, seed=5)
        for kernel in kernels:
            case = build_case(f"cuda-sharded:{kernel}", graph, mesh.device)
            rec = counted(case.backend, case.dims, steps, mesh.rank,
                          lambda: case.converge(steps, 0.0))
            out.append(rec.__dict__)
    return out


def check_comm_case(budget: CommBudget, case: CommCase) -> tuple[list[Finding], dict]:
    """One rank at one scale against its budget: ``(findings, record)``."""
    findings = []
    n = case.dims.get("n", 0)
    scale = f"N={n}/E={case.dims.get('edges')}"
    per_step = {w: c / case.steps for w, c in case.calls.items()}
    expected = {w: float(budget.calls_per_step.get(w, 0)) for w in case.calls}
    if per_step != expected:
        findings.append(_finding(
            "collective-count",
            f"rank {case.rank} made {per_step} all-reduces a step at {scale}; the "
            f"budget declares {expected}",
            case.backend,
        ))
    bytes_step = case.bytes / case.steps
    allowed = budget.bytes_n * n
    if bytes_step > allowed:
        findings.append(_finding(
            "comm-bytes-budget",
            f"rank {case.rank} all-reduced {bytes_step:.0f} B a step at {scale}, over "
            f"the budget of {allowed:.0f} B (bytes_n={budget.bytes_n}); the budget has "
            "no term in E",
            case.backend,
        ))
    if case.subgroup_calls:
        findings.append(_finding(
            "replica-group-coverage",
            f"rank {case.rank} made {case.subgroup_calls} all-reduce(s) over a sub-group "
            f"at {scale}: a sub-group reduce completes only its own ranks' rows",
            case.backend,
        ))
    record = {
        "scale": scale,
        "dims": case.dims,
        "rank": case.rank,
        "steps": case.steps,
        "calls_per_step": per_step,
        "bytes_per_step": bytes_step,
        "budget_bytes_per_step": allowed,
        "subgroup_calls": case.subgroup_calls,
        "violations": len(findings),
    }
    return findings, record


def check_scaling(backend: str, first: CommCase, second: CommCase) -> list[Finding]:
    """Bytes a step may grow from ``first`` to ``second`` at most as N does."""
    b1, b2 = first.bytes / first.steps, second.bytes / second.steps
    n1, n2 = first.dims["n"], second.dims["n"]
    if b1 and b2 / b1 > n2 / n1 + 1e-9:
        return [_finding(
            "comm-bytes-scaling",
            f"bytes a step grew {b2 / b1:.2f}x from N={n1}/E={first.dims['edges']} to "
            f"N={n2}/E={second.dims['edges']}, where N grew {n2 / n1:.2f}x: the volume "
            "follows the edges",
            backend,
        )]
    return []


def judge(cases: list[CommCase]) -> tuple[list[Finding], dict[str, Any]]:
    """Every rank's records judged, by backend, and each rank's scaling."""
    findings: list[Finding] = []
    backends: dict[str, Any] = {}
    by_rank: dict[tuple[str, int], list[CommCase]] = {}
    for case in cases:
        budget = COMM_INVARIANTS.get(case.backend)
        if budget is None:
            backends[case.backend] = {"status": "undeclared"}
            findings.append(_finding(
                "undeclared-comm-budget",
                f"sharded backend {case.backend!r} declares no CommBudget", case.backend,
            ))
            continue
        case_findings, record = check_comm_case(budget, case)
        findings.extend(case_findings)
        entry = backends.setdefault(case.backend, {"status": "checked", "scales": []})
        entry["scales"].append(record)
        by_rank.setdefault((case.backend, case.rank), []).append(case)
    for (backend, _), ranked in by_rank.items():
        ranked.sort(key=lambda c: c.dims["n"])
        for a, b in zip(ranked, ranked[1:]):
            findings.extend(check_scaling(backend, a, b))
    for name, entry in backends.items():
        if name in COMM_INVARIANTS:
            b = COMM_INVARIANTS[name]
            entry["budget"] = {"calls_per_step": b.calls_per_step, "bytes_n": b.bytes_n,
                               "notes": b.notes}
    return findings, backends


def judge_zk_collectives(label: str, kernels, lanes: int, counters: dict[str, int]
                         ) -> tuple[list[Finding], dict[str, dict]]:
    """The collectives one graft recipe made (``read_counters`` around
    it) against the ``CommBudget`` of each registry name it stands for:
    ``(findings, {name: record})``."""
    findings: list[Finding] = []
    records: dict[str, dict] = {}
    for name in kernels:
        budget = COMM_INVARIANTS.get(name)
        if budget is None:
            continue  # the step leg's registry gate reports it
        case = CommCase(name, {"n": lanes, "n_shards": 1}, 1,
                        {"all_reduce_sum": counters["calls"]}, counters["bytes"],
                        counters["subgroup_calls"])
        found, record = check_comm_case(budget, case)
        findings.extend(found)
        records[name] = dict(record, recipe=label)
    return findings, records


def zk_section(records: dict[str, list[dict]], source: str) -> dict[str, dict]:
    """The comm section's entry of each graft kernel from its records."""
    return {
        name: {"status": "checked", "source": source, "scales": recs,
               "collectives": sum(sum(r["calls_per_step"].values()) for r in recs),
               "violations": sum(r["violations"] for r in recs),
               "budget": {"calls_per_step": COMM_INVARIANTS[name].calls_per_step,
                          "bytes_n": COMM_INVARIANTS[name].bytes_n,
                          "notes": COMM_INVARIANTS[name].notes}}
        for name, recs in records.items()
    }


def run_zk_comm(device, measured: dict[str, list[dict]] | None = None
                ) -> tuple[list[Finding], dict[str, dict]]:
    """Each graft kernel's collectives: ``measured``, the records the
    memory pass judged (``memory.checker.run_zk_memory``), or else each of
    ``zk_lowering``'s kernel recipes run here at both sizes between a
    reset and a read of the counters, on one rank (this process).
    Returns ``(findings, {name: comm section entry})``."""
    import torch

    from ..cases import host_threads
    from ..zk_lowering import ZK_LANES, kernel_recipes

    if measured is not None:
        return [], zk_section(measured, "memory")
    device = torch.device(device)
    findings: list[Finding] = []
    records: dict[str, list[dict]] = {}
    with host_threads(device):
        for lanes in ZK_LANES:
            for recipe in kernel_recipes(device, lanes):
                reset_counters()
                recipe.call()
                found, recs = judge_zk_collectives(recipe.label, recipe.kernels, lanes,
                                                   read_counters())
                findings.extend(found)
                for name, rec in recs.items():
                    records.setdefault(name, []).append(rec)
    return findings, zk_section(records, "comm")


def run_comm_pass(device) -> tuple[list[Finding], dict[str, Any]]:
    """Both sharded composites on ``COMM_RANKS`` gloo ranks of ``device``
    at each of ``COMM_SCALES``.  Returns ``(findings, comm section)``."""
    import torch

    from ...parallel.launch import run_ranks
    from ..cases import card_backends

    device = torch.device(device)
    kernels = [n.partition(":")[2] for n in card_backends() if n.startswith("cuda-sharded:")]
    per_rank = run_ranks(COMM_RANKS, comm_rank, COMM_SCALES, kernels, COMM_STEPS,
                         backend="gloo", device=str(device), timeout_s=600)
    cases = [CommCase(**fields) for rank_cases in per_rank for fields in rank_cases]
    findings, backends = judge(cases)
    live, waived, stale = apply_waivers(findings, COMM_WAIVERS, "comm")
    section = {
        "device": str(device), "ranks": COMM_RANKS, "steps": COMM_STEPS,
        "scales": [list(s) for s in COMM_SCALES], "backends": backends,
        "waived": waived, "stale_waivers": stale,
    }
    return live, section


__all__ = [
    "COMM_RANKS",
    "COMM_SCALES",
    "CommCase",
    "check_comm_case",
    "check_scaling",
    "comm_rank",
    "judge",
    "judge_zk_collectives",
    "run_comm_pass",
    "run_zk_comm",
    "zk_section",
]
