"""Findings and the machine-readable ``ANALYSIS.json`` report.

Every analyzer pass emits :class:`Finding` records with ``file:line``
anchors where it has one; :class:`Report` aggregates them, renders the
human summary and serializes the JSON artifact.  Exit-code policy: any
``error``-severity finding that no waiver covers fails the gate.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

SEVERITIES = ("error", "warning", "info")


@dataclass(frozen=True)
class Finding:
    """One analyzer finding, anchored to source where possible."""

    pass_name: str  # "step" | "ast" | "concurrency" | "comm" | "memory" | "determinism"
    rule: str  # stable rule id, e.g. "random-gather-budget"
    severity: str  # "error" | "warning" | "info"
    message: str
    file: str | None = None
    line: int | None = None
    backend: str | None = None

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    @property
    def anchor(self) -> str:
        if self.file is None:
            return "<no source>"
        return f"{self.file}:{self.line}" if self.line else self.file

    def render(self) -> str:
        who = f" [{self.backend}]" if self.backend else ""
        return f"{self.severity}: {self.anchor}{who} {self.rule}: {self.message}"

    def to_dict(self) -> dict[str, Any]:
        return {
            "pass": self.pass_name,
            "rule": self.rule,
            "severity": self.severity,
            "message": self.message,
            "file": self.file,
            "line": self.line,
            "backend": self.backend,
        }


@dataclass
class Report:
    """Aggregated analysis result."""

    findings: list[Finding] = field(default_factory=list)
    #: Per-backend bookkeeping from the step leg: the declared budget,
    #: what one step dispatched, and on the card its capture and replay.
    backends: dict[str, dict[str, Any]] = field(default_factory=dict)
    #: The device the runtime legs ran on ("cuda", "cpu"; None: none ran).
    device: str | None = None
    #: The step leg's registry gate and device.
    step: dict[str, Any] = field(default_factory=dict)
    #: Files scanned by pass 2.
    files_scanned: int = 0
    #: Pass 2's traced table, waived findings and stale waivers.
    ast: dict[str, Any] = field(default_factory=dict)
    #: Pass-7 whole-program concurrency section: execution roots, the
    #: inferred guard map, the lock-order graph, and the enumerated
    #: waiver list (analysis/concurrency/).
    concurrency: dict[str, Any] = field(default_factory=dict)
    #: Pass-8 communication section: per-backend, per-rank all-reduce
    #: calls and bytes a step at each scale, and the comm waiver list
    #: (analysis/comm/).
    comm: dict[str, Any] = field(default_factory=dict)
    #: Pass-12 peak-memory section: per-backend resident/transient bytes
    #: measured at each scale against the MEM_INVARIANTS allowances,
    #: host transfers, and the memory waiver list (analysis/memory/).
    memory: dict[str, Any] = field(default_factory=dict)
    #: Pass-13 determinism section: per-backend replay digests in this
    #: process and a fresh one, the kernels' atomics scan, AST files
    #: scanned, and the determinism waiver list (analysis/determinism/).
    determinism: dict[str, Any] = field(default_factory=dict)
    #: Rules this run could not judge on its device (card-only rules
    #: with ``--device cpu``), by pass: not run, never passed.
    not_run: dict[str, list[str]] = field(default_factory=dict)
    #: Wall seconds of each pass.
    seconds: dict[str, float] = field(default_factory=dict)
    #: Converge-kernel launches of the runtime legs, by wrapper: in this
    #: process, in the fresh replay process, and on each memory rank.
    launches: dict[str, Any] = field(default_factory=dict)

    def extend(self, findings: list[Finding]) -> None:
        self.findings.extend(findings)

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def exit_code(self) -> int:
        return 1 if self.errors else 0

    def to_dict(self) -> dict[str, Any]:
        sev = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            sev[f.severity] += 1
        return {
            "version": 1,
            "tool": "protocol_tpu_torch.analysis (graftlint)",
            "device": self.device,
            "summary": {
                **sev,
                "backends_checked": len(self.backends),
                "files_scanned": self.files_scanned,
                "not_run": self.not_run,
            },
            "seconds": self.seconds,
            "launches": self.launches,
            "backends": self.backends,
            "step": self.step,
            "ast": self.ast,
            "concurrency": self.concurrency,
            "comm": self.comm,
            "memory": self.memory,
            "determinism": self.determinism,
            "findings": [f.to_dict() for f in self.findings],
        }

    def write_json(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2) + "\n")

    def render(self) -> str:
        lines = [f.render() for f in self.findings]
        sev = {s: sum(1 for f in self.findings if f.severity == s) for s in SEVERITIES}
        lines.append(
            f"analysis: {len(self.backends)} backends / "
            f"{self.files_scanned} files scanned — "
            f"{sev['error']} error(s), {sev['warning']} warning(s), "
            f"{sev['info']} info"
        )
        for pass_name, rules in sorted(self.not_run.items()):
            lines.append(f"not run on {self.device} ({pass_name}): {', '.join(rules)}")
        return "\n".join(lines)


__all__ = ["Finding", "Report", "SEVERITIES"]
