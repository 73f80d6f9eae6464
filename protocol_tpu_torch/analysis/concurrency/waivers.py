"""Explicit pass-7 waivers — every suppression is enumerated and tested.

A waiver is a *documented* decision that a finding describes a design
the code makes safe by other means (GIL-atomic single-opcode ops,
boot-time-only writes, advisory counters).  The checker records every
match in the ANALYSIS.json ``concurrency.waived`` list, and
``tests/test_analysis.py`` asserts two invariants:

- zero **unwaived** findings on the real tree, and
- zero **stale** waivers (every entry below still matches a live
  finding — a fixed bug must take its waiver with it).

Matching is (rule, file substring, message substring) — the symbol
string names the class attribute or call site precisely enough that a
new, different bug in the same file cannot hide behind an old waiver.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Waiver:
    rule: str
    file: str  # substring of the repo-relative path
    symbol: str  # substring of the finding message (Class.attr / call)
    reason: str

    def matches(self, rule: str, file: str, message: str) -> bool:
        return (
            rule == self.rule and self.file in file and self.symbol in message
        )


def apply_waivers(
    findings: list, table: tuple[Waiver, ...], pass_name: str, judged=None
) -> tuple[list, list[dict], list[dict]]:
    """Split ``findings`` into (live, waived records, stale records) by
    ``table``; each stale waiver also joins the live findings as a
    ``stale-waiver`` error of ``pass_name`` (a fixed finding must take
    its waiver with it).  ``judged``, where given, names the rules this
    run evaluated: a waiver of another rule cannot be judged stale."""
    from ..report import Finding

    live, waived, matched = [], [], set()
    for f in findings:
        hit = next(
            ((i, w) for i, w in enumerate(table) if w.matches(f.rule, f.file or "", f.message)),
            None,
        )
        if hit is None:
            live.append(f)
        else:
            matched.add(hit[0])
            waived.append({
                "rule": f.rule, "file": f.file, "line": f.line,
                "symbol": hit[1].symbol, "reason": hit[1].reason,
            })
    stale = [
        {"symbol": w.symbol, "rule": w.rule, "reason": w.reason}
        for i, w in enumerate(table)
        if i not in matched and (judged is None or w.rule in judged)
    ]
    for entry in stale:
        live.append(Finding(
            pass_name=pass_name, rule="stale-waiver", severity="error",
            message=f"{pass_name} waiver {entry['symbol']!r} ({entry['rule']}) matches no "
            "live finding; a fixed finding must take its waiver with it",
        ))
    return live, waived, stale


WAIVERS: tuple[Waiver, ...] = (
    Waiver(
        rule="unguarded-shared-attr",
        file="protocol_tpu_torch/obs/journal.py",
        symbol="FlightRecorder._file",
        reason=(
            "record()/flush() read _file bare by design: the hot path "
            "must never take a lock (doctrine at the top of journal.py). "
            "_file only transitions between None and an open handle "
            "under _io_lock; a torn read sees one of the two valid "
            "states, and flush() re-checks under the lock before "
            "writing.  The witness stress test exercises this exact "
            "interleaving."
        ),
    ),
    Waiver(
        rule="unguarded-rmw",
        file="protocol_tpu_torch/utils/telemetry.py",
        symbol="TimerStats.",
        reason=(
            "TimerStats.record() mutates count/total, but every call "
            "site reaches it as `self.timers[name].record(...)` inside "
            "`with self._lock` on Telemetry — a cross-class guard the "
            "analyzer cannot see through a subscript receiver.  The "
            "lock-witness stress test watches these writes at runtime."
        ),
    ),
    Waiver(
        rule="unguarded-rmw",
        file="protocol_tpu_torch/zk/cs.py",
        symbol="ConstraintSystem.n_rows",
        reason=(
            "zk/ is not tree-confined (the prover pool shares it), "
            "but a ConstraintSystem is still *instance*-"
            "confined: each one is synthesized and consumed by exactly "
            "one prove path — one plane dispatcher thread, one worker "
            "process, or one /aggregate executor call — and never "
            "escapes it.  The genuinely shared zk state (the "
            "zk/native.py loader globals) grew a real lock instead.  "
            "The pooled-vs-inline bit-equality test would catch any "
            "cross-thread sharing regression as a torn row count."
        ),
    ),
    Waiver(
        rule="check-then-act",
        file="protocol_tpu_torch/zk/plonk.py",
        symbol="_CosetEvaluator._shift_pows",
        reason=(
            "Per-prove lazy memo: a _CosetEvaluator lives inside one "
            "prove() call (one dispatcher thread or worker process); "
            "the flag flip can never race because the instance never "
            "crosses a thread.  Same instance-confinement argument as "
            "ConstraintSystem.n_rows — recorded, not locked, to keep "
            "the MSM-adjacent hot path allocation-free."
        ),
    ),
    Waiver(
        rule="unguarded-shared-attr",
        file="protocol_tpu_torch/obs/lineage.py",
        symbol="LineageTracker._every",
        reason=(
            "maybe_begin() reads _every bare by design: it is the "
            "per-submission intake hot path (ingest plane submit), and "
            "the no-lock contract there mirrors the journal's record() "
            "doctrine.  _every is a single int flipped by configure() "
            "at node boot (and by tests); a torn read samples one "
            "period early or late — the sampled fraction is advisory, "
            "the entry table itself is fully lock-guarded."
        ),
    ),
    Waiver(
        rule="unguarded-rmw",
        file="protocol_tpu_torch/obs/journal.py",
        symbol="FlightRecorder._seq",
        reason=(
            "_seq is an advisory ordering hint (commented 'benign "
            "race'): a lost increment reorders two events' seq numbers "
            "but loses no event — the ring append is the source of "
            "truth.  Locking the hot record() path to fix a cosmetic "
            "counter would invert the recorder's no-block contract."
        ),
    ),
    Waiver(
        rule="unguarded-rmw",
        file="protocol_tpu_torch/zk/evm_verifier.py",
        symbol="_Gen.",
        reason=(
            "_Gen is the verifier codegen's emitter: generate_evm_verifier "
            "builds one per call and it never leaves that call (instance-"
            "confined, as ConstraintSystem.n_rows above).  It counts as "
            "multiroot only because the port keeps tools with main() "
            "roots inside the analyzed tree (parallel/dryrun.py, "
            "dryrun_pod.py, bench/), whose calls reach _Gen.emit by name; "
            "the reference keeps its tools outside its package.  ROADMAP "
            "A13 moves them out, and this waiver with them."
        ),
    ),
)


__all__ = ["WAIVERS", "Waiver", "apply_waivers"]
