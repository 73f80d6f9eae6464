"""CLI: ``python -m protocol_tpu_torch.analysis`` — run graftlint on the port.

    python -m protocol_tpu_torch.analysis [--pass all|step|ast|concurrency|comm|memory|determinism ...]
        [--device cuda|cpu] [--zk] [--fixture NAME] [--list-fixtures] [--output PATH]

Exit code 0 iff no unwaived error-severity finding; writes
``ANALYSIS.json`` (``--output``).  ``--pass`` may be given more than
once.  The AST passes (``ast``, ``concurrency``) need no device.  The
runtime legs (``step``, ``comm``, ``memory``, ``determinism``) run on
the card unless ``--device cpu`` is given; with no card and no
``--device cpu`` they raise — nothing falls back.  With ``--device cpu``
they judge what the plain path can show and report the card-only rules
as not run (``summary.not_run``), never as passed.

``--zk`` extends the runtime legs to the graft prover's kernels
(``zk.graft``, ``zk_lowering``'s recipes), as the reference's ``--zk``
extends its compile passes: the step leg records each recipe's ops, the
memory leg measures each kernel recipe at 1,024 and 2,048 lanes and
counts its collectives (the comm section lists them), the determinism
leg replays each recipe here and in the fresh process.  It is opt-in
because K13's plain version takes ~8 s a call on the CPU, so the leg
adds about a minute and a half there; the registry gate covers the
graft kernels' budgets in every run.

``--fixture`` runs one seeded violation instead of the real tree; it
exits 1 when the violation is caught (the gate's self-check), 3 when
the fixture's rule needs the card and ``--device cpu`` was given (not
run), and 2 for an unknown name.
"""

from __future__ import annotations

import argparse
import sys
import time

PASSES = ("step", "ast", "concurrency", "comm", "memory", "determinism")
#: Passes that run code on a device.
RUNTIME_PASSES = ("step", "comm", "memory", "determinism")
#: Exit code of a fixture that could not run on the device given.
NOT_RUN = 3


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m protocol_tpu_torch.analysis",
        description="graftlint: the port's step, AST, concurrency, comm, memory and "
        "determinism analyzers",
    )
    parser.add_argument("--output", default="ANALYSIS.json",
                        help="machine-readable report path (default: %(default)s)")
    parser.add_argument("--pass", dest="passes", action="append",
                        choices=("all",) + PASSES,
                        help="pass(es) to run, repeatable (default: all)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="device of the runtime legs (default: the card)")
    parser.add_argument(
        "--zk", action="store_true",
        help="extend the runtime legs (step, comm, memory, determinism) to the zk.graft "
        "proving kernels; on the CPU their plain versions add about a minute and a half, so "
        "only a run that asks covers them (the registry gate always covers their budgets)",
    )
    parser.add_argument("--fixture", default=None,
                        help="run one seeded violation fixture instead of the real tree")
    parser.add_argument("--list-fixtures", action="store_true",
                        help="list fixture names and exit")
    args = parser.parse_args(argv)

    from .. import resolve_device
    from .report import Report

    report = Report()

    if args.list_fixtures:
        from .fixtures import FIXTURES

        for name, fixture in sorted(FIXTURES.items()):
            where = "card" if fixture.card_only else "any device"
            print(f"{name}: expects {fixture.rule} ({fixture.kind}, {where})")
        return 0

    if args.fixture is not None:
        from .fixtures import FIXTURES, RUNTIME_KINDS, run_fixture

        fixture = FIXTURES.get(args.fixture)
        if fixture is None:
            print(
                f"unknown fixture {args.fixture!r}; available: {', '.join(sorted(FIXTURES))}",
                file=sys.stderr,
            )
            return 2
        device = resolve_device(args.device) if fixture.kind in RUNTIME_KINDS else None
        findings = run_fixture(args.fixture, device) if device is not None else run_fixture(
            args.fixture
        )
        report.device = None if device is None else str(device)
        if findings is None:
            report.not_run[fixture.kind] = [fixture.rule]
            report.backends[f"fixture:{args.fixture}"] = {"status": "not-run"}
            report.write_json(args.output)
            print(report.render())
            return NOT_RUN
        report.extend(findings)
        report.backends[f"fixture:{args.fixture}"] = {"status": "fixture"}
        report.write_json(args.output)
        print(report.render())
        return report.exit_code

    passes = set(PASSES) if not args.passes or "all" in args.passes else set(args.passes)
    device = resolve_device(args.device) if passes & set(RUNTIME_PASSES) else None
    report.device = None if device is None else str(device)
    on_card = device is not None and device.type == "cuda"
    if device is not None:
        from .cases import launch_counts, launches_since

        before = launch_counts()
    # On the card the other processes the runtime legs need (the memory
    # ranks, the fresh replay process) start first and run beside the
    # step leg; on the CPU they would contend for the cores.
    early: dict = {}
    if on_card and "memory" in passes:
        from .memory.checker import RankRun

        early["memory"] = RankRun(device)
    if on_card and "determinism" in passes:
        from .determinism.checker import start_fresh_process

        early["determinism"] = start_fresh_process(str(device), args.zk)

    def timed(name, run):
        t0 = time.perf_counter()
        findings, section = run()
        report.seconds[name] = time.perf_counter() - t0
        report.extend(findings)
        return section

    if "step" in passes:
        from .step import CARD_RULES, ZK_CARD_RULES, run_step_pass

        section = timed("step", lambda: run_step_pass(device, zk=args.zk))
        report.backends.update(section.pop("backends"))
        report.step = section
        if not on_card:
            report.not_run["step"] = list(CARD_RULES) + (list(ZK_CARD_RULES) if args.zk else [])
    if "ast" in passes:
        from .ast_rules import run_ast_pass

        report.ast = timed("ast", run_ast_pass)
        report.files_scanned = report.ast["files_scanned"]
    if "concurrency" in passes:
        from .concurrency import run_concurrency_pass

        report.concurrency = timed("concurrency", run_concurrency_pass)
    if "comm" in passes:
        from .comm import run_comm_pass

        report.comm = timed("comm", lambda: run_comm_pass(device))
    if "memory" in passes:
        from .memory import run_memory_pass
        from .memory.checker import MEASURED_RULES

        report.memory = timed(
            "memory", lambda: run_memory_pass(device, early.get("memory"), zk=args.zk))
        if not on_card:
            report.not_run["memory"] = list(MEASURED_RULES)
        if "rank_launches" in report.memory:
            report.launches["memory_ranks"] = report.memory["rank_launches"]
    if args.zk and "comm" in passes:
        # The graft kernels' collectives: counted by the memory leg when it
        # ran, else here.
        from .comm.checker import run_zk_comm

        t0 = time.perf_counter()
        findings, zk_comm = run_zk_comm(device, report.memory.get("zk_comm"))
        report.extend(findings)
        report.comm["backends"].update(zk_comm)
        report.seconds["comm"] += time.perf_counter() - t0
    if "determinism" in passes:
        from .determinism import run_determinism_pass

        report.determinism = timed(
            "determinism",
            lambda: run_determinism_pass(device, early.get("determinism"), zk=args.zk))
        report.launches["fresh_process"] = report.determinism["fresh_process_launches"]
    if device is not None:
        report.launches["this_process"] = launches_since(before)

    report.write_json(args.output)
    print(report.render())
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
