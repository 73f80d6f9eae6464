"""The determinism pass's replays: every card backend's converge of the
synthetic graph (``cases.step_graph``), digested; with ``--zk`` also
every graft recipe's output (``zk_lowering``, at ``RECORD_LANES``).

    python -m protocol_tpu_torch.analysis.determinism.replay --device cuda|cpu [--zk]

prints one JSON object: ``digests``, backend -> digest, from one
converge each in this (fresh) process, ``zk_digests``, recipe -> digest
(empty without ``--zk``), and this process's kernel ``launches``;
``checker.run_determinism_pass`` compares the digests with two runs of
its own.  The sharded composites run in a process group of one rank
(``cases.single_rank_group``).
"""

from __future__ import annotations

import argparse
import json
import sys


def converge_digests(device, runs: int = 1) -> dict:
    """``{backend: [digest, ...]}``: ``runs`` converges of each card
    backend on ``device`` (tol 1e-6, at most 30 steps), each digested."""
    import torch

    from ..cases import build_case, card_backends, host_threads, single_rank_group, step_graph
    from .checker import REPLAY_MAX_ITER, REPLAY_TOL, replay_in_process

    device = torch.device(device)
    names = card_backends()
    graph = step_graph()
    out: dict[str, list[str]] = {}

    def one(name):
        case = build_case(name, graph, device)
        out[name] = replay_in_process(
            lambda: case.converge(REPLAY_MAX_ITER, REPLAY_TOL), runs=runs
        )

    sharded = [n for n in names if n.startswith("cuda-sharded")]
    with host_threads(device):
        for name in names:
            if name not in sharded:
                one(name)
        if sharded:
            with single_rank_group(device):
                for name in sharded:
                    one(name)
    return out


def zk_digests(device, runs: int = 1) -> dict:
    """``{recipe label: [digest, ...]}``: ``runs`` calls of each graft
    recipe (the kernel recipes, then the entries) on ``device`` at
    ``RECORD_LANES`` lanes, from the same seed, each digested bit for bit."""
    import torch

    from ..cases import host_threads
    from ..zk_lowering import RECORD_LANES, digest_output, entry_recipes, kernel_recipes

    device = torch.device(device)
    out: dict[str, list[str]] = {}
    with host_threads(device):
        for recipe in kernel_recipes(device, RECORD_LANES) + entry_recipes(device, RECORD_LANES):
            out[recipe.label] = [digest_output(recipe.call()) for _ in range(runs)]
    return out


def main(argv: list[str] | None = None) -> int:
    from ..cases import launch_counts

    parser = argparse.ArgumentParser(
        prog="python -m protocol_tpu_torch.analysis.determinism.replay",
        description="digest each card backend's converge of the analyzers' synthetic graph "
        "(and with --zk each graft recipe's output)",
    )
    parser.add_argument("--device", required=True, choices=("cuda", "cpu"))
    parser.add_argument("--zk", action="store_true",
                        help="also digest every graft recipe's output")
    args = parser.parse_args(argv)
    digests = converge_digests(args.device, runs=1)
    zk = zk_digests(args.device, runs=1) if args.zk else {}
    print(json.dumps({"digests": {name: d[0] for name, d in digests.items()},
                      "zk_digests": {name: d[0] for name, d in zk.items()},
                      "launches": launch_counts()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
