"""Explicit pass-13 waivers — same doctrine as the pass-7/8/12 tables:
every suppression is enumerated with its rationale, emitted into
ANALYSIS.json's ``determinism.waived`` list, and **stale-tested** in
every run that evaluates the table — a waiver that no longer matches a
live finding is itself an error (``stale-waiver``), so a fixed
divergence source takes its waiver with it.
"""

from __future__ import annotations

from ..concurrency.waivers import Waiver

#: (rule, file substring, message substring) -> rationale — see
#: :class:`~protocol_tpu_torch.analysis.concurrency.waivers.Waiver`.
DET_WAIVERS: tuple[Waiver, ...] = (
    Waiver(
        rule="unseeded-rng",
        file="protocol_tpu_torch/node/ethereum.py",
        symbol="random.Random",
        reason=(
            "ChainEventSource's retry-backoff jitter RNG is unseeded on "
            "purpose: jitter exists to DE-correlate hosts (every host "
            "retrying an RPC on the same schedule is the thundering "
            "herd the backoff is there to break), so seeding it from "
            "the shared protocol seed would be the bug.  The draw "
            "feeds only sleep durations inside the retry loop — it "
            "never reaches a WAL record, checkpoint column, manifest, "
            "job seed, or partition key, which is the bit-identity "
            "plane this pass protects."
        ),
    ),
)

__all__ = ["DET_WAIVERS"]
