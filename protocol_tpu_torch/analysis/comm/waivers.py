"""Explicit pass-8 waivers — same doctrine as the pass-7 table
(``analysis/concurrency/waivers.py``): every suppression is enumerated
with its rationale, emitted into ANALYSIS.json, and **stale-tested** in
the default full run — a waiver that no longer matches a live finding
is itself an error (``stale-waiver``), so a fixed lowering takes its
waiver with it.

The table is empty: both sharded composites make exactly their
budget's one all-reduce of 4 N bytes a step over the whole group, at
both scales, and the first waiver added here should arrive with the
surprise it documents.
"""

from __future__ import annotations

from ..concurrency.waivers import Waiver

#: (rule, file substring, message substring) -> rationale — see
#: :class:`~protocol_tpu_torch.analysis.concurrency.waivers.Waiver`.
COMM_WAIVERS: tuple[Waiver, ...] = ()

__all__ = ["COMM_WAIVERS"]
