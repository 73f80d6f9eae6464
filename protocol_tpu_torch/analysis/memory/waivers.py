"""Explicit pass-12 waivers — same doctrine as the pass-7/pass-8
tables: every suppression is enumerated with its rationale, emitted
into ANALYSIS.json's ``memory.waived`` list, and **stale-tested** in
every run that evaluates its rule — a waiver that no longer matches a
live finding is itself an error (``stale-waiver``), so a fixed leak
takes its waiver with it.  A measured rule is evaluated on the card
only, so a run on the CPU cannot find its waiver stale.
"""

from __future__ import annotations

from ..concurrency.waivers import Waiver

#: (rule, file substring, message substring) -> rationale — see
#: :class:`~protocol_tpu_torch.analysis.concurrency.waivers.Waiver`.
MEM_WAIVERS: tuple[Waiver, ...] = (
    Waiver(
        rule="o-e-live-temporary",
        file="protocol_tpu_torch/ops/sparse.py",
        symbol="in gather_ds_cumsum",
        reason=(
            "K9 (gather_ds_cumsum.cu) writes the CSR and COO steps' block "
            "prefix as two float32 lanes of every padded edge, 8 B an edge "
            "(400 MB at 1M/50M), which K6 and K8 then read: an O(E) "
            "temporary that the transient budget, with no edge term, "
            "cannot express.  The windowed step has none.  ROADMAP B's "
            "converge speed item for K9 removes it: each block writes its "
            "prefix only at the row pointers that fall in it, so the lanes "
            "never leave the chip (K6's and K8's interfaces reopen)."
        ),
    ),
    Waiver(
        rule="unbounded-cache-growth",
        file="protocol_tpu_torch/node/manager.py",
        symbol="Manager._hash_cache",
        reason=(
            "The Poseidon pk-hash memo is bounded by the PEER SET, not "
            "by time: it holds exactly one entry per public key the "
            "node has ever verified, the same population (and the same "
            "lifetime) as the attestation cache that IS the graph.  "
            "Evicting it would re-pay 68 field-level Poseidon rounds "
            "per ingest of a known sender — the admission plane's "
            "hashing win exists to avoid exactly that.  The "
            "epoch-keyed caches this rule polices (cached_proofs / "
            "cached_results have ring eviction) leak with uptime; "
            "this one grows with the graph."
        ),
    ),
)

__all__ = ["MEM_WAIVERS"]
