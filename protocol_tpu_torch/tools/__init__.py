"""The port's acceptance drivers: programs that run the node through its
own entry points, in child processes or over HTTP, and hold it to its
guarantees.

- ``crash_matrix``: kill the node at every registered fault point and
  prove that it recovers every acknowledged attestation to the fixed
  point an uncrashed run reaches (``python -m
  protocol_tpu_torch.tools.crash_matrix``);
- ``obs_dryrun``: one node over HTTP, its observability surface scraped
  and every SLO objective held green (``python -m
  protocol_tpu_torch.tools.obs_dryrun``);
- ``divergence_probe``: the 2-host churned pod replay run twice under
  perturbed schedules (hash seed, thread count, launch order, fleet
  scrape interleaving), every durability sink, score and proof
  bit-identical across the runs; ``--seed-divergence`` must exit 1
  (``python -m protocol_tpu_torch.tools.divergence_probe``);
- ``epoch_pipe``: churned epochs through ``EpochPipeline`` on
  ``cuda-windowed``, each warm one in fewer iterations than the cold one
  on a delta plan, no tick dropped, the warm fixed point on the cold one
  (``python -m protocol_tpu_torch.tools.epoch_pipe``).

They keep clocks and spawn processes, so they live outside the kernel
trees (``analysis/ast_rules.py::KERNEL_TREES``).  The sharded and pod
dry runs (``parallel/dryrun.py``, ``parallel/dryrun_pod.py``) and their
launcher (``parallel/launch.py``) are to move here as well (ROADMAP
A13); they stay where they are for now.

Every driver runs on the card unless ``--device cpu`` asks for the plain
versions, and raises where there is no card and no ``--device cpu``.
"""

from __future__ import annotations

import subprocess


def card_name_and_limit(device: str) -> str | None:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, for
    a run on ``cuda``; None for a run on the CPU."""
    if device != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    return out.stdout.strip() or None


__all__ = ["card_name_and_limit"]
