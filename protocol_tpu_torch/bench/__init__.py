"""Probes of the card, ported from the reference's ``bench/`` scripts.

- ``probe_mosaic_gather``: in-block gather (K2) and transpose (K3)
  kernels at the reference probe's shapes, and the random-gather rate
  of ``t[idx]`` against table size.
- ``probe_fused_primitives``: the region-table windowed gather (K4) and
  the fused pipeline's two 268 MB transposes.
- ``yardsticks``: the earlier forms of the block-total scan (K6) and the
  pointer tail (K8), and an empty kernel, which ``chip_smoke.py`` times
  beside the port's kernels.

Importing a probe module runs nothing; each has ``run(device=None)``,
which returns one record per measurement, and a ``main()`` that prints
them as JSON lines (``python -m protocol_tpu_torch.bench.<probe>``).
"""
