"""Dense trust kernels on PyTorch.

Port of ``protocol_tpu/ops/dense.py``:

- ``converge_dense``: repeated ``opsᵀ·s``, the image of the
  reference's ``native()`` power iteration (circuit/src/circuit.rs:425-470)
  on a row-normalised matrix.
- ``filter_and_normalize`` + ``set_converge_dense``: the EigenTrustSet
  filter / redistribute / normalise semantics (circuit/src/native.rs:83-234)
  as data-parallel masks.

The reference computes the products with XLA ``dot_general`` under
``lax.scan``, outside any Pallas kernel, so no hand-written kernel
stands here (ROADMAP B12): each step is one ``torch.mv``, a matrix-vector
product, and the masks are plain tensor ops.  A matrix-vector product
goes to cuBLAS's ``gemv``, which has no TF32 path, so the steps run in
full float32 whatever ``torch.backends.cuda.matmul.allow_tf32`` or
``torch.set_float32_matmul_precision`` says (``chip_smoke.py`` holds a
converge with TF32 allowed bit-equal to one without).
"""

from __future__ import annotations

import torch


def converge_dense(ops_t: torch.Tensor, s0: torch.Tensor, num_iter: int) -> torch.Tensor:
    """``num_iter`` power-iteration steps ``s ← ops_t @ s``.

    ``ops_t`` is the transposed local-trust matrix; pass a
    column-stochastic matrix and a normalised ``s0`` for bounded
    dynamics.  ``s0`` is not written to."""
    s = s0
    for _ in range(num_iter):
        s = torch.mv(ops_t, s)
    return s


def filter_and_normalize(
    ops: torch.Tensor, match: torch.Tensor, set_valid: torch.Tensor
) -> torch.Tensor:
    """Vectorised ``filter_peers`` + credit normalisation
    (circuit/src/native.rs:146-234, 89-102), returning a row-stochastic
    matrix (zero rows for invalid peers).

    - ``ops[i, j]``: peer i's score for set slot j (aligned to set order
      by the caller; a mismatched slot has ``match[i, j] = False``).
    - ``match[i, j]``: the opinion's j-th public key equals set slot j's.
    - ``set_valid[i]``: slot i holds a real (non-null) member.

    A score is kept only where the key matches, the target slot is
    valid and it is not a self-score.  All-zero rows of valid peers
    redistribute evenly over the other valid slots.  Rows are then
    normalised to sum to 1."""
    n = ops.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=ops.device)
    valid_row = set_valid[:, None]
    valid_col = set_valid[None, :]

    keep = match & valid_col & ~eye & valid_row
    a = torch.where(keep, ops, 0.0)

    row_sum = a.sum(dim=1)
    redistribute = (row_sum == 0.0) & set_valid
    fallback = valid_col & ~eye & valid_row
    a = torch.where(redistribute[:, None] & fallback, 1.0, a)

    row_sum = a.sum(dim=1)
    safe = torch.where(row_sum == 0.0, 1.0, row_sum)
    return a / safe[:, None]


def set_converge_dense(
    stochastic: torch.Tensor, credits: torch.Tensor, num_iter: int
) -> torch.Tensor:
    """EigenTrustSet convergence on a row-stochastic filtered matrix:
    ``s ← Mᵀ s`` from ``credits / Σ credits``, scaled back by the credit
    total (the reference's raw result divided by
    ``INITIAL_SCORE^num_iter``)."""
    total = credits.sum()
    s = credits / total
    for _ in range(num_iter):
        s = torch.mv(stochastic.T, s)
    return s * total
