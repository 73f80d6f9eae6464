"""protocol_tpu_torch — the EigenTrust convergence on PyTorch and CUDA.

A port of ``protocol_tpu`` (the JAX/TPU package, kept beside it as the
reference) to an NVIDIA H100.  Structure and names mirror the
reference so each counterpart is easy to find:

- ``trust``   — ``TrustGraph``, the backend registry (``native-cpu``,
  ``cuda-dense``, ``cuda-sparse``, ``cuda-csr``, ``cuda-windowed``,
  ``cuda-sharded:cuda-csr`` and ``cuda-sharded:cuda-windowed``) and
  the exact fixed-set kernels.
- ``parallel`` — the sharded converge over the ranks of a
  ``torch.distributed`` group (``mesh``, ``launch``, ``sharded``, the
  ``dryrun`` and its rank programs) and the peer partition.
- ``ops``     — the power iteration, the dense, COO and CSR steps (the
  edge product and its block prefix in the hand-written CUDA kernel
  ``ops/csrc/gather_ds_cumsum.cu``), the host-built ``WindowPlan`` and
  the windowed step on the hand-written CUDA gather kernel
  (``ops/csrc/gather_window.cu``).
- ``node``    — the single-device node: ``Manager`` (attestation ingest,
  the epoch path, commitment and PLONK proofs), ``EpochPipeline``,
  ``CheckpointStore``, ``AttestationWAL``, ``ProtocolConfig``, the chain
  event sources and the HTTP server (``python -m
  protocol_tpu_torch.node.server --config <file>``).
- ``crypto``, ``zk``, ``prover``, ``obs``, ``chaos``, ``analysis``,
  ``utils`` — the host modules the node needs: field, Poseidon and
  EdDSA (with the repository's C++ runtime built at first use), proofs,
  proof jobs, spans, metrics and the journal, fault points, and the
  kernel and communication budgets.
- ``models``  — graph and churn generators and ``EigenTrustModel``.
- ``bench``   — the reference's gather/transpose probes on the card,
  with their hand-written CUDA kernels (``ops/csrc/take_along_axis.cu``,
  ``transpose2d.cu``, ``gather_region.cu``).

The package never imports ``jax`` or ``protocol_tpu``.  Entry points
run on the card unless the caller asks for the CPU: ``device=None``
means CUDA, and raises where CUDA is absent — nothing falls back to the
CPU behind the caller's back.  Submodules load lazily, so importing the
package alone does not import torch.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

_SUBMODULES = (
    "analysis", "bench", "chaos", "crypto", "models", "node", "obs", "ops", "parallel",
    "prover", "trust", "utils", "zk",
)


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on: ``None`` means
    ``"cuda"`` and raises ``RuntimeError`` when no card is visible;
    anything else is taken as given (``"cpu"`` is how tests ask for the
    plain path)."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["__version__", "resolve_device", *_SUBMODULES]
