"""The flagship model: EigenTrust global-trust convergence.

Port of ``protocol_tpu/models/eigentrust.py`` over the port's backend
registry: a TrustGraph with convergence hyper-parameters (damping α,
tolerance, iteration budget), a backend name and the device it runs on
(``None`` → the card, raising where there is none).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..trust.backend import ConvergenceResult, get_backend
from ..trust.graph import TrustGraph


@dataclass
class EigenTrustModel:
    graph: TrustGraph
    alpha: float = 0.1
    tol: float = 1e-6
    max_iter: int = 50
    backend: str = "cuda-sparse"
    device: str | None = None
    backend_kwargs: dict = field(default_factory=dict)

    def converge(self, **overrides) -> ConvergenceResult:
        params = dict(alpha=self.alpha, tol=self.tol, max_iter=self.max_iter)
        params.update(overrides)
        backend = get_backend(self.backend, device=self.device, **self.backend_kwargs)
        return backend.converge(self.graph, **params)

    def top_k(self, result: ConvergenceResult, k: int = 10) -> list[tuple[int, float]]:
        idx = np.argsort(result.scores)[::-1][:k]
        return [(int(i), float(result.scores[i])) for i in idx]
