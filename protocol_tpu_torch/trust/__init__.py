"""Trust computation on PyTorch: ``TrustGraph`` and the backend registry
(``cuda-csr``, ``cuda-windowed``)."""

from .backend import ConvergenceResult, TrustBackend, get_backend, registered_backends  # noqa: F401
from .graph import TrustGraph  # noqa: F401
