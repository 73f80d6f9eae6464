"""Trust computation on PyTorch: ``TrustGraph``, the backend registry
(``native-cpu``, ``cuda-dense``, ``cuda-sparse``, ``cuda-csr``,
``cuda-windowed``) and the exact fixed-set kernels (``native``)."""

from .backend import ConvergenceResult, TrustBackend, get_backend, registered_backends  # noqa: F401
from .graph import TrustGraph  # noqa: F401
