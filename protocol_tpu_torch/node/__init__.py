"""The single-device node: attestation ingest, the epoch path, proofs,
checkpoints and the write-ahead log, on the port's backends.

The port of the reference package's ``node``: ``Manager`` (attestation
cache, per-epoch convergence on a ``cuda-*`` or ``native-cpu`` backend,
commitment proofs), ``EpochPipeline`` (host and device stages
overlapped), ``CheckpointStore`` and ``AttestationWAL``.  The HTTP
server, its config and the chain event source are not ported yet.
"""

from .attestation import Attestation, AttestationData  # noqa: F401
from .epoch import Epoch  # noqa: F401
from .errors import EigenError, EigenErrorCode  # noqa: F401
from .manager import Manager, ManagerConfig  # noqa: F401
