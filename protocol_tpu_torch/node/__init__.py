"""The single-device node: attestation ingest, the epoch path, proofs,
checkpoints, the write-ahead log and the HTTP server, on the port's
backends.

The port of the reference package's ``node``: ``Manager`` (attestation
cache, per-epoch convergence on a ``cuda-*`` or ``native-cpu`` backend,
commitment and PLONK proofs), ``EpochPipeline`` (host and device stages
overlapped), ``CheckpointStore``, ``AttestationWAL``, ``ProtocolConfig``
(``config``), the chain event sources (``ethereum``) and the daemon
(``server``: ``python -m protocol_tpu_torch.node.server --config
<file>``) and the pod's durability plane (``pod``: per-host WAL and
checkpoint shards bound by sealed pod manifests).
"""

from .attestation import Attestation, AttestationData  # noqa: F401
from .epoch import Epoch  # noqa: F401
from .errors import EigenError, EigenErrorCode  # noqa: F401
from .manager import Manager, ManagerConfig  # noqa: F401
