"""Sharding across devices and hosts: the sharded converge over the ranks
of a ``torch.distributed`` group (``mesh``, ``launch``, ``sharded``,
``dryrun``) and the deterministic peer→host assignment (``partition``)
the node's warm-start remap and pod clip key peers by.  Importing the
package loads only ``partition``."""

from .partition import HostPartition, keys_from_hashes, mix64  # noqa: F401
