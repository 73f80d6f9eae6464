"""Partitioning across hosts: the deterministic peer→host assignment
(``partition``) the node's warm-start remap and pod clip key peers by."""

from .partition import HostPartition, keys_from_hashes, mix64  # noqa: F401
