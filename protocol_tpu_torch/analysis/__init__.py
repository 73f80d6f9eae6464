"""The kernel-budget registry the node consults (``budget``)."""
