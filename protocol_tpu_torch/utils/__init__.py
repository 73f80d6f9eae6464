"""Shared utilities: byte codecs and base58 (``codec``), the 4x64-bit
limb packing of the ctypes bindings (``limbs``) and named timers
(``telemetry``)."""

from .codec import (  # noqa: F401
    b58decode,
    b58encode,
    to_short,
    to_wide,
)
