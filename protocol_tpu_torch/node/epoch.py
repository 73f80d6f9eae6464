"""Epoch arithmetic (server/src/epoch.rs)."""

from __future__ import annotations

import time
from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class Epoch:
    """Wall-clock epoch index: unix seconds // interval."""

    number: int

    def __str__(self) -> str:
        return f"Epoch({self.number})"

    def to_be_bytes(self) -> bytes:
        return self.number.to_bytes(8, "big")

    @classmethod
    def from_be_bytes(cls, b: bytes) -> "Epoch":
        return cls(int.from_bytes(b[:8], "big"))

    @classmethod
    def current_timestamp(cls) -> int:
        return int(time.time())

    @classmethod
    def current_epoch(cls, interval: int) -> "Epoch":
        return cls(cls.current_timestamp() // interval)

    @classmethod
    def secs_until_next_epoch(cls, interval: int) -> int:
        secs = cls.current_timestamp()
        return (secs // interval + 1) * interval - secs

    def previous(self) -> "Epoch":
        return Epoch(self.number - 1)

    def next(self) -> "Epoch":
        return Epoch(self.number + 1)

    def is_zero(self) -> bool:
        return self.number == 0
