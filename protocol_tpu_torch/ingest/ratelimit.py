"""Per-sender token buckets and the spam score.

The port of ``protocol_tpu/ingest/ratelimit.py``.

The admission plane's second cheap gate (after the structural check,
before dedup recording): a classic token bucket per sender bounds
sustained rate and burst size, and a simple spam score — rejection
history plus burst ratio — catches senders whose traffic is mostly
garbage even when each individual message would fit the bucket.
Pre-trusted senders (the EigenTrust pre-trust set, the original
design's sybil anchor) can bypass both via the whitelist.

All state is O(senders) dicts with insertion-order eviction, and the
clock is injectable so tests can drain and refill buckets without
sleeping.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass(frozen=True)
class RateLimitConfig:
    #: Sustained tokens/second refilled per sender.
    rate: float = 50.0
    #: Bucket capacity — the burst a quiet sender may spend at once.
    burst: float = 200.0
    #: Spam-score ceiling; scores above it reject with ``spam-score``.
    spam_threshold: float = 4.0
    #: Senders tracked before oldest-inserted eviction.
    max_senders: int = 65536
    #: Pre-trusted sender keys that bypass rate and spam checks.
    whitelist: frozenset[tuple[int, int]] = frozenset()


@dataclass
class _SenderState:
    tokens: float
    stamp: float
    accepted: int = 0
    rejected: int = 0
    window_start: float = 0.0
    window_count: int = 0


class AdmissionPolicy:
    """Token bucket + spam score, one state record per sender.

    The spam score is ``4 * rejected/(accepted+rejected) + max(0,
    burst_ratio - 1)`` where ``burst_ratio`` is this second's arrival
    count over the sustained rate — a sender whose history is mostly
    rejections, or who is arriving far above their refill rate, climbs
    past the threshold and gets cut off before spending more verify
    budget.  Outcomes are fed back via :meth:`record_outcome` so
    downstream rejections (bad signature, duplicate) raise the score
    of the sender who caused them.
    """

    def __init__(self, config: RateLimitConfig | None = None, clock=time.monotonic):
        self.config = config or RateLimitConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._senders: dict[tuple[int, int], _SenderState] = {}

    def _state(self, sender: tuple[int, int], now: float) -> _SenderState:
        state = self._senders.get(sender)
        if state is None:
            if len(self._senders) >= self.config.max_senders:
                self._senders.pop(next(iter(self._senders)))
            state = self._senders[sender] = _SenderState(
                tokens=self.config.burst, stamp=now, window_start=now
            )
        return state

    def score(self, sender: tuple[int, int]) -> float:
        """Current spam score (0.0 for unseen senders)."""
        with self._lock:
            state = self._senders.get(sender)
            if state is None:
                return 0.0
            return self._score(state)

    def _score(self, state: _SenderState) -> float:
        total = state.accepted + state.rejected
        reject_frac = state.rejected / total if total else 0.0
        burst_ratio = state.window_count / max(self.config.rate, 1.0)
        return 4.0 * reject_frac + max(0.0, burst_ratio - 1.0)

    def check(self, sender: tuple[int, int]) -> str | None:
        """Reason code (``rate-limited`` / ``spam-score``) or None."""
        if sender in self.config.whitelist:
            return None
        now = self._clock()
        with self._lock:
            state = self._state(sender, now)
            if now - state.window_start >= 1.0:
                state.window_start = now
                state.window_count = 0
            state.window_count += 1
            state.tokens = min(
                self.config.burst,
                state.tokens + (now - state.stamp) * self.config.rate,
            )
            state.stamp = now
            if state.tokens < 1.0:
                state.rejected += 1
                return "rate-limited"
            if self._score(state) > self.config.spam_threshold:
                state.rejected += 1
                return "spam-score"
            state.tokens -= 1.0
            return None

    def record_outcome(self, sender: tuple[int, int], accepted: bool) -> None:
        """Feed a downstream verdict (signature check, dedup) back into
        the sender's history — the spam score's memory."""
        now = self._clock()
        with self._lock:
            state = self._state(sender, now)
            if accepted:
                state.accepted += 1
            else:
                state.rejected += 1


__all__ = ["AdmissionPolicy", "RateLimitConfig"]
