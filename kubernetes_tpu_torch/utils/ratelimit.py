"""Token-bucket rate limiter and per-key exponential backoff.

A copy of `kubernetes_tpu/utils/ratelimit.py` (reference:
pkg/util/throttle.go, the RateLimiter behind the binding QPS of
factory.go:43-46; podBackoff, factory.go:334-378). The scheduler daemons
space a rejected pod's retries with the backoff; the per-pod daemon
throttles its binds with the bucket when its config is given
`bind_qps`. The batch daemons commit in bulk and never throttle, as in
the JAX package.
"""

from __future__ import annotations

import threading
import time
from typing import Dict


class TokenBucket:
    def __init__(self, qps: float, burst: int):
        if qps <= 0:
            raise ValueError("qps must be positive")
        self.qps = qps
        self.burst = max(1, burst)
        self._tokens = float(self.burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def _refill_locked(self) -> None:
        now = time.monotonic()
        self._tokens = min(self.burst, self._tokens + (now - self._last) * self.qps)
        self._last = now

    def try_accept(self) -> bool:
        with self._lock:
            self._refill_locked()
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def accept(self) -> None:
        """Block until a token is available (reference: RateLimiter.Accept)."""
        while True:
            with self._lock:
                self._refill_locked()
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return
                wait = (1.0 - self._tokens) / self.qps
            time.sleep(wait)


class Backoff:
    """Per-key exponential backoff: 1 s initial, doubling to a 60 s
    ceiling; `expire` forgets keys idle for a while."""

    def __init__(self, initial: float = 1.0, max_backoff: float = 60.0):
        self.initial = initial
        self.max = max_backoff
        self._lock = threading.Lock()
        self._entries: Dict[str, tuple] = {}  # key -> (duration, last_update)

    def duration(self, key: str) -> float:
        """Current duration for key, doubling it for next time."""
        with self._lock:
            dur, _ = self._entries.get(key, (self.initial, 0.0))
            self._entries[key] = (min(dur * 2, self.max), time.monotonic())
            return dur

    def reset(self, key: str) -> None:
        with self._lock:
            self._entries.pop(key, None)

    def expire(self, older_than: float = 120.0) -> None:
        cutoff = time.monotonic() - older_than
        with self._lock:
            self._entries = {k: v for k, v in self._entries.items() if v[1] >= cutoff}
