"""Per-phase wall timer for the backlog solve.

The counterpart of `kubernetes_tpu/utils/tracing.py`'s `phase()`
without its span tree or metrics registry: a caller makes one
PhaseTimer, hands it to the entry point, and reads the summed seconds
of each phase (lower, upload, solve, readback) afterwards. Device work
is asynchronous, so "solve" measures the launches and the wait for the
device lands in the phase that synchronises ("readback").
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional


class PhaseTimer:
    """Summed host wall seconds per phase name."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + (
                time.perf_counter() - t0
            )


def phase(timer: Optional[PhaseTimer], name: str):
    """timer.phase(name), or a no-op context when no timer is given."""
    if timer is None:
        return contextlib.nullcontext()
    return timer.phase(name)
