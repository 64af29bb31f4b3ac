"""Device-time profiling: tick duty cycle, solve/commit overlap, device
traces, and a profiled call's busy share.

The counterpart of `kubernetes_tpu/utils/profiler.py`, under its series
names, with `torch.profiler` in place of `jax.profiler`:

- **duty cycle** (`scheduler_device_duty_cycle`): the fraction of a tick
  period the card spent busy, the in-flight window from a tick's launch
  to its `PendingSolve.result()` over the wall between consecutive tick
  resolutions (`ops/incremental.py` keeps both ends on the handle);
- **overlap efficiency** (`scheduler_overlap_efficiency`): of that
  window, the share the host spent on other work rather than blocked in
  the readback, 1 - blocked / busy;
- `scheduler_device_busy_seconds_total`: the busy seconds behind the
  duty ratio;
- **device traces**: `capture_device_trace(seconds)` runs
  `torch.profiler` around a sleep on the calling thread while other
  threads launch, and writes a Chrome trace; one capture at a time;
- `profile_call(fn)`: `fn()` once under `torch.profiler`, with its host
  wall (ending in a synchronise), the device time the trace holds, their
  ratio as the card's busy share, and the kernels that hold most of it.

`observe_tick` is microseconds of host bookkeeping per tick.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Callable, Optional, Tuple

from kubernetes_tpu_torch.utils import metrics

#: Ratio ladders: duty and overlap are in [0, 1] by construction.
RATIO_BUCKETS = (
    0.01, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95,
    0.99, 1.0,
)

DUTY_CYCLE = metrics.DEFAULT.histogram(
    "scheduler_device_duty_cycle",
    "Fraction of a micro-tick period the solve device spent busy "
    "(dispatch -> readback over the tick wall)",
    buckets=RATIO_BUCKETS,
)
OVERLAP = metrics.DEFAULT.histogram(
    "scheduler_overlap_efficiency",
    "Fraction of the device-busy window the host overlapped with "
    "useful work instead of blocking on the readback",
    buckets=RATIO_BUCKETS,
)
DEVICE_BUSY = metrics.DEFAULT.counter(
    "scheduler_device_busy_seconds_total",
    "Total seconds the solve device spent busy (in-flight solves)",
)


def observe_tick(device_s: float, wall_s: float, blocked_s: float) -> None:
    """One resolved tick's accounting: `device_s` is the launch-to-
    readback in-flight window, `wall_s` the period since the previous
    tick resolved, `blocked_s` the host time spent blocked inside
    `result()`. Ratios clamp to [0, 1]; a tick with no busy window or
    no period is not observed."""
    if device_s <= 0.0 or wall_s <= 0.0:
        return
    DEVICE_BUSY.inc(device_s)
    DUTY_CYCLE.observe(min(1.0, device_s / wall_s))
    OVERLAP.observe(min(1.0, max(0.0, 1.0 - blocked_s / device_s)))


# -- device traces -----------------------------------------------------


class ProfilerUnavailable(RuntimeError):
    """torch.profiler cannot start or record in this process."""


class TraceInProgress(RuntimeError):
    """A device trace capture is already running (profiler sessions
    cannot nest)."""


_CAPTURE_LOCK = threading.Lock()
_CAPTURE_ACTIVE = [False]

#: Capture length clamp.
MAX_TRACE_SECONDS = 60.0


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def capture_device_trace(seconds: float = 2.0, out_dir: Optional[str] = None) -> dict:
    """Record `seconds` of activity with `torch.profiler` into a
    directory (a fresh temporary one unless `out_dir`) as a Chrome trace
    (`trace.json`). The calling thread sleeps inside the session; other
    threads' launches land in the trace. Returns {dir, seconds, files}."""
    if seconds != seconds:  # NaN slips through min/max clamps
        seconds = 2.0
    seconds = min(max(float(seconds), 0.1), MAX_TRACE_SECONDS)
    try:
        from torch.profiler import profile
    except ImportError as e:
        raise ProfilerUnavailable(f"torch.profiler unavailable: {e!r}")
    with _CAPTURE_LOCK:
        if _CAPTURE_ACTIVE[0]:
            raise TraceInProgress("a device trace capture is already in progress")
        _CAPTURE_ACTIVE[0] = True
    try:
        trace_dir = out_dir or tempfile.mkdtemp(prefix="ktt-device-trace-")
        try:
            with profile(activities=_activities()) as prof:
                time.sleep(seconds)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        except RuntimeError as e:
            raise ProfilerUnavailable(f"device trace capture failed: {e!r}")
        files = []
        for root, _dirs, names in os.walk(trace_dir):
            for name in names:
                files.append(os.path.relpath(os.path.join(root, name), trace_dir))
        return {"dir": trace_dir, "seconds": seconds, "files": sorted(files)}
    finally:
        with _CAPTURE_LOCK:
            _CAPTURE_ACTIVE[0] = False


def profile_call(fn: Callable[[], object], top: int = 10) -> Tuple[object, dict]:
    """`fn()` once under torch.profiler: (its result, {wall_ms: host
    wall ending in a synchronise, device_ms: the device time the trace
    holds (each kernel's own time, summed), device_busy_share: their
    ratio, kernel_launches, top_kernels: the `top` kernels by device
    time}). Needs a card: device time is what it reads."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise ProfilerUnavailable("profile_call reads device time and there is no CUDA device")

    def device_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # The kernels' own rows: an operator's row repeats its kernels' time.
    rows = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=device_us, reverse=True)
    device_ms = sum(device_us(e) for e in rows) / 1e3
    return out, {
        "wall_ms": wall * 1e3,
        "device_ms": device_ms,
        "device_busy_share": device_ms / (wall * 1e3),
        "kernel_launches": sum(e.count for e in rows),
        "top_kernels": [{"kernel": e.key[:120], "device_ms": device_us(e) / 1e3, "calls": e.count}
                        for e in rows[:top]],
    }
