"""Debug surfaces of a process: request log, stack dump and profiler.

The port's copy of `kubernetes_tpu/utils/debug.py`:

- pkg/httplog/ (request logging) -> `RequestLog`, an in-memory ring of
  the apiserver's recent requests (`/debug/requests`); entries carry the
  request's X-Trace-Id (when the client stamped one), so a slow request
  in the ring can be looked up in `/debug/traces`.
- net/http/pprof's goroutine dump -> `dump_stacks` renders every Python
  thread's current stack (`/debug/stacks`).
- pprof's CPU profile -> `sample_profile` runs an in-process wall-clock
  sampling profiler over sys._current_frames() (py-spy style) and
  renders the hottest stacks, or folded stacks (`format="collapsed"`,
  flamegraph.pl / speedscope input) (`/debug/profile?seconds=N`).

`render_view` is the one renderer of the `/debug/<view>` bodies, with
the query parameters, status codes and bodies of the JAX apiserver's
handlers (`kubernetes_tpu/server/httpserver.py` `_serve_debug`). The
apiserver (`server/httpserver.py`) and a daemon's health server
(`cmd/daemons.py`) each serve the views of their own process through
it; `/debug/health` needs the apiserver and stays there.
"""

from __future__ import annotations

import collections
import json
import sys
import threading
import time
import traceback
from typing import Deque, Dict, Tuple


class RequestLog:
    """Fixed-size ring of recent HTTP requests (httplog analog)."""

    def __init__(self, size: int = 256):
        self._ring: Deque[Tuple[float, str, str, int, float, str]] = (
            collections.deque(maxlen=size)
        )
        self._lock = threading.Lock()

    def record(
        self,
        verb: str,
        path: str,
        code: int,
        duration_s: float,
        trace_id: str = "",
    ) -> None:
        with self._lock:
            self._ring.append(
                (time.time(), verb, path, code, duration_s, trace_id)
            )

    def render(self) -> str:
        with self._lock:
            entries = list(self._ring)
        lines = [
            f"{'TIME':23} {'CODE':5} {'MS':>8}  {'TRACE':16} VERB PATH"
        ]
        for ts, verb, path, code, dur, tid in reversed(entries):
            stamp = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts))
            lines.append(
                f"{stamp:23} {code:<5} {dur * 1000:8.1f}  "
                f"{(tid or '-'):16} {verb} {path}"
            )
        return "\n".join(lines) + "\n"


DEFAULT_REQUEST_LOG = RequestLog()


def dump_stacks() -> str:
    """Every thread's current stack (goroutine-dump analog)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(tid, '?')} (id {tid}) ---")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out) + "\n"


def _collect_samples(
    seconds: float, interval: float
) -> Tuple[Dict[Tuple[Tuple[str, int, str], ...], int], int]:
    """(stack -> sample count, total samples): the sampling loop shared
    by both render formats. Stacks are root-first tuples of (filename,
    lineno, funcname) frames."""
    me = threading.get_ident()
    counts: Dict[Tuple[Tuple[str, int, str], ...], int] = (
        collections.defaultdict(int)
    )
    samples = 0
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue  # don't profile the profiler
            stack = []
            f = frame
            while f is not None and len(stack) < 24:
                code = f.f_code
                stack.append((code.co_filename, f.f_lineno, code.co_name))
                f = f.f_back
            counts[tuple(reversed(stack))] += 1
        samples += 1
        time.sleep(interval)
    return counts, samples


def _render_top(counts, samples: int, seconds: float) -> str:
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:20]
    lines = [
        f"sampling profile: {samples} samples over {seconds:.1f}s "
        f"({len(counts)} distinct stacks)",
        "",
    ]
    for stack, n in top:
        lines.append(f"=== {n} samples ({100.0 * n / max(samples, 1):.1f}%) ===")
        lines.extend(
            f"  {fname}:{lineno} {func}"
            for fname, lineno, func in stack[-12:]
        )
        lines.append("")
    return "\n".join(lines) + "\n"


def _render_collapsed(counts) -> str:
    """Folded stacks: one 'frame;frame;frame count' line per distinct
    stack, root first — flamegraph.pl / speedscope input. Frames are
    'func (file:line)'; semicolons inside a frame would split the
    fold, so they are scrubbed."""
    lines = []
    for stack, n in sorted(counts.items(), key=lambda kv: -kv[1]):
        if not stack:
            continue
        folded = ";".join(
            f"{func} ({fname}:{lineno})".replace(";", ":")
            for fname, lineno, func in stack
        )
        lines.append(f"{folded} {n}")
    return "\n".join(lines) + "\n"


def sample_profile(
    seconds: float = 2.0, interval: float = 0.01, fmt: str = "top"
) -> str:
    """Wall-clock sampling profiler: periodically snapshot every
    thread's stack and report the hottest ones. No instrumentation, no
    tracing overhead on the profiled code — the same trade py-spy and
    pprof's CPU profile make. fmt: "top" (human-readable hottest
    stacks) or "collapsed" (folded stacks for flamegraph tooling)."""
    if seconds != seconds:  # NaN slips through min/max clamps
        seconds = 2.0
    seconds = min(max(seconds, 0.1), 30.0)
    counts, samples = _collect_samples(seconds, interval)
    if fmt == "collapsed":
        return _render_collapsed(counts)
    return _render_top(counts, samples, seconds)


class ViewError(Exception):
    """A debug view's error status (code, reason, message); each server
    answers it with its `Status` body."""

    def __init__(self, code: int, reason: str, message: str):
        self.code = code
        self.reason = reason
        self.message = message
        super().__init__(message)


def _number(query: dict, key: str, default: str, cast=float):
    try:
        return cast(query.get(key, default))
    except ValueError:
        raise ViewError(400, "BadRequest", f"{key} must be numeric")


def cold_report(view: str) -> dict:
    """The body of the `capacity` or `rebalance` view before the
    process's monitor has sampled: what the monitors answer then, and
    what a process that never loaded them (the apiserver's) answers."""
    if view == "capacity":
        return {"kind": "CapacityReport", "sampled": False, "samples": 0,
                "probes": [], "stranded_nodes": [], "trend": []}
    return {"kind": "RebalanceReport", "sampled": False, "samples": 0,
            "moves": [], "outcomes": {}, "trend": []}


def render_view(view: str, query: dict, views) -> Tuple[str, str]:
    """(body, content type) of one `/debug/<view>` of this process; a
    view not in `views` is a 404 listing them. Raises ViewError."""
    from kubernetes_tpu_torch.utils import flightrecorder, tracing

    json_type, text_type = "application/json", "text/plain; charset=utf-8"
    if view not in views:
        raise ViewError(404, "NotFound",
                        "debug endpoints: " + " ".join(f"/debug/{v}" for v in views))
    if view == "traces":
        return tracing.render_json(pod=query.get("pod", ""),
                                   limit=_number(query, "limit", "64", int)), json_type
    if view == "decisions":
        return (flightrecorder.render_decisions_json(
            pod=query.get("pod", ""), limit=_number(query, "limit", "64", int)), json_type)
    if view == "solves":
        return flightrecorder.render_solves_json(limit=_number(query, "limit", "64", int)), json_type
    if view == "slo":
        from kubernetes_tpu_torch.utils import slo

        return json.dumps(slo.evaluate()), json_type
    if view in ("capacity", "rebalance"):
        # The scheduler's rings, read from sys.modules: a process that
        # never loaded the monitor (the apiserver's) has never sampled,
        # and answers so without importing torch or numpy.
        monitor = sys.modules.get(f"kubernetes_tpu_torch.utils.{view}")
        body = monitor.DEFAULT.snapshot() if monitor is not None else cold_report(view)
        return json.dumps(body), json_type
    if view == "kernels":
        # Read from sys.modules: a process that never launched a kernel
        # (the apiserver's) reports none without importing torch.
        led = sys.modules.get("kubernetes_tpu_torch.ops.ledger")
        payload = (led.DEFAULT.to_dict() if led is not None
                   else {"kernels": [], "summary": {"compiles": 0}})
        return json.dumps(payload), json_type
    if view == "device-profile":
        from kubernetes_tpu_torch.utils import profiler

        seconds = _number(query, "seconds", "2")
        try:
            info = profiler.capture_device_trace(seconds=seconds)
        except profiler.TraceInProgress as e:
            raise ViewError(409, "Conflict", str(e))
        except profiler.ProfilerUnavailable as e:
            raise ViewError(503, "ServiceUnavailable", str(e))
        return json.dumps(info), json_type
    if view == "alerts":
        from kubernetes_tpu_torch.utils import alerts

        return json.dumps(alerts.DEFAULT.snapshot()), json_type
    if view == "timeseries":
        from kubernetes_tpu_torch.utils import timeseries

        window_s = _number(query, "window", "300")
        return json.dumps(timeseries.DEFAULT.snapshot(
            series=query.get("series", ""), window_s=window_s)), json_type
    if view == "requests":
        return DEFAULT_REQUEST_LOG.render(), text_type
    if view == "stacks":
        return dump_stacks(), text_type
    if view == "profile":
        seconds = _number(query, "seconds", "2")
        fmt = query.get("format", "top")
        if fmt not in ("top", "collapsed"):
            raise ViewError(400, "BadRequest", "format must be top or collapsed")
        return sample_profile(seconds=seconds, fmt=fmt), text_type
    raise ViewError(404, "NotFound",
                    "debug endpoints: " + " ".join(f"/debug/{v}" for v in views))
