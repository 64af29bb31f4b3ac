"""Span trees for the solve pipeline, trace ids, and phase timers.

The port's own copy of `kubernetes_tpu/utils/tracing.py` (reference
lineage: pkg/util/trace.go, util.NewTrace / trace.Step / LogIfLong,
with Dapper-style trace-id propagation so one pod's enqueue -> lower ->
solve -> readback -> bind story can be read across processes):

- A Trace owns a tree of Spans (monotonic start/end, point-in-time
  steps, free-form fields) plus the set of pod names it touched (at
  most `max_pods`).
- The active trace/span rides a contextvar; threads start clean, so a
  callback on another thread (a reflector, the commit worker) never
  leaks into a tick's trace.
- trace() opens a root trace, sampled at `sample_rate` unless given an
  explicit trace id (the upstream sampler decided), recorded into the
  bounded DEFAULT_BUFFER on exit and logged when over its threshold;
  when a trace is already active it joins as a child span instead.
- The HTTP client stamps the active trace id into the X-Trace-Id header
  (`client/rest.py`), so the apiserver records its handling of a bind
  under the tick's id; `TraceBuffer.to_dicts` merges entries by id and
  filters by pod.
- phase(name, **fields) is span() plus an unconditional observation
  into the scheduler_phase_seconds histogram, and the same seconds
  added to every PhaseTimer attached to the context (`timing`). Both
  are observed when the trace is sampled out.

`PhaseTimer` is the per-call view of the same phases: an entry point
given `timer=` attaches it for the call, and each phase() adds its
seconds to it, so a timer, the histogram and the span tree read one
measurement of each phase. `stats` holds what a solve notes beside the
times: the wave count, and Sinkhorn's total price iterations and last
residual. Device work is asynchronous, so a phase that only launches
measures the launches, and the wait for the card lands in the phase
that synchronises ("readback").

Sampled out (configure(sample_rate=0)), trace() costs one contextvar
read and one draw of `_RNG`, span() one contextvar read and phase() one
histogram observation; phases wrap whole chunks, never per-pod work.
"""


from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import random
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from kubernetes_tpu_torch.utils import metrics

_LOG = logging.getLogger("kubernetes_tpu_torch.trace")

#: Propagation header (Dapper's trace-id role; one hop, no span ids:
#: entries re-parent by trace id at render time).
TRACE_HEADER = "X-Trace-Id"

#: In-situ per-phase latency of the batched solve pipeline. Always
#: observed, with or without an active trace. Kernel launches are
#: asynchronous, so in pipelined mode "solve" measures the launches and
#: the device time accrues to "readback" (the blocking copy-out).
PHASE_SECONDS = metrics.DEFAULT.histogram(
    "scheduler_phase_seconds",
    "Latency of one solve-pipeline phase (lower/upload/solve/readback/bind)",
    ("phase",),
)

#: The sampler's generator (a test may seed it).
_RNG = random.Random()

_CONFIG = {
    "sample_rate": 1.0,
    # Default LogIfLong threshold (seconds); 0 disables the dump.
    "log_threshold_s": 0.0,
    # Cap on pod names remembered a trace (a 50k-pod batch trace must
    # not pin 50k strings in the ring).
    "max_pods": 8192,
}


def configure(
    sample_rate: Optional[float] = None,
    log_threshold_s: Optional[float] = None,
    max_pods: Optional[int] = None,
) -> None:
    if sample_rate is not None:
        _CONFIG["sample_rate"] = float(sample_rate)
    if log_threshold_s is not None:
        _CONFIG["log_threshold_s"] = float(log_threshold_s)
    if max_pods is not None:
        _CONFIG["max_pods"] = int(max_pods)


def new_trace_id() -> str:
    return os.urandom(8).hex()


class Span:
    """One timed operation. Single-writer by design: a span is mutated
    only by the thread that opened it (matching util.NewTrace)."""

    __slots__ = ("name", "start", "end", "fields", "steps", "children")

    def __init__(self, name: str, fields: Optional[dict] = None,
                 start: Optional[float] = None):
        self.name = name
        self.start = time.monotonic() if start is None else start
        self.end: Optional[float] = None
        self.fields = dict(fields) if fields else {}
        self.steps: List = []  # (monotonic_at, label)
        self.children: List["Span"] = []

    def step(self, label: str) -> None:
        """Record a point-in-time step (trace.Step)."""
        self.steps.append((time.monotonic(), label))

    def note(self, **fields) -> None:
        self.fields.update(fields)

    def child(self, name: str, start: Optional[float] = None,
              end: Optional[float] = None, **fields) -> "Span":
        sp = Span(name, fields or None, start=start)
        sp.end = end
        self.children.append(sp)
        return sp

    def finish(self) -> "Span":
        if self.end is None:
            self.end = time.monotonic()
        return self

    @property
    def duration_s(self) -> float:
        return (self.end if self.end is not None else time.monotonic()) - self.start

    def to_dict(self, base: float) -> dict:
        d = {
            "name": self.name,
            "start_s": round(self.start - base, 6),
            "duration_s": round(self.duration_s, 6),
        }
        if self.fields:
            d["fields"] = dict(self.fields)
        if self.steps:
            d["steps"] = [{"at_s": round(at - base, 6), "label": label}
                          for at, label in self.steps]
        if self.children:
            d["children"] = [c.to_dict(base) for c in self.children]
        return d


class _NullSpan:
    """Shared no-op span: every mutator swallows its arguments."""

    __slots__ = ()

    def step(self, label):
        pass

    def note(self, **fields):
        pass

    def child(self, name, start=None, end=None, **fields):
        return self

    def finish(self):
        return self


NULL_SPAN = _NullSpan()


class Trace:
    """A root span plus identity: trace id, wall-clock start, pods."""

    __slots__ = ("trace_id", "root", "start_wall", "pods", "pods_truncated", "threshold_s",
                 "record_threshold_s")

    def __init__(self, name: str, trace_id: Optional[str] = None,
                 threshold_s: Optional[float] = None, start: Optional[float] = None,
                 record_threshold_s: float = 0.0):
        self.trace_id = trace_id or new_trace_id()
        self.root = Span(name, start=start)
        self.start_wall = time.time()
        self.pods: set = set()
        self.pods_truncated = False
        self.threshold_s = threshold_s
        self.record_threshold_s = record_threshold_s

    def note_pods(self, names: Iterable[str]) -> None:
        limit = _CONFIG["max_pods"]
        for n in names:
            if len(self.pods) >= limit:
                self.pods_truncated = True
                return
            self.pods.add(n)

    def to_dict(self) -> dict:
        d = {
            "traceId": self.trace_id,
            "start": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(self.start_wall)),
            "duration_s": round(self.root.duration_s, 6),
            "spans": [self.root.to_dict(self.root.start)],
        }
        if self.pods:
            d["pods"] = sorted(self.pods)
        if self.pods_truncated:
            d["podsTruncated"] = True
        return d


# Active context: the trace (identity, pod set) and the innermost open
# span (nesting parent). Fresh threads see None for both.
_current_trace: "contextvars.ContextVar[Optional[Trace]]" = (
    contextvars.ContextVar("ktt_trace", default=None)
)
_current_span: "contextvars.ContextVar[Optional[Span]]" = (
    contextvars.ContextVar("ktt_span", default=None)
)


def current_trace_id() -> str:
    tr = _current_trace.get()
    return tr.trace_id if tr is not None else ""


def note_pods(names: Iterable[str]) -> None:
    """Associate pod names with the active trace (no-op without one)."""
    tr = _current_trace.get()
    if tr is not None:
        tr.note_pods(names)


class TraceBuffer:
    """Bounded ring of completed traces (newest win), merged by trace id
    at render time: entries recorded under one id by different
    components come back as one trace with several span trees."""

    def __init__(self, size: int = 512):
        self._size = size
        self._entries: List[Trace] = []
        self._lock = threading.Lock()

    def record(self, trace: Trace) -> None:
        with self._lock:
            self._entries.append(trace)
            if len(self._entries) > self._size:
                del self._entries[: len(self._entries) - self._size]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def to_dicts(self, pod: str = "", limit: int = 64) -> dict:
        """{"kind": "TraceList", "traces": [...]}: newest first, entries
        merged by trace id, optionally only the traces that touched
        `pod`."""
        with self._lock:
            entries = list(self._entries)
        merged: Dict[str, dict] = {}
        order: List[str] = []
        for tr in entries:
            d = tr.to_dict()
            cur = merged.get(tr.trace_id)
            if cur is None:
                merged[tr.trace_id] = d
                order.append(tr.trace_id)
            else:
                cur["spans"].extend(d["spans"])
                if d.get("pods"):
                    cur["pods"] = sorted(set(cur.get("pods", [])) | set(d["pods"]))
                cur["duration_s"] = max(cur["duration_s"], d["duration_s"])
        out = []
        for tid in reversed(order):
            if len(out) >= limit:
                break
            d = merged[tid]
            if pod and pod not in d.get("pods", []):
                continue
            out.append(d)
        return {"kind": "TraceList", "traces": out}


DEFAULT_BUFFER = TraceBuffer()


class _TraceCtx:
    """Context manager behind trace(): owns a root Trace, joins the
    active trace as a child span, or (sampled out) does nothing."""

    __slots__ = ("_trace", "_span", "_tok_trace", "_tok_span")

    def __init__(self, trace: Optional[Trace], join_span: Optional[Span]):
        self._trace = trace
        self._span = trace.root if trace is not None else join_span
        self._tok_trace = None
        self._tok_span = None

    def __enter__(self) -> Span:
        if self._span is None:
            return NULL_SPAN
        if self._trace is not None:
            self._tok_trace = _current_trace.set(self._trace)
        self._tok_span = _current_span.set(self._span)
        return self._span

    def __exit__(self, *exc) -> bool:
        if self._span is None:
            return False
        self._span.finish()
        if self._tok_span is not None:
            _current_span.reset(self._tok_span)
        if self._tok_trace is not None:
            _current_trace.reset(self._tok_trace)
        tr = self._trace
        if tr is not None:
            # record_threshold_s keeps chatty sources that did next to
            # no work out of the shared ring.
            if tr.root.duration_s >= tr.record_threshold_s:
                DEFAULT_BUFFER.record(tr)
            threshold = tr.threshold_s
            if threshold is None:
                threshold = _CONFIG["log_threshold_s"]
            if threshold and tr.root.duration_s > threshold:
                _LOG.info("trace over threshold (%.3fs > %.3fs):\n%s", tr.root.duration_s,
                          threshold, format_trace(tr.to_dict()))
        return False


_NULL_CTX = _TraceCtx(None, None)


def trace(name: str, trace_id: Optional[str] = None, pod: Optional[str] = None,
          pods: Optional[Iterable[str]] = None, threshold_s: Optional[float] = None,
          start: Optional[float] = None, record_threshold_s: float = 0.0) -> _TraceCtx:
    """Open a root trace (recorded, and logged when over its threshold,
    on exit). Joins the already-active trace as a child span when one
    exists. An explicit trace_id (header propagation) bypasses sampling:
    the upstream sampler already decided. record_threshold_s keeps a
    trace that finishes faster than it out of the buffer."""
    active = _current_trace.get()
    if active is not None:
        sp = Span(name, start=start)
        parent = _current_span.get()
        (parent or active.root).children.append(sp)
        if pod:
            active.note_pods((pod,))
        if pods:
            active.note_pods(pods)
        return _TraceCtx(None, sp)
    if not trace_id:
        rate = _CONFIG["sample_rate"]
        if rate <= 0.0 or (rate < 1.0 and _RNG.random() >= rate):
            return _NULL_CTX
    tr = Trace(name, trace_id=trace_id, threshold_s=threshold_s, start=start,
               record_threshold_s=record_threshold_s)
    if pod:
        tr.note_pods((pod,))
    if pods:
        tr.note_pods(pods)
    return _TraceCtx(tr, None)


class _SpanCtx:
    __slots__ = ("_span", "_tok", "_phase", "_t0")

    def __init__(self, span: Optional[Span], phase: Optional[str]):
        self._span = span
        self._phase = phase
        self._tok = None
        self._t0 = 0.0

    def __enter__(self):
        if self._phase is not None:
            self._t0 = time.monotonic()
        if self._span is None:
            return NULL_SPAN
        self._tok = _current_span.set(self._span)
        return self._span

    def __exit__(self, *exc) -> bool:
        if self._phase is not None:
            seconds = time.monotonic() - self._t0
            PHASE_SECONDS.observe(seconds, phase=self._phase)
            for timer in _timers.get():
                timer.add(self._phase, seconds)
        if self._span is not None:
            self._span.finish()
            _current_span.reset(self._tok)
        return False


def span(name: str, **fields) -> _SpanCtx:
    """Child span of the active span; no-op without an active trace."""
    parent = _current_span.get()
    if parent is None:
        return _SpanCtx(None, None)
    return _SpanCtx(parent.child(name, **fields), None)


def phase(name: str, **fields) -> _SpanCtx:
    """span() + unconditional scheduler_phase_seconds observation, whose
    seconds also go to every PhaseTimer attached by `timing`."""
    parent = _current_span.get()
    sp = parent.child(name, **fields) if parent is not None else None
    return _SpanCtx(sp, name)


# -- per-call phase timers ---------------------------------------------

#: PhaseTimers attached to the active context (innermost last).
_timers: "contextvars.ContextVar[Tuple[PhaseTimer, ...]]" = (
    contextvars.ContextVar("ktt_timers", default=())
)


class PhaseTimer:
    """Summed wall seconds per phase name, fed by phase() while the timer
    is attached (`timing(timer)`, which the entry points taking `timer=`
    do for the call), and the solve's `stats`."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.stats: Dict[str, float] = {}

    def add(self, name: str, seconds: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds

    @contextlib.contextmanager
    def phase(self, name: str, **fields) -> Iterator[Span]:
        """phase(name, **fields) with this timer attached."""
        with timing(self), phase(name, **fields) as sp:
            yield sp


@contextlib.contextmanager
def timing(timer: Optional[PhaseTimer]) -> Iterator[None]:
    """Attach `timer` to the context for the block: every phase() inside
    it (in this thread) adds its seconds to the timer. None, or a timer
    already attached, changes nothing."""
    attached = _timers.get()
    if timer is None or timer in attached:
        yield
        return
    tok = _timers.set(attached + (timer,))
    try:
        yield
    finally:
        _timers.reset(tok)


# -- rendering (the LogIfLong dump and `ktctl trace`) -------------------


def _format_span(d: dict, indent: int, lines: List[str]) -> None:
    pad = "  " * indent
    fields = d.get("fields") or {}
    extra = "".join(f" {k}={v}" for k, v in sorted(fields.items()))
    lines.append(
        f"{pad}{d['name']:<24} +{d['start_s']:.3f}s "
        f"({d['duration_s'] * 1000:.1f}ms){extra}"
    )
    for st in d.get("steps", ()):
        lines.append(f"{pad}  * {st['label']} @ +{st['at_s']:.3f}s")
    for c in d.get("children", ()):
        _format_span(c, indent + 1, lines)


def format_trace(d: dict) -> str:
    """Render one merged trace dict as an indented span tree."""
    pods = d.get("pods", [])
    head = f"TRACE {d['traceId']} {d.get('start', '')} ({d['duration_s']:.3f}s)"
    if pods:
        shown = ", ".join(pods[:5])
        more = f" +{len(pods) - 5} more" if len(pods) > 5 else ""
        head += f" pods=[{shown}{more}]"
    lines = [head]
    for root in d.get("spans", ()):
        _format_span(root, 1, lines)
    return "\n".join(lines)


def render_json(pod: str = "", limit: int = 64) -> str:
    return json.dumps(DEFAULT_BUFFER.to_dicts(pod=pod, limit=limit))
