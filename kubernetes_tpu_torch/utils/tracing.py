"""Span trees for the solve pipeline, and phase timers.

The port's own copy of the span tree of `kubernetes_tpu/utils/tracing.py`
(reference lineage: pkg/util/trace.go, with Dapper-style trace ids):

- A Trace owns a tree of Spans (monotonic start/end, free-form
  fields).
- The active trace/span rides a contextvar; threads start clean, so a
  callback on another thread never leaks into a solve's trace.
- trace() opens a root trace (recorded into the bounded DEFAULT_BUFFER
  on exit); when a trace is already active it joins as a child span
  instead.
- phase(name, **fields) is span() plus an unconditional observation
  into the scheduler_phase_seconds histogram, and the same seconds
  added to every PhaseTimer attached to the context (`timing`).

`PhaseTimer` is the per-call view of the same phases: an entry point
given `timer=` attaches it for the call, and each phase() adds its
seconds to it, so a timer, the histogram and the span tree read one
measurement of each phase. `stats` holds what a solve notes beside the
times: the wave count, and Sinkhorn's total price iterations and last
residual. Device work is asynchronous, so a phase that only launches
measures the launches, and the wait for the card lands in the phase
that synchronises ("readback").

Without an active trace, span() costs one contextvar read and phase()
one histogram observation; phases wrap whole chunks, never per-pod
work.
"""


from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from kubernetes_tpu_torch.utils import metrics

#: In-situ per-phase latency of the batched solve pipeline. Always
#: observed, with or without an active trace. Kernel launches are
#: asynchronous, so in pipelined mode "solve" measures the launches and
#: the device time accrues to "readback" (the blocking copy-out).
PHASE_SECONDS = metrics.DEFAULT.histogram(
    "scheduler_phase_seconds",
    "Latency of one solve-pipeline phase (lower/upload/solve/readback/bind)",
    ("phase",),
)

def new_trace_id() -> str:
    return os.urandom(8).hex()


class Span:
    """One timed operation. Single-writer by design: a span is mutated
    only by the thread that opened it (matching util.NewTrace)."""

    __slots__ = ("name", "start", "end", "fields", "children")

    def __init__(self, name: str, fields: Optional[dict] = None):
        self.name = name
        self.start = time.monotonic()
        self.end: Optional[float] = None
        self.fields = dict(fields) if fields else {}
        self.children: List["Span"] = []

    def note(self, **fields) -> None:
        self.fields.update(fields)

    def child(self, name: str, **fields) -> "Span":
        sp = Span(name, fields or None)
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
        if self.children:
            d["children"] = [c.to_dict(base) for c in self.children]
        return d


class _NullSpan:
    """Shared no-op span: every mutator swallows its arguments."""

    __slots__ = ()

    def note(self, **fields):
        pass

    def child(self, name, **fields):
        return self

    def finish(self):
        return self


NULL_SPAN = _NullSpan()


class Trace:
    """A root span plus identity: trace id and wall-clock start."""

    __slots__ = ("trace_id", "root", "start_wall")

    def __init__(self, name: str):
        self.trace_id = new_trace_id()
        self.root = Span(name)
        self.start_wall = time.time()

    def to_dict(self) -> dict:
        return {
            "traceId": self.trace_id,
            "start": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime(self.start_wall)
            ),
            "duration_s": round(self.root.duration_s, 6),
            "spans": [self.root.to_dict(self.root.start)],
        }


# Active context: the trace (identity) and the innermost
# open span (nesting parent). Fresh threads see None for both.
_current_trace: "contextvars.ContextVar[Optional[Trace]]" = (
    contextvars.ContextVar("ktt_trace", default=None)
)
_current_span: "contextvars.ContextVar[Optional[Span]]" = (
    contextvars.ContextVar("ktt_span", default=None)
)


class TraceBuffer:
    """Bounded ring of completed traces (newest win)."""

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

    def to_dicts(self, limit: int = 64) -> dict:
        """{"kind": "TraceList", "traces": [...]}, newest first."""
        with self._lock:
            entries = self._entries[-limit:] if limit > 0 else []
        return {"kind": "TraceList", "traces": [tr.to_dict() for tr in reversed(entries)]}


DEFAULT_BUFFER = TraceBuffer()


class _TraceCtx:
    """Context manager behind trace(): owns a root Trace, or joins the
    active trace as a child span."""

    __slots__ = ("_trace", "_span", "_tok_trace", "_tok_span")

    def __init__(self, trace: Optional[Trace], join_span: Optional[Span]):
        self._trace = trace
        self._span = trace.root if trace is not None else join_span
        self._tok_trace = None
        self._tok_span = None

    def __enter__(self) -> Span:
        if self._trace is not None:
            self._tok_trace = _current_trace.set(self._trace)
        self._tok_span = _current_span.set(self._span)
        return self._span

    def __exit__(self, *exc) -> bool:
        self._span.finish()
        _current_span.reset(self._tok_span)
        if self._tok_trace is not None:
            _current_trace.reset(self._tok_trace)
            DEFAULT_BUFFER.record(self._trace)
        return False


def trace(name: str) -> _TraceCtx:
    """Open a root trace, recorded into DEFAULT_BUFFER on exit. Joins
    the already-active trace as a child span when one exists."""
    active = _current_trace.get()
    if active is not None:
        sp = Span(name)
        parent = _current_span.get()
        (parent or active.root).children.append(sp)
        return _TraceCtx(None, sp)
    return _TraceCtx(Trace(name), None)


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


# -- rendering ----------------------------------------------------------


def _format_span(d: dict, indent: int, lines: List[str]) -> None:
    pad = "  " * indent
    fields = d.get("fields") or {}
    extra = "".join(f" {k}={v}" for k, v in sorted(fields.items()))
    lines.append(
        f"{pad}{d['name']:<24} +{d['start_s']:.3f}s "
        f"({d['duration_s'] * 1000:.1f}ms){extra}"
    )
    for c in d.get("children", ()):
        _format_span(c, indent + 1, lines)


def format_trace(d: dict) -> str:
    """Render one trace dict as an indented span tree."""
    lines = [f"TRACE {d['traceId']} {d.get('start', '')} ({d['duration_s']:.3f}s)"]
    for root in d.get("spans", ()):
        _format_span(root, 1, lines)
    return "\n".join(lines)


def render_json(limit: int = 64) -> str:
    return json.dumps(DEFAULT_BUFFER.to_dicts(limit=limit))
