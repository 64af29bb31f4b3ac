"""Debug surfaces of a daemon's process: stack dump and profiler.

The port's copy of the process half of `kubernetes_tpu/utils/debug.py`
(the apiserver's request log stays with the apiserver):

- net/http/pprof's goroutine dump -> `dump_stacks` renders every Python
  thread's current stack (`/debug/stacks`).
- pprof's CPU profile -> `sample_profile` runs an in-process wall-clock
  sampling profiler over sys._current_frames() (py-spy style) and
  renders the hottest stacks, or folded stacks (`format="collapsed"`,
  flamegraph.pl / speedscope input) (`/debug/profile?seconds=N`).
"""

from __future__ import annotations

import collections
import sys
import threading
import time
import traceback
from typing import Dict, Tuple


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
