"""ktsan, runtime half: an opt-in lock/blocking-call sanitizer.

The API plane is now genuinely concurrent — WAL group commit, the
watch cache's event feed, informer-fed controllers, bulk write paths —
and the class of bug that ships silently there is not a wrong value
but a wrong *ordering*: two locks taken in opposite orders on two
threads, or a disk flush performed while holding the lock every other
writer needs. ktlint's KT002 sees one function at a time; this module
watches the locks actually taken at runtime.

Usage: components create their locks through the factory instead of
``threading.Lock()``::

    from kubernetes_tpu_torch.utils import sanitizer
    self._lock = sanitizer.lock("kvstore.lock")
    self._sync_lock = sanitizer.lock("kvstore.sync", io_gate=True)

When the sanitizer is OFF (the default) the factory returns a plain
``threading.Lock``/``RLock`` — zero overhead, nothing imported beyond
stdlib. When ON (``KT_SANITIZE=locks`` in the environment, or
:func:`enable` — the port's test helper `tests/torch_ktsan.py` flips
it for the concurrency-heavy test files), the factory returns instrumented wrappers that feed three
detectors:

1. **Lock-order inversions.** Every acquisition taken while other
   sanitized locks are held adds a ``held -> acquired`` edge to a
   process-global graph keyed by the factory NAME (instances
   aggregate: any ``kvstore.lock`` before any ``watchcache.resource``
   is one edge). A new edge that closes a cycle is a potential
   deadlock and is recorded as a finding with both stacks.
2. **Blocking calls under a lock.** While enabled, ``os.fsync``,
   ``os.fdatasync``, socket connect/accept/recv/sendall,
   ``threading.Event.wait`` *without a timeout*, and the solver's kernel
   dispatch entry points (they call :func:`check_blocking`) report a
   finding when any sanitized non-``io_gate`` lock is held. This
   generalizes the kvstore ``_wal_sync`` group-commit invariant
   ("never fsync under self._lock") into an enforced runtime check. ``io_gate=True`` marks a lock whose declared PURPOSE is
   serializing blocking I/O (the kvstore sync lock); blocking under
   only io-gate locks is the design, not a finding. A legitimate
   exception (the kvstore snapshot, a stop-the-world compaction) wraps
   itself in :func:`allow_blocking` with a reason.
3. **Leaks at teardown.** :func:`leaked_locks` lists sanitized locks
   still held by threads that have exited (a thread died holding a
   lock — every later acquirer deadlocks); the test helper's
   thread-leak guard pairs it with a live-thread snapshot.

Findings accumulate in-process (:func:`findings`, :func:`reset`); with
``KT_SANITIZE_REPORT=<path>`` the edge graph + findings are dumped as
JSON at exit so ``python -m tools.ktlint --lock-graph --runtime-graph
<path>`` can merge the observed ordering with the statically extracted
one (the node names match by construction).

A copy of `kubernetes_tpu/utils/sanitizer.py`. The report's JSON and
the lock names are JAX's, so the JAX package's ``tools.ktlint
--lock-graph --runtime-graph`` reads a port run's report. The port's
locks sit at the counterparts of JAX's sites under JAX's names, but
for one: JAX's ``sli.xla`` guards an XLA compile-cache count, and the
port's lock in its place, `utils/sli.py`'s ``_SEEN_LOCK`` (the count
of kernel builds the device telemetry has reported), is named
``sli.device``. The locks the port has
and JAX lacks (the commit worker's error list, the HTTP transport's
endpoint and recorder locks, the kernel build lock, ...) stay plain
``threading`` locks. The four :func:`check_blocking` hooks sit at the
port's kernel dispatch entry points (`scheduler/batch.py`
``schedule_backlog``, ``schedule_backlog_wave``,
``schedule_backlog_sinkhorn``, `ops/pipeline.py`
``solve_backlog_pipelined``) under the kind ``kernel-dispatch``; a
launch's host reads (``.item()``, ``.cpu()``) are not patched.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import socket
import threading
import traceback
from typing import Dict, List, Optional, Tuple

__all__ = [
    "allow_blocking",
    "check_blocking",
    "disable",
    "edges",
    "enable",
    "enabled",
    "findings",
    "held_locks",
    "leaked_locks",
    "lock",
    "report",
    "reset",
    "rlock",
]

_ENV_MODES = frozenset(
    m.strip()
    for m in os.environ.get("KT_SANITIZE", "").replace(";", ",").split(",")
    if m.strip()
)

#: Master switch. Read on every hot operation, so it must stay a plain
#: module global (one dict lookup + truth test when off).
_enabled = "locks" in _ENV_MODES or "all" in _ENV_MODES

# The sanitizer's own locks are PLAIN locks on purpose (instrumenting
# them would recurse) and are leaves: no user code ever runs under
# them.
_meta = threading.Lock()

# (held_name, acquired_name) -> {"count", "site"} — first observation
# keeps its acquisition site for the report.
_edges: Dict[Tuple[str, str], dict] = {}
_cycles_seen: set = set()
# Finding dicts: {"kind", "detail", ...}. Bounded (newest dropped) so a
# hot loop with a systematic violation can't OOM the process.
_findings: List[dict] = []
_MAX_FINDINGS = 256
_blocking_seen: set = set()

# thread ident -> (thread name, held-stack list). The list object is
# shared with that thread's TLS, so reading it from another thread
# (leak checks) sees the live stack.
_thread_stacks: Dict[int, Tuple[str, list]] = {}

_tls = threading.local()


class _Held:
    __slots__ = ("obj_id", "name", "io_gate")

    def __init__(self, obj_id: int, name: str, io_gate: bool):
        self.obj_id = obj_id
        self.name = name
        self.io_gate = io_gate


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
        t = threading.current_thread()
        with _meta:
            _thread_stacks[t.ident] = (t.name, st)
    return st


def _site(skip_prefixes=("sanitizer.py",)) -> str:
    """Compact 'file:line in func' chain of the last few frames outside
    this module. Only computed on findings/new edges — never hot."""
    frames = traceback.extract_stack()
    keep = [
        f for f in frames
        if not f.filename.endswith(skip_prefixes)
    ][-6:]
    return " <- ".join(
        f"{os.path.basename(f.filename)}:{f.lineno}({f.name})"
        for f in reversed(keep)
    )


def _add_finding(kind: str, **kw) -> None:
    with _meta:
        if len(_findings) < _MAX_FINDINGS:
            _findings.append({"kind": kind, **kw})


# -- detector 1: lock-order graph --------------------------------------


def _path_exists(src: str, dst: str) -> Optional[List[str]]:
    """DFS over _edges (caller holds _meta). Returns the node path
    src..dst if one exists."""
    stack = [(src, [src])]
    seen = {src}
    adj: Dict[str, List[str]] = {}
    for a, b in _edges:
        adj.setdefault(a, []).append(b)
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in adj.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _note_acquire(obj_id: int, name: str, io_gate: bool) -> None:
    st = _stack()
    if _enabled and st:
        for held in st:
            if held.obj_id == obj_id or held.name == name:
                # Same instance (RLock reentry is handled by the
                # wrapper) or a sibling instance of the same class —
                # same-name edges would make every two-store test a
                # false self-cycle.
                continue
            key = (held.name, name)
            with _meta:
                hit = _edges.get(key)
                if hit is not None:
                    hit["count"] += 1
                    continue
                back = _path_exists(name, held.name)
                _edges[key] = {"count": 1, "site": _site()}
                if back:
                    cycle = tuple(sorted(set(back)))
                    if cycle in _cycles_seen:
                        continue
                    _cycles_seen.add(cycle)
                    if len(_findings) < _MAX_FINDINGS:
                        _findings.append({
                            "kind": "lock-order-cycle",
                            "cycle": back + [name],
                            "edge": f"{held.name} -> {name}",
                            "site": _edges[key]["site"],
                            "reverse_site": _edges[
                                (back[0], back[1])
                            ]["site"] if len(back) > 1 else "",
                        })
    st.append(_Held(obj_id, name, io_gate))


def _note_release(obj_id: int) -> None:
    st = getattr(_tls, "stack", None)
    if not st:
        return
    # Almost always LIFO; scan from the top for the rare out-of-order
    # release (which is itself suspicious but legal for Lock objects
    # released by a different code path than acquired).
    for i in range(len(st) - 1, -1, -1):
        if st[i].obj_id == obj_id:
            del st[i]
            return


# -- detector 2: blocking calls under a lock ---------------------------


def check_blocking(kind: str, detail: str = "") -> None:
    """Record a finding if the calling thread performs blocking work
    (`kind`) while holding a sanitized non-io-gate lock. Near-zero when
    the sanitizer is off — instrument hot dispatch entry points
    freely."""
    if not _enabled:
        return
    if getattr(_tls, "allow", 0):
        return
    st = getattr(_tls, "stack", None)
    if not st:
        return
    held = [h.name for h in st if not h.io_gate]
    if not held:
        return
    dedup = (kind, tuple(held))
    with _meta:
        if dedup in _blocking_seen:
            return
        _blocking_seen.add(dedup)
    _add_finding(
        "blocking-under-lock",
        op=kind,
        detail=detail,
        locks=held,
        site=_site(),
    )


@contextlib.contextmanager
def allow_blocking(reason: str):
    """Suppress blocking-under-lock findings for a region whose
    blocking-while-locked behavior is the documented design (e.g. the
    kvstore snapshot's stop-the-world compaction). The reason string is
    the audit trail — grep for allow_blocking to review every grant."""
    _tls.allow = getattr(_tls, "allow", 0) + 1
    try:
        yield
    finally:
        _tls.allow -= 1


# -- instrumented lock types -------------------------------------------


class SanLock:
    """Instrumented non-reentrant lock. Duck-compatible with
    threading.Lock including use as the lock of a threading.Condition
    (the Condition falls back to release()/acquire() pairs, which keep
    the held-stack honest across wait())."""

    __slots__ = ("_inner", "name", "io_gate")

    def __init__(self, name: str, io_gate: bool = False):
        self._inner = threading.Lock()
        self.name = name
        self.io_gate = io_gate

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _note_acquire(id(self), self.name, self.io_gate)
        return ok

    def release(self) -> None:
        _note_release(id(self))
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<SanLock {self.name} {self._inner!r}>"


class SanRLock:
    """Instrumented reentrant lock. Tracks per-thread depth so only the
    OUTERMOST acquire/release touch the held-stack, and exposes the
    _is_owned/_release_save/_acquire_restore trio threading.Condition
    (and kvstore._wal_sync's ownership probe) relies on."""

    __slots__ = ("_inner", "name", "io_gate", "_depth")

    def __init__(self, name: str, io_gate: bool = False):
        self._inner = threading.RLock()
        self.name = name
        self.io_gate = io_gate
        self._depth = threading.local()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            d = getattr(self._depth, "n", 0)
            self._depth.n = d + 1
            if d == 0:
                _note_acquire(id(self), self.name, self.io_gate)
        return ok

    def release(self) -> None:
        # Mirror RLock: releasing an unowned lock raises BEFORE any
        # bookkeeping changes.
        self._inner.release()
        d = getattr(self._depth, "n", 1) - 1
        self._depth.n = d
        if d == 0:
            _note_release(id(self))

    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def _release_save(self):
        d = getattr(self._depth, "n", 0)
        self._depth.n = 0
        _note_release(id(self))
        return (self._inner._release_save(), d)

    def _acquire_restore(self, state) -> None:
        inner_state, d = state
        self._inner._acquire_restore(inner_state)
        self._depth.n = d
        _note_acquire(id(self), self.name, self.io_gate)

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<SanRLock {self.name} {self._inner!r}>"


def lock(name: str, io_gate: bool = False):
    """A named mutex: plain threading.Lock when the sanitizer is off,
    instrumented SanLock when on. `io_gate` marks a lock that exists to
    serialize blocking I/O (see module docstring)."""
    if _enabled:
        return SanLock(name, io_gate)
    return threading.Lock()


def rlock(name: str, io_gate: bool = False):
    """Named reentrant mutex; see lock()."""
    if _enabled:
        return SanRLock(name, io_gate)
    return threading.RLock()


# -- blocking-call patches ---------------------------------------------

_ABSENT = object()
_patches: List[Tuple[object, str, object]] = []


def _patch(owner, attr: str, wrapper) -> None:
    prev = owner.__dict__.get(attr, _ABSENT) if isinstance(owner, type) \
        else getattr(owner, attr, _ABSENT)
    _patches.append((owner, attr, prev))
    setattr(owner, attr, wrapper)


def _install_patches() -> None:
    if _patches:
        return

    orig_fsync = os.fsync
    orig_fdatasync = getattr(os, "fdatasync", None)
    orig_event_wait = threading.Event.wait
    sock_base = socket.socket.__bases__[0]  # _socket.socket

    def fsync(fd):
        check_blocking("fsync")
        return orig_fsync(fd)

    _patch(os, "fsync", fsync)

    if orig_fdatasync is not None:
        def fdatasync(fd):
            check_blocking("fsync")
            return orig_fdatasync(fd)

        _patch(os, "fdatasync", fdatasync)

    def event_wait(self, timeout=None):
        if timeout is None:
            check_blocking("event-wait-no-timeout")
        return orig_event_wait(self, timeout)

    _patch(threading.Event, "wait", event_wait)

    def _sock_wrapper(method_name):
        orig = getattr(sock_base, method_name)

        def wrapper(self, *args, **kw):
            check_blocking("socket-" + method_name)
            return orig(self, *args, **kw)

        wrapper.__name__ = method_name
        return wrapper

    for m in ("connect", "recv", "sendall"):
        # accept() is wrapped at the Python level already and servers
        # legitimately block in it forever; connect/recv/sendall are
        # the calls that stall request paths.
        _patch(socket.socket, m, _sock_wrapper(m))


def _remove_patches() -> None:
    while _patches:
        owner, attr, prev = _patches.pop()
        if prev is _ABSENT:
            try:
                delattr(owner, attr)
            except AttributeError:
                pass
        else:
            setattr(owner, attr, prev)


# -- control + reporting -----------------------------------------------


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Turn the sanitizer on for locks created FROM NOW ON (existing
    plain locks stay plain — tests construct their stores/daemons after
    enabling, which is what the conftest fixture does)."""
    global _enabled
    _enabled = True
    _install_patches()


def disable() -> None:
    global _enabled
    _enabled = False
    _remove_patches()


def findings() -> List[dict]:
    with _meta:
        return list(_findings)


def reset() -> None:
    """Drop findings and the dedup memory; KEEP the edge graph (lock
    order is a process-lifetime property — two tests that each take
    half of a cycle should still be caught). Dead threads' EMPTY
    stacks are pruned (pure bookkeeping); a dead thread still holding
    a lock is preserved for leaked_locks()."""
    alive = {t.ident for t in threading.enumerate()}
    with _meta:
        del _findings[:]
        _blocking_seen.clear()
        for ident in [
            i for i, (_n, st) in _thread_stacks.items()
            if not st and i not in alive
        ]:
            del _thread_stacks[ident]


def purge_dead_threads() -> None:
    """Forget locks held by dead threads — for test harness use AFTER
    a deliberate leak has been asserted, so the state doesn't bleed
    into the next test's leak check."""
    alive = {t.ident for t in threading.enumerate()}
    with _meta:
        for ident in [i for i in _thread_stacks if i not in alive]:
            del _thread_stacks[ident]


def edges() -> List[dict]:
    with _meta:
        return [
            {"from": a, "to": b, "count": e["count"], "site": e["site"]}
            for (a, b), e in sorted(_edges.items())
        ]


def held_locks() -> List[Tuple[str, str]]:
    """(thread name, lock name) for every sanitized lock currently
    held anywhere in the process."""
    out = []
    with _meta:
        snap = list(_thread_stacks.items())
    for _ident, (tname, st) in snap:
        for h in list(st):
            out.append((tname, h.name))
    return out


def leaked_locks() -> List[Tuple[str, str]]:
    """(thread name, lock name) held by threads that are no longer
    alive — a thread died holding a lock; every later acquirer
    deadlocks."""
    alive = {t.ident for t in threading.enumerate()}
    out = []
    with _meta:
        snap = list(_thread_stacks.items())
    for ident, (tname, st) in snap:
        if ident in alive:
            continue
        for h in list(st):
            out.append((tname, h.name))
    return out


def report() -> dict:
    """Everything the static side can merge: the observed edge graph
    plus findings (tools/ktlint --lock-graph --runtime-graph FILE)."""
    return {"edges": edges(), "findings": findings()}


def _atexit_report() -> None:
    path = os.environ.get("KT_SANITIZE_REPORT", "")
    if not path or not _enabled:
        return
    try:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(report(), f, indent=2, sort_keys=True)
    except OSError:
        pass


if _enabled:
    _install_patches()
atexit.register(_atexit_report)
