"""Event recording: broadcaster, recorder, and the aggregating sink.

A copy of `kubernetes_tpu/client/record.py` (reference:
pkg/client/record/event.go, EventBroadcaster + EventRecorder.Eventf ->
sinks, and events_cache.go:52-69): events identical in (source,
involved object, reason, message) within the cache window become one
Event whose count and lastTimestamp advance, so a pod that fails to
schedule tick after tick leaves one FailedScheduling event, not one a
tick. A drain burst of fresh events goes out as one bulk request.

Events are observability, never control flow: recording is async and
every sink failure is swallowed.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.models.objects import now_iso

# Process-wide event-name uniquifier.
_event_seq = itertools.count()

# Aggregation cache: an LRU of 4096, with a TTL so a long-lived daemon
# does not resurrect old counts.
_CACHE_TTL = 3600.0
_CACHE_MAX = 4096


def _event_key(ev: dict) -> Tuple:
    inv = ev.get("involvedObject", {})
    return (
        ev.get("source", {}).get("component", ""),
        inv.get("kind", ""),
        inv.get("namespace", ""),
        inv.get("name", ""),
        inv.get("uid", ""),
        ev.get("reason", ""),
        ev.get("message", ""),
    )


@dataclass
class _CacheEntry:
    name: str  # the stored event's object name
    namespace: str
    count: int
    first_timestamp: str
    last_seen: float = field(default_factory=time.monotonic)


class EventAggregator:
    """Dedup state (reference: events_cache.go eventsCache)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[Tuple, _CacheEntry] = {}

    def observe(self, ev: dict) -> Optional[_CacheEntry]:
        """The existing entry, bumped, when `ev` is a repeat; else None."""
        key = _event_key(ev)
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and now - entry.last_seen < _CACHE_TTL:
                entry.count += 1
                entry.last_seen = now
                return entry
            return None

    def track(self, ev: dict) -> None:
        key = _event_key(ev)
        with self._lock:
            if len(self._entries) >= _CACHE_MAX:
                oldest = min(self._entries, key=lambda k: self._entries[k].last_seen)
                del self._entries[oldest]
            self._entries[key] = _CacheEntry(
                name=ev["metadata"]["name"],
                namespace=ev["metadata"]["namespace"],
                count=int(ev.get("count", 1)),
                first_timestamp=ev.get("firstTimestamp", ""),
            )


class EventRecorder:
    """Component-scoped recorder (reference: EventRecorder.Eventf)."""

    def __init__(self, broadcaster: "EventBroadcaster", component: str):
        self.broadcaster = broadcaster
        self.component = component

    def event(self, involved, reason: str, message: str) -> None:
        wire = involved if isinstance(involved, dict) else None
        if wire is None:
            from kubernetes_tpu_torch.models import serde

            wire = serde.to_wire(involved)
        meta = wire.get("metadata", {})
        ns = meta.get("namespace", "") or "default"
        ts = now_iso()
        self.broadcaster.emit({
            "kind": "Event",
            "apiVersion": "v1",
            "metadata": {
                # Timestamp and a per-process counter: two events in the
                # same microsecond must not collide on create.
                "name": f"{meta.get('name', 'unknown')}"
                        f".{int(time.time() * 1e6):x}.{next(_event_seq):x}",
                "namespace": ns,
            },
            "involvedObject": {
                "kind": wire.get("kind", ""),
                "name": meta.get("name", ""),
                "namespace": ns,
                "uid": meta.get("uid", ""),
            },
            "reason": reason,
            "message": message,
            "source": {"component": self.component},
            "firstTimestamp": ts,
            "lastTimestamp": ts,
            "count": 1,
        })


class _SinkHandler:
    """API sink with dedup and batched writes: `batch` takes a drain
    burst."""

    def __init__(self, client):
        self.client = client
        self.aggregator = EventAggregator()
        self._bulk_ok: Optional[bool] = None  # None = probe on the first batch

    def _bump_repeat(self, entry: _CacheEntry, ev: dict) -> None:
        """A repeat: advance count and lastTimestamp on the stored event."""
        try:
            stored = self.client.get("events", entry.name, namespace=entry.namespace)
            stored.count = entry.count
            stored.last_timestamp = now_iso()
            self.client.update("events", stored, namespace=entry.namespace)
        except Exception:
            # The stored event expired: create it again with the count.
            self._create_one(dict(ev, count=entry.count))

    def _create_one(self, ev: dict) -> None:
        try:
            self.client.create("events", ev, namespace=ev["metadata"]["namespace"])
            self.aggregator.track(ev)
        except Exception:
            pass

    def batch(self, evs: List[dict]) -> None:
        fresh: List[dict] = []
        in_batch: Dict[Tuple, dict] = {}  # repeats within the burst
        for ev in evs:
            key = _event_key(ev)
            first = in_batch.get(key)
            if first is not None:
                # Compress into the burst's first occurrence, as
                # sequential dedup would have.
                first["count"] = int(first.get("count", 1)) + 1
                first["lastTimestamp"] = ev.get("lastTimestamp", first.get("lastTimestamp", ""))
                continue
            entry = self.aggregator.observe(ev)
            if entry is not None:
                self._bump_repeat(entry, ev)
            else:
                in_batch[key] = ev
                fresh.append(ev)
        if not fresh:
            return
        if len(fresh) == 1 or self._bulk_ok is False:
            for ev in fresh:
                self._create_one(ev)
            return
        try:
            results = self.client.create_events_bulk(fresh)
            self._bulk_ok = True
        except Exception as e:
            # A server or transport without the bulk path falls back to
            # one create an event for good; any other failure drops the
            # burst (the server may have applied it, and a re-create
            # would write duplicates).
            from kubernetes_tpu_torch.client.rest import APIError

            if isinstance(e, (ValueError, TypeError)) or (
                    isinstance(e, APIError) and e.code in (400, 404, 405)):
                self._bulk_ok = False
                for ev in fresh:
                    self._create_one(ev)
            return
        for ev, res in zip(fresh, results):
            if isinstance(res, dict) and res.get("status") == "Success":
                self.aggregator.track(ev)


class EventBroadcaster:
    """Fan-out hub: recorders push, sinks drain on a thread of their own
    (reference: event.go NewBroadcaster over watch.Mux)."""

    _BURST = 64  # most events delivered in one batch

    def __init__(self, queue_len: int = 1000):
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_len)
        self._watchers: List[_SinkHandler] = []
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        self._started = False

    def new_recorder(self, component: str = "") -> EventRecorder:
        return EventRecorder(self, component)

    def emit(self, ev: dict) -> None:
        try:
            self._queue.put_nowait(ev)
        except queue.Full:
            pass  # observability never blocks its callers

    def start_recording_to_sink(self, client) -> "EventBroadcaster":
        """Write events through the dedup cache to the events API
        (reference: StartRecordingToSink)."""
        return self._add_watcher(_SinkHandler(client))

    def _add_watcher(self, handler: _SinkHandler) -> "EventBroadcaster":
        with self._lock:
            self._watchers.append(handler)
            if not self._started:
                self._started = True
                t = threading.Thread(target=self._drain, daemon=True)
                t.start()
                self._threads.append(t)
        return self

    def flush(self, timeout: float = 2.0) -> bool:
        """Block until everything emitted before this call went through
        every sink."""
        done = threading.Event()
        try:
            self._queue.put(("__flush__", done), timeout=timeout)
        except queue.Full:
            return False
        return done.wait(timeout)

    def _deliver(self, burst: List[dict]) -> None:
        if not burst:
            return
        with self._lock:
            watchers = list(self._watchers)
        for w in watchers:
            try:
                w.batch(burst)
            except Exception:
                pass

    def _drain(self) -> None:
        while True:
            ev = self._queue.get()
            stopping = False
            burst: List[dict] = []
            while True:
                if ev is None:
                    stopping = True
                    break
                if isinstance(ev, tuple) and ev[0] == "__flush__":
                    self._deliver(burst)
                    burst = []
                    ev[1].set()
                else:
                    burst.append(ev)
                    if len(burst) >= self._BURST:
                        break
                try:
                    ev = self._queue.get_nowait()
                except queue.Empty:
                    break
            self._deliver(burst)
            if stopping:
                return
