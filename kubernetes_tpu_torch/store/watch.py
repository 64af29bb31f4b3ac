"""Watch events and streams.

Behavioral parity with pkg/watch/ (Event{Added,Modified,Deleted,Error},
watch.Interface) and the etcd->watch translation in
pkg/tools/etcd_helper_watch.go. A WatchStream is a bounded queue the
store pushes into; consumers iterate or poll with timeouts.

A copy of `kubernetes_tpu/store/watch.py`, with its chaos seams
(`watch.stream.drop`, `watch.stream.delay`; `utils/faults.py`) and the
sanitizer's `watch.broadcaster` lock where JAX's are.
"""

from __future__ import annotations

import logging
import queue
import threading
from dataclasses import dataclass
from typing import Any, Iterator, List, Optional

from kubernetes_tpu_torch.utils import faults, metrics, sanitizer

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"
ERROR = "ERROR"

_LOG = logging.getLogger("kubernetes_tpu_torch.store.watch")

#: Slow-consumer watch streams dropped (each forces the consumer to
#: re-list). This drop used to be SILENT — a bulk churn drill would
#: quietly lose its watch and report rates that excluded fan-out cost.
STREAMS_DROPPED = metrics.DEFAULT.counter(
    "watch_streams_dropped_total",
    "Watch streams dropped for falling behind (slow consumers)",
    ("resource",),
)

#: Sampled event-queue depth per resource — a rough backpressure gauge
#: (deep queues mean consumers are trailing the dispatcher and drops
#: are near). Updated every 64 queued events and at the drop site, NOT
#: per push: the fan-out path is the burst-coalesced hot path,
#: and a healthy (shallow) queue is exactly the case that needs zero
#: added cost. One gauge per resource, not per stream: label
#: cardinality must not scale with watcher count.
QUEUE_DEPTH = metrics.DEFAULT.gauge(
    "watch_stream_queue_depth",
    "Sampled watch stream queue depth (every 64 queued events and at "
    "slow-consumer drops), by resource",
    ("resource",),
)


def resource_of_prefix(prefix: str) -> str:
    """The resource name inside a registry key prefix
    ('/registry/pods/default/' -> 'pods'); the prefix itself when the
    shape is foreign (metric label fallback)."""
    parts = prefix.strip("/").split("/")
    if len(parts) >= 2 and parts[0] == "registry":
        return parts[1]
    return prefix


@dataclass
class Event:
    type: str
    object: Any  # wire-form dict (or Status dict for ERROR)
    version: int = 0  # store logical clock at event time

    @property
    def key(self) -> str:
        meta = self.object.get("metadata", {}) if isinstance(self.object, dict) else {}
        ns = meta.get("namespace", "")
        return f"{ns}/{meta.get('name', '')}" if ns else meta.get("name", "")


class WatchStream:
    """One consumer's view of a watch. Closed by either side."""

    def __init__(self, maxsize: int = 4096, resource: str = ""):
        self._q: "queue.Queue[Optional[Event]]" = queue.Queue(maxsize=maxsize)
        self._closed = threading.Event()
        # Version floor: events at or below it are silently dropped.
        # The store sets it at registration time so the async dispatch
        # thread's backlog (events the registration-time replay already
        # covered) can never be double-delivered or re-ordered.
        self.floor = 0
        #: Resource this stream watches (metric label for the drop
        #: counter / depth gauge; "" for anonymous broadcast streams).
        self.resource = resource

    def push(self, ev: Event) -> bool:
        if self._closed.is_set():
            return False
        if ev.version and ev.version <= self.floor:
            return True  # already covered by replay — drop, stay open
        if faults.enabled() and self.resource and self.resource != "broadcast":
            # Chaos seams, store-fed streams only (anonymous broadcast
            # streams have no re-list recovery path to exercise): a
            # forced slow-consumer drop takes the exact branch below;
            # the delay site stalls delivery on the dispatcher thread.
            if faults.fire(faults.WATCH_DROP, self.resource):
                return self._drop_slow_consumer()
            faults.fire(faults.WATCH_DELAY, self.resource)
        try:
            self._q.put_nowait(ev)
            depth = self._q.qsize()
            if not depth & 63:  # sampled: zero cost while shallow
                QUEUE_DEPTH.set(depth, resource=self.resource)
            return True
        except queue.Full:
            return self._drop_slow_consumer()

    def _drop_slow_consumer(self) -> bool:
        # Slow consumer: drop the stream (reference watchers are also
        # terminated and must re-list; Reflector handles that) —
        # OBSERVABLY: the counter + warn log are what tell an
        # operator the churn figures just stopped including this
        # consumer's fan-out cost.
        STREAMS_DROPPED.inc(resource=self.resource)
        QUEUE_DEPTH.set(self._q.qsize(), resource=self.resource)
        _LOG.warning(
            "dropping slow watch consumer (resource=%r, version "
            "floor=%d, queue depth=%d/%d); it must re-list",
            self.resource, self.floor, self._q.qsize(),
            self._q.maxsize,
        )
        self.close()
        return False

    def next(self, timeout: Optional[float] = None) -> Optional[Event]:
        """Next event, or None on close/timeout."""
        if self._closed.is_set() and self._q.empty():
            return None
        try:
            ev = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        return ev

    def close(self) -> None:
        if not self._closed.is_set():
            self._closed.set()
            try:
                self._q.put_nowait(None)  # wake blocked consumers
            except queue.Full:
                pass

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def __iter__(self) -> Iterator[Event]:
        while True:
            ev = self.next()
            if ev is None:
                return
            yield ev


class Broadcaster:
    """Fan-out of events to many streams (reference: pkg/watch/mux.go)."""

    def __init__(self):
        self._lock = sanitizer.lock("watch.broadcaster")
        self._streams: List[WatchStream] = []

    def watch(self, maxsize: int = 4096) -> WatchStream:
        s = WatchStream(maxsize=maxsize, resource="broadcast")
        with self._lock:
            self._streams.append(s)
        return s

    def action(self, ev: Event) -> None:
        with self._lock:
            live = []
            for s in self._streams:
                if s.push(ev) or not s.closed:
                    if not s.closed:
                        live.append(s)
            self._streams = live

    def close(self) -> None:
        with self._lock:
            for s in self._streams:
                s.close()
            self._streams = []
