"""List/watch cache substrate: ThreadSafeStore/Indexer, FIFO/DeltaFIFO,
ExpirationCache, UndeltaStore, Reflector, Informer.

A copy of `kubernetes_tpu/client/cache.py` (reference: pkg/client/cache/
store.go, index.go, fifo.go, delta_fifo.go, expiration_cache.go,
undelta_store.go, reflector.go:80-268, and
pkg/controller/framework/controller.go NewInformer), its locks from the
sanitizer's factory under JAX's names (`informer.store`,
`informer.fifo`, `informer.deltafifo`). The Reflector lists, primes
its store, then applies watch deltas from the list's version; a transport failure resumes the watch
from the last version seen, a 410 (history compacted) re-lists, and a
re-list hands objects that vanished meanwhile to the handlers as
DELETED, so delta subscribers never keep phantom state.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from kubernetes_tpu_torch.client.rest import ADDED, DELETED, ERROR, MODIFIED, APIError
from kubernetes_tpu_torch.utils import sanitizer


def meta_namespace_key(obj) -> str:
    """Default key func (reference: cache.MetaNamespaceKeyFunc); reads
    typed objects and wire dicts alike."""
    if isinstance(obj, dict):
        meta = obj.get("metadata", {})
        ns, name = meta.get("namespace", ""), meta.get("name", "")
    else:
        ns, name = obj.metadata.namespace, obj.metadata.name
    return f"{ns}/{name}" if ns else name


class ThreadSafeStore:
    """Keyed object cache (reference: cache.ThreadSafeStore)."""

    def __init__(self, key_func: Callable = meta_namespace_key):
        self._lock = sanitizer.rlock("informer.store")
        self._items: Dict[str, Any] = {}
        self.key_func = key_func

    def add(self, obj) -> None:
        with self._lock:
            self._items[self.key_func(obj)] = obj

    def update(self, obj) -> None:
        self.add(obj)

    def delete(self, obj) -> None:
        with self._lock:
            self._items.pop(self.key_func(obj), None)

    def get(self, key: str):
        with self._lock:
            return self._items.get(key)

    def list(self) -> List[Any]:
        with self._lock:
            return list(self._items.values())

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._items.keys())

    def replace(self, objs: List[Any]) -> None:
        with self._lock:
            self._items = {self.key_func(o): o for o in objs}

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


class Indexer(ThreadSafeStore):
    """ThreadSafeStore with named secondary indexes (reference:
    cache.Indexer, index.go). An index func maps an object to a list
    of index values; by_index(name, value) returns every object whose
    func emitted that value — e.g. pods by node, endpoints by service."""

    def __init__(
        self,
        indexers: Optional[Dict[str, Callable[[Any], List[str]]]] = None,
        key_func: Callable = meta_namespace_key,
    ):
        super().__init__(key_func)
        self.indexers = dict(indexers or {})
        # index name -> value -> set of object keys
        self._indices: Dict[str, Dict[str, set]] = {
            name: {} for name in self.indexers
        }
        # Reverse map: key -> [(index name, value), ...] it was indexed
        # under, so unindexing is O(entries for that key) instead of a
        # scan over every bucket of every index (which would serialize
        # readers behind thousands of set.discards per pod update).
        self._indexed_under: Dict[str, List[tuple]] = {}

    def _unindex(self, key: str) -> None:
        for name, value in self._indexed_under.pop(key, ()):
            bucket = self._indices[name].get(value)
            if bucket is not None:
                bucket.discard(key)
                if not bucket:
                    del self._indices[name][value]

    def _index(self, key: str, obj: Any) -> None:
        under = []
        for name, fn in self.indexers.items():
            for value in fn(obj):
                self._indices[name].setdefault(value, set()).add(key)
                under.append((name, value))
        if under:
            self._indexed_under[key] = under

    def add(self, obj) -> None:
        with self._lock:
            key = self.key_func(obj)
            self._unindex(key)
            self._items[key] = obj
            self._index(key, obj)

    def delete(self, obj) -> None:
        with self._lock:
            key = self.key_func(obj)
            self._unindex(key)
            self._items.pop(key, None)

    def replace(self, objs: List[Any]) -> None:
        with self._lock:
            self._items = {self.key_func(o): o for o in objs}
            self._indices = {name: {} for name in self.indexers}
            self._indexed_under = {}
            for key, obj in self._items.items():
                self._index(key, obj)

    def by_index(self, name: str, value: str) -> List[Any]:
        with self._lock:
            keys = self._indices.get(name, {}).get(value, ())
            return [self._items[k] for k in keys if k in self._items]

    def index_values(self, name: str) -> List[str]:
        with self._lock:
            return sorted(
                v for v, keys in self._indices.get(name, {}).items() if keys
            )


class ExpirationCache(ThreadSafeStore):
    """TTL store: entries vanish ttl seconds after their last add
    (reference: cache.ExpirationCache, expiration_cache.go — backs the
    scheduler's assumed-pods window)."""

    def __init__(self, ttl: float, key_func: Callable = meta_namespace_key):
        super().__init__(key_func)
        self.ttl = ttl
        self._stamps: Dict[str, float] = {}

    def _expire_locked(self) -> None:
        now = time.monotonic()
        for key in [k for k, t in self._stamps.items() if now - t > self.ttl]:
            del self._stamps[key]
            self._items.pop(key, None)

    def add(self, obj) -> None:
        with self._lock:
            self._expire_locked()
            key = self.key_func(obj)
            self._items[key] = obj
            self._stamps[key] = time.monotonic()

    def delete(self, obj) -> None:
        with self._lock:
            key = self.key_func(obj)
            self._items.pop(key, None)
            self._stamps.pop(key, None)

    def get(self, key: str):
        with self._lock:
            self._expire_locked()
            return self._items.get(key)

    def list(self) -> List[Any]:
        with self._lock:
            self._expire_locked()
            return list(self._items.values())

    def keys(self) -> List[str]:
        with self._lock:
            self._expire_locked()
            return list(self._items.keys())

    def __len__(self) -> int:
        with self._lock:
            self._expire_locked()
            return len(self._items)


class UndeltaStore(ThreadSafeStore):
    """Store that pushes the FULL current state to a callback on every
    change (reference: cache.UndeltaStore, undelta_store.go — feeds
    consumers that want snapshots, e.g. the proxy's OnUpdate).

    The snapshot is captured AND delivered under the store lock
    (reentrant), so pushes arrive in mutation order and the last push
    always reflects the final state; the callback must not block or
    mutate the store."""

    def __init__(
        self,
        push: Callable[[List[Any]], None],
        key_func: Callable = meta_namespace_key,
    ):
        super().__init__(key_func)
        self.push = push

    def add(self, obj) -> None:
        with self._lock:
            super().add(obj)
            self.push(self.list())

    def delete(self, obj) -> None:
        with self._lock:
            super().delete(obj)
            self.push(self.list())

    def replace(self, objs: List[Any]) -> None:
        with self._lock:
            super().replace(objs)
            self.push(self.list())


class FIFO:
    """Producer/consumer queue with key dedup: a pop returns the latest
    version of each enqueued object (reference: cache.FIFO,
    fifo.go:49-184)."""

    def __init__(self, key_func: Callable = meta_namespace_key):
        self._lock = sanitizer.lock("informer.fifo")
        self._cond = threading.Condition(self._lock)
        self._items: Dict[str, Any] = {}
        self._queue: List[str] = []
        self._closed = False
        self._wakes: List = []
        self.key_func = key_func

    def attach_wake(self, event) -> None:
        """Register a threading.Event set whenever the queue gains items
        (or closes): the daemon's micro-tick waits on one event fed by
        queue arrivals, watch deltas and commit releases."""
        with self._cond:
            self._wakes.append(event)

    def _signal_locked(self) -> None:
        for ev in self._wakes:
            ev.set()

    def add(self, obj) -> None:
        key = self.key_func(obj)
        with self._cond:
            if key not in self._items:
                self._queue.append(key)
            self._items[key] = obj
            self._cond.notify()
            self._signal_locked()

    update = add

    def delete(self, obj) -> None:
        key = self.key_func(obj)
        with self._cond:
            self._items.pop(key, None)  # lazy: pop skips keys without items

    def pop(self, timeout: Optional[float] = None):
        """Blocking pop (reference: fifo.go:168). None on close/timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                while self._queue:
                    key = self._queue.pop(0)
                    if key in self._items:
                        return self._items.pop(key)
                if self._closed:
                    return None
                wait = None
                if deadline is not None:
                    wait = deadline - time.monotonic()
                    if wait <= 0:
                        return None
                self._cond.wait(timeout=wait)

    def replace(self, objs: List[Any]) -> None:
        with self._cond:
            self._items = {self.key_func(o): o for o in objs}
            self._queue = list(self._items.keys())
            self._cond.notify_all()
            self._signal_locked()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            self._signal_locked()

    def peek(self):
        """The object the next pop returns, left queued; None when empty."""
        with self._lock:
            for key in self._queue:
                if key in self._items:
                    return self._items[key]
        return None

    def __len__(self) -> int:
        with self._lock:
            return len([k for k in self._queue if k in self._items])

    def list(self) -> List[Any]:
        """The queued objects (a snapshot)."""
        with self._lock:
            return list(self._items.values())


class DeltaFIFO:
    """FIFO of per-key DELTA LISTS (reference: cache.DeltaFIFO,
    delta_fifo.go). Unlike FIFO — whose key dedup silently drops
    deletions that race a pending add — a pop returns the ordered
    [(type, object), ...] history for one key since its last pop, so
    consumers observe every transition including Deleted. replace()
    emits Sync deltas and synthesizes Deleted for keys that vanished."""

    SYNC = "SYNC"

    def __init__(self, key_func: Callable = meta_namespace_key):
        self.key_func = key_func
        self._cond = threading.Condition(sanitizer.lock("informer.deltafifo"))
        self._deltas: Dict[str, List[tuple]] = {}
        self._queue: List[str] = []
        self._known: Dict[str, Any] = {}  # last object seen per key
        self._closed = False

    def _append(self, key: str, etype: str, obj: Any) -> None:
        if key not in self._deltas:
            self._deltas[key] = []
            self._queue.append(key)
        self._deltas[key].append((etype, obj))
        self._cond.notify()

    def add(self, obj) -> None:
        with self._cond:
            key = self.key_func(obj)
            etype = MODIFIED if key in self._known else ADDED
            self._known[key] = obj
            self._append(key, etype, obj)

    def update(self, obj) -> None:
        self.add(obj)

    def delete(self, obj) -> None:
        with self._cond:
            key = self.key_func(obj)
            self._known.pop(key, None)
            self._append(key, DELETED, obj)

    def replace(self, objs: List[Any]) -> None:
        with self._cond:
            new = {self.key_func(o): o for o in objs}
            for key, old in list(self._known.items()):
                if key not in new:
                    self._known.pop(key)
                    self._append(key, DELETED, old)
            for key, obj in new.items():
                self._known[key] = obj
                self._append(key, self.SYNC, obj)

    def pop(self, timeout: Optional[float] = None) -> Optional[List[tuple]]:
        """Oldest key's delta list, or None on close/timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if self._queue:
                    key = self._queue.pop(0)
                    return self._deltas.pop(key)
                if self._closed:
                    return None
                wait = None
                if deadline is not None:
                    wait = deadline - time.monotonic()
                    if wait <= 0:
                        return None
                self._cond.wait(timeout=wait)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return len(self._queue)


class Reflector:
    """List+watch loop feeding a store (reference: reflector.go:80-268).

    `store` needs add/update/delete/replace. Objects land in wire form
    unless `decode` converts them; with `decode_deleted=False` a DELETED
    event hands the raw wire dict on (deletions need only the key). With
    a `decode`, the LIST is read in wire form too (`Client.list_wire`)
    and decoded by it, so a controller that decodes into the whole model
    (`models/apiobjects.py`) gets it from the LIST as from the watch;
    without one, the LIST's objects are typed by the client.
    `last_event_mono` is when a delta or re-list was last processed
    (the daemon's informer-staleness gauge reads it)."""

    #: Empty watch closes tolerated before falling back to a re-list.
    _RELIST_AFTER_IDLE_CLOSES = 3

    def __init__(
        self,
        client,
        resource: str,
        store,
        namespace: str = "",
        label_selector: str = "",
        field_selector: str = "",
        decode: Optional[Callable[[dict], Any]] = None,
        on_event: Optional[Callable] = None,
        decode_deleted: bool = True,
    ):
        self.client = client
        self.resource = resource
        self.store = store
        self.namespace = namespace
        self.label_selector = label_selector
        self.field_selector = field_selector
        self._list_wire = decode is not None and hasattr(client, "list_wire")
        self.decode = decode or (lambda o: o)
        self.on_event = on_event
        self.decode_deleted = decode_deleted
        self.last_sync_version = 0
        self.last_event_mono = 0.0
        # Set once a cycle reaches its watch: a cycle that dies in the
        # watch resumes it from last_sync_version instead of re-listing.
        self._resume_watch = False
        self.list_count = 0  # full LISTs issued
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._synced = threading.Event()
        self._stream = None  # in-flight watch; closed by stop()

    def start(self) -> "Reflector":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        stream = self._stream
        if stream is not None:
            try:
                stream.close()
            except Exception:
                pass
        if self._thread:
            self._thread.join(timeout=5)

    def wait_for_sync(self, timeout: float = 10.0) -> bool:
        return self._synced.wait(timeout)

    def _run(self) -> None:
        backoff = 0.05
        while not self._stop.is_set():
            try:
                progressed = self._list_and_watch()
            except Exception:
                if self._stop.is_set():
                    return
                time.sleep(backoff)
                backoff = min(backoff * 2, 5.0)
                continue
            if progressed:
                backoff = 0.05
            elif not self._stop.is_set():
                # The watch is being shed: back off before re-listing.
                self._stop.wait(backoff)
                backoff = min(backoff * 2, 5.0)

    def _list_and_watch(self) -> bool:
        """One LIST + watch cycle (the LIST skipped when resuming).
        Returns False only when the watch was abandoned after
        consecutive closes that delivered nothing."""
        resume = self._resume_watch and self.last_sync_version > 0
        self._resume_watch = False
        if not resume:
            self._list()
        idle_closes = 0
        self._resume_watch = True
        while not self._stop.is_set():
            try:
                stream = self.client.watch(
                    self.resource,
                    namespace=self.namespace,
                    since=self.last_sync_version,
                    label_selector=self.label_selector,
                    field_selector=self.field_selector,
                )
            except APIError as e:
                if e.code == 410:  # history compacted: re-list
                    self._resume_watch = False
                    return True
                raise
            self._stream = stream
            try:
                delivered = self._consume(stream)
            finally:
                self._stream = None
                stream.close()
            if self._stop.is_set():
                return True
            if delivered:
                idle_closes = 0
                continue
            idle_closes += 1
            if idle_closes >= self._RELIST_AFTER_IDLE_CLOSES:
                self._resume_watch = False
                return False
            self._stop.wait(min(0.05 * (2 ** idle_closes), 2.0))
        return True

    def _list(self) -> None:
        """Full LIST, store replace, and the synthesized deltas: DELETED
        for objects that vanished, ADDED for every listed one."""
        items, version = (self.client.list_wire if self._list_wire else self.client.list)(
            self.resource,
            namespace=self.namespace,
            label_selector=self.label_selector,
            field_selector=self.field_selector,
        )
        self.list_count += 1
        objs = [self.decode(o) if isinstance(o, dict) else o for o in items]
        vanished = []
        if self.on_event is not None and hasattr(self.store, "keys"):
            key_func = getattr(self.store, "key_func", meta_namespace_key)
            new_keys = {key_func(o) for o in objs}
            for k in self.store.keys():
                if k not in new_keys:
                    old = self.store.get(k)
                    if old is not None:
                        vanished.append(old)
        self.store.replace(objs)
        self.last_sync_version = version
        self.last_event_mono = time.monotonic()
        self._synced.set()
        if self.on_event:
            for o in vanished:
                self.on_event(DELETED, o)
            for o in objs:
                self.on_event(ADDED, o)

    def _consume(self, stream) -> int:
        """Drain `stream` until it closes; returns events processed."""
        delivered = 0
        while not self._stop.is_set():
            ev = stream.next(timeout=10.0)
            if ev is None:
                if stream.closed:
                    return delivered
                continue
            if ev.type == ERROR:
                return delivered
            if ev.type == DELETED and not self.decode_deleted and isinstance(ev.object, dict):
                obj = ev.object
            elif isinstance(ev.object, dict):
                obj = self.decode(ev.object)
            else:
                obj = ev.object
            if ev.version:
                self.last_sync_version = ev.version
            self.last_event_mono = time.monotonic()
            if ev.type == ADDED:
                self.store.add(obj)
            elif ev.type == MODIFIED:
                self.store.update(obj)
            elif ev.type == DELETED:
                self.store.delete(obj)
            delivered += 1
            if self.on_event:
                self.on_event(ev.type, obj)
        return delivered


class Informer:
    """Reflector + cache + event handlers (reference:
    framework.NewInformer, controller.go:201)."""

    def __init__(
        self,
        client,
        resource: str,
        namespace: str = "",
        label_selector: str = "",
        field_selector: str = "",
        decode: Optional[Callable] = None,
        on_add: Optional[Callable] = None,
        on_update: Optional[Callable] = None,
        on_delete: Optional[Callable] = None,
        decode_deleted: bool = True,
    ):
        self.store = ThreadSafeStore()
        self._on_add = on_add
        self._on_update = on_update
        self._on_delete = on_delete
        self.reflector = Reflector(
            client,
            resource,
            self.store,
            namespace=namespace,
            label_selector=label_selector,
            field_selector=field_selector,
            decode=decode,
            on_event=self._handle,
            decode_deleted=decode_deleted,
        )

    def _handle(self, etype: str, obj) -> None:
        if etype == ADDED and self._on_add:
            self._on_add(obj)
        elif etype == MODIFIED and self._on_update:
            self._on_update(obj)
        elif etype == DELETED and self._on_delete:
            self._on_delete(obj)

    def start(self) -> "Informer":
        self.reflector.start()
        return self

    def stop(self) -> None:
        self.reflector.stop()

    def wait_for_sync(self, timeout: float = 10.0) -> bool:
        return self.reflector.wait_for_sync(timeout)
