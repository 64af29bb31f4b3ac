"""The apiserver-resident watch cache: an event-fed read path.

Reference: pkg/storage/cacher (the etcd watch cache the reference grew
into) and PAPER.md §1 layer 4 — reads should be served from memory kept
current by the event stream, never by scanning the store.

One `WatchCacheSet` subscribes ONCE to the kvstore's dispatcher
(`KVStore.subscribe`) and routes every event to a per-resource
`ResourceCache` keyed by registry prefix. Each cache holds:

- `key -> _Entry(obj, version, enc)` — the stored object REF (the
  store's objects are never mutated in place, so sharing the ref is
  safe and copy-free) plus a lazily computed JSON encoding. Because the
  store's logical clock is global and every write bumps it, an object's
  resourceVersion uniquely identifies its bytes — the encode cache can
  never serve stale bytes, and an object listed N times (every
  controller relist, every reflector sync) is serialized ONCE.
- a monotone `version` + condition variable: `wait_until(v)` gives
  read-your-writes consistency (a client that just wrote at version v
  LISTs at >= v, exactly Kubernetes' waitUntilFreshAndBlock). The
  dispatcher normally trails writes by microseconds; the bounded wait
  falls back to a direct store read on timeout so a wedged dispatcher
  degrades to the old path instead of erroring.

LIST responses for the HTTP tier are assembled from the cached
per-object fragments (`list_encoded`): a 5k-node LIST that used to pay
a full json.dumps per request becomes a byte join. Watch frames are
cached the same way (`frame_bytes`): one event fanned out to N watch
connections is encoded once, keyed by its globally unique version.

A copy of `kubernetes_tpu/server/watchcache.py`, its locks from the
sanitizer's factory under JAX's names (`watchcache.resource`, `.set`,
`.applied`, `.frames`, `.bufroute`; `utils/sanitizer.py`).
"""

from __future__ import annotations

import json
import threading
import time as _time
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.utils import sanitizer


class _Entry:
    __slots__ = ("obj", "version", "enc")

    def __init__(self, obj: dict, version: int):
        self.obj = obj
        self.version = version
        self.enc: Optional[bytes] = None


class ResourceCache:
    """Event-fed mirror of one registry prefix ('/registry/pods/')."""

    def __init__(self, prefix: str, store, cache_set: "WatchCacheSet"):
        self.prefix = prefix
        self._store = store
        self._set = cache_set
        self._lock = sanitizer.lock("watchcache.resource")
        self._items: Dict[str, _Entry] = {}
        self._sorted: Optional[List[str]] = None  # lazily (re)sorted keys
        # Everything <= seed_version is reflected (from the seed list);
        # everything <= the SET's applied version is reflected (events
        # are dispatched in global version order). The freshness floor
        # is the max of the two.
        self.seed_version = 0
        # Seed from the store's current state; events that raced in are
        # buffered by the set's _BufferingRoute and replayed after (the
        # route registers BEFORE this list, so nothing can be missed —
        # apply() drops versions the seed already covered).
        objs, at = store.list(prefix, copy=False)
        with self._lock:
            for obj in objs:
                key = self._key_of(obj)
                if key is not None:
                    self._items[key] = _Entry(
                        obj, int(obj.get("metadata", {})
                                 .get("resourceVersion", "0") or "0")
                    )
            self.seed_version = at

    def _key_of(self, obj: dict) -> Optional[str]:
        meta = obj.get("metadata", {})
        name = meta.get("name", "")
        if not name:
            return None
        ns = meta.get("namespace", "")
        return self.prefix + (f"{ns}/{name}" if ns else name)

    # -- event feed (dispatcher thread) --------------------------------

    def apply(self, version: int, etype: str, key: str, obj: dict) -> None:
        with self._lock:
            if etype == "DELETED":
                # Version-guarded like the upsert branch: a stale
                # buffered DELETED replayed during seeding must not
                # remove a NEWER recreated object the seed captured.
                cur = self._items.get(key)
                if cur is not None and version >= cur.version:
                    del self._items[key]
                    self._sorted = None
            else:
                cur = self._items.get(key)
                if cur is None:
                    self._sorted = None
                if cur is None or version >= cur.version:
                    self._items[key] = _Entry(obj, version)

    # -- consistency ---------------------------------------------------

    @property
    def version(self) -> int:
        """The freshness floor: every write at or below it is
        reflected here (LIST responses report this, so a watch resumed
        from it sees exactly the later events)."""
        return max(self.seed_version, self._set.applied)

    def fresh(self, timeout: float = 2.0) -> bool:
        """Catch up to the store's CURRENT version — read-your-writes
        (Kubernetes' waitUntilFreshAndBlock). Runs due TTL expirations
        first so a quiet store can't serve dead TTL'd objects from
        memory. False on timeout (wedged dispatcher) — caller falls
        back to a direct store read."""
        self._store.expire_now()
        target = self._store.version
        if target <= self.seed_version:
            return True
        return self._set.wait_applied(target, timeout)

    # -- reads ---------------------------------------------------------

    def _keys_sorted_locked(self) -> List[str]:
        if self._sorted is None:
            self._sorted = sorted(self._items)
        return self._sorted

    def get(self, key: str) -> Optional[dict]:
        """The stored object ref (read-only) or None."""
        with self._lock:
            e = self._items.get(key)
            return None if e is None else e.obj

    def get_encoded(self, key: str) -> Optional[bytes]:
        with self._lock:
            e = self._items.get(key)
            if e is None:
                return None
            if e.enc is None:
                e.enc = json.dumps(e.obj).encode()
            return e.enc

    def _snapshot_entries_locked_free(self, prefix: str) -> List[_Entry]:
        """Consistent entry snapshot under a SHORT lock hold. The
        per-object work (selector filtering, lazy encoding) happens
        OUTSIDE the lock: the dispatcher thread needs it for apply(),
        so a large LIST must not stall watch fan-out for the duration
        of thousands of json.dumps calls. Entries are immutable per
        version and `enc` writes are idempotent (bytes deterministic
        per resourceVersion), so the unlocked access is benign."""
        with self._lock:
            keys = self._keys_sorted_locked()
            items = self._items
            if prefix == self.prefix:
                return [items[k] for k in keys]
            return [items[k] for k in keys if k.startswith(prefix)]

    def list_refs(
        self, prefix: str, pred: Optional[Callable] = None
    ) -> Tuple[List[dict], int]:
        """(object refs under prefix in key order, cache version).
        Refs are read-only; callers that hand objects out copy them
        (same contract as KVStore.list(copy=False))."""
        # Version BEFORE the snapshot: events landing in between are
        # included-but-unclaimed (a resumed watch re-delivers them,
        # idempotent). The reverse order would claim events the
        # snapshot missed — a resumed watch would skip them forever.
        version = self.version
        entries = self._snapshot_entries_locked_free(prefix)
        out = [e.obj for e in entries]
        if pred is not None:
            out = [o for o in out if pred(o)]
        return out, version

    def list_encoded(
        self, prefix: str, pred: Optional[Callable] = None
    ) -> Tuple[bytes, int, int]:
        """(b'obj,obj,...' joined fragments, count, version) for the
        HTTP LIST fast path. Each object's encoding is computed at most
        once per resourceVersion; encoding runs OUTSIDE the cache lock
        (see _snapshot_entries_locked_free)."""
        version = self.version  # before the snapshot — see list_refs
        entries = self._snapshot_entries_locked_free(prefix)
        frags: List[bytes] = []
        for e in entries:
            if pred is not None and not pred(e.obj):
                continue
            if e.enc is None:
                e.enc = json.dumps(e.obj).encode()
            frags.append(e.enc)
        return b", ".join(frags), len(frags), version

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


class WatchCacheSet:
    """All resource caches over one store, fed by one subscriber.

    Freshness is tracked GLOBALLY: the store's logical clock spans all
    resources, and events reach the one subscriber in version order, so
    "every cache reflects all writes <= applied" holds after each event
    regardless of which cache it routed to. That makes wait_applied()
    work even when the triggering write touched another resource."""

    def __init__(self, store):
        self._store = store
        self._lock = sanitizer.lock("watchcache.set")
        self._caches: Dict[str, ResourceCache] = {}  # prefix -> cache
        self._routes: List[Tuple[str, object]] = []
        self.applied = 0  # highest event version processed by the feed
        self._applied_cond = threading.Condition(
            sanitizer.lock("watchcache.applied")
        )
        # Encoded watch frames keyed by (event type, version): the
        # store's version clock is global, so within one store the key
        # uniquely identifies the frame bytes. One event fanned out to
        # N watch connections is json.dumps'd once. Per-set (per-store)
        # on purpose: two stores' clocks both start at 1.
        self._frame_lock = sanitizer.lock("watchcache.frames")
        self._frames: Dict[Tuple[str, int], bytes] = {}
        # Per-resource applied watermark: highest event version seen
        # FOR each resource (keyed by the '/registry/<res>/' segment).
        # The fan-out lag SLI compares a stream's delivered version
        # against ITS resource's watermark — comparing against the
        # global `applied` would charge a caught-up services watch
        # with every pod write's version (false SLO warns). Plain dict:
        # single writer (the dispatcher), GIL-atomic reads.
        self._applied_by_resource: Dict[str, int] = {}
        store.subscribe(self._on_event)

    def _on_event(
        self, version: int, etype: str, key: str, obj: dict, prev
    ) -> None:
        for prefix, cache in self._routes:
            if key.startswith(prefix):
                cache.apply(version, etype, key, obj)
                break
        # key shape '/registry/<resource>/...' — split bounded at 3.
        parts = key.split("/", 3)
        if len(parts) > 2:
            self._applied_by_resource[parts[2]] = version
        with self._applied_cond:
            self.applied = version
            self._applied_cond.notify_all()

    def applied_version(self, resource: str) -> int:
        """Highest event version the feed has processed for ONE
        resource (0 = no event seen yet) — the fan-out lag SLI's
        comparison point."""
        return self._applied_by_resource.get(resource, 0)

    def wait_applied(self, version: int, timeout: float = 2.0) -> bool:
        """Block until the feed has processed every event <= version."""
        if self.applied >= version:
            return True
        deadline = _time.monotonic() + timeout
        with self._applied_cond:
            while self.applied < version:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return False
                self._applied_cond.wait(remaining)
        return True

    def cache_for(self, prefix: str) -> ResourceCache:
        """The cache mirroring `prefix`, created (and seeded) on first
        use. A buffering route registers BEFORE seeding so no event can
        fall between the seed snapshot and the live feed."""
        cache = self._caches.get(prefix)
        if cache is not None:
            return cache
        with self._lock:
            cache = self._caches.get(prefix)
            if cache is not None:
                return cache
            holder = _BufferingRoute(prefix)
            self._routes = self._routes + [(prefix, holder)]
            cache = ResourceCache(prefix, self._store, self)
            holder.drain_into(cache)
            # Swap the buffering route for the live cache.
            self._routes = [
                (p, cache if c is holder else c) for p, c in self._routes
            ]
            self._caches[prefix] = cache
            return cache

    def peek(self, prefix: str) -> Optional[ResourceCache]:
        return self._caches.get(prefix)

    def frame_bytes(self, etype: str, version: int, obj) -> bytes:
        """Encoded b'{"type": ..., "object": ...}' watch frame (no
        trailing newline), cached by (etype, version) when nonzero."""
        if not version:
            return json.dumps({"type": etype, "object": obj}).encode()
        key = (etype, version)
        with self._frame_lock:
            hit = self._frames.get(key)
        if hit is not None:
            return hit
        enc = json.dumps({"type": etype, "object": obj}).encode()
        with self._frame_lock:
            if len(self._frames) >= 8192:
                self._frames.clear()  # cheap bound; re-encode on miss
            self._frames[key] = enc
        return enc


class _BufferingRoute:
    """Stand-in route that buffers events while its real cache seeds;
    drain_into() replays them (idempotent — apply() drops versions the
    seed already covered) and then forwards directly, preserving the
    dispatcher's version order."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self._lock = sanitizer.lock("watchcache.bufroute")
        self._buf: List[tuple] = []
        self._target: Optional[ResourceCache] = None

    def apply(self, version: int, etype: str, key: str, obj: dict) -> None:
        with self._lock:
            if self._target is None:
                self._buf.append((version, etype, key, obj))
                return
            target = self._target
        target.apply(version, etype, key, obj)

    def drain_into(self, cache: ResourceCache) -> None:
        # Replay UNDER the lock: a live event racing in must queue
        # behind the replay, never interleave ahead of older buffered
        # events (a DELETED overtaken by a buffered older ADDED would
        # resurrect the object).
        with self._lock:
            for version, etype, key, obj in self._buf:
                cache.apply(version, etype, key, obj)
            self._buf = []
            self._target = cache


