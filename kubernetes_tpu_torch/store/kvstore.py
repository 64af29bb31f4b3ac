"""The versioned KV store.

Semantics mirror the reference's etcd usage through EtcdHelper
(pkg/tools/etcd_helper.go):

- A single global, monotonically increasing logical clock. Every write
  bumps it; every object carries the version of its last write in
  metadata.resourceVersion (pkg/tools/etcd_object.go).
- Create fails if the key exists (AlreadyExists); CompareAndSwap update
  fails on version mismatch (Conflict); `guaranteed_update` is the CAS
  retry loop of EtcdHelper.GuaranteedUpdate (etcd_helper.go:510-600).
- Watch(prefix, since) replays buffered history after `since`, then
  streams live events in version order (etcd_helper_watch.go:73-165).
  Asking for a version older than the history window raises
  CompactedError (clients must re-list, like etcd index cleared errors).
- Values are wire-form dicts (deep-copied on the way in and out), so
  storage is serialization-faithful like etcd's JSON payloads.
- Optional per-key TTL (events registry uses it, reference: event TTL).
- Optional durability (`data_dir=`): every mutation is appended to a
  JSON-lines write-ahead log and the full state is periodically
  snapshotted; construction replays snapshot + WAL so an apiserver
  restarted on the same --data-dir recovers every object, binding and
  allocator lease with the resourceVersion clock intact. This is the
  role etcd plays for the reference (pkg/tools/etcd_helper.go:101,
  hack/local-up-cluster.sh:152-153): master state must survive process
  death. TTLs are wall-clock deadlines so they age across restarts.
  fsync-before-ack is the DEFAULT (etcd's contract: acked writes
  survive power loss, not just process death), group-committed so N
  concurrent writers share a disk flush; fsync=False (daemon flag
  --no-data-fsync) trades that for write latency.

Thread-safe; many reader/writer threads over one lock with short holds
(TTL expiry via a heap, watch fan-out off-thread behind a sharded
watcher index, bulk applies for the scheduler's commit path). For
thread-herd hosts (1000 in-process kubelets) `serialized_writes=True`
funnels mutations through one hot applier thread instead — etcd's
single raft-apply loop, in spirit.

A copy of `kubernetes_tpu/store/kvstore.py`. The on-disk format (the
JSON-lines WAL, the snapshot file, the lock file) is the JAX store's
byte for byte, so a data directory written by either package recovers
in the other, a WAL torn by either's `kvstore.wal.torn_write` seam
included. The chaos seams (`kvstore.wal.torn_write` with its rollback,
`kvstore.wal.fsync`, `kvstore.snapshot.rename`; `utils/faults.py`) and
the sanitizer's locks and `allow_blocking` grants sit where JAX's do.
"""

from __future__ import annotations

import copy
import fcntl
import json
import heapq
import math
import os
import queue as _queue
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.store.watch import ADDED, DELETED, Event, MODIFIED, WatchStream
from kubernetes_tpu_torch.utils import faults, sanitizer


class StoreError(Exception):
    pass


class NotFoundError(StoreError):
    pass


class AlreadyExistsError(StoreError):
    pass


class ConflictError(StoreError):
    pass


class CompactedError(StoreError):
    """Watch window no longer covers the requested version."""


class AbortedError(StoreError):
    """An atomic batch aborted before this item was applied (some other
    item in the batch failed); nothing in the batch was committed."""


class StoreClosedError(StoreError):
    """The store was closed while this write was queued/in flight; the
    write was NOT applied (serialized-writer shutdown path)."""


def _copy_obj(obj: dict) -> dict:
    """Private copy of a wire-form object. Wire objects are JSON by
    construction (they ride the WAL and the HTTP API as JSON), and a
    C-accelerated json round-trip is ~2x faster than copy.deepcopy on
    pod-sized dicts; anything non-JSON (test doubles) falls back.

    Contract caveat: json.dumps coerces rather than rejects two
    non-wire shapes — int dict keys become strings and tuples become
    lists — so the fallback won't fire for them. That's the store's
    documented JSON-object contract (same coercion the WAL and the
    HTTP tier already apply); don't put non-wire values in the store."""
    try:
        return json.loads(json.dumps(obj))
    except (TypeError, ValueError):
        return copy.deepcopy(obj)


def _dispatch_thread(store_ref: "weakref.ref", q: "_queue.SimpleQueue") -> None:
    """Drains a store's dispatch queue until a None sentinel (close) or
    the store itself is collected."""
    while True:
        item = q.get()
        if item is None:
            return
        store = store_ref()
        if store is None:
            return
        store._dispatch_event(item)
        del store  # don't pin the store across the blocking get()


def _filter_event(
    pred: Optional[Callable], etype: str, obj: dict, prev: Optional[dict], version: int
) -> Optional[Event]:
    """etcd's filtered-watch translation (pkg/tools/etcd_helper_watch.go
    sendModify/sendDelete): a selector-filtered watcher sees ADDED/
    MODIFIED only while the object matches, a synthesized DELETED when a
    modification takes it out of the filter (so a spec.nodeName=""
    watcher sees pods leave its view when the scheduler binds them), and
    nothing at all for objects that never concerned it. With no previous
    state to consult (history replay), a non-matching MODIFIED degrades
    to a spurious DELETED — a harmless no-op for consumers."""
    if pred is None:
        return Event(etype, obj, version)
    if etype == ADDED:
        return Event(ADDED, obj, version) if pred(obj) else None
    if etype == MODIFIED:
        if pred(obj):
            return Event(MODIFIED, obj, version)
        if prev is None or pred(prev):
            return Event(DELETED, obj, version)
        return None
    # DELETED: obj is the last stored state — deliver iff it was visible.
    return Event(DELETED, obj, version) if pred(obj) else None


def _drain_write_queue(q, batch=()) -> None:
    """Shutdown path: fail every not-yet-applied queued entry so no
    writer thread is stranded in ev.wait() forever (the None sentinel
    used to retire the applier mid-batch, silently dropping already-
    dequeued entries)."""
    err = StoreClosedError("store closed before this write was applied")
    pending = list(batch)
    while True:
        try:
            pending.append(q.get_nowait())
        except _queue.Empty:
            break
    for entry in pending:
        if entry is None:
            continue
        _fn, ev, cell = entry
        cell.append((False, err))
        ev.set()


def _write_thread(store_ref, q) -> None:
    """Serialized write-combining loop (etcd's single raft-apply
    thread, in spirit): drains queued mutations and executes them with
    ONE thread. Under a thread herd (1000 kubelets' status writers on
    one core), per-caller lock acquisition makes every write pay a
    full wake+GIL-handoff latency and system write throughput
    collapses to ~1/wake-latency; with a single applier the writes
    themselves proceed at full speed and only each caller's own
    wake-up is laggy.

    Group commit rides the batch: after applying a drained batch the
    thread fsyncs the WAL ONCE (advancing _synced_seq past every record
    the batch appended) and only then wakes the callers — their own
    _wal_sync finds the work already done, so N queued writers pay one
    disk flush instead of racing N.

    Shutdown: on the None sentinel every already-dequeued and still-
    queued entry is failed with StoreClosedError (events always set) —
    a write racing close() must error out, never hang."""
    spin_s = 0.004  # stay runnable briefly between batches (see below)
    while True:
        item = q.get()
        if item is None:
            _drain_write_queue(q)
            return
        while True:
            batch = [item]
            while len(batch) < 256:
                try:
                    batch.append(q.get_nowait())
                except _queue.Empty:
                    break
            store = store_ref()
            if store is None:
                return
            if None in batch:
                # Sentinel mid-batch: fail the whole drained batch and
                # everything still queued, then retire.
                _drain_write_queue(q, batch)
                return
            done = []
            for entry in batch:
                fn, ev, cell = entry
                try:
                    cell.append((True, fn()))
                except BaseException as e:
                    cell.append((False, e))
                done.append(ev)
            # One fsync covers the whole drained batch before any
            # caller is woken (their _wal_sync then no-ops). Failures
            # fall through: each caller's own _wal_sync retries and
            # surfaces the real error.
            try:
                store._sync_batch_locked_free()
            except Exception:
                pass
            for ev in done:
                ev.set()
            del store
            # Spin-drain: a blocking get() puts this thread to SLEEP,
            # and under a runnable herd each wake-up costs many GIL
            # quanta — the writer's throughput became 1/wake-latency
            # (~75 ops/s observed) no matter how fast the writes were.
            # Yielding but staying runnable keeps the pump hot while
            # load continues; after a quiet spell it blocks for real.
            deadline = time.monotonic() + spin_s
            item = None
            while item is None and time.monotonic() < deadline:
                try:
                    nxt = q.get_nowait()
                except _queue.Empty:
                    time.sleep(0)  # yield the GIL, stay runnable
                    continue
                if nxt is None:
                    # Shutdown sentinel (close/GC finalizer): fail any
                    # entries that raced in behind it.
                    _drain_write_queue(q)
                    return
                item = nxt
            if item is None:
                break  # idle: go back to the blocking get


class KVStore:
    def __init__(
        self,
        history_limit: int = 10000,
        data_dir: Optional[str] = None,
        fsync: bool = True,
        snapshot_every: int = 4096,
        serialized_writes: bool = False,
    ):
        self._lock = sanitizer.rlock("kvstore.lock")
        self._data: Dict[str, Tuple[dict, int]] = {}  # key -> (wire obj, version)
        self._ttl: Dict[str, float] = {}  # key -> expiry wall-clock time
        self._version = 0
        # History ring for watch replay: (version, type, key, obj).
        self._history: deque = deque(maxlen=history_limit)
        self._oldest = 0  # lowest version NOT compacted out of history
        # (prefix, pred-or-None, stream). Selector predicates live HERE,
        # not above the store: a filtered watcher (kubelet watching
        # spec.nodeName=X) must not even be offered the other 99 nodes'
        # events — at 100 kubelets that fan-out was the control plane's
        # wall, not the solver.
        # watcher tuple: (prefix, pred, stream, shard) where shard is
        # None or (extract_fn, value) — see _dispatch_event.
        self._watchers: List[tuple] = []
        self._unsharded: List[tuple] = []
        self._shard_buckets: Dict[tuple, List[tuple]] = {}
        self._shard_fns: tuple = ()
        # Event subscribers (the apiserver's watch cache): called on
        # the DISPATCHER thread for every event, before watcher
        # fan-out, with the stored (read-only) object — no copy. See
        # subscribe().
        self._subscribers: tuple = ()
        # WAL taps (the replication hub's feed): called UNDER self._lock
        # with (version, raw_line) for every journaled mutation, in
        # version order, with the exact bytes the WAL got — the line a
        # follower must append verbatim for its log to be byte-identical
        # to the leader's. Taps run only after the local append
        # succeeded, so a torn (unacked) record is never shipped. See
        # add_wal_tap().
        self._wal_taps: tuple = ()
        # Optional quorum gate: when set (by the replication hub on the
        # leader), every write ack additionally waits for the record to
        # reach the replicated commit index — fsync-before-ack extended
        # to quorum-before-ack. See set_commit_gate().
        self._commit_gate = None
        # Fan-out rides its own thread: writers only append to this
        # queue under the lock; the dispatcher does the per-event copy
        # and per-watcher predicate work OFF the write path, so write
        # latency is independent of watcher count. Ordering: single
        # dispatcher = version order; replay/live races are settled by
        # each stream's version floor (WatchStream.push).
        self._dispatch_q: "_queue.SimpleQueue" = _queue.SimpleQueue()
        # The thread holds only (weakref, queue): a dropped store is
        # still collectable even if close() was never called (tests
        # build thousands of throwaway stores).
        self._dispatcher = threading.Thread(
            target=_dispatch_thread,
            args=(weakref.ref(self), self._dispatch_q),
            daemon=True,
        )
        self._dispatcher.start()
        # A store dropped WITHOUT close() must still retire its thread:
        # the weakref alone makes the object collectable, but the
        # thread would park in q.get() forever. The finalizer holds
        # only the queue, so it doesn't resurrect the store.
        weakref.finalize(self, self._dispatch_q.put, None)
        # Optional serialized write path (see _write_thread). Off by
        # default: the queue hop + event wake adds ~100us of latency
        # per write, only worth paying when HUNDREDS of threads would
        # otherwise contend the lock (the 1000-kubelet shape).
        self._write_q = None
        if serialized_writes:
            self._write_q = _queue.SimpleQueue()
            threading.Thread(
                target=_write_thread,
                args=(weakref.ref(self), self._write_q),
                daemon=True,
            ).start()
            weakref.finalize(self, self._write_q.put, None)
        # TTL fast path: earliest pending expiry; ops skip all expiry
        # work until the clock actually reaches it. The heap carries
        # (expiry, key) with lazy invalidation (see _expire_locked).
        self._next_expiry = math.inf
        self._ttl_heap: List[Tuple[float, str]] = []
        # Durability (off when data_dir is None — tests/benches that
        # want a pure in-memory store keep the old behavior).
        # TTL clock: wall time for durable stores (deadlines must age
        # across restarts), monotonic for in-memory ones (immune to
        # NTP steps — the pre-durability behavior).
        self._now = time.time if data_dir else time.monotonic
        # Replica mode (set_replica_mode): the store is a follower
        # mirror — direct writes are refused (mutations arrive only
        # through replicate()) and TTL entries never expire locally
        # (the leader's expiry lands as a replicated DELETED record; a
        # local expiry would fork the version clock). The journal/
        # apply split: _repl_pending holds journaled-but-uncommitted
        # (version, raw_line) entries; _repl_journaled is the highest
        # journaled version (what the leader's quorum counts).
        self._replica = False
        self._repl_pending: deque = deque()
        self._repl_journaled = 0
        self._fsync = fsync
        self._snapshot_every = snapshot_every
        self._wal_file = None
        self._wal_count = 0
        self._wal_seq = 0  # records appended (group-commit cursor)
        self._synced_seq = 0  # records known durable
        # io_gate: this lock EXISTS to serialize the group-commit fsync
        # (ktsan's blocking-under-lock check exempts it by declaration).
        self._sync_lock = sanitizer.lock("kvstore.sync", io_gate=True)
        self._closed = False
        self._lockfd: Optional[int] = None
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            self._data_dir = data_dir
            self._snap_path = os.path.join(data_dir, "snapshot.json")
            self._wal_path = os.path.join(data_dir, "wal.log")
            # Exclusive advisory lock on the data dir: two stores
            # appending the same WAL / racing snapshot.json via
            # os.replace would silently interleave state (etcd
            # serializes this for the reference — one member owns the
            # dir). Held for the process lifetime; the OS releases it
            # on any death, so a kill -9'd owner never wedges restart.
            self._lockfd = os.open(
                os.path.join(data_dir, "LOCK"), os.O_CREAT | os.O_RDWR, 0o644
            )
            try:
                fcntl.flock(self._lockfd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                os.close(self._lockfd)
                self._lockfd = None
                raise StoreError(
                    f"data dir {data_dir!r} is locked by another KVStore "
                    "(apiserver already running against it?)"
                )
            os.ftruncate(self._lockfd, 0)  # clear any longer stale pid
            os.write(self._lockfd, str(os.getpid()).encode())
            replayed = self._recover()
            self._repl_journaled = self._version
            self._ttl_heap = [(t, k) for k, t in self._ttl.items()]
            heapq.heapify(self._ttl_heap)
            self._next_expiry = min(self._ttl.values(), default=math.inf)
            self._wal_file = open(self._wal_path, "a", encoding="utf-8")
            if replayed:
                # Compact on boot: fold the replayed tail into a fresh
                # snapshot so the next recovery is O(snapshot).
                self._snapshot_locked()
            # Age out TTL'd keys that expired while we were down; goes
            # through the normal delete path so the WAL records it.
            self._expire_locked()
            if self._fsync:
                self._fsync_dir()  # make the WAL's dir entry durable

    # -- durability ---------------------------------------------------

    def _recover(self) -> int:
        """Load snapshot then replay WAL records newer than it.

        Tolerates a torn final WAL line (the process died mid-append;
        that write was never acknowledged... the apiserver responds
        only after create/set/delete return, which is after the append)
        by truncating the file back to the last intact record, so the
        next append never fuses onto torn bytes. Returns the number of
        WAL records replayed.
        """
        snap_version = 0
        if os.path.exists(self._snap_path):
            with open(self._snap_path, "r", encoding="utf-8") as f:
                snap = json.load(f)
            snap_version = snap["version"]
            for key, obj, ver, exp in snap["items"]:
                self._data[key] = (obj, ver)
                if exp is not None:
                    self._ttl[key] = exp
            # Recovery runs in __init__, before the store is shared
            # with any other thread.  # ktlint: disable=KT002
            self._version = snap_version
        replayed = 0
        if os.path.exists(self._wal_path):
            torn = False
            with open(self._wal_path, "rb") as f:
                good_offset = 0
                for raw in f:
                    if not raw.endswith(b"\n"):
                        torn = True  # mid-append crash, unacked
                        break
                    line = raw.strip()
                    if line:
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            torn = True
                            break
                        v = rec["v"]
                        if v > snap_version:  # else folded into snapshot
                            key = rec["k"]
                            if rec["t"] == DELETED:
                                self._data.pop(key, None)
                                self._ttl.pop(key, None)
                            else:
                                self._data[key] = (rec["o"], v)
                                if rec.get("e") is not None:
                                    self._ttl[key] = rec["e"]
                                else:
                                    self._ttl.pop(key, None)
                            # Same: pre-share WAL replay, no
                            # readers yet.  # ktlint: disable=KT002
                            self._version = max(self._version, v)
                            replayed += 1
                    good_offset += len(raw)
            if torn:
                with open(self._wal_path, "r+b") as f:
                    f.truncate(good_offset)
        return replayed

    def _wal_append_locked(
        self, version: int, etype: str, key: str, obj: dict,
        flush: bool = True,
    ) -> None:
        if self._wal_file is None and not self._wal_taps:
            return
        rec = {"v": version, "t": etype, "k": key}
        if etype != DELETED:
            rec["o"] = obj
            exp = self._ttl.get(key)
            if exp is not None:
                rec["e"] = exp
        data = json.dumps(rec, separators=(",", ":")) + "\n"
        if self._wal_file is not None:
            if faults.enabled() and faults.fire(faults.WAL_TORN_WRITE, key):
                # Mid-append process death: a PREFIX of the record
                # reaches the file (no newline), the write is never
                # acked (raise), and recovery must truncate back to the
                # last intact record. The store is DEAD from here
                # (_closed): a torn line only exists because the
                # process died mid-write, so later appends must never
                # fuse onto the torn bytes — a live continuation would
                # make replay truncate ACKED records that landed after
                # it. Pair with crash() + a fresh store on the same
                # data dir. The raise also happens BEFORE the WAL taps:
                # a torn record must never reach a follower.
                self._wal_file.write(data[: max(1, len(data) // 2)])
                self._wal_file.flush()
                self._closed = True
                raise faults.FaultInjected(
                    f"kvstore.wal.torn_write: died mid-append of {key}"
                )
            self._wal_file.write(data)
            # flush=False is the batch path (create_many/
            # atomic_update_many and friends): records accumulate in
            # the file object's buffer and _wal_flush_locked writes
            # them as ONE append at the end of the lock hold — the
            # "single WAL append" half of group commit.
            if flush:
                self._wal_file.flush()
            # fsync does NOT happen here (we hold self._lock): callers
            # ack through _wal_sync after releasing it — the group-
            # commit seam.
            self._wal_seq += 1
            self._wal_count += 1
            if self._wal_count >= self._snapshot_every:
                self._snapshot_locked()
        for tap in self._wal_taps:
            # O(append-to-buffer) by contract: taps enqueue the raw
            # line for an off-thread shipper; the actual network send
            # never happens under this lock.
            try:
                tap(version, data)
            except Exception:
                pass  # a broken replication link must not fail writes

    def _wal_flush_locked(self) -> None:
        """Flush buffered batch appends to the OS (one write syscall
        for the whole batch); the fsync still happens in _wal_sync."""
        if self._wal_file is not None:
            self._wal_file.flush()

    def _sync_batch_locked_free(self) -> None:
        """One group-commit fsync covering everything appended so far
        (the serialized write thread's per-batch flush). Caller must
        NOT hold self._lock. No-op for in-memory / fsync=off stores.
        Deliberately NOT _ack_write: the applier thread must never park
        on the replication quorum — each caller waits for its own
        commit in _ack_write instead."""
        with self._lock:
            seq = self._wal_seq
        self._wal_sync(seq)

    def _ack_write(self, seq: int) -> None:
        """The full before-ack pipeline for one local write: group-
        commit fsync (_wal_sync), then — when a replication hub gates
        this store — quorum commit. Every public mutation funnels its
        ack through here, so "acked" always means "durable on this
        node AND on a quorum of replicas" once replication is attached.
        Callers must NOT hold self._lock."""
        self._wal_sync(seq)
        gate = self._commit_gate
        if gate is not None:
            gate()

    def _wal_sync(self, seq: int) -> None:
        """Group commit: make WAL record `seq` durable before the
        caller acks. One fsync covers every record flushed before it,
        so N concurrent writers pay ~1 disk flush, not N — the batching
        etcd does on its WAL. Callers must NOT hold self._lock (appends
        proceed while the disk flushes; that concurrency IS the
        amortization). No-op when fsync is off or the store is
        in-memory (seq stays 0)."""
        if not self._fsync or seq == 0:
            return
        # The documented contract, now enforced: holding self._lock
        # here would serialize every writer behind the disk flush and
        # deadlock against _snapshot_locked's handle rotation — the
        # group-commit amortization depends on appends proceeding WHILE
        # the fsync runs. (RLock._is_owned is the same probe
        # threading.Condition uses.)
        owned = getattr(self._lock, "_is_owned", None)
        if owned is not None and owned():
            raise AssertionError(
                "_wal_sync must not be called while holding self._lock "
                "(group-commit contract; see the _wal_sync docstring)"
            )
        with self._sync_lock:
            while True:
                if self._synced_seq >= seq:
                    return  # a peer's fsync / snapshot / close covered us
                with self._lock:
                    wal = self._wal_file
                    flushed = self._wal_seq
                if wal is None:
                    # Closed underneath us. close() fsyncs the WAL and
                    # advances _synced_seq BEFORE dropping the handle —
                    # but the loop-top check may predate close(), so
                    # re-check before refusing: only a close whose
                    # fsync FAILED leaves _synced_seq behind seq.
                    if self._synced_seq >= seq:
                        return
                    raise StoreError(
                        "store closed before this write became durable"
                    )
                try:
                    # Chaos seam: an injected fsync failure surfaces to
                    # the acking writer as a real I/O error — flushed
                    # but not durable. INSIDE this try on purpose: like
                    # a genuine OSError, it must be forgiven when a
                    # concurrent snapshot rotation already made the
                    # write durable (the rotated-handle branch below).
                    faults.fire(faults.WAL_FSYNC)
                    os.fsync(wal.fileno())
                except (ValueError, OSError):
                    with self._lock:
                        rotated = wal is not self._wal_file
                    if not rotated:
                        raise  # real I/O failure on the live handle
                    # A concurrent _snapshot_locked rotated the handle
                    # between capture and fsync. The snapshot fsync'd
                    # everything appended before it and advanced
                    # _synced_seq — loop and re-check instead of
                    # surfacing a bogus failure for a durable write.
                    continue
                if flushed > self._synced_seq:
                    self._synced_seq = flushed
                return

    def _snapshot_locked(self) -> None:
        """Write the full state atomically, then truncate the WAL.

        Crash-safe in both orders: a crash after the rename but before
        the truncate leaves WAL records with v <= snapshot version,
        which _recover skips.

        Runs (fsyncs included) under self._lock on purpose: compaction
        is stop-the-world for writers — rotating the WAL handle while
        appends proceed would lose records. The ktsan allow_blocking
        grant below documents that exception; everything else in the
        store honors "no blocking I/O under kvstore.lock".
        """
        items = [
            [key, obj, ver, self._ttl.get(key)]
            for key, (obj, ver) in sorted(self._data.items())
        ]
        tmp = self._snap_path + ".tmp"
        with sanitizer.allow_blocking(
            "snapshot compaction is stop-the-world by design"
        ):
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"version": self._version, "items": items}, f)
                f.flush()
                os.fsync(f.fileno())
            # Chaos seam: crash-before-rename leaves only the .tmp file
            # — recovery must keep serving the previous snapshot plus
            # the (untruncated) WAL.
            faults.fire(faults.SNAPSHOT_RENAME)
            os.replace(tmp, self._snap_path)
        if self._wal_file is not None:
            self._wal_file.close()
        self._wal_file = open(self._wal_path, "w", encoding="utf-8")
        self._wal_count = 0
        if self._fsync:
            # Power-loss ordering: the snapshot rename's directory
            # entry must be durable BEFORE new WAL appends land, or a
            # crash could pair the old snapshot with a truncated WAL.
            with sanitizer.allow_blocking(
                "snapshot compaction is stop-the-world by design"
            ):
                self._fsync_dir()
            # Everything appended so far is folded into the (fsync'd)
            # snapshot: waiting group-commit callers are already
            # durable without touching the fresh WAL.
            self._synced_seq = self._wal_seq

    def _fsync_dir(self) -> None:
        fd = os.open(self._data_dir, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def snapshot(self) -> None:
        """Force a snapshot + WAL truncation (no-op for in-memory stores)."""
        with self._lock:
            if self._wal_file is not None:
                self._snapshot_locked()

    # -- version plumbing ---------------------------------------------

    @property
    def closed(self) -> bool:
        """Whether close() ran — the healthz kvstore subcheck (a closed
        store still answers reads from memory, so liveness must be
        asked, not probed)."""
        return self._closed

    def dispatcher_alive(self) -> bool:
        """Liveness of the watch fan-out thread (healthz watch-hub
        subcheck): a dead dispatcher freezes every watcher — scheduler,
        kubelets, controllers — while writes still succeed, which is
        exactly the failure a plain write probe cannot see."""
        return self._dispatcher.is_alive()

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    @property
    def journaled_version(self) -> int:
        """Highest version durable in this store's log — the replica
        ack the leader counts toward quorum (>= version while an
        uncommitted replicated tail is pending)."""
        with self._lock:
            return max(self._repl_journaled, self._version)

    def _bump(self) -> int:
        # Every mutation funnels through here under self._lock. A
        # closed store must REFUSE writes rather than ack them with
        # the WAL handle already gone — an in-flight HTTP handler
        # racing server shutdown would otherwise ack a write that no
        # recovery will ever see.
        if self._closed:
            raise StoreError("store is closed")
        if self._replica:
            # Follower mirrors take mutations ONLY through
            # apply_replicated: a local write would mint a version the
            # leader also mints, forking the logical clock. This is
            # also the store-tier fencing backstop — a stale leader's
            # late write against a demoted store is refused here.
            raise StoreError("store is a read-only replica")
        # Every caller holds self._lock (the apply paths); _bump is
        # the locked clock's helper.  # ktlint: disable=KT002
        self._version += 1
        return self._version

    @staticmethod
    def _stamp(obj: dict, version: int) -> dict:
        obj.setdefault("metadata", {})["resourceVersion"] = str(version)
        return obj

    def _expire_locked(self) -> None:
        if self._replica:
            return  # expiry replicates from the leader as DELETED records
        if self._now() < self._next_expiry:
            return  # nothing can have expired yet — O(1) common path
        now = self._now()
        # Heap of (expiry, key) with lazy invalidation (the _ttl dict
        # is authoritative): expiry work is O(expired log n). The old
        # full scan of _ttl was O(all TTL entries) under the store
        # lock EVERY write once any entry was due — with tens of
        # thousands of TTL'd events continuously expiring at 1000-node
        # scale, that scan WAS the store's write ceiling.
        heap = self._ttl_heap
        while heap and heap[0][0] <= now:
            exp, k = heapq.heappop(heap)
            cur = self._ttl.get(k)
            if cur is None or cur != exp:
                continue  # refreshed or already gone: stale heap entry
            del self._ttl[k]
            if k in self._data:
                obj, _ = self._data.pop(k)
                v = self._bump()
                self._record_locked(v, DELETED, k, obj)
        self._next_expiry = heap[0][0] if heap else math.inf

    def _record_locked(
        self, version: int, etype: str, key: str, obj: dict,
        prev: Optional[dict] = None, flush: bool = True,
    ) -> None:
        """Journal one mutation; the _locked suffix IS the contract
        (callers hold self._lock; ktsan checks it at runtime). The write
        path only appends: WAL, history ring, dispatch queue. The
        per-event copy and per-watcher filter/push work happens on the
        dispatcher thread, so a write's lock hold is O(obj-serialize)
        for durable stores and O(1) otherwise — independent of watcher
        count. `obj` is the just-stored object (never mutated in place
        after storage); history shares the ref and replay copies it
        per delivery (watch())."""
        try:
            self._wal_append_locked(version, etype, key, obj, flush=flush)
        except faults.FaultInjected:
            # Torn-write chaos site: the "process" died mid-append, so
            # the in-memory apply (made by the caller just before this
            # journal step) must roll back — the dead store's reads
            # would otherwise serve an object watchers never saw and
            # replay will not reconstruct. Stored objects carry their
            # stamped resourceVersion, so the previous tuple rebuilds
            # exactly. (TTL bookkeeping is left to the heap's lazy
            # invalidation; the version-counter gap is harmless.)
            if etype == ADDED:
                self._data.pop(key, None)
                self._ttl.pop(key, None)
            elif etype == MODIFIED and prev is not None:
                self._data[key] = (
                    prev,
                    int(prev.get("metadata", {}).get("resourceVersion", 0)),
                )
            elif etype == DELETED:
                self._data[key] = (
                    obj,
                    int(obj.get("metadata", {}).get("resourceVersion", 0)),
                )
            raise
        self._publish_locked(version, etype, key, obj, prev)

    def _publish_locked(
        self, version: int, etype: str, key: str, obj: dict,
        prev: Optional[dict] = None,
    ) -> None:
        """History-ring + dispatch half of _record_locked — shared with
        the replicated-apply path, which journals raw leader bytes
        instead of re-serializing but must feed watchers identically."""
        if not self._history:
            self._oldest = version
        self._history.append((version, etype, key, obj))
        if len(self._history) == self._history.maxlen:
            self._oldest = self._history[0][0]
        self._dispatch_q.put((version, etype, key, obj, prev))

    def _dispatch_event(self, item: tuple) -> None:
        """Watch fan-out for one event, off the write path. ALL watchers
        share ONE private copy per event: stored state stays unreachable
        through events, and the copy cost doesn't scale with watcher
        count (at 100 kubelets a per-watcher deepcopy under the store
        lock was the control plane's wall, not the solver). Event
        objects are read-only by contract — every consumer either
        JSON-encodes them (HTTP watch) or decodes them into fresh typed
        objects (serde.from_wire rebuilds every container).

        Sharded watchers (watch(..., shard=(fn, value))) are indexed by
        their shard value and only offered events whose object (or
        previous state) maps to that value — at 1000 kubelets each
        watching spec.nodeName=<self>, per-event fan-out would
        otherwise cost O(watchers) filter evaluations, and 90k pod
        events x 1000 watchers of dispatch work WAS the 1000-node
        drill's wall. Routing is conservative: a watcher's pred can
        only match (directly or through the DELETED translation) when
        obj or prev carries its shard value, so skipped watchers would
        have produced no event anyway."""
        version, etype, key, obj, prev = item
        for sub in self._subscribers:
            # Subscribers see every event in version order before the
            # watcher fan-out (they feed read caches, so they must be
            # at least as fresh as anything a watcher could observe).
            # obj is the stored object — read-only by contract.
            try:
                sub(version, etype, key, obj, prev)
            except Exception:
                pass  # a broken cache must not stall watch fan-out
        with self._lock:
            watchers = list(self._unsharded)
            for fn in self._shard_fns:  # distinct extractors (usually 1)
                vals = {fn(obj)}
                if prev is not None:
                    vals.add(fn(prev))
                for v in vals:
                    watchers.extend(self._shard_buckets.get((fn, v), ()))
        delivered = None  # lazily copied: most events match few watchers
        saw_closed = False
        for prefix, pred, stream, _shard in watchers:
            if stream.closed:
                saw_closed = True
                continue
            if key.startswith(prefix):
                ev = _filter_event(pred, etype, obj, prev, version)
                if ev is not None:
                    if delivered is None:
                        delivered = _copy_obj(obj)
                    stream.push(Event(ev.type, delivered, version))
            if stream.closed:
                saw_closed = True  # push() just dropped a slow consumer
        if saw_closed:
            with self._lock:
                self._watchers = [
                    w for w in self._watchers if not w[2].closed
                ]
                self._rebuild_watch_index_locked()

    def _rebuild_watch_index_locked(self) -> None:
        self._unsharded = []
        self._shard_buckets = {}
        for w in self._watchers:
            shard = w[3]
            if shard is None:
                self._unsharded.append(w)
            else:
                self._shard_buckets.setdefault(tuple(shard), []).append(w)
        self._shard_fns = tuple({fn for fn, _v in self._shard_buckets})

    # -- CRUD ---------------------------------------------------------

    def create(self, key: str, obj: dict, ttl: Optional[float] = None) -> dict:
        obj = _copy_obj(obj)  # before the lock: O(obj) work stays outside

        def op():
            with self._lock:
                self._expire_locked()
                if key in self._data:
                    raise AlreadyExistsError(key)
                v = self._bump()
                self._stamp(obj, v)
                self._data[key] = (obj, v)
                if ttl is not None:
                    exp = self._now() + ttl
                    self._ttl[key] = exp
                    heapq.heappush(self._ttl_heap, (exp, key))
                    self._next_expiry = min(self._next_expiry, exp)
                self._record_locked(v, ADDED, key, obj)
                return self._wal_seq

        seq = self._apply_write(op)
        self._ack_write(seq)  # fsync-before-ack, amortized across writers
        return _copy_obj(obj)

    def create_many(
        self,
        entries: List[Tuple[str, dict, Optional[float]]],
        copy: bool = True,
    ) -> List:
        """Create a batch of objects under ONE lock hold, ONE buffered
        WAL append, and ONE group-commit fsync — the bulk write fast
        path (a 512-pod bulk POST pays one commit, not 512). Per-item
        results: the stored object (a ref — callers must not mutate)
        or the exception instance (AlreadyExistsError) for items that
        failed; failures never abort the rest of the batch. Versions
        are assigned in list order, so watchers observe the batch's
        ADDED events in exactly the submitted order.

        copy=False trusts the caller to hand over PRIVATE dicts (the
        HTTP tier's just-parsed request body) and skips the defensive
        per-object copy — the dominant per-item cost at bulk rates."""
        if copy:
            entries = [(k, _copy_obj(o), t) for k, o, t in entries]

        def op():
            out = []
            with self._lock:
                self._expire_locked()
                for key, obj, ttl in entries:
                    if key in self._data:
                        out.append(AlreadyExistsError(key))
                        continue
                    v = self._bump()
                    self._stamp(obj, v)
                    self._data[key] = (obj, v)
                    if ttl is not None:
                        exp = self._now() + ttl
                        self._ttl[key] = exp
                        heapq.heappush(self._ttl_heap, (exp, key))
                        self._next_expiry = min(self._next_expiry, exp)
                    self._record_locked(v, ADDED, key, obj, flush=False)
                    out.append(obj)
                self._wal_flush_locked()
                return out, self._wal_seq

        results, seq = self._apply_write(op)
        self._ack_write(seq)  # ONE fsync for the whole batch
        return results

    def delete_many(self, keys: List[str]) -> List:
        """Delete a batch of keys under one lock hold / WAL append /
        fsync (the bulk-churn drain path). Per-item results: the
        deleted object or NotFoundError."""

        def op():
            out = []
            with self._lock:
                self._expire_locked()
                for key in keys:
                    if key not in self._data:
                        out.append(NotFoundError(key))
                        continue
                    obj, _ = self._data.pop(key)
                    self._ttl.pop(key, None)
                    v = self._bump()
                    self._record_locked(v, DELETED, key, obj, flush=False)
                    out.append(obj)
                self._wal_flush_locked()
                return out, self._wal_seq

        results, seq = self._apply_write(op)
        self._ack_write(seq)
        return results

    def get(self, key: str) -> dict:
        with self._lock:
            self._expire_locked()
            if key not in self._data:
                raise NotFoundError(key)
            obj = self._data[key][0]
        # Copy OUTSIDE the lock: stored tuples are rebound, never
        # mutated in place, so the ref is a consistent snapshot — and
        # the store's one lock must not be held for O(object) copies.
        return _copy_obj(obj)

    def set(
        self, key: str, obj: dict, expected_version: Optional[int] = None
    ) -> dict:
        """Update; CAS when expected_version is given (etcd CompareAndSwap)."""
        obj = _copy_obj(obj)  # before the lock: O(obj) work stays outside

        def op():
            with self._lock:
                self._expire_locked()
                if key not in self._data:
                    raise NotFoundError(key)
                prev, cur_v = self._data[key]
                if expected_version is not None and cur_v != expected_version:
                    raise ConflictError(
                        f"{key}: version {expected_version} != current {cur_v}"
                    )
                v = self._bump()
                self._stamp(obj, v)
                self._data[key] = (obj, v)
                self._record_locked(v, MODIFIED, key, obj, prev=prev)
                return self._wal_seq

        seq = self._apply_write(op)
        self._ack_write(seq)
        return _copy_obj(obj)

    def delete(self, key: str, expected_version: Optional[int] = None) -> dict:
        def op():
            with self._lock:
                self._expire_locked()
                if key not in self._data:
                    raise NotFoundError(key)
                obj, cur_v = self._data[key]
                if expected_version is not None and cur_v != expected_version:
                    raise ConflictError(
                        f"{key}: version {expected_version} != current {cur_v}"
                    )
                del self._data[key]
                self._ttl.pop(key, None)
                v = self._bump()
                self._record_locked(v, DELETED, key, obj)
                return obj, self._wal_seq

        obj, seq = self._apply_write(op)
        self._ack_write(seq)
        return _copy_obj(obj)

    def list(self, prefix: str, copy: bool = True) -> Tuple[List[dict], int]:
        """All objects under prefix + the store version (for watch
        resume). copy=False hands out the stored objects themselves
        (read-only contract — for callers that only serialize)."""
        with self._lock:
            self._expire_locked()
            # Snapshot refs under the lock (cheap), copy outside it: a
            # 3000-pod list must not stall every writer for the copy.
            snap = [
                obj
                for key, (obj, _) in sorted(self._data.items())
                if key.startswith(prefix)
            ]
            version = self._version
        if not copy:
            return snap, version
        return [_copy_obj(o) for o in snap], version

    def keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            self._expire_locked()
            return sorted(k for k in self._data if k.startswith(prefix))

    def _apply_write(self, op):
        """Run a mutation closure directly, or through the serialized
        writer when enabled. `op` takes the store lock itself (short
        hold); exceptions propagate to the caller either way.

        Shutdown-safe: close() retires the applier thread (which fails
        every queued entry with StoreClosedError) and nulls _write_q so
        late writers fall back to the direct path (where _bump refuses
        with "store is closed"). The wait is bounded with a closed-
        store re-check so a write racing close() can never block its
        thread forever."""
        q = self._write_q
        if q is None:
            return op()
        ev = threading.Event()
        cell: list = []
        q.put((op, ev, cell))
        while not ev.wait(timeout=5.0):
            if self._closed and not cell:
                # Applier retired without reaching this entry (close()
                # raced the enqueue above the sentinel-drain window).
                raise StoreClosedError(
                    "store closed before this write was applied"
                )
        ok, val = cell[0]
        if ok:
            return val
        raise val

    def _atomic_update_locked(
        self, key: str, update_fn, flush: bool = True, copy: bool = True
    ) -> dict:
        """Caller holds self._lock.

        copy=False is the trusted bulk-replace path: update_fn receives
        the STORED object itself (READ-ONLY — it must not mutate it)
        and must return a PRIVATE dict (the HTTP tier's parsed request
        body qualifies), which is stored without the two defensive
        json round-trips — at bulk-update rates those copies were the
        batch's dominant cost."""
        if key not in self._data:
            raise NotFoundError(key)
        cur, _ = self._data[key]
        if copy:
            # Stored state must be PRIVATE: update_fn may graft caller-
            # owned sub-dicts into its return (update_status splices the
            # request body's status), so the stored object is a copy —
            # same invariant set() keeps by copying its input.
            stored = _copy_obj(update_fn(_copy_obj(cur)))
        else:
            stored = update_fn(cur)
        v = self._bump()
        self._stamp(stored, v)
        self._data[key] = (stored, v)
        self._record_locked(v, MODIFIED, key, stored, prev=cur, flush=flush)
        return stored

    def atomic_update(self, key: str, update_fn: Callable[[dict], dict]) -> dict:
        """Single-hold read-modify-write: update_fn runs under the store
        lock on a private copy, so no CAS retry loop and ONE lock
        acquisition per write instead of guaranteed_update's two. This
        is the high-traffic write path (status PUTs, bindings): on a
        single-core host a 100-kubelet status burst queues hundreds of
        threads on this lock, and every extra lock handoff costs up to
        a GIL switch interval. update_fn must be small and must not
        call back into the store."""

        def op():
            with self._lock:
                self._expire_locked()
                stored = self._atomic_update_locked(key, update_fn)
                return stored, self._wal_seq

        stored, seq = self._apply_write(op)
        self._ack_write(seq)
        return _copy_obj(stored)

    def atomic_update_many(
        self, ops: List[Tuple[str, Callable[[dict], dict]]],
        atomic: bool = False,
        copy: bool = True,
        copy_results: Optional[bool] = None,
    ) -> List:
        """Batch of single-hold read-modify-writes under ONE lock
        acquisition (and one serialized-writer hop). The batch solver
        commits a whole backlog's bindings through this: per-binding
        lock acquisitions would queue the scheduler behind every
        kubelet status writer once per pod — at 1000 nodes that
        convoy, not the solve, was the bind-rate ceiling. Per-item
        results: the stored object, or the exception instance for
        items whose update raised (APIError-style callers translate).

        atomic=True makes the batch all-or-nothing (the gang-bind
        path): every update_fn runs against a staged copy first, and
        only when ALL succeed are the staged objects committed —
        versions bumped, watches fanned out. On the first failure
        nothing has been applied; the failing item carries its own
        exception and every other item an AbortedError. Check-then-
        commit under the one lock hold is strictly stronger than
        apply-then-roll-back: no watcher can ever observe a state
        that is later undone."""

        def batch():
            out = []
            with self._lock:
                self._expire_locked()
                if not atomic:
                    for key, update_fn in ops:
                        try:
                            out.append(
                                self._atomic_update_locked(
                                    key, update_fn, flush=False, copy=copy
                                )
                            )
                        except Exception as e:  # per-item outcome, not abort
                            out.append(e)
                    self._wal_flush_locked()
                    return out, self._wal_seq
                # Atomic: stage everything, commit only if all succeed.
                # `staged` doubles as an overlay so a batch touching the
                # same key twice sees its own earlier (uncommitted) write.
                staged: Dict[str, dict] = {}
                order: List[Tuple[str, dict, dict]] = []
                failure: Optional[Exception] = None
                for key, update_fn in ops:
                    cur = staged.get(key)
                    if cur is None:
                        if key not in self._data:
                            failure = NotFoundError(key)
                            break
                        cur = self._data[key][0]
                    try:
                        stored = _copy_obj(update_fn(_copy_obj(cur)))
                    except Exception as e:
                        failure = e
                        break
                    staged[key] = stored
                    order.append((key, stored, cur))
                if failure is not None:
                    n_done = len(order)
                    for i in range(len(ops)):
                        if i == n_done:
                            out.append(failure)
                        else:
                            out.append(
                                AbortedError(
                                    "atomic batch aborted; nothing applied"
                                )
                            )
                    return out, self._wal_seq
                for key, stored, cur in order:
                    v = self._bump()
                    self._stamp(stored, v)
                    self._data[key] = (stored, v)
                    self._record_locked(v, MODIFIED, key, stored, prev=cur, flush=False)
                    out.append(stored)
                self._wal_flush_locked()
                return out, self._wal_seq

        results, seq = self._apply_write(batch)
        self._ack_write(seq)
        # copy_results=False hands back the STORED objects (read-only
        # contract) — callers that only inspect status/metadata (the
        # bind commit path, bulk update) skip a per-item json round
        # trip, which at 50k-pod bulk binds was a full copy of the
        # cluster per commit.
        if copy_results is None:
            copy_results = copy
        if not copy_results:
            return results
        return [
            r if isinstance(r, Exception) else _copy_obj(r) for r in results
        ]

    # -- GuaranteedUpdate (etcd_helper.go:510-600) ---------------------

    def guaranteed_update(
        self, key: str, update_fn: Callable[[dict], dict], max_retries: int = 16
    ) -> dict:
        """Read-modify-write with CAS retry. update_fn gets a private copy
        and returns the new object (or raises to abort)."""
        for _ in range(max_retries):
            with self._lock:
                self._expire_locked()
                if key not in self._data:
                    raise NotFoundError(key)
                cur, cur_v = self._data[key]
            cur = _copy_obj(cur)  # private copy, made outside the lock
            new = update_fn(cur)
            try:
                return self.set(key, new, expected_version=cur_v)
            except ConflictError:
                continue
        raise ConflictError(f"{key}: too many CAS retries")

    # -- Watch --------------------------------------------------------

    def subscribe(self, fn: Callable) -> None:
        """Register an event subscriber: fn(version, etype, key, obj,
        prev) is invoked on the dispatcher thread for EVERY event, in
        version order, before watcher fan-out. `obj` is the stored
        object itself (read-only by contract — subscribers must not
        mutate and must copy before handing out). This is the
        apiserver watch cache's feed: one hook, no extra threads, no
        per-event copies."""
        with self._lock:
            self._subscribers = self._subscribers + (fn,)

    # -- Replication (store/replication.py rides these seams) ---------

    def add_wal_tap(self, fn: Callable) -> None:
        """Register a WAL tap: fn(version, raw_line) is invoked UNDER
        self._lock, in version order, with the exact newline-terminated
        bytes the local WAL received — the replication hub's feed. Taps
        must only enqueue (no I/O, no store calls)."""
        with self._lock:
            self._wal_taps = self._wal_taps + (fn,)

    def set_commit_gate(self, fn: Optional[Callable]) -> None:
        """Install (or clear, with None) the quorum gate: a zero-arg
        callable every write ack runs AFTER its fsync, off-lock. The
        replication hub points this at its wait-committed barrier so a
        leader acks at raft-lite quorum, not just local durability."""
        self._commit_gate = fn

    def set_replica_mode(self, replica: bool) -> None:
        """Mark this store a follower mirror (writes refused, TTLs
        passive — see _bump/_expire_locked) or promote it back to a
        writable leader."""
        with self._lock:
            self._replica = replica

    @property
    def replica(self) -> bool:
        return self._replica

    def replicate(self, raw_lines: List[str], commit: int) -> Tuple[int, int]:
        """Follower ingest — raft's log/state-machine split on one
        store. Leader-shipped WAL lines are journaled VERBATIM (byte-
        identical follower logs are the promotion oracle; no re-
        serialization can drift) and made durable before return, so the
        leader may count this follower toward quorum for every
        journaled version. Only the prefix at or below `commit` (the
        leader's commit index) is applied to the live mirror — memory,
        history ring, subscribers, watchers — exactly as _recover
        would replay it, so a follower apiserver's watch cache stays
        warm while the uncommitted tail stays invisible. Lines at or
        below the journaled version are skipped (idempotent under link
        retries). Returns (journaled_version, applied_version)."""

        def op():
            with self._lock:
                if self._closed:
                    raise StoreError("store is closed")
                for data in raw_lines:
                    v = json.loads(data)["v"]
                    if v <= self._repl_journaled:
                        continue
                    # Pending BEFORE journal: _wal_raw_locked's deferred-
                    # compaction guard must already see this entry.
                    self._repl_pending.append((v, data))
                    self._wal_raw_locked(v, data)
                    self._repl_journaled = v
                self._commit_replicated_locked(commit)
                self._wal_flush_locked()
                return self._repl_journaled, self._version, self._wal_seq

        journaled, applied, seq = self._apply_write(op)
        self._wal_sync(seq)
        return journaled, applied

    def _commit_replicated_locked(self, commit: int) -> None:
        """Apply journaled entries up to the leader commit index."""
        while self._repl_pending and self._repl_pending[0][0] <= commit:
            v, data = self._repl_pending.popleft()
            rec = json.loads(data)
            key, etype = rec["k"], rec["t"]
            if etype == DELETED:
                prev_t = self._data.pop(key, None)
                self._ttl.pop(key, None)
                obj = prev_t[0] if prev_t is not None else {
                    "metadata": {"name": key.rsplit("/", 1)[-1]}
                }
                prev = None
            else:
                obj = rec["o"]
                prev_t = self._data.get(key)
                prev = prev_t[0] if prev_t is not None else None
                self._data[key] = (obj, v)
                exp = rec.get("e")
                if exp is not None:
                    self._ttl[key] = exp
                    heapq.heappush(self._ttl_heap, (exp, key))
                    self._next_expiry = min(self._next_expiry, exp)
                else:
                    self._ttl.pop(key, None)
            self._version = v
            self._publish_locked(v, etype, key, obj, prev)

    def promote_replica(self) -> int:
        """Promote this follower to a writable leader exposing EXACTLY
        the committed prefix: the journaled-but-uncommitted tail is
        discarded (truncated out of the WAL — an unacked record must
        never surface after failover, the crash-recovery oracle
        extended to replication) and replica mode flips off. Returns
        the version the new leader serves from."""
        with self._lock:
            dropped = sum(
                len(d.encode("utf-8")) for _v, d in self._repl_pending
            )
            self._repl_pending.clear()
            self._repl_journaled = self._version
            if self._wal_file is not None and dropped:
                with sanitizer.allow_blocking(
                    "promotion truncates the uncommitted tail; "
                    "stop-the-world like snapshot compaction"
                ):
                    self._wal_file.flush()
                    size = os.path.getsize(self._wal_path)
                    os.truncate(self._wal_path, max(0, size - dropped))
                    if self._fsync:
                        os.fsync(self._wal_file.fileno())
            self._replica = False
            return self._version

    def _wal_raw_locked(self, version: int, data: str) -> None:
        """Journal one leader-shipped line byte-for-byte (the verbatim
        half of replicate; flush batched by the caller). Compaction is
        deferred while uncommitted entries are pending: a snapshot
        folds MEMORY state and truncates the WAL, which would silently
        drop the journaled-not-applied tail."""
        if self._wal_file is not None:
            self._wal_file.write(data)
            self._wal_seq += 1
            self._wal_count += 1
            if (
                self._wal_count >= self._snapshot_every
                and not self._repl_pending
            ):
                self._snapshot_locked()
        for tap in self._wal_taps:  # chained replication stays possible
            try:
                tap(version, data)
            except Exception:
                pass

    def dump_state(self) -> dict:
        """Consistent bootstrap snapshot for a late-joining follower —
        same shape as the on-disk snapshot ({version, items:[key, obj,
        version, expiry]}). Objects are copied: the dump outlives this
        lock hold and usually crosses a process/HTTP boundary."""
        with self._lock:
            self._expire_locked()
            items = [
                [k, obj, ver, self._ttl.get(k)]
                for k, (obj, ver) in sorted(self._data.items())
            ]
            version = self._version
        return {
            "version": version,
            "items": [[k, _copy_obj(o), v, e] for k, o, v, e in items],
        }

    def load_state(self, state: dict) -> None:
        """Install a leader bootstrap snapshot into this (empty)
        follower; durable followers immediately fold it into their own
        snapshot file so a restart recovers to the same point."""
        with self._lock:
            if self._data or self._version:
                raise StoreError("load_state requires an empty store")
            for key, obj, ver, exp in state["items"]:
                self._data[key] = (obj, ver)
                if exp is not None:
                    self._ttl[key] = exp
                    heapq.heappush(self._ttl_heap, (exp, key))
                    self._next_expiry = min(self._next_expiry, exp)
            self._version = state["version"]
            self._repl_journaled = self._version
            if self._wal_file is not None:
                self._snapshot_locked()

    def expire_now(self) -> None:
        """Process due TTL expirations (O(1) when none are due). Read
        caches call this before serving: expiry normally piggybacks on
        writes, so a quiet store could otherwise serve TTL'd objects
        past their deadline from a cache."""
        with self._lock:
            self._expire_locked()

    def watch(
        self,
        prefix: str,
        since: int = 0,
        maxsize: int = 4096,
        pred: Optional[Callable[[dict], bool]] = None,
        shard: Optional[tuple] = None,
    ) -> WatchStream:
        """Stream events for keys under prefix with version > since.

        since=0 means "from now". History older than the replay buffer
        raises CompactedError — caller must re-list (Reflector does).
        `pred` is a selector filter applied INSIDE the fan-out with
        etcd's modified-out-of-filter -> DELETED translation
        (_filter_event): non-matching events are never copied or queued
        for this watcher.

        `shard` = (extract_fn, value): a routing hint asserting this
        watcher's pred can only match objects whose extract_fn(obj)
        equals `value` (directly or via the previous state). The
        dispatcher then indexes the watcher by value instead of
        evaluating it against every event — O(1) fan-out for the
        1000-kubelets-each-watching-their-node shape. extract_fn must
        be a shared (module-level) callable so equal shards hash
        together.
        """
        with self._lock:
            self._expire_locked()
            # The replayable floor: with history, anything >= oldest-1;
            # without (fresh boot / post-restart), only "now" — an older
            # `since` has missed events that no longer exist, so 410.
            if since and since < self._version:
                if not self._history or since + 1 < self._oldest:
                    raise CompactedError(
                        f"version {since} compacted "
                        f"(oldest {self._oldest if self._history else self._version})"
                    )
            from kubernetes_tpu_torch.store.watch import resource_of_prefix

            stream = WatchStream(
                maxsize=maxsize, resource=resource_of_prefix(prefix)
            )
            if since:
                for v, etype, key, obj in self._history:
                    if v > since and key.startswith(prefix):
                        # History has no prev state: replay uses the
                        # spurious-DELETED degradation (_filter_event).
                        # History entries share stored objects, so each
                        # delivery gets its own copy.
                        ev = _filter_event(pred, etype, obj, None, v)
                        if ev is not None:
                            stream.push(Event(ev.type, _copy_obj(obj), v))
            # Replay covered everything <= the current version; the
            # floor makes the dispatcher's not-yet-fanned-out backlog
            # (all <= it, since writes need this lock) a no-op for this
            # stream instead of a duplicate. Registration happens only
            # AFTER replay so live events can't interleave mid-replay.
            stream.floor = self._version
            self._watchers = [
                w for w in self._watchers if not w[2].closed
            ]
            self._watchers.append((prefix, pred, stream, shard))
            self._rebuild_watch_index_locked()
            return stream

    def stop_watch(self, stream: WatchStream) -> None:
        stream.close()
        with self._lock:
            self._watchers = [
                w for w in self._watchers if not w[2].closed
            ]
            self._rebuild_watch_index_locked()

    def crash(self) -> None:
        """Abandon the store the way a killed process would (the chaos
        harness's kill -9 analog): watchers close, queued serialized
        writes fail with StoreClosedError, the flock releases — and
        unlike close(), NOTHING is fsynced and _synced_seq does not
        advance, so a writer racing the crash is refused its durability
        ack ("store closed before this write became durable") exactly
        as it would be by a real death.

        Fidelity note: file buffers still flush on handle close (we
        share the page cache with any successor store, so OS-level loss
        of flushed-not-fsynced bytes is not simulatable in-process).
        The WAL_TORN_WRITE fault site models death MID-append; this
        method models death between append and fsync."""
        with self._lock:
            self._closed = True
            for w in self._watchers:
                w[2].close()
            self._watchers = []
            self._unsharded = []
            self._shard_buckets = {}
            if self._write_q is not None:
                self._write_q.put(None)
                self._write_q = None
            self._dispatch_q.put(None)
            if self._wal_file is not None:
                try:
                    self._wal_file.close()
                except OSError:
                    pass
                self._wal_file = None
            if self._lockfd is not None:
                os.close(self._lockfd)  # the OS releases a dead owner's flock
                self._lockfd = None

    def close(self) -> None:
        with self._lock:
            self._closed = True
            for w in self._watchers:
                w[2].close()
            self._watchers = []
            self._unsharded = []
            self._shard_buckets = {}
            if self._write_q is not None:
                # Retire the serialized writer (it fails every queued
                # entry with StoreClosedError) and null the queue so
                # late writers take the direct path, where _bump
                # refuses writes on a closed store.
                self._write_q.put(None)
                self._write_q = None
            self._dispatch_q.put(None)  # retire the dispatcher thread
            if self._wal_file is not None:
                # fsync-before-close: a writer that appended its record
                # but hasn't reached _wal_sync yet must still find its
                # bytes durable (its wal-is-None path checks
                # _synced_seq). Without this, a write racing close()
                # would be acked flushed-but-not-fsync'd — exactly what
                # fsync-by-default promises can't happen.
                if self._fsync:
                    try:
                        with sanitizer.allow_blocking(
                            "close() is terminal; no writer can make "
                            "progress past a closed store anyway"
                        ):
                            self._wal_file.flush()
                            os.fsync(self._wal_file.fileno())
                        self._synced_seq = self._wal_seq
                    except OSError:
                        pass  # racing writers will refuse their acks
                self._wal_file.close()
                self._wal_file = None
            if self._lockfd is not None:
                os.close(self._lockfd)  # releases the flock
                self._lockfd = None
