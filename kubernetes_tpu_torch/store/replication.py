"""WAL-shipping replication for the kvstore — the raft-lite HA plane.

The reference delegates layer-0 durability AND availability to etcd;
we own the WAL, so replication is an append stream plus a commit
index. The protocol, end to end:

- The **leader** is an ordinary ``KVStore`` with a ``ReplicationHub``
  attached through ``add_wal_tap``: every journaled mutation hands the
  hub its exact WAL line (newline-terminated bytes), under the store
  lock, in version order. The hub only buffers there; shipping happens
  on one thread per follower.
- Each **follower** is a ``KVStore`` in replica mode wrapped in a
  ``FollowerReplica``. Shipped lines are journaled verbatim into the
  follower's own WAL (durable before the ack — that journaled version
  is what quorum counts) and applied to the live mirror only up to the
  leader's **commit index**, so the follower's watch cache serves
  exactly the committed prefix and never a torn or unacked record.
- The **commit index** is the highest version durable on a majority of
  the cluster (leader + followers). Leader write acks gate on it via
  ``KVStore.set_commit_gate`` — fsync-before-ack extended to
  quorum-before-ack — and ``ReplicationHub.wait_committed``
  additionally waits until enough followers have *learned* the index,
  so a write acked to a client survives any single-process death and a
  promoted follower exposes it.
- **Failover**: ``FollowerReplica.promote()`` truncates the
  uncommitted journaled tail out of the WAL (the store's torn-line
  recovery, extended to replication) and flips the store
  writable. A new ``ReplicationHub`` can then be attached to the
  promoted store to re-form the cluster.

Links come in two transports: ``LocalLink`` (in-process, the soak/
bench/test harness) and ``HTTPLink`` (POSTs to a follower apiserver's
``/replication/append``, riding the same HTTP plane as every other
verb). Both are driven by the hub's per-follower shipper threads, so a
slow follower lags alone instead of convoying the others.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from kubernetes_tpu_torch.store.kvstore import KVStore, StoreError
from kubernetes_tpu_torch.utils import metrics

COMMIT_INDEX = metrics.DEFAULT.gauge(
    "replication_commit_index",
    "Highest store version durable on a quorum of replicas",
    labels=("role",),
)
FOLLOWER_LAG = metrics.DEFAULT.gauge(
    "replication_follower_lag_versions",
    "Versions the follower's durable log trails the leader by",
    labels=("follower",),
)


class ReplicationError(StoreError):
    """Replication-plane failure (quorum timeout, stale-leader append,
    dead link)."""


class LocalLink:
    """In-process link to a FollowerReplica (tests, soak, bench)."""

    def __init__(self, replica: "FollowerReplica", name: str = "follower"):
        self.name = name
        self._replica = replica

    def append(self, lines: List[str], commit: int) -> int:
        return self._replica.append(lines, commit)

    def commit(self, commit: int) -> int:
        return self._replica.append([], commit)

    def status(self) -> dict:
        return self._replica.status()


class HTTPLink:
    """Link to a follower apiserver over the existing HTTP plane.

    POSTs {"lines": [...], "commit": N} to /replication/append on the
    follower's base URL; the follower answers {"journaled": N}. Uses a
    dedicated keep-alive connection (NOT the client transport's pool:
    replication must keep flowing while user traffic rotates away from
    a sick endpoint)."""

    def __init__(self, base_url: str, name: Optional[str] = None,
                 timeout: float = 10.0):
        from urllib.parse import urlparse

        u = urlparse(base_url)
        self.host, self.port = u.hostname, u.port or 80
        self.name = name or f"{self.host}:{self.port}"
        self.timeout = timeout
        self._conn = None

    def _request(self, body: dict) -> dict:
        import http.client

        payload = json.dumps(body)
        for attempt in (0, 1):  # one free replay for a stale keep-alive
            if self._conn is None:
                self._conn = http.client.HTTPConnection(
                    self.host, self.port, timeout=self.timeout
                )
            try:
                self._conn.request(
                    "POST", "/replication/append", body=payload,
                    headers={"Content-Type": "application/json"},
                )
                resp = self._conn.getresponse()
                data = resp.read()
                if resp.status != 200:
                    raise ReplicationError(
                        f"follower {self.name}: HTTP {resp.status} "
                        f"{data[:200]!r}"
                    )
                return json.loads(data)
            except (OSError, http.client.HTTPException):
                try:
                    self._conn.close()
                except Exception:
                    pass
                self._conn = None
                if attempt:
                    raise

    def append(self, lines: List[str], commit: int) -> int:
        return int(self._request({"lines": lines, "commit": commit})[
            "journaled"
        ])

    def commit(self, commit: int) -> int:
        return self.append([], commit)

    def status(self) -> dict:
        return self._request({"lines": [], "commit": -1})


class _Follower:
    """Hub-side state for one link (all fields guarded by the hub CV)."""

    def __init__(self, link, start: int):
        self.link = link
        self.next = start  # buffer offset of the next line to ship
        self.acked = 0  # highest version durable in the follower's log
        self.commit_known = 0  # highest commit index delivered to it
        self.alive = True
        self.thread: Optional[threading.Thread] = None


class ReplicationHub:
    """Leader-side shipping plane over one KVStore.

    attach() taps the store's WAL and (by default) gates its write
    acks on the quorum commit index. Followers are added with
    add_follower(link, bootstrap=...); each gets a shipper thread that
    streams new lines + the current commit index, retrying dead links
    with bounded backoff. stop() detaches the gate and retires the
    shippers (a crashed leader never stops cleanly — that path is the
    follower's promote())."""

    def __init__(self, store: KVStore, ack_timeout_s: float = 5.0,
                 name: str = "leader"):
        self.name = name
        self.store = store
        self.ack_timeout_s = ack_timeout_s
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._buf: deque = deque()  # raw lines, in version order
        self._base = 0  # buffer offset of _buf[0]
        self._last_version = 0  # highest version tapped (or bootstrapped)
        self._commit = 0
        self._followers: List[_Follower] = []
        self._stopped = False
        self._attached = False

    # -- wiring -------------------------------------------------------

    def attach(self, gate_writes: bool = True) -> "ReplicationHub":
        """Tap the store's WAL; optionally gate its acks on quorum."""
        with self._cv:
            if self._attached:
                return self
            self._attached = True
            self._last_version = self.store.version
            self._commit = self._last_version
        self.store.add_wal_tap(self._tap)
        if gate_writes:
            self.store.set_commit_gate(self._gate)
        COMMIT_INDEX.set(self._commit, role="leader")
        return self

    def _tap(self, version: int, data: str) -> None:
        # Runs UNDER the store lock — buffer + wake shippers, nothing
        # else. The hub CV nests inside the store lock here and is
        # never held while calling into the store, so the order is DAG.
        with self._cv:
            self._buf.append(data)
            self._last_version = version
            # Single-node cluster (no followers yet): local fsync IS
            # quorum — advance the commit index here or the gate would
            # park forever waiting on nobody.
            self._recompute_commit_locked()
            self._trim_locked()
            self._cv.notify_all()

    def add_follower(self, link, bootstrap: bool = True) -> None:
        """Register a follower link. bootstrap=True ships a full
        dump_state() first (late joiners — the WAL tap only carries
        lines since attach), through the link's replica if local or a
        /replication/bootstrap POST for HTTP links."""
        if bootstrap:
            state = self.store.dump_state()
            if isinstance(link, LocalLink):
                link._replica.bootstrap(state)
            else:
                link._request({"bootstrap": state})  # type: ignore[attr-defined]
        with self._cv:
            f = _Follower(link, start=self._base + len(self._buf))
            f.acked = self.store.version if bootstrap else 0
            self._followers.append(f)
            self._recompute_commit_locked()
            f.thread = threading.Thread(
                target=self._ship_loop, args=(f,), daemon=True,
                name=f"repl-ship-{link.name}",
            )
            f.thread.start()

    def stop(self) -> None:
        self.store.set_commit_gate(None)
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    # -- commit plumbing ----------------------------------------------

    def _majority(self) -> int:
        return (len(self._followers) + 1) // 2 + 1

    def _recompute_commit_locked(self) -> bool:
        """Commit index = highest version durable on a majority (the
        leader's own fsync-before-ack covers its vote)."""
        need = self._majority() - 1  # follower votes beyond the leader
        if need <= 0:
            commit = self._last_version
        else:
            acks = sorted((f.acked for f in self._followers), reverse=True)
            commit = acks[need - 1] if len(acks) >= need else 0
        commit = min(commit, self._last_version)
        if commit > self._commit:
            self._commit = commit
            COMMIT_INDEX.set(commit, role="leader")
            self._cv.notify_all()
            return True
        return False

    @property
    def commit_index(self) -> int:
        with self._cv:
            return self._commit

    def wait_committed(self, version: int,
                       timeout: Optional[float] = None) -> int:
        """Block until `version` is quorum-durable AND enough followers
        have learned a commit index covering it — the full before-ack
        barrier (a follower promoted the instant this returns must
        expose the write). Raises ReplicationError on timeout: the
        write is journaled locally but NOT acked, exactly a raft
        leader losing its quorum."""
        deadline = time.monotonic() + (
            self.ack_timeout_s if timeout is None else timeout
        )
        need = None
        with self._cv:
            while True:
                need = self._majority() - 1
                known = sum(
                    1 for f in self._followers if f.commit_known >= version
                )
                if self._commit >= version and known >= need:
                    return self._commit
                left = deadline - time.monotonic()
                if left <= 0 or self._stopped:
                    raise ReplicationError(
                        f"write v{version} not committed within "
                        f"{self.ack_timeout_s}s (commit={self._commit}, "
                        f"followers knowing={known}/{need})"
                    )
                self._cv.wait(timeout=min(left, 0.5))

    def _gate(self) -> None:
        # store.version is >= the acking write's version; waiting for
        # it over-waits by at most the in-flight concurrent writes —
        # the raft-lite simplification that keeps the store's write
        # paths version-agnostic.
        self.wait_committed(self.store.version)

    # -- shipping -----------------------------------------------------

    def _ship_loop(self, f: _Follower) -> None:
        backoff = 0.05
        while True:
            with self._cv:
                while (
                    not self._stopped
                    and f.next >= self._base + len(self._buf)
                    and f.commit_known >= self._commit
                ):
                    self._cv.wait(timeout=0.5)
                if self._stopped:
                    return
                lines = list(
                    itertools.islice(
                        self._buf, max(0, f.next - self._base), None
                    )
                )
                sent_upto = self._base + len(self._buf)
                commit = self._commit
            try:
                acked = f.link.append(lines, commit)
            except Exception:
                f.alive = False
                time.sleep(backoff)
                backoff = min(backoff * 2, 2.0)
                continue
            backoff = 0.05
            f.alive = True
            with self._cv:
                f.next = sent_upto
                f.commit_known = max(f.commit_known, commit)
                if acked > f.acked:
                    f.acked = acked
                FOLLOWER_LAG.set(
                    max(0, self._last_version - f.acked),
                    follower=f.link.name,
                )
                self._recompute_commit_locked()
                self._trim_locked()
                self._cv.notify_all()

    def _trim_locked(self) -> None:
        """Drop buffered lines every follower has been sent (late
        joiners bootstrap from dump_state, never from this buffer —
        with no followers the buffer stays empty)."""
        floor = min(
            (f.next for f in self._followers),
            default=self._base + len(self._buf),
        )
        while self._base < floor and self._buf:
            self._buf.popleft()
            self._base += 1

    # -- introspection ------------------------------------------------

    def status(self) -> dict:
        with self._cv:
            return {
                "role": "leader",
                "name": self.name,
                "version": self._last_version,
                "commitIndex": self._commit,
                "followers": [
                    {
                        "name": f.link.name,
                        "acked": f.acked,
                        "commitKnown": f.commit_known,
                        "lagVersions": max(0, self._last_version - f.acked),
                        "alive": f.alive,
                    }
                    for f in self._followers
                ],
            }


class FollowerReplica:
    """Follower-side ingest over one replica-mode KVStore."""

    def __init__(self, store: Optional[KVStore] = None,
                 name: str = "follower"):
        self.name = name
        self.store = store if store is not None else KVStore()
        self.store.set_replica_mode(True)
        # append() fsyncs the follower WAL under this lock by design: it
        # serializes the (single-shipper) ingest order.
        self._lock = threading.Lock()
        self._commit = 0
        self._promoted = False

    def bootstrap(self, state: dict) -> None:
        """Install a leader dump_state() snapshot (late join)."""
        with self._lock:
            self.store.load_state(state)
            self._commit = state["version"]
            COMMIT_INDEX.set(self._commit, role=f"follower:{self.name}")

    def append(self, lines: List[str], commit: int) -> int:
        """Journal shipped lines + apply the committed prefix; returns
        the journaled (quorum-countable) version. commit=-1 is a pure
        status probe."""
        with self._lock:
            if self._promoted:
                raise ReplicationError(
                    f"follower {self.name} was promoted; stale leader?"
                )
            if commit < 0:
                return self.store.journaled_version
            self._commit = max(self._commit, commit)
            journaled, _applied = self.store.replicate(lines, self._commit)
            COMMIT_INDEX.set(
                min(self._commit, journaled), role=f"follower:{self.name}"
            )
            return journaled

    @property
    def commit_index(self) -> int:
        with self._lock:
            return min(self._commit, self.store.journaled_version)

    def promote(self) -> KVStore:
        """Leader died: discard the uncommitted tail and hand back the
        store as a writable leader serving exactly the committed
        prefix."""
        with self._lock:
            self._promoted = True
            self.store.promote_replica()
            COMMIT_INDEX.set(self.store.version, role="leader")
            return self.store

    def status(self) -> dict:
        with self._lock:
            version = self.store.version
            journaled = self.store.journaled_version
            commit = (
                version if self._promoted else min(self._commit, journaled)
            )
            return {
                "role": "leader" if self._promoted else "follower",
                "name": self.name,
                "version": version,
                "journaled": journaled,
                "commitIndex": commit,
                "followers": [],
            }
