"""Leader election over the apiserver, and the hot-standby wrapper.

The port's copy of `kubernetes_tpu/utils/leaderelect.py` (reference:
contrib/pod-master/podmaster.go: an etcd lock, created atomically, that
its holder renews and a standby takes over once it expires, keeping one
scheduler or controller manager active). The lock is an annotated
Endpoints object in kube-system, compare-and-swapped through the
apiserver's resourceVersion.

Holders and standbys must share a clock within the lease duration, as
in the reference.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from kubernetes_tpu_torch.client.rest import APIError

LOCK_NAMESPACE = "kube-system"
HOLDER_KEY = "leaderelection.kubernetes-tpu.io/holder"
RENEW_KEY = "leaderelection.kubernetes-tpu.io/renew-time"


class LeaderElector:
    """Acquires and renews the lock `name` as `identity` on a thread of
    its own. `on_started_leading` runs on every successful acquisition
    or renewal (its consumers are idempotent), `on_stopped_leading`
    once leadership is lost."""

    def __init__(
        self,
        client,
        name: str,
        identity: str,
        lease_duration: float = 5.0,
        renew_period: float = 1.0,
        retry_period: float = 1.0,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ):
        self.client = client
        self.name = name
        self.identity = identity
        self.lease_duration = lease_duration
        self.renew_period = renew_period
        self.retry_period = retry_period
        self.on_started = on_started_leading or (lambda: None)
        self.on_stopped = on_stopped_leading or (lambda: None)
        self.is_leader = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _try_acquire_or_renew(self) -> bool:
        now = time.time()
        try:
            obj = self.client.get("endpoints", self.name, namespace=LOCK_NAMESPACE)
        except APIError as e:
            if e.code != 404:
                raise
            # No lock yet: an atomic create (the loser gets a 409).
            try:
                self.client.create(
                    "endpoints",
                    {"kind": "Endpoints",
                     "metadata": {"name": self.name, "namespace": LOCK_NAMESPACE,
                                  "annotations": {HOLDER_KEY: self.identity,
                                                  RENEW_KEY: str(now)}}},
                    namespace=LOCK_NAMESPACE,
                )
                return True
            except APIError as ce:
                if ce.code == 409:
                    return False
                raise
        annotations = obj.metadata.annotations or {}
        holder = annotations.get(HOLDER_KEY, "")
        try:
            renewed = float(annotations.get(RENEW_KEY, "0") or "0")
        except ValueError:
            renewed = 0.0
        if holder != self.identity and now - renewed < self.lease_duration:
            return False  # someone else holds a live lease
        # Ours to take or renew: a CAS on the resourceVersion (a conflict
        # means another standby won the race).
        obj.metadata.annotations = dict(annotations)
        obj.metadata.annotations[HOLDER_KEY] = self.identity
        obj.metadata.annotations[RENEW_KEY] = str(now)
        try:
            self.client.update("endpoints", obj, namespace=LOCK_NAMESPACE)
            return True
        except APIError as e:
            if e.code == 409:
                return False
            raise

    def start(self) -> "LeaderElector":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        if self.is_leader:
            self.is_leader = False
            self.on_stopped()

    def _run(self) -> None:
        last_renew = 0.0
        while not self._stop.is_set():
            now = time.time()
            try:
                acquired = self._try_acquire_or_renew()
                if acquired:
                    last_renew = now
            except Exception:
                # A transient API failure: lead only within the lease
                # window, or a partitioned leader and the standby that
                # took over would both run.
                acquired = self.is_leader and (now - last_renew) < self.lease_duration
            if self._stop.is_set():
                # stop() may have finished while the call above stalled;
                # a late `acquired` would start a daemon nothing stops.
                return
            if acquired:
                self.is_leader = True
                try:
                    self.on_started()
                except Exception:
                    pass
            elif self.is_leader:
                self.is_leader = False
                try:
                    self.on_stopped()
                except Exception:
                    pass
            self._stop.wait(self.renew_period if self.is_leader else self.retry_period)


class HAHotStandby:
    """Runs a daemon only while holding leadership (podmaster.go's whole
    job: the standby process is alive and idle until the lease falls to
    it).

    `factory` builds and starts the daemon and returns an object with
    `stop()`; it is called on every acquisition (the daemons are not
    restartable in place)."""

    def __init__(self, client, lock_name: str, identity: str, factory: Callable[[], object],
                 **elector_kwargs):
        self.factory = factory
        self.daemon: Optional[object] = None
        self._lock = threading.Lock()
        self._want = False
        self._starting = False
        self.elector = LeaderElector(client, lock_name, identity, on_started_leading=self._up,
                                     on_stopped_leading=self._down, **elector_kwargs)

    def _up(self) -> None:
        """Idempotent; called on every renewal. The build runs on a
        thread of its own: a slow start-up (the informers' sync, the
        session's build) on the elector's thread would hold renewals past
        the lease. A failed build is tried again at the next renewal."""
        with self._lock:
            self._want = True
            if self.daemon is not None or self._starting:
                return
            self._starting = True
        threading.Thread(target=self._build, daemon=True).start()

    def _build(self) -> None:
        try:
            daemon = self.factory()
        except Exception:
            with self._lock:
                self._starting = False  # tried again at the next renewal
            return
        stale = None
        with self._lock:
            self._starting = False
            if self._want:
                self.daemon = daemon
            else:
                stale = daemon  # leadership lost while it was built
        if stale is not None:
            stale.stop()

    def _down(self) -> None:
        with self._lock:
            self._want = False
            daemon, self.daemon = self.daemon, None
        if daemon is not None:
            daemon.stop()

    def start(self) -> "HAHotStandby":
        self.elector.start()
        return self

    def stop(self) -> None:
        self.elector.stop()
        self._down()

    @property
    def active(self) -> bool:
        return self.daemon is not None
