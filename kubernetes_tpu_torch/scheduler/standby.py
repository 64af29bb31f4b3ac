"""Warm-standby scheduler: lease-gated failover without the cold start.

The port's copy of `kubernetes_tpu/scheduler/standby.py`. A cold
failover pays three latencies in series: the LIST and watch of every
informer, the `SolverSession`'s build (the host lowering and the upload
to the card) and its first launches. The standby keeps that state
resident on a follower: its informers run (started and synced) and it
holds a prewarmed, not started `IncrementalBatchScheduler` whose session
is on the card. Watch deltas queue in the daemon's event queue through
the `SchedulerConfig.cluster_events` hook and are not applied, so the
session is one replay behind the cluster. Activation is
`daemon.start()`: the first tick replays the queued deltas (the session's
handlers are idempotent: a pod already charged is not charged again, an
absent one is not freed) and solves the backlog at once. That is what
keeps `failover_to_first_bind_s` (`utils/slo.py`) under a second.

`HAScheduler` ties a standby to a fencing lease (`utils/lease.py`):
`on_elected` activates it, `on_lost` kills its daemon (a deposed leader
stops binding at once: its token is stale) and prewarms a fresh standby,
so the replica stands for election again warm. A rebuild that fails is
logged and counted (`rebuild_failures`), and the next election builds
one; nothing falls back to the CPU. Both run on the elector's thread, as
in JAX, so a prewarm there holds the lease's renewals for its length.
A replica that cannot take office (the build or the activation at its
election raises) departs from JAX, which swallows the error and goes on
renewing a lease it does not serve: it logs and counts the failure
(`election_failures`), drops its standby and declines the lease, which
the elector releases before sitting out one lease duration, so a rival
leads.

The standby's daemon comes from `daemon_factory` (default: an
`IncrementalBatchScheduler` on the CUDA card; a standby built without
one raises). The leader's session and the follower's share the card
while both replicas run in one process.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from kubernetes_tpu_torch.scheduler.daemon import IncrementalBatchScheduler, SchedulerConfig
from kubernetes_tpu_torch.utils import metrics
from kubernetes_tpu_torch.utils.lease import LeaseClient, LeaseElector

_LOG = logging.getLogger("kubernetes_tpu_torch.scheduler.standby")

#: Seconds from a lease's grant to the standby's daemon running: the
#: control plane's part of failover_to_first_bind_s.
_ACTIVATION_LATENCY = metrics.DEFAULT.summary(
    "scheduler_standby_activation_seconds",
    "Warm-standby activation latency (lease grant to daemon running)",
)


class WarmStandbyScheduler:
    """A prewarmed, idle IncrementalBatchScheduler.

    `prewarm()` starts the informers, waits for their sync and builds
    the daemon's session (its warm launches too, when `daemon_factory`
    gives it `prewarm_buckets`); `activate()` starts the solve loop;
    `kill()` and `stop()` tear down. An instance activates at most once:
    a deposed leader builds a fresh standby (the killed daemon's session
    may hold charges for binds that never landed). `sync_s` and
    `build_s` are the last prewarm's two parts."""

    def __init__(
        self,
        client,
        sync_timeout: float = 10.0,
        daemon_factory: Callable[[SchedulerConfig], IncrementalBatchScheduler] = (
            IncrementalBatchScheduler),
    ):
        self.client = client
        self.sync_timeout = sync_timeout
        self.config = SchedulerConfig(client)
        # The daemon installs the cluster_events hook: before
        # config.start(), so no delta is missed.
        self.daemon = daemon_factory(self.config)
        self._warm = False
        self._active = False
        self.activated_mono: Optional[float] = None
        self.sync_s: Optional[float] = None
        self.build_s: Optional[float] = None

    @property
    def warm(self) -> bool:
        return self._warm

    @property
    def active(self) -> bool:
        return self._active

    def prewarm(self) -> "WarmStandbyScheduler":
        """Start the informers, wait for their sync, build the session.
        Deltas from here on queue in the daemon and replay at
        activation. Raises what the build raises, the informers
        stopped."""
        if self._warm:
            return self
        t0 = time.monotonic()
        self.config.start()
        try:
            if not self.config.wait_for_sync(self.sync_timeout):
                raise TimeoutError("standby informers failed to sync")
            t1 = time.monotonic()
            # Built from the synced caches; deltas that raced the build
            # replay idempotently at activation.
            self.daemon.prewarm()
        except BaseException:
            self.config.stop()  # no informer outlives a failed prewarm
            raise
        self.sync_s, self.build_s = t1 - t0, time.monotonic() - t1
        self._warm = True
        return self

    def activate(self) -> IncrementalBatchScheduler:
        """Start the solve loop (prewarming first if needed). Idempotent;
        returns the live daemon."""
        if self._active:
            return self.daemon
        if not self._warm:
            self.prewarm()
        self.daemon.start()
        self._active = True
        self.activated_mono = time.monotonic()
        return self.daemon

    def stop(self) -> None:
        """Graceful teardown (the commit pipeline flushed)."""
        if self._active:
            self.daemon.stop()
            self._active = False
        if self._warm:
            self.config.stop()
            self._warm = False

    def kill(self) -> None:
        """Abrupt teardown, the deposed leader's: queued commits are
        dropped (`daemon.kill()`), so a dead leader binds nothing after
        its lease is gone; a bind already on the wire may still land."""
        if self._active:
            self.daemon.kill()
            self._active = False
        if self._warm:
            try:
                self.config.stop()
            except Exception:
                _LOG.debug("standby config stop failed", exc_info=True)
            self._warm = False


class HAScheduler:
    """A lease-elected scheduler with a warm standby behind it; one a
    control-plane replica. The replica whose acquisition succeeds (the
    fencing token bumps, `leader_elections_total{tier="scheduler"}`)
    activates its prewarmed daemon; on losing the lease the daemon is
    killed and a fresh standby prewarmed."""

    def __init__(
        self,
        client,
        identity: str,
        lease_name: str = "kt-scheduler",
        lease_duration: float = 5.0,
        renew_period: float = 1.0,
        retry_period: float = 1.0,
        standby_factory: Optional[Callable[[], WarmStandbyScheduler]] = None,
    ):
        self.client = client
        self.identity = identity
        self._factory = standby_factory or (lambda: WarmStandbyScheduler(client))
        self.lease = LeaseClient(client, lease_name, identity, tier="scheduler",
                                 lease_duration=lease_duration)
        self.elector = LeaseElector(self.lease, renew_period=renew_period,
                                    retry_period=retry_period, on_elected=self._elected,
                                    on_lost=self._deposed)
        self.standby: Optional[WarmStandbyScheduler] = None
        self.token: Optional[int] = None
        # Standby rebuilds after a deposition that raised.
        self.rebuild_failures = 0
        # Elections declined because the standby's build or activation
        # raised.
        self.election_failures = 0
        # Serializes the elector's callbacks against start and stop.
        self._transition = threading.Lock()
        self._stopping = False

    @property
    def is_leader(self) -> bool:
        return self.token is not None

    @property
    def daemon(self) -> Optional[IncrementalBatchScheduler]:
        sb = self.standby
        return sb.daemon if sb is not None and sb.active else None

    def start(self) -> "HAScheduler":
        """Prewarm the standby first, then stand for election: a replica
        that won before it was warm would pay the cold start."""
        with self._transition:
            self._stopping = False
            if self.standby is None:
                self.standby = self._factory().prewarm()
        self.elector.start()
        return self

    def stop(self) -> None:
        with self._transition:
            self._stopping = True
        self.elector.stop()  # fires on_lost if leading
        with self._transition:
            sb, self.standby = self.standby, None
            if sb is not None:
                sb.stop()

    # -- the elector's callbacks (its thread) -------------------------

    def _elected(self, token: int) -> None:
        with self._transition:
            if self._stopping:
                return
            self.token = token
            try:
                sb = self.standby
                if sb is None:
                    sb = self.standby = self._factory().prewarm()
                granted = time.monotonic()
                sb.activate()
            except Exception:
                # Holding a lease it does not serve would stop the whole
                # control plane: decline it (the elector releases it and
                # sits out), so a rival leads.
                self.token = None
                self.election_failures += 1
                sb, self.standby = self.standby, None
                if sb is not None:
                    sb.kill()
                _LOG.error("%s: scheduler could not take office (token %d); lease declined",
                           self.identity, token, exc_info=True)
                raise
            _ACTIVATION_LATENCY.observe(time.monotonic() - granted)
            _LOG.info("%s: scheduler leadership acquired (token %d); warm standby activated",
                      self.identity, token)

    def _deposed(self) -> None:
        with self._transition:
            self.token = None
            sb, self.standby = self.standby, None
            if sb is not None:
                sb.kill()  # a stale token: stop binding now
            _LOG.warning("%s: scheduler leadership lost; daemon killed", self.identity)
            if self._stopping:
                return
            # Stand for election again, warm.
            try:
                self.standby = self._factory().prewarm()
            except Exception:
                self.rebuild_failures += 1
                _LOG.warning("%s: standby rebuild failed; will retry on next election",
                             self.identity, exc_info=True)
