"""CAS-renewed lease with a monotonic fencing token.

The port's copy of `kubernetes_tpu/utils/lease.py`. `utils/leaderelect.py`
answers "who runs the daemon"; this module answers "whose writes are
still legitimate". The lease lives in the store as an annotated
Endpoints record in kube-system, compare-and-swapped through its
resourceVersion like the elector's lock, and carries a fencing token:
an integer bumped on every change of effective holder (a fresh create,
the steal of an expired lease, or the re-acquisition after this
identity's own lease lapsed), never on a plain renewal. Whoever works
on behalf of the lease carries its token; `validate` and `require`
refuse a token older than the current one, so a stale holder (paused,
partitioned, or on a slow clock) cannot write after a takeover even
while it still believes it leads.

The clock is injectable: the tests drive whole renew/expire/steal
schedules without sleeping, and make a renew's write vanish or a
holder's clock run slow through the clock and the client they hand in.
The JAX module's fault seams (`lease.renew.lost`, `lease.clock.skew`)
are not carried (departure (c) of `scheduler/daemon.py`): nothing in
the port injects faults.

`LeaseElector` wraps the client in the renew/steal loop (the shape of
`LeaderElector`, with the token threaded into the callbacks); it gates
the warm-standby scheduler (`scheduler/standby.py`). Unlike JAX's, an
`on_elected` that raises declines the lease: the elector logs it,
releases the lease and sits out one lease duration before it stands
again, so a replica that cannot serve does not hold the lease forever.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from kubernetes_tpu_torch.client.rest import APIError
from kubernetes_tpu_torch.utils import metrics

_LOG = logging.getLogger("kubernetes_tpu_torch.utils.lease")

LEASE_NAMESPACE = "kube-system"
HOLDER_KEY = "lease.kubernetes-tpu.io/holder"
RENEW_KEY = "lease.kubernetes-tpu.io/renew-time"
TOKEN_KEY = "lease.kubernetes-tpu.io/fencing-token"

ELECTIONS = metrics.DEFAULT.counter(
    "leader_elections_total",
    "Leadership acquisitions (fencing-token bumps) per control-plane tier",
    labels=("tier",),
)

RENEW_LATENCY = metrics.DEFAULT.histogram(
    "lease_renew_latency_seconds",
    "Lease CAS round-trip (read + conditional write) per op: renew for the live "
    "holder's heartbeat, acquire for create/steal/observe passes",
    labels=("op",),
)


class LeaseFenceError(Exception):
    """A write carried a fencing token older than the current lease:
    the writer lost leadership and must stop."""


class LeaseRecord:
    """Snapshot of the lease object."""

    __slots__ = ("holder", "token", "renewed", "resource_version")

    def __init__(self, holder: str, token: int, renewed: float,
                 resource_version: Optional[int]):
        self.holder = holder
        self.token = token
        self.renewed = renewed
        self.resource_version = resource_version

    def __repr__(self) -> str:
        return f"<Lease holder={self.holder!r} token={self.token} renewed={self.renewed:.3f}>"


class LeaseClient:
    """CAS lease mechanics for one identity over one named lease. The
    record in the store carries the true clock's times; the identity's
    belief in its own lease (`held_token`) decays on its `clock`."""

    def __init__(
        self,
        client,
        name: str,
        identity: str,
        tier: str = "scheduler",
        lease_duration: float = 5.0,
        clock: Callable[[], float] = time.time,
    ):
        self.client = client
        self.name = name
        self.identity = identity
        self.tier = tier
        self.lease_duration = lease_duration
        self._clock = clock
        # What this identity believes it holds: updated only by its own
        # acquire and renew outcomes and its own clock.
        self._held_token: Optional[int] = None
        self._renewed_local = 0.0
        self._last_op = "acquire"

    def now(self) -> float:
        return self._clock()

    # -- record I/O ---------------------------------------------------

    def _read_obj(self):
        try:
            return self.client.get("endpoints", self.name, namespace=LEASE_NAMESPACE)
        except APIError as e:
            if e.code == 404:
                return None
            raise

    @staticmethod
    def _record_of(obj) -> LeaseRecord:
        ann = obj.metadata.annotations or {}
        try:
            renewed = float(ann.get(RENEW_KEY, "0") or "0")
        except ValueError:
            renewed = 0.0
        try:
            token = int(ann.get(TOKEN_KEY, "0") or "0")
        except ValueError:
            token = 0
        rv = None
        try:
            rv = int(obj.metadata.resource_version or 0)
        except (TypeError, ValueError):
            pass
        return LeaseRecord(ann.get(HOLDER_KEY, ""), token, renewed, rv)

    def read(self) -> Optional[LeaseRecord]:
        obj = self._read_obj()
        return None if obj is None else self._record_of(obj)

    def try_acquire(self) -> Optional[int]:
        """Acquire, steal or renew; the fencing token while held after
        this call, else None. A plain renewal keeps the token; any change
        of effective holder bumps it and counts as an election."""
        t0 = time.monotonic()
        self._last_op = "acquire"
        try:
            return self._try_acquire()
        finally:
            # Failed and slow rounds count too.
            RENEW_LATENCY.observe(time.monotonic() - t0, op=self._last_op)

    def _try_acquire(self) -> Optional[int]:
        now = self.now()
        obj = self._read_obj()
        rec = None if obj is None else self._record_of(obj)
        if rec is None:
            # No lease yet: an atomic create; the loser of the race 409s.
            try:
                self.client.create(
                    "endpoints",
                    {"kind": "Endpoints",
                     "metadata": {"name": self.name, "namespace": LEASE_NAMESPACE,
                                  "annotations": {HOLDER_KEY: self.identity,
                                                  RENEW_KEY: str(self._clock()),
                                                  TOKEN_KEY: "1"}}},
                    namespace=LEASE_NAMESPACE,
                )
            except APIError as e:
                if e.code == 409:
                    return self.held_token()
                raise
            self._held_token = 1
            self._renewed_local = now
            ELECTIONS.inc(tier=self.tier)
            return 1
        true_now = self._clock()
        renewing = rec.holder == self.identity and self._held_token == rec.token
        if renewing:
            self._last_op = "renew"
        expired = true_now - rec.renewed >= self.lease_duration
        if not renewing and not expired:
            return self.held_token()  # someone else holds a live lease
        token = rec.token if renewing and not expired else rec.token + 1
        try:
            # CAS against the resourceVersion of the read the decision
            # used: any rival write in between conflicts.
            ann = dict(obj.metadata.annotations or {})
            ann[HOLDER_KEY] = self.identity
            ann[RENEW_KEY] = str(true_now)
            ann[TOKEN_KEY] = str(token)
            obj.metadata.annotations = ann
            self.client.update("endpoints", obj, namespace=LEASE_NAMESPACE)
        except APIError as e:
            if e.code in (404, 409):
                return self.held_token()  # lost the race
            raise
        self._held_token = token
        self._renewed_local = now
        if not renewing:
            ELECTIONS.inc(tier=self.tier)
        return token

    def release(self) -> None:
        """Drop the lease cooperatively (renew time zeroed, so a rival
        takes over at once); the local belief clears regardless."""
        token, self._held_token = self._held_token, None
        if token is None:
            return
        try:
            obj = self.client.get("endpoints", self.name, namespace=LEASE_NAMESPACE)
            ann = dict(obj.metadata.annotations or {})
            if ann.get(HOLDER_KEY) != self.identity:
                return
            ann[RENEW_KEY] = "0"
            obj.metadata.annotations = ann
            self.client.update("endpoints", obj, namespace=LEASE_NAMESPACE)
        except APIError:
            pass  # best effort: expiry reclaims it anyway

    # -- belief and fencing -------------------------------------------

    def held_token(self) -> Optional[int]:
        """The token this identity believes it holds, decayed on its own
        clock: None once its window lapses."""
        if self._held_token is None:
            return None
        if self.now() - self._renewed_local >= self.lease_duration:
            return None  # could have been stolen; stop acting
        return self._held_token

    def validate(self, token: Optional[int]) -> bool:
        """Whether `token` is the current fencing token, by the record:
        the store is the fencing authority, never anyone's clock."""
        if token is None:
            return False
        rec = self.read()
        return rec is not None and rec.token == token

    def require(self, token: Optional[int]) -> None:
        if not self.validate(token):
            rec = self.read()
            raise LeaseFenceError(f"{self.identity}: fencing token {token} is stale "
                                  f"(current: {rec.token if rec else 'none'})")


class LeaseElector:
    """The renew/steal loop over a LeaseClient. `on_elected(token)`
    fires once an acquisition (raising, it declines the lease),
    `on_renewed(token)` on every successful renewal, `on_lost()` when
    the belief lapses or a rival took the lease."""

    def __init__(
        self,
        lease: LeaseClient,
        renew_period: float = 1.0,
        retry_period: float = 1.0,
        on_elected: Optional[Callable[[int], None]] = None,
        on_renewed: Optional[Callable[[int], None]] = None,
        on_lost: Optional[Callable[[], None]] = None,
    ):
        self.lease = lease
        self.renew_period = renew_period
        self.retry_period = retry_period
        self.on_elected = on_elected or (lambda _t: None)
        self.on_renewed = on_renewed or (lambda _t: None)
        self.on_lost = on_lost or (lambda: None)
        self.token: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def is_leader(self) -> bool:
        return self.token is not None

    def start(self) -> "LeaseElector":
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"lease-{self.lease.name}-{self.lease.identity}",
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.token is not None:
            self.token = None
            self.lease.release()
            try:
                self.on_lost()
            except Exception:
                pass

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                token = self.lease.try_acquire()
            except Exception:
                # A transient failure: believe only within the local window.
                token = self.lease.held_token()
            if self._stop.is_set():
                return
            if token is not None and self.token is None:
                self.token = token
                try:
                    self.on_elected(token)
                except Exception:
                    _LOG.warning("%s: on_elected raised; lease %s declined",
                                 self.lease.identity, self.lease.name, exc_info=True)
                    self.token = None
                    try:
                        self.lease.release()
                    except Exception:
                        pass  # expiry reclaims it
                    self._stop.wait(self.lease.lease_duration)
                    continue
            elif token is not None:
                self.token = token
                try:
                    self.on_renewed(token)
                except Exception:
                    pass
            elif self.token is not None:
                self.token = None
                try:
                    self.on_lost()
                except Exception:
                    pass
            self._stop.wait(self.renew_period if self.is_leader else self.retry_period)
