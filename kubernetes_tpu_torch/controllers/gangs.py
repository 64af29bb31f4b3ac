"""GangController: PodGroup lifecycle (status, aging, events).

No direct reference analog (the closest shape is the sig-scheduling
coscheduling controller's PodGroup status loop); structurally it is a
standard level-triggered controller like controllers/resourcequota.py:
every sync period it reconciles each PodGroup's observed membership
against its declared gang intent.

Per group, each pass:

- recounts members (pods carrying POD_GROUP_LABEL in the group's
  namespace) and bound members (spec.nodeName set), publishing both in
  status;
- flips phase to Scheduled (+ event) once bound >= minMember — the
  gang landed, whoever solved it;
- ages groups stuck Pending past spec.scheduleTimeoutSeconds: marks
  them Unschedulable, emits a GangTimeout event, and bumps
  gang_solve_outcomes_total{outcome="timeout"}. Unschedulable is NOT
  terminal — member pods stay in the scheduler's backoff requeue loop,
  so a later successful gang solve flips the group straight to
  Scheduled (the "requeue" half of age-out: nothing needs resubmitting).

The port's copy of `kubernetes_tpu/controllers/gangs.py`, counting with
the port's `scheduler/gang.py` (`OUTCOMES`, `pod_is_live`); groups and
pods are decoded into the whole model (`models/apiobjects.py`).
"""

from __future__ import annotations

import logging
import threading
import time
from datetime import datetime, timezone
from typing import Optional

from kubernetes_tpu_torch.client.cache import Informer
from kubernetes_tpu_torch.models import serde
from kubernetes_tpu_torch.models.apiobjects import POD_GROUP_LABEL, Pod, PodGroup
from kubernetes_tpu_torch.client.rest import APIError
from kubernetes_tpu_torch.utils import metrics

_LOG = logging.getLogger("kubernetes_tpu_torch.controllers.gangs")

_SYNCS = metrics.DEFAULT.counter(
    "gang_controller_syncs_total", "PodGroup sync passes", ("result",)
)
#: Groups currently Pending/Unschedulable, refreshed every sync — the
#: backlog-depth signal dashboards watch for gang starvation.
_PENDING = metrics.DEFAULT.gauge(
    "gang_pending_groups", "PodGroups currently Pending"
)

PENDING = "Pending"
SCHEDULED = "Scheduled"
UNSCHEDULABLE = "Unschedulable"


def _decode_group(wire: dict) -> PodGroup:
    return serde.from_wire(PodGroup, wire)


def _decode_pod(wire: dict) -> Pod:
    return serde.from_wire(Pod, wire)


def _parse_ts(ts: str) -> Optional[float]:
    if not ts:
        return None
    try:
        return (
            datetime.strptime(ts, "%Y-%m-%dT%H:%M:%SZ")
            .replace(tzinfo=timezone.utc)
            .timestamp()
        )
    except ValueError:
        return None


class GangController:
    def __init__(self, client, sync_period: float = 1.0, pods_informer=None):
        self.client = client
        self.sync_period = sync_period
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Informer-fed caches: the RUNNING controller reads groups and
        # member pods from watch-fed stores instead of two cluster-wide
        # LISTs per sync period (at a 1s period over 50k pods the
        # repeated full fetch was the controller's whole API budget).
        # `pods_informer` SHARES another controller's typed pods
        # informer (the manager passes ReplicationManager's) — a
        # controller-manager process must not run three independent
        # all-pods watches each decoding every event. A direct
        # sync_once() without start() (tests, one-shot reconciles)
        # falls back to read-through LISTs.
        self.podgroups = None
        self.pods = pods_informer
        self._owns_pods = pods_informer is None

    def start(self) -> "GangController":
        self.podgroups = Informer(
            self.client, "podgroups", decode=_decode_group,
        ).start()
        if self.pods is None:
            self.pods = Informer(
                self.client, "pods", decode=_decode_pod,
            ).start()
            self.pods.wait_for_sync()
        self.podgroups.wait_for_sync()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self.podgroups is not None:
            self.podgroups.stop()
        if self.pods is not None and self._owns_pods:
            self.pods.stop()  # a shared informer is its owner's to stop
        if self._thread:
            self._thread.join(timeout=3)

    def _list_groups(self) -> list:
        if self.podgroups is not None:
            return self.podgroups.store.list()
        # The client types podgroups and pods with the trimmed scheduler
        # model: read the wire form and decode it into the whole one.
        return [_decode_group(w) for w in self.client.list_wire("podgroups")[0]]

    def _list_pods(self) -> list:
        if self.pods is not None:
            return self.pods.store.list()
        return [_decode_pod(w) for w in self.client.list_wire("pods")[0]]

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.sync_once()
                _SYNCS.inc(result="ok")
            except Exception:
                _LOG.exception("gang controller sync pass failed")
                _SYNCS.inc(result="error")
            self._stop.wait(self.sync_period)

    def sync_once(self, now: Optional[float] = None) -> int:
        """One reconcile pass over every PodGroup; returns groups whose
        status changed. `now` is injectable for aging tests."""
        from kubernetes_tpu_torch.scheduler.gang import OUTCOMES, pod_is_live

        now = time.time() if now is None else now
        changed = 0
        pending = 0
        groups = self._list_groups()
        if not groups:
            _PENDING.set(0)
            return 0
        # ONE pass over the pod cache per sync, bucketed host-side: a
        # per-group label-selected LIST is a full server-side scan of
        # the namespace's pods EACH (api.list predicate-filters the
        # whole collection), which at the 50k-pod target and G groups
        # costs G full scans per second at steady state. With the
        # informer started this doesn't even leave the process.
        by_group: dict = {}
        for p in self._list_pods():
            g = (p.metadata.labels or {}).get(POD_GROUP_LABEL, "")
            if g:
                by_group.setdefault(
                    (p.metadata.namespace or "default", g), []
                ).append(p)
        for pg in groups:
            ns = pg.metadata.namespace or "default"
            name = pg.metadata.name
            labeled = by_group.get((ns, name), [])
            # Live members only (same rule as admission and the solve's
            # bound credit): a crashed member keeps label + nodeName but
            # satisfies nothing — counting it would pin a dead gang
            # "Scheduled" forever and mute GangTimeout.
            members = [p for p in labeled if pod_is_live(p)]
            bound = sum(1 for p in members if p.spec.node_name)
            phase = pg.status.phase or PENDING
            message = pg.status.message
            # The current Pending stint's start: aging runs against
            # THIS, not creationTimestamp — a gang that re-pends after
            # running gets a full fresh timeout window.
            pending_since = (
                pg.status.pending_since or pg.metadata.creation_timestamp
            )
            if bound >= pg.spec.min_member:
                if phase != SCHEDULED:
                    phase = SCHEDULED
                    message = (
                        f"{bound}/{pg.spec.min_member} minMember pods bound"
                    )
                    self._event(
                        pg, "GangScheduled",
                        f'pod group "{ns}/{name}" fully bound '
                        f"({bound} members)",
                    )
            elif phase == SCHEDULED:
                # A bound gang lost members (deletes/evictions) below
                # minMember: it is pending again and ages from now.
                phase = PENDING
                message = f"bound fell to {bound}/{pg.spec.min_member}"
                pending_since = time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ", time.gmtime(now)
                )
            elif phase == PENDING and pg.spec.schedule_timeout_seconds > 0:
                since = _parse_ts(pending_since)
                if (
                    since is not None
                    and now - since > pg.spec.schedule_timeout_seconds
                ):
                    phase = UNSCHEDULABLE
                    message = (
                        f"still {bound}/{pg.spec.min_member} bound after "
                        f"{pg.spec.schedule_timeout_seconds}s; member pods "
                        "remain queued and will gang-bind if capacity frees"
                    )
                    OUTCOMES.inc(outcome="timeout")
                    self._event(
                        pg, "GangTimeout",
                        f'pod group "{ns}/{name}" unschedulable: {message}',
                    )
            if phase in (PENDING, UNSCHEDULABLE):
                pending += 1
            if (
                phase == pg.status.phase
                and bound == pg.status.bound
                and len(members) == pg.status.members
                and pending_since == (
                    pg.status.pending_since
                    or pg.metadata.creation_timestamp
                )
            ):
                continue  # unchanged: skip the write, don't wake watchers
            try:
                self.client.update_status(
                    "podgroups",
                    {
                        "kind": "PodGroup",
                        "metadata": {"name": name, "namespace": ns},
                        "status": {
                            "phase": phase,
                            "members": len(members),
                            "bound": bound,
                            "message": message,
                            "pendingSince": pending_since,
                        },
                    },
                    namespace=ns,
                )
                changed += 1
            except APIError:
                pass  # deleted mid-sync / racing writer: next pass fixes
        _PENDING.set(pending)
        return changed

    def _event(self, pg, reason: str, message: str) -> None:
        try:
            self.client.record_event(
                pg, reason, message,
                source="gang-controller",
                namespace=pg.metadata.namespace or "default",
            )
        except Exception:  # ktlint: disable=KT003
            pass  # events are observability, never control flow
