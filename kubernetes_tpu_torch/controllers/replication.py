"""ReplicationManager: keeps actual pod counts equal to RC replicas.

Reference: pkg/controller/replication_controller.go:98-384. The
expectation tracker prevents over-creation while watch events are in
flight (controller_utils.go RCExpectations): after issuing N creates we
wait to observe N adds before diffing again.

The port's copy of `kubernetes_tpu/controllers/replication.py`. RCs and
pods are decoded into the whole model (`models/apiobjects.py`), so a
created pod carries the template's whole spec; errors are the port
client's `APIError` (`client/rest.py`), which its transports raise for
an apiserver's error status.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from kubernetes_tpu_torch.client.cache import Informer
from kubernetes_tpu_torch.models import labels as labelpkg
from kubernetes_tpu_torch.models import serde
from kubernetes_tpu_torch.models.apiobjects import Pod, ReplicationController
from kubernetes_tpu_torch.client.rest import APIError
from kubernetes_tpu_torch.utils import metrics

_LOG = logging.getLogger("kubernetes_tpu_torch.controllers.replication")

_SYNCS = metrics.DEFAULT.counter(
    "replication_controller_syncs_total", "RC sync passes", ("result",)
)


def _decode_rc(wire: dict) -> ReplicationController:
    return serde.from_wire(ReplicationController, wire)


def _decode_pod(wire: dict) -> Pod:
    return serde.from_wire(Pod, wire)


class _Expectations:
    """Per-RC add/del expectations (controller_utils.go)."""

    TIMEOUT = 30.0

    def __init__(self):
        self._lock = threading.Lock()
        self._exp: Dict[str, tuple] = {}  # key -> (adds, dels, stamp)

    def expect(self, key: str, adds: int, dels: int) -> None:
        with self._lock:
            self._exp[key] = (adds, dels, time.monotonic())

    def observe_add(self, key: str) -> None:
        with self._lock:
            if key in self._exp:
                a, d, t = self._exp[key]
                self._exp[key] = (max(0, a - 1), d, t)

    def observe_del(self, key: str) -> None:
        with self._lock:
            if key in self._exp:
                a, d, t = self._exp[key]
                self._exp[key] = (a, max(0, d - 1), t)

    def satisfied(self, key: str) -> bool:
        with self._lock:
            if key not in self._exp:
                return True
            a, d, t = self._exp[key]
            if a <= 0 and d <= 0:
                return True
            if time.monotonic() - t > self.TIMEOUT:
                return True  # expectations expire; resync will fix drift
            return False


class ReplicationManager:
    BURST_REPLICAS = 500  # reference: 500 (replication_controller.go:64)

    def __init__(self, client, sync_period: float = 5.0):
        self.client = client
        self.sync_period = sync_period
        self.expectations = _Expectations()
        self._rc_key_cache: Dict[tuple, Optional[str]] = {}
        self._dirty = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.rcs = Informer(
            client, "replicationcontrollers", decode=_decode_rc,
            on_add=self._rc_changed,
            on_update=self._rc_changed,
            on_delete=self._rc_changed,
        )
        self.pods = Informer(
            client, "pods", decode=_decode_pod,
            on_add=self._pod_added,
            on_delete=self._pod_deleted,
        )

    # -- watch handlers ----------------------------------------------

    def _rc_changed(self, _rc) -> None:
        """RC add/update/delete: invalidate the pod->RC memo BEFORE
        waking the sync loop. The memo can hold a stale None computed
        before a new matching RC appeared — pod events for that RC
        would then skip expectation observation until the 30s
        expectations timeout (slow convergence). The
        per-round clear in sync_all still runs; this closes the gap
        between an RC appearing and the next round."""
        self._rc_key_cache.clear()
        self._dirty.set()

    def _rc_key_for_pod(self, pod: Pod) -> Optional[str]:
        # Memoized by (namespace, label signature): this runs on the
        # reflector thread for EVERY pod event, and rebuilding one
        # Selector per RC per event is O(RCs) selector constructions x
        # 30k events at scale. Pods from one template share a
        # signature; sync_all (and _rc_changed) clear the cache so RC
        # churn converges within a sync period.
        labels = pod.metadata.labels or {}
        sig = (pod.metadata.namespace, frozenset(labels.items()))
        cache = self._rc_key_cache
        if sig in cache:
            return cache[sig]
        out = None
        for rc in self.rcs.store.list():
            if rc.metadata.namespace != pod.metadata.namespace:
                continue
            sel = rc.spec.selector
            if sel and labelpkg.selector_from_set(sel).matches(labels):
                out = f"{rc.metadata.namespace}/{rc.metadata.name}"
                break
        if len(cache) > 4096:
            cache.clear()
        cache[sig] = out
        return out

    def _pod_added(self, pod: Pod) -> None:
        key = self._rc_key_for_pod(pod)
        if key:
            self.expectations.observe_add(key)
        self._dirty.set()

    def _pod_deleted(self, pod: Pod) -> None:
        key = self._rc_key_for_pod(pod)
        if key:
            self.expectations.observe_del(key)
        self._dirty.set()

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "ReplicationManager":
        self.rcs.start()
        self.pods.start()
        self.rcs.wait_for_sync()
        self.pods.wait_for_sync()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._dirty.set()
        self.rcs.stop()
        self.pods.stop()
        if self._thread:
            self._thread.join(timeout=3)
        pool = getattr(self, "_burst_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)
            self._burst_pool = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._dirty.wait(timeout=self.sync_period)
            self._dirty.clear()
            if self._stop.is_set():
                return
            try:
                self.sync_all()
            except Exception:
                _LOG.exception("replication sync pass failed")

    # -- reconciliation ----------------------------------------------

    def sync_all(self) -> None:
        # ONE pass over the pod cache, memoized by label signature:
        # per-RC re-listing is O(pods x RCs) per round (3M selector
        # matches at 30k pods x 100 RCs — the controller's whole core
        # share at 1000-node scale). Pods from one template share a
        # label signature, so distinct match computations ~ #templates.
        self._rc_key_cache.clear()  # RC set may have changed
        rcs = self.rcs.store.list()
        if not rcs:
            return
        rc_sels = [
            (rc, labelpkg.selector_from_set(rc.spec.selector or {}), [])
            for rc in rcs
        ]
        sig_hits: Dict[tuple, List[int]] = {}
        for p in self.pods.store.list():
            if p.status.phase in ("Succeeded", "Failed"):
                continue
            labels = p.metadata.labels or {}
            sig = (p.metadata.namespace, frozenset(labels.items()))
            hits = sig_hits.get(sig)
            if hits is None:
                hits = [
                    i
                    for i, (rc, sel, _m) in enumerate(rc_sels)
                    if rc.metadata.namespace == p.metadata.namespace
                    and not sel.empty()
                    and sel.matches(labels)
                ]
                sig_hits[sig] = hits
            for i in hits:
                rc_sels[i][2].append(p)
        # Per-RC error isolation: one broken RC must not starve the rest
        # (the reference syncs per queue key with individual handling).
        for rc, _sel, matched in rc_sels:
            try:
                self.sync_rc(rc, matched)
            except Exception:
                _LOG.exception(
                    "sync of replicationcontroller %s/%s failed",
                    rc.metadata.namespace, rc.metadata.name,
                )
                _SYNCS.inc(result="error")

    def _matching_pods(self, rc: ReplicationController) -> List[Pod]:
        sel = labelpkg.selector_from_set(rc.spec.selector)
        return [
            p
            for p in self.pods.store.list()
            if p.metadata.namespace == rc.metadata.namespace
            and sel.matches(p.metadata.labels)
            and p.status.phase not in ("Succeeded", "Failed")
        ]

    def sync_rc(
        self, rc: ReplicationController, pods: Optional[List[Pod]] = None
    ) -> None:
        """syncReplicationController (:351) + manageReplicas (:294).
        `pods` = this RC's active pods when the caller (sync_all)
        already computed them; None recomputes."""
        key = f"{rc.metadata.namespace}/{rc.metadata.name}"
        if not self.expectations.satisfied(key):
            return
        if pods is None:
            pods = self._matching_pods(rc)
        else:
            pods = list(pods)
        diff = len(pods) - rc.spec.replicas
        if diff < 0:
            count = min(-diff, self.BURST_REPLICAS)
            self.expectations.expect(key, adds=count, dels=0)
            # Concurrent burst, like the reference's per-create
            # goroutines (manageReplicas fires `go rm.createPods` for
            # the whole diff): a serial loop caps creation at
            # 1/apiserver-round-trip — under load at 1000 nodes that
            # was ~16 pods/s for a 30k-pod fan-out.
            for ok in self._pool().map(
                lambda _i: self._create_pod(rc), range(count)
            ):
                if not ok:
                    # Lower expectations by exactly the failed create so
                    # concurrent watch-observed adds still count
                    # (reference: rm.expectations.CreationObserved on
                    # failure, replication_controller.go:294+).
                    self.expectations.observe_add(key)
            _SYNCS.inc(result="scale_up")
        elif diff > 0:
            count = min(diff, self.BURST_REPLICAS)
            # Prefer killing unassigned/pending pods first (reference
            # sorts by activePods ordering).
            pods.sort(key=lambda p: (p.spec.node_name != "", p.status.phase == "Running"))
            victims = pods[:count]
            self.expectations.expect(key, adds=0, dels=len(victims))
            for p in victims:
                try:
                    self.client.delete(
                        "pods", p.metadata.name,
                        namespace=p.metadata.namespace or "default",
                    )
                except APIError:
                    self.expectations.observe_del(key)
            _SYNCS.inc(result="scale_down")
        else:
            _SYNCS.inc(result="in_sync")
        # Status writeback (:384) — guard on the value actually written,
        # else unchanged writes loop through the watch forever.
        if rc.status.replicas != len(pods):
            rc.status.replicas = len(pods)
            try:
                self.client.update_status(
                    "replicationcontrollers", rc,
                    namespace=rc.metadata.namespace or "default",
                )
            except APIError:
                pass

    def _pool(self):
        """Shared burst executor (the goroutine analog, bounded)."""
        if getattr(self, "_burst_pool", None) is None:
            from concurrent.futures import ThreadPoolExecutor

            self._burst_pool = ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="rc-burst"
            )
        return self._burst_pool

    def _create_pod(self, rc: ReplicationController) -> bool:
        tmpl = rc.spec.template
        if tmpl is None:
            return False
        pod = Pod()
        pod.metadata.generate_name = rc.metadata.name + "-"
        pod.metadata.namespace = rc.metadata.namespace or "default"
        pod.metadata.labels = dict(tmpl.metadata.labels or {})
        pod.spec = serde.from_wire(type(tmpl.spec), serde.to_wire(tmpl.spec))
        try:
            self.client.create("pods", pod, namespace=pod.metadata.namespace)
            return True
        except APIError:
            return False
