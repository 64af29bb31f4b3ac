"""NamespaceManager: two-phase namespace deletion.

Reference: pkg/namespace/namespace_controller.go — when a namespace
enters Terminating (deletionTimestamp set by the registry while
spec.finalizers is non-empty), purge all namespaced content, clear the
'kubernetes' finalizer via the finalize subresource, then delete the
now-finalizer-free namespace for real.

The port's copy of `kubernetes_tpu/controllers/namespace.py`.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional

from kubernetes_tpu_torch.client.rest import APIError
from kubernetes_tpu_torch.utils import metrics

# Content purged on namespace termination (reference
# namespace_controller.go deleteAllContent; extended to every
# namespaced resource this framework serves).
_NAMESPACED_RESOURCES = [
    "pods",
    "replicationcontrollers",
    "services",
    "endpoints",
    "secrets",
    "serviceaccounts",
    "limitranges",
    "resourcequotas",
    "persistentvolumeclaims",
    "podtemplates",
    "events",
]

_LOG = logging.getLogger("kubernetes_tpu_torch.controllers.namespace")

_SYNCS = metrics.DEFAULT.counter(
    "namespace_controller_syncs_total", "namespace sync passes", ("result",)
)


class NamespaceManager:
    def __init__(self, client, sync_period: float = 1.0):
        self.client = client
        self.sync_period = sync_period
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "NamespaceManager":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=3)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.sync_once()
            except Exception:
                _LOG.exception("namespace lifecycle sync pass failed")
                _SYNCS.inc(result="error")
            self._stop.wait(self.sync_period)

    def sync_once(self) -> int:
        """One pass over all namespaces; returns count finalized (a
        namespace still held by a foreign finalizer doesn't count)."""
        done = 0
        namespaces, _ = self.client.list("namespaces")
        for ns in namespaces:
            if ns.status.phase != "Terminating":
                continue
            if self._terminate(ns.metadata.name, ns.spec.finalizers):
                done += 1
                _SYNCS.inc(result="terminated")
            else:
                _SYNCS.inc(result="blocked")
        return done

    def _terminate(self, name: str, finalizers: List[str]) -> bool:
        for resource in _NAMESPACED_RESOURCES:
            try:
                items, _ = self.client.list(resource, namespace=name)
            except APIError:
                continue
            for obj in items:
                try:
                    self.client.delete(
                        resource, obj.metadata.name, namespace=name
                    )
                except APIError:
                    pass  # already gone / racing deleter
        # Remove only OUR finalizer; foreign finalizers (guarding
        # external cleanup owned by other controllers) must stay until
        # their owners remove them (namespace_controller.go finalize).
        remaining = [f for f in finalizers if f != "kubernetes"]
        if remaining != list(finalizers):
            try:
                self.client.finalize_namespace(name, remaining)
            except APIError:
                return False
        if remaining:
            return False  # someone else's finalizer still pending
        try:
            self.client.delete("namespaces", name)
        except APIError:
            return False
        return True
