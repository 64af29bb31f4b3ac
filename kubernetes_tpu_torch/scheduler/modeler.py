"""System modeler: the optimistic assumed-pod cache.

A copy of `kubernetes_tpu/scheduler/modeler.py` (reference:
plugin/pkg/scheduler/modeler.go). After a successful bind the scheduler
assumes the pod onto its node, so a binding counts against capacity
before the apiserver's watch confirms it (scheduler.go:142-157).
Assumptions live `ttl` seconds and are dropped early when the pod shows
up in the scheduled-pods cache (factory.go:91-114).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List

from kubernetes_tpu_torch.models.objects import Pod
from kubernetes_tpu_torch.utils import sanitizer


class SimpleModeler:
    def __init__(self, scheduled_pods: Callable[[], List[Pod]], ttl: float = 30.0):
        self._scheduled = scheduled_pods
        self._ttl = ttl
        self._lock = sanitizer.lock("scheduler.modeler")
        self._assumed: Dict[str, tuple] = {}  # key -> (pod, expiry)

    @staticmethod
    def _key(pod: Pod) -> str:
        return f"{pod.metadata.namespace}/{pod.metadata.name}"

    def assume_pod(self, pod: Pod) -> None:
        with self._lock:
            self._assumed[self._key(pod)] = (pod, time.monotonic() + self._ttl)

    def forget_pod(self, pod: Pod) -> None:
        with self._lock:
            self._assumed.pop(self._key(pod), None)

    def _live_assumed(self) -> List[Pod]:
        now = time.monotonic()
        with self._lock:
            self._assumed = {k: v for k, v in self._assumed.items() if v[1] > now}
            return [pod for pod, _ in self._assumed.values()]

    def pod_lister(self):
        """Merged lister: scheduled pods, then the live assumptions not
        yet visible as scheduled (modeler.go:134-179); with a label
        `selector`, the pods it matches (the scalar plugins' query)."""
        modeler = self

        class _Lister:
            def list(self, selector=None) -> List[Pod]:
                scheduled = modeler._scheduled()
                seen = {modeler._key(p) for p in scheduled}
                out = list(scheduled)
                for pod in modeler._live_assumed():
                    if modeler._key(pod) in seen:
                        modeler.forget_pod(pod)  # confirmed by the watch
                        continue
                    out.append(pod)
                if selector is not None and not selector.empty():
                    out = [p for p in out if selector.matches(p.metadata.labels)]
                return out

        return _Lister()
