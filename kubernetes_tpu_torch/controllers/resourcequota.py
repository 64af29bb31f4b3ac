"""ResourceQuotaManager: periodic full recalculation of quota usage.

Reference: pkg/resourcequota/resource_quota_manager.go — the admission
plugin keeps status.used current incrementally; this controller is the
level-triggered backstop that recomputes observed usage from scratch
every sync period and fixes any drift (missed deletes, direct store
writes, controller restarts).

The port's copy of `kubernetes_tpu/controllers/resourcequota.py`, over
the port's admission chain's `COUNTED_RESOURCES`.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

from kubernetes_tpu_torch.models.quantity import Quantity
from kubernetes_tpu_torch.server.admission import COUNTED_RESOURCES
from kubernetes_tpu_torch.client.rest import APIError
from kubernetes_tpu_torch.utils import metrics

_LOG = logging.getLogger("kubernetes_tpu_torch.controllers.resourcequota")

_SYNCS = metrics.DEFAULT.counter(
    "resource_quota_controller_syncs_total", "quota sync passes", ("result",)
)


class ResourceQuotaManager:
    def __init__(self, client, sync_period: float = 10.0):
        self.client = client
        self.sync_period = sync_period
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ResourceQuotaManager":
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
                _SYNCS.inc(result="ok")
            except Exception:
                _LOG.exception("resourcequota sync pass failed")
                _SYNCS.inc(result="error")
            self._stop.wait(self.sync_period)

    def sync_once(self) -> int:
        """Recompute status for every quota; returns quotas updated."""
        updated = 0
        quotas, _ = self.client.list("resourcequotas")
        for quota in quotas:
            hard = quota.spec.hard or {}
            if not hard:
                continue
            ns = quota.metadata.namespace
            used = self._compute_usage(ns, hard)
            old_used = {k: str(v) for k, v in (quota.status.used or {}).items()}
            if used == old_used:
                continue
            quota.status.hard = dict(hard)
            quota.status.used = {k: Quantity.from_string(v) for k, v in used.items()}
            try:
                self.client.update_status("resourcequotas", quota, namespace=ns)
                updated += 1
            except APIError:
                pass  # CAS loss; next period recomputes
        return updated

    def _compute_usage(self, namespace: str, hard) -> Dict[str, str]:
        used: Dict[str, str] = {}
        pods = None
        for key in hard:
            if key in COUNTED_RESOURCES:
                items, _ = self.client.list(key, namespace=namespace)
                used[key] = str(len(items))
            elif key in ("cpu", "memory"):
                if pods is None:
                    pods, _ = self.client.list("pods", namespace=namespace)
                total = 0
                for pod in pods:
                    for c in pod.spec.containers:
                        q = c.resources.limits.get(key) or c.resources.requests.get(
                            key
                        )
                        if q is not None:
                            total += q.milli_value()
                used[key] = str(Quantity.from_milli(total))
        return used
