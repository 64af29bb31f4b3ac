"""Cluster-level log aggregation addon.

Reference: cluster/addons/fluentd-elasticsearch — a per-node fluentd
tails every container's logs into Elasticsearch so operators can
search across the whole cluster (including pods that have since been
restarted or deleted). Here the aggregator rides the stack's own
surfaces instead of host-path tailing: a pod informer discovers
running containers, and each poll pulls fresh lines through the
apiserver's pod-log subresource (which relays to the owning kubelet)
— the same route `ktctl logs` takes, so whatever runtime backs the
kubelet is automatically covered.

Retention is a bounded global ring: entries survive their pod's
deletion until capacity evicts them (the ES-index analog, sized for a
dev cluster not a datacenter).

The port's copy of `kubernetes_tpu/addons/logging.py`. Pods are decoded
into the whole model (`models/apiobjects.py`); the lines come through
the port client's `pod_logs`.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.client.cache import Informer
from kubernetes_tpu_torch.client.rest import APIError
from kubernetes_tpu_torch.models import serde
from kubernetes_tpu_torch.models.apiobjects import Pod


@dataclass
class LogEntry:
    namespace: str
    pod: str
    container: str
    line: str


class ClusterLogAggregator:
    """Poll-based cluster log collector with substring search."""

    def __init__(self, client, poll_interval: float = 1.0, capacity: int = 100_000):
        self.client = client
        self.poll_interval = poll_interval
        self._entries: deque = deque(maxlen=capacity)
        # (ns, pod, container) -> number of lines already ingested.
        self._offsets: Dict[Tuple[str, str, str], int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.pods = Informer(
            client, "pods", decode=lambda w: serde.from_wire(Pod, w)
        )

    def start(self) -> "ClusterLogAggregator":
        self.pods.start()
        self.pods.wait_for_sync()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.pods.stop()
        if self._thread:
            self._thread.join(timeout=3)

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.collect_once()
            except Exception:
                pass  # crash containment, like every other loop

    def collect_once(self) -> int:
        """One sweep over running pods; returns lines ingested."""
        ingested = 0
        live_keys = set()
        for pod in self.pods.store.list():
            if pod.status.phase not in ("Running", "Succeeded", "Failed"):
                continue
            if not pod.spec.node_name:
                continue
            ns = pod.metadata.namespace or "default"
            for c in pod.spec.containers:
                key = (ns, pod.metadata.name, c.name)
                live_keys.add(key)
                try:
                    text = self.client.pod_logs(
                        pod.metadata.name, namespace=ns, container=c.name
                    )
                except APIError:
                    continue  # kubelet not serving this pod's logs yet
                except Exception:
                    continue  # transport hiccup; retry next sweep
                lines = text.splitlines()
                if text and not text.endswith("\n") and lines:
                    # Trailing unterminated fragment: leave it for the
                    # sweep after its newline arrives — counting it now
                    # would pin the offset past the completed line.
                    lines = lines[:-1]
                seen = self._offsets.get(key, 0)
                if len(lines) < seen:
                    seen = 0  # log rotated/truncated: re-ingest
                fresh = lines[seen:]
                if not fresh:
                    continue
                with self._lock:
                    for line in fresh:
                        self._entries.append(
                            LogEntry(ns, pod.metadata.name, c.name, line)
                        )
                self._offsets[key] = len(lines)
                ingested += len(fresh)
        # Deleted pods keep their RING entries (retention is the whole
        # point) but not their offset bookkeeping — under churn the
        # offsets dict would otherwise grow one key per ever-seen pod.
        for key in list(self._offsets):
            if key not in live_keys:
                del self._offsets[key]
        return ingested

    def search(
        self,
        substring: str = "",
        namespace: Optional[str] = None,
        pod: Optional[str] = None,
        limit: int = 1000,
    ) -> List[LogEntry]:
        """Newest-last substring search across every collected line —
        the Kibana-query analog."""
        out: List[LogEntry] = []
        with self._lock:
            for e in self._entries:
                if substring and substring not in e.line:
                    continue
                if namespace is not None and e.namespace != namespace:
                    continue
                if pod is not None and e.pod != pod:
                    continue
                out.append(e)
        return out[-limit:]
