"""NodeLifecycleController: detect dead nodes, evict their pods.

Reference: pkg/cloudprovider/nodecontroller/nodecontroller.go:186-341 —
monitor NodeStatus heartbeats; after a grace period mark the node
NotReady (ConditionUnknown in the reference); evict its pods after the
eviction timeout so the replication controller can recreate them
elsewhere. Eviction is rate-limited.

The port's copy of `kubernetes_tpu/controllers/nodelifecycle.py`. Nodes
and pods are decoded into the whole model (`models/apiobjects.py`), so
the NotReady status write keeps every field of the stored node.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

from kubernetes_tpu_torch.client.cache import Informer
from kubernetes_tpu_torch.models import serde
from kubernetes_tpu_torch.models.apiobjects import Node, Pod, now_iso
from kubernetes_tpu_torch.client.rest import APIError
from kubernetes_tpu_torch.utils.ratelimit import TokenBucket

_LOG = logging.getLogger("kubernetes_tpu_torch.controllers.nodelifecycle")


def _decode_node(wire: dict) -> Node:
    return serde.from_wire(Node, wire)


def _decode_pod(wire: dict) -> Pod:
    return serde.from_wire(Pod, wire)


class NodeLifecycleController:
    def __init__(
        self,
        client,
        monitor_period: float = 2.0,
        # Reference defaults, deliberately: --node-monitor-grace-period
        # defaults to 40s ("must be N times more than the kubelet's
        # status update frequency") and --pod-eviction-timeout to 5min
        # (cmd/kube-controller-manager/app/controllermanager.go:106,140).
        # Round 4 originally shipped 8s/4s — 5x/75x tighter — and at
        # 100 kubelets a heartbeat delayed by the pod-creation burst
        # read as node death, so mass eviction landed exactly when the
        # control plane was busiest and the recreate/rebind storm fed
        # itself. Failure-drill tests pass short values explicitly.
        grace_period: float = 40.0,
        eviction_timeout: float = 120.0,
        eviction_qps: float = 10.0,
    ):
        self.client = client
        self.monitor_period = monitor_period
        self.grace_period = grace_period
        self.eviction_timeout = eviction_timeout
        self.eviction_limiter = TokenBucket(eviction_qps, burst=20)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # node -> monotonic time of last observed heartbeat change.
        self._last_seen: Dict[str, float] = {}
        self._last_heartbeat: Dict[str, str] = {}
        self._not_ready_since: Dict[str, float] = {}
        self.nodes = Informer(client, "nodes", decode=_decode_node)
        self.pods = Informer(client, "pods", decode=_decode_pod)

    def start(self) -> "NodeLifecycleController":
        self.nodes.start()
        self.pods.start()
        self.nodes.wait_for_sync()
        self.pods.wait_for_sync()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.nodes.stop()
        self.pods.stop()
        if self._thread:
            self._thread.join(timeout=3)

    def _loop(self) -> None:
        while not self._stop.wait(self.monitor_period):
            try:
                self.monitor()
            except Exception:
                _LOG.exception("node lifecycle monitor pass failed")

    # -- monitoring ---------------------------------------------------

    @staticmethod
    def _heartbeat_of(node: Node) -> str:
        for c in node.status.conditions:
            if c.type == "Ready":
                return c.last_heartbeat_time
        return ""

    @staticmethod
    def _is_ready(node: Node) -> bool:
        for c in node.status.conditions:
            if c.type == "Ready":
                return c.status == "True"
        return False

    def monitor(self) -> None:
        now = time.monotonic()
        for node in self.nodes.store.list():
            name = node.metadata.name
            hb = self._heartbeat_of(node)
            if self._last_heartbeat.get(name) != hb:
                self._last_heartbeat[name] = hb
                self._last_seen[name] = now
                continue
            last = self._last_seen.setdefault(name, now)
            if now - last < self.grace_period:
                continue
            # Heartbeat stale past the grace period.
            if self._is_ready(node):
                self._mark_not_ready(node)
            since = self._not_ready_since.setdefault(name, now)
            if now - since >= self.eviction_timeout:
                self._evict_pods(name)
        # Reset eviction clocks for nodes that recovered.
        for node in self.nodes.store.list():
            name = node.metadata.name
            if self._is_ready(node) and (
                time.monotonic() - self._last_seen.get(name, 0)
                < self.grace_period
            ):
                self._not_ready_since.pop(name, None)

    def _mark_not_ready(self, node: Node) -> None:
        for c in node.status.conditions:
            if c.type == "Ready":
                c.status = "Unknown"
                c.reason = "NodeStatusUnknown"
                c.message = "Kubelet stopped posting node status"
                c.last_transition_time = now_iso()
        try:
            self.client.update_status("nodes", node)
            self.client.record_event(
                node, "NodeNotReady", f"Node {node.metadata.name} stopped heartbeating",
                source="node-controller",
            )
        except APIError:
            pass

    def _evict_pods(self, node_name: str) -> None:
        """deletePods (nodecontroller.go:341): remove pods so the RC
        manager recreates them on live nodes."""
        for pod in self.pods.store.list():
            if pod.spec.node_name != node_name:
                continue
            if not self.eviction_limiter.try_accept():
                return  # rate limited: resume next tick
            try:
                self.client.delete(
                    "pods", pod.metadata.name,
                    namespace=pod.metadata.namespace or "default",
                )
                self.client.record_event(
                    pod, "NodeControllerEviction",
                    f"Deleting pod from unresponsive node {node_name}",
                    source="node-controller",
                )
            except APIError:
                pass
