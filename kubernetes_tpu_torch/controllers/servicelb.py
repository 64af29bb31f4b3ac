"""ServiceController: drives the cloud provider's load-balancer surface
for Services of type LoadBalancer.

Reference: pkg/cloudprovider/servicecontroller/servicecontroller.go —
watch services; for type=LoadBalancer ensure a provider LB pointing at
the cluster's (ready) hosts and publish the allocated ingress in
service.status; keep the host list in sync as nodes come and go; tear
the LB down when the service is deleted or changes type.

Here the provider's "load balancer" is an ingress at the cluster edge
(cloudprovider/gpu.py), but the control loop is provider-agnostic
through LoadBalancerStub.

The port's copy of `kubernetes_tpu/controllers/servicelb.py`. Services
and nodes are decoded into the whole model (`models/apiobjects.py`):
the client's trimmed model has no `status.loadBalancer`. The status
write sends the whole service and keeps the answer in wire form
(`Client.update_status_wire`).
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional

from kubernetes_tpu_torch.client.cache import Informer
from kubernetes_tpu_torch.client.rest import APIError
from kubernetes_tpu_torch.models import serde
from kubernetes_tpu_torch.models.apiobjects import Node, Service
from kubernetes_tpu_torch.utils import metrics

_LOG = logging.getLogger("kubernetes_tpu_torch.controllers.servicelb")

_SYNCS = metrics.DEFAULT.counter(
    "service_lb_syncs_total", "service LB sync outcomes", ("action",)
)


def _decode_service(wire: dict) -> Service:
    return serde.from_wire(Service, wire)


def _decode_node(wire: dict) -> Node:
    return serde.from_wire(Node, wire)


def _node_ready(node: Node) -> bool:
    for c in node.status.conditions:
        if c.type == "Ready":
            return c.status == "True"
    return False


class ServiceController:
    def __init__(self, client, provider, sync_period: float = 1.0):
        self.client = client
        self.lb = provider.load_balancer()
        self.sync_period = sync_period
        self._dirty = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        mark = lambda o: self._dirty.set()  # noqa: E731
        self.services = Informer(
            client, "services", decode=_decode_service,
            on_add=mark, on_update=mark, on_delete=mark,
        )
        self.nodes = Informer(
            client, "nodes", decode=_decode_node,
            on_add=mark, on_update=mark, on_delete=mark,
        )

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "ServiceController":
        if self.lb is None:
            raise ValueError("cloud provider has no load balancer surface")
        self.services.start()
        self.nodes.start()
        self.services.wait_for_sync()
        self.nodes.wait_for_sync()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._dirty.set()
        self.services.stop()
        self.nodes.stop()
        if self._thread:
            self._thread.join(timeout=2)

    # -- reconcile ----------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._dirty.wait(self.sync_period)
            self._dirty.clear()
            if self._stop.is_set():
                return
            try:
                self.sync()
                _SYNCS.inc(action="ok")
            except Exception:
                # Crash containment, but visibly: a permanently failing
                # reconcile must show up in /metrics.
                _LOG.exception("service LB sync pass failed")
                _SYNCS.inc(action="error")

    def _hosts(self) -> List[str]:
        return sorted(
            n.metadata.name
            for n in self.nodes.store.list()
            if _node_ready(n)
        )

    @staticmethod
    def _lb_name(svc: Service) -> str:
        """Unique, DNS-safe provider LB name. The namespace/name pair
        is disambiguated with a short hash: a plain '-' join collides
        ('team-a'/'api' vs 'team'/'a-api'), and the reference derives
        LB names from the service UID for the same reason."""
        import hashlib

        key = f"{svc.metadata.namespace or 'default'}/{svc.metadata.name}"
        suffix = hashlib.sha1(key.encode()).hexdigest()[:6]
        return f"{key.replace('/', '-')}-{suffix}"

    def _publish_status(self, svc: Service, ingress) -> None:
        """Write status.loadBalancer.ingress if it differs (copy first:
        the informer cache's object is shared — mutating it in place
        would make a FAILED status write look already-applied)."""
        import copy

        wanted = {"ingress": ingress} if ingress else {}
        current = (svc.status or {}).get("loadBalancer") or {}
        if current == wanted:
            return
        patched = copy.deepcopy(svc)
        patched.status = dict(patched.status or {})
        patched.status["loadBalancer"] = wanted
        try:
            self.client.update_status_wire(
                "services", serde.to_wire(patched),
                namespace=svc.metadata.namespace or "default",
            )
        except APIError:
            pass  # retried next tick (cache stays unmodified)

    def sync(self) -> None:
        hosts = self._hosts()
        wanted_names = set()
        for svc in self.services.store.list():
            if svc.spec.type != "LoadBalancer":
                # Type changed away from LoadBalancer: the provider LB
                # is collected below, and the published ingress must go
                # with it (a live-looking ingress pointing at a deleted
                # LB is worse than none).
                self._publish_status(svc, None)
                continue
            name = self._lb_name(svc)
            wanted_names.add(name)
            if name not in self.lb.balancers:
                ingress = self.lb.ensure(name, hosts)
            else:
                # Already provisioned: only reprogram on host drift
                # (a real provider call per service per tick is waste).
                if self.lb.balancers.get(name) != hosts:
                    self.lb.update_hosts(name, hosts)
                ingress = self.lb.address(name)
            self._publish_status(svc, [{"ip": ingress}])
        # Reconcile teardown against the PROVIDER's state, not an
        # in-memory map: a controller restart must still collect LBs
        # whose service vanished while it was down. This controller
        # owns the provider's whole LB surface (reference
        # servicecontroller owns cloud LBs matching its naming).
        for name in list(self.lb.balancers):
            if name not in wanted_names:
                self.lb.delete(name)
