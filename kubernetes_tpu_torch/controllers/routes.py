"""RouteController: reconciles provider routes against node podCIDRs.

Reference: pkg/cloudprovider/routecontroller/routecontroller.go — every
node with a spec.podCIDR gets a provider route sending that CIDR to the
node; routes whose node (or CIDR) is gone are deleted. The GPU
provider's base connectivity is its ring between hosts
(cloudprovider/gpu.py routes()); managed pod-CIDR routes layer on top.

The port's copy of `kubernetes_tpu/controllers/routes.py`. Nodes are
decoded into the whole model (`models/apiobjects.py`): the client's
trimmed model has no `spec.podCIDR`, and a route read through it would
look CIDR-less and be deleted.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from kubernetes_tpu_torch.client.cache import Informer
from kubernetes_tpu_torch.models import serde
from kubernetes_tpu_torch.models.apiobjects import Node
from kubernetes_tpu_torch.utils import metrics

_LOG = logging.getLogger("kubernetes_tpu_torch.controllers.routes")

_SYNCS = metrics.DEFAULT.counter(
    "route_syncs_total", "route sync outcomes", ("action",)
)


def _decode_node(wire: dict) -> Node:
    return serde.from_wire(Node, wire)


def route_name(node_name: str) -> str:
    return f"podcidr-{node_name}"


class RouteController:
    def __init__(self, client, provider, sync_period: float = 1.0):
        self.client = client
        self.provider = provider
        self.sync_period = sync_period
        self._dirty = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        mark = lambda o: self._dirty.set()  # noqa: E731
        self.nodes = Informer(
            client, "nodes", decode=_decode_node,
            on_add=mark, on_update=mark, on_delete=mark,
        )

    def start(self) -> "RouteController":
        if self.provider.routes() is None:
            raise ValueError("cloud provider has no routes surface")
        self.nodes.start()
        self.nodes.wait_for_sync()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._dirty.set()
        self.nodes.stop()
        if self._thread:
            self._thread.join(timeout=2)

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
                # Crash containment, but visibly (cloudnodes pattern).
                _LOG.exception("route sync pass failed")
                _SYNCS.inc(action="error")

    def sync(self) -> None:
        nodes = {n.metadata.name: n for n in self.nodes.store.list()}
        existing = {r.name: r for r in (self.provider.routes() or [])}
        # Ensure a route per node with a podCIDR.
        for name, node in nodes.items():
            cidr = node.spec.pod_cidr
            if not cidr:
                continue
            rname = route_name(name)
            cur = existing.get(rname)
            if cur is not None and cur.destination_cidr == cidr:
                continue
            if cur is not None:
                self.provider.delete_route(rname)  # CIDR moved
            self.provider.create_route(rname, name, cidr)
        # Delete managed routes whose node is gone. Only routes this
        # controller created (podcidr- prefix) are touched: the
        # provider's base routes (the host ring) are not ours.
        for rname, route in existing.items():
            if not rname.startswith("podcidr-"):
                continue
            node = nodes.get(route.target_instance)
            if node is None or not node.spec.pod_cidr:
                self.provider.delete_route(rname)
