"""EndpointsController: joins services and ready pods into Endpoints.

Reference: pkg/service/endpoints_controller.go:59,255 — for each
service, list pods matching its selector, keep the ready ones with pod
IPs, and write an Endpoints object mirroring the service's ports.

The port's copy of `kubernetes_tpu/controllers/endpoints.py`. Pods,
services and the Endpoints read back are decoded into the whole model
(`models/apiobjects.py`): the client types pods and endpoints with the
trimmed scheduler model, which has no pod IP, conditions or ports.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional

from kubernetes_tpu_torch.client.cache import Informer
from kubernetes_tpu_torch.models import labels as labelpkg
from kubernetes_tpu_torch.models import serde
from kubernetes_tpu_torch.models.apiobjects import (
    EndpointAddress,
    EndpointPort,
    Endpoints,
    EndpointSubset,
    Pod,
    Service,
)
from kubernetes_tpu_torch.client.rest import APIError

_LOG = logging.getLogger("kubernetes_tpu_torch.controllers.endpoints")


def _decode_pod(wire: dict) -> Pod:
    return serde.from_wire(Pod, wire)


def _decode_service(wire: dict) -> Service:
    return serde.from_wire(Service, wire)


def _pod_ready(pod: Pod) -> bool:
    if pod.status.phase != "Running" or not pod.status.pod_ip:
        return False
    for c in pod.status.conditions:
        if c.type == "Ready":
            return c.status == "True"
    return False


class EndpointsController:
    def __init__(self, client, sync_period: float = 3.0):
        self.client = client
        self.sync_period = sync_period
        self._dirty = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        mark = lambda o: self._dirty.set()  # noqa: E731
        self.services = Informer(
            client, "services", decode=_decode_service,
            on_add=mark, on_update=mark, on_delete=mark,
        )
        self.pods = Informer(
            client, "pods", decode=_decode_pod,
            on_add=mark, on_update=mark, on_delete=mark,
        )
        # Endpoints cache for orphan GC: the per-sync full LIST of
        # endpoints was the controller's remaining steady-state read
        # against the API plane (wire dicts are enough — GC only needs
        # keys).
        self.endpoints = Informer(client, "endpoints")

    def start(self) -> "EndpointsController":
        self.services.start()
        self.pods.start()
        self.endpoints.start()
        self.services.wait_for_sync()
        self.pods.wait_for_sync()
        self.endpoints.wait_for_sync()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._dirty.set()
        self.services.stop()
        self.pods.stop()
        self.endpoints.stop()
        if self._thread:
            self._thread.join(timeout=3)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._dirty.wait(timeout=self.sync_period)
            self._dirty.clear()
            if self._stop.is_set():
                return
            try:
                self.sync_all()
            except Exception:
                _LOG.exception("endpoints sync pass failed")

    def sync_all(self) -> None:
        services = self.services.store.list()
        for svc in services:
            try:
                self.sync_service(svc)
            except Exception:
                _LOG.exception(
                    "endpoints sync for service %s/%s failed",
                    svc.metadata.namespace, svc.metadata.name,
                )
        self._gc_orphans(services)

    def _gc_orphans(self, services: List[Service]) -> None:
        """Endpoints whose service is gone are garbage-collected
        (reference: endpoints_controller.go removes them)."""
        live = {f"{s.metadata.namespace}/{s.metadata.name}" for s in services}
        # Informer-fed: no per-sync endpoints LIST. The undecoded cache
        # mixes typed objects (reflector list) and wire dicts (watch
        # events); GC only needs the key, so read both shapes.
        for ep in self.endpoints.store.list():
            if isinstance(ep, dict):
                meta = ep.get("metadata", {})
                ns = meta.get("namespace", "")
                name = meta.get("name", "")
            else:
                ns, name = ep.metadata.namespace, ep.metadata.name
            if f"{ns}/{name}" not in live:
                try:
                    self.client.delete(
                        "endpoints", name, namespace=ns or "default"
                    )
                except APIError:
                    pass

    @staticmethod
    def _resolve_target_port(service_port, pod: Pod) -> int:
        """findPort (reference: pkg/util/findPort as used by the
        endpoints controller): int targetPort used directly; named
        targetPort resolved against the pod's container ports; empty
        falls back to the service port."""
        tp = service_port.target_port
        if isinstance(tp, int) and tp:
            return tp
        if isinstance(tp, str) and tp:
            for c in pod.spec.containers:
                for p in c.ports:
                    if p.name == tp:
                        return p.container_port
        return service_port.port

    def sync_service(self, svc: Service) -> None:
        if not svc.spec.selector:
            return  # headless/external services manage their own endpoints
        sel = labelpkg.selector_from_set(svc.spec.selector)
        # Named targetPorts resolve PER POD (two pods can expose the
        # same port name on different container ports), so addresses
        # group by their resolved port tuple — one subset per distinct
        # tuple, the reference's endpoints.RepackSubsets shape
        # (endpoints_controller.go:255 + pkg/api/endpoints/util.go).
        groups: dict = {}
        for pod in self.pods.store.list():
            if pod.metadata.namespace != svc.metadata.namespace:
                continue
            if not sel.matches(pod.metadata.labels):
                continue
            if not _pod_ready(pod):
                continue
            ports = tuple(
                (p.name, self._resolve_target_port(p, pod), p.protocol)
                for p in svc.spec.ports
            )
            groups.setdefault(ports, []).append(
                EndpointAddress(
                    ip=pod.status.pod_ip,
                    target_ref={
                        "kind": "Pod",
                        "name": pod.metadata.name,
                        "namespace": pod.metadata.namespace,
                        "uid": pod.metadata.uid,
                    },
                )
            )
        subsets = []
        for ports, addresses in sorted(groups.items()):
            addresses.sort(key=lambda a: (a.ip, (a.target_ref or {}).get("uid", "")))
            subsets.append(
                EndpointSubset(
                    addresses=addresses,
                    ports=[
                        EndpointPort(name=n, port=num, protocol=proto)
                        for (n, num, proto) in ports
                    ],
                )
            )
        ep = Endpoints()
        ep.metadata.name = svc.metadata.name
        ep.metadata.namespace = svc.metadata.namespace
        ep.subsets = subsets
        ns = svc.metadata.namespace or "default"
        try:
            current = serde.from_wire(
                Endpoints,
                self.client.get_wire("endpoints", svc.metadata.name, namespace=ns),
            )
            if serde.to_wire(current.subsets) == serde.to_wire(ep.subsets):
                return  # no change
            current.subsets = ep.subsets
            self.client.update("endpoints", current, namespace=ns)
        except APIError as e:
            if e.code == 404:
                try:
                    self.client.create("endpoints", ep, namespace=ns)
                except APIError:
                    pass
