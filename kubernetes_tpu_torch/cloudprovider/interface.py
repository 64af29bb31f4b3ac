"""Cloud provider interface + registry.

Reference: pkg/cloudprovider/cloud.go (Interface, Instances, Zones,
Routes, TCPLoadBalancer, Clusters) and plugins.go (RegisterCloudProvider
/ GetCloudProvider).

The port's copy of `kubernetes_tpu/cloudprovider/interface.py`: the same
dataclasses, the load-balancer stub, the provider base class and the
registry (an unknown name raises the same `KeyError`). Host code: it
loads neither torch nor numpy.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional


@dataclass(frozen=True)
class Instance:
    """One schedulable machine (reference: Instances.List/NodeAddresses).
    For the TPU provider an instance is a TPU HOST (the unit that runs
    a kubelet), not a chip."""

    name: str
    addresses: tuple = ()  # (ip, ...)
    instance_type: str = ""
    instance_id: str = ""
    labels: tuple = ()  # ((k, v), ...) — hashable

    def labels_dict(self) -> Dict[str, str]:
        return dict(self.labels)


@dataclass(frozen=True)
class Zone:
    """Failure/locality domain (reference: Zones.GetZone). TPU analog:
    one slice (or one host's coordinates within it)."""

    failure_domain: str
    region: str


@dataclass(frozen=True)
class Route:
    """Inter-instance connectivity (reference: Routes). TPU analog: an
    ICI link between neighboring hosts."""

    name: str
    target_instance: str
    destination_cidr: str = ""


class LoadBalancerStub:
    """TCP load balancer surface (reference: TCPLoadBalancer). Cloud
    LBs don't exist on the fabric; providers may override with
    something real (the fake records calls for tests)."""

    def __init__(self):
        self.balancers: Dict[str, List[str]] = {}

    def ensure(self, name: str, hosts: List[str]) -> str:
        self.balancers[name] = list(hosts)
        return self.address(name)

    def address(self, name: str) -> str:
        """Ingress address of an already-provisioned balancer."""
        return f"lb-{name}"

    def update_hosts(self, name: str, hosts: List[str]) -> None:
        if name in self.balancers:
            self.balancers[name] = list(hosts)

    def delete(self, name: str) -> None:
        self.balancers.pop(name, None)


class CloudProvider:
    """The provider interface. Capability getters return None when
    unsupported, mirroring the reference's (iface, bool) returns."""

    name: str = ""

    def instances(self) -> Optional[List[Instance]]:
        return None

    def zone_of(self, instance_name: str) -> Optional[Zone]:
        return None

    def routes(self) -> Optional[List[Route]]:
        return None

    def create_route(
        self, name: str, target_instance: str, destination_cidr: str
    ) -> None:
        """Program one route (reference: Routes.CreateRoute). Providers
        without a mutable route table raise."""
        raise NotImplementedError(f"{self.name}: routes are read-only")

    def delete_route(self, name: str) -> None:
        raise NotImplementedError(f"{self.name}: routes are read-only")

    def load_balancer(self) -> Optional[LoadBalancerStub]:
        return None

    def cluster_names(self) -> List[str]:
        return []


_lock = threading.Lock()
_providers: Dict[str, Callable[[], CloudProvider]] = {}


def register_provider(name: str, factory: Callable[[], CloudProvider]) -> None:
    with _lock:
        _providers[name] = factory


def get_provider(name: str) -> CloudProvider:
    with _lock:
        if name not in _providers:
            raise KeyError(
                f"cloud provider {name!r} not registered "
                f"(have: {sorted(_providers)})"
            )
        return _providers[name]()
