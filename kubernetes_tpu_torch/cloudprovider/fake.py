"""Fake cloud provider for tests.

Reference: pkg/cloudprovider/fake/fake.go — fully configurable
instances/zones/routes plus a call log so controllers can be tested
against deterministic cloud state.

The port's copy of `kubernetes_tpu/cloudprovider/fake.py`, registered
as `fake`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from kubernetes_tpu_torch.cloudprovider.interface import (
    CloudProvider,
    Instance,
    LoadBalancerStub,
    Route,
    Zone,
    register_provider,
)


class FakeCloudProvider(CloudProvider):
    name = "fake"

    def __init__(
        self,
        instances: Optional[List[Instance]] = None,
        zones: Optional[Dict[str, Zone]] = None,
        routes: Optional[List[Route]] = None,
    ):
        self._instances = instances if instances is not None else []
        self._zones = zones or {}
        self._routes = routes if routes is not None else []
        self._lb = LoadBalancerStub()
        self.calls: List[str] = []

    def instances(self) -> Optional[List[Instance]]:
        self.calls.append("instances")
        return list(self._instances)

    def zone_of(self, instance_name: str) -> Optional[Zone]:
        self.calls.append(f"zone_of:{instance_name}")
        return self._zones.get(instance_name)

    def routes(self) -> Optional[List[Route]]:
        self.calls.append("routes")
        return list(self._routes)

    def create_route(
        self, name: str, target_instance: str, destination_cidr: str
    ) -> None:
        self.calls.append(f"create_route:{name}")
        self._routes = [r for r in self._routes if r.name != name]
        self._routes.append(
            Route(
                name=name,
                target_instance=target_instance,
                destination_cidr=destination_cidr,
            )
        )

    def delete_route(self, name: str) -> None:
        self.calls.append(f"delete_route:{name}")
        self._routes = [r for r in self._routes if r.name != name]

    def load_balancer(self) -> Optional[LoadBalancerStub]:
        return self._lb

    def cluster_names(self) -> List[str]:
        return ["fake-cluster"]

    # test helpers
    def set_instances(self, instances: List[Instance]) -> None:
        self._instances = list(instances)


register_provider("fake", FakeCloudProvider)
