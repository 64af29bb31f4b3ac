"""Card-machine provider: the host's CUDA cards ARE the cloud.

Reference seam: pkg/cloudprovider/gce/gce.go et al. discover VM
instances from a cloud API; here the equivalent inventory — hosts and
their cards — comes from torch's view of the machine.

The port's counterpart of `kubernetes_tpu/cloudprovider/tpu.py`, which
reads `jax.devices()`. With `devices=None` this provider reads
`torch.cuda`: one record a card, with `process_index` 0 (one process
sees one host's cards), `device_kind` the card's name
(`torch.cuda.get_device_name`), `platform` "gpu" and no `coords` (the
cards have no torus position). With no card it raises: nothing falls
back to an empty or a CPU inventory. Given `devices=` records (any
objects with those attributes), every method runs JAX's logic
unchanged: one INSTANCE a host, its cards' kind and count as instance
labels a nodeSelector can target, a zone a host within the cluster
(`slice_name`), a ring of base routes between hosts with managed
pod-CIDR routes on top, and a load-balancer stub.

Departures: hosts are named `gpu-host-N` (JAX: `tpu-host-N`); the
label keys are JAX's `LABEL_*` keys, so a nodeSelector written for the
JAX cluster selects the same nodes; the provider registers as `gpu`,
and `tpu` is not registered in the port (`--cloud-provider tpu` is an
unknown provider). Only the inventory read imports torch, and it opens
a CUDA context in the calling process: the controller-manager's
process loads torch only when it is given this provider (with no
provider, or `fake`, it loads neither torch nor numpy).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Optional

from kubernetes_tpu_torch.cloudprovider.interface import (
    CloudProvider,
    Instance,
    LoadBalancerStub,
    Route,
    Zone,
    register_provider,
)

# Node label keys: JAX's (the reference-era equivalents were
# failure-domain.beta.kubernetes.io/zone etc.).
LABEL_PLATFORM = "tpu.kubernetes-tpu.io/platform"
LABEL_CHIP = "tpu.kubernetes-tpu.io/chip"
LABEL_CHIPS = "tpu.kubernetes-tpu.io/chips-per-host"
LABEL_HOST = "tpu.kubernetes-tpu.io/host-index"
LABEL_COORDS = "tpu.kubernetes-tpu.io/coords"


def cuda_inventory() -> List[SimpleNamespace]:
    """One device record a CUDA card of this process; raises without one."""
    import torch

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("GPUCloudProvider: no CUDA card in this process to inventory")
    return [
        SimpleNamespace(process_index=0, device_kind=torch.cuda.get_device_name(i),
                        platform="gpu", coords=None)
        for i in range(count)
    ]


class GPUCloudProvider(CloudProvider):
    name = "gpu"

    def __init__(self, devices=None, slice_name: str = "slice-0"):
        if devices is None:
            devices = cuda_inventory()
        self.devices = list(devices)
        self.slice_name = slice_name
        # Managed routes (RouteController's pod-CIDR routes) layered on
        # top of the base host ring.
        self._managed_routes: Dict[str, Route] = {}
        # Ingress surface: portal rules at the cluster edge.
        self._lb = LoadBalancerStub()

    # -- host grouping ------------------------------------------------

    def _hosts(self) -> Dict[int, List]:
        hosts: Dict[int, List] = {}
        for d in self.devices:
            hosts.setdefault(int(getattr(d, "process_index", 0)), []).append(d)
        return hosts

    @staticmethod
    def _coords(device) -> Optional[tuple]:
        coords = getattr(device, "coords", None)
        return tuple(coords) if coords is not None else None

    def host_name(self, process_index: int) -> str:
        return f"gpu-host-{process_index}"

    # -- CloudProvider ------------------------------------------------

    def instances(self) -> List[Instance]:
        out = []
        hosts = self._hosts()
        for pid, devs in sorted(hosts.items()):
            kind = getattr(devs[0], "device_kind", "unknown")
            platform = getattr(devs[0], "platform", "gpu")
            coords = [c for c in (self._coords(d) for d in devs) if c]
            labels = {
                LABEL_PLATFORM: str(platform),
                LABEL_CHIP: str(kind).replace(" ", "-"),
                LABEL_CHIPS: str(len(devs)),
                LABEL_HOST: str(pid),
            }
            if coords:
                # Label-value safe encoding (no commas/semicolons pass
                # validation): coords dash-joined, devices dot-joined
                # -> "0-0-0.1-0-0".
                labels[LABEL_COORDS] = ".".join(
                    "-".join(str(x) for x in c) for c in sorted(coords)
                )
            out.append(
                Instance(
                    name=self.host_name(pid),
                    addresses=("127.0.0.1",) if len(hosts) == 1 else (),
                    instance_type=f"{platform}-{len(devs)}x-{str(kind).replace(' ', '-')}",
                    instance_id=f"{self.slice_name}/host-{pid}",
                    labels=tuple(sorted(labels.items())),
                )
            )
        return out

    def zone_of(self, instance_name: str) -> Optional[Zone]:
        for pid in self._hosts():
            if self.host_name(pid) == instance_name:
                return Zone(
                    failure_domain=f"{self.slice_name}/host-{pid}",
                    region=self.slice_name,
                )
        return None

    def _base_routes(self) -> List[Route]:
        """Connectivity between hosts, modeled as a ring over host
        indices, as JAX's provider models its ICI wraparound links."""
        hosts = sorted(self._hosts())
        if len(hosts) <= 1:
            return []
        out = []
        for i, pid in enumerate(hosts):
            nxt = hosts[(i + 1) % len(hosts)]
            out.append(
                Route(
                    name=f"ici-{pid}-{nxt}",
                    target_instance=self.host_name(nxt),
                    destination_cidr=f"host://{nxt}",
                )
            )
        return out

    def routes(self) -> List[Route]:
        return self._base_routes() + list(self._managed_routes.values())

    def create_route(
        self, name: str, target_instance: str, destination_cidr: str
    ) -> None:
        self._managed_routes[name] = Route(
            name=name,
            target_instance=target_instance,
            destination_cidr=destination_cidr,
        )

    def delete_route(self, name: str) -> None:
        self._managed_routes.pop(name, None)

    def load_balancer(self) -> LoadBalancerStub:
        return self._lb

    def cluster_names(self) -> List[str]:
        return [self.slice_name]


register_provider("gpu", GPUCloudProvider)
