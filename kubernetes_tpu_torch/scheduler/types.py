"""Scheduler interfaces: predicate/priority signatures and listers.

Reference: plugin/pkg/scheduler/algorithm/{types.go,listers.go,
scheduler_interface.go}.

FitPredicate(pod, existing_pods_on_node, node_name) -> bool
PriorityFunction(pod, pod_lister, minion_lister) -> [HostPriority]

The port's copy of `kubernetes_tpu/scheduler/types.py`, line for line:
the scalar path of the full re-lower daemon (a policy that does not
lower to the card) and the yardstick the card's decisions are held to.
Pure Python; no torch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from kubernetes_tpu_torch.models import labels as labelpkg
from kubernetes_tpu_torch.models.objects import Node, Pod, Service

FitPredicate = Callable[[Pod, List[Pod], str], bool]


@dataclass
class HostPriority:
    host: str
    score: int


PriorityFunction = Callable[
    [Pod, "StaticPodLister", "StaticNodeLister"], List[HostPriority]
]


@dataclass
class PriorityConfig:
    function: PriorityFunction
    weight: int = 1


class StaticPodLister:
    """PodLister over a fixed list (reference: FakePodLister; the real
    one wraps an informer store — daemon.py builds those)."""

    def __init__(self, pods: Sequence[Pod]):
        self.pods = list(pods)

    def list(self, selector: Optional[labelpkg.Selector] = None) -> List[Pod]:
        if selector is None or selector.empty():
            return list(self.pods)
        return [p for p in self.pods if selector.matches(p.metadata.labels)]


class StaticNodeLister:
    """MinionLister (reference: FakeMinionLister)."""

    def __init__(self, nodes: Sequence[Node]):
        self.nodes = list(nodes)

    def list(self) -> List[Node]:
        return list(self.nodes)

    def get(self, name: str) -> Node:
        for n in self.nodes:
            if n.metadata.name == name:
                return n
        raise KeyError(f"node {name!r} not found")


class StaticServiceLister:
    """ServiceLister with GetPodServices (reference: listers.go)."""

    def __init__(self, services: Sequence[Service]):
        self.services = list(services)

    def list(self) -> List[Service]:
        return list(self.services)

    def get_pod_services(self, pod: Pod) -> List[Service]:
        out = []
        for svc in self.services:
            if svc.metadata.namespace != pod.metadata.namespace:
                continue
            sel = svc.spec.selector
            if not sel:
                continue
            if labelpkg.selector_from_set(sel).matches(pod.metadata.labels or {}):
                out.append(svc)
        return out


def map_pods_to_machines(pod_lister: StaticPodLister) -> Dict[str, List[Pod]]:
    """Pivot all pods into host -> pods, skipping terminal phases.

    Reference: MapPodsToMachines + filterNonRunningPods
    (predicates.go:361-392).
    """
    machine_to_pods: Dict[str, List[Pod]] = {}
    for pod in pod_lister.list():
        if pod.status.phase in ("Succeeded", "Failed"):
            continue
        machine_to_pods.setdefault(pod.spec.node_name, []).append(pod)
    return machine_to_pods
