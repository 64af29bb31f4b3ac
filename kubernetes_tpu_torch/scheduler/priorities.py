"""Scalar priority functions — exact reference semantics including
integer truncation.

Reference: plugin/pkg/scheduler/algorithm/priorities/{priorities.go,
spreading.go}. Scores are ints 0-10; weighted sums combine them
(generic_scheduler.go:151-166).

The port's copy of `kubernetes_tpu/scheduler/priorities.py`, line for
line: the scalar path of the full re-lower daemon (a policy that does
not lower to the card) and the yardstick the card's decisions are held
to. Pure Python; no torch.
"""

from __future__ import annotations

import math
from typing import Dict, List

from kubernetes_tpu_torch.models import labels as labelpkg
from kubernetes_tpu_torch.models.objects import Node, Pod, RESOURCE_CPU, RESOURCE_MEMORY
from kubernetes_tpu_torch.scheduler.types import (
    HostPriority,
    StaticNodeLister,
    StaticPodLister,
    map_pods_to_machines,
)


def _limits_total(pods: List[Pod], pod: Pod) -> tuple:
    """Sum container limits over existing pods + the incoming pod
    (calculateOccupancy, priorities.go:44-58)."""
    total_cpu = 0
    total_mem = 0
    for existing in pods:
        for c in existing.spec.containers:
            limits = c.resources.limits
            if RESOURCE_CPU in limits:
                total_cpu += limits[RESOURCE_CPU].milli_value()
            if RESOURCE_MEMORY in limits:
                total_mem += limits[RESOURCE_MEMORY].value()
    for c in pod.spec.containers:
        limits = c.resources.limits
        if RESOURCE_CPU in limits:
            total_cpu += limits[RESOURCE_CPU].milli_value()
        if RESOURCE_MEMORY in limits:
            total_mem += limits[RESOURCE_MEMORY].value()
    return total_cpu, total_mem


def _node_capacity(node: Node) -> tuple:
    cap = node.status.capacity or {}
    cpu = cap[RESOURCE_CPU].milli_value() if RESOURCE_CPU in cap else 0
    mem = cap[RESOURCE_MEMORY].value() if RESOURCE_MEMORY in cap else 0
    return cpu, mem


def calculate_score(requested: int, capacity: int) -> int:
    """(cap - req) * 10 / cap with integer truncation; 0 when cap == 0
    or req > cap (priorities.go:31-40)."""
    if capacity == 0:
        return 0
    if requested > capacity:
        return 0
    return ((capacity - requested) * 10) // capacity


def least_requested_priority(
    pod: Pod, pod_lister: StaticPodLister, minion_lister: StaticNodeLister
) -> List[HostPriority]:
    """LeastRequestedPriority (priorities.go:83-95): average of cpu and
    memory scores, integer-truncated."""
    pods_to_machines = map_pods_to_machines(pod_lister)
    out = []
    for node in minion_lister.list():
        total_cpu, total_mem = _limits_total(
            pods_to_machines.get(node.metadata.name, []), pod
        )
        cap_cpu, cap_mem = _node_capacity(node)
        cpu_score = calculate_score(total_cpu, cap_cpu)
        mem_score = calculate_score(total_mem, cap_mem)
        out.append(
            HostPriority(node.metadata.name, (cpu_score + mem_score) // 2)
        )
    return out


def _fraction_of_capacity(requested: int, capacity: int) -> float:
    if capacity == 0:
        return 1.0
    return float(requested) / float(capacity)


def balanced_resource_allocation(
    pod: Pod, pod_lister: StaticPodLister, minion_lister: StaticNodeLister
) -> List[HostPriority]:
    """BalancedResourceAllocation (priorities.go:146-205):
    int(10 - |cpuFraction - memFraction| * 10); 0 if either >= 1."""
    pods_to_machines = map_pods_to_machines(pod_lister)
    out = []
    for node in minion_lister.list():
        total_cpu, total_mem = _limits_total(
            pods_to_machines.get(node.metadata.name, []), pod
        )
        cap_cpu, cap_mem = _node_capacity(node)
        cpu_frac = _fraction_of_capacity(total_cpu, cap_cpu)
        mem_frac = _fraction_of_capacity(total_mem, cap_mem)
        if cpu_frac >= 1 or mem_frac >= 1:
            score = 0
        else:
            diff = abs(cpu_frac - mem_frac)
            score = int(10 - diff * 10)
        out.append(HostPriority(node.metadata.name, score))
    return out


def equal_priority(
    pod: Pod, pod_lister: StaticPodLister, minion_lister: StaticNodeLister
) -> List[HostPriority]:
    """EqualPriority (generic_scheduler.go:176-190): all nodes score 1."""
    return [HostPriority(n.metadata.name, 1) for n in minion_lister.list()]


class NodeLabelPrioritizer:
    """CalculateNodeLabelPriority (priorities.go:113-138): 10 when the
    label's presence matches the preference, else 0."""

    def __init__(self, label: str, presence: bool):
        self.label = label
        self.presence = presence

    def __call__(
        self, pod: Pod, pod_lister: StaticPodLister, minion_lister: StaticNodeLister
    ) -> List[HostPriority]:
        out = []
        for minion in minion_lister.list():
            exists = self.label in (minion.metadata.labels or {})
            success = (exists and self.presence) or (not exists and not self.presence)
            out.append(HostPriority(minion.metadata.name, 10 if success else 0))
        return out


def _ns_service_pods(pod: Pod, pod_lister, service_lister) -> List[Pod]:
    """First matching service's pods in the pod's namespace
    (spreading.go:44-57)."""
    services = service_lister.get_pod_services(pod)
    if not services:
        return []
    selector = labelpkg.selector_from_set(services[0].spec.selector)
    return [
        p
        for p in pod_lister.list(selector)
        if p.metadata.namespace == pod.metadata.namespace
    ]


class ServiceSpread:
    """CalculateSpreadPriority (spreading.go:38-87):
    10 * (maxCount - count) / maxCount, float32 then int-truncated."""

    def __init__(self, service_lister):
        self.service_lister = service_lister

    def __call__(
        self, pod: Pod, pod_lister: StaticPodLister, minion_lister: StaticNodeLister
    ) -> List[HostPriority]:
        ns_service_pods = _ns_service_pods(pod, pod_lister, self.service_lister)
        counts: Dict[str, int] = {}
        max_count = 0
        for p in ns_service_pods:
            counts[p.spec.node_name] = counts.get(p.spec.node_name, 0) + 1
            max_count = max(max_count, counts[p.spec.node_name])
        out = []
        for minion in minion_lister.list():
            fscore = 10.0
            if max_count > 0:
                fscore = 10 * (
                    (max_count - counts.get(minion.metadata.name, 0)) / max_count
                )
            out.append(HostPriority(minion.metadata.name, int(fscore)))
        return out


class ServiceAntiAffinity:
    """CalculateAntiAffinityPriority (spreading.go:105-169): spread
    service pods across values of a node label; unlabeled nodes get 0."""

    def __init__(self, service_lister, label: str):
        self.service_lister = service_lister
        self.label = label

    def __call__(
        self, pod: Pod, pod_lister: StaticPodLister, minion_lister: StaticNodeLister
    ) -> List[HostPriority]:
        ns_service_pods = _ns_service_pods(pod, pod_lister, self.service_lister)

        other_minions: List[str] = []
        labeled_minions: Dict[str, str] = {}
        for minion in minion_lister.list():
            node_labels = minion.metadata.labels or {}
            if self.label in node_labels:
                labeled_minions[minion.metadata.name] = node_labels[self.label]
            else:
                other_minions.append(minion.metadata.name)

        pod_counts: Dict[str, int] = {}
        for p in ns_service_pods:
            label = labeled_minions.get(p.spec.node_name)
            if label is None:
                continue
            pod_counts[label] = pod_counts.get(label, 0) + 1

        num_service_pods = len(ns_service_pods)
        out = []
        for minion in labeled_minions:
            fscore = 10.0
            if num_service_pods > 0:
                fscore = 10 * (
                    (num_service_pods - pod_counts.get(labeled_minions[minion], 0))
                    / num_service_pods
                )
            out.append(HostPriority(minion, int(fscore)))
        for minion in other_minions:
            out.append(HostPriority(minion, 0))
        return out
