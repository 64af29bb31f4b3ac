"""Scalar fit predicates — exact reference semantics.

Reference: plugin/pkg/scheduler/algorithm/predicates/predicates.go.
These are the parity oracle for the TPU matrix path; every behavioral
quirk of the original is preserved on purpose:

- resources come from container LIMITS (getResourceRequest,
  predicates.go:106-114 — v0.19 predates requests-based scheduling);
- a zero-request pod fits iff the node has pod-count headroom
  (predicates.go:146-148);
- capacity checking greedily re-simulates packing the existing pods in
  order, so pods that overflow an overcommitted node stop counting
  (CheckPodsExceedingCapacity, predicates.go:116-136);
- zero capacity for a resource means "unlimited" for that resource but
  scores 0 later (predicates.go:123-124);
- GCE PD conflicts exempt pairs where BOTH mounts are read-only; AWS
  EBS conflicts regardless (isVolumeConflict, predicates.go:53-78).

The port's copy of `kubernetes_tpu/scheduler/predicates.py`, line for
line: the scalar path of the full re-lower daemon (a policy that does
not lower to the card) and the yardstick the card's decisions are held
to. Pure Python; no torch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.models import labels as labelpkg
from kubernetes_tpu_torch.models.objects import Node, Pod, RESOURCE_CPU, RESOURCE_MEMORY, RESOURCE_PODS
from kubernetes_tpu_torch.scheduler.types import StaticNodeLister


def get_resource_request(pod: Pod) -> Tuple[int, int]:
    """(milliCPU, memory bytes) summed over container limits."""
    milli_cpu = 0
    memory = 0
    for c in pod.spec.containers:
        limits = c.resources.limits
        if RESOURCE_CPU in limits:
            milli_cpu += limits[RESOURCE_CPU].milli_value()
        if RESOURCE_MEMORY in limits:
            memory += limits[RESOURCE_MEMORY].value()
    return milli_cpu, memory


def _capacity(node: Node) -> Tuple[int, int, int]:
    cap = node.status.capacity or {}
    cpu = cap[RESOURCE_CPU].milli_value() if RESOURCE_CPU in cap else 0
    mem = cap[RESOURCE_MEMORY].value() if RESOURCE_MEMORY in cap else 0
    pods = cap[RESOURCE_PODS].value() if RESOURCE_PODS in cap else 0
    return cpu, mem, pods


def check_pods_exceeding_capacity(
    pods: Sequence[Pod], capacity: Tuple[int, int]
) -> Tuple[List[Pod], List[Pod]]:
    """Greedy packing simulation (predicates.go:116-136)."""
    total_cpu, total_mem = capacity
    cpu_used = 0
    mem_used = 0
    fitting: List[Pod] = []
    not_fitting: List[Pod] = []
    for pod in pods:
        cpu_req, mem_req = get_resource_request(pod)
        fits_cpu = total_cpu == 0 or (total_cpu - cpu_used) >= cpu_req
        fits_mem = total_mem == 0 or (total_mem - mem_used) >= mem_req
        if not fits_cpu or not fits_mem:
            not_fitting.append(pod)
            continue
        cpu_used += cpu_req
        mem_used += mem_req
        fitting.append(pod)
    return fitting, not_fitting


class ResourceFit:
    """PodFitsResources (predicates.go:139-156)."""

    def __init__(self, node_lister: StaticNodeLister):
        self.node_lister = node_lister

    def __call__(self, pod: Pod, existing_pods: List[Pod], node: str) -> bool:
        cpu_req, mem_req = get_resource_request(pod)
        info = self.node_lister.get(node)
        cap_cpu, cap_mem, cap_pods = _capacity(info)
        if cpu_req == 0 and mem_req == 0:
            return len(existing_pods) < cap_pods
        pods = list(existing_pods) + [pod]
        _, exceeding = check_pods_exceeding_capacity(pods, (cap_cpu, cap_mem))
        if exceeding or len(pods) > cap_pods:
            return False
        return True


def pod_matches_node_labels(pod: Pod, node: Node) -> bool:
    """predicates.go:172-178."""
    if not pod.spec.node_selector:
        return True
    selector = labelpkg.selector_from_set(pod.spec.node_selector)
    return selector.matches(node.metadata.labels or {})


class NodeSelectorMatches:
    """PodSelectorMatches / MatchNodeSelector (predicates.go:184-190)."""

    def __init__(self, node_lister: StaticNodeLister):
        self.node_lister = node_lister

    def __call__(self, pod: Pod, existing_pods: List[Pod], node: str) -> bool:
        return pod_matches_node_labels(pod, self.node_lister.get(node))


def pod_fits_host(pod: Pod, existing_pods: List[Pod], node: str) -> bool:
    """PodFitsHost / HostName (predicates.go:192-197)."""
    if not pod.spec.node_name:
        return True
    return pod.spec.node_name == node


def _is_volume_conflict(volume, pod: Pod) -> bool:
    """isVolumeConflict (predicates.go:53-78)."""
    if volume.gce_persistent_disk is not None:
        disk = volume.gce_persistent_disk
        for v in pod.spec.volumes:
            if (
                v.gce_persistent_disk is not None
                and v.gce_persistent_disk.pd_name == disk.pd_name
                and not (v.gce_persistent_disk.read_only and disk.read_only)
            ):
                return True
    if volume.aws_elastic_block_store is not None:
        volume_id = volume.aws_elastic_block_store.volume_id
        for v in pod.spec.volumes:
            if (
                v.aws_elastic_block_store is not None
                and v.aws_elastic_block_store.volume_id == volume_id
            ):
                return True
    return False


def no_disk_conflict(pod: Pod, existing_pods: List[Pod], node: str) -> bool:
    """NoDiskConflict (predicates.go:85-95)."""
    for volume in pod.spec.volumes:
        for existing in existing_pods:
            if _is_volume_conflict(volume, existing):
                return False
    return True


def get_used_ports(*pods: Pod) -> Dict[int, bool]:
    """predicates.go:351-360 — note hostPort 0 is recorded too (and
    ignored by the caller)."""
    ports: Dict[int, bool] = {}
    for pod in pods:
        for container in pod.spec.containers:
            for port in container.ports:
                ports[port.host_port] = True
    return ports


def pod_fits_ports(pod: Pod, existing_pods: List[Pod], node: str) -> bool:
    """PodFitsPorts (predicates.go:337-349)."""
    existing_ports = get_used_ports(*existing_pods)
    want_ports = get_used_ports(pod)
    for wport in want_ports:
        if wport == 0:
            continue
        if existing_ports.get(wport):
            return False
    return True


class NodeLabelChecker:
    """CheckNodeLabelPresence (predicates.go:226-240)."""

    def __init__(self, node_lister: StaticNodeLister, labels: List[str], presence: bool):
        self.node_lister = node_lister
        self.labels = labels
        self.presence = presence

    def __call__(self, pod: Pod, existing_pods: List[Pod], node: str) -> bool:
        minion = self.node_lister.get(node)
        minion_labels = minion.metadata.labels or {}
        for label in self.labels:
            exists = label in minion_labels
            if (exists and not self.presence) or (not exists and self.presence):
                return False
        return True


class ServiceAffinity:
    """CheckServiceAffinity (predicates.go:268-335)."""

    def __init__(self, pod_lister, service_lister, node_lister, labels: List[str]):
        self.pod_lister = pod_lister
        self.service_lister = service_lister
        self.node_lister = node_lister
        self.labels = labels

    def __call__(self, pod: Pod, existing_pods: List[Pod], node: str) -> bool:
        affinity_labels: Dict[str, str] = {}
        node_selector = pod.spec.node_selector or {}
        labels_exist = True
        for l in self.labels:
            if l in node_selector:
                affinity_labels[l] = node_selector[l]
            else:
                labels_exist = False

        if not labels_exist:
            services = self.service_lister.get_pod_services(pod)
            if services:
                selector = labelpkg.selector_from_set(services[0].spec.selector)
                service_pods = self.pod_lister.list(selector)
                ns_service_pods = [
                    p
                    for p in service_pods
                    if p.metadata.namespace == pod.metadata.namespace
                ]
                if ns_service_pods:
                    try:
                        other = self.node_lister.get(ns_service_pods[0].spec.node_name)
                    except KeyError:
                        return False
                    other_labels = other.metadata.labels or {}
                    for l in self.labels:
                        if l in affinity_labels:
                            continue
                        if l in other_labels:
                            affinity_labels[l] = other_labels[l]

        minion = self.node_lister.get(node)
        if not affinity_labels:
            return True
        return labelpkg.selector_from_set(affinity_labels).matches(
            minion.metadata.labels or {}
        )
