"""Typed API objects: the kinds the batch scheduler's lowering reads.

A copy of the subset of `kubernetes_tpu/models/objects.py` that
`models/columnar.py` consumes (reference: pkg/api/types.go): ObjectMeta,
Pod with its spec, containers, ports, resources and the exclusive-disk
volume sources, Node with its status and conditions, and Service. The
lowering reads these objects by attribute only, so the JAX package's
objects of the same shape lower identically.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from kubernetes_tpu_torch.models.quantity import Quantity

# Resource names (reference: pkg/api/types.go ResourceName consts).
RESOURCE_CPU = "cpu"
RESOURCE_MEMORY = "memory"
RESOURCE_PODS = "pods"

# Rebalance-move destination annotation: a pod recreated by the
# descheduler carries its planned destination here, and the lowering
# honours it as a HostName pin.
REBALANCE_DEST_ANNOTATION = "rebalance.kubernetes-tpu.io/destination"


@dataclass
class ObjectMeta:
    """Reference: pkg/api/types.go ObjectMeta."""

    name: str = ""
    namespace: str = ""
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Pod
# ---------------------------------------------------------------------------


@dataclass
class ContainerPort:
    name: str = ""
    host_port: int = 0
    container_port: int = 0
    protocol: str = "TCP"


@dataclass
class ResourceRequirements:
    limits: Dict[str, Quantity] = field(default_factory=dict)
    requests: Dict[str, Quantity] = field(default_factory=dict)


@dataclass
class Container:
    """Reference: pkg/api/types.go Container."""

    name: str = ""
    image: str = ""
    ports: List[ContainerPort] = field(default_factory=list)
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)


@dataclass
class GCEPersistentDiskVolumeSource:
    pd_name: str = ""
    fs_type: str = ""
    read_only: bool = False


@dataclass
class AWSElasticBlockStoreVolumeSource:
    volume_id: str = ""
    fs_type: str = ""
    read_only: bool = False


@dataclass
class Volume:
    """Reference: pkg/api/types.go Volume. Only the exclusive-disk
    sources that NoDiskConflict reads are modelled."""

    name: str = ""
    gce_persistent_disk: Optional[GCEPersistentDiskVolumeSource] = None
    aws_elastic_block_store: Optional[AWSElasticBlockStoreVolumeSource] = None


@dataclass
class PodSpec:
    """Reference: pkg/api/types.go PodSpec."""

    volumes: List[Volume] = field(default_factory=list)
    containers: List[Container] = field(default_factory=list)
    node_selector: Dict[str, str] = field(default_factory=dict)
    node_name: str = ""


@dataclass
class PodStatus:
    """phase in Pending|Running|Succeeded|Failed|Unknown."""

    phase: str = "Pending"


@dataclass
class Pod:
    kind: str = "Pod"
    api_version: str = "v1"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)


# ---------------------------------------------------------------------------
# Node
# ---------------------------------------------------------------------------


@dataclass
class NodeCondition:
    type: str = ""  # Ready
    status: str = ""  # True | False | Unknown


@dataclass
class NodeStatus:
    """Reference: pkg/api/types.go NodeStatus (capacity drives scheduling)."""

    capacity: Dict[str, Quantity] = field(default_factory=dict)
    conditions: List[NodeCondition] = field(default_factory=list)


@dataclass
class NodeSpec:
    unschedulable: bool = False


@dataclass
class Node:
    kind: str = "Node"
    api_version: str = "v1"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)


# ---------------------------------------------------------------------------
# Service
# ---------------------------------------------------------------------------


@dataclass
class ServiceSpec:
    """Reference: pkg/api/types.go ServiceSpec (the selector is all the
    scheduler reads)."""

    selector: Dict[str, str] = field(default_factory=dict)


@dataclass
class Service:
    kind: str = "Service"
    api_version: str = "v1"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ServiceSpec = field(default_factory=ServiceSpec)
    status: Dict[str, Any] = field(default_factory=dict)
