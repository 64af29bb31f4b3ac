"""Typed API objects: the kinds the batch scheduler reads.

A copy of the subset of `kubernetes_tpu/models/objects.py` that
`models/columnar.py`, the incremental session, the gang solver,
preemption, the defrag planner and the scheduler daemon consume
(reference: pkg/api/types.go): ObjectMeta, Pod with its spec,
containers, ports, resources and the exclusive-disk volume sources,
Node with its spec, status and conditions, Service, PodGroup, the
PodTemplate of the descheduler's move journal, the Event the
recorder writes, and the Endpoints record a lease is kept in. The lowering reads these objects by
attribute only, so the JAX package's objects of the same shape lower
identically. Wire form is camelCase JSON through `models/serde.py`;
a field's `wire` metadata names a key that the plain conversion would
spell otherwise.
"""

from __future__ import annotations

import calendar
import random as _random
import time
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

# Label marking a PodTemplate as a journaled rebalance move (value: the
# move's destination node): written before the eviction, deleted once
# the replacement pod exists; the descheduler's recovery replays an
# orphaned one.
REBALANCE_JOURNAL_LABEL = "rebalance.kubernetes-tpu.io/move"

# The pod label naming the PodGroup (same namespace) a pod belongs to;
# the gang solver places a group's pods all-or-nothing.
POD_GROUP_LABEL = "pod-group.kubernetes-tpu.io/name"


# Preemption policies (reference: core.PreemptionPolicy). The empty
# string on a pod means PREEMPT_LOWER_PRIORITY.
PREEMPT_LOWER_PRIORITY = "PreemptLowerPriority"
PREEMPT_NEVER = "Never"


@dataclass
class ObjectMeta:
    """Reference: pkg/api/types.go ObjectMeta."""

    name: str = ""
    namespace: str = ""
    uid: str = ""
    resource_version: str = ""
    creation_timestamp: str = ""
    # Set when a pod is marked Terminating; gang membership no longer
    # counts it.
    deletion_timestamp: str = ""
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
    volume_id: str = field(default="", metadata={"wire": "volumeID"})
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
    # Resolved scheduling priority (None = unresolved, read as 0) and
    # whether the pod may evict lower-priority pods ("" reads as
    # PreemptLowerPriority).
    priority: Optional[int] = None
    preemption_policy: str = ""


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


def pod_priority(pod: Pod) -> int:
    """Resolved scheduling priority (0 = unset/best-effort)."""
    return pod.spec.priority or 0


def pod_full_key(pod: Pod) -> str:
    """Canonical 'namespace/name' pod key with the empty namespace
    defaulted: the key preemption decisions and the gang preemption
    guard compare."""
    return f"{pod.metadata.namespace or 'default'}/{pod.metadata.name}"


def pod_can_preempt(pod: Pod) -> bool:
    """Whether this pod may evict others (its own policy, not its
    victims'). Unset policy = PreemptLowerPriority."""
    return (pod.spec.preemption_policy or PREEMPT_LOWER_PRIORITY) != PREEMPT_NEVER


def pod_is_terminating(pod: Pod) -> bool:
    """Graceful delete in flight: still occupies its node, no longer a
    preemption victim or a movable pod."""
    return bool(pod.metadata.deletion_timestamp)


@dataclass
class PodTemplateSpec:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)


@dataclass
class PodTemplate:
    """Reference: pkg/api/types.go PodTemplate. Typed, it carries only
    the PodSpec fields above; the descheduler reads and writes its
    journal entries in wire form, so no field of a moved pod is lost."""

    kind: str = "PodTemplate"
    api_version: str = "v1"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)


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


# ---------------------------------------------------------------------------
# Endpoints (the record leader election and the fencing lease annotate)
# ---------------------------------------------------------------------------


@dataclass
class EndpointAddress:
    ip: str = field(default="", metadata={"wire": "ip"})
    target_ref: Optional[Dict[str, str]] = None


@dataclass
class EndpointPort:
    name: str = ""
    port: int = 0
    protocol: str = "TCP"


@dataclass
class EndpointSubset:
    addresses: List[EndpointAddress] = field(default_factory=list)
    ports: List[EndpointPort] = field(default_factory=list)


@dataclass
class Endpoints:
    kind: str = "Endpoints"
    api_version: str = "v1"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    subsets: List[EndpointSubset] = field(default_factory=list)


# ---------------------------------------------------------------------------
# PodGroup
# ---------------------------------------------------------------------------


@dataclass
class PodGroupSpec:
    """Gang-scheduling intent: fewer than `min_member` schedulable
    members rejects the whole group."""

    min_member: int = 1
    max_member: int = 0
    schedule_timeout_seconds: int = 0


@dataclass
class PodGroupStatus:
    phase: str = "Pending"  # Pending | Scheduled | Unschedulable
    members: int = 0
    bound: int = 0
    message: str = ""


@dataclass
class PodGroup:
    kind: str = "PodGroup"
    api_version: str = "v1"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodGroupSpec = field(default_factory=PodGroupSpec)
    status: PodGroupStatus = field(default_factory=PodGroupStatus)


# ---------------------------------------------------------------------------
# Event
# ---------------------------------------------------------------------------


@dataclass
class ObjectReference:
    kind: str = ""
    namespace: str = ""
    name: str = ""
    uid: str = ""


@dataclass
class Event:
    """Reference: pkg/api/types.go Event (what the recorder writes and,
    for a repeat, reads back to raise its count)."""

    kind: str = "Event"
    api_version: str = "v1"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    involved_object: ObjectReference = field(default_factory=ObjectReference)
    reason: str = ""
    message: str = ""
    source: Dict[str, str] = field(default_factory=dict)
    first_timestamp: str = ""
    last_timestamp: str = ""
    count: int = 0


#: Second-granular ISO timestamp memo: creationTimestamp stamping sits
#: on the bulk-create hot path, and strftime+gmtime per object was
#: ~6us of pure re-formatting of the same second.
_NOW_ISO = (0, "")


def now_iso() -> str:
    """The current UTC time to the second, as the wire stamps it."""
    global _NOW_ISO
    t = int(time.time())
    if t != _NOW_ISO[0]:
        _NOW_ISO = (t, time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t)))
    return _NOW_ISO[1]


#: uid entropy: one urandom-seeded PRNG per process instead of a
#: urandom() syscall per object (uuid.uuid4 reads the kernel CSPRNG
#: every call, the largest cost of a bulk create). uids need
#: uniqueness, not cryptographic unpredictability; the seed itself
#: still comes from the kernel.
_UID_RAND = _random.Random()


def new_uid() -> str:
    """A fresh uuid4-shaped uid (version and variant nibbles fixed, so
    anything parsing uids as UUIDs keeps working)."""
    h = "%032x" % _UID_RAND.getrandbits(128)
    return (
        f"{h[0:8]}-{h[8:12]}-4{h[13:16]}-"
        f"{'89ab'[int(h[16], 16) & 3]}{h[17:20]}-{h[20:32]}"
    )


def parse_iso(ts: str) -> Optional[float]:
    """Seconds since the epoch of a wire stamp (`now_iso`'s form); None
    when it is empty or not in that form."""
    if not ts:
        return None
    try:
        return float(calendar.timegm(time.strptime(ts, "%Y-%m-%dT%H:%M:%SZ")))
    except ValueError:
        return None
