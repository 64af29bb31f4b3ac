"""The API object model whole, as the apiserver validates it.

A copy of the classes of `kubernetes_tpu/models/objects.py` (reference:
pkg/api/types.go): Pod, Node, Service, Endpoints,
ReplicationController, Binding, Event, Namespace, Secret, the volume,
quota, limit, priority and service-account kinds, plus list and status
envelope types. The apiserver stores wire dicts and decodes them into
these classes (`models/serde.py`) only to validate them
(`models/validation.py`, `server/registry.py`). The scheduler side
keeps the smaller `models/objects.py`, which models only the fields it
lowers: decoding the wire form of the 50,000-pod backlog into this
model's classes takes about half as long again as into that one's
(`kubernetes_tpu_torch/lowering_timing.py`; PERF.md). The names that
are not classes (resource names, labels, annotations, preemption
policies, the pod helpers and the uid and timestamp stamps) are that
module's, imported here. Only fields the framework consumes are
modelled; the codec ignores unknown wire fields, so richer manifests
still load.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from kubernetes_tpu_torch.models.objects import (  # noqa: F401 (re-exported)
    POD_GROUP_LABEL,
    PREEMPT_LOWER_PRIORITY,
    PREEMPT_NEVER,
    REBALANCE_DEST_ANNOTATION,
    REBALANCE_JOURNAL_LABEL,
    RESOURCE_CPU,
    RESOURCE_MEMORY,
    RESOURCE_PODS,
    new_uid,
    now_iso,
    pod_can_preempt,
    pod_full_key,
    pod_is_terminating,
    pod_priority,
)
from kubernetes_tpu_torch.models.quantity import Quantity

ResourceList = Dict[str, Quantity]


@dataclass
class ObjectMeta:
    """Reference: pkg/api/types.go ObjectMeta."""

    name: str = ""
    namespace: str = ""
    uid: str = ""
    resource_version: str = ""
    creation_timestamp: str = ""
    deletion_timestamp: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    generate_name: str = ""
    # Graceful-delete bookkeeping (reference: api.ObjectMeta — later
    # releases): set together with deletion_timestamp when a pod is
    # marked Terminating; the kubelet force-deletes once the stamped
    # deadline passes.
    deletion_grace_period_seconds: Optional[int] = None


@dataclass
class ListMeta:
    resource_version: str = ""


@dataclass
class TypeMeta:
    kind: str = ""
    api_version: str = ""


# ---------------------------------------------------------------------------
# Pod
# ---------------------------------------------------------------------------


@dataclass
class ContainerPort:
    name: str = ""
    host_port: int = 0
    container_port: int = 0
    protocol: str = "TCP"
    host_ip: str = ""


@dataclass
class ResourceRequirements:
    limits: Dict[str, Quantity] = field(default_factory=dict)
    requests: Dict[str, Quantity] = field(default_factory=dict)


@dataclass
class ExecAction:
    command: List[str] = field(default_factory=list)


@dataclass
class HTTPGetAction:
    path: str = ""
    port: int = 0
    host: str = ""


@dataclass
class TCPSocketAction:
    port: int = 0


@dataclass
class Probe:
    exec: Optional[ExecAction] = None
    http_get: Optional[HTTPGetAction] = None
    tcp_socket: Optional[TCPSocketAction] = None
    initial_delay_seconds: int = 0
    timeout_seconds: int = 1


@dataclass
class EnvVar:
    name: str = ""
    value: str = ""


@dataclass
class VolumeMount:
    name: str = ""
    mount_path: str = ""
    read_only: bool = False


@dataclass
class Capabilities:
    add: List[str] = field(default_factory=list)
    drop: List[str] = field(default_factory=list)


@dataclass
class SecurityContext:
    """Reference: pkg/api/types.go SecurityContext (pkg/securitycontext/)."""

    privileged: bool = False
    capabilities: Optional[Capabilities] = None
    run_as_user: Optional[int] = None
    se_linux_options: Optional[Dict[str, str]] = None


@dataclass
class Container:
    """Reference: pkg/api/types.go Container."""

    name: str = ""
    image: str = ""
    command: List[str] = field(default_factory=list)
    args: List[str] = field(default_factory=list)
    working_dir: str = ""
    ports: List[ContainerPort] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    volume_mounts: List[VolumeMount] = field(default_factory=list)
    liveness_probe: Optional[Probe] = None
    readiness_probe: Optional[Probe] = None
    image_pull_policy: str = "IfNotPresent"
    security_context: Optional[SecurityContext] = None


@dataclass
class EmptyDirVolumeSource:
    medium: str = ""


@dataclass
class HostPathVolumeSource:
    path: str = ""


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
class SecretVolumeSource:
    secret_name: str = ""


@dataclass
class NFSVolumeSource:
    server: str = ""
    path: str = ""
    read_only: bool = False


@dataclass
class GitRepoVolumeSource:
    repository: str = ""
    revision: str = ""


@dataclass
class GlusterfsVolumeSource:
    endpoints_name: str = field(default="", metadata={"wire": "endpoints"})
    path: str = ""
    read_only: bool = False


@dataclass
class RBDVolumeSource:
    monitors: List[str] = field(default_factory=list)
    image: str = ""
    pool: str = "rbd"
    fs_type: str = ""
    read_only: bool = False


@dataclass
class ISCSIVolumeSource:
    target_portal: str = ""
    iqn: str = ""
    lun: int = 0
    fs_type: str = ""
    read_only: bool = False


@dataclass
class PersistentVolumeClaimVolumeSource:
    claim_name: str = ""
    read_only: bool = False


@dataclass
class Volume:
    """Reference: pkg/api/types.go Volume / VolumeSource."""

    name: str = ""
    empty_dir: Optional[EmptyDirVolumeSource] = None
    host_path: Optional[HostPathVolumeSource] = None
    gce_persistent_disk: Optional[GCEPersistentDiskVolumeSource] = None
    aws_elastic_block_store: Optional[AWSElasticBlockStoreVolumeSource] = None
    secret: Optional[SecretVolumeSource] = None
    nfs: Optional[NFSVolumeSource] = None
    git_repo: Optional[GitRepoVolumeSource] = None
    glusterfs: Optional[GlusterfsVolumeSource] = None
    rbd: Optional[RBDVolumeSource] = None
    iscsi: Optional[ISCSIVolumeSource] = None
    persistent_volume_claim: Optional[PersistentVolumeClaimVolumeSource] = None


@dataclass
class PodSpec:
    """Reference: pkg/api/types.go PodSpec."""

    volumes: List[Volume] = field(default_factory=list)
    containers: List[Container] = field(default_factory=list)
    restart_policy: str = "Always"
    node_selector: Dict[str, str] = field(default_factory=dict)
    node_name: str = ""
    host_network: bool = False
    service_account: str = ""
    # Priority & preemption (shape follows the later reference's
    # scheduling.k8s.io wiring): priorityClassName names a cluster
    # PriorityClass; the Priority admission plugin resolves it into
    # `priority` (and `preemption_policy`) and freezes all three.
    # None = unresolved; schedulers read it through pod_priority().
    priority_class_name: str = ""
    priority: Optional[int] = None
    preemption_policy: str = ""  # "" -> PreemptLowerPriority


@dataclass
class ContainerStatus:
    name: str = ""
    state: Dict[str, Any] = field(default_factory=dict)
    ready: bool = False
    restart_count: int = 0
    image: str = ""
    container_id: str = field(default="", metadata={"wire": "containerID"})


@dataclass
class PodCondition:
    type: str = ""
    status: str = ""
    # Wall-clock of the last status flip (reference: v1.PodCondition
    # .lastTransitionTime). The kubelet stamps it when the condition
    # changes and CARRIES it over when it doesn't, so the Running/Ready
    # transition instant survives status rewrites — the telemetry
    # plane's wire-visible startup timestamp (utils/sli.py).
    last_transition_time: str = ""


@dataclass
class PodStatus:
    """Reference: pkg/api/types.go PodStatus. phase in
    Pending|Running|Succeeded|Failed|Unknown."""

    phase: str = "Pending"
    conditions: List[PodCondition] = field(default_factory=list)
    message: str = ""
    reason: str = ""
    host_ip: str = ""
    pod_ip: str = ""
    start_time: str = ""
    container_statuses: List[ContainerStatus] = field(default_factory=list)
    # Node the scheduler nominated this (still pending) pod onto after
    # preempting victims there; cleared implicitly by binding. Lower-
    # priority pods must not race the freed capacity while this is set.
    nominated_node_name: str = ""


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
    last_heartbeat_time: str = ""
    last_transition_time: str = ""
    reason: str = ""
    message: str = ""


@dataclass
class NodeAddress:
    type: str = ""  # InternalIP | ExternalIP | Hostname
    address: str = ""


@dataclass
class DaemonEndpoint:
    port: int = 0


@dataclass
class NodeDaemonEndpoints:
    """Where this node's kubelet API listens. The reference hard-codes
    port 10250 and dials node addresses (pkg/master/master.go:497-520);
    publishing the endpoint in NodeStatus is the discovery seam our
    apiserver uses to proxy pod log/exec subresources."""

    kubelet_endpoint: DaemonEndpoint = field(default_factory=DaemonEndpoint)


@dataclass
class NodeStatus:
    """Reference: pkg/api/types.go NodeStatus (capacity drives scheduling)."""

    capacity: Dict[str, Quantity] = field(default_factory=dict)
    phase: str = ""
    conditions: List[NodeCondition] = field(default_factory=list)
    addresses: List[NodeAddress] = field(default_factory=list)
    daemon_endpoints: NodeDaemonEndpoints = field(
        default_factory=NodeDaemonEndpoints
    )
    node_info: Dict[str, str] = field(default_factory=dict)


@dataclass
class NodeSpec:
    pod_cidr: str = field(default="", metadata={"wire": "podCIDR"})
    external_id: str = field(default="", metadata={"wire": "externalID"})
    unschedulable: bool = False


@dataclass
class Node:
    kind: str = "Node"
    api_version: str = "v1"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)


# ---------------------------------------------------------------------------
# Service / Endpoints
# ---------------------------------------------------------------------------


@dataclass
class ServicePort:
    name: str = ""
    protocol: str = "TCP"
    port: int = 0
    target_port: Any = 0  # int or named port string
    node_port: int = 0


@dataclass
class ServiceSpec:
    """Reference: pkg/api/types.go ServiceSpec."""

    ports: List[ServicePort] = field(default_factory=list)
    selector: Dict[str, str] = field(default_factory=dict)
    cluster_ip: str = ""
    type: str = "ClusterIP"
    external_ips: List[str] = field(default_factory=list)
    session_affinity: str = "None"


@dataclass
class Service:
    kind: str = "Service"
    api_version: str = "v1"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ServiceSpec = field(default_factory=ServiceSpec)
    status: Dict[str, Any] = field(default_factory=dict)


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
# ReplicationController
# ---------------------------------------------------------------------------


@dataclass
class PodTemplateSpec:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)


@dataclass
class ReplicationControllerSpec:
    replicas: int = 0
    selector: Dict[str, str] = field(default_factory=dict)
    template: Optional[PodTemplateSpec] = None


@dataclass
class ReplicationControllerStatus:
    replicas: int = 0
    observed_generation: int = 0


@dataclass
class ReplicationController:
    kind: str = "ReplicationController"
    api_version: str = "v1"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ReplicationControllerSpec = field(default_factory=ReplicationControllerSpec)
    status: ReplicationControllerStatus = field(
        default_factory=ReplicationControllerStatus
    )


# ---------------------------------------------------------------------------
# Binding / Event / Namespace / Secret / envelopes
# ---------------------------------------------------------------------------


@dataclass
class ObjectReference:
    kind: str = ""
    namespace: str = ""
    name: str = ""
    uid: str = ""
    api_version: str = ""
    resource_version: str = ""
    field_path: str = ""


@dataclass
class Binding:
    """Reference: pkg/api/types.go Binding — metadata names the pod,
    target names the node (pkg/registry/pod/etcd/etcd.go:123-181)."""

    kind: str = "Binding"
    api_version: str = "v1"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    target: ObjectReference = field(default_factory=ObjectReference)


@dataclass
class Event:
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


@dataclass
class NamespaceSpec:
    finalizers: List[str] = field(default_factory=list)


@dataclass
class NamespaceStatus:
    phase: str = "Active"


@dataclass
class Namespace:
    kind: str = "Namespace"
    api_version: str = "v1"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NamespaceSpec = field(default_factory=NamespaceSpec)
    status: NamespaceStatus = field(default_factory=NamespaceStatus)


@dataclass
class Secret:
    kind: str = "Secret"
    api_version: str = "v1"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, str] = field(default_factory=dict)
    type: str = "Opaque"


@dataclass
class ServiceAccount:
    """Reference: pkg/api/types.go ServiceAccount."""

    kind: str = "ServiceAccount"
    api_version: str = "v1"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    secrets: List[ObjectReference] = field(default_factory=list)
    image_pull_secrets: List[Dict[str, str]] = field(default_factory=list)


@dataclass
class LimitRangeItem:
    """Reference: pkg/api/types.go LimitRangeItem — per-type min/max/default."""

    type: str = "Container"  # Pod | Container
    max: ResourceList = field(default_factory=dict)
    min: ResourceList = field(default_factory=dict)
    default: ResourceList = field(default_factory=dict)


@dataclass
class LimitRangeSpec:
    limits: List[LimitRangeItem] = field(default_factory=list)


@dataclass
class LimitRange:
    kind: str = "LimitRange"
    api_version: str = "v1"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LimitRangeSpec = field(default_factory=LimitRangeSpec)


@dataclass
class ResourceQuotaSpec:
    hard: ResourceList = field(default_factory=dict)


@dataclass
class ResourceQuotaStatus:
    hard: ResourceList = field(default_factory=dict)
    used: ResourceList = field(default_factory=dict)


@dataclass
class ResourceQuota:
    """Reference: pkg/api/types.go ResourceQuota. Hard limits include
    cpu/memory plus object counts (pods, services, ...)."""

    kind: str = "ResourceQuota"
    api_version: str = "v1"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ResourceQuotaSpec = field(default_factory=ResourceQuotaSpec)
    status: ResourceQuotaStatus = field(default_factory=ResourceQuotaStatus)


@dataclass
class PersistentVolumeSource:
    """Exactly one of the fields should be set (reference:
    pkg/api/types.go PersistentVolumeSource)."""

    host_path: Optional[HostPathVolumeSource] = None
    gce_persistent_disk: Optional[GCEPersistentDiskVolumeSource] = None
    aws_elastic_block_store: Optional[AWSElasticBlockStoreVolumeSource] = None
    nfs: Optional[NFSVolumeSource] = None
    glusterfs: Optional[GlusterfsVolumeSource] = None
    rbd: Optional[RBDVolumeSource] = None
    iscsi: Optional[ISCSIVolumeSource] = None


@dataclass
class PersistentVolumeSpec:
    capacity: ResourceList = field(default_factory=dict)
    access_modes: List[str] = field(default_factory=list)  # RWO/ROX/RWX
    persistent_volume_source: PersistentVolumeSource = field(
        default_factory=PersistentVolumeSource
    )
    claim_ref: Optional[ObjectReference] = None
    persistent_volume_reclaim_policy: str = "Retain"


@dataclass
class PersistentVolumeStatus:
    phase: str = "Pending"  # Pending|Available|Bound|Released|Failed
    message: str = ""
    reason: str = ""


@dataclass
class PersistentVolume:
    kind: str = "PersistentVolume"
    api_version: str = "v1"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeSpec = field(default_factory=PersistentVolumeSpec)
    status: PersistentVolumeStatus = field(default_factory=PersistentVolumeStatus)


@dataclass
class PersistentVolumeClaimSpec:
    access_modes: List[str] = field(default_factory=list)
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    volume_name: str = ""


@dataclass
class PersistentVolumeClaimStatus:
    phase: str = "Pending"  # Pending|Bound|Lost
    access_modes: List[str] = field(default_factory=list)
    capacity: ResourceList = field(default_factory=dict)


@dataclass
class PersistentVolumeClaim:
    kind: str = "PersistentVolumeClaim"
    api_version: str = "v1"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeClaimSpec = field(default_factory=PersistentVolumeClaimSpec)
    status: PersistentVolumeClaimStatus = field(
        default_factory=PersistentVolumeClaimStatus
    )


@dataclass
class PodTemplate:
    """Reference: pkg/api/types.go PodTemplate (pkg/registry/podtemplate)."""

    kind: str = "PodTemplate"
    api_version: str = "v1"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)


@dataclass
class PodGroupSpec:
    """Gang-scheduling intent (no reference analog in this tree; shape
    follows the sig-scheduling coscheduling PodGroup CRD). A group's
    member pods carry the pod-group label (scheduler/gang.py
    POD_GROUP_LABEL); the batch solver places them all-or-nothing."""

    # Minimum members that must be schedulable together; fewer than
    # this many feasible placements rejects the whole group atomically.
    min_member: int = 1
    # Optional ceiling on group membership; 0 = unlimited. Admission
    # rejects pods that would push the group past this (an "oversized"
    # group is a manifest bug, not a scheduling problem).
    max_member: int = 0
    # Groups still Pending this many seconds after creation are marked
    # Unschedulable by the gang controller (events + status); 0 = no
    # timeout.
    schedule_timeout_seconds: int = 0


@dataclass
class PodGroupStatus:
    phase: str = "Pending"  # Pending | Scheduled | Unschedulable
    members: int = 0  # pods carrying the group label
    bound: int = 0  # members with spec.nodeName set
    message: str = ""
    # When the current Pending stint began (ISO8601); the gang
    # controller ages scheduleTimeoutSeconds against THIS, not
    # creationTimestamp, so a gang that re-pends after running gets a
    # fresh timeout window. Empty = pending since creation.
    pending_since: str = ""


@dataclass
class PodGroup:
    kind: str = "PodGroup"
    api_version: str = "v1"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodGroupSpec = field(default_factory=PodGroupSpec)
    status: PodGroupStatus = field(default_factory=PodGroupStatus)


#: |value| ceiling for user PriorityClasses (reference:
#: scheduling.k8s.io HighestUserDefinablePriority).
MAX_PRIORITY = 1_000_000_000


@dataclass
class PriorityClass:
    """Cluster-scoped pod importance (no analog in this reference tree;
    shape follows scheduling.k8s.io/v1 PriorityClass). `value` is
    copied onto pods by the Priority admission plugin; `globalDefault`
    marks the class applied to pods naming no class at all;
    `preemptionPolicy: Never` opts a class's pods out of preempting
    (they still queue by priority and can themselves be preempted)."""

    kind: str = "PriorityClass"
    api_version: str = "v1"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0
    global_default: bool = False
    preemption_policy: str = PREEMPT_LOWER_PRIORITY
    description: str = ""


@dataclass
class ComponentCondition:
    type: str = "Healthy"
    status: str = "Unknown"  # True|False|Unknown
    message: str = ""
    error: str = ""


@dataclass
class ComponentStatus:
    """Reference: pkg/registry/componentstatus — health of master components."""

    kind: str = "ComponentStatus"
    api_version: str = "v1"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    conditions: List[ComponentCondition] = field(default_factory=list)


@dataclass
class DeleteOptions:
    kind: str = "DeleteOptions"
    api_version: str = "v1"
    grace_period_seconds: Optional[int] = None


@dataclass
class StatusDetails:
    name: str = ""
    kind: str = ""
    causes: List[Dict[str, str]] = field(default_factory=list)


@dataclass
class Status:
    """Reference: pkg/api/types.go Status — API error/success envelope."""

    kind: str = "Status"
    api_version: str = "v1"
    metadata: ListMeta = field(default_factory=ListMeta)
    status: str = ""  # Success | Failure
    message: str = ""
    reason: str = ""
    details: Optional[StatusDetails] = None
    code: int = 0


# Registry of kinds for decode dispatch (reference: runtime.Scheme type map).
KINDS = {
    "Pod": Pod,
    "Node": Node,
    "Minion": Node,
    "Service": Service,
    "Endpoints": Endpoints,
    "ReplicationController": ReplicationController,
    "Binding": Binding,
    "Event": Event,
    "Namespace": Namespace,
    "Secret": Secret,
    "ServiceAccount": ServiceAccount,
    "LimitRange": LimitRange,
    "ResourceQuota": ResourceQuota,
    "PersistentVolume": PersistentVolume,
    "PersistentVolumeClaim": PersistentVolumeClaim,
    "PodTemplate": PodTemplate,
    "PodGroup": PodGroup,
    "PriorityClass": PriorityClass,
    "ComponentStatus": ComponentStatus,
    "DeleteOptions": DeleteOptions,
    "Status": Status,
}
