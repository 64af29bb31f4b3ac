"""Resource registry: which resources exist, their kinds, scoping,
validation, and storage layout.

Reference: the resource->storage map assembled in
pkg/master/master.go:460-494 and the per-resource registries under
pkg/registry/.

A copy of `kubernetes_tpu/server/registry.py` over the port's whole
object model (`models/apiobjects.py`) and validation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

from kubernetes_tpu_torch.models import apiobjects as O
from kubernetes_tpu_torch.models import validation as V


@dataclass(frozen=True)
class ResourceInfo:
    name: str  # plural REST name, e.g. "pods"
    kind: str
    cls: type
    namespaced: bool = True
    validator: Optional[Callable] = None
    ttl: Optional[float] = None  # seconds; events are TTL'd
    # Optional wire-form validator twin (same checks, no typed
    # decode) — the bulk-path fast validator; parity with `validator`
    # is pinned by tests.
    wire_validator: Optional[Callable] = None

    def key(self, namespace: str, name: str) -> str:
        if self.namespaced:
            return f"/registry/{self.name}/{namespace}/{name}"
        return f"/registry/{self.name}/{name}"

    def prefix(self, namespace: str = "") -> str:
        if self.namespaced and namespace:
            return f"/registry/{self.name}/{namespace}/"
        return f"/registry/{self.name}/"


RESOURCES: Dict[str, ResourceInfo] = {}


def _register(info: ResourceInfo, *aliases: str) -> None:
    RESOURCES[info.name] = info
    for a in aliases:
        RESOURCES[a] = info


_register(
    ResourceInfo(
        "pods", "Pod", O.Pod,
        validator=V.validate_pod,
        wire_validator=V.validate_pod_wire,
    )
)
_register(
    ResourceInfo("nodes", "Node", O.Node, namespaced=False, validator=V.validate_node),
    "minions",  # legacy alias (reference: pkg/registry/minion)
)
_register(ResourceInfo("services", "Service", O.Service, validator=V.validate_service))
_register(ResourceInfo("endpoints", "Endpoints", O.Endpoints))
_register(
    ResourceInfo(
        "replicationcontrollers",
        "ReplicationController",
        O.ReplicationController,
        validator=V.validate_replication_controller,
    ),
    "rc",
)
_register(ResourceInfo("events", "Event", O.Event, ttl=3600.0))
_register(ResourceInfo("namespaces", "Namespace", O.Namespace, namespaced=False))
_register(ResourceInfo("secrets", "Secret", O.Secret))
_register(
    ResourceInfo(
        "serviceaccounts",
        "ServiceAccount",
        O.ServiceAccount,
        validator=V.validate_service_account,
    )
)
_register(
    ResourceInfo(
        "limitranges", "LimitRange", O.LimitRange, validator=V.validate_limit_range
    )
)
_register(
    ResourceInfo(
        "resourcequotas",
        "ResourceQuota",
        O.ResourceQuota,
        validator=V.validate_resource_quota,
    ),
    "quota",
)
_register(
    ResourceInfo(
        "persistentvolumes",
        "PersistentVolume",
        O.PersistentVolume,
        namespaced=False,
        validator=V.validate_persistent_volume,
    ),
    "pv",
)
_register(
    ResourceInfo(
        "persistentvolumeclaims",
        "PersistentVolumeClaim",
        O.PersistentVolumeClaim,
        validator=V.validate_persistent_volume_claim,
    ),
    "pvc",
)
_register(ResourceInfo("podtemplates", "PodTemplate", O.PodTemplate))
_register(
    ResourceInfo(
        "podgroups", "PodGroup", O.PodGroup, validator=V.validate_pod_group
    ),
    "pg",
)
_register(
    ResourceInfo(
        "priorityclasses",
        "PriorityClass",
        O.PriorityClass,
        namespaced=False,
        validator=V.validate_priority_class,
    ),
    "pc",
)
_register(
    ResourceInfo(
        "componentstatuses", "ComponentStatus", O.ComponentStatus, namespaced=False
    ),
    "cs",
)


# Field extractors for field selectors (reference: pkg/registry/pod/strategy
# PodToSelectableFields etc.). Values must be strings.
def unique_resources():
    """ResourceInfos deduped across aliases, sorted by name (the
    registry maps each info under its name PLUS aliases)."""
    seen = set()
    out = []
    for info in sorted(RESOURCES.values(), key=lambda i: i.name):
        if info.name in seen:
            continue
        seen.add(info.name)
        out.append(info)
    return out


def pod_fields(obj: dict) -> Dict[str, str]:
    return {
        "metadata.name": obj.get("metadata", {}).get("name", ""),
        "metadata.namespace": obj.get("metadata", {}).get("namespace", ""),
        "spec.nodeName": obj.get("spec", {}).get("nodeName", ""),
        "spec.host": obj.get("spec", {}).get("nodeName", ""),  # legacy name
        "status.phase": obj.get("status", {}).get("phase", ""),
    }


def generic_fields(obj: dict) -> Dict[str, str]:
    return {
        "metadata.name": obj.get("metadata", {}).get("name", ""),
        "metadata.namespace": obj.get("metadata", {}).get("namespace", ""),
    }


def event_fields(obj: dict) -> Dict[str, str]:
    inv = obj.get("involvedObject", {})
    f = generic_fields(obj)
    f.update(
        {
            "involvedObject.kind": inv.get("kind", ""),
            "involvedObject.name": inv.get("name", ""),
            "involvedObject.namespace": inv.get("namespace", ""),
            "involvedObject.uid": inv.get("uid", ""),
        }
    )
    return f


FIELD_EXTRACTORS: Dict[str, Callable[[dict], Dict[str, str]]] = {
    "pods": pod_fields,
    "events": event_fields,
}


def fields_for(resource: str, obj: dict) -> Dict[str, str]:
    return FIELD_EXTRACTORS.get(resource, generic_fields)(obj)
