"""Object validation.

Behavioral parity with pkg/api/validation/validation.go (subset): DNS
naming rules, required fields, uniqueness constraints, port ranges.
Errors are collected (not fail-fast) like the reference's field-error
lists (pkg/util/fielderrors/).

A copy of `kubernetes_tpu/models/validation.py` over the port's copy of
the whole object model (`models/apiobjects.py`).
"""

from __future__ import annotations

import re
from typing import List

from kubernetes_tpu_torch.models.apiobjects import (
    Node,
    Pod,
    ReplicationController,
    Service,
)

# RFC 1123 subdomain/label (reference: util.IsDNS1123Subdomain/Label).
_DNS1123_LABEL = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")
_DNS1123_SUBDOMAIN = re.compile(
    r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?(\.[a-z0-9]([-a-z0-9]*[a-z0-9])?)*$"
)
_LABEL_VALUE = re.compile(r"^(([A-Za-z0-9][-A-Za-z0-9_.]*)?[A-Za-z0-9])?$")

RESTART_POLICIES = {"Always", "OnFailure", "Never"}
PULL_POLICIES = {"Always", "Never", "IfNotPresent"}
PROTOCOLS = {"TCP", "UDP"}


#: Quantity strings already proven parseable (bounded memo): pods in a
#: fleet reuse a handful of resource sizes, so the wire validator's
#: quantity re-parse is almost always a set hit.
_KNOWN_GOOD_QUANTITIES: set = set()


class ValidationError(ValueError):
    def __init__(self, errors: List[str]):
        self.errors = errors
        super().__init__("; ".join(errors))


def is_dns1123_label(s: str) -> bool:
    return bool(s) and len(s) <= 63 and bool(_DNS1123_LABEL.match(s))


def is_dns1123_subdomain(s: str) -> bool:
    return bool(s) and len(s) <= 253 and bool(_DNS1123_SUBDOMAIN.match(s))


def _validate_meta(meta, errs: List[str], *, namespace_required: bool = True) -> None:
    if not meta.name and not meta.generate_name:
        errs.append("metadata.name: required")
    elif meta.name and not is_dns1123_subdomain(meta.name):
        errs.append(f"metadata.name: invalid name {meta.name!r}")
    if namespace_required and not meta.namespace:
        errs.append("metadata.namespace: required")
    for k, v in (meta.labels or {}).items():
        if not _LABEL_VALUE.match(v):
            errs.append(f"metadata.labels[{k}]: invalid value {v!r}")


def _validate_containers(containers, errs: List[str]) -> None:
    if not containers:
        errs.append("spec.containers: required")
    names = set()
    for i, c in enumerate(containers):
        where = f"spec.containers[{i}]"
        if not is_dns1123_label(c.name):
            errs.append(f"{where}.name: invalid {c.name!r}")
        if c.name in names:
            errs.append(f"{where}.name: duplicate {c.name!r}")
        names.add(c.name)
        if not c.image:
            errs.append(f"{where}.image: required")
        if c.image_pull_policy and c.image_pull_policy not in PULL_POLICIES:
            errs.append(f"{where}.imagePullPolicy: invalid {c.image_pull_policy!r}")
        for p in c.ports:
            if not (0 < p.container_port < 65536):
                errs.append(f"{where}.ports: containerPort {p.container_port} invalid")
            if p.host_port and not (0 < p.host_port < 65536):
                errs.append(f"{where}.ports: hostPort {p.host_port} invalid")
            if p.protocol not in PROTOCOLS:
                errs.append(f"{where}.ports: protocol {p.protocol!r} invalid")


def validate_pod_wire(obj: dict) -> None:
    """validate_pod's wire-form twin: the SAME checks evaluated
    directly on the camelCase wire dict, skipping the typed decode.

    Exists for the bulk-create fast path: serde.from_wire + the typed
    validator cost ~60us/pod — at bulk-ingest rates the decode (whose
    result is thrown away) was the apiserver's single largest per-pod
    cost. tests/test_watchcache.py pins accept/reject parity between
    the twins on shared fixtures so they cannot drift silently.

    One deliberate strengthening: resource quantity strings are parsed
    here (the typed path parses them inside from_wire, surfacing a bad
    quantity as a 500 from the codec; the wire path reports it as a
    field error like the reference's validation does)."""
    from kubernetes_tpu_torch.models.apiobjects import (
        MAX_PRIORITY,
        PREEMPT_LOWER_PRIORITY,
        PREEMPT_NEVER,
    )
    from kubernetes_tpu_torch.models.quantity import parse_quantity

    errs: List[str] = []
    meta = obj.get("metadata") or {}
    if not meta.get("name") and not meta.get("generateName"):
        errs.append("metadata.name: required")
    elif meta.get("name") and not is_dns1123_subdomain(meta["name"]):
        errs.append(f"metadata.name: invalid name {meta['name']!r}")
    if not meta.get("namespace"):
        errs.append("metadata.namespace: required")
    for k, v in (meta.get("labels") or {}).items():
        if not isinstance(v, str) or not _LABEL_VALUE.match(v):
            errs.append(f"metadata.labels[{k}]: invalid value {v!r}")
    spec = obj.get("spec") or {}
    containers = spec.get("containers") or []
    if not containers:
        errs.append("spec.containers: required")
    names = set()
    for i, c in enumerate(containers):
        where = f"spec.containers[{i}]"
        cname = c.get("name", "")
        if not is_dns1123_label(cname):
            errs.append(f"{where}.name: invalid {cname!r}")
        if cname in names:
            errs.append(f"{where}.name: duplicate {cname!r}")
        names.add(cname)
        if not c.get("image"):
            errs.append(f"{where}.image: required")
        pull = c.get("imagePullPolicy", "")
        if pull and pull not in PULL_POLICIES:
            errs.append(f"{where}.imagePullPolicy: invalid {pull!r}")
        for p in c.get("ports") or []:
            cp = p.get("containerPort", 0)
            hp = p.get("hostPort", 0)
            if not (0 < cp < 65536):
                errs.append(f"{where}.ports: containerPort {cp} invalid")
            if hp and not (0 < hp < 65536):
                errs.append(f"{where}.ports: hostPort {hp} invalid")
            if p.get("protocol", "TCP") not in PROTOCOLS:
                errs.append(
                    f"{where}.ports: protocol {p.get('protocol')!r} invalid"
                )
        for kind in ("limits", "requests"):
            for rname, q in ((c.get("resources") or {}).get(kind) or {}).items():
                q_s = str(q)
                if q_s in _KNOWN_GOOD_QUANTITIES:
                    continue  # fleets reuse a handful of sizes
                try:
                    parse_quantity(q_s)
                except (ValueError, TypeError):
                    errs.append(
                        f"{where}.resources.{kind}[{rname}]: "
                        f"invalid quantity {q!r}"
                    )
                else:
                    if len(_KNOWN_GOOD_QUANTITIES) < 4096:
                        _KNOWN_GOOD_QUANTITIES.add(q_s)
    if spec.get("restartPolicy", "Always") not in RESTART_POLICIES:
        errs.append(
            f"spec.restartPolicy: invalid {spec.get('restartPolicy')!r}"
        )
    if spec.get("preemptionPolicy", "") not in (
        "", PREEMPT_LOWER_PRIORITY, PREEMPT_NEVER
    ):
        errs.append(
            f"spec.preemptionPolicy: invalid {spec.get('preemptionPolicy')!r} "
            f"(want {PREEMPT_LOWER_PRIORITY} or {PREEMPT_NEVER})"
        )
    prio = spec.get("priority")
    if prio is not None:
        try:
            if abs(int(prio)) > MAX_PRIORITY:
                errs.append(
                    f"spec.priority: must be within ±{MAX_PRIORITY}"
                )
        except (TypeError, ValueError):
            errs.append(f"spec.priority: invalid {prio!r}")
    vol_names = set()
    for i, v in enumerate(spec.get("volumes") or []):
        vname = v.get("name", "")
        if not is_dns1123_label(vname):
            errs.append(f"spec.volumes[{i}].name: invalid {vname!r}")
        if vname in vol_names:
            errs.append(f"spec.volumes[{i}].name: duplicate {vname!r}")
        vol_names.add(vname)
    for c in containers:
        for m in c.get("volumeMounts") or []:
            if m.get("name") not in vol_names:
                errs.append(
                    f"volumeMounts: unknown volume {m.get('name')!r}"
                )
    if errs:
        raise ValidationError(errs)


def validate_pod(pod: Pod) -> None:
    from kubernetes_tpu_torch.models.apiobjects import (
        MAX_PRIORITY,
        PREEMPT_LOWER_PRIORITY,
        PREEMPT_NEVER,
    )

    errs: List[str] = []
    _validate_meta(pod.metadata, errs)
    _validate_containers(pod.spec.containers, errs)
    if pod.spec.restart_policy not in RESTART_POLICIES:
        errs.append(f"spec.restartPolicy: invalid {pod.spec.restart_policy!r}")
    if pod.spec.preemption_policy not in (
        "", PREEMPT_LOWER_PRIORITY, PREEMPT_NEVER
    ):
        # A typoed opt-out ("Nevr") must fail loudly, not silently
        # leave the pod preempt-capable (pod_can_preempt treats any
        # non-"Never" string as PreemptLowerPriority).
        errs.append(
            f"spec.preemptionPolicy: invalid {pod.spec.preemption_policy!r} "
            f"(want {PREEMPT_LOWER_PRIORITY} or {PREEMPT_NEVER})"
        )
    if pod.spec.priority is not None and abs(pod.spec.priority) > MAX_PRIORITY:
        errs.append(f"spec.priority: must be within ±{MAX_PRIORITY}")
    vol_names = set()
    for i, v in enumerate(pod.spec.volumes):
        if not is_dns1123_label(v.name):
            errs.append(f"spec.volumes[{i}].name: invalid {v.name!r}")
        if v.name in vol_names:
            errs.append(f"spec.volumes[{i}].name: duplicate {v.name!r}")
        vol_names.add(v.name)
    for c in pod.spec.containers:
        for m in c.volume_mounts:
            if m.name not in vol_names:
                errs.append(f"volumeMounts: unknown volume {m.name!r}")
    if errs:
        raise ValidationError(errs)


def validate_node(node: Node) -> None:
    errs: List[str] = []
    _validate_meta(node.metadata, errs, namespace_required=False)
    for k, q in (node.status.capacity or {}).items():
        if q.milli_value() < 0:
            errs.append(f"status.capacity[{k}]: must be nonnegative")
    if errs:
        raise ValidationError(errs)


def validate_service(svc: Service) -> None:
    errs: List[str] = []
    _validate_meta(svc.metadata, errs)
    if not svc.spec.ports:
        errs.append("spec.ports: required")
    for i, p in enumerate(svc.spec.ports):
        if not (0 < p.port < 65536):
            errs.append(f"spec.ports[{i}].port: invalid {p.port}")
        if p.protocol not in PROTOCOLS:
            errs.append(f"spec.ports[{i}].protocol: invalid {p.protocol!r}")
    if errs:
        raise ValidationError(errs)


def validate_replication_controller(rc: ReplicationController) -> None:
    errs: List[str] = []
    _validate_meta(rc.metadata, errs)
    if rc.spec.replicas < 0:
        errs.append("spec.replicas: must be nonnegative")
    if not rc.spec.selector:
        errs.append("spec.selector: required")
    tmpl = rc.spec.template
    if tmpl is None:
        errs.append("spec.template: required")
    else:
        labels = tmpl.metadata.labels or {}
        for k, v in rc.spec.selector.items():
            if labels.get(k) != v:
                errs.append(f"spec.template.metadata.labels: selector {k}={v} not matched")
        _validate_containers(tmpl.spec.containers, errs)
        if tmpl.spec.restart_policy != "Always":
            # Reference: RC templates must have RestartPolicy Always
            # (validation.go ValidateReplicationControllerSpec).
            errs.append("spec.template.spec.restartPolicy: must be Always")
    if errs:
        raise ValidationError(errs)


ACCESS_MODES = {"ReadWriteOnce", "ReadOnlyMany", "ReadWriteMany"}
RECLAIM_POLICIES = {"Retain", "Recycle", "Delete"}
LIMIT_TYPES = {"Pod", "Container"}


def validate_service_account(sa) -> None:
    errs: List[str] = []
    _validate_meta(sa.metadata, errs)
    if errs:
        raise ValidationError(errs)


def validate_limit_range(lr) -> None:
    """Reference: validation.go ValidateLimitRange — types unique, min<=max."""
    errs: List[str] = []
    _validate_meta(lr.metadata, errs)
    seen = set()
    for i, item in enumerate(lr.spec.limits):
        if item.type not in LIMIT_TYPES:
            errs.append(f"spec.limits[{i}].type: invalid {item.type!r}")
        if item.type in seen:
            errs.append(f"spec.limits[{i}].type: duplicate {item.type!r}")
        seen.add(item.type)
        for k, mn in (item.min or {}).items():
            mx = (item.max or {}).get(k)
            if mx is not None and mn.milli_value() > mx.milli_value():
                errs.append(f"spec.limits[{i}].min[{k}]: exceeds max")
    if errs:
        raise ValidationError(errs)


def validate_resource_quota(rq) -> None:
    errs: List[str] = []
    _validate_meta(rq.metadata, errs)
    for k, q in (rq.spec.hard or {}).items():
        if q.milli_value() < 0:
            errs.append(f"spec.hard[{k}]: must be nonnegative")
    if errs:
        raise ValidationError(errs)


def validate_persistent_volume(pv) -> None:
    """Reference: validation.go ValidatePersistentVolume."""
    errs: List[str] = []
    _validate_meta(pv.metadata, errs, namespace_required=False)
    if not pv.spec.capacity:
        errs.append("spec.capacity: required")
    if not pv.spec.access_modes:
        errs.append("spec.accessModes: required")
    for m in pv.spec.access_modes:
        if m not in ACCESS_MODES:
            errs.append(f"spec.accessModes: invalid {m!r}")
    if pv.spec.persistent_volume_reclaim_policy not in RECLAIM_POLICIES:
        errs.append(
            "spec.persistentVolumeReclaimPolicy: invalid "
            f"{pv.spec.persistent_volume_reclaim_policy!r}"
        )
    src = pv.spec.persistent_volume_source
    set_sources = [
        s
        for s in (
            src.host_path,
            src.gce_persistent_disk,
            src.aws_elastic_block_store,
            src.nfs,
            src.glusterfs,
            src.rbd,
            src.iscsi,
        )
        if s is not None
    ]
    if len(set_sources) != 1:
        errs.append("spec.persistentVolumeSource: exactly one source required")
    if errs:
        raise ValidationError(errs)


def validate_pod_group(pg) -> None:
    """Gang-scheduling group: minMember >= 1, maxMember (when set)
    covers minMember, timeout nonnegative."""
    errs: List[str] = []
    _validate_meta(pg.metadata, errs)
    if pg.spec.min_member < 1:
        errs.append("spec.minMember: must be >= 1")
    if pg.spec.max_member < 0:
        errs.append("spec.maxMember: must be nonnegative")
    elif pg.spec.max_member and pg.spec.max_member < pg.spec.min_member:
        errs.append("spec.maxMember: must cover spec.minMember")
    if pg.spec.schedule_timeout_seconds < 0:
        errs.append("spec.scheduleTimeoutSeconds: must be nonnegative")
    if errs:
        raise ValidationError(errs)


def validate_priority_class(pc) -> None:
    """PriorityClass: value within the user-definable band, policy one
    of the two enum values (empty = PreemptLowerPriority)."""
    from kubernetes_tpu_torch.models.apiobjects import (
        MAX_PRIORITY,
        PREEMPT_LOWER_PRIORITY,
        PREEMPT_NEVER,
    )

    errs: List[str] = []
    _validate_meta(pc.metadata, errs, namespace_required=False)
    if not isinstance(pc.value, int) or isinstance(pc.value, bool):
        errs.append("value: must be an integer")
    elif abs(pc.value) > MAX_PRIORITY:
        errs.append(f"value: must be within ±{MAX_PRIORITY}")
    if pc.preemption_policy not in ("", PREEMPT_LOWER_PRIORITY, PREEMPT_NEVER):
        errs.append(
            f"preemptionPolicy: invalid {pc.preemption_policy!r} "
            f"(want {PREEMPT_LOWER_PRIORITY} or {PREEMPT_NEVER})"
        )
    if errs:
        raise ValidationError(errs)


def validate_persistent_volume_claim(pvc) -> None:
    errs: List[str] = []
    _validate_meta(pvc.metadata, errs)
    if not pvc.spec.access_modes:
        errs.append("spec.accessModes: required")
    for m in pvc.spec.access_modes:
        if m not in ACCESS_MODES:
            errs.append(f"spec.accessModes: invalid {m!r}")
    req = pvc.spec.resources.requests or pvc.spec.resources.limits
    if "storage" not in req:
        errs.append("spec.resources: storage request required")
    if errs:
        raise ValidationError(errs)
