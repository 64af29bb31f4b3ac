"""Admission control: mutate/deny requests after authn/authz, before
storage.

Behavioral parity with the reference's admission framework
(pkg/admission/: Interface, chain.go, plugins.go) and the standard
plugin set (plugin/pkg/admission/): AlwaysAdmit, AlwaysDeny,
LimitRanger, NamespaceAutoprovision, NamespaceExists,
NamespaceLifecycle, ResourceQuota, ServiceAccount,
SecurityContextDeny, DenyExecOnPrivileged.

Plugins see wire-form dicts (the apiserver's storage currency) and may
mutate them in place (LimitRanger defaulting, ServiceAccount
defaulting) or raise AdmissionError to reject (HTTP 403, matching the
reference's apiserver.errToAPIStatus forbidden mapping).

A copy of `kubernetes_tpu/server/admission.py`: every plugin, from
`AlwaysAdmit` to `DenyExecOnPrivileged`, and `new_from_plugins`.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch.models.quantity import Quantity, parse_quantity

CREATE = "CREATE"
UPDATE = "UPDATE"
DELETE = "DELETE"
CONNECT = "CONNECT"


class AdmissionError(Exception):
    """Rejection; surfaces as HTTP 403 Forbidden (or the plugin's code,
    e.g. 404 NotFound from the namespace plugins)."""

    def __init__(self, message: str, code: int = 403):
        super().__init__(message)
        self.code = code
        self.message = message
        self.reason = {404: "NotFound", 409: "Conflict"}.get(code, "Forbidden")


@dataclass
class Attributes:
    """Reference: pkg/admission/attributes.go."""

    operation: str  # CREATE | UPDATE | DELETE | CONNECT
    resource: str  # plural REST name, e.g. "pods"
    namespace: str = ""
    name: str = ""
    subresource: str = ""
    obj: Optional[dict] = None  # wire form; None for DELETE


class Interface:
    """A single admission plugin (pkg/admission/interfaces.go)."""

    def handles(self, operation: str) -> bool:
        return True

    def admit(self, attrs: Attributes) -> None:  # may mutate attrs.obj
        raise NotImplementedError

    def commit(self, attrs: Attributes) -> None:
        """Called after the store write succeeded (best-effort hook for
        usage bookkeeping); must not raise."""
        return None


class Chain(list):
    """Ordered plugin list; first rejection wins (pkg/admission/chain.go)."""

    def admit(self, attrs: Attributes) -> None:
        for plugin in self:
            if plugin.handles(attrs.operation):
                plugin.admit(attrs)

    def commit(self, attrs: Attributes) -> None:
        for plugin in self:
            if plugin.handles(attrs.operation):
                plugin.commit(attrs)


# -- plugin registry (pkg/admission/plugins.go) -----------------------------

_PLUGINS: Dict[str, Callable] = {}
_plugins_lock = threading.Lock()


def register_plugin(name: str, factory: Callable) -> None:
    with _plugins_lock:
        if name in _PLUGINS:
            raise ValueError(f"admission plugin {name!r} already registered")
        _PLUGINS[name] = factory


def new_from_plugins(api, names: List[str]) -> Chain:
    """Instantiate a chain from plugin names (--admission-control flag,
    cmd/kube-apiserver/app/server.go:184)."""
    chain = Chain()
    for name in names:
        factory = _PLUGINS.get(name)
        if factory is None:
            raise ValueError(f"unknown admission plugin {name!r}")
        chain.append(factory(api))
    return chain


# -- helpers ----------------------------------------------------------------


def _pod_resource_total(pod: dict, key: str) -> Quantity:
    """Sum a resource across containers (limits, falling back to requests)."""
    total = 0
    for c in pod.get("spec", {}).get("containers", []):
        res = c.get("resources", {})
        v = (res.get("limits") or {}).get(key) or (res.get("requests") or {}).get(key)
        if v:
            total += parse_quantity(v).milli_value()
    return Quantity.from_milli(total)


# -- plugins ----------------------------------------------------------------


class AlwaysAdmit(Interface):
    """plugin/pkg/admission/admit."""

    def admit(self, attrs: Attributes) -> None:
        return None


class AlwaysDeny(Interface):
    """plugin/pkg/admission/deny."""

    def admit(self, attrs: Attributes) -> None:
        raise AdmissionError("admission plugin AlwaysDeny rejected the request")


class NamespaceExists(Interface):
    """Reject requests in namespaces that do not exist
    (plugin/pkg/admission/namespace/exists)."""

    def __init__(self, api):
        self.api = api

    def handles(self, operation: str) -> bool:
        return operation in (CREATE, UPDATE, DELETE)

    def admit(self, attrs: Attributes) -> None:
        if not attrs.namespace or attrs.resource == "namespaces":
            return
        from kubernetes_tpu_torch.server.api import APIError

        try:
            self.api.get("namespaces", "", attrs.namespace)
        except APIError:
            raise AdmissionError(f"namespace {attrs.namespace!r} does not exist", 404)


class NamespaceAutoprovision(Interface):
    """Create the namespace on first use
    (plugin/pkg/admission/namespace/autoprovision)."""

    def __init__(self, api):
        self.api = api

    def handles(self, operation: str) -> bool:
        return operation == CREATE

    def admit(self, attrs: Attributes) -> None:
        if not attrs.namespace or attrs.resource == "namespaces":
            return
        from kubernetes_tpu_torch.server.api import APIError

        try:
            self.api.get("namespaces", "", attrs.namespace)
        except APIError:
            try:
                self.api.create(
                    "namespaces", "", {"metadata": {"name": attrs.namespace}}
                )
            except APIError as e:
                if e.code != 409:  # racing creator won: fine
                    raise


class NamespaceLifecycle(Interface):
    """Reject creates in missing or Terminating namespaces
    (plugin/pkg/admission/namespace/lifecycle)."""

    def __init__(self, api):
        self.api = api

    def handles(self, operation: str) -> bool:
        return operation == CREATE

    def admit(self, attrs: Attributes) -> None:
        if not attrs.namespace or attrs.resource == "namespaces":
            return
        from kubernetes_tpu_torch.server.api import APIError

        try:
            ns = self.api.get("namespaces", "", attrs.namespace)
        except APIError:
            raise AdmissionError(f"namespace {attrs.namespace!r} does not exist", 404)
        if ns.get("status", {}).get("phase") == "Terminating":
            raise AdmissionError(
                f"namespace {attrs.namespace!r} is terminating; "
                f"cannot create {attrs.resource}"
            )


class LimitRanger(Interface):
    """Apply container defaults and enforce min/max from LimitRange
    objects (plugin/pkg/admission/limitranger/admission.go)."""

    def __init__(self, api):
        self.api = api

    def handles(self, operation: str) -> bool:
        return operation in (CREATE, UPDATE)

    def admit(self, attrs: Attributes) -> None:
        if attrs.resource != "pods" or attrs.obj is None:
            return
        items = self.api.list("limitranges", attrs.namespace)["items"]
        for lr in items:
            for limit in lr.get("spec", {}).get("limits", []):
                if limit.get("type", "Container") == "Container":
                    self._apply_container_limit(limit, attrs.obj)
                elif limit.get("type") == "Pod":
                    self._check_pod_limit(limit, attrs.obj)

    def _apply_container_limit(self, limit: dict, pod: dict) -> None:
        defaults = limit.get("default", {})
        mins = limit.get("min", {})
        maxes = limit.get("max", {})
        for c in pod.get("spec", {}).get("containers", []):
            res = c.setdefault("resources", {})
            limits = res.setdefault("limits", {})
            for key, v in defaults.items():
                limits.setdefault(key, v)
            for key, mn in mins.items():
                have = limits.get(key)
                if have and parse_quantity(have).milli_value() < parse_quantity(
                    mn
                ).milli_value():
                    raise AdmissionError(
                        f"minimum {key} usage per Container is {mn}; "
                        f"container {c.get('name')!r} requests {have}"
                    )
            for key, mx in maxes.items():
                have = limits.get(key)
                if have and parse_quantity(have).milli_value() > parse_quantity(
                    mx
                ).milli_value():
                    raise AdmissionError(
                        f"maximum {key} usage per Container is {mx}; "
                        f"container {c.get('name')!r} requests {have}"
                    )

    def _check_pod_limit(self, limit: dict, pod: dict) -> None:
        for key, mx in (limit.get("max") or {}).items():
            total = _pod_resource_total(pod, key)
            if total.milli_value() > parse_quantity(mx).milli_value():
                raise AdmissionError(
                    f"maximum {key} usage per Pod is {mx}; total requested {total}"
                )
        for key, mn in (limit.get("min") or {}).items():
            total = _pod_resource_total(pod, key)
            if total.milli_value() and total.milli_value() < parse_quantity(
                mn
            ).milli_value():
                raise AdmissionError(
                    f"minimum {key} usage per Pod is {mn}; total requested {total}"
                )


# Hard-limit keys a ResourceQuota can carry for object counts
# (reference: pkg/api/types.go ResourceQuota resource names). Shared
# with the ResourceQuotaManager backstop controller — one list, one
# definition of "countable".
COUNTED_RESOURCES = frozenset(
    {
        "pods",
        "services",
        "replicationcontrollers",
        "secrets",
        "persistentvolumeclaims",
        "resourcequotas",
    }
)


class ResourceQuotaAdmission(Interface):
    """Enforce namespace ResourceQuota hard limits and keep
    status.used current (plugin/pkg/admission/resourcequota).

    The apiserver serializes admission with the store write (see
    APIServer create/update/delete), so the check-then-act here cannot
    race another writer past a hard limit."""

    def __init__(self, api):
        self.api = api

    def handles(self, operation: str) -> bool:
        return operation in (CREATE, UPDATE, DELETE)

    def admit(self, attrs: Attributes) -> None:
        """Enforce only; no status writes here. A rejected (or later
        failing) request must leave quota status untouched — recording
        happens in commit() after the store write lands."""
        if not attrs.namespace or attrs.resource == "resourcequotas":
            return
        for quota in self.api.list("resourcequotas", attrs.namespace)["items"]:
            hard = quota.get("spec", {}).get("hard", {})
            if self._relevant(hard, attrs):
                self._enforce(hard, attrs)

    def commit(self, attrs: Attributes) -> None:
        """Post-write: recompute used from the store (now exact — the
        write already landed) and persist it when it changed."""
        if not attrs.namespace or attrs.resource == "resourcequotas":
            return
        from kubernetes_tpu_torch.server.api import APIError

        for quota in self.api.list("resourcequotas", attrs.namespace)["items"]:
            hard = quota.get("spec", {}).get("hard", {})
            if not self._relevant(hard, attrs):
                continue
            used = self._usage(attrs.namespace, hard)
            if used == quota.get("status", {}).get("used", {}):
                continue  # unchanged: skip the write, don't wake watchers
            try:
                self.api.update_status(
                    "resourcequotas",
                    attrs.namespace,
                    quota["metadata"]["name"],
                    {"status": {"hard": dict(hard), "used": used}},
                )
            except APIError:
                pass  # backstop controller reconciles

    @staticmethod
    def _relevant(hard: dict, attrs: Attributes) -> bool:
        """Skip quotas that track nothing this request touches."""
        if attrs.resource in hard and attrs.resource in COUNTED_RESOURCES:
            return True
        return attrs.resource == "pods" and ("cpu" in hard or "memory" in hard)

    def _usage(self, namespace: str, hard: dict) -> dict:
        used: Dict[str, str] = {}
        pods = None
        for key in hard:
            if key in COUNTED_RESOURCES:
                n = len(self.api.list(key, namespace)["items"])
                used[key] = str(n)
            elif key in ("cpu", "memory"):
                if pods is None:
                    pods = self.api.list("pods", namespace)["items"]
                total = 0
                for pod in pods:
                    total += _pod_resource_total(pod, key).milli_value()
                used[key] = str(Quantity.from_milli(total))
        return used

    def _old_pod_total(self, attrs: Attributes, key: str) -> int:
        """Milli-total of `key` in the stored version of attrs' pod (for
        UPDATE/DELETE deltas); 0 when it doesn't exist."""
        from kubernetes_tpu_torch.server.api import APIError

        try:
            old = self.api.get("pods", attrs.namespace, attrs.name)
        except APIError:
            return 0
        return _pod_resource_total(old, key).milli_value()

    def _enforce(self, hard: dict, attrs: Attributes) -> None:
        # `used` reflects the store BEFORE this request's write lands.
        used = self._usage(attrs.namespace, hard)
        counted = attrs.resource in hard and attrs.resource in COUNTED_RESOURCES
        if attrs.operation == CREATE and counted:
            if int(used[attrs.resource]) + 1 > parse_quantity(
                hard[attrs.resource]
            ).value():
                raise AdmissionError(
                    f"limited to {hard[attrs.resource]} {attrs.resource}", 403
                )
        if attrs.resource == "pods":
            for key in ("cpu", "memory"):
                if key not in hard:
                    continue
                if attrs.operation == CREATE and attrs.obj is not None:
                    delta = _pod_resource_total(attrs.obj, key).milli_value()
                elif attrs.operation == UPDATE and attrs.obj is not None:
                    delta = _pod_resource_total(
                        attrs.obj, key
                    ).milli_value() - self._old_pod_total(attrs, key)
                else:
                    continue  # deletes only shrink usage
                have = parse_quantity(used[key]).milli_value()
                cap = parse_quantity(hard[key]).milli_value()
                if delta > 0 and have + delta > cap:
                    raise AdmissionError(
                        f"{key} quota exceeded: used {used[key]}, "
                        f"requested {Quantity.from_milli(delta)}, "
                        f"hard limit {hard[key]}"
                    )


class ServiceAccountAdmission(Interface):
    """Default pods to the 'default' ServiceAccount and require the
    referenced account to exist (plugin/pkg/admission/serviceaccount)."""

    def __init__(self, api, require_account: bool = False):
        self.api = api
        self.require_account = require_account

    def handles(self, operation: str) -> bool:
        return operation == CREATE

    # Where every container sees its API credential (the reference's
    # DefaultAPITokenMountPath, plugin/pkg/admission/serviceaccount).
    TOKEN_MOUNT_PATH = "/var/run/secrets/kubernetes.io/serviceaccount"

    def admit(self, attrs: Attributes) -> None:
        if attrs.resource != "pods" or attrs.obj is None:
            return
        spec = attrs.obj.setdefault("spec", {})
        if not spec.get("serviceAccount"):
            spec["serviceAccount"] = "default"
        if self.require_account:
            from kubernetes_tpu_torch.server.api import APIError

            try:
                self.api.get("serviceaccounts", attrs.namespace, spec["serviceAccount"])
            except APIError:
                raise AdmissionError(
                    f"service account {attrs.namespace}/{spec['serviceAccount']} "
                    "does not exist"
                )
        self._mount_api_token(attrs.namespace, spec)

    def _mount_api_token(self, namespace: str, spec: dict) -> None:
        """Mount the account's token Secret (minted by the Token
        controller) into every container at the well-known path —
        reference admission.go mountServiceAccountToken. Soft-fails
        when the account or its token doesn't exist yet: the plugin
        must not block pods during controller warm-up."""
        from kubernetes_tpu_torch.server.api import APIError

        try:
            sa = self.api.get("serviceaccounts", namespace, spec["serviceAccount"])
        except APIError:
            return
        token_secret = None
        for ref in sa.get("secrets") or []:
            name = ref.get("name", "")
            try:
                sec = self.api.get("secrets", namespace, name)
            except APIError:
                continue
            if sec.get("type") == "kubernetes.io/service-account-token":
                token_secret = name
                break
        if token_secret is None:
            return
        volumes = spec.setdefault("volumes", [])
        vol_name = next(
            (
                v["name"]
                for v in volumes
                if (v.get("secret") or {}).get("secretName") == token_secret
            ),
            None,
        )
        if vol_name is None:
            vol_name = token_secret
            if any(v.get("name") == vol_name for v in volumes):
                vol_name = f"{token_secret}-sa"
            volumes.append(
                {"name": vol_name, "secret": {"secretName": token_secret}}
            )
        for c in spec.get("containers") or []:
            mounts = c.setdefault("volumeMounts", [])
            if any(m.get("mountPath") == self.TOKEN_MOUNT_PATH for m in mounts):
                continue
            mounts.append(
                {
                    "name": vol_name,
                    "mountPath": self.TOKEN_MOUNT_PATH,
                    "readOnly": True,
                }
            )


class PodGroupAdmission(Interface):
    """Reject pods referencing unknown or oversized PodGroups (the
    gang-scheduling admission gate; no reference analog — follows the
    sig-scheduling coscheduling controller's membership rules).

    A pod labeled with POD_GROUP_LABEL must name a PodGroup in its own
    namespace, and when the group declares spec.maxMember, admitting
    the pod must not push membership past it — an oversized group can
    never gang-place atomically and would pin the whole group Pending.
    UPDATE/PATCH is gated too (joining a gang by relabeling an existing
    pod is the same membership change); updates that leave the label
    untouched pass without re-checking."""

    def __init__(self, api):
        self.api = api

    def handles(self, operation: str) -> bool:
        return operation in (CREATE, UPDATE)

    def admit(self, attrs: Attributes) -> None:
        if attrs.resource != "pods" or attrs.obj is None:
            return
        from kubernetes_tpu_torch.models.apiobjects import POD_GROUP_LABEL
        from kubernetes_tpu_torch.server.api import APIError

        group = (
            attrs.obj.get("metadata", {}).get("labels", {}) or {}
        ).get(POD_GROUP_LABEL, "")
        if not group:
            # Unlabeled (or label-removing) writes always admit — and
            # this is every ordinary pod UPDATE in the cluster, so it
            # must return before any store fetch.
            return
        if attrs.operation == UPDATE:
            try:
                old = self.api.get("pods", attrs.namespace, attrs.name)
            except APIError:
                old = {}
            old_group = (
                old.get("metadata", {}).get("labels", {}) or {}
            ).get(POD_GROUP_LABEL, "")
            if group == old_group:
                return  # membership unchanged: nothing to vet
        try:
            pg = self.api.get("podgroups", attrs.namespace, group)
        except APIError:
            raise AdmissionError(
                f"pod group {attrs.namespace}/{group} does not exist", 404
            )
        max_member = int(pg.get("spec", {}).get("maxMember", 0) or 0)
        if not max_member:
            return
        # Live members only: terminated pods (Succeeded/Failed) and
        # pods being deleted no longer occupy a gang slot — counting
        # them would permanently reject replacements for crashed
        # members and wedge the gang below minMember. The pod being
        # admitted never counts itself (relevant on relabel-updates).
        # copy=False: the list is counted and discarded — a full
        # deep copy of the namespace's pods under the admission lock
        # would stall every concurrent write for nothing.
        members = sum(
            1
            for p in self.api.list(
                "pods", attrs.namespace,
                label_selector=f"{POD_GROUP_LABEL}={group}",
                copy=False,
            )["items"]
            if p.get("metadata", {}).get("name") != attrs.name
            and p.get("status", {}).get("phase") not in ("Succeeded", "Failed")
            and not p.get("metadata", {}).get("deletionTimestamp")
        )
        if members + 1 > max_member:
            raise AdmissionError(
                f"pod group {attrs.namespace}/{group} is full "
                f"({members} live members, maxMember {max_member})"
            )


class PriorityAdmission(Interface):
    """Resolve and freeze pod priority (no analog in this reference
    tree; follows the later reference's Priority admission plugin).

    CREATE: a pod naming spec.priorityClassName gets spec.priority and
    spec.preemptionPolicy copied from the class (unknown class: 404);
    a pod naming none inherits the globalDefault class (highest value
    wins when several are marked) or priority 0. A caller-supplied
    spec.priority must agree with the resolved value — priority comes
    from classes, never free-form.

    UPDATE: priorityClassName/priority/preemptionPolicy are immutable
    (a priority bump would silently re-rank a queued pod past peers
    that were admitted under the old value); omitted fields carry over
    from the stored pod so status-ish full updates keep passing."""

    _FROZEN = ("priorityClassName", "priority", "preemptionPolicy")

    def __init__(self, api):
        self.api = api

    def handles(self, operation: str) -> bool:
        return operation in (CREATE, UPDATE)

    def _default_class(self) -> Optional[dict]:
        best = None
        for pc in self.api.list("priorityclasses", "", copy=False)["items"]:
            if not pc.get("globalDefault"):
                continue
            if best is None or int(pc.get("value", 0)) > int(best.get("value", 0)):
                best = pc
        return best

    def admit(self, attrs: Attributes) -> None:
        if attrs.resource != "pods" or attrs.obj is None:
            return
        spec = attrs.obj.setdefault("spec", {})
        if attrs.operation == UPDATE:
            from kubernetes_tpu_torch.server.api import APIError

            try:
                old = self.api.get("pods", attrs.namespace, attrs.name)
            except APIError:
                return  # racing delete: the update will 404 on its own
            old_spec = old.get("spec", {})
            for field_ in self._FROZEN:
                if field_ not in spec or spec[field_] in ("", None):
                    if field_ in old_spec:
                        spec[field_] = old_spec[field_]
                elif spec[field_] != old_spec.get(field_):
                    # Compare against the STORED value (None when the
                    # pod never had one) — defaulting to the new value
                    # would let any update grant itself arbitrary
                    # priority after creation.
                    raise AdmissionError(
                        f"spec.{field_} is immutable "
                        f"(was {old_spec.get(field_)!r})"
                    )
            return
        name = spec.get("priorityClassName", "")
        if name:
            from kubernetes_tpu_torch.server.api import APIError

            try:
                pc = self.api.get("priorityclasses", "", name)
            except APIError:
                raise AdmissionError(
                    f"priority class {name!r} does not exist", 404
                )
        else:
            pc = self._default_class()
        value = int(pc.get("value", 0)) if pc else 0
        supplied = spec.get("priority")
        if supplied is not None and int(supplied) != value:
            raise AdmissionError(
                f"spec.priority {supplied} conflicts with priority class "
                f"value {value}; priority is resolved from "
                "priorityClassName, not set directly"
            )
        if pc:
            spec["priorityClassName"] = pc["metadata"]["name"]
            spec["priority"] = value
            policy = pc.get("preemptionPolicy", "")
            if policy:
                spec["preemptionPolicy"] = policy
        elif supplied is not None:
            spec["priority"] = 0


class SecurityContextDeny(Interface):
    """Reject pods that request privileged mode, added capabilities, or
    custom SELinux/RunAsUser options
    (plugin/pkg/admission/securitycontext/scdeny)."""

    def handles(self, operation: str) -> bool:
        return operation in (CREATE, UPDATE)

    def admit(self, attrs: Attributes) -> None:
        if attrs.resource != "pods" or attrs.obj is None:
            return
        for c in attrs.obj.get("spec", {}).get("containers", []):
            sc = c.get("securityContext") or {}
            if sc.get("privileged"):
                raise AdmissionError(
                    f"container {c.get('name')!r}: privileged mode is forbidden"
                )
            if (sc.get("capabilities") or {}).get("add"):
                raise AdmissionError(
                    f"container {c.get('name')!r}: added capabilities are forbidden"
                )
            if sc.get("seLinuxOptions") or sc.get("runAsUser") is not None:
                raise AdmissionError(
                    f"container {c.get('name')!r}: SecurityContext overrides "
                    "are forbidden"
                )


class DenyExecOnPrivileged(Interface):
    """Deny exec/attach on pods with privileged containers
    (plugin/pkg/admission/exec)."""

    def __init__(self, api):
        self.api = api

    def handles(self, operation: str) -> bool:
        return operation == CONNECT

    def admit(self, attrs: Attributes) -> None:
        if attrs.resource != "pods" or attrs.subresource not in ("exec", "attach"):
            return
        from kubernetes_tpu_torch.server.api import APIError

        try:
            pod = self.api.get("pods", attrs.namespace, attrs.name)
        except APIError:
            return
        for c in pod.get("spec", {}).get("containers", []):
            if (c.get("securityContext") or {}).get("privileged"):
                raise AdmissionError(
                    "cannot exec into or attach to a privileged container"
                )


register_plugin("AlwaysAdmit", lambda api: AlwaysAdmit())
register_plugin("AlwaysDeny", lambda api: AlwaysDeny())
register_plugin("NamespaceExists", NamespaceExists)
register_plugin("NamespaceAutoProvision", NamespaceAutoprovision)
register_plugin("NamespaceLifecycle", NamespaceLifecycle)
register_plugin("LimitRanger", LimitRanger)
register_plugin("ResourceQuota", ResourceQuotaAdmission)
register_plugin("ServiceAccount", ServiceAccountAdmission)
register_plugin("PodGroup", PodGroupAdmission)
register_plugin("Priority", PriorityAdmission)
register_plugin("SecurityContextDeny", lambda api: SecurityContextDeny())
register_plugin("DenyExecOnPrivileged", DenyExecOnPrivileged)
