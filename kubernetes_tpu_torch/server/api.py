"""Transport-independent API server core.

REST verbs (create/get/list/update/delete/watch) with the reference's
semantics (pkg/apiserver/resthandler.go):

- create: defaulting (uid, creationTimestamp, namespace, generateName),
  validation, AlreadyExists on duplicates.
- update: CAS when the client supplies metadata.resourceVersion,
  last-write-wins when it doesn't (reference allows both).
- list/watch: label & field selector filtering; lists carry the store
  version so watches can resume exactly after them.
- bind: the parity-critical guarded write — pod.spec.nodeName is set
  iff currently empty (pkg/registry/pod/etcd/etcd.go:123-181).
- update_status: status subresource writes that preserve spec.

All objects cross this boundary in wire form (camelCase dicts); typed
callers use the client layer.

A copy of `kubernetes_tpu/server/api.py` on a plain reentrant lock
(no lock sanitizer). `replication` and `leader_url` are the HA plane's
handles (`store/replication.py`, read by `server/httpserver.py`).
`APIServer.__init__` attaches the port's lifecycle SLI collector
(`utils/sli.py`) to its store, as JAX's does.
"""

from __future__ import annotations

import contextlib
import json
import logging
import random
import string
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from kubernetes_tpu_torch.models import labels as labelpkg
from kubernetes_tpu_torch.models import serde
from kubernetes_tpu_torch.models.objects import new_uid, now_iso
from kubernetes_tpu_torch.models.validation import ValidationError
from kubernetes_tpu_torch.server.allocators import (
    AllocationError,
    IPAllocator,
    PortAllocator,
    service_ips_in_use,
    service_node_ports_in_use,
)
from kubernetes_tpu_torch.server.registry import RESOURCES, ResourceInfo, fields_for
from kubernetes_tpu_torch.store import (
    AlreadyExistsError,
    ConflictError,
    KVStore,
    NotFoundError,
)
from kubernetes_tpu_torch.store.watch import WatchStream

_LOG = logging.getLogger("kubernetes_tpu_torch.apiserver")

#: Default grace for the eviction subresource when the Eviction body
#: names none (reference: 30s pod default, scaled to this codebase's
#: test-sized clusters).
DEFAULT_EVICTION_GRACE_SECONDS = 5


class APIError(Exception):
    def __init__(self, code: int, reason: str, message: str):
        self.code = code
        self.reason = reason
        self.message = message
        super().__init__(message)

    def to_status(self) -> dict:
        return {
            "kind": "Status",
            "apiVersion": "v1",
            "status": "Failure",
            "reason": self.reason,
            "message": self.message,
            "code": self.code,
        }


def _pod_node_name(obj: dict) -> str:
    """Shared shard extractor: equal shards must hash together, so this
    is THE module-level callable for pod spec.nodeName routing."""
    return obj.get("spec", {}).get("nodeName", "") or ""


_SHARD_FIELDS = {("pods", "spec.nodeName"): _pod_node_name}


def _watch_shard(resource: str, field_selector: str):
    """Derive a dispatch-routing shard from a watch's field selector:
    an exact-equality clause on an indexed field (pods' spec.nodeName —
    the kubelet/scheduler watch shape) lets the store skip this
    watcher for events that can't concern it. Conservative: any parse
    surprise returns None (unindexed, full fan-out)."""
    if not field_selector:
        return None
    try:
        fsel = labelpkg.parse_fields(field_selector)
    except ValueError:
        return None
    for key, op, value in fsel.requirements:
        if op == labelpkg.EQUALS:
            fn = _SHARD_FIELDS.get((resource, key))
            if fn is not None:
                return (fn, value)
    return None


def _not_found(resource: str, name: str) -> APIError:
    return APIError(404, "NotFound", f'{resource} "{name}" not found')


def _conflict(msg: str) -> APIError:
    return APIError(409, "Conflict", msg)


def _invalid(msg: str) -> APIError:
    return APIError(422, "Invalid", msg)


def _json_merge(target: dict, patch: dict) -> dict:
    """RFC 7386 JSON merge patch: null deletes, dicts merge
    recursively, everything else replaces."""
    out = dict(target)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        elif isinstance(v, dict):
            # Merge into the existing dict, or into {} when the target
            # key is absent/non-dict — RFC 7386 strips nulls either way
            # (storing a literal null would make the key 'exist' and
            # break later null-delete semantics).
            base = out.get(k)
            out[k] = _json_merge(base if isinstance(base, dict) else {}, v)
        else:
            out[k] = v
    return out


def _json_pointer_parts(pointer: str) -> List[str]:
    """RFC 6901: '/a/b~1c/0' -> ['a', 'b/c', '0']."""
    if pointer == "":
        return []
    if not pointer.startswith("/"):
        raise _bad_request(f"invalid JSON pointer {pointer!r}")
    return [
        p.replace("~1", "/").replace("~0", "~")
        for p in pointer[1:].split("/")
    ]


def _json_patch(doc: dict, ops: list) -> dict:
    """RFC 6902 JSON patch: ordered add/remove/replace/move/copy/test
    over JSON pointers (the reference PATCH handler's JSONPatchType,
    pkg/apiserver/resthandler.go:446)."""
    import copy as _copy

    doc = _copy.deepcopy(doc)

    def resolve(pointer):
        """-> (container, final_token). Container is a dict or list.
        RFC 6902 resolution never auto-creates intermediates: 'add'
        (and move/copy targets) MUST fail when the parent container
        does not exist — matching evanphx/json-patch, which the
        reference vendors."""
        parts = _json_pointer_parts(pointer)
        if not parts:
            raise _bad_request("operations on the root document are not supported")
        cur = doc
        for p in parts[:-1]:
            if isinstance(cur, list):
                try:
                    cur = cur[int(p)]
                except (ValueError, IndexError):
                    raise _bad_request(f"pointer {pointer!r}: bad index {p!r}")
            elif isinstance(cur, dict):
                if p not in cur:
                    raise _bad_request(f"pointer {pointer!r}: missing {p!r}")
                cur = cur[p]
            else:
                raise _bad_request(f"pointer {pointer!r}: {p!r} is a scalar")
        return cur, parts[-1]

    def get_at(pointer):
        cont, tok = resolve(pointer)
        if isinstance(cont, list):
            try:
                return cont[int(tok)]
            except (ValueError, IndexError):
                raise _bad_request(f"pointer {pointer!r}: bad index")
        if tok not in cont:
            raise _bad_request(f"pointer {pointer!r}: missing {tok!r}")
        return cont[tok]

    def add_at(pointer, value):
        cont, tok = resolve(pointer)
        if isinstance(cont, list):
            if tok == "-":
                cont.append(value)
            else:
                try:
                    i = int(tok)
                except ValueError:
                    raise _bad_request(f"pointer {pointer!r}: bad index")
                if not 0 <= i <= len(cont):
                    raise _bad_request(f"pointer {pointer!r}: index out of range")
                cont.insert(i, value)
        else:
            cont[tok] = value

    def remove_at(pointer):
        cont, tok = resolve(pointer)
        if isinstance(cont, list):
            try:
                return cont.pop(int(tok))
            except (ValueError, IndexError):
                raise _bad_request(f"pointer {pointer!r}: bad index")
        if tok not in cont:
            raise _bad_request(f"pointer {pointer!r}: missing {tok!r}")
        return cont.pop(tok)

    for op in ops:
        if not isinstance(op, dict) or "op" not in op or "path" not in op:
            raise _bad_request("each patch op needs 'op' and 'path'")
        kind, path = op["op"], op["path"]
        if kind == "add":
            add_at(path, _copy.deepcopy(op.get("value")))
        elif kind == "replace":
            remove_at(path)
            add_at(path, _copy.deepcopy(op.get("value")))
        elif kind == "remove":
            remove_at(path)
        elif kind == "move":
            add_at(path, remove_at(op.get("from", "")))
        elif kind == "copy":
            add_at(path, _copy.deepcopy(get_at(op.get("from", ""))))
        elif kind == "test":
            if get_at(path) != op.get("value"):
                raise APIError(
                    409, "Conflict", f"test failed at {path!r}"
                )
        else:
            raise _bad_request(f"unknown patch op {kind!r}")
    return doc


#: Strategic-merge list merge keys, keyed on the FIELD NAME the list
#: lives under — mirroring the reference's per-field struct tags
#: consumed by pkg/util/strategicpatch (`patchMergeKey`), not a global
#: candidate order. Container ports must merge by containerPort even
#: when every element also carries a name: a patch entry reusing a
#: name with a new containerPort APPENDS in the reference (distinct
#: merge-key value) rather than updating in place.
_FIELD_MERGE_KEYS: Dict[str, Tuple[str, ...]] = {
    "containers": ("name",),
    "env": ("name",),
    "volumes": ("name",),
    "imagePullSecrets": ("name",),
    "volumeMounts": ("mountPath",),
    # Container ports merge by containerPort; Service ports (same
    # field name, no containerPort on the elements) by port.
    "ports": ("containerPort", "port"),
    # Two element shapes share this field name: Endpoints subset
    # addresses (keyed by ip, pkg/api/types.go EndpointAddress) and
    # NodeStatus addresses (keyed by type, NodeAddress has no ip
    # field) — candidates in struct-tag order, first present wins.
    "addresses": ("ip", "type"),
    "conditions": ("type",),
    "secrets": ("name",),
}
#: Fallback candidates for lists under fields with no registered tag.
_STRATEGIC_MERGE_KEYS = ("name", "containerPort", "port", "mountPath", "type", "ip")


def _strategic_key_for(items: list, field: Optional[str] = None) -> Optional[str]:
    if not items or not all(isinstance(x, dict) for x in items):
        return None
    candidates = _FIELD_MERGE_KEYS.get(field) if field else None
    for key in candidates if candidates else _STRATEGIC_MERGE_KEYS:
        if all(key in x for x in items):
            return key
    return None


def _strategic_merge(target: dict, patch: dict) -> dict:
    """Strategic merge patch (pkg/util/strategicpatch): like RFC 7386
    but lists of objects MERGE element-wise by their merge key instead
    of replacing wholesale; a '$patch': 'delete' element removes its
    match, '$patch': 'replace' in a dict replaces it wholesale."""
    if patch.get("$patch") == "replace":
        out = {k: v for k, v in patch.items() if k != "$patch"}
        return out
    out = dict(target)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        elif isinstance(v, dict):
            base = out.get(k)
            out[k] = _strategic_merge(base if isinstance(base, dict) else {}, v)
        elif isinstance(v, list):
            base = out.get(k)
            key = _strategic_key_for(
                [x for x in v if isinstance(x, dict) and x.get("$patch") != "delete"],
                field=k,
            ) or _strategic_key_for(base if isinstance(base, list) else [], field=k)
            if key is None or not isinstance(base, list):
                out[k] = [
                    x for x in v
                    if not (isinstance(x, dict) and x.get("$patch") == "delete")
                ]
                continue
            merged = list(base)
            index = {
                x.get(key): i
                for i, x in enumerate(merged)
                if isinstance(x, dict)
            }
            for item in v:
                if not isinstance(item, dict) or key not in item:
                    # A $patch directive MUST carry the list's merge
                    # key (reference strategicpatch errors likewise);
                    # appending it raw would persist the directive
                    # into the stored object and skip the delete.
                    if isinstance(item, dict) and "$patch" in item:
                        raise _bad_request(
                            f"strategic patch directive in {k!r} lacks "
                            f"merge key {key!r}"
                        )
                    merged.append(item)
                    continue
                i = index.get(item[key])
                if item.get("$patch") == "delete":
                    if i is not None:
                        merged[i] = None  # compact below
                    continue
                if i is None:
                    merged.append(item)
                    index[item[key]] = len(merged) - 1
                else:
                    merged[i] = _strategic_merge(
                        merged[i] if isinstance(merged[i], dict) else {}, item
                    )
            out[k] = [x for x in merged if x is not None]
        else:
            out[k] = v
    return out


def _bad_request(msg: str) -> APIError:
    return APIError(400, "BadRequest", msg)


class APIServer:
    """The master: storage-backed REST resources (pkg/master/master.go)."""

    def __init__(
        self,
        store: Optional[KVStore] = None,
        admission=None,
        service_cidr: str = "10.0.0.0/24",
        node_port_range: Tuple[int, int] = (30000, 32767),
    ):
        self.store = store or KVStore()
        # Watch-cache read path (server/watchcache.py): per-resource
        # event-fed mirrors serving GET/LIST without touching kvstore
        # or re-serializing. Lazily built per resource on first LIST.
        from kubernetes_tpu_torch.server.watchcache import WatchCacheSet

        self.caches = WatchCacheSet(self.store)
        # Lifecycle SLI collector (utils/sli.py): the process-global
        # collector rides the SAME dispatcher feed as the watch cache —
        # pod events become pod_startup_latency_seconds milestone
        # watermarks with zero polling and zero extra copies. Always
        # on (tests/test_sli.py pins its cost under 5% of the bulk
        # churn drill's per-pod budget).
        from kubernetes_tpu_torch.utils import sli

        sli.DEFAULT.attach(self.store)
        # Reentrant: admission plugins may issue writes of their own
        # (NamespaceAutoprovision creates the namespace mid-admission).
        self._lock = threading.RLock()
        self._rand = random.Random(0xC0FFEE)
        # Admission chain (kubernetes_tpu_torch.server.admission.Chain); None
        # means admit everything (reference default --admission-control
        # AlwaysAdmit, cmd/kube-apiserver/app/server.go:117).
        self.admission = admission
        # Live component health checks (componentstatuses probes on
        # read; pkg/registry/componentstatus/rest.go).
        self._component_checks: Dict[str, object] = {}
        # HA control plane handle (store/replication.py): a
        # ReplicationHub when this apiserver fronts the leader store, a
        # FollowerReplica when it fronts a replica. Drives the /healthz
        # replication subcheck, /replication/append ingest, and the
        # follower's mutating-verb forward (httpserver.py). None =
        # single-node, the historical shape.
        self.replication = None
        # A follower apiserver forwards writes here (the leader's base
        # URL); set alongside `replication` by the HA wiring.
        self.leader_url = ""
        # Service allocation pools (pkg/master/master.go:440-455) with
        # the reference's restart repair pass: rebuild the bitmaps from
        # whatever services the (possibly pre-existing) store holds
        # (ipallocator/controller/repair.go).
        self.service_ips = IPAllocator(service_cidr)
        self.service_node_ports = PortAllocator(*node_port_range)
        stored_services, _ = self.store.list("/registry/services/")
        for ip in service_ips_in_use(stored_services):
            self.service_ips.mark(ip)
        for port in service_node_ports_in_use(stored_services):
            self.service_node_ports.mark(port)
        # Ensure the default namespace exists (reference auto-creates).
        # A replica-mode store is read-only from this side — the
        # namespace arrives through replication from the leader.
        if getattr(self.store, "replica", False):
            return
        try:
            self.store.create(
                "/registry/namespaces/default",
                {
                    "kind": "Namespace",
                    "apiVersion": "v1",
                    "metadata": {
                        "name": "default",
                        "uid": new_uid(),
                        "creationTimestamp": now_iso(),
                    },
                    "spec": {},
                    "status": {"phase": "Active"},
                },
            )
        except AlreadyExistsError:
            pass

    # -- helpers ------------------------------------------------------

    def _info(self, resource: str) -> ResourceInfo:
        info = RESOURCES.get(resource)
        if info is None:
            raise _bad_request(f"unknown resource {resource!r}")
        return info

    def _gen_name(self, base: str) -> str:
        suffix = "".join(self._rand.choices(string.ascii_lowercase + "0123456789", k=5))
        return base + suffix

    # -- verbs --------------------------------------------------------

    def create(self, resource: str, namespace: str, obj: dict) -> dict:
        info = self._info(resource)
        if info.name == "namespaces":
            # Reference: namespaces default to the "kubernetes" finalizer
            # (pkg/registry/namespace/etcd + pkg/api defaults), making
            # deletion two-phase (Terminating -> content purge -> gone).
            obj.setdefault("spec", {}).setdefault("finalizers", ["kubernetes"])
            obj.setdefault("status", {}).setdefault("phase", "Active")
        ns, _name = self._default_create_meta(info, namespace, obj)
        meta = obj["metadata"]
        with self._write_guard():
            self._admit("CREATE", info, ns, meta["name"], obj)
            self._validate(info, obj)
            release = (
                self._allocate_service(obj) if info.name == "services" else None
            )
            try:
                out = self.store.create(
                    info.key(ns, meta["name"]), obj, ttl=info.ttl
                )
            except AlreadyExistsError:
                if release:
                    release()
                raise _conflict(f'{info.name} "{meta["name"]}" already exists')
            self._commit("CREATE", info, ns, meta["name"], obj)
            return out

    def _write_guard(self):
        """Serialize admission's check-then-act with the store write so
        concurrent requests cannot both pass a quota/limit check and
        blow past a hard limit (the reference serializes via CAS on
        quota status; an in-process lock is the equivalent here). A
        no-op when no admission chain is configured."""
        if self.admission is None:
            return contextlib.nullcontext()
        return self._lock

    def _admit(
        self, operation: str, info: ResourceInfo, ns: str, name: str, obj
    ) -> None:
        if self.admission is None:
            return
        from kubernetes_tpu_torch.server.admission import AdmissionError, Attributes

        try:
            self.admission.admit(
                Attributes(
                    operation=operation,
                    resource=info.name,
                    namespace=ns,
                    name=name,
                    obj=obj,
                )
            )
        except AdmissionError as e:
            raise APIError(e.code, e.reason, e.message)

    def _commit(
        self, operation: str, info: ResourceInfo, ns: str, name: str, obj
    ) -> None:
        """Post-write admission hook (usage bookkeeping); never raises."""
        if self.admission is None:
            return
        from kubernetes_tpu_torch.server.admission import Attributes

        try:
            self.admission.commit(
                Attributes(
                    operation=operation,
                    resource=info.name,
                    namespace=ns,
                    name=name,
                    obj=obj,
                )
            )
        except Exception:
            # Usage bookkeeping drift is better logged than hidden —
            # the write itself already succeeded, so don't fail it.
            _LOG.exception("post-write admission commit failed")

    def _validate(self, info: ResourceInfo, obj: dict) -> None:
        if info.validator is None:
            return
        typed = serde.from_wire(info.cls, obj)
        try:
            info.validator(typed)
        except ValidationError as e:
            raise _invalid("; ".join(e.errors))

    def _validate_fast(self, info: ResourceInfo, obj: dict) -> None:
        """Bulk-path validation: the wire-form twin when the resource
        registers one (same checks, no typed decode — the decode was
        the apiserver's largest per-pod cost at bulk rates), otherwise
        the ordinary typed validator."""
        if info.wire_validator is not None:
            try:
                info.wire_validator(obj)
            except ValidationError as e:
                raise _invalid("; ".join(e.errors))
            return
        self._validate(info, obj)

    def _ns(self, info: ResourceInfo, namespace: str) -> str:
        return (namespace or "default") if info.namespaced else ""

    # -- service allocation (pkg/registry/service/rest.go:68-131) ------

    def _allocate_service(self, obj: dict):
        """Fill spec.clusterIP / spec.ports[].nodePort from the pools.
        Returns a rollback closure releasing everything granted, for
        the store-create-failed path (rest.go's releaseServiceIP defer
        + portallocator operation)."""
        spec = obj.setdefault("spec", {})
        granted_ip: Optional[str] = None
        granted_ports: List[int] = []

        def rollback():
            if granted_ip:
                self.service_ips.release(granted_ip)
            for p in granted_ports:
                self.service_node_ports.release(p)

        try:
            ip = spec.get("clusterIP") or ""
            if not ip:
                spec["clusterIP"] = granted_ip = self.service_ips.allocate_next()
            elif ip != "None":
                self.service_ips.allocate(ip)
                granted_ip = ip
            assign = spec.get("type") in ("NodePort", "LoadBalancer")
            for port in spec.get("ports") or []:
                requested = port.get("nodePort") or 0
                if requested:
                    self.service_node_ports.allocate(requested)
                    granted_ports.append(requested)
                elif assign:
                    port["nodePort"] = self.service_node_ports.allocate_next()
                    granted_ports.append(port["nodePort"])
        except AllocationError as e:
            rollback()
            raise _invalid(f"spec.clusterIP/nodePort: {e}")
        return rollback

    @staticmethod
    def _carry_node_ports(cur_spec: dict, new_spec: dict) -> None:
        """Fill missing nodePort fields on an updated/patched spec from
        the current object, matching ports by name (or by port number
        when unnamed) — the reference's update path carries the
        existing allocation over rather than churning the externally
        advertised port on every full replace."""
        by_key = {}
        for p in cur_spec.get("ports") or []:
            if p.get("nodePort"):
                by_key[p.get("name") or ("#", p.get("port"))] = p["nodePort"]
        claimed = {
            p.get("nodePort") for p in new_spec.get("ports") or [] if p.get("nodePort")
        }
        for p in new_spec.get("ports") or []:
            if p.get("nodePort"):
                continue
            prev = by_key.get(p.get("name") or ("#", p.get("port")))
            if prev and prev not in claimed:
                p["nodePort"] = prev
                claimed.add(prev)

    def _update_service_allocations(self, current: dict, obj: dict):
        """Update-path allocation semantics: clusterIP is immutable
        (carried over when omitted, rejected when changed — reference
        validation.ValidateServiceUpdate); existing node ports carry
        over, newly requested ones allocate, dropped ones release only
        after the write commits. Returns (rollback, commit) closures."""
        cur_spec = current.get("spec") or {}
        spec = obj.setdefault("spec", {})
        cur_ip = cur_spec.get("clusterIP") or ""
        new_ip = spec.get("clusterIP") or ""
        if not new_ip and cur_ip:
            spec["clusterIP"] = cur_ip
        elif cur_ip and new_ip != cur_ip:
            raise _invalid("spec.clusterIP: field is immutable")
        cur_ports = {
            p.get("nodePort") for p in cur_spec.get("ports") or [] if p.get("nodePort")
        }
        granted: List[int] = []
        assign = spec.get("type") in ("NodePort", "LoadBalancer")
        if assign:
            # Only a type that still wants node ports carries them over;
            # NodePort -> ClusterIP must shed its ports (commit()
            # releases them) instead of pinning them forever.
            self._carry_node_ports(cur_spec, spec)
        else:
            # Shed explicitly-submitted stale ports too: a ClusterIP
            # spec has no business carrying nodePort fields, and
            # leaving them would keep the pool allocation forever.
            for p in spec.get("ports") or []:
                p.pop("nodePort", None)
        try:
            new_ports = set()
            for port in spec.get("ports") or []:
                requested = port.get("nodePort") or 0
                if not requested and assign:
                    port["nodePort"] = requested = (
                        self.service_node_ports.allocate_next()
                    )
                    granted.append(requested)
                elif requested and requested not in cur_ports:
                    self.service_node_ports.allocate(requested)
                    granted.append(requested)
                if requested:
                    new_ports.add(requested)
        except AllocationError as e:
            for p in granted:
                self.service_node_ports.release(p)
            raise _invalid(f"spec.ports.nodePort: {e}")

        def rollback():
            for p in granted:
                self.service_node_ports.release(p)

        def commit():
            for p in cur_ports - new_ports:
                self.service_node_ports.release(p)

        return rollback, commit

    def publish_master_service(self, host: str, port: int) -> dict:
        """Publish the 'kubernetes' service + endpoints addressing this
        master (pkg/master/publish.go). Selector-less, so the endpoints
        controller leaves the manually-set endpoints alone; reconciled
        on every (re)start so a moved master updates its address."""
        try:
            svc = self.get("services", "default", "kubernetes")
            if (svc.get("spec") or {}).get("ports") != [
                {"name": "http", "port": port, "protocol": "TCP"}
            ]:
                # Master restarted on a different port over a persisted
                # store: the advertised service port must follow.
                svc["spec"]["ports"] = [
                    {"name": "http", "port": port, "protocol": "TCP"}
                ]
                svc = self.update("services", "default", "kubernetes", svc)
        except APIError:
            svc = self.create(
                "services",
                "default",
                {
                    "kind": "Service",
                    "apiVersion": "v1",
                    "metadata": {"name": "kubernetes", "namespace": "default"},
                    "spec": {
                        "ports": [{"name": "http", "port": port, "protocol": "TCP"}],
                        "sessionAffinity": "None",
                    },
                },
            )
        endpoints = {
            "kind": "Endpoints",
            "apiVersion": "v1",
            "metadata": {"name": "kubernetes", "namespace": "default"},
            "subsets": [
                {
                    "addresses": [{"ip": host}],
                    "ports": [{"name": "http", "port": port, "protocol": "TCP"}],
                }
            ],
        }
        try:
            self.update("endpoints", "default", "kubernetes", endpoints)
        except APIError as e:
            if e.code != 404:
                raise
            self.create("endpoints", "default", endpoints)
        return svc

    def _release_service(self, obj: dict) -> None:
        spec = obj.get("spec") or {}
        ip = spec.get("clusterIP") or ""
        if ip and ip != "None":
            self.service_ips.release(ip)
        for port in spec.get("ports") or []:
            if port.get("nodePort"):
                self.service_node_ports.release(port["nodePort"])

    # -- component statuses (live health probes) ----------------------

    def register_component(self, name: str, check) -> None:
        """Register a component health check (callable -> (ok, msg)).
        Reference: pkg/registry/componentstatus/rest.go — the resource
        is a LIVE view probing registered servers on every read, not
        stored objects."""
        self._component_checks[name] = check

    def _component_status(self, name: str) -> dict:
        check = self._component_checks[name]
        try:
            ok, msg = check()
        except Exception as e:
            ok, msg = False, f"{type(e).__name__}: {e}"
        return {
            "kind": "ComponentStatus",
            "apiVersion": "v1",
            "metadata": {"name": name},
            "conditions": [
                {
                    "type": "Healthy",
                    "status": "True" if ok else "False",
                    "message": msg,
                }
            ],
        }

    def get(self, resource: str, namespace: str, name: str) -> dict:
        info = self._info(resource)
        if info.name == "componentstatuses" and name in self._component_checks:
            return self._component_status(name)
        try:
            return self.store.get(info.key(self._ns(info, namespace), name))
        except NotFoundError:
            raise _not_found(info.name, name)

    def _cache_list(self, info: ResourceInfo, namespace: str):
        """(object REFS, version) through the watch cache when it is
        fresh, falling back to a direct store scan when the dispatcher
        trails too far (wedged fan-out must degrade, not error)."""
        cache = self.caches.cache_for(info.prefix())
        if cache.fresh():
            return cache.list_refs(info.prefix(namespace))
        return self.store.list(info.prefix(namespace), copy=False)

    def list(
        self,
        resource: str,
        namespace: str = "",
        label_selector: str = "",
        field_selector: str = "",
        copy: bool = True,
    ) -> dict:
        """Served from the watch cache (event-fed, read-your-writes via
        the version wait) — a LIST never scans or re-copies kvstore
        state on the steady-state path.

        copy=False returns the cache's own objects (READ-ONLY — for
        callers that immediately serialize, like the HTTP tier: a
        3000-pod LIST must not pay a full deep copy just to be JSON-
        encoded and thrown away). Stored objects are never mutated in
        place, so the refs are a consistent snapshot."""
        info = self._info(resource)
        items, version = self._cache_list(info, namespace)
        pred = self._selector_pred(resource, label_selector, field_selector)
        items = [o for o in items if pred(o)]
        if copy:
            from kubernetes_tpu_torch.store.kvstore import _copy_obj

            items = [_copy_obj(o) for o in items]
        if info.name == "componentstatuses" and self._component_checks:
            # Live probes first (the reference ignores selectors here
            # entirely, rest.go:52; we at least apply them uniformly);
            # stored objects only fill names no live check covers.
            live = [
                o
                for n in sorted(self._component_checks)
                if pred(o := self._component_status(n))
            ]
            covered = set(self._component_checks)
            items = live + [
                o for o in items if o.get("metadata", {}).get("name") not in covered
            ]
        return {
            "kind": info.kind + "List",
            "apiVersion": "v1",
            "metadata": {"resourceVersion": str(version)},
            "items": items,
        }

    def list_response_bytes(
        self,
        resource: str,
        namespace: str = "",
        label_selector: str = "",
        field_selector: str = "",
    ) -> Optional[bytes]:
        """Complete JSON LIST response assembled from the watch cache's
        per-object encodings (each object serialized at most once per
        resourceVersion, ever — across LISTs, watchers, and callers).
        None when the fast path does not apply (live componentstatuses,
        stale cache) — the caller falls back to list()."""
        info = self._info(resource)
        if info.name == "componentstatuses" and self._component_checks:
            return None
        cache = self.caches.cache_for(info.prefix())
        if not cache.fresh():
            return None
        pred = None
        if label_selector or field_selector:
            pred = self._selector_pred(
                resource, label_selector, field_selector
            )
        body, _count, version = cache.list_encoded(
            info.prefix(namespace), pred
        )
        head = (
            '{"kind": "%sList", "apiVersion": "v1", "metadata": '
            '{"resourceVersion": "%d"}, "items": [' % (info.kind, version)
        ).encode()
        return head + body + b"]}"

    def get_response_bytes(
        self, resource: str, namespace: str, name: str
    ) -> Optional[bytes]:
        """Encoded GET served from the watch cache; None = fall back
        (missing object included — the slow path owns 404 semantics)."""
        info = self._info(resource)
        if info.name == "componentstatuses":
            return None
        cache = self.caches.cache_for(info.prefix())
        if not cache.fresh():
            return None
        return cache.get_encoded(info.key(self._ns(info, namespace), name))

    def _selector_pred(self, resource: str, label_selector: str, field_selector: str):
        lsel = labelpkg.parse(label_selector)
        fsel = labelpkg.parse_fields(field_selector)
        if lsel.empty() and fsel.empty():
            return lambda o: True

        def pred(o: dict) -> bool:
            if not lsel.empty():
                if not lsel.matches(o.get("metadata", {}).get("labels", {})):
                    return False
            if not fsel.empty():
                if not fsel.matches(fields_for(resource, o)):
                    return False
            return True

        return pred

    def update(self, resource: str, namespace: str, name: str, obj: dict) -> dict:
        info = self._info(resource)
        meta = obj.setdefault("metadata", {})
        if meta.get("name") and meta["name"] != name:
            raise _bad_request(f"name mismatch: body {meta['name']!r} vs url {name!r}")
        meta["name"] = name
        namespace = self._ns(info, namespace)
        if info.namespaced:
            meta.setdefault("namespace", namespace)
        key = info.key(namespace, name)
        try:
            current = self.store.get(key)
        except NotFoundError:
            raise _not_found(info.name, name)
        # Immutable server-side fields carry over.
        meta["uid"] = current["metadata"].get("uid", "")
        meta["creationTimestamp"] = current["metadata"].get("creationTimestamp", "")
        expected = None
        if meta.get("resourceVersion"):
            try:
                expected = int(meta["resourceVersion"])
            except ValueError:
                raise _bad_request(
                    f"invalid resourceVersion {meta['resourceVersion']!r}"
                )
        with self._write_guard():
            self._admit("UPDATE", info, namespace, name, obj)
            self._validate(info, obj)
            rollback = commit = None
            if info.name == "services":
                rollback, commit = self._update_service_allocations(current, obj)
            try:
                out = self.store.set(key, obj, expected_version=expected)
            except ConflictError as e:
                if rollback:
                    rollback()
                raise _conflict(str(e))
            except NotFoundError:
                if rollback:
                    rollback()
                raise _not_found(info.name, name)
            if commit:
                commit()
            self._commit("UPDATE", info, namespace, name, obj)
            return out

    def _mark_namespace_terminating(self, name: str) -> Optional[dict]:
        """Two-phase namespace deletion (pkg/registry/namespace/etcd):
        while spec.finalizers is non-empty, DELETE marks the namespace
        Terminating (deletionTimestamp + status.phase) and returns it;
        the namespace controller purges content, finalizes, and re-issues
        the DELETE which then actually removes the object. Returns None
        when the namespace should be deleted for real."""
        key = "/registry/namespaces/" + name
        try:
            cur = self.store.get(key)
        except NotFoundError:
            raise _not_found("namespaces", name)
        if not cur.get("spec", {}).get("finalizers"):
            return None

        def mark(obj: dict) -> dict:
            obj.setdefault("metadata", {}).setdefault(
                "deletionTimestamp", now_iso()
            )
            obj.setdefault("status", {})["phase"] = "Terminating"
            return obj

        try:
            return self.store.guaranteed_update(key, mark)
        except NotFoundError:
            raise _not_found("namespaces", name)

    def finalize_namespace(self, name: str, obj: dict) -> dict:
        """The 'finalize' subresource: replace spec.finalizers from the
        wire body (pkg/registry/namespace/etcd FinalizeREST)."""
        finalizers = list(obj.get("spec", {}).get("finalizers", []))

        def apply(cur: dict) -> dict:
            cur.setdefault("spec", {})["finalizers"] = finalizers
            return cur

        try:
            return self.store.guaranteed_update(
                "/registry/namespaces/" + name, apply
            )
        except NotFoundError:
            raise _not_found("namespaces", name)

    def connect(
        self, resource: str, namespace: str, name: str, subresource: str
    ) -> None:
        """Admission gate for CONNECT subresources (exec/attach/proxy).
        Reference: CONNECT verbs in pkg/apiserver/api_installer.go:268-284
        pass through the admission chain before upgrade."""
        info = self._info(resource)
        if self.admission is None:
            return
        from kubernetes_tpu_torch.server.admission import AdmissionError, Attributes

        try:
            self.admission.admit(
                Attributes(
                    operation="CONNECT",
                    resource=info.name,
                    namespace=self._ns(info, namespace),
                    name=name,
                    subresource=subresource,
                )
            )
        except AdmissionError as e:
            raise APIError(e.code, e.reason, e.message)

    def patch(
        self,
        resource: str,
        namespace: str,
        name: str,
        patch,
        patch_type: str = "merge",
    ) -> dict:
        """PATCH with all three reference patch types
        (pkg/apiserver/resthandler.go:446): "merge" (RFC 7386, a dict),
        "json" (RFC 6902, an op list), "strategic" (strategic merge —
        lists of objects merge by key). Applied over a CAS retry.
        Admission runs on the MERGED object like any other update — a
        patch must not be a side door around quota/policy."""
        import copy as _copy

        info = self._info(resource)
        ns = self._ns(info, namespace)
        if patch_type not in ("merge", "json", "strategic"):
            raise _bad_request(f"unknown patch type {patch_type!r}")
        if patch_type == "json":
            if not isinstance(patch, list):
                raise _bad_request("a JSON patch body must be an op array")
        elif not isinstance(patch, dict):
            raise _bad_request("a merge patch body must be an object")
        # Deep copy: the sanitizer below edits nested dicts, and
        # in-process (LocalTransport) callers must get their patch
        # object back untouched.
        patch = _copy.deepcopy(patch)
        if patch_type != "json":
            # Identity/shape fields never come from a patch body.
            for forbidden in ("kind", "apiVersion"):
                patch.pop(forbidden, None)
            meta_patch = patch.get("metadata")
            if isinstance(meta_patch, dict):
                for forbidden in ("name", "namespace", "resourceVersion", "uid"):
                    meta_patch.pop(forbidden, None)

        pre: List[Optional[dict]] = [None]

        def apply(cur: dict) -> dict:
            pre[0] = _copy.deepcopy(cur)
            if patch_type == "json":
                merged = _json_patch(cur, patch)
            elif patch_type == "strategic":
                merged = _strategic_merge(cur, patch)
            else:
                merged = _json_merge(cur, patch)
            if not isinstance(merged, dict):
                raise _bad_request("patched object must remain an object")
            if not isinstance(merged.get("metadata", {}), dict):
                raise _bad_request("patched metadata must remain an object")
            # Identity fields are never patchable, whatever the type
            # (a JSON patch op can name any pointer — restore).
            for field in ("kind", "apiVersion"):
                if field in cur:
                    merged[field] = cur[field]
            m_cur = cur.get("metadata") or {}
            m_new = merged.setdefault("metadata", {})
            for field in ("name", "namespace", "resourceVersion", "uid"):
                if field in m_cur:
                    m_new[field] = m_cur[field]
                else:
                    m_new.pop(field, None)
            if info.name == "services":
                # PATCH must not be a side door around the allocator
                # invariants create/update enforce: clusterIP stays
                # immutable; existing nodePorts carry over when the
                # patch replaces spec.ports; a patched-in nodePort must
                # be in range and free; a NodePort service port cannot
                # be left without one.
                cur_spec, new_spec = cur.get("spec") or {}, merged.get("spec") or {}
                cur_ip = cur_spec.get("clusterIP") or ""
                new_ip = new_spec.get("clusterIP") or ""
                if cur_ip and new_ip != cur_ip:
                    raise _invalid("spec.clusterIP: field is immutable")
                assign = new_spec.get("type") in ("NodePort", "LoadBalancer")
                if assign:
                    self._carry_node_ports(cur_spec, new_spec)
                else:
                    # Type patched away from NodePort: the merge kept
                    # the old ports (with nodePorts) — shed them so the
                    # post-commit reconcile releases the pool slots.
                    for p in new_spec.get("ports") or []:
                        p.pop("nodePort", None)
                held = {
                    p.get("nodePort")
                    for p in cur_spec.get("ports") or []
                    if p.get("nodePort")
                }
                lo, hi = self.service_node_ports.lo, self.service_node_ports.hi
                for p in new_spec.get("ports") or []:
                    np = p.get("nodePort") or 0
                    if np and not (lo <= np <= hi):
                        raise _invalid(
                            f"spec.ports.nodePort: port {np} is not in the "
                            f"node port range {lo}-{hi}"
                        )
                    if np and np not in held and self.service_node_ports.is_allocated(np):
                        raise _invalid(f"spec.ports.nodePort: port {np} is already allocated")
                    if not np and assign:
                        raise _invalid(
                            "spec.ports.nodePort: a NodePort service port "
                            "needs an explicit nodePort when patched"
                        )
            self._admit("UPDATE", info, ns, name, merged)
            self._validate(info, merged)
            return merged

        key = info.key(ns, name)
        with self._write_guard():
            try:
                out = self.store.guaranteed_update(key, apply)
            except NotFoundError:
                raise _not_found(info.name, name)
            if info.name == "services":
                # Reconcile the port pool with what actually committed.
                def _ports(o):
                    return {
                        p.get("nodePort")
                        for p in (o.get("spec") or {}).get("ports") or []
                        if p.get("nodePort")
                    }

                old_ports, new_ports = _ports(pre[0] or {}), _ports(out)
                for p in new_ports - old_ports:
                    self.service_node_ports.mark(p)
                for p in old_ports - new_ports:
                    self.service_node_ports.release(p)
            self._commit("UPDATE", info, ns, name, out)
        return out

    def service_location(
        self, namespace: str, name: str, port_hint: str = ""
    ) -> Tuple[str, int]:
        """Pick a backend (ip, port) for a service — the routing half
        of the services proxy subresource (reference:
        pkg/registry/service/rest.go ResourceLocation: resolve the
        service's endpoints, pick a random one). `port_hint` from the
        'name:port' form selects by endpoint port name (or number);
        empty takes the first port."""
        try:
            eps = self.get("endpoints", namespace, name)
        except APIError as e:
            if e.code != 404:
                raise
            # Distinguish "service doesn't exist" (404) from "exists
            # but has no endpoints yet" (503).
            self.get("services", namespace, name)
            eps = {}
        candidates: List[Tuple[str, int]] = []
        for subset in eps.get("subsets") or []:
            ports = subset.get("ports") or []
            chosen = None
            if not port_hint:
                chosen = ports[0]["port"] if ports else None
            elif port_hint.isdigit():
                if any(p.get("port") == int(port_hint) for p in ports):
                    chosen = int(port_hint)
            else:
                for p in ports:
                    if p.get("name") == port_hint:
                        chosen = p["port"]
                        break
            if chosen is None:
                continue
            for addr in subset.get("addresses") or []:
                if addr.get("ip"):
                    candidates.append((addr["ip"], chosen))
        if not candidates:
            raise APIError(
                503,
                "ServiceUnavailable",
                f"no endpoints available for service {name!r}",
            )
        return candidates[self._rand.randrange(len(candidates))]

    def kubelet_location(self, namespace: str, name: str) -> Tuple[str, dict]:
        """Resolve the kubelet API base URL serving a pod — the routing
        half of the log/exec subresources (reference: LogLocation /
        ExecLocation in pkg/registry/pod/rest.go resolve node host +
        port 10250; we read the port from NodeStatus daemon endpoints).
        Returns (base_url, pod_wire)."""
        pod = self.get("pods", namespace, name)
        node_name = pod.get("spec", {}).get("nodeName", "")
        if not node_name:
            raise APIError(
                409, "Conflict", f"pod {name!r} is not scheduled to a node yet"
            )
        node = self.get("nodes", "", node_name)
        status = node.get("status", {})
        port = (
            status.get("daemonEndpoints", {})
            .get("kubeletEndpoint", {})
            .get("port", 0)
        )
        if not port:
            raise APIError(
                501,
                "NotImplemented",
                f"node {node_name!r} does not publish a kubelet API endpoint",
            )
        ip = next(
            (
                a.get("address")
                for a in status.get("addresses", [])
                if a.get("type") == "InternalIP"
            ),
            "127.0.0.1",
        )
        return f"http://{ip}:{port}", pod

    def _pod_container(self, pod: dict, container: str) -> str:
        if container:
            return container
        containers = pod.get("spec", {}).get("containers", [])
        return containers[0].get("name", "") if containers else ""

    def pod_log(
        self,
        namespace: str,
        name: str,
        container: str = "",
        tail: Optional[int] = None,
    ) -> str:
        """GET /pods/{name}/log — relayed from the pod's kubelet
        (reference: LogREST, pkg/registry/pod/etcd/etcd.go:45)."""
        import urllib.error
        import urllib.request

        base, pod = self.kubelet_location(namespace, name)
        container = self._pod_container(pod, container)
        url = f"{base}/logs/{namespace or 'default'}/{name}/{container}"
        if tail is not None:
            url += f"?tail={int(tail)}"
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                return resp.read().decode(errors="replace")
        except urllib.error.URLError as e:
            raise APIError(502, "BadGateway", f"kubelet log fetch failed: {e}")

    def pod_exec(
        self, namespace: str, name: str, container: str, body: dict
    ) -> dict:
        """POST /pods/{name}/exec — admission-gated, then relayed to the
        pod's kubelet as JSON run-style exec (reference: ExecLocation +
        pkg/kubelet/server.go /exec/)."""
        import urllib.error
        import urllib.request

        self.connect("pods", namespace, name, "exec")
        command = (body or {}).get("command", [])
        if not command:
            raise _bad_request("exec requires a command")
        base, pod = self.kubelet_location(namespace, name)
        container = self._pod_container(pod, container)
        url = f"{base}/exec/{namespace or 'default'}/{name}/{container}"
        req = urllib.request.Request(
            url,
            data=json.dumps({"command": command}).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read())
        except urllib.error.URLError as e:
            raise APIError(502, "BadGateway", f"kubelet exec failed: {e}")

    def update_status(self, resource: str, namespace: str, name: str, obj: dict) -> dict:
        """Status subresource: replace only .status (pkg/registry/pod/etcd
        StatusREST)."""
        info = self._info(resource)
        key = info.key(self._ns(info, namespace), name)
        new_status = obj.get("status", {})

        def apply(cur: dict) -> dict:
            cur["status"] = new_status
            return cur

        try:
            # atomic_update, not guaranteed_update: status writes are
            # the highest-traffic mutation (every kubelet sync), and
            # the single-hold form halves lock handoffs under burst.
            return self.store.atomic_update(key, apply)
        except NotFoundError:
            raise _not_found(info.name, name)

    def _mark_pod_terminating(
        self, namespace: str, name: str, grace: int
    ) -> Optional[dict]:
        """Graceful pod delete: instead of removing the object, stamp
        metadata.deletionTimestamp (= now + grace, the force-delete
        deadline) and deletionGracePeriodSeconds, so watchers see ONE
        MODIFIED (Terminating) now and ONE DELETED when the kubelet
        confirms termination with a grace-0 delete. A second graceful
        DELETE can only shorten the remaining grace, never extend it
        (reference: rest.BeforeDelete's CheckGracefulDelete shape).
        Returns the marked pod, or None when the pod should be removed
        immediately (unbound — no kubelet will ever confirm it)."""
        try:
            pod = self.store.get(RESOURCES["pods"].key(namespace, name))
        except NotFoundError:
            raise _not_found("pods", name)
        if not pod.get("spec", {}).get("nodeName"):
            return None  # pending pod: nothing to terminate gracefully

        deadline = time.time() + grace

        def mark(obj: dict) -> dict:
            meta = obj.setdefault("metadata", {})
            prev = meta.get("deletionTimestamp", "")
            new_ts = time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime(deadline)
            )
            if not prev or new_ts < prev:
                meta["deletionTimestamp"] = new_ts
                meta["deletionGracePeriodSeconds"] = grace
            return obj

        try:
            return self.store.guaranteed_update(
                RESOURCES["pods"].key(namespace, name), mark
            )
        except NotFoundError:
            raise _not_found("pods", name)

    def evict_pod(self, namespace: str, name: str, body: Optional[dict]) -> dict:
        """POST /pods/{name}/eviction — the graceful-delete subresource
        (shape follows policy/v1 Eviction: metadata + deleteOptions).
        The preemption path uses this so victims terminate with grace
        instead of vanishing under their kubelet."""
        body = body or {}
        opts = body.get("deleteOptions") or {}
        grace = opts.get("gracePeriodSeconds")
        if grace is None:
            grace = DEFAULT_EVICTION_GRACE_SECONDS
        try:
            grace = int(grace)
        except (TypeError, ValueError):
            raise _bad_request(
                f"deleteOptions.gracePeriodSeconds: invalid {grace!r}"
            )
        return self.delete(
            "pods", namespace, name, grace_period_seconds=grace
        )

    def delete(
        self,
        resource: str,
        namespace: str,
        name: str,
        grace_period_seconds: Optional[int] = None,
    ) -> dict:
        info = self._info(resource)
        if info.name == "namespaces":
            marked = self._mark_namespace_terminating(name)
            if marked is not None:
                return marked
        with self._write_guard():
            self._admit("DELETE", info, self._ns(info, namespace), name, None)
            if (
                info.name == "pods"
                and grace_period_seconds is not None
                and grace_period_seconds > 0
            ):
                # Bound-ness check and the immediate-delete fallback
                # stay under ONE guard hold: a bind landing between
                # them would otherwise hard-delete a pod the caller
                # asked to terminate gracefully.
                marked = self._mark_pod_terminating(
                    self._ns(info, namespace), name, int(grace_period_seconds)
                )
                if marked is not None:
                    return marked
                # Unbound pod: nothing to terminate — delete now.
            try:
                deleted = self.store.delete(info.key(self._ns(info, namespace), name))
            except NotFoundError:
                raise _not_found(info.name, name)
            if info.name == "services":
                self._release_service(deleted)
            self._commit("DELETE", info, self._ns(info, namespace), name, None)
        return {
            "kind": "Status",
            "apiVersion": "v1",
            "status": "Success",
            "code": 200,
        }

    def watch(
        self,
        resource: str,
        namespace: str = "",
        since: int = 0,
        label_selector: str = "",
        field_selector: str = "",
        maxsize: int = 4096,
    ) -> WatchStream:
        """Selector filtering happens INSIDE the store's fan-out (with
        etcd's modified-out-of-filter -> DELETED translation,
        kvstore._filter_event): a kubelet watching spec.nodeName=X never
        has the other nodes' pod events copied or queued for it.

        `maxsize` bounds the consumer's event queue (slow consumers are
        dropped at overflow and must re-list); bulk-churn clients ask
        for deeper buffers (?maxsize=) so a single group commit's burst
        of N events cannot out-run one scheduling quantum of their
        reader."""
        info = self._info(resource)
        pred = None
        shard = None
        if label_selector or field_selector:
            pred = self._selector_pred(resource, label_selector, field_selector)
            shard = _watch_shard(resource, field_selector)
        try:
            return self.store.watch(
                info.prefix(namespace), since=since, pred=pred, shard=shard,
                maxsize=max(1024, min(int(maxsize), 65536)),
            )
        except Exception as e:  # CompactedError -> 410 Gone
            raise APIError(410, "Expired", str(e))

    # -- bindings (the scheduler's commit path) ------------------------

    def bind(self, namespace: str, binding: dict) -> dict:
        """POST /bindings: set pod.spec.nodeName iff currently empty.

        Reference: BindingREST.Create -> assignPod -> GuaranteedUpdate
        with the emptiness guard (pkg/registry/pod/etcd/etcd.go:123-181).
        """
        pod_name = binding.get("metadata", {}).get("name", "")
        target = binding.get("target", {})
        node_name = target.get("name", "")
        if not pod_name or not node_name:
            raise _bad_request("binding requires metadata.name and target.name")
        if target.get("kind", "") not in ("", "Node", "Minion"):
            raise _bad_request(f"cannot bind to {target.get('kind')!r}")
        key = RESOURCES["pods"].key(namespace or "default", pod_name)

        def assign(cur: dict) -> dict:
            spec = cur.setdefault("spec", {})
            if spec.get("nodeName"):
                raise _conflict(
                    f'pod "{pod_name}" is already assigned to node '
                    f'"{spec["nodeName"]}"'
                )
            spec["nodeName"] = node_name
            return cur

        try:
            self.store.atomic_update(key, assign)
        except NotFoundError:
            raise _not_found("pods", pod_name)
        except ConflictError as e:
            # The already-assigned guard raises inside atomic_update
            # and surfaces as 409 (the caller retries the pod).
            raise _conflict(str(e))
        return {
            "kind": "Status",
            "apiVersion": "v1",
            "status": "Success",
            "code": 201,
        }

    # -- bulk object verbs (the write fast path) -----------------------

    #: Resources whose create/delete carry side effects (allocators,
    #: finalizer phases) — bulk falls back to the per-item verbs there.
    _BULK_SLOW = frozenset({"services", "namespaces"})

    def create_bulk(
        self, resource: str, namespace: str, items, copy: bool = True
    ) -> list:
        """POST {resource}:bulk — create N objects through ONE store
        batch (one lock hold, one WAL append, one group-commit fsync;
        KVStore.create_many). Per-item Status results in input order;
        failures never abort the rest (pods are independent objects —
        the atomic path is bind_bulk(atomic=True), not creation).
        Watch events land in version order matching the input order.

        copy=False trusts the items to be PRIVATE dicts (the HTTP
        tier's just-parsed body); in-process callers keep the copy."""
        info = self._info(resource)
        if isinstance(items, dict):
            items = items.get("items", [])
        out: List[Optional[dict]] = [None] * len(items)
        if info.name in self._BULK_SLOW or self.admission is not None:
            # Admission is check-then-act against CURRENT usage: a
            # batched admit-everything-then-commit would let one
            # request blow a hard quota/limit by up to the batch size.
            # With a chain configured, each item takes the full
            # admit->commit->bookkeep cycle (correctness over the
            # group-commit fast path).
            for i, obj in enumerate(items):
                try:
                    created = self.create(resource, namespace, obj)
                    out[i] = self._created_status(created)
                except APIError as e:
                    out[i] = e.to_status()
                except Exception as e:
                    out[i] = _invalid(f"{type(e).__name__}: {e}").to_status()
            return out
        entries = []
        entry_idx = []
        with self._write_guard():
            for i, obj in enumerate(items):
                try:
                    ns, name = self._default_create_meta(
                        info, namespace, obj
                    )
                    self._admit("CREATE", info, ns, name, obj)
                    self._validate_fast(info, obj)
                except APIError as e:
                    out[i] = e.to_status()
                    continue
                except Exception as e:
                    # Per-item contract: a malformed object (non-
                    # numeric priority, non-string label value, ...)
                    # that slips past the validator's field checks
                    # must fail ITS slot, never abort the batch.
                    out[i] = _invalid(f"{type(e).__name__}: {e}").to_status()
                    continue
                entries.append((info.key(ns, name), obj, info.ttl))
                entry_idx.append(i)
            if entries:
                results = self.store.create_many(entries, copy=copy)
                for i, res in zip(entry_idx, results):
                    if isinstance(res, AlreadyExistsError):
                        name = items[i].get("metadata", {}).get("name", "")
                        out[i] = _conflict(
                            f'{info.name} "{name}" already exists'
                        ).to_status()
                    elif isinstance(res, Exception):
                        out[i] = APIError(
                            500, "InternalError", str(res)
                        ).to_status()
                    else:
                        out[i] = self._created_status(res)
                        self._commit(
                            "CREATE", info,
                            res.get("metadata", {}).get("namespace", ""),
                            res.get("metadata", {}).get("name", ""), res,
                        )
        return out

    @staticmethod
    def _created_status(obj: dict) -> dict:
        meta = obj.get("metadata", {})
        return {
            "kind": "Status",
            "apiVersion": "v1",
            "status": "Success",
            "code": 201,
            "details": {
                "name": meta.get("name", ""),
                "resourceVersion": meta.get("resourceVersion", ""),
            },
        }

    def _default_create_meta(
        self, info: ResourceInfo, namespace: str, obj: dict
    ) -> Tuple[str, str]:
        """The create() defaulting pass (namespace/name/kind/uid/
        creationTimestamp), shared by the single and bulk paths."""
        meta = obj.setdefault("metadata", {})
        if info.namespaced:
            ns = meta.get("namespace") or namespace or "default"
            meta["namespace"] = ns
            if namespace and ns != namespace:
                raise _bad_request(
                    f"namespace mismatch: body {ns!r} vs url {namespace!r}"
                )
        else:
            meta.pop("namespace", None)
            ns = ""
        if not meta.get("name") and meta.get("generateName"):
            meta["name"] = self._gen_name(meta["generateName"])
        if not meta.get("name"):
            raise _invalid("metadata.name: required")
        obj.setdefault("kind", info.kind)
        obj.setdefault("apiVersion", "v1")
        if obj["kind"] != info.kind:
            raise _bad_request(
                f"kind {obj['kind']!r} does not match {info.kind!r}"
            )
        meta["uid"] = new_uid()
        meta["creationTimestamp"] = now_iso()
        meta.pop("resourceVersion", None)
        return ns, meta["name"]

    def update_bulk(
        self, resource: str, namespace: str, items, copy: bool = True
    ) -> list:
        """POST {resource}:bulkupdate — replace N objects through one
        store batch (atomic_update_many: one lock hold, one WAL append,
        one fsync). Each item keeps update()'s semantics: CAS when the
        body carries metadata.resourceVersion, last-write-wins when
        not; uid/creationTimestamp carry over from the stored object.

        copy=False trusts the items to be PRIVATE dicts (the HTTP
        tier's parsed body): the store then skips its defensive
        per-item round-trip copies — the dominant bulk-update cost."""
        info = self._info(resource)
        if isinstance(items, dict):
            items = items.get("items", [])
        if info.name in self._BULK_SLOW or self.admission is not None:
            # Same check-then-act concern as create_bulk: quota usage
            # deltas must be observed item by item under the guard.
            out = []
            for obj in items:
                try:
                    name = obj.get("metadata", {}).get("name", "")
                    self.update(resource, namespace, name, obj)
                    out.append(
                        {"kind": "Status", "apiVersion": "v1",
                         "status": "Success", "code": 200}
                    )
                except APIError as e:
                    out.append(e.to_status())
                except Exception as e:
                    out.append(
                        _invalid(f"{type(e).__name__}: {e}").to_status()
                    )
            return out
        out = [None] * len(items)
        ops = []
        op_idx = []
        with self._write_guard():
            for i, obj in enumerate(items):
                ns = self._ns(info, namespace)
                try:
                    meta = obj.setdefault("metadata", {})
                    name = meta.get("name", "")
                    if info.namespaced:
                        meta.setdefault("namespace", ns)
                    if not name:
                        out[i] = _invalid(
                            "metadata.name: required"
                        ).to_status()
                        continue
                    expected = None
                    if meta.get("resourceVersion"):
                        try:
                            expected = int(meta["resourceVersion"])
                        except ValueError:
                            out[i] = _bad_request(
                                f"invalid resourceVersion "
                                f"{meta['resourceVersion']!r}"
                            ).to_status()
                            continue
                    self._admit("UPDATE", info, ns, name, obj)
                    self._validate_fast(info, obj)
                except APIError as e:
                    out[i] = e.to_status()
                    continue
                except Exception as e:
                    # Per-item contract: a malformed item (non-dict,
                    # string metadata, ...) fails ITS slot, never the
                    # batch.
                    out[i] = _invalid(f"{type(e).__name__}: {e}").to_status()
                    continue

                def apply(cur, _obj=obj, _expected=expected):
                    if _expected is not None:
                        cur_v = int(
                            cur.get("metadata", {})
                            .get("resourceVersion", "0") or "0"
                        )
                        if cur_v != _expected:
                            raise ConflictError(
                                f"version {_expected} != current {cur_v}"
                            )
                    m_cur = cur.get("metadata", {})
                    m = _obj.setdefault("metadata", {})
                    m["uid"] = m_cur.get("uid", "")
                    m["creationTimestamp"] = m_cur.get(
                        "creationTimestamp", ""
                    )
                    return _obj

                ops.append((info.key(ns, name), apply))
                op_idx.append(i)
            if ops:
                results = self.store.atomic_update_many(
                    ops, copy=copy, copy_results=False
                )
                for i, res in zip(op_idx, results):
                    name = items[i].get("metadata", {}).get("name", "")
                    if isinstance(res, NotFoundError):
                        out[i] = _not_found(info.name, name).to_status()
                    elif isinstance(res, ConflictError):
                        out[i] = _conflict(str(res)).to_status()
                    elif isinstance(res, Exception):
                        out[i] = APIError(
                            500, "InternalError", str(res)
                        ).to_status()
                    else:
                        out[i] = {
                            "kind": "Status", "apiVersion": "v1",
                            "status": "Success", "code": 200,
                            "details": {
                                "name": name,
                                "resourceVersion": res.get("metadata", {})
                                .get("resourceVersion", ""),
                            },
                        }
                        self._commit("UPDATE", info, ns, name, res)
        return out

    def delete_bulk(self, resource: str, namespace: str, names) -> list:
        """POST {resource}:bulkdelete — immediate delete of N objects
        through one store batch (delete_many: one lock hold, one WAL
        append, one fsync). Graceful pod termination is a per-item
        concern; this is the churn-drain path (the reference analog is
        a DeleteCollection)."""
        info = self._info(resource)
        if isinstance(names, dict):
            names = names.get("names", [])
        if info.name in self._BULK_SLOW or self.admission is not None:
            # Per-item when an admission chain is configured so usage
            # bookkeeping (quota release) observes each delete.
            out = []
            for name in names:
                try:
                    self.delete(resource, namespace, name)
                    out.append(
                        {"kind": "Status", "apiVersion": "v1",
                         "status": "Success", "code": 200}
                    )
                except APIError as e:
                    out.append(e.to_status())
            return out
        ns = self._ns(info, namespace)
        out = [None] * len(names)
        keys = []
        key_idx = []
        with self._write_guard():
            for i, name in enumerate(names):
                try:
                    self._admit("DELETE", info, ns, name, None)
                except APIError as e:
                    out[i] = e.to_status()
                    continue
                keys.append(info.key(ns, name))
                key_idx.append(i)
            if keys:
                results = self.store.delete_many(keys)
                for i, res in zip(key_idx, results):
                    if isinstance(res, NotFoundError):
                        out[i] = _not_found(info.name, names[i]).to_status()
                    elif isinstance(res, Exception):
                        out[i] = APIError(
                            500, "InternalError", str(res)
                        ).to_status()
                    else:
                        out[i] = {
                            "kind": "Status", "apiVersion": "v1",
                            "status": "Success", "code": 200,
                        }
                        self._commit("DELETE", info, ns, names[i], None)
        return out

    def create_events_bulk(self, namespace: str, items) -> list:
        """Write many Events in one call — the event broadcaster's
        batched sink. No reference analog: one POST per event
        (pkg/client/record/event.go recordToSink) is viable at the
        reference's 15 binds/s but becomes the control plane's largest
        per-pod cost at 1k+ binds/s. Per-item results; each event still
        takes the normal create path (validation, TTL, watch fan-out)."""
        if isinstance(items, dict):
            items = items.get("items", [])
        results = []
        for ev in items:
            ns = ev.get("metadata", {}).get("namespace") or namespace or "default"
            try:
                self.create("events", ns, ev)
                results.append(
                    {
                        "kind": "Status",
                        "apiVersion": "v1",
                        "status": "Success",
                        "code": 201,
                    }
                )
            except APIError as e:
                results.append(e.to_status())
        return results

    def bind_bulk(
        self, namespace: str, bindings, atomic: bool = False
    ) -> list:
        """Commit many bindings in one call (no reference analog — this
        is the batch-solver commit path: one request for a whole solved
        backlog instead of one per pod). The whole batch runs as ONE
        store apply (atomic_update_many): per-binding lock acquisitions
        would queue the scheduler behind every kubelet status writer
        once per pod — at 1000 nodes that convoy, not the solve, was
        the bind-rate ceiling. Each binding keeps the same guarded
        emptiness check; per-item Status results are returned.

        atomic=True (the gang-commit mode) makes the batch all-or-
        nothing: the first conflict/invalid binding rejects EVERY
        binding in the batch and commits none — the store stages all
        writes and only publishes when every guard passes, so no pod is
        ever observed bound and then rolled back. The failing item
        carries its real error; the rest answer 409 Aborted."""
        from kubernetes_tpu_torch.store import AbortedError, NotFoundError

        if isinstance(bindings, dict):
            atomic = bool(bindings.get("atomic", atomic))
            bindings = bindings.get("bindings", [])
        aborted = APIError(
            409, "Aborted", "atomic bind batch aborted; nothing applied"
        ).to_status()
        out: List[Optional[dict]] = [None] * len(bindings)
        ops = []
        op_idx = []
        for i, binding in enumerate(bindings):
            pod_name = binding.get("metadata", {}).get("name", "")
            target = binding.get("target", {})
            node_name = target.get("name", "")
            if not pod_name or not node_name:
                out[i] = _bad_request(
                    "binding requires metadata.name and target.name"
                ).to_status()
                continue
            if target.get("kind", "") not in ("", "Node", "Minion"):
                out[i] = _bad_request(
                    f"cannot bind to {target.get('kind')!r}"
                ).to_status()
                continue
            key = RESOURCES["pods"].key(namespace or "default", pod_name)

            def assign(cur: dict, _node=node_name, _pod=pod_name) -> dict:
                spec = cur.setdefault("spec", {})
                if spec.get("nodeName"):
                    raise _conflict(
                        f'pod "{_pod}" is already assigned to node '
                        f'"{spec["nodeName"]}"'
                    )
                spec["nodeName"] = _node
                return cur

            ops.append((key, assign))
            op_idx.append(i)
        if atomic and any(o is not None for o in out):
            # A malformed binding rejects the whole atomic batch before
            # any store work (reject-all on first invalid item).
            return [o if o is not None else aborted for o in out]
        if ops:
            # copy_results=False: only per-item status is inspected;
            # a result copy per binding would re-copy the whole solved
            # backlog on every bulk commit.
            results = self.store.atomic_update_many(
                ops, atomic=atomic, copy_results=False
            )
            for i, res in zip(op_idx, results):
                if isinstance(res, APIError):
                    out[i] = res.to_status()
                elif isinstance(res, AbortedError):
                    out[i] = aborted
                elif isinstance(res, NotFoundError):
                    name = bindings[i].get("metadata", {}).get("name", "")
                    out[i] = _not_found("pods", name).to_status()
                elif isinstance(res, Exception):
                    out[i] = APIError(
                        500, "InternalError", str(res)
                    ).to_status()
                else:
                    out[i] = {
                        "kind": "Status",
                        "apiVersion": "v1",
                        "status": "Success",
                        "code": 201,
                    }
        return out
