"""The port's apiserver against the JAX package's, over HTTP.

Twin servers, `kubernetes_tpu.server.httpserver.APIHTTPServer` over the
JAX `APIServer` and the port's over its own, each on its own port, get
the same scripted requests; every status code and body must be equal.
uids and timestamps are patched alike in both packages
(`new_uid` and `now_iso` of each package's `models/objects.py` and
where `server/api.py` imports them), so bodies compare exactly. Each script is one case of a
parametrised test. Covered: CRUD with label and field selectors on
every resource of the registry; 404, 409 on a stale resourceVersion and
422 from validation; bind, bind_bulk, the bulk create, update and
delete verbs, bulk events and the status subresource; namespace
lifecycle; each admission plugin; basic and token auth under ABAC; a
watch from a version, as newline JSON and as websocket frames, and its
410 after compaction; the v1beta3 conversion; /healthz, /api,
/validate, /swagger.json, the apiserver's /metrics families,
/debug/requests and the other debug views, and /replication/*.
"""

import copy
import http.client
import itertools
import json
import re
import time
import types

import pytest

from kubernetes_tpu.models import objects as jax_objects
from kubernetes_tpu.server import admission as jax_admission
from kubernetes_tpu.server import api as jax_api
from kubernetes_tpu.server import auth as jax_auth
from kubernetes_tpu.server import httpserver as jax_http
from kubernetes_tpu.server.registry import unique_resources
from kubernetes_tpu.store.kvstore import KVStore as JaxKVStore
from kubernetes_tpu.utils import flightrecorder as jax_flightrecorder

from kubernetes_tpu_torch.models import objects as port_objects
from kubernetes_tpu_torch.server import admission as port_admission
from kubernetes_tpu_torch.server import api as port_api
from kubernetes_tpu_torch.server import auth as port_auth
from kubernetes_tpu_torch.server import httpserver as port_http
from kubernetes_tpu_torch.server.registry import unique_resources as port_unique_resources
from kubernetes_tpu_torch.store.kvstore import KVStore as PortKVStore
from kubernetes_tpu_torch.utils import flightrecorder as port_flightrecorder
from kubernetes_tpu_torch.utils import websocket as ws

PACKAGES = {
    "jax": (jax_api, jax_http, jax_admission, jax_auth, JaxKVStore, jax_objects),
    "port": (port_api, port_http, port_admission, port_auth, PortKVStore, port_objects),
}
STAMP = "2026-01-01T00:00:00Z"


@pytest.fixture(autouse=True, scope="module")
def jax_request_latency_kept():
    """The JAX apiserver's process-wide request latency histogram as it
    was before this module: the JAX package's SLO gate
    (`tests/test_density.py`) reads it in a process that may have run
    this file first. Other files that serve the JAX apiserver over HTTP
    import it."""
    stats = jax_http._LATENCY._stats
    with jax_http._LATENCY._lock:
        saved = copy.deepcopy(stats)
    yield
    with jax_http._LATENCY._lock:
        stats.clear()
        stats.update(saved)


@pytest.fixture(autouse=True)
def same_uids_and_stamps(monkeypatch):
    """One uid counter a package, the same fixed stamp in both, the same
    wall clock in both `server/api.py`s (a graceful delete stamps its
    deadline from it), and both flight recorders empty (their ring sizes
    are in /healthz)."""
    wall = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                    if not k.startswith("_")})
    wall.time = lambda: 1_767_225_600.0
    for api_mod, _http, _adm, _auth, _kv, obj_mod in PACKAGES.values():
        monkeypatch.setattr(api_mod, "time", wall)
        counter = itertools.count(1)

        def uid(c=counter):
            return f"00000000-0000-4000-8000-{next(c):012d}"

        for mod in (api_mod, obj_mod):
            monkeypatch.setattr(mod, "new_uid", uid)
            monkeypatch.setattr(mod, "now_iso", lambda: STAMP)
    for rec in (jax_flightrecorder.DEFAULT, port_flightrecorder.DEFAULT):
        rec.clear()


def _call(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    data = None if body is None else (body if isinstance(body, bytes) else json.dumps(body).encode())
    hdrs = {"Content-Type": "application/json", **(headers or {})}
    conn.request(method, path, body=data, headers=hdrs)
    resp = conn.getresponse()
    raw = resp.read()
    ctype = resp.getheader("Content-Type", "")
    conn.close()
    if ctype.startswith("application/json"):
        if "watch" in path:  # newline-delimited frames
            return resp.status, [json.loads(x) for x in raw.splitlines() if x.strip()]
        return resp.status, json.loads(raw)
    return resp.status, raw.decode()


class Twin:
    """The JAX apiserver and the port's, built alike and served over
    HTTP; `same(...)` sends one request to both and asserts that the
    answers are equal."""

    def __init__(self, admission=(), auth=None, history_limit=None):
        self.servers = {}
        for name, (api_mod, http_mod, adm_mod, auth_mod, kv, _obj) in PACKAGES.items():
            store = kv(history_limit=history_limit) if history_limit else None
            api = api_mod.APIServer(store=store)
            if admission:
                api.admission = adm_mod.new_from_plugins(api, list(admission))
            authn = authz = None
            if auth:
                authn = auth_mod.UnionAuthenticator(
                    password=auth_mod.PasswordAuthenticator.from_file(auth["basic"]),
                    tokens=[auth_mod.TokenAuthenticator.from_file(auth["token"])],
                )
                authz = auth_mod.ABACAuthorizer.from_file(auth["policy"])
            self.servers[name] = http_mod.APIHTTPServer(
                api, authenticator=authn, authorizer=authz).start()

    def port(self, name):
        return self.servers[name].httpd.server_address[1]

    def both(self, method, path, body=None, headers=None):
        return {name: _call(self.port(name), method, path, body, headers)
                for name in self.servers}

    def same(self, method, path, body=None, headers=None, code=None):
        out = self.both(method, path, body, headers)
        assert out["port"] == out["jax"], (method, path, out)
        if code is not None:
            assert out["port"][0] == code, (method, path, out["port"])
        return out["port"]

    def stop(self):
        for srv in self.servers.values():
            srv.stop()


@pytest.fixture
def twin():
    t = Twin()
    yield t
    t.stop()


def _pod(name, labels=None, node="", cpu=None, **spec):
    container = {"name": "c", "image": "nginx"}
    if cpu:
        container["resources"] = {"limits": {"cpu": cpu, "memory": "64Mi"}}
    body = {"kind": "Pod", "apiVersion": "v1",
            "metadata": {"name": name, "labels": labels or {}},
            "spec": {"containers": [container], **spec}}
    if node:
        body["spec"]["nodeName"] = node
    return body


def _node(name, labels=None):
    return {"kind": "Node", "metadata": {"name": name, "labels": labels or {}},
            "status": {"capacity": {"cpu": "4", "memory": "8Gi", "pods": "20"}}}


#: A valid object of each resource, and a change for its update.
OBJECTS = {
    "pods": (lambda n: _pod(n, {"app": "web"}), ("spec", "activeDeadlineSeconds", 30)),
    "nodes": (lambda n: _node(n, {"app": "web"}), ("spec", "unschedulable", True)),
    "services": (lambda n: {"kind": "Service", "metadata": {"name": n, "labels": {"app": "web"}},
                            "spec": {"selector": {"app": "web"},
                                     "ports": [{"port": 80, "protocol": "TCP"}]}},
                 ("spec", "sessionAffinity", "ClientIP")),
    "endpoints": (lambda n: {"kind": "Endpoints", "metadata": {"name": n, "labels": {"app": "web"}},
                             "subsets": [{"addresses": [{"ip": "10.1.0.1"}],
                                          "ports": [{"port": 80}]}]},
                  ("metadata", "annotations", {"a": "b"})),
    "replicationcontrollers": (
        lambda n: {"kind": "ReplicationController", "metadata": {"name": n, "labels": {"app": "web"}},
                   "spec": {"replicas": 2, "selector": {"app": "web"},
                            "template": {"metadata": {"labels": {"app": "web"}},
                                         "spec": {"containers": [{"name": "c", "image": "x"}]}}}},
        ("spec", "replicas", 3)),
    "events": (lambda n: {"kind": "Event", "metadata": {"name": n, "labels": {"app": "web"}},
                          "involvedObject": {"kind": "Pod", "name": "p", "namespace": "default"},
                          "reason": "Scheduled", "message": "m", "count": 1},
               ("metadata", "annotations", {"a": "b"})),
    "namespaces": (lambda n: {"kind": "Namespace", "metadata": {"name": n, "labels": {"app": "web"}}},
                   ("metadata", "annotations", {"a": "b"})),
    "secrets": (lambda n: {"kind": "Secret", "metadata": {"name": n, "labels": {"app": "web"}},
                           "type": "Opaque", "data": {"k": "dg=="}},
                ("metadata", "annotations", {"a": "b"})),
    "serviceaccounts": (lambda n: {"kind": "ServiceAccount",
                                   "metadata": {"name": n, "labels": {"app": "web"}}},
                        ("metadata", "annotations", {"a": "b"})),
    "limitranges": (lambda n: {"kind": "LimitRange", "metadata": {"name": n, "labels": {"app": "web"}},
                               "spec": {"limits": [{"type": "Container",
                                                    "max": {"cpu": "2"}}]}},
                    ("metadata", "annotations", {"a": "b"})),
    "resourcequotas": (lambda n: {"kind": "ResourceQuota",
                                  "metadata": {"name": n, "labels": {"app": "web"}},
                                  "spec": {"hard": {"pods": "10"}}},
                       ("metadata", "annotations", {"a": "b"})),
    "persistentvolumes": (
        lambda n: {"kind": "PersistentVolume", "metadata": {"name": n, "labels": {"app": "web"}},
                   "spec": {"capacity": {"storage": "1Gi"}, "accessModes": ["ReadWriteOnce"],
                            "persistentVolumeSource": {"nfs": {"server": "10.9.0.1",
                                                               "path": "/export"}}}},
        ("metadata", "annotations", {"a": "b"})),
    "persistentvolumeclaims": (
        lambda n: {"kind": "PersistentVolumeClaim",
                   "metadata": {"name": n, "labels": {"app": "web"}},
                   "spec": {"accessModes": ["ReadWriteOnce"],
                            "resources": {"requests": {"storage": "1Gi"}}}},
        ("metadata", "annotations", {"a": "b"})),
    "podtemplates": (lambda n: {"kind": "PodTemplate", "metadata": {"name": n, "labels": {"app": "web"}},
                                "template": {"spec": {"containers": [{"name": "c", "image": "x"}]}}},
                     ("metadata", "annotations", {"a": "b"})),
    "podgroups": (lambda n: {"kind": "PodGroup", "metadata": {"name": n, "labels": {"app": "web"}},
                             "spec": {"minMember": 2}},
                  ("spec", "minMember", 3)),
    "priorityclasses": (lambda n: {"kind": "PriorityClass",
                                   "metadata": {"name": n, "labels": {"app": "web"}},
                                   "value": 1000},
                        ("metadata", "annotations", {"a": "b"})),
}


def test_the_registries_name_the_same_resources():
    assert ([(i.name, i.kind, i.namespaced, i.ttl) for i in unique_resources()]
            == [(i.name, i.kind, i.namespaced, i.ttl) for i in port_unique_resources()])
    assert {i.name for i in unique_resources()} - {"componentstatuses"} == set(OBJECTS)


def _base(resource, cluster_scoped):
    return f"/api/v1/{resource}" if cluster_scoped else f"/api/v1/namespaces/default/{resource}"


@pytest.mark.parametrize("resource", sorted(OBJECTS))
def test_crud_with_selectors(twin, resource):
    info = {i.name: i for i in unique_resources()}[resource]
    make, (section, key, value) = OBJECTS[resource]
    base = _base(resource, not info.namespaced)
    twin.same("POST", base, make("a1"), code=201)
    other = make("b2")
    other["metadata"]["labels"] = {"app": "db"}
    twin.same("POST", base, other, code=201)
    twin.same("POST", base, make("a1"), code=409)  # already exists
    twin.same("GET", f"{base}/a1", code=200)
    twin.same("GET", f"{base}/missing", code=404)
    for query in ("", "?labelSelector=app%3Dweb", "?labelSelector=app%21%3Dweb",
                  "?labelSelector=app+in+%28web%2Cdb%29", "?fieldSelector=metadata.name%3Db2",
                  "?fieldSelector=metadata.name%21%3Db2"):
        twin.same("GET", base + query, code=200)
    if info.namespaced:
        twin.same("GET", f"/api/v1/{resource}", code=200)  # across namespaces
    _, obj = twin.same("GET", f"{base}/a1")
    changed = json.loads(json.dumps(obj))
    changed.setdefault(section, {})[key] = value
    twin.same("PUT", f"{base}/a1", changed, code=200)
    twin.same("PUT", f"{base}/a1", changed, code=409)  # the version it carries is stale
    twin.same("PATCH", f"{base}/a1", {"metadata": {"labels": {"patched": "yes"}}},
              headers={"Content-Type": "application/merge-patch+json"}, code=200)
    twin.same("PATCH", f"{base}/b2", [{"op": "add", "path": "/metadata/annotations",
                                       "value": {"x": "1"}}],
              headers={"Content-Type": "application/json-patch+json"}, code=200)
    twin.same("GET", base, code=200)
    twin.same("DELETE", f"{base}/a1", code=200)
    twin.same("DELETE", f"{base}/a1")  # gone, or a namespace still Terminating
    twin.same("GET", base, code=200)


INVALID = [
    ("pods", {"kind": "Pod", "metadata": {"name": "Bad_Name"},
              "spec": {"containers": [{"name": "c", "image": "x"}]}}),
    ("pods", {"kind": "Pod", "metadata": {"name": "noc"}, "spec": {"containers": []}}),
    ("pods", {"kind": "Pod", "metadata": {"name": "port"}, "spec": {"containers": [
        {"name": "c", "image": "x", "ports": [{"containerPort": 70000}]}]}}),
    ("services", {"kind": "Service", "metadata": {"name": "noports"}, "spec": {}}),
    ("replicationcontrollers", {"kind": "ReplicationController", "metadata": {"name": "neg"},
                                "spec": {"replicas": -1, "selector": {"a": "b"}}}),
    ("resourcequotas", {"kind": "ResourceQuota", "metadata": {"name": "q"},
                        "spec": {"hard": {"cpu": "-1"}}}),
    ("persistentvolumeclaims", {"kind": "PersistentVolumeClaim", "metadata": {"name": "c"},
                                "spec": {}}),
    ("podgroups", {"kind": "PodGroup", "metadata": {"name": "g"}, "spec": {"minMember": 0}}),
]


@pytest.mark.parametrize("case", range(len(INVALID)))
def test_validation_errors(twin, case):
    resource, body = INVALID[case]
    code, status = twin.same("POST", _base(resource, False), body)
    assert code == 422, status
    # The bulk path validates the wire form and reports the same errors.
    twin.same("POST", f"/api/v1/namespaces/default/{resource}:bulk", {"items": [body]}, code=200)


def test_bind_bulk_verbs_and_status(twin):
    for j in range(3):
        twin.same("POST", "/api/v1/nodes", _node(f"n{j}"), code=201)
    for i in range(6):
        twin.same("POST", "/api/v1/namespaces/default/pods", _pod(f"p{i}"), code=201)
    twin.same("POST", "/api/v1/namespaces/default/bindings",
              {"metadata": {"name": "p0"}, "target": {"kind": "Node", "name": "n0"}}, code=201)
    twin.same("POST", "/api/v1/namespaces/default/bindings",
              {"metadata": {"name": "p0"}, "target": {"kind": "Node", "name": "n1"}}, code=409)
    twin.same("POST", "/api/v1/namespaces/default/pods/p1/binding",
              {"target": {"kind": "Node", "name": "n1"}}, code=201)
    twin.same("POST", "/api/v1/namespaces/default/bindings",
              {"metadata": {"name": "missing"}, "target": {"kind": "Node", "name": "n1"}})
    twin.same("POST", "/api/v1/namespaces/default/bulkbindings", {"bindings": [
        {"metadata": {"name": "p2"}, "target": {"kind": "Node", "name": "n2"}},
        {"metadata": {"name": "p3"}, "target": {"kind": "Node", "name": "n0"}},
        {"metadata": {"name": "p0"}, "target": {"kind": "Node", "name": "n2"}},
        {"metadata": {"name": "nope"}, "target": {"kind": "Node", "name": "n2"}}]}, code=200)
    twin.same("POST", "/api/v1/namespaces/default/bulkbindings", {"atomic": True, "bindings": [
        {"metadata": {"name": "p4"}, "target": {"kind": "Node", "name": "n2"}},
        {"metadata": {"name": "p0"}, "target": {"kind": "Node", "name": "n2"}}]}, code=200)
    twin.same("GET", "/api/v1/namespaces/default/pods?fieldSelector=spec.nodeName%3Dn2")
    twin.same("POST", "/api/v1/namespaces/default/pods:bulk",
              {"items": [_pod(f"q{i}") for i in range(4)] + [_pod("p0")]}, code=200)
    _, listed = twin.same("GET", "/api/v1/namespaces/default/pods?labelSelector=")
    items = [o for o in listed["items"] if o["metadata"]["name"].startswith("q")]
    for o in items:
        o["metadata"].setdefault("labels", {})["tier"] = "bulk"
    items[0]["metadata"]["resourceVersion"] = "1"  # stale: a conflict
    twin.same("POST", "/api/v1/namespaces/default/pods:bulkupdate", {"items": items}, code=200)
    twin.same("POST", "/api/v1/namespaces/default/pods:bulkdelete",
              {"names": ["q2", "q3", "nope"]}, code=200)
    twin.same("POST", "/api/v1/namespaces/default/pods:unknown", {"items": []}, code=404)
    twin.same("POST", "/api/v1/nodes:bulk", {"items": [_node("n3"), _node("n0")]}, code=200)
    twin.same("POST", "/api/v1/namespaces/default/bulkevents", {"items": [
        {"metadata": {"name": f"e{i}"}, "involvedObject": {"kind": "Pod", "name": "p0"},
         "reason": "Scheduled", "message": f"m{i}"} for i in range(3)]}, code=200)
    twin.same("GET", "/api/v1/namespaces/default/events?fieldSelector=involvedObject.name%3Dp0")
    _, pod = twin.same("GET", "/api/v1/namespaces/default/pods/p0")
    pod["status"] = {"phase": "Running", "podIP": "10.2.0.1"}
    pod["spec"]["nodeName"] = "ignored-by-status"
    twin.same("PUT", "/api/v1/namespaces/default/pods/p0/status", pod, code=200)
    twin.same("PUT", "/api/v1/namespaces/default/pods/p0/status", pod)
    _, node = twin.same("GET", "/api/v1/nodes/n0")
    node["status"]["conditions"] = [{"type": "Ready", "status": "True"}]
    twin.same("PUT", "/api/v1/nodes/n0/status", node, code=200)
    twin.same("GET", "/api/v1/namespaces/default/pods?fieldSelector=status.phase%3DRunning")
    twin.same("POST", "/api/v1/namespaces/default/pods/p1/eviction", {}, code=201)
    twin.same("GET", "/api/v1/namespaces/default/pods/p1")
    twin.same("DELETE", "/api/v1/namespaces/default/pods/p1?gracePeriodSeconds=0", code=200)
    twin.same("GET", "/api/v1/componentstatuses")
    twin.same("GET", "/validate")
    twin.same("GET", "/api/v1")
    twin.same("GET", "/api")
    twin.same("GET", "/api/v2/pods", code=404)
    twin.same("GET", "/api/v1/widgets", code=404)
    twin.same("GET", "/api/v1/pods/x", code=400)


def test_namespace_lifecycle(twin):
    ns = "/api/v1/namespaces"
    twin.same("POST", ns, {"kind": "Namespace", "metadata": {"name": "team"}}, code=201)
    twin.same("POST", f"{ns}/team/pods", _pod("p"), code=201)
    twin.same("POST", f"{ns}/team/services", OBJECTS["services"][0]("s"), code=201)
    twin.same("DELETE", f"{ns}/team", code=200)
    twin.same("GET", f"{ns}/team", code=200)  # Terminating, finalizer pending
    twin.same("PUT", f"{ns}/team/finalize",
              {"kind": "Namespace", "metadata": {"name": "team"}, "spec": {"finalizers": []}})
    twin.same("GET", f"{ns}/team")
    twin.same("GET", ns, code=200)
    twin.same("DELETE", f"{ns}/default")
    twin.same("GET", ns, code=200)


def _auth_files(tmp_path):
    basic = tmp_path / "basic.csv"
    basic.write_text("secret,alice,1\nhunter2,bob,2\n")
    token = tmp_path / "token.csv"
    token.write_text("tok-carol,carol,3,admins\n")
    policy = tmp_path / "policy.jsonl"
    policy.write_text("\n".join(json.dumps(p) for p in (
        {"user": "alice"},
        {"user": "bob", "readonly": True},
        {"group": "admins", "resource": "pods", "namespace": "default"},
    )) + "\n")
    return {"basic": str(basic), "token": str(token), "policy": str(policy)}


def _basic(user, password):
    import base64

    return {"Authorization": "Basic " + base64.b64encode(f"{user}:{password}".encode()).decode()}


def test_basic_and_token_auth_under_abac(tmp_path):
    twin = Twin(auth=_auth_files(tmp_path))
    try:
        pods = "/api/v1/namespaces/default/pods"
        twin.same("GET", pods, code=401)  # anonymous: no policy line matches
        twin.same("GET", pods, headers=_basic("alice", "wrong"), code=401)
        twin.same("GET", pods, headers={"Authorization": "Bearer nope"}, code=401)
        twin.same("POST", pods, _pod("a"), headers=_basic("alice", "secret"), code=201)
        twin.same("GET", pods, headers=_basic("bob", "hunter2"), code=200)
        twin.same("POST", pods, _pod("b"), headers=_basic("bob", "hunter2"), code=403)
        twin.same("POST", pods, _pod("c"), headers={"Authorization": "Bearer tok-carol"}, code=201)
        twin.same("GET", "/api/v1/nodes", headers={"Authorization": "Bearer tok-carol"}, code=403)
        twin.same("GET", "/api/v1/watch/pods?timeoutSeconds=0.1",
                  headers={"Authorization": "Bearer tok-carol"}, code=403)
        twin.same("GET", "/debug/requests", code=401)
        twin.same("GET", "/swagger.json", code=401)
        twin.same("GET", "/healthz", code=200)  # probes stay ahead of auth
    finally:
        twin.stop()


LIMIT_RANGE = {"kind": "LimitRange", "metadata": {"name": "limits"}, "spec": {"limits": [
    {"type": "Container", "min": {"cpu": "100m"}, "max": {"cpu": "2", "memory": "1Gi"},
     "default": {"cpu": "250m", "memory": "128Mi"}}]}}
QUOTA = {"kind": "ResourceQuota", "metadata": {"name": "q"},
         "spec": {"hard": {"pods": "2", "cpu": "1"}}}
PRIVILEGED = {"securityContext": {"privileged": True}}

#: (plugins, requests) per admission case: each request (method, path, body).
ADMISSION = {
    "AlwaysAdmit": [("POST", "/api/v1/namespaces/default/pods", _pod("a"))],
    "AlwaysDeny": [("POST", "/api/v1/namespaces/default/pods", _pod("a")),
                   ("GET", "/api/v1/namespaces/default/pods", None)],
    "NamespaceExists": [
        ("POST", "/api/v1/namespaces/nope/pods", _pod("a")),
        ("POST", "/api/v1/namespaces", {"kind": "Namespace", "metadata": {"name": "nope"}}),
        ("POST", "/api/v1/namespaces/nope/pods", _pod("a"))],
    "NamespaceAutoProvision": [
        ("POST", "/api/v1/namespaces/fresh/pods", _pod("a")),
        ("GET", "/api/v1/namespaces/fresh", None)],
    "NamespaceLifecycle": [
        ("POST", "/api/v1/namespaces", {"kind": "Namespace", "metadata": {"name": "gone"}}),
        ("DELETE", "/api/v1/namespaces/gone", None),
        ("POST", "/api/v1/namespaces/gone/pods", _pod("a")),
        ("DELETE", "/api/v1/namespaces/default", None),
        ("POST", "/api/v1/namespaces/never/pods", _pod("a"))],
    "LimitRanger": [
        ("POST", "/api/v1/namespaces/default/limitranges", LIMIT_RANGE),
        ("POST", "/api/v1/namespaces/default/pods", _pod("a")),
        ("POST", "/api/v1/namespaces/default/pods", _pod("b", cpu="4")),
        ("POST", "/api/v1/namespaces/default/pods", _pod("c", cpu="50m")),
        ("PATCH", "/api/v1/namespaces/default/pods/a", {"spec": {"containers": [
            {"name": "c", "image": "nginx", "resources": {"limits": {"cpu": "4"}}}]}})],
    "ResourceQuota": [
        ("POST", "/api/v1/namespaces/default/resourcequotas", QUOTA),
        ("POST", "/api/v1/namespaces/default/pods", _pod("a", cpu="800m")),
        ("POST", "/api/v1/namespaces/default/pods", _pod("b", cpu="500m")),
        ("POST", "/api/v1/namespaces/default/pods", _pod("c", cpu="100m")),
        ("POST", "/api/v1/namespaces/default/pods", _pod("d", cpu="50m")),
        ("GET", "/api/v1/namespaces/default/resourcequotas/q", None),
        ("DELETE", "/api/v1/namespaces/default/pods/a", None),
        ("GET", "/api/v1/namespaces/default/resourcequotas/q", None)],
    "ServiceAccount": [
        ("POST", "/api/v1/namespaces/default/pods", _pod("a")),
        ("POST", "/api/v1/namespaces/default/serviceaccounts",
         {"kind": "ServiceAccount", "metadata": {"name": "robot"}}),
        ("POST", "/api/v1/namespaces/default/pods", _pod("b", serviceAccount="robot")),
        ("POST", "/api/v1/namespaces/default/pods", _pod("c", serviceAccount="ghost")),
        ("GET", "/api/v1/namespaces/default/secrets", None)],
    "PodGroup": [
        ("POST", "/api/v1/namespaces/default/pods",
         _pod("a", {"pod-group.kubernetes-tpu.io/name": "g"})),
        ("POST", "/api/v1/namespaces/default/podgroups",
         {"kind": "PodGroup", "metadata": {"name": "g"}, "spec": {"minMember": 2}}),
        ("POST", "/api/v1/namespaces/default/pods",
         _pod("b", {"pod-group.kubernetes-tpu.io/name": "g"})),
        ("GET", "/api/v1/namespaces/default/podgroups/g", None)],
    "Priority": [
        ("POST", "/api/v1/priorityclasses",
         {"kind": "PriorityClass", "metadata": {"name": "high"}, "value": 1000}),
        ("POST", "/api/v1/priorityclasses",
         {"kind": "PriorityClass", "metadata": {"name": "base"}, "value": 10,
          "globalDefault": True}),
        ("POST", "/api/v1/namespaces/default/pods", _pod("a", priorityClassName="high")),
        ("POST", "/api/v1/namespaces/default/pods", _pod("b")),
        ("POST", "/api/v1/namespaces/default/pods", _pod("c", priorityClassName="nope")),
        ("POST", "/api/v1/namespaces/default/pods", _pod("d", priority=5))],
    "SecurityContextDeny": [
        ("POST", "/api/v1/namespaces/default/pods", {**_pod("a"), "spec": {"containers": [
            {"name": "c", "image": "x", **PRIVILEGED}]}}),
        ("POST", "/api/v1/namespaces/default/pods", _pod("b"))],
    "DenyExecOnPrivileged": [
        ("POST", "/api/v1/namespaces/default/pods", {**_pod("a", node="n0"), "spec": {
            "nodeName": "n0", "containers": [{"name": "c", "image": "x", **PRIVILEGED}]}}),
        ("POST", "/api/v1/namespaces/default/pods/a/exec", {"command": ["ls"]}),
        ("POST", "/api/v1/namespaces/default/pods/missing/exec", {"command": ["ls"]})],
    "NamespaceLifecycle,LimitRanger,ServiceAccount,ResourceQuota": [
        ("POST", "/api/v1/namespaces/default/resourcequotas", QUOTA),
        ("POST", "/api/v1/namespaces/default/limitranges", LIMIT_RANGE),
        ("POST", "/api/v1/namespaces/default/pods", _pod("a")),
        ("POST", "/api/v1/namespaces/default/pods", _pod("b")),
        ("GET", "/api/v1/namespaces/default/resourcequotas/q", None)],
}


@pytest.mark.parametrize("plugins", sorted(ADMISSION))
def test_admission_plugins(plugins):
    twin = Twin(admission=plugins.split(","))
    try:
        for method, path, body in ADMISSION[plugins]:
            twin.same(method, path, body)
        twin.same("GET", "/api/v1/namespaces/default/pods")
    finally:
        twin.stop()


def _ws_frames(port, path):
    client = ws.WebSocketClient("127.0.0.1", port, path, timeout=10)
    frames = []
    try:
        while True:
            text = client.recv_text()
            if text is None:
                break
            frames.append(json.loads(text))
    finally:
        client.close()
    return frames


def test_watch_from_a_version_as_json_and_websocket(twin):
    pods = "/api/v1/namespaces/default/pods"
    twin.same("POST", pods, _pod("w0", {"app": "web"}), code=201)
    _, listed = twin.same("GET", pods)
    since = listed["metadata"]["resourceVersion"]
    twin.same("POST", pods, _pod("w1", {"app": "web"}), code=201)
    twin.same("POST", pods, _pod("w2", {"app": "db"}), code=201)
    twin.same("POST", "/api/v1/nodes", _node("n0"), code=201)
    twin.same("POST", f"{pods}/w1/binding", {"target": {"kind": "Node", "name": "n0"}}, code=201)
    twin.same("PATCH", f"{pods}/w2", {"metadata": {"labels": {"app": "web"}}},
              headers={"Content-Type": "application/merge-patch+json"}, code=200)
    twin.same("DELETE", f"{pods}/w0", code=200)
    for query in (f"resourceVersion={since}", f"resourceVersion={since}&labelSelector=app%3Dweb",
                  f"resourceVersion={since}&fieldSelector=spec.nodeName%3Dn0", "resourceVersion=1"):
        for path in (f"/api/v1/watch/namespaces/default/pods?{query}",
                     f"/api/v1/watch/pods?{query}", f"{pods}?watch=true&{query}"):
            code, frames = twin.same("GET", path + "&timeoutSeconds=0.3")
            assert code == 200 and frames
            by_ws = {name: _ws_frames(twin.port(name), path + "&timeoutSeconds=0.3")
                     for name in twin.servers}
            assert by_ws["port"] == by_ws["jax"] == frames
    twin.same("GET", "/api/v1/watch/pods?resourceVersion=x", code=400)
    twin.same("GET", "/api/v1/watch/bad/path/x", code=404)


def test_watch_after_compaction_is_gone():
    twin = Twin(history_limit=4)
    try:
        for i in range(12):
            twin.same("POST", "/api/v1/namespaces/default/pods", _pod(f"c{i}"), code=201)
        twin.same("GET", "/api/v1/watch/pods?resourceVersion=1&timeoutSeconds=0.2", code=410)
        _, listed = twin.same("GET", "/api/v1/namespaces/default/pods")
        rv = listed["metadata"]["resourceVersion"]
        twin.same("GET", f"/api/v1/watch/pods?resourceVersion={rv}&timeoutSeconds=0.2", code=200)
        with pytest.raises(ConnectionError):
            ws.WebSocketClient("127.0.0.1", twin.port("port"),
                               "/api/v1/watch/pods?resourceVersion=1", timeout=5)
    finally:
        twin.stop()


def test_v1beta3_conversion(twin):
    old = "/api/v1beta3/namespaces/default"
    twin.same("POST", "/api/v1/nodes", _node("n0"), code=201)
    pod = _pod("legacy")
    pod["apiVersion"] = "v1beta3"
    pod["spec"]["host"] = "n0"
    pod["spec"]["containers"][0]["privileged"] = True
    twin.same("POST", f"{old}/pods", pod, code=201)
    twin.same("GET", f"{old}/pods/legacy", code=200)
    twin.same("GET", "/api/v1/namespaces/default/pods/legacy", code=200)
    svc = {"kind": "Service", "apiVersion": "v1beta3", "metadata": {"name": "s"},
           "spec": {"portalIP": "10.0.0.50", "createExternalLoadBalancer": True,
                    "publicIPs": ["1.2.3.4"], "ports": [{"port": 80}]}}
    twin.same("POST", f"{old}/services", svc, code=201)
    twin.same("GET", f"{old}/services/s")
    twin.same("GET", "/api/v1/namespaces/default/services/s")
    twin.same("GET", f"{old}/pods/missing", code=404)
    twin.same("GET", f"/api/v1beta3/watch/namespaces/default/pods?resourceVersion=1"
                     "&timeoutSeconds=0.2", code=200)


def _metric_families(source_files):
    names = set()
    for path in source_files:
        with open(path) as f:
            names |= set(re.findall(
                r'metrics\.DEFAULT\.(?:counter|gauge|histogram|summary)\(\s*"([a-z_]+)"', f.read()))
    return names


def test_health_metrics_swagger_and_debug_views(twin):
    import os

    import kubernetes_tpu

    twin.same("GET", "/healthz", code=200)
    twin.same("POST", "/api/v1/namespaces/default/pods", _pod("m0"), code=201)
    twin.same("GET", "/api/v1/namespaces/default/pods/m0", code=200)
    twin.same("GET", "/api/v1/namespaces/default/pods/nope", code=404)
    twin.same("GET", "/healthz", code=200)
    twin.same("GET", "/swagger.json", code=200)
    twin.same("GET", "/swaggerapi", code=200)
    twin.same("GET", "/replication/status", code=404)
    twin.same("GET", "/replication/other", code=404)
    twin.same("POST", "/replication/append", {"lines": []}, code=409)
    for view in ("nope", "decisions?limit=x", "traces?limit=x", "timeseries?window=x",
                 "profile?format=svg", "profile?seconds=x", "device-profile?seconds=x",
                 "alerts", "capacity", "rebalance"):
        twin.same("GET", f"/debug/{view}")
    twin.same("GET", "/debug/timeseries?window=60", code=200)
    # The rings, the SLO series and the kernel ledger are each package's
    # process-wide ones, which other tests in this process fill.
    for view in ("health", "slo", "solves", "decisions", "traces", "kernels"):
        out = twin.both("GET", f"/debug/{view}")
        assert out["jax"][0] == out["port"][0] == 200, (view, out)
    # The request log is each package's process-wide ring: compare the
    # rows of requests marked for this test.
    twin.same("GET", "/api/v1/namespaces/default/pods/req-marker-a", code=404)
    twin.same("POST", "/api/v1/namespaces/default/pods?req-marker=b", _pod("m1"), code=201)
    twin.same("GET", "/healthz?req-marker=c", code=200)
    twin.same("GET", "/api/v1/namespaces/default/pods?req-marker=d&labelSelector=x%3Dy")
    # Both servers write a request's row after its response has gone
    # out, so a row may land after the next request's: poll until each
    # log holds all four marked rows, then compare them as sorted lists.
    rows = {}
    deadline = time.monotonic() + 5
    while True:
        for name, (code, text) in twin.both("GET", "/debug/requests").items():
            assert code == 200
            lines = text.splitlines()
            # TIME (two columns) and MS vary; CODE, TRACE, VERB and PATH do not.
            rows[name] = (lines[0], sorted((ln.split()[2], *ln.split()[4:])
                                           for ln in lines[1:] if "req-marker" in ln))
        if all(len(r[1]) == 4 for r in rows.values()) or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert rows["port"] == rows["jax"] and len(rows["port"][1]) == 4
    (jv, jbody), (pv, pbody) = (twin.both("GET", "/version")[k] for k in ("jax", "port"))
    assert jv == pv == 200 and jbody["gitVersion"] == pbody["gitVersion"]
    assert (jbody["platform"], pbody["platform"]) == ("tpu", "gpu")
    jax_root = os.path.dirname(kubernetes_tpu.__file__)
    sources = [os.path.join(jax_root, *p.split("/")) for p in (
        "server/httpserver.py", "server/api.py", "store/watch.py", "store/kvstore.py",
        "utils/timeseries.py", "utils/alerts.py")]
    families = _metric_families(sources) | {"pod_startup_latency_seconds",
                                            "watch_fanout_lag_versions"}
    texts = {name: twin.both("GET", "/metrics")[name][1] for name in ("jax",)}
    texts["port"] = twin.both("GET", "/metrics")["port"][1]
    declared = {name: {f for f in families if f"# TYPE {f} " in text}
                for name, text in texts.items()}
    assert declared["port"] == declared["jax"] and "apiserver_request_count" in declared["port"]
