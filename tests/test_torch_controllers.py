"""The port's controllers and controller-manager against the JAX package's.

Twin apiservers, the JAX `APIServer` under the JAX client and the
port's under the port's (each over its `LocalTransport`), get the same
objects; the JAX controller runs on one and the port's on the other,
driven by `sync_once`, `sync_all` and `monitor` (their informers primed
by one synchronous LIST, `reflector._list()`), and after each step the
stored objects must be equal. uids and timestamps are patched alike in
both packages; node lifecycle runs on one injected monotonic clock.

Covered: the namespace controller's two-phase delete and finalizers;
quota recomputation and a create the quota rejects; the default
service account and a verifiable token; the claim binder's matching and
release and the recycler's scrub; the replication manager's scale up
(each pod's whole body equal, containers, env, volumes and probes
included: pods are created by 8 threads in no fixed order, so each RC's
pods are compared as a multiset of bodies with the generated names,
uids and versions normalised), scale down with unbound pods first and
the status write-back; endpoints from Ready pods with IPs and the
orphan GC; a node marked NotReady after the grace and its pods evicted
after the timeout; the gang controller's cases of
`tests/test_gang.py::TestGangController`; and `ControllerManager`'s
controller list for every combination of its flags.
"""

import base64
import itertools
import json
import types

import pytest

from kubernetes_tpu.client import rest as jax_rest
from kubernetes_tpu.controllers import descheduler as jax_desched
from kubernetes_tpu.controllers import autoscaler as jax_autoscaler
from kubernetes_tpu.controllers import endpoints as jax_endpoints
from kubernetes_tpu.controllers import gangs as jax_gangs
from kubernetes_tpu.controllers import manager as jax_manager
from kubernetes_tpu.controllers import namespace as jax_namespace
from kubernetes_tpu.controllers import nodelifecycle as jax_nodelifecycle
from kubernetes_tpu.controllers import pvrecycler as jax_pvrecycler
from kubernetes_tpu.controllers import replication as jax_replication
from kubernetes_tpu.controllers import resourcequota as jax_resourcequota
from kubernetes_tpu.controllers import serviceaccounts as jax_serviceaccounts
from kubernetes_tpu.controllers import volumeclaimbinder as jax_volumeclaimbinder
from kubernetes_tpu.models import objects as jax_objects
from kubernetes_tpu.server import admission as jax_admission
from kubernetes_tpu.server import api as jax_api
from kubernetes_tpu.server import auth as jax_auth

from kubernetes_tpu_torch.client import rest as port_rest
from kubernetes_tpu_torch.controllers import autoscaler as port_autoscaler
from kubernetes_tpu_torch.controllers import descheduler as port_desched
from kubernetes_tpu_torch.controllers import endpoints as port_endpoints
from kubernetes_tpu_torch.controllers import gangs as port_gangs
from kubernetes_tpu_torch.controllers import manager as port_manager
from kubernetes_tpu_torch.controllers import namespace as port_namespace
from kubernetes_tpu_torch.controllers import nodelifecycle as port_nodelifecycle
from kubernetes_tpu_torch.controllers import pvrecycler as port_pvrecycler
from kubernetes_tpu_torch.controllers import replication as port_replication
from kubernetes_tpu_torch.controllers import resourcequota as port_resourcequota
from kubernetes_tpu_torch.controllers import serviceaccounts as port_serviceaccounts
from kubernetes_tpu_torch.controllers import volumeclaimbinder as port_volumeclaimbinder
from kubernetes_tpu_torch.models import apiobjects as port_apiobjects
from kubernetes_tpu_torch.models import objects as port_objects
from kubernetes_tpu_torch.server import admission as port_admission
from kubernetes_tpu_torch.server import api as port_api
from kubernetes_tpu_torch.server import auth as port_auth

STAMP = "2026-01-01T00:00:00Z"
T0 = 1_767_225_600.0  # STAMP as epoch seconds
POD_GROUP_LABEL = "pod-group.kubernetes-tpu.io/name"


def _pkg(name, rest, api, adm, auth, objs, extra_obj_mods, **controllers):
    return types.SimpleNamespace(name=name, rest=rest, api_mod=api, adm=adm, auth=auth,
                                 obj_mods=(objs, *extra_obj_mods), **controllers)


JAX = _pkg("jax", jax_rest, jax_api, jax_admission, jax_auth, jax_objects, (),
           namespace=jax_namespace, resourcequota=jax_resourcequota,
           serviceaccounts=jax_serviceaccounts, volumeclaimbinder=jax_volumeclaimbinder,
           pvrecycler=jax_pvrecycler, replication=jax_replication, endpoints=jax_endpoints,
           nodelifecycle=jax_nodelifecycle, gangs=jax_gangs, manager=jax_manager,
           desched=jax_desched, autoscaler=jax_autoscaler)
PORT = _pkg("port", port_rest, port_api, port_admission, port_auth, port_objects,
            (port_apiobjects,),
            namespace=port_namespace, resourcequota=port_resourcequota,
            serviceaccounts=port_serviceaccounts, volumeclaimbinder=port_volumeclaimbinder,
            pvrecycler=port_pvrecycler, replication=port_replication, endpoints=port_endpoints,
            nodelifecycle=port_nodelifecycle, gangs=port_gangs, manager=port_manager,
            desched=port_desched, autoscaler=port_autoscaler)
BOTH = (JAX, PORT)


class Clock:
    """One monotonic clock for both node lifecycle controllers."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


@pytest.fixture(autouse=True)
def same_uids_and_stamps(monkeypatch):
    for pkg in BOTH:
        counter = itertools.count(1)

        def uid(c=counter):
            return f"00000000-0000-4000-8000-{next(c):012d}"

        for mod in (pkg.api_mod, *pkg.obj_mods):
            monkeypatch.setattr(mod, "new_uid", uid)
            monkeypatch.setattr(mod, "now_iso", lambda: STAMP)
        monkeypatch.setattr(pkg.nodelifecycle, "now_iso", lambda: STAMP)


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    for pkg in BOTH:
        monkeypatch.setattr(pkg.nodelifecycle, "time", types.SimpleNamespace(monotonic=c.monotonic))
    return c


class Twin:
    """One apiserver and client a package; `each(fn)` runs fn(pkg, side)
    on both and returns {package: result}."""

    def __init__(self, admission=()):
        self.side = {}
        for pkg in BOTH:
            api = pkg.api_mod.APIServer()
            if admission:
                api.admission = pkg.adm.new_from_plugins(api, list(admission))
            self.side[pkg.name] = types.SimpleNamespace(
                pkg=pkg, api=api, client=pkg.rest.Client(pkg.rest.LocalTransport(api)))

    def each(self, fn):
        return {name: fn(s.pkg, s) for name, s in self.side.items()}

    def same(self, fn):
        got = self.each(fn)
        assert got["port"] == got["jax"]
        return got["port"]

    def create(self, resource, ns, obj):
        for s in self.side.values():
            s.api.create(resource, ns, json.loads(json.dumps(obj)))

    def call(self, method, *args):
        """The same apiserver call on both; the answers must be equal."""
        out = {}
        for name, s in self.side.items():
            try:
                out[name] = getattr(s.api, method)(*json.loads(json.dumps(args)))
            except Exception as e:
                out[name] = (type(e).__name__, getattr(e, "code", None))
        assert out["port"] == out["jax"], method
        return out["port"]

    def stored(self, *resources, ns=""):
        """Every stored object of these resources, equal in both."""
        return self.same(lambda pkg, s: {r: s.api.list(r, ns)["items"] for r in resources})


def prime(*informers):
    """Fill each informer's cache by one LIST (its handlers see ADDED)."""
    for inf in informers:
        inf.reflector._list()


def mkpod(name, ns="default", cpu=None):
    spec = {"containers": [{"name": "c", "image": "i"}]}
    if cpu:
        spec["containers"][0]["resources"] = {"limits": {"cpu": cpu}}
    return {"kind": "Pod", "metadata": {"name": name, "namespace": ns}, "spec": spec}


# -- namespace -----------------------------------------------------------


def test_namespace_two_phase_delete_and_finalizers_as_jax():
    tw = Twin()
    tw.create("namespaces", "", {"metadata": {"name": "team"}})
    tw.create("pods", "team", mkpod("p1", "team"))
    tw.create("secrets", "team", {"kind": "Secret", "metadata": {"name": "s1"}})
    tw.create("namespaces", "", {"metadata": {"name": "keep"}})
    tw.create("pods", "keep", mkpod("p1", "keep"))
    tw.create("namespaces", "", {"metadata": {"name": "guarded"},
                                 "spec": {"finalizers": ["kubernetes", "example.com/cleanup"]}})
    tw.create("pods", "guarded", mkpod("g1", "guarded"))
    tw.call("delete", "namespaces", "", "team")
    tw.call("delete", "namespaces", "", "guarded")
    mgrs = tw.each(lambda pkg, s: pkg.namespace.NamespaceManager(s.client))
    first = tw.same(lambda pkg, s: mgrs[pkg.name].sync_once())
    assert first == 1  # team finalized; guarded held by a foreign finalizer
    after = tw.stored("namespaces", "pods", "secrets")
    names = {n["metadata"]["name"]: n for n in after["namespaces"]}
    assert "team" not in names and names["guarded"]["spec"]["finalizers"] == [
        "example.com/cleanup"]
    assert {(p["metadata"]["namespace"], p["metadata"]["name"]) for p in after["pods"]} == {
        ("keep", "p1")}
    tw.call("finalize_namespace", "guarded", {"spec": {"finalizers": []}})
    assert tw.same(lambda pkg, s: mgrs[pkg.name].sync_once()) == 1
    assert "guarded" not in {n["metadata"]["name"] for n in tw.stored("namespaces")["namespaces"]}
    # A namespace with no finalizer is deleted at once.
    tw.create("namespaces", "", {"metadata": {"name": "plain"}})
    tw.call("finalize_namespace", "plain", {"spec": {"finalizers": []}})
    tw.call("delete", "namespaces", "", "plain")
    tw.call("get", "namespaces", "", "plain")  # 404 in both
    assert tw.same(lambda pkg, s: mgrs[pkg.name].sync_once()) == 0


# -- resource quota ------------------------------------------------------


def test_quota_recomputation_and_rejected_create_as_jax():
    tw = Twin()
    tw.create("resourcequotas", "default", {"kind": "ResourceQuota", "metadata": {"name": "q"},
                                            "spec": {"hard": {"pods": "10", "cpu": "4",
                                                              "secrets": "3"}}})
    tw.create("pods", "default", mkpod("a", cpu="500m"))
    tw.create("pods", "default", mkpod("b", cpu="250m"))
    tw.create("secrets", "default", {"kind": "Secret", "metadata": {"name": "s"}})
    mgrs = tw.each(lambda pkg, s: pkg.resourcequota.ResourceQuotaManager(s.client))
    assert tw.same(lambda pkg, s: mgrs[pkg.name].sync_once()) == 1
    quota = tw.stored("resourcequotas", ns="default")["resourcequotas"][0]
    assert quota["status"]["used"] == {"pods": "2", "cpu": "750m", "secrets": "1"}
    assert tw.same(lambda pkg, s: mgrs[pkg.name].sync_once()) == 0  # no drift, no write
    tw.call("delete", "pods", "default", "a")  # drift: a missed delete
    assert tw.same(lambda pkg, s: mgrs[pkg.name].sync_once()) == 1
    tw.stored("resourcequotas", "pods", ns="default")


def test_quota_rejected_create_leaves_status_as_jax():
    tw = Twin(admission=("ResourceQuota",))
    tw.create("resourcequotas", "default", {"kind": "ResourceQuota", "metadata": {"name": "q"},
                                            "spec": {"hard": {"pods": "1"}}})
    tw.call("create", "pods", "default", mkpod("a"))
    tw.call("create", "pods", "default", mkpod("a"))  # 409 after admission
    tw.call("create", "pods", "default", mkpod("b"))  # 403: over the quota
    mgrs = tw.each(lambda pkg, s: pkg.resourcequota.ResourceQuotaManager(s.client))
    tw.same(lambda pkg, s: mgrs[pkg.name].sync_once())
    quota = tw.stored("resourcequotas", ns="default")["resourcequotas"][0]
    assert quota["status"]["used"]["pods"] == "1"


# -- service accounts ----------------------------------------------------


def test_default_service_account_and_verifiable_token_as_jax():
    tw = Twin()
    tw.create("namespaces", "", {"metadata": {"name": "apps"}})
    sa = tw.each(lambda pkg, s: pkg.serviceaccounts.ServiceAccountsController(s.client))
    assert tw.same(lambda pkg, s: sa[pkg.name].sync_once()) >= 2  # default + apps
    assert tw.same(lambda pkg, s: sa[pkg.name].sync_once()) == 0  # idempotent
    managers = tw.each(lambda pkg, s: pkg.auth.ServiceAccountTokenManager(b"test-key"))
    tc = tw.each(lambda pkg, s: pkg.serviceaccounts.TokenController(s.client,
                                                                     managers[pkg.name]))
    assert tw.same(lambda pkg, s: tc[pkg.name].sync_once()) >= 1
    stored = tw.stored("secrets", "serviceaccounts")
    secret = next(x for x in stored["secrets"] if x["metadata"]["name"] == "default-token"
                  and x["metadata"]["namespace"] == "default")
    assert secret["type"] == "kubernetes.io/service-account-token"
    token = base64.b64decode(secret["data"]["token"]).decode()
    users = tw.each(lambda pkg, s: managers[pkg.name].authenticate_token(token).name)
    assert users == {"jax": "system:serviceaccount:default:default",
                     "port": "system:serviceaccount:default:default"}
    assert tw.same(lambda pkg, s: tc[pkg.name].sync_once()) == 0


# -- persistent volumes --------------------------------------------------


def mkpv(name, storage, modes=("ReadWriteOnce",), reclaim="Retain", path=None):
    return {"kind": "PersistentVolume", "metadata": {"name": name},
            "spec": {"capacity": {"storage": storage}, "accessModes": list(modes),
                     "persistentVolumeSource": {"hostPath": {"path": path or f"/tmp/{name}"}},
                     "persistentVolumeReclaimPolicy": reclaim}}


def mkpvc(name, storage, modes=("ReadWriteOnce",), ns="default"):
    return {"kind": "PersistentVolumeClaim", "metadata": {"name": name, "namespace": ns},
            "spec": {"accessModes": list(modes), "resources": {"requests": {"storage": storage}}}}


def test_claim_binder_matching_and_release_as_jax():
    tw = Twin()
    tw.create("persistentvolumes", "", mkpv("small", "1Gi"))
    tw.create("persistentvolumes", "", mkpv("big", "100Gi"))
    tw.create("persistentvolumes", "", mkpv("rwo", "10Gi", reclaim="Recycle"))
    tw.create("persistentvolumeclaims", "default", mkpvc("c1", "500Mi"))
    tw.create("persistentvolumeclaims", "default", mkpvc("huge", "500Gi"))
    tw.create("persistentvolumeclaims", "default", mkpvc("rwx", "1Gi", modes=("ReadWriteMany",)))
    binders = tw.each(lambda pkg, s: pkg.volumeclaimbinder.PersistentVolumeClaimBinder(s.client))
    assert tw.same(lambda pkg, s: binders[pkg.name].sync_once()) == 1
    stored = tw.stored("persistentvolumes", "persistentvolumeclaims")
    claims = {c["metadata"]["name"]: c for c in stored["persistentvolumeclaims"]}
    assert claims["c1"]["spec"]["volumeName"] == "small"
    assert claims["c1"]["status"]["phase"] == "Bound"
    assert not claims["huge"]["spec"].get("volumeName")
    assert not claims["rwx"]["spec"].get("volumeName")
    tw.create("persistentvolumeclaims", "default", mkpvc("c2", "2Gi"))
    assert tw.same(lambda pkg, s: binders[pkg.name].sync_once()) == 1  # c2 -> rwo
    tw.call("delete", "persistentvolumeclaims", "default", "c1")
    tw.call("delete", "persistentvolumeclaims", "default", "c2")
    tw.same(lambda pkg, s: binders[pkg.name].sync_once())
    pvs = {v["metadata"]["name"]: v for v in tw.stored("persistentvolumes")["persistentvolumes"]}
    assert pvs["small"]["status"]["phase"] == "Released"  # Retain
    assert pvs["rwo"]["status"]["phase"] == "Released"  # Recycle waits for the scrub
    assert pvs["big"]["status"]["phase"] == "Available"


@pytest.mark.parametrize("case", ["recycle", "retain", "nfs", "missing_dir"])
def test_recycler_as_jax(tmp_path, case):
    """One volume, bound, released and recycled by each package in turn
    over the same directory (set up afresh for each)."""
    voldir = tmp_path / "vol"

    def fill():
        if voldir.exists():
            import shutil

            shutil.rmtree(voldir)
        if case == "missing_dir":
            return
        voldir.mkdir()
        (voldir / "old-tenant-data.txt").write_text("secret")
        (voldir / "sub").mkdir()
        (voldir / "sub" / "f").write_text("x")

    def run(pkg, side):
        fill()
        pv = mkpv("rv", "10Gi", reclaim="Retain" if case == "retain" else "Recycle",
                  path=str(voldir))
        if case == "nfs":
            pv["spec"]["persistentVolumeSource"] = {"nfs": {"server": "fs", "path": "/x"}}
        side.api.create("persistentvolumes", "", pv)
        side.api.create("persistentvolumeclaims", "default", mkpvc("c1", "1Gi"))
        binder = pkg.volumeclaimbinder.PersistentVolumeClaimBinder(side.client)
        recycler = pkg.pvrecycler.PersistentVolumeRecycler(side.client)
        binder.sync_once()
        side.api.delete("persistentvolumeclaims", "default", "c1")
        binder.sync_once()
        recycled = recycler.sync_once()
        left = sorted(p.name for p in voldir.iterdir()) if voldir.is_dir() else None
        rebound = None
        if case == "recycle":
            side.api.create("persistentvolumeclaims", "default", mkpvc("c2", "1Gi"))
            rebound = binder.sync_once()
        return recycled, left, rebound, side.api.list("persistentvolumes", "")["items"]

    tw = Twin()
    got = tw.same(run)
    recycled, left, rebound, pvs = got
    phase = pvs[0]["status"]["phase"]
    assert {"recycle": (1, [], 1, "Bound"), "retain": (0, ["old-tenant-data.txt", "sub"], None,
                                                       "Released"),
            "nfs": (0, ["old-tenant-data.txt", "sub"], None, "Failed"),
            "missing_dir": (0, None, None, "Failed")}[case] == (recycled, left, rebound, phase)


# -- replication manager -------------------------------------------------


RC_TEMPLATE_SPEC = {
    "containers": [{
        "name": "web", "image": "nginx:1.7", "command": ["nginx"], "args": ["-g", "daemon off;"],
        "workingDir": "/srv", "ports": [{"name": "http", "containerPort": 80, "protocol": "TCP"}],
        "env": [{"name": "MODE", "value": "prod"}, {"name": "LEVEL", "value": "3"}],
        "resources": {"limits": {"cpu": "250m", "memory": "64Mi"},
                      "requests": {"cpu": "100m", "memory": "32Mi"}},
        "volumeMounts": [{"name": "data", "mountPath": "/data"},
                         {"name": "cfg", "mountPath": "/etc/cfg", "readOnly": True}],
        "livenessProbe": {"httpGet": {"path": "/healthz", "port": 80},
                          "initialDelaySeconds": 5, "timeoutSeconds": 2},
        "readinessProbe": {"exec": {"command": ["cat", "/ready"]}},
        "imagePullPolicy": "IfNotPresent",
    }, {"name": "sidecar", "image": "busybox", "command": ["sh", "-c", "sleep 3600"]}],
    "volumes": [{"name": "data", "emptyDir": {}},
                {"name": "cfg", "hostPath": {"path": "/etc/app"}},
                {"name": "disk", "gcePersistentDisk": {"pdName": "pd-1", "fsType": "ext4"}}],
    "restartPolicy": "Always", "dnsPolicy": "ClusterFirst",
    "nodeSelector": {"zone": "z1"}, "terminationGracePeriodSeconds": 30,
}


def rc_wire(name, replicas, app, spec=None):
    return {"kind": "ReplicationController", "apiVersion": "v1",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"replicas": replicas, "selector": {"app": app},
                     "template": {"metadata": {"labels": {"app": app, "tier": "fe"}},
                                  "spec": spec or RC_TEMPLATE_SPEC}}}


def normalised(pods):
    """Pod bodies with the generated name, uid and version taken out,
    as a sorted multiset (JSON text)."""
    out = []
    for p in pods:
        p = json.loads(json.dumps(p))
        meta = p["metadata"]
        assert meta["name"].startswith(meta["generateName"])
        for k in ("name", "uid", "resourceVersion"):
            meta.pop(k, None)
        out.append(json.dumps(p, sort_keys=True))
    return sorted(out)


def test_replication_manager_scale_up_down_and_status_as_jax():
    tw = Twin()
    tw.create("replicationcontrollers", "default", rc_wire("web", 5, "web"))
    tw.create("replicationcontrollers", "default",
              rc_wire("api", 3, "api", {"containers": [{"name": "c", "image": "app"}]}))
    tw.create("pods", "default", {**mkpod("stray"), "metadata": {
        "name": "stray", "namespace": "default", "labels": {"app": "other"}}})
    mgrs = tw.each(lambda pkg, s: pkg.replication.ReplicationManager(s.client))

    def step(pkg, s):
        m = mgrs[pkg.name]
        prime(m.rcs, m.pods)
        m.sync_all()
        prime(m.pods)
        return None

    tw.each(step)
    pods = tw.each(lambda pkg, s: s.api.list("pods", "default")["items"])
    by_app = {name: {app: normalised([p for p in ps
                                       if (p["metadata"].get("labels") or {}).get("app") == app])
                     for app in ("web", "api")}
              for name, ps in pods.items()}
    assert by_app["port"] == by_app["jax"]
    assert len(by_app["port"]["web"]) == 5 and len(by_app["port"]["api"]) == 3
    web = json.loads(by_app["port"]["web"][0])
    assert web["spec"]["containers"][0]["env"] == RC_TEMPLATE_SPEC["containers"][0]["env"]
    assert web["spec"]["containers"][0]["livenessProbe"]["httpGet"]["path"] == "/healthz"
    assert [v["name"] for v in web["spec"]["volumes"]] == ["data", "cfg", "disk"]
    assert web["metadata"]["generateName"] == "web-"
    # Status write-back on the next pass (the manager saw its pods).
    tw.each(step)
    rcs = tw.stored("replicationcontrollers", ns="default")["replicationcontrollers"]
    assert {r["metadata"]["name"]: r["status"]["replicas"] for r in rcs} == {"web": 5, "api": 3}

    # Scale web down to 2 with two of its pods bound: the unbound go first.
    def bind_two_and_scale(pkg, s):
        names = sorted(p["metadata"]["name"] for p in s.api.list("pods", "default")["items"]
                       if p["metadata"]["labels"]["app"] == "web")
        for i, n in enumerate(names[:2]):
            s.api.bind("default", {"kind": "Binding", "metadata": {"name": n},
                                   "target": {"kind": "Node", "name": f"node{i}"}})
        rc = s.api.get("replicationcontrollers", "default", "web")
        rc["spec"]["replicas"] = 2
        s.api.update("replicationcontrollers", "default", "web", rc)

    tw.each(bind_two_and_scale)
    tw.each(step)
    tw.each(step)
    pods = tw.each(lambda pkg, s: s.api.list("pods", "default")["items"])
    web = {name: normalised([p for p in ps if p["metadata"]["labels"].get("app") == "web"])
           for name, ps in pods.items()}
    assert web["port"] == web["jax"]
    assert sorted(json.loads(p)["spec"].get("nodeName") for p in web["port"]) == ["node0", "node1"]
    rcs = tw.stored("replicationcontrollers", ns="default")["replicationcontrollers"]
    assert {r["metadata"]["name"]: r["status"]["replicas"] for r in rcs} == {"web": 2, "api": 3}


def test_replication_manager_expectations_hold_back_a_second_burst_as_jax():
    """Creates not yet observed hold the next pass (no over-creation),
    and observed ones release it."""
    tw = Twin()
    tw.create("replicationcontrollers", "default",
              rc_wire("r", 4, "r", {"containers": [{"name": "c", "image": "app"}]}))
    mgrs = tw.each(lambda pkg, s: pkg.replication.ReplicationManager(s.client))

    def unobserved(pkg, s):
        m = mgrs[pkg.name]
        prime(m.rcs, m.pods)
        m.sync_all()
        m.sync_all()  # the 4 adds are not observed yet: no second burst
        return len(s.api.list("pods", "default")["items"]), m.expectations.satisfied("default/r")

    assert tw.same(unobserved) == (4, False)

    def observed(pkg, s):
        m = mgrs[pkg.name]
        prime(m.pods)
        return m.expectations.satisfied("default/r")

    assert tw.same(observed) is True


# -- endpoints -----------------------------------------------------------


def test_endpoints_from_ready_pods_and_orphan_gc_as_jax():
    tw = Twin()
    for i, (ready, ip, port_name) in enumerate([(True, "10.1.0.3", "http"),
                                                (True, "10.1.0.1", "http"),
                                                (False, "10.1.0.2", "http"),
                                                (True, "", "http"),
                                                (True, "10.1.0.9", "alt")]):
        pod = {"kind": "Pod", "metadata": {"name": f"p{i}", "namespace": "default",
                                           "labels": {"app": "web"}},
               "spec": {"containers": [{"name": "c", "image": "i", "ports": [
                   {"name": port_name, "containerPort": 8080 + (i == 4)}]}]}}
        tw.create("pods", "default", pod)
        status = {"kind": "Pod", "metadata": {"name": f"p{i}", "namespace": "default"},
                  "status": {"phase": "Running", "podIP": ip, "conditions": [
                      {"type": "Ready", "status": "True" if ready else "False"}]}}
        tw.call("update_status", "pods", "default", f"p{i}", status)
    tw.create("services", "default", {"kind": "Service", "metadata": {"name": "web"},
                                      "spec": {"selector": {"app": "web"}, "ports": [
                                          {"name": "main", "port": 80, "targetPort": "http"},
                                          {"name": "raw", "port": 81, "targetPort": 9000}]}})
    tw.create("services", "default", {"kind": "Service", "metadata": {"name": "headless"},
                                      "spec": {"ports": [{"port": 53}]}})
    ctls = tw.each(lambda pkg, s: pkg.endpoints.EndpointsController(s.client))

    def sync(pkg, s):
        c = ctls[pkg.name]
        prime(c.services, c.pods, c.endpoints)
        c.sync_all()

    tw.each(sync)
    eps = tw.stored("endpoints", ns="default")["endpoints"]
    (web,) = [e for e in eps if e["metadata"]["name"] == "web"]
    # p4 names no "http" port: its subset falls back to the service port.
    assert [[a["ip"] for a in sub["addresses"]] for sub in web["subsets"]] == [
        ["10.1.0.9"], ["10.1.0.1", "10.1.0.3"]]
    assert [[p["port"] for p in sub["ports"]] for sub in web["subsets"]] == [
        [80, 9000], [8080, 9000]]
    tw.each(sync)  # unchanged: no write
    assert tw.stored("endpoints", ns="default")["endpoints"] == eps
    tw.call("delete", "services", "default", "web")
    tw.each(sync)
    assert [e["metadata"]["name"] for e in tw.stored("endpoints", ns="default")["endpoints"]] \
        == []


# -- node lifecycle ------------------------------------------------------


def node_wire(name, beat):
    return {"kind": "Node", "metadata": {"name": name, "labels": {"zone": "z1"}},
            "spec": {"podCIDR": "10.0.0.0/24"},
            "status": {"capacity": {"cpu": "4", "memory": "8Gi", "pods": "110"},
                       "addresses": [{"type": "InternalIP", "address": "192.168.0.1"}],
                       "conditions": [{"type": "Ready", "status": "True", "reason": "KubeletReady",
                                       "lastHeartbeatTime": beat}]}}


def test_node_marked_not_ready_after_grace_and_pods_evicted_as_jax(clock):
    tw = Twin()
    for n in ("n0", "n1", "n2"):
        tw.create("nodes", "", node_wire(n, "2026-01-01T00:00:00Z"))
    for i in range(4):
        tw.create("pods", "default", mkpod(f"p{i}"))
        tw.call("bind", "default", {"kind": "Binding", "metadata": {"name": f"p{i}"},
                                    "target": {"kind": "Node", "name": f"n{i % 2}"}})
    ctls = tw.each(lambda pkg, s: pkg.nodelifecycle.NodeLifecycleController(
        s.client, grace_period=10.0, eviction_timeout=5.0))

    def beat(names, stamp):
        for n in names:
            tw.call("update_status", "nodes", "", n, node_wire(n, stamp))

    def monitor(pkg, s):
        c = ctls[pkg.name]
        prime(c.nodes, c.pods)
        c.monitor()
        s.client.flush_events()  # the events' writes land before the next step's

    tw.each(monitor)  # first sight of every heartbeat
    clock.t += 6
    beat(["n1", "n2"], "2026-01-01T00:00:06Z")
    tw.each(monitor)
    assert all(n["status"]["conditions"][0]["status"] == "True"
               for n in tw.stored("nodes")["nodes"])
    clock.t += 6  # n0 silent for 12 s, past the 10 s grace
    beat(["n1", "n2"], "2026-01-01T00:00:12Z")
    tw.each(monitor)
    nodes = {n["metadata"]["name"]: n for n in tw.stored("nodes")["nodes"]}
    cond = nodes["n0"]["status"]["conditions"][0]
    assert (cond["status"], cond["reason"]) == ("Unknown", "NodeStatusUnknown")
    assert nodes["n0"]["status"]["addresses"] and nodes["n0"]["spec"]["podCIDR"]
    assert len(tw.stored("pods", ns="default")["pods"]) == 4  # not yet evicted
    clock.t += 5  # the eviction timeout
    beat(["n1", "n2"], "2026-01-01T00:00:17Z")
    tw.each(monitor)
    left = tw.stored("pods", ns="default")["pods"]
    assert sorted(p["metadata"]["name"] for p in left) == ["p1", "p3"]  # n0's went
    reasons = tw.same(lambda pkg, s: (s.client.flush_events(), sorted(
        e["reason"] for e in s.api.list("events", "default")["items"]))[1])
    assert reasons == ["NodeControllerEviction"] * 2 + ["NodeNotReady"]


# -- gangs ---------------------------------------------------------------


def pg_wire(name, min_member=1, timeout=0):
    spec = {"minMember": min_member}
    if timeout:
        spec["scheduleTimeoutSeconds"] = timeout
    return {"kind": "PodGroup", "apiVersion": "v1",
            "metadata": {"name": name, "namespace": "default"}, "spec": spec}


def member(name, group):
    return {"kind": "Pod", "metadata": {"name": name, "namespace": "default",
                                        "labels": {POD_GROUP_LABEL: group}},
            "spec": {"containers": [{"name": "c", "image": "pause", "resources": {
                "limits": {"cpu": "100m", "memory": "64Mi"}}}]}}


def bind(tw, pod, node):
    tw.call("bind", "default", {"kind": "Binding", "metadata": {"name": pod},
                                "target": {"kind": "Node", "name": node}})


GANG_CASES = ["scheduled_when_bound", "timeout", "repending_fresh_window",
              "crashed_repends", "unschedulable_recovers"]


@pytest.mark.parametrize("case", GANG_CASES)
def test_gang_controller_as_jax(case):
    """The cases of tests/test_gang.py::TestGangController, on both
    packages, clocks given explicitly (creation is stamped at T0)."""
    tw = Twin()
    ctls = tw.each(lambda pkg, s: pkg.gangs.GangController(s.client))
    steps = []

    def sync(now):
        changed = tw.same(lambda pkg, s: (ctls[pkg.name].sync_once(now=now),
                                          s.client.flush_events())[0])
        group = tw.stored("podgroups", ns="default")["podgroups"][0]
        steps.append((changed, group["status"]))
        return group["status"]

    if case == "scheduled_when_bound":
        tw.create("podgroups", "default", pg_wire("g1", min_member=2))
        tw.create("pods", "default", member("m0", "g1"))
        tw.create("pods", "default", member("m1", "g1"))
        st = sync(T0)
        assert (st["phase"], st["members"], st["bound"]) == ("Pending", 2, 0)
        bind(tw, "m0", "n0")
        bind(tw, "m1", "n1")
        assert sync(T0 + 1)["phase"] == "Scheduled"
        want = ["GangScheduled"]
    elif case == "timeout":
        tw.create("podgroups", "default", pg_wire("g1", min_member=2, timeout=5))
        tw.create("pods", "default", member("m0", "g1"))
        assert sync(T0)["phase"] == "Pending"
        st = sync(T0 + 60)
        assert st["phase"] == "Unschedulable" and "still 0/2" in st["message"]
        want = ["GangTimeout"]
    elif case == "repending_fresh_window":
        tw.create("podgroups", "default", pg_wire("g1", min_member=1, timeout=30))
        tw.create("pods", "default", member("m0", "g1"))
        bind(tw, "m0", "n0")
        assert sync(T0)["phase"] == "Scheduled"
        tw.call("delete", "pods", "default", "m0")
        late = T0 + 1000
        st = sync(late)
        assert st["phase"] == "Pending" and st["pendingSince"]
        assert sync(late + 5)["phase"] == "Pending"
        assert sync(late + 60)["phase"] == "Unschedulable"
        want = ["GangScheduled", "GangTimeout"]
    elif case == "crashed_repends":
        tw.create("podgroups", "default", pg_wire("g1", min_member=1))
        tw.create("pods", "default", member("m0", "g1"))
        bind(tw, "m0", "n0")
        assert sync(T0)["phase"] == "Scheduled"
        tw.call("update_status", "pods", "default", "m0",
                {"kind": "Pod", "metadata": {"name": "m0", "namespace": "default"},
                 "status": {"phase": "Failed"}})
        st = sync(T0 + 1)
        assert (st["phase"], st["bound"], st["members"]) == ("Pending", 0, 0)
        want = ["GangScheduled"]
    else:
        tw.create("podgroups", "default", pg_wire("g1", min_member=1, timeout=5))
        tw.create("pods", "default", member("m0", "g1"))
        assert sync(T0 + 60)["phase"] == "Unschedulable"
        bind(tw, "m0", "n0")
        assert sync(T0 + 61)["phase"] == "Scheduled"
        want = ["GangTimeout", "GangScheduled"]
    reasons = tw.same(lambda pkg, s: (s.client.flush_events(), sorted(
        e["reason"] for e in s.api.list("events", "default")["items"]))[1])
    assert reasons == sorted(want)


def test_gang_controller_shares_the_replication_managers_pods_informer_as_jax():
    for pkg in BOTH:
        client = pkg.rest.Client(pkg.rest.LocalTransport(pkg.api_mod.APIServer()))
        mgr = pkg.manager.ControllerManager(client)
        assert mgr.gangs.pods is mgr.replication.pods and not mgr.gangs._owns_pods


# -- the controller-manager ----------------------------------------------


FLAGS = ("enable_replication", "enable_endpoints", "enable_node_lifecycle", "enable_namespace",
         "enable_resource_quota", "enable_service_accounts", "enable_pv_binder", "enable_gangs")


class _Recorder:
    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs


def _controller_list(pkg, client, kw):
    mgr = pkg.manager.ControllerManager(client, **kw)
    out = []
    for c in mgr.controllers:
        extra = {}
        if isinstance(c, _Recorder):
            extra = {k: (type(v).__name__ if k == "descheduler" else v)
                     for k, v in c.kwargs.items()}
        elif type(c).__name__ == "NodeLifecycleController":
            extra = {"grace": c.grace_period, "eviction": c.eviction_timeout}
        out.append((type(c).__name__, extra))
    attrs = sorted(a for a in ("replication", "endpoints", "node_lifecycle", "namespace",
                               "resource_quota", "service_accounts", "tokens", "gangs",
                               "descheduler", "autoscaler", "pv_binder", "pv_recycler")
                   if hasattr(mgr, a))
    return out, attrs, mgr.running


def test_controller_manager_builds_jax_set_for_every_flag_combination(monkeypatch):
    """All 2^8 enable flags, with and without a token manager, the
    descheduler and an autoscaler pool (both recorded, not built: they
    run on the card), and the node lifecycle timings: the same
    controllers in the same order."""
    class Descheduler(_Recorder):
        pass

    class Autoscaler(_Recorder):
        pass

    for pkg in BOTH:
        monkeypatch.setattr(pkg.desched, "Descheduler", Descheduler)
        monkeypatch.setattr(pkg.autoscaler, "Autoscaler", Autoscaler)
    clients = {pkg.name: pkg.rest.Client(pkg.rest.LocalTransport(pkg.api_mod.APIServer()))
               for pkg in BOTH}
    tokens = {pkg.name: pkg.auth.ServiceAccountTokenManager(b"k") for pkg in BOTH}
    seen = set()
    for bits in itertools.product((True, False), repeat=len(FLAGS) + 3):
        kw = dict(zip(FLAGS, bits))
        extra = bits[len(FLAGS):]
        kw.update(enable_descheduler=extra[0], node_grace_period=7.0, node_eviction_timeout=3.0,
                  autoscaler_pool="pool" if extra[1] else None)
        got = {}
        for pkg in BOTH:
            got[pkg.name] = _controller_list(
                pkg, clients[pkg.name],
                dict(kw, sa_token_manager=tokens[pkg.name] if extra[2] else None))
        assert got["port"] == got["jax"], kw
        seen.add(tuple(name for name, _ in got["port"][0]))
    assert len(seen) > 200


def test_controller_manager_refuses_a_cloud_provider():
    """Kept under its name from when the port refused a cloud provider:
    now a provider puts the cloud controllers first, as in JAX's
    manager, and the other controllers follow unchanged
    (`tests/test_torch_cloud.py` holds the controllers themselves)."""
    from kubernetes_tpu.cloudprovider.fake import FakeCloudProvider as JaxFake

    from kubernetes_tpu_torch.cloudprovider.fake import FakeCloudProvider as PortFake

    got = {}
    for pkg, provider in ((JAX, JaxFake()), (PORT, PortFake())):
        client = pkg.rest.Client(pkg.rest.LocalTransport(pkg.api_mod.APIServer()))
        mgr = pkg.manager.ControllerManager(client, cloud_provider=provider)
        got[pkg.name] = [type(c).__name__ for c in mgr.controllers]
    assert got["port"] == got["jax"]
    assert got["port"][:4] == ["CloudNodeController", "ServiceController", "RouteController",
                               "ReplicationManager"]


def test_started_manager_reconciles_an_rc_as_jax():
    """start() runs every controller's loop; an RC gets its replicas and
    its status, and stop() ends them."""
    import time

    got = {}
    for pkg in BOTH:
        api = pkg.api_mod.APIServer()
        client = pkg.rest.Client(pkg.rest.LocalTransport(api))
        mgr = pkg.manager.ControllerManager(client).start()
        try:
            assert mgr.running
            api.create("replicationcontrollers", "default",
                       rc_wire("r", 3, "r", {"containers": [{"name": "c", "image": "app"}]}))
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                rc = api.get("replicationcontrollers", "default", "r")
                if (rc.get("status") or {}).get("replicas") == 3:
                    break
                time.sleep(0.05)
            pods = api.list("pods", "default")["items"]
            got[pkg.name] = (len(pods), rc["status"]["replicas"],
                             [type(c).__name__ for c in mgr.controllers])
        finally:
            mgr.stop()
        assert not mgr.running
    assert got["port"] == got["jax"] == (3, 3, got["jax"][2])
