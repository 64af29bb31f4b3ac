"""The port's descheduler moves as the JAX descheduler does.

Two apiservers (the JAX package's `APIServer`) are seeded alike. The
JAX `Descheduler` drives one through the JAX client, the port's
(`device="cpu"`: K2's plain version) the other through the port's
client over a `LocalTransport`. After the same calls the cycle
summaries, the pods and journal entries on the wire (less uid,
resourceVersion and creationTimestamp), the rebalance and capacity
monitors' snapshots and the move counters must be equal. The one
counter that differs by design is `rebalance_moves_total{outcome=
"planned"}`: the port's `build_plan` counts every plan's moves, the JAX
descheduler an executed plan's.

Pods are created in the JAX package's canonical wire form (a typed
round trip), so a replacement built from the stored wire equals the JAX
one built from its typed copy; `test_raw_pod_keeps_its_wire_form`
shows what the port keeps where a pod was created otherwise. The
recovery cases write their journals directly: neither package has a
crash seam that the port carries.
"""

import copy
import time

import pytest
import torch

from kubernetes_tpu.client import Client as JClient
from kubernetes_tpu.client import LocalTransport as JLocalTransport
from kubernetes_tpu.controllers.descheduler import Descheduler as JDescheduler
from kubernetes_tpu.models import serde as jserde
from kubernetes_tpu.models.objects import Pod as JPod
from kubernetes_tpu.server.api import APIServer
from kubernetes_tpu.utils import capacity as jcapmod
from kubernetes_tpu.utils import rebalance as jrebmod
from kubernetes_tpu_torch.client.rest import Client, LocalTransport
from kubernetes_tpu_torch.controllers import descheduler as desched_mod
from kubernetes_tpu_torch.controllers.descheduler import Descheduler
from kubernetes_tpu_torch.models.objects import (
    POD_GROUP_LABEL,
    REBALANCE_DEST_ANNOTATION,
    REBALANCE_JOURNAL_LABEL,
)
from kubernetes_tpu_torch.utils import capacity as capmod
from kubernetes_tpu_torch.utils import rebalance as rebmod

OUTCOMES = ("evicted", "rebound", "recovered", "failed", "stranded")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def move_counters_kept():
    """Both packages' move counters (`MOVES`, `STRANDED`) as they were
    before each test: the JAX package's exposition golden
    (`tests/test_metrics_exposition.py`) reads its counters from a
    process that may have run this file first. The other files that
    drive either package's descheduler or rebalance monitor import it."""
    saved = {c: c.snapshot() for mod in (jrebmod, rebmod) for c in (mod.MOVES, mod.STRANDED)}
    yield
    for c, values in saved.items():
        with c._lock:
            c._values.clear()
            c._values.update(values)


@pytest.fixture(autouse=True)
def fresh_monitors(monkeypatch):
    monkeypatch.setattr(jrebmod, "DEFAULT", jrebmod.RebalanceMonitor())
    monkeypatch.setattr(jcapmod, "DEFAULT", jcapmod.CapacityMonitor())
    monkeypatch.setattr(rebmod, "DEFAULT", rebmod.RebalanceMonitor())
    monkeypatch.setattr(capmod, "DEFAULT", capmod.CapacityMonitor())


def canonical(wire: dict) -> dict:
    """A pod's wire form as the JAX package writes its typed pod."""
    return jserde.to_wire(jserde.from_wire(JPod, wire))


def pod_wire(name, cpu="200m", mem="64Mi", labels=None):
    return canonical({
        "kind": "Pod",
        "metadata": {"name": name, "namespace": "default", "labels": labels or {}},
        "spec": {"containers": [{"name": "c", "image": "pause",
                                 "resources": {"limits": {"cpu": cpu, "memory": mem}}}]},
    })


def node_wire(name, cpu="1", mem="2Gi", pods="20"):
    return {"kind": "Node", "metadata": {"name": name, "labels": {}},
            "status": {"capacity": {"cpu": cpu, "memory": mem, "pods": pods},
                       "conditions": [{"type": "Ready", "status": "True"}]}}


def _norm(obj: dict) -> dict:
    obj = copy.deepcopy(obj)
    for k in ("uid", "resourceVersion", "creationTimestamp"):
        obj.get("metadata", {}).pop(k, None)
    return obj


def counters():
    return ({o: jrebmod.MOVES.value(outcome=o) for o in OUTCOMES + ("planned",)},
            {o: rebmod.MOVES.value(outcome=o) for o in OUTCOMES + ("planned",)},
            jrebmod.STRANDED.value(), rebmod.STRANDED.value())


class Twin:
    """Twin apiservers, seeded by the same calls of the JAX client."""

    def __init__(self):
        self.apis = [APIServer(), APIServer()]
        self.setups = [JClient(JLocalTransport(a)) for a in self.apis]
        self.jc = self.setups[0]
        self.tc = Client(LocalTransport(self.apis[1]))
        self.before = counters()

    def each(self, verb, *args, **kw):
        return [getattr(c, verb)(*args, **kw) for c in self.setups]

    def nodes(self, n, **kw):
        for j in range(n):
            self.each("create", "nodes", node_wire(f"n{j}", **kw))

    def bound(self, name, node, **kw):
        self.each("create", "pods", pod_wire(name, **kw))
        for res in self.each("bind_bulk", [(name, node)]):
            assert all(r.get("status") == "Success" for r in res), res

    def fragment(self, n_nodes=6, per_node=3, cpu="200m"):
        """JAX tests' fragmented cluster: `per_node` small pods bound to
        every node, each node keeping a shard nobody fits."""
        self.nodes(n_nodes)
        k = 0
        for j in range(n_nodes):
            for _ in range(per_node):
                self.bound(f"p{k}", f"n{j}", cpu=cpu)
                k += 1

    def deschedulers(self, **kw):
        kw.setdefault("grace_period_seconds", 0)
        return JDescheduler(self.jc, **kw), Descheduler(self.tc, device="cpu", **kw)

    def state(self, k):
        api = self.apis[k]
        return ({p["metadata"]["name"]: _norm(p) for p in api.list("pods", "")["items"]},
                {t["metadata"]["name"]: _norm(t) for t in api.list("podtemplates", "")["items"]})

    def assert_same(self):
        (jpods, jtemplates), (tpods, ttemplates) = self.state(0), self.state(1)
        assert jpods.keys() == tpods.keys()
        for name in jpods:
            assert tpods[name] == jpods[name], name
        assert ttemplates == jtemplates
        assert rebmod.DEFAULT.snapshot() == jrebmod.DEFAULT.snapshot()
        assert capmod.DEFAULT.probe_set() == jcapmod.DEFAULT.probe_set()
        (j0, t0, js0, ts0), (j1, t1, js1, ts1) = self.before, counters()
        for o in OUTCOMES:
            assert t1[o] - t0[o] == j1[o] - j0[o], o
        assert ts1 - ts0 == js1 - js0
        # The port counts every plan's moves as planned, JAX the executed ones.
        assert t1["planned"] - t0["planned"] >= j1["planned"] - j0["planned"]
        return jpods

    def both(self, j, t, call, *args, **kw):
        out = getattr(j, call)(*args, **kw), getattr(t, call)(*args, **kw)
        assert out[1] == out[0]
        return out[1]


def moved(pods):
    return {n: p["metadata"]["annotations"][REBALANCE_DEST_ANNOTATION]
            for n, p in pods.items()
            if (p["metadata"].get("annotations") or {}).get(REBALANCE_DEST_ANNOTATION)}


def test_defrag_cycle_matches_jax():
    twin = Twin()
    twin.fragment()
    twin.each("create", "pods", pod_wire("waiting", cpu="500m"))
    j, t = twin.deschedulers()
    out = twin.both(j, t, "sync_once")
    assert out["triggered"] and out["moves_executed"] > 0
    assert out["score_after"] < out["score_before"]
    pods = twin.assert_same()
    assert len(moved(pods)) == out["moves_executed"]
    assert all(not pods[n]["spec"].get("nodeName") for n in moved(pods))
    assert rebmod.DEFAULT.snapshot()["outcomes"]["evicted"] == out["moves_executed"]
    # The second cycle sees the moved pods pending at their pins.
    twin.both(j, t, "sync_once")
    twin.assert_same()


@pytest.mark.parametrize("cap", [1, 2, 4, 16])
def test_disruption_cap_matches_jax(cap):
    twin = Twin()
    twin.fragment(n_nodes=8)
    twin.each("create", "pods", pod_wire("waiting", cpu="500m"))
    j, t = twin.deschedulers(disruption_cap=cap)
    out = twin.both(j, t, "sync_once")
    assert out["triggered"] and 0 < out["moves_executed"] <= cap
    twin.assert_same()


@pytest.mark.parametrize("waiting,threshold,force", [
    (False, 0.5, False), (True, 1.1, False), (True, 0.5, False), (False, 1.1, True)])
def test_trigger_gating_matches_jax(waiting, threshold, force):
    twin = Twin()
    twin.fragment()
    if waiting:
        twin.each("create", "pods", pod_wire("waiting", cpu="500m"))
    j, t = twin.deschedulers(frag_threshold=threshold)
    out = twin.both(j, t, "sync_once", force=force)
    assert out["triggered"] == (force or (waiting and threshold <= 0.5))
    twin.assert_same()


def _journal(name, dest, spec=None):
    return {"kind": "PodTemplate", "apiVersion": "v1",
            "metadata": {"name": f"rebalance-move-{name}", "namespace": "default",
                         "labels": {REBALANCE_JOURNAL_LABEL: dest}},
            "template": {"metadata": {"name": name, "namespace": "default",
                                      "labels": {"app": "x"}, "annotations": {"a": "1"}},
                         "spec": spec if spec is not None else pod_wire(name)["spec"]}}


def test_recovery_matches_jax():
    """An orphan is recreated pinned, an entry whose pod exists is
    dropped, a recreate refused with a 4xx counts the pod as stranded;
    an entry without the label is left alone."""
    twin = Twin()
    twin.nodes(2)
    twin.bound("alive", "n0")
    twin.each("create", "podtemplates", _journal("ghost", "n1"), namespace="default")
    twin.each("create", "podtemplates", _journal("alive", "n1"), namespace="default")
    twin.each("create", "podtemplates", _journal("bad", "n1", spec={"containers": []}),
              namespace="default")
    other = _journal("other", "n1")
    other["metadata"]["labels"] = {"app": "x"}
    twin.each("create", "podtemplates", other, namespace="default")
    j, t = twin.deschedulers()
    assert twin.both(j, t, "recover") == 1
    pods = twin.assert_same()
    assert pods["ghost"]["metadata"]["annotations"][REBALANCE_DEST_ANNOTATION] == "n1"
    assert "bad" not in pods
    assert set(twin.state(1)[1]) == {"rebalance-move-other"}
    before, after = twin.before, counters()
    assert after[1]["recovered"] - before[1]["recovered"] == 1
    assert after[1]["stranded"] - before[1]["stranded"] == 1
    assert after[3] - before[3] == 1
    # A cycle runs the same recovery first.
    twin.each("create", "podtemplates", _journal("ghost2", "n0"), namespace="default")
    out = twin.both(j, t, "sync_once")
    assert out["recovered"] == 1
    twin.assert_same()


@pytest.mark.parametrize("ttl", [0.0, 3600.0])
def test_nomination_sweep_matches_jax(ttl):
    """A pinned pod that bound is settled `rebound`; a pinned pending
    pod past the TTL is unpinned `failed`, within it kept."""
    twin = Twin()
    twin.nodes(2)
    twin.bound("landed", "n0")
    twin.each("patch", "pods", "landed",
              {"metadata": {"annotations": {REBALANCE_DEST_ANNOTATION: "n0"}}})
    twin.each("create", "pods", pod_wire("wedged"))
    twin.each("patch", "pods", "wedged",
              {"metadata": {"annotations": {REBALANCE_DEST_ANNOTATION: "n9"}}})
    j, t = twin.deschedulers(nomination_ttl_s=ttl)
    twin.both(j, t, "_sweep_nominations")
    pods = twin.assert_same()
    assert not pods["landed"]["metadata"]["annotations"][REBALANCE_DEST_ANNOTATION]
    assert bool(pods["wedged"]["metadata"]["annotations"][REBALANCE_DEST_ANNOTATION]) == (ttl > 0)


def test_rebound_after_the_scheduler_binds_matches_jax():
    """Moved pods bound at their pins (by the test, as a scheduler
    would) settle `rebound` at the next cycle."""
    twin = Twin()
    twin.fragment()
    twin.each("create", "pods", pod_wire("waiting", cpu="500m"))
    j, t = twin.deschedulers()
    twin.both(j, t, "sync_once")
    for name, dest in moved(twin.assert_same()).items():
        twin.each("bind_bulk", [(name, dest)])
    twin.both(j, t, "sync_once")
    twin.assert_same()
    assert rebmod.DEFAULT.snapshot()["outcomes"]["rebound"] > 0


def test_gang_moves_commit_atomically_as_jax():
    """A gang wholly on a drained node moves as one group, its members
    bound at their destinations by one atomic bind_bulk, pins blanked."""
    twin = Twin()
    twin.nodes(3)
    gang = {POD_GROUP_LABEL: "slice-a"}
    for k in range(2):
        twin.bound(f"g{k}", "n0", labels=gang)
    twin.bound("f0", "n1", cpu="300m")
    jd, td = twin.deschedulers(disruption_cap=8)
    out = twin.both(jd, td, "drain_node", "n0")
    pods = twin.assert_same()
    gang_moves = [m for m in rebmod.DEFAULT.snapshot()["moves"] if m["gang"]]
    assert out["moves_executed"] == 2 and len(gang_moves) == 2
    for m in gang_moves:
        assert pods[m["name"]]["spec"]["nodeName"] == m["to"]
        assert not pods[m["name"]]["metadata"]["annotations"][REBALANCE_DEST_ANNOTATION]
    assert rebmod.DEFAULT.snapshot()["outcomes"]["rebound"] == 2


def test_drain_node_matches_jax():
    twin = Twin()
    twin.nodes(3)
    for k in range(3):
        twin.bound(f"d{k}", "n0")
    twin.bound("other", "n1", cpu="300m")
    j, t = twin.deschedulers(disruption_cap=8)
    out = twin.both(j, t, "drain_node", "n0")
    assert out["moves_executed"] == 3 and out["trigger"] == "drain"
    pods = twin.assert_same()
    for name in ("d0", "d1", "d2"):
        dest = pods[name]["metadata"]["annotations"][REBALANCE_DEST_ANNOTATION]
        assert dest and dest != "n0" and not pods[name]["spec"].get("nodeName")
    assert pods["other"]["spec"]["nodeName"] == "n1"


def test_an_error_in_the_plan_raises_and_the_loop_counts_it(monkeypatch):
    twin = Twin()
    twin.fragment()

    def broken(*args, **kw):
        raise RuntimeError("K2 failed")

    monkeypatch.setattr(desched_mod, "build_plan", broken)
    _, t = twin.deschedulers(sync_period=0.01)
    with pytest.raises(RuntimeError, match="K2 failed"):
        t.sync_once()
    errors = desched_mod._SYNCS.value(result="error")
    ok = desched_mod._SYNCS.value(result="ok")
    t.start()
    try:
        deadline = time.monotonic() + 30
        while desched_mod._SYNCS.value(result="error") < errors + 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        t.stop()
    assert desched_mod._SYNCS.value(result="ok") == ok
    # Nothing moved: the plan never ran.
    assert not twin.state(1)[1] and not moved(twin.state(1)[0])


def test_a_started_loop_counts_good_cycles():
    twin = Twin()
    twin.fragment()
    _, t = twin.deschedulers(sync_period=0.01)
    ok = desched_mod._SYNCS.value(result="ok")
    t.start()
    try:
        deadline = time.monotonic() + 30
        while desched_mod._SYNCS.value(result="ok") < ok + 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        t.stop()


def test_the_device_is_the_descheduler_s(monkeypatch):
    """build_plan and fragment_score get the descheduler's device."""
    twin = Twin()
    twin.fragment()
    twin.each("create", "pods", pod_wire("waiting", cpu="500m"))
    seen = []
    for name in ("build_plan", "fragment_score"):
        real = getattr(desched_mod, name)

        def spy(*args, _real=real, **kw):
            seen.append(kw["device"])
            return _real(*args, **kw)

        monkeypatch.setattr(desched_mod, name, spy)
    _, t = twin.deschedulers()
    assert t.sync_once()["triggered"]
    assert [str(d) for d in seen] == ["cpu", "cpu"]


# -- wire fidelity -------------------------------------------------------------


def full_pod_wire(name):
    """A pod that sets every field of the JAX package's PodSpec and
    Container away from its default."""
    return canonical({
        "kind": "Pod",
        "metadata": {"name": name, "namespace": "default", "labels": {"app": "full"},
                     "annotations": {"note": "kept"}},
        "spec": {
            "volumes": [{"name": "data", "gcePersistentDisk": {"pdName": "pd-1",
                                                               "fsType": "ext4"}},
                        {"name": "cache", "emptyDir": {"medium": "Memory"}},
                        {"name": "host", "hostPath": {"path": "/var/x"}}],
            "containers": [{
                "name": "main", "image": "app:1", "command": ["/bin/app"],
                "args": ["--serve", "--port=8080"], "workingDir": "/srv",
                "ports": [{"name": "http", "containerPort": 8080, "hostPort": 18080,
                           "protocol": "TCP"}],
                "env": [{"name": "MODE", "value": "prod"}],
                "resources": {"limits": {"cpu": "200m", "memory": "64Mi"},
                              "requests": {"cpu": "100m", "memory": "32Mi"}},
                "volumeMounts": [{"name": "data", "mountPath": "/data", "readOnly": True}],
                "livenessProbe": {"exec": {"command": ["true"]}, "initialDelaySeconds": 5,
                                  "timeoutSeconds": 2},
                "readinessProbe": {"httpGet": {"path": "/ready", "port": 8080},
                                   "initialDelaySeconds": 1, "timeoutSeconds": 1},
                "imagePullPolicy": "Always",
                "securityContext": {"privileged": True},
            }],
            "restartPolicy": "OnFailure",
            "nodeSelector": {"disk": "ssd"},
            "hostNetwork": True,
            "serviceAccount": "deployer",
            "priorityClassName": "batch-high",
            "priority": 1000,
            "preemptionPolicy": "Never",
        },
    })


def _spy_creates(api):
    seen = []
    real = api.create

    def create(resource, namespace, obj):
        seen.append((resource, copy.deepcopy(obj)))
        return real(resource, namespace, obj)

    api.create = create
    return seen


def test_wire_fidelity_of_journal_and_replacement():
    """Every field of the JAX PodSpec and Container survives the move:
    the journal and the replacement the port writes equal the JAX
    ones, field for field, as sent and as stored."""
    twin = Twin()
    twin.nodes(2)
    for c in twin.setups:
        c.patch("nodes", "n0", {"metadata": {"labels": {"disk": "ssd"}}})
        c.patch("nodes", "n1", {"metadata": {"labels": {"disk": "ssd"}}})
    wire = full_pod_wire("full")
    # Every field set: the JAX typed form drops nothing of it.
    assert set(wire["spec"]) == {
        "volumes", "containers", "restartPolicy", "nodeSelector", "hostNetwork",
        "serviceAccount", "priorityClassName", "priority", "preemptionPolicy"}
    assert len(wire["spec"]["containers"][0]) == 13
    twin.each("create", "pods", wire)
    twin.each("bind_bulk", [("full", "n0")])
    seen = [_spy_creates(api) for api in twin.apis]
    j, t = twin.deschedulers()
    out = twin.both(j, t, "drain_node", "n0")
    assert out["moves_executed"] == 1
    jsent, tsent = ([(r, _norm(o)) for r, o in s if r != "events"] for s in seen)
    assert [r for r, _ in tsent] == ["podtemplates", "pods"]
    assert tsent == jsent
    journal, replacement = (o for _, o in tsent)
    assert journal["template"]["spec"] == dict(wire["spec"], nodeName="n0")
    assert replacement["spec"] == wire["spec"]
    assert replacement["metadata"]["annotations"] == {"note": "kept",
                                                      REBALANCE_DEST_ANNOTATION: "n1"}
    twin.assert_same()


def test_raw_pod_keeps_its_wire_form():
    """A pod created without the JAX defaults (restartPolicy,
    imagePullPolicy) keeps its stored spec through the port's move; the
    JAX replacement adds its typed defaults. Both decode to the same
    JAX pod."""
    twin = Twin()
    twin.nodes(2)
    raw = {"kind": "Pod", "metadata": {"name": "raw", "namespace": "default"},
           "spec": {"containers": [{"name": "c", "image": "pause", "resources": {
               "limits": {"cpu": "200m", "memory": "64Mi"}}, "x-extra": 1}]}}
    twin.each("create", "pods", raw)
    twin.each("bind_bulk", [("raw", "n0")])
    j, t = twin.deschedulers()
    twin.both(j, t, "drain_node", "n0")
    (jpods, _), (tpods, _) = twin.state(0), twin.state(1)
    assert tpods["raw"]["spec"] == raw["spec"]
    assert jpods["raw"]["spec"]["restartPolicy"] == "Always"
    assert canonical(tpods["raw"]) == canonical(jpods["raw"])
