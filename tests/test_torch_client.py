"""The port's client stack equals the JAX package's.

- serde: seeded wire dicts of Pod, Node, Service and PodGroup decode
  through the port into objects whose every field equals the same field
  of the JAX decode; the port's `to_wire` of them decodes through the
  JAX `from_wire` to the same values.
- ThreadSafeStore, FIFO (with its wake event), Backoff and TokenBucket
  answer seeded call sequences as the JAX copies do.
- Reflector/Informer over the JAX APIServer, through the port's
  LocalTransport, hold the JAX Informer's keys after creates, updates
  and deletes, and a forced re-list hands vanished objects on as
  DELETED, as the JAX one does.
- Over HTTP, against the JAX APIHTTPServer on 127.0.0.1: the port's
  HTTPTransport `list`, `watch` and `bind_bulk` (atomic, with a
  conflict) return what the JAX `Client(HTTPTransport)` returns; so do
  `delete` (with and without a grace), the wire reads `list_wire` and
  `get_wire`, and `podtemplates` listed by an existence label selector,
  over HTTP and a LocalTransport.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

from kubernetes_tpu.client import Client as JClient
from kubernetes_tpu.client import HTTPTransport as JHTTPTransport
from kubernetes_tpu.client import LocalTransport as JLocalTransport
from kubernetes_tpu.client import cache as jcache
from kubernetes_tpu.models import objects as jobjects
from kubernetes_tpu.models import serde as jserde
from kubernetes_tpu.server.api import APIServer
from kubernetes_tpu.server.httpserver import APIHTTPServer
from kubernetes_tpu.utils import ratelimit as jratelimit
from kubernetes_tpu_torch.client import cache
from kubernetes_tpu_torch.client.rest import Client, HTTPTransport, LocalTransport
from kubernetes_tpu_torch.models import objects, serde
from kubernetes_tpu_torch.models.quantity import Quantity
from kubernetes_tpu_torch.utils import ratelimit

SEEDS = (0, 1, 2, 3)


def wait_until(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


# -- seeded wire objects ---------------------------------------------------


def _labels(rng, n):
    return {f"k{int(rng.integers(6))}": f"v{int(rng.integers(3))}" for _ in range(n)}


def pod_wire(rng, i):
    cpu, mem = int(rng.integers(1, 9)) * 125, int(rng.integers(1, 9)) * 32
    spec = {
        "containers": [{
            "name": "c", "image": "app", "imagePullPolicy": "Always",
            "ports": [{"containerPort": 80, "hostPort": int(rng.integers(0, 3)) * 8080,
                       "protocol": "TCP", "hostIP": "0.0.0.0"}],
            "resources": {"limits": {"cpu": f"{cpu}m", "memory": f"{mem}Mi"},
                          "requests": {"cpu": f"{cpu // 2}m"}},
        }],
        "volumes": [
            {"name": "g", "gcePersistentDisk": {"pdName": f"pd{int(rng.integers(3))}",
                                               "readOnly": bool(rng.integers(2))}},
            {"name": "a", "awsElasticBlockStore": {"volumeID": f"vol{int(rng.integers(3))}",
                                                   "fsType": "ext4"}},
        ],
        "nodeSelector": _labels(rng, int(rng.integers(0, 3))),
        "restartPolicy": "Never",
        "priority": int(rng.integers(0, 100)),
        "preemptionPolicy": ("", "Never")[int(rng.integers(2))],
    }
    if rng.integers(2):
        spec["nodeName"] = f"n{int(rng.integers(8))}"
    return {
        "kind": "Pod", "apiVersion": "v1",
        "metadata": {"name": f"p{i}", "namespace": "default", "uid": f"u{i}",
                     "resourceVersion": str(int(rng.integers(1, 1000))),
                     "labels": _labels(rng, 3), "annotations": {"a": "b"},
                     "deletionTimestamp": ("", "2026-01-01T00:00:00Z")[int(rng.integers(2))],
                     "creationTimestamp": "2026-01-01T00:00:00Z"},
        "spec": spec,
        "status": {"phase": ("Pending", "Running")[int(rng.integers(2))], "podIP": "10.0.0.1"},
    }


def node_wire(rng, i):
    return {
        "kind": "Node",
        "metadata": {"name": f"n{i}", "labels": _labels(rng, 2),
                     "resourceVersion": str(int(rng.integers(1, 1000)))},
        "spec": {"unschedulable": bool(rng.integers(2)), "podCIDR": "10.1.0.0/24"},
        "status": {
            "capacity": {"cpu": str(int(rng.integers(1, 33))),
                         "memory": f"{int(rng.integers(1, 65))}Gi", "pods": "110"},
            "conditions": [{"type": "Ready", "status": ("True", "False")[int(rng.integers(2))],
                            "reason": "KubeletReady"}],
            "addresses": [{"type": "InternalIP", "address": "10.0.0.2"}],
        },
    }


def service_wire(rng, i):
    return {
        "kind": "Service",
        "metadata": {"name": f"s{i}", "namespace": "default", "labels": _labels(rng, 1)},
        "spec": {"selector": _labels(rng, 2), "clusterIP": "10.0.0.9",
                 "ports": [{"port": 80, "targetPort": 8080}]},
        "status": {"loadBalancer": {}},
    }


def podgroup_wire(rng, i):
    return {
        "kind": "PodGroup",
        "metadata": {"name": f"g{i}", "namespace": "default"},
        "spec": {"minMember": int(rng.integers(1, 10)), "maxMember": int(rng.integers(0, 20)),
                 "scheduleTimeoutSeconds": int(rng.integers(0, 60))},
        "status": {"phase": "Pending", "members": int(rng.integers(0, 5)), "bound": 1,
                   "pendingSince": "2026-01-01T00:00:00Z"},
    }


def podtemplate_wire(rng, i):
    pod = pod_wire(rng, i)
    return {"kind": "PodTemplate", "apiVersion": "v1",
            "metadata": {"name": f"t{i}", "namespace": "default",
                         "labels": {"rebalance.kubernetes-tpu.io/move": f"n{i}"}},
            "template": {"metadata": pod["metadata"], "spec": pod["spec"]}}


KINDS = {
    "Pod": (pod_wire, objects.Pod, jobjects.Pod),
    "PodTemplate": (podtemplate_wire, objects.PodTemplate, jobjects.PodTemplate),
    "Node": (node_wire, objects.Node, jobjects.Node),
    "Service": (service_wire, objects.Service, jobjects.Service),
    "PodGroup": (podgroup_wire, objects.PodGroup, jobjects.PodGroup),
}


def assert_same_fields(port, ref, path="obj"):
    """Every field of the port's object equals the same field of the
    JAX object (the JAX objects carry more fields; those are skipped)."""
    if dataclasses.is_dataclass(port):
        assert dataclasses.is_dataclass(ref), path
        for f in dataclasses.fields(port):
            assert_same_fields(getattr(port, f.name), getattr(ref, f.name), f"{path}.{f.name}")
    elif isinstance(port, Quantity):
        assert str(port) == str(ref) and port.milli_value() == ref.milli_value(), path
    elif isinstance(port, list):
        assert isinstance(ref, list) and len(port) == len(ref), path
        for k, (a, b) in enumerate(zip(port, ref)):
            assert_same_fields(a, b, f"{path}[{k}]")
    elif isinstance(port, dict):
        assert isinstance(ref, dict) and port.keys() == ref.keys(), path
        for k in port:
            assert_same_fields(port[k], ref[k], f"{path}[{k!r}]")
    else:
        assert port == ref and type(port) is type(ref), f"{path}: {port!r} != {ref!r}"


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_serde_matches_jax(kind, seed):
    make, cls, jcls = KINDS[kind]
    rng = np.random.default_rng(seed)
    for i in range(8):
        wire = make(rng, i)
        got = serde.from_wire(cls, wire)
        assert_same_fields(got, jserde.from_wire(jcls, wire))
        assert_same_fields(got, jserde.from_wire(jcls, serde.to_wire(got)))


def test_decode_copies_untyped_leaves():
    wire = service_wire(np.random.default_rng(0), 0)
    svc = serde.from_wire(objects.Service, wire)
    wire["status"]["loadBalancer"]["x"] = 1
    assert svc.status == {"loadBalancer": {}}


# -- stores, queues, rate limits ----------------------------------------------


def _ops(rng, n=200):
    names = [f"ns/o{i}" for i in range(12)]
    for _ in range(n):
        yield int(rng.integers(6)), names[int(rng.integers(len(names)))], int(rng.integers(100))


def _obj(key, v):
    ns, name = key.split("/")
    return {"metadata": {"namespace": ns, "name": name}, "v": v}


@pytest.mark.parametrize("seed", SEEDS)
def test_thread_safe_store_matches_jax(seed):
    got, ref = cache.ThreadSafeStore(), jcache.ThreadSafeStore()
    for op, key, v in _ops(np.random.default_rng(seed)):
        for s in (got, ref):
            if op == 0:
                s.add(_obj(key, v))
            elif op == 1:
                s.update(_obj(key, v))
            elif op == 2:
                s.delete(_obj(key, v))
            elif op == 3 and v % 10 == 0:
                s.replace([_obj(key, v), _obj("ns/r", v)])
        assert got.get(key) == ref.get(key)
        assert got.list() == ref.list() and got.keys() == ref.keys() and len(got) == len(ref)


@pytest.mark.parametrize("seed", SEEDS)
def test_fifo_matches_jax(seed):
    got, ref = cache.FIFO(), jcache.FIFO()
    wake = threading.Event()
    got.attach_wake(wake)
    for op, key, v in _ops(np.random.default_rng(seed)):
        if op in (0, 1):
            wake.clear()
            got.add(_obj(key, v))
            ref.add(_obj(key, v))
            assert wake.is_set()
        elif op == 2:
            got.delete(_obj(key, v))
            ref.delete(_obj(key, v))
        elif op in (3, 4):
            assert got.pop(timeout=0) == ref.pop(timeout=0)
        elif v % 10 == 0:
            wake.clear()
            got.replace([_obj(key, v)])
            ref.replace([_obj(key, v)])
            assert wake.is_set()
        assert len(got) == len(ref)
    wake.clear()
    got.close()
    ref.close()
    assert wake.is_set()

    def drain(q):
        out = [q.pop(timeout=None)]
        while out[-1] is not None:
            out.append(q.pop(timeout=None))
        return out

    assert drain(got) == drain(ref)


@pytest.mark.parametrize("seed", SEEDS)
def test_backoff_and_token_bucket_match_jax(seed):
    rng = np.random.default_rng(seed)
    got, ref = ratelimit.Backoff(0.5, 8.0), jratelimit.Backoff(0.5, 8.0)
    for op, key, _ in _ops(rng):
        if op == 5:
            got.reset(key)
            ref.reset(key)
        else:
            assert got.duration(key) == ref.duration(key)
    burst = int(rng.integers(1, 20))
    # A rate too low to refill within the test: only the burst passes.
    got, ref = ratelimit.TokenBucket(1e-9, burst), jratelimit.TokenBucket(1e-9, burst)
    assert [got.try_accept() for _ in range(burst + 3)] == [ref.try_accept()
                                                            for _ in range(burst + 3)]
    with pytest.raises(ValueError):
        ratelimit.TokenBucket(0, 1)


# -- reflectors and informers over the JAX apiserver ------------------------


def _mkpod(name, **labels):
    return {"kind": "Pod", "metadata": {"name": name, "namespace": "default", "labels": labels},
            "spec": {"containers": [{"name": "c", "image": "app"}]}}


class _Recorded:
    """An informer and the (event, key) deltas its handlers saw."""

    def __init__(self, informer_cls, client, decode, key):
        self.seen = []
        self.informer = informer_cls(
            client, "pods", decode=decode,
            on_add=lambda o: self.seen.append(("ADDED", key(o))),
            on_update=lambda o: self.seen.append(("MODIFIED", key(o))),
            on_delete=lambda o: self.seen.append(("DELETED", key(o))),
        )

    def keys(self):
        return sorted(self.informer.store.keys())


def test_informer_matches_jax_over_local_transport():
    api = APIServer()
    setup = JClient(JLocalTransport(api))
    for i in range(6):
        setup.create("pods", _mkpod(f"a{i}"), namespace="default")
    got = _Recorded(cache.Informer, Client(LocalTransport(api)),
                    lambda w: serde.from_wire(objects.Pod, w), cache.meta_namespace_key)
    ref = _Recorded(jcache.Informer, JClient(JLocalTransport(api)),
                    lambda w: jserde.from_wire(jobjects.Pod, w), jcache.meta_namespace_key)
    for r in (got, ref):
        r.informer.start()
        assert r.informer.wait_for_sync(10)
    try:
        for i in range(6, 12):
            setup.create("pods", _mkpod(f"a{i}"), namespace="default")
        for i in range(3):
            setup.patch("pods", f"a{i}", {"metadata": {"labels": {"x": "y"}}},
                        namespace="default")
        for i in (4, 7):
            setup.delete("pods", f"a{i}", namespace="default")
        want = sorted(f"default/{p.metadata.name}"
                      for p in setup.list("pods", namespace="default")[0])
        assert wait_until(lambda: got.keys() == want and ref.keys() == want)
        assert wait_until(lambda: got.seen == ref.seen)
        assert isinstance(got.informer.store.get("default/a0"), objects.Pod)
        assert got.informer.store.get("default/a0").metadata.labels == {"x": "y"}
    finally:
        for r in (got, ref):
            r.informer.stop()
    # A watch outage: objects vanish and appear while nobody watches,
    # then a forced re-list.
    for i in (0, 1, 9):
        setup.delete("pods", f"a{i}", namespace="default")
    setup.create("pods", _mkpod("late"), namespace="default")
    for r in (got, ref):
        r.seen.clear()
        r.informer.reflector._list()
    assert got.seen == ref.seen
    assert sorted(k for e, k in got.seen if e == "DELETED") == [
        "default/a0", "default/a1", "default/a9"]
    assert got.keys() == ref.keys() and "default/late" in got.keys()
    assert got.informer.reflector.list_count == 2


def test_reflector_feeds_a_fifo_and_keeps_deletes_raw():
    api = APIServer()
    setup = JClient(JLocalTransport(api))
    fifo, deleted = cache.FIFO(), []
    ref = cache.Reflector(
        Client(LocalTransport(api)), "pods", fifo, field_selector="spec.nodeName=",
        decode=lambda w: serde.from_wire(objects.Pod, w), decode_deleted=False,
        on_event=lambda e, o: e == "DELETED" and deleted.append(o),
    ).start()
    try:
        assert ref.wait_for_sync(10)
        setup.create("pods", _mkpod("q"), namespace="default")
        assert wait_until(lambda: len(fifo) == 1)
        setup.delete("pods", "q", namespace="default")
        assert wait_until(lambda: deleted)
        assert isinstance(deleted[0], dict) and ref.last_event_mono > 0
    finally:
        ref.stop()


# -- over HTTP -------------------------------------------------------------------


@pytest.fixture
def two_servers():
    """Two apiservers over HTTP, seeded with the same nodes and pods."""
    servers = []
    for _ in range(2):
        api = APIServer()
        setup = JClient(JLocalTransport(api))
        for j in range(3):
            setup.create("nodes", {"kind": "Node", "metadata": {"name": f"n{j}"},
                                   "status": {"capacity": {"cpu": "4", "memory": "8Gi",
                                                           "pods": "110"}}})
        for i in range(8):
            setup.create("pods", _mkpod(f"h{i}", app=f"a{i % 2}"), namespace="default")
        setup.bind("h0", "n0", namespace="default")
        servers.append(APIHTTPServer(api).start())
    yield [s.address for s in servers]
    for s in servers:
        s.stop()


def test_http_list_matches_jax(two_servers):
    url = two_servers[0]
    got_items, got_v = Client(HTTPTransport(url)).list("pods", namespace="default",
                                                      field_selector="spec.nodeName=")
    ref_items, ref_v = JClient(JHTTPTransport(url)).list("pods", namespace="default",
                                                         field_selector="spec.nodeName=")
    assert got_v == ref_v and len(got_items) == len(ref_items) == 7
    for a, b in zip(got_items, ref_items):
        assert_same_fields(a, b)
    nodes, _ = Client(HTTPTransport(url)).list("nodes")
    assert [n.metadata.name for n in nodes] == ["n0", "n1", "n2"]


def test_http_watch_matches_jax(two_servers):
    url = two_servers[0]
    _, version = JClient(JHTTPTransport(url)).list("pods", namespace="default")
    got = Client(HTTPTransport(url)).watch("pods", namespace="default", since=version)
    ref = JClient(JHTTPTransport(url)).watch("pods", namespace="default", since=version)
    try:
        setup = JClient(JHTTPTransport(url))
        setup.create("pods", _mkpod("w0"), namespace="default")
        setup.bind("w0", "n1", namespace="default")
        setup.delete("pods", "h3", namespace="default")

        def take(stream):
            out = []
            while len(out) < 3:
                ev = stream.next(timeout=10)
                assert ev is not None, out
                out.append((ev.type, ev.object["metadata"]["name"], ev.version,
                            ev.object.get("spec", {}).get("nodeName", "")))
            return out

        assert take(got) == take(ref)
    finally:
        got.close()
        ref.close()
    assert wait_until(lambda: got.closed)


def test_http_bind_bulk_matches_jax(two_servers):
    got_c = Client(HTTPTransport(two_servers[0]))
    ref_c = JClient(JHTTPTransport(two_servers[1]))
    plain = [("h1", "n1"), ("h2", "n2"), ("h0", "n2")]  # h0 is bound already: 409
    atomic = [("h4", "n0"), ("h5", "n1"), ("h1", "n0")]  # h1 now bound: the batch rolls back
    for items, kw in ((plain, {}), (atomic, {"atomic": True})):
        got = got_c.bind_bulk(items, namespace="default", **kw)
        ref = ref_c.bind_bulk(items, namespace="default", **kw)
        assert got == ref
    assert [r.get("status") for r in got] != ["Success"] * 3
    assert {r.get("reason") for r in got if r.get("status") != "Success"} >= {"Aborted"}
    bound = {p.metadata.name: p.spec.node_name
             for p in got_c.list("pods", namespace="default")[0]}
    assert bound["h4"] == "" and bound["h1"] == "n1" and bound["h2"] == "n2"


def test_fifo_peek_is_the_next_pop():
    q = cache.FIFO()
    assert q.peek() is None
    for name in ("a", "b", "c"):
        q.add(_mkpod(name))
    q.delete(_mkpod("a"))
    assert q.peek()["metadata"]["name"] == "b" and len(q) == 2
    assert q.pop(timeout=0)["metadata"]["name"] == "b"
    assert q.peek()["metadata"]["name"] == "c"


def _same_but_stamps(port, ref):
    """assert_same_fields, the server-assigned uid, resourceVersion and
    creationTimestamp aside (twin servers assign their own)."""
    for k in ("uid", "resource_version", "creation_timestamp"):
        setattr(port.metadata, k, getattr(ref.metadata, k))
    assert_same_fields(port, ref)


def _journal(name, dest):
    return {"kind": "PodTemplate", "apiVersion": "v1",
            "metadata": {"name": name, "namespace": "default",
                         "labels": {"rebalance.kubernetes-tpu.io/move": dest}},
            "template": {"metadata": {"name": name}, "spec": {"containers": [
                {"name": "c", "image": "app", "restartPolicyX": "kept"}]}}}


@pytest.mark.parametrize("over", ["http", "local"])
def test_wire_reads_delete_and_podtemplates_match_jax(two_servers, over):
    """The port's client against the JAX client on twin servers: the
    wire reads return the stored dicts (fields the port does not model
    included), the typed reads decode them, a label-existence selector
    passes unchanged, and deletes (a grace on a bound pod marks it
    Terminating) leave the servers alike."""
    if over == "http":
        got_c, ref_c = Client(HTTPTransport(two_servers[0])), JClient(JHTTPTransport(two_servers[1]))
    else:
        apis = [APIServer(), APIServer()]
        for api in apis:
            setup = JClient(JLocalTransport(api))
            setup.create("nodes", {"kind": "Node", "metadata": {"name": "n0"}})
            for i in range(8):
                setup.create("pods", _mkpod(f"h{i}", app=f"a{i % 2}"), namespace="default")
            setup.bind("h0", "n0", namespace="default")
        got_c, ref_c = Client(LocalTransport(apis[0])), JClient(JLocalTransport(apis[1]))
    for c in (got_c, ref_c):
        c.create("podtemplates", _journal("rebalance-move-a", "n1"), namespace="default")
        c.create("podtemplates", dict(_journal("other", "n2"), metadata={
            "name": "other", "namespace": "default", "labels": {"app": "x"}}),
            namespace="default")
    label = "rebalance.kubernetes-tpu.io/move"
    got, _ = got_c.list_wire("podtemplates", label_selector=label)
    ref, _ = ref_c.list("podtemplates", label_selector=label)
    assert [t["metadata"]["name"] for t in got] == [t.metadata.name for t in ref] == [
        "rebalance-move-a"]
    assert got[0]["template"]["spec"]["containers"][0]["restartPolicyX"] == "kept"
    typed, _ = got_c.list("podtemplates", label_selector=label)
    _same_but_stamps(typed[0], ref[0])
    wire = got_c.get_wire("pods", "h1", namespace="default")
    _same_but_stamps(serde.from_wire(objects.Pod, wire), ref_c.get("pods", "h1", namespace="default"))
    pods, version = got_c.list_wire("pods", namespace="default")
    _, ref_version = ref_c.list("pods", namespace="default")
    assert version == ref_version and len(pods) == 8
    assert all(isinstance(p, dict) for p in pods)

    for c in (got_c, ref_c):
        c.delete("podtemplates", "rebalance-move-a", namespace="default")
        c.delete("pods", "h2", namespace="default")
        c.delete("pods", "h0", namespace="default", grace_period_seconds=30)
    assert got_c.list_wire("podtemplates", label_selector=label)[0] == []
    names = sorted(p["metadata"]["name"] for p in got_c.list_wire("pods", "default")[0])
    assert names == sorted(p.metadata.name for p in ref_c.list("pods", "default")[0])
    assert "h2" not in names
    h0 = got_c.get_wire("pods", "h0", namespace="default")
    assert h0["metadata"].get("deletionTimestamp")
    assert ref_c.get("pods", "h0", namespace="default").metadata.deletion_timestamp
    from kubernetes_tpu_torch.client.rest import APIError

    with pytest.raises(APIError) as e:
        got_c.delete("pods", "nope", namespace="default")
    assert e.value.code == 404
