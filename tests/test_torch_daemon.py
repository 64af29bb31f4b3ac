"""The port's scheduler daemon decides as the JAX daemon does.

Two apiservers (the JAX package's `APIServer`) are seeded with the same
objects from a numpy seed. The JAX `IncrementalBatchScheduler` drives
one, the port's (`device="cpu"`) the other; neither is started, so
every tick is one synchronous `schedule_batch()`. After the same
operations, pod for pod the bindings, the Scheduled and FailedScheduling
event counts and the session's host mirror (compared by node name) must
be equal, and after every tick the capacity monitor's snapshot (each
package's `utils.capacity.DEFAULT`, fed by the daemon's capacity
sample) on every field but the backlog's age and pressure, which follow
the wall clock. Both daemons sample on every idle tick
(`CAPACITY_IDLE_REFRESH_S` 0), so the samples do not depend on timing.

The retry backoff runs on threads; here both daemons hand their
rejected pods to the test instead, which sends them back through each
daemon's own `_refetch_and_requeue` at the same points. The JAX daemon's
decision records (telemetry the port does not carry, departure (d))
are switched off on its instance.

One test runs the port's daemon started, over HTTP; its waits are
bounded and it asserts no timing. One runs the port's daemon on the
port's own apiserver (`kubernetes_tpu_torch.server.api.APIServer`),
seeded through the port's client, against the JAX daemon on JAX's.
"""

import copy
import time

import numpy as np
import pytest
import torch

from kubernetes_tpu.client import Client as JClient
from kubernetes_tpu.client import HTTPTransport as JHTTPTransport
from kubernetes_tpu.client import LocalTransport as JLocalTransport
from kubernetes_tpu.ops import RebuildRequired as JRebuildRequired
from kubernetes_tpu.scheduler.daemon import IncrementalBatchScheduler as JDaemon
from kubernetes_tpu.scheduler.daemon import SchedulerConfig as JConfig
from kubernetes_tpu.server.api import APIServer
from kubernetes_tpu.server.httpserver import APIHTTPServer
from kubernetes_tpu.utils import capacity as jcapmod
from kubernetes_tpu_torch.client.rest import Client, HTTPTransport, LocalTransport
from kubernetes_tpu_torch.models.objects import POD_GROUP_LABEL
from kubernetes_tpu_torch.ops import RebuildRequired
from kubernetes_tpu_torch.scheduler.daemon import IncrementalBatchScheduler, SchedulerConfig
from kubernetes_tpu_torch.server.api import APIServer as PortAPIServer
from kubernetes_tpu_torch.utils import capacity as capmod
from tests.test_torch_apiserver import jax_request_latency_kept  # noqa: F401 (autouse)

N_NODES, N_PODS = 64, 600


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def wait_until(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


# -- seeded objects -----------------------------------------------------------


def node_wire(name, rng):
    cpu = int(rng.choice([2, 4, 8]))
    return {
        "kind": "Node",
        "metadata": {"name": name, "labels": {"zone": f"z{int(rng.integers(3))}",
                                              "disk": ("ssd", "hdd")[int(rng.integers(2))]}},
        "status": {"capacity": {"cpu": str(cpu), "memory": f"{2 * cpu}Gi", "pods": "20"},
                   "conditions": [{"type": "Ready", "status": "True"}]},
    }


def pod_wire(name, rng, priority=0, labels=None, cpu=None):
    container = {
        "name": "c", "image": "app",
        "resources": {"limits": {
            "cpu": cpu or f"{int(rng.choice([100, 250, 500, 1000]))}m",
            "memory": f"{int(rng.choice([64, 256, 512]))}Mi"}},
    }
    if rng.random() < 0.1:
        container["ports"] = [{"containerPort": 80, "hostPort": int(rng.choice([8080, 9090]))}]
    spec = {"containers": [container]}
    if rng.random() < 0.15:
        spec["nodeSelector"] = {"disk": "ssd"} if rng.random() < 0.5 else {
            "zone": f"z{int(rng.integers(3))}"}
    if priority:
        spec["priority"] = priority
    return {"kind": "Pod",
            "metadata": {"name": name, "namespace": "default",
                         "labels": labels or {"app": f"a{int(rng.integers(4))}"}},
            "spec": spec}


def service_wire(name, app):
    return {"kind": "Service", "metadata": {"name": name, "namespace": "default"},
            "spec": {"selector": {"app": app}, "ports": [{"port": 80}]}}


class Pair:
    """The JAX daemon on one apiserver and the port's on another, both
    fed the same operations."""

    compare_capacity = True
    #: Backlog fields of the capacity snapshot that follow timing.
    capacity_timed = ("oldest_age_s", "pressure")

    def __init__(self, seed=0, n_nodes=N_NODES, n_pods=N_PODS, services=2, max_batch=256,
                 port_apiserver=False, **daemon_kw):
        # With `port_apiserver`, the port's daemon runs on the port's
        # apiserver, seeded and changed through the port's client.
        if port_apiserver:
            self.apis = [APIServer(), PortAPIServer()]
            self.setups = [JClient(JLocalTransport(self.apis[0])),
                           Client(LocalTransport(self.apis[1]))]
        else:
            self.apis = [APIServer(), APIServer()]
            self.setups = [JClient(JLocalTransport(a)) for a in self.apis]
        rng = np.random.default_rng(seed)
        nodes = [node_wire(f"n{j}", rng) for j in range(n_nodes)]
        pods = [pod_wire(f"p{i}", rng) for i in range(n_pods)]
        for c in self.setups:
            for s in range(services):
                c.create("services", service_wire(f"s{s}", f"a{s}"), namespace="default")
            for n in nodes:
                c.create("nodes", n)
            c.create_bulk("pods", pods, namespace="default")
        self.jcfg = JConfig(JClient(JLocalTransport(self.apis[0]))).start()
        self.tcfg = SchedulerConfig(Client(LocalTransport(self.apis[1]))).start()
        assert self.jcfg.wait_for_sync() and self.tcfg.wait_for_sync()
        self.j = JDaemon(self.jcfg, max_batch=max_batch, **daemon_kw)
        self.t = IncrementalBatchScheduler(self.tcfg, max_batch=max_batch, device="cpu",
                                           **daemon_kw)
        self.j._record_decisions = lambda *a, **k: None
        for d, cfg in ((self.j, self.jcfg), (self.t, self.tcfg)):
            d.CAPACITY_IDLE_REFRESH_S = 0.0
            d.held = []
            d._requeue_many = lambda pods, epoch=None, _d=d: _d.held.extend(pods)
            # Count the deltas handed to each daemon: equal servers give
            # both daemons the same deltas, so equal counts mean neither
            # has one still on its way to the event queue.
            d.deltas = 0

            def counted(kind, etype, obj, _d=d, _hook=cfg.cluster_events):
                _hook(kind, etype, obj)
                _d.deltas += 1

            cfg.cluster_events = counted

    def daemons(self):
        return ((self.j, self.jcfg, self.apis[0]), (self.t, self.tcfg, self.apis[1]))

    def capacity_snapshots(self):
        """Both monitors' snapshots less the backlog's timed fields."""
        out = []
        for snap in (jcapmod.DEFAULT.snapshot(), capmod.DEFAULT.snapshot()):
            snap = copy.deepcopy(snap)
            for k in self.capacity_timed:
                snap.get("backlog", {}).pop(k, None)
            out.append(snap)
        return out

    def assert_capacity_same(self):
        jsnap, tsnap = self.capacity_snapshots()
        assert tsnap == jsnap
        return tsnap

    def each(self, verb, *args, **kw):
        for c in self.setups:
            getattr(c, verb)(*args, **kw)

    def _caught_up(self, d, cfg, api):
        pods = api.list("pods", "default")["items"]
        bound = {p["metadata"]["name"] for p in pods if p["spec"].get("nodeName")}
        unbound = {p["metadata"]["name"] for p in pods} - bound
        queued = {k.split("/")[1] for k in cfg.pod_queue._queue if k in cfg.pod_queue._items}
        held = {p.metadata.name for p in d.held}
        names = lambda inf: {k.split("/")[-1] for k in inf.store.keys()}  # noqa: E731
        return (queued | held == unbound and names(cfg.scheduled_pods) == bound
                and names(cfg.nodes) == {n["metadata"]["name"]
                                         for n in api.list("nodes", "")["items"]}
                and names(cfg.services) == {s["metadata"]["name"]
                                            for s in api.list("services", "default")["items"]}
                and names(cfg.podgroups) == {g["metadata"]["name"]
                                             for g in api.list("podgroups", "default")["items"]})

    def _settled(self):
        return (all(self._caught_up(*x) for x in self.daemons())
                and self.j.deltas == self.t.deltas)

    def settle(self):
        """Both daemons' caches and queues hold what their apiservers
        hold, and both have been handed the same deltas, twice in a row
        a beat apart."""
        assert wait_until(lambda: self._settled() and (time.sleep(0.05) or self._settled()))

    def tick_all(self):
        """Tick both until their queues are empty; the tick sizes agree."""
        ticks = 0
        while True:
            self.settle()
            nj, nt = self.j.schedule_batch(timeout=0.05), self.t.schedule_batch(timeout=0.05)
            assert nj == nt, f"tick {ticks}: jax took {nj} pods, the port {nt}"
            if self.compare_capacity:
                self.assert_capacity_same()
            if nj == 0:
                return ticks
            ticks += 1

    def retry(self):
        """Send the rejected pods back, through each daemon's refetch."""
        for d in (self.j, self.t):
            held, d.held = d.held, []
            for pod in held:
                d._refetch_and_requeue(pod)

    def bindings(self, k):
        return {p["metadata"]["name"]: p["spec"].get("nodeName", "")
                for p in self.apis[k].list("pods", "default")["items"]}

    def events(self, k):
        cfg = (self.jcfg, self.tcfg)[k]
        cfg.client.flush_events(timeout=10)
        out = {}
        for ev in self.apis[k].list("events", "default")["items"]:
            n, total = out.get(ev["reason"], (0, 0))
            out[ev["reason"]] = (n + 1, total + int(ev.get("count", 1)))
        return out

    @staticmethod
    def mirror(d):
        s = d._session
        rows = {name: j for j, name in enumerate(s.node_names) if name is not None}
        return ({name: {k: col[j] for k, col in s.h.items()} for name, j in rows.items()},
                {key: s.node_names[j] for key, j in s._pod_node.items()})

    def assert_same(self):
        jb, tb = self.bindings(0), self.bindings(1)
        diff = [n for n in jb if jb[n] != tb.get(n)]
        assert jb.keys() == tb.keys() and not diff, f"{len(diff)} differ, first {diff[:3]}"
        assert self.events(0) == self.events(1)
        (jrows, jpods), (trows, tpods) = self.mirror(self.j), self.mirror(self.t)
        assert jpods == tpods and jrows.keys() == trows.keys()
        for name, cols in jrows.items():
            for k, ref in cols.items():
                got = trows[name][k]
                assert got.dtype == ref.dtype and np.array_equal(got, ref), f"{name}: h[{k!r}]"
        return jb

    def stop(self):
        for d in (self.j, self.t):
            d.stop()


@pytest.fixture(autouse=True)
def fresh_capacity_monitors(monkeypatch):
    monkeypatch.setattr(jcapmod, "DEFAULT", jcapmod.CapacityMonitor())
    monkeypatch.setattr(capmod, "DEFAULT", capmod.CapacityMonitor())


@pytest.fixture
def pair_factory():
    made = []

    def make(**kw):
        made.append(Pair(**kw))
        return made[-1]

    yield make
    for p in made:
        p.stop()


def test_backlog_ticks_match_jax(pair_factory):
    pair = pair_factory(seed=1)
    assert pair.tick_all() == 3  # 600 pods at max_batch 256
    bound = pair.assert_same()
    assert sum(bool(v) for v in bound.values()) > N_PODS // 2
    assert pair.t.device_errors == 0 and pair.j.fallback_count == 0


def test_deletes_and_node_churn_match_jax(pair_factory):
    pair = pair_factory(seed=2, n_pods=900)
    pair.tick_all()
    pair.assert_same()
    bound = sorted(n for n, v in pair.bindings(0).items() if v)
    for name in bound[::3]:
        pair.each("delete", "pods", name, namespace="default")
    pair.each("create", "nodes", node_wire("late0", np.random.default_rng(7)))
    pair.each("delete", "nodes", "n5")
    pair.retry()
    pair.tick_all()
    pair.assert_same()
    rng = np.random.default_rng(8)
    more = [pod_wire(f"q{i}", rng) for i in range(150)]
    pair.each("create_bulk", "pods", more, namespace="default")
    pair.each("delete", "nodes", "n9")
    pair.tick_all()
    bound = pair.assert_same()
    assert any(v == "late0" for v in bound.values())
    assert not any(v in ("n5", "n9") and n.startswith("q") for n, v in bound.items())


def test_port_daemon_on_the_port_apiserver_matches_jax(pair_factory):
    """The JAX daemon on the JAX apiserver, the port's on the port's:
    the same bindings, events and session mirror after every round of
    ticks, through pod deletes, node churn and a second wave."""
    pair = pair_factory(seed=9, n_pods=700, port_apiserver=True)
    assert pair.tick_all() == 3
    pair.assert_same()
    bound = sorted(n for n, v in pair.bindings(0).items() if v)
    for name in bound[::4]:
        pair.each("delete", "pods", name, namespace="default")
    pair.each("create", "nodes", node_wire("late0", np.random.default_rng(9)))
    pair.each("delete", "nodes", "n3")
    pair.retry()
    pair.tick_all()
    pair.assert_same()
    rng = np.random.default_rng(10)
    pair.each("create_bulk", "pods", [pod_wire(f"q{i}", rng) for i in range(120)],
              namespace="default")
    pair.tick_all()
    bound = pair.assert_same()
    assert any(v == "late0" for v in bound.values())
    assert pair.t.device_errors == 0


def test_service_change_rebuilds_and_matches_jax(pair_factory):
    pair = pair_factory(seed=3)
    pair.tick_all()
    pair.assert_same()
    rebuilds = pair.t.rebuilds
    pair.each("create", "services", service_wire("s-new", "a3"), namespace="default")
    rng = np.random.default_rng(9)
    pair.each("create_bulk", "pods", [pod_wire(f"r{i}", rng, labels={"app": "a3"})
                                      for i in range(100)], namespace="default")
    pair.tick_all()
    pair.assert_same()
    assert pair.t.rebuilds == rebuilds + 1 and pair.t._session.S == 3


def test_rebuild_required_resolves_the_same_tick(pair_factory, monkeypatch):
    """Departure (a): the port rebuilds its session and solves the
    tick's pods again; the JAX daemon falls to its full re-lower tick.
    The bindings are the same."""
    pair = pair_factory(seed=4, n_pods=300)
    pair.tick_all()
    pair.assert_same()
    armed = {"j": True, "t": True}

    def fail_once(daemon, tag, exc):
        session = daemon._session
        add = session.add_pending

        def add_pending(pod):
            if armed[tag]:
                armed[tag] = False
                raise exc("vocabulary full")
            return add(pod)

        monkeypatch.setattr(session, "add_pending", add_pending)

    fail_once(pair.j, "j", JRebuildRequired)
    fail_once(pair.t, "t", RebuildRequired)
    rng = np.random.default_rng(10)
    pair.each("create_bulk", "pods", [pod_wire(f"v{i}", rng) for i in range(100)],
              namespace="default")
    pair.settle()
    pair.j.schedule_batch(timeout=0.05)
    pair.t.schedule_batch(timeout=0.05)
    pair.tick_all()
    jb, tb = pair.bindings(0), pair.bindings(1)
    assert jb == tb and any(jb[f"v{i}"] for i in range(100))
    assert not armed["t"] and pair.t.rebuilds == 1 and pair.t.device_errors == 0
    assert pair.j.fallback_count == 1


def widen(pair, first_pod, n_pods, rng):
    """Objects past the JAX session's 128 tokens a vocabulary: every
    node gets a hostname and a rack label of its own (the pods created
    after are spread over them), and `n_pods` new pods each mount a
    disk of their own, one in ten shared read-only, and one in eight
    selects a host."""
    pods = []
    for i in range(first_pod, first_pod + n_pods):
        pod = pod_wire(f"w{i}", rng)
        shared = i % 10 == 0
        pod["spec"]["volumes"] = [{"name": "data", "gcePersistentDisk": {
            "pdName": "pd-shared" if shared else f"pd-{i}", "readOnly": shared}}]
        if i % 8 == 0:
            pod["spec"]["nodeSelector"] = {"kubernetes.io/hostname": f"n{i % N_NODES}"}
        pods.append(pod)
    return pods


def test_wide_vocabularies_match_jax(pair_factory):
    """Past 128 node labels and 128 volumes the JAX session overflows
    and its daemon re-lowers every tick; the port sizes its session from
    the caches and keeps ticking on it, to the same bindings and events.
    Volumes past that session's headroom rebuild it (departure (a)).
    Each tick takes the whole queue: the JAX daemon's fallback puts a
    tick's pods back behind what is still queued, so with a longer queue
    it would solve other pods first."""
    pair = pair_factory(seed=14, n_pods=0, max_batch=1024)
    for j in range(N_NODES):
        for c in pair.setups:
            node = c.get("nodes", f"n{j}")
            node.metadata.labels.update({"kubernetes.io/hostname": f"n{j}", "rack": f"r{j}"})
            c.update("nodes", node)
    rng = np.random.default_rng(15)
    pair.each("create_bulk", "pods", widen(pair, 0, 400, rng), namespace="default")
    pair.settle()
    pair.t.prewarm()  # the build over the caches, queued pods included
    assert (pair.t._session.LW, pair.t._session.VW) == (6, 15)
    pair.tick_all()
    bound = pair.bindings(0)
    assert bound == pair.bindings(1) and pair.events(0) == pair.events(1)
    assert pair.j.fallback_count > 0 and pair.j._session is None
    rebuilds = pair.t.rebuilds
    pair.each("create_bulk", "pods", widen(pair, 400, 300, rng), namespace="default")
    pair.tick_all()
    bound = pair.bindings(0)
    assert bound == pair.bindings(1) and pair.events(0) == pair.events(1)
    assert pair.t.rebuilds > rebuilds and pair.t.device_errors == 0
    assert pair.t._session.VW > 15
    assert sum(bool(v) for v in bound.values()) > 500
    for i in range(0, 700, 8):
        assert bound[f"w{i}"] in ("", f"n{i % N_NODES}")


def test_gangs_match_jax(pair_factory):
    pair = pair_factory(seed=5, n_nodes=16, n_pods=40)
    pair.tick_all()
    pair.assert_same()
    rng = np.random.default_rng(11)
    for name, min_member in (("met", 4), ("short", 6)):
        pair.each("create", "podgroups", {"kind": "PodGroup",
                                          "metadata": {"name": name, "namespace": "default"},
                                          "spec": {"minMember": min_member}},
                  namespace="default")
    gangs = []
    for name, members in (("met", 4), ("short", 3)):
        gangs += [pod_wire(f"{name}{i}", rng, labels={POD_GROUP_LABEL: name}, cpu="200m")
                  for i in range(members)]
    pair.each("create_bulk", "pods", gangs, namespace="default")
    pair.tick_all()
    bound = pair.assert_same()
    assert all(bound[f"met{i}"] for i in range(4))
    assert not any(bound[f"short{i}"] for i in range(3))
    reasons = pair.events(1)
    assert reasons["FailedScheduling"][1] >= 3


def test_priority_burst_preempts_as_jax(pair_factory):
    pair = pair_factory(seed=6, n_nodes=8, n_pods=0, services=0,
                        eviction_grace_seconds=30)
    # The queue's depth at the sample counts preemptors that the tick's
    # own nomination patches have sent back through the watch by then.
    pair.capacity_timed += ("depth",)
    rng = np.random.default_rng(12)
    fill = [pod_wire(f"low{i}", rng, cpu="500m") for i in range(8 * 16)]
    pair.each("create_bulk", "pods", fill, namespace="default")
    pair.tick_all()
    pair.assert_same()
    burst = [pod_wire(f"hi{i}", rng, priority=100, cpu="1500m") for i in range(6)]
    pair.each("create_bulk", "pods", burst, namespace="default")
    pair.tick_all()
    pair.assert_same()

    def evicted(k):
        return sorted(p["metadata"]["name"] for p in pair.apis[k].list("pods", "default")["items"]
                      if p["metadata"].get("deletionTimestamp"))

    def nominated(k):
        return {p["metadata"]["name"]: p["status"].get("nominatedNodeName")
                for p in pair.apis[k].list("pods", "default")["items"]
                if p.get("status", {}).get("nominatedNodeName")}

    assert evicted(0) == evicted(1) and evicted(1)
    assert nominated(0) == nominated(1) and nominated(1)
    assert {k: v[:2] for k, v in pair.j._nominations.items()} == {
        k: v[:2] for k, v in pair.t._nominations.items()}
    assert pair.events(0).get("Preempted") == pair.events(1).get("Preempted")


def test_device_errors_propagate(pair_factory, monkeypatch):
    """A failing solve raises out of schedule_batch and is counted; there
    is no scalar path to fall to, and nothing is bound."""
    pair = pair_factory(seed=7, n_pods=50)
    daemon = pair.t
    pair.settle()
    daemon.prewarm()

    def broken():
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(daemon._session, "solve_async", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        daemon.schedule_batch(timeout=0.05)
    assert daemon.device_errors == 1
    assert not any(pair.bindings(1).values())


def test_started_daemon_stops_after_a_device_error(monkeypatch):
    api = APIServer()
    setup = JClient(JLocalTransport(api))
    setup.create("nodes", node_wire("n0", np.random.default_rng(0)))
    cfg = SchedulerConfig(Client(LocalTransport(api))).start()
    assert cfg.wait_for_sync()
    daemon = IncrementalBatchScheduler(cfg, device="cpu")
    daemon.prewarm()
    monkeypatch.setattr(daemon._session, "solve_async",
                        lambda: (_ for _ in ()).throw(RuntimeError("device lost")))
    daemon.start()
    try:
        setup.create("pods", pod_wire("x", np.random.default_rng(1)), namespace="default")
        assert wait_until(lambda: not daemon._thread.is_alive())
        assert daemon.device_errors == 1
    finally:
        daemon.stop()


def test_started_daemon_over_http_binds_everything_once():
    api = APIServer()
    setup = JClient(JLocalTransport(api))
    rng = np.random.default_rng(13)
    for j in range(16):
        setup.create("nodes", node_wire(f"n{j}", rng))
    srv = APIHTTPServer(api).start()
    watcher = JClient(JHTTPTransport(srv.address))
    _, version = watcher.list("pods", namespace="default")
    stream = watcher.watch("pods", namespace="default", since=version,
                           field_selector="spec.nodeName!=")
    cfg = SchedulerConfig(Client(HTTPTransport(srv.address))).start()
    daemon = None
    try:
        assert cfg.wait_for_sync()
        daemon = IncrementalBatchScheduler(cfg, device="cpu", max_batch=64, prewarm_buckets=64)
        daemon.prewarm()
        daemon.start()
        pods = [pod_wire(f"w{i}", rng, cpu="100m") for i in range(200)]
        for i in range(0, 200, 50):
            setup.create_bulk("pods", pods[i:i + 50], namespace="default")
        seen = {}
        deadline = time.monotonic() + 30
        while len(seen) < 200 and time.monotonic() < deadline:
            ev = stream.next(timeout=1)
            if ev is None:
                continue
            name, node = ev.object["metadata"]["name"], ev.object["spec"].get("nodeName")
            assert seen.setdefault(name, node) == node, f"{name} bound twice"
        assert len(seen) == 200
    finally:
        stream.close()
        if daemon is not None:
            daemon.stop()
        srv.stop()
    assert daemon._commit_q.unfinished_tasks == 0 and daemon._inflight is None
    assert daemon._commit_thread is None and daemon.device_errors == 0
    bound = {p.metadata.name: p.spec.node_name for p in setup.list("pods", namespace="default")[0]}
    assert all(bound[n] == seen[n] for n in seen)


def test_requeue_is_released_by_freed_capacity():
    api = APIServer()
    setup = JClient(JLocalTransport(api))
    cfg = SchedulerConfig(Client(LocalTransport(api))).start()
    assert cfg.wait_for_sync()
    daemon = IncrementalBatchScheduler(cfg, device="cpu")
    try:
        setup.create("pods", pod_wire("r", np.random.default_rng(2)), namespace="default")
        assert wait_until(lambda: len(cfg.pod_queue) == 1)
        pod = cfg.pod_queue.pop(timeout=1)
        cfg.backoff = type(cfg.backoff)(initial=3600.0, max_backoff=3600.0)
        with daemon._capacity_cond:
            epoch = daemon._capacity_epoch
        daemon._requeue_many([pod], epoch=epoch)
        time.sleep(0.2)
        assert len(cfg.pod_queue) == 0
        daemon._on_cluster_event("pod", "DELETED", {"metadata": {"name": "gone"}})
        assert wait_until(lambda: len(cfg.pod_queue) == 1)
        setup.delete("pods", "r", namespace="default")
        daemon._refetch_and_requeue(pod)  # a 404 drops it
        assert cfg.pod_queue.pop(timeout=0) is not None and len(cfg.pod_queue) == 0
    finally:
        daemon.stop()


def test_daemon_refuses_policies_and_unknown_modes():
    api = APIServer()
    policy = {"predicates": [{"name": "PodFitsResources"}],
              "priorities": [{"name": "LeastRequestedPriority", "weight": 1}]}
    cfg = SchedulerConfig(Client(LocalTransport(api)), policy=policy)
    with pytest.raises(ValueError, match="default policy only"):
        IncrementalBatchScheduler(cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown batch mode"):
        IncrementalBatchScheduler(SchedulerConfig(Client(LocalTransport(api))), mode="bogus",
                                  device="cpu")
    # `auto` is the scan on one card, as the JAX daemons resolve it
    # without a device mesh.
    daemon = IncrementalBatchScheduler(SchedulerConfig(Client(LocalTransport(api))), mode="auto",
                                       device="cpu")
    assert daemon.mode == "scan"


def test_kill_drops_queued_commits_and_stops_the_threads():
    api = APIServer()
    setup = JClient(JLocalTransport(api))
    setup.create("nodes", node_wire("n0", np.random.default_rng(3)))
    cfg = SchedulerConfig(Client(LocalTransport(api))).start()
    assert cfg.wait_for_sync()
    daemon = IncrementalBatchScheduler(cfg, device="cpu").start()
    try:
        assert wait_until(lambda: daemon._commit_thread.is_alive())
        worker, loop = daemon._commit_thread, daemon._thread
        daemon.kill()
        assert not loop.is_alive() and not worker.is_alive()
        assert daemon._commit_thread is None and daemon._commit_q.unfinished_tasks == 0
    finally:
        cfg.stop()


def test_label_rows_past_the_old_kernel_limit_match_jax(pair_factory):
    """40 nodes with 190 labels of their own (7,600 label tokens, as a
    hostname and rack labels per node would give a large cluster): the
    port's session sizes its label words from them, past the 224-word
    pod rows the scan kernel once refused, and ticks to the JAX daemon's
    bindings (which re-lowers every tick of such a cluster)."""
    from kubernetes_tpu_torch.ops import scan_kernel

    n_nodes = 40
    pair = pair_factory(seed=16, n_nodes=n_nodes, n_pods=0, max_batch=1024)
    for j in range(n_nodes):
        for c in pair.setups:
            node = c.get("nodes", f"n{j}")
            node.metadata.labels.update({f"l{j}-{k}": f"v{k % 7}" for k in range(190)})
            node.metadata.labels["kubernetes.io/hostname"] = f"n{j}"
            c.update("nodes", node)
    rng = np.random.default_rng(17)
    pods = []
    for i in range(240):
        pod = pod_wire(f"h{i}", rng, cpu="100m")
        if i % 3 == 0:
            pod["spec"]["nodeSelector"] = {f"l{i % n_nodes}-{i % 190}": f"v{(i % 190) % 7}"}
        elif i % 3 == 1:
            pod["spec"]["nodeSelector"] = {"kubernetes.io/hostname": f"n{(7 * i) % n_nodes}"}
        pods.append(pod)
    pair.each("create_bulk", "pods", pods, namespace="default")
    pair.settle()
    pair.t.prewarm()
    session = pair.t._session
    plan = scan_kernel.launch_plan(n_nodes, session.LW, session.PW, session.VW, 8)
    assert session.LW * 32 > 7600 and plan.row_words > 224 and plan.tile < scan_kernel.TILE
    pair.tick_all()
    bound = pair.bindings(0)
    assert bound == pair.bindings(1) and pair.events(0) == pair.events(1)
    assert pair.j.fallback_count > 0 and pair.t.device_errors == 0
    for i in range(0, 240, 3):
        assert bound[f"h{i}"] == f"n{i % n_nodes}"
    for i in range(1, 240, 3):
        assert bound[f"h{i}"] == f"n{(7 * i) % n_nodes}"
