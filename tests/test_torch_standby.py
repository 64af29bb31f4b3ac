"""The port's warm standby and lease-elected scheduler behave as the JAX
package's (`scheduler/standby.py`).

- Warm standby against the JAX one, on two apiservers (the JAX
  package's `APIServer`) seeded alike: both standbys prewarm (informers
  synced, session built; the port's daemon with `device="cpu"`), then the same
  deltas arrive while they idle (pods created, bound pods deleted, nodes
  added, pods bound by someone else, and, in one case, the snapshot's
  own objects replayed as deltas that raced the build). Nothing binds
  until `activate()`; then the first tick replays the queued deltas and
  binds the backlog. The bindings equal the JAX standby's, pod for pod,
  and a fresh `schedule_backlog` of the queued pods, in their drain
  order, on the cluster LISTed at activation (its nodes in the node
  cache's order); the session's host mirror equals the JAX session's.
- `activate()` is idempotent and prewarms a cold standby; `kill()` drops
  the daemon's session and stops its informers.
- `HAScheduler` (after `tests/test_standby.py:65-211`, over HTTP): the
  leader's crash hands the lease to the warm rival, which binds the next
  pod where `schedule_backlog` would, with the fencing token bumped; a
  deposed leader rebuilds a warm standby; a failed rebuild is counted
  and the next election builds one; a replica whose build or activation
  fails at its election declines the lease, and its rival leads and
  binds.
"""

import copy
import time

import numpy as np
import pytest
import torch

from kubernetes_tpu.client import Client as JClient
from kubernetes_tpu.client import LocalTransport as JLocalTransport
from kubernetes_tpu.scheduler.standby import WarmStandbyScheduler as JStandby
from kubernetes_tpu.server.api import APIServer
from kubernetes_tpu.server.httpserver import APIHTTPServer
from kubernetes_tpu.utils import capacity as jcapmod
from kubernetes_tpu_torch.client.rest import Client, HTTPTransport, LocalTransport
from kubernetes_tpu_torch.scheduler.batch import schedule_backlog
from kubernetes_tpu_torch.scheduler.daemon import IncrementalBatchScheduler
from kubernetes_tpu_torch.scheduler.standby import HAScheduler, WarmStandbyScheduler
from kubernetes_tpu_torch.utils import capacity as capmod

N_NODES, N_BOUND, N_PENDING = 12, 40, 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_capacity_monitors(monkeypatch):
    monkeypatch.setattr(jcapmod, "DEFAULT", jcapmod.CapacityMonitor())
    monkeypatch.setattr(capmod, "DEFAULT", capmod.CapacityMonitor())


def on_cpu(config):
    return IncrementalBatchScheduler(config, device="cpu")


def wait_until(cond, timeout=30.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def node_wire(name, rng=None, cpu=None):
    cpu = cpu or int(rng.choice([4, 8, 16]))
    return {"kind": "Node",
            "metadata": {"name": name, "labels": {"zone": f"z{len(name) % 3}"}},
            "status": {"capacity": {"cpu": str(cpu), "memory": f"{2 * cpu}Gi", "pods": "40"},
                       "conditions": [{"type": "Ready", "status": "True"}]}}


def pod_wire(name, rng=None, cpu="100m", mem="64Mi"):
    if rng is not None:
        cpu = f"{int(rng.choice([100, 250, 500]))}m"
        mem = f"{int(rng.choice([64, 128, 256]))}Mi"
    return {"kind": "Pod",
            "metadata": {"name": name, "namespace": "default",
                         "labels": {"app": f"a{len(name) % 2}"}},
            "spec": {"containers": [{"name": "c", "image": "pause",
                                     "resources": {"limits": {"cpu": cpu, "memory": mem}}}]}}


def service_wire(name, app):
    return {"kind": "Service", "metadata": {"name": name, "namespace": "default"},
            "spec": {"selector": {"app": app}, "ports": [{"port": 80}]}}


def bound_names(client):
    pods, _ = client.list("pods", namespace="default")
    return {p.metadata.name for p in pods if p.spec.node_name}


def bindings(api):
    return {p["metadata"]["name"]: p["spec"].get("nodeName", "")
            for p in api.list("pods", "default")["items"]}


def mirror(daemon):
    s = daemon._session
    rows = {name: j for j, name in enumerate(s.node_names) if name is not None}
    return ({name: {k: col[j] for k, col in s.h.items()} for name, j in rows.items()},
            {key: s.node_names[j] for key, j in s._pod_node.items()})


def queued(cfg):
    q = cfg.pod_queue
    return [q._items[k] for k in q._queue if k in q._items]


class Twins:
    """A JAX and a port warm standby on two apiservers seeded alike."""

    def __init__(self, seed=3):
        self.apis = [APIServer(), APIServer()]
        self.setups = [JClient(JLocalTransport(a)) for a in self.apis]
        rng = np.random.default_rng(seed)
        nodes = [node_wire(f"n{j}", rng) for j in range(N_NODES)]
        pods = [pod_wire(f"b{i}", rng) for i in range(N_BOUND)]
        self.rng = rng
        for c in self.setups:
            for s in range(2):
                c.create("services", service_wire(f"s{s}", f"a{s}"), namespace="default")
            for n in nodes:
                c.create("nodes", n)
            c.create_bulk("pods", pods, namespace="default")
            c.bind_bulk([(f"b{i}", f"n{(i * 7) % N_NODES}") for i in range(N_BOUND)],
                        namespace="default")
        self.j = JStandby(JClient(JLocalTransport(self.apis[0])), sync_timeout=30)
        self.t = WarmStandbyScheduler(Client(LocalTransport(self.apis[1])), sync_timeout=30,
                                      daemon_factory=on_cpu)
        # The JAX daemon's decision records are telemetry the port's
        # test does not compare here.
        self.j.daemon._record_decisions = lambda *a, **k: None
        for sb in (self.j, self.t):
            sb.deltas = 0
            hook = sb.config.cluster_events

            def counted(kind, etype, obj, _sb=sb, _hook=hook):
                _hook(kind, etype, obj)
                _sb.deltas += 1

            sb.config.cluster_events = counted

    def each(self, verb, *args, **kw):
        for c in self.setups:
            getattr(c, verb)(*args, **kw)

    def standbys(self):
        return ((self.j, self.apis[0]), (self.t, self.apis[1]))

    def settled(self):
        """Both queues hold their apiserver's unbound pods, and both
        daemons were handed the same deltas."""
        for sb, api in self.standbys():
            b = bindings(api)
            if {p.metadata.name for p in queued(sb.config)} != {n for n, v in b.items() if not v}:
                return False
        return self.j.deltas == self.t.deltas

    def stop(self):
        for sb, _ in self.standbys():
            sb.stop()


@pytest.mark.parametrize("raced", [False, True], ids=["deltas", "deltas_and_raced_snapshot"])
def test_deltas_queued_while_warm_replay_on_activate_as_jax(raced):
    tw = Twins()
    try:
        for sb, _ in tw.standbys():
            sb.prewarm()
            assert sb.warm and not sb.active
        assert tw.t.sync_s is not None and tw.t.build_s is not None
        # The cluster moves while both idle.
        tw.each("create_bulk", "pods", [pod_wire(f"p{i}", tw.rng) for i in range(N_PENDING)],
                namespace="default")
        for i in range(0, 10, 2):
            tw.each("delete", "pods", f"b{i}", namespace="default")
        tw.each("create", "nodes", node_wire("n-late-0", cpu=32))
        tw.each("create", "nodes", node_wire("n-late-1", cpu=2))
        # A pod bound to a node whose ADDED delta is not yet queued would
        # be dropped by the session in both packages (ROADMAP queue 3):
        # the binds wait for the nodes' deltas.
        assert wait_until(lambda: all(
            any(k == "node" and getattr(o, "metadata", None) and o.metadata.name == "n-late-1"
                for k, _e, o in list(sb.daemon._event_q)) for sb, _ in tw.standbys()))
        tw.each("bind_bulk", [("p1", "n3"), ("p4", "n5"), ("p9", "n-late-1")],
                namespace="default")
        assert wait_until(lambda: tw.settled() and (time.sleep(0.05) or tw.settled()))
        if raced:
            # Deltas that raced the build: the objects the caches hold
            # again, and the delete of a pod the session never held.
            for sb, _ in tw.standbys():
                d, cfg = sb.daemon, sb.config
                for node in cfg.nodes.store.list():
                    d._on_cluster_event("node", "MODIFIED", node)
                for pod in cfg.scheduled_pods.store.list():
                    d._on_cluster_event("pod", "ADDED", pod)
                d._on_cluster_event("pod", "DELETED",
                                    {"metadata": {"name": "never", "namespace": "default"}})
        time.sleep(0.3)
        assert bound_names(tw.setups[1]) == {f"b{i}" for i in range(10, N_BOUND)} | {
            f"b{i}" for i in range(1, 10, 2)} | {"p1", "p4", "p9"}, "a standby bound a pod"
        # The port's expected placements: a fresh solve of the queue, in
        # its drain order, on the cluster as LISTed now, the nodes in the
        # order the node cache holds them (a node added while warm sits
        # last, where the session slots it: ties go to the lower index).
        pending = copy.deepcopy(queued(tw.t.config))
        client = Client(LocalTransport(tw.apis[1]))
        pods, _ = client.list("pods", namespace="default")
        listed = {n.metadata.name: n for n in client.list("nodes")[0]}
        nodes = [listed[n.metadata.name] for n in tw.t.config.nodes.store.list()]
        assert len(nodes) == len(listed)
        services, _ = client.list("services", namespace="default")
        want = schedule_backlog(pending, nodes, [p for p in pods if p.spec.node_name], services,
                                device="cpu")
        assert all(want)
        for sb, _ in tw.standbys():
            assert sb.activate() is sb.daemon and sb.active
        names = [p.metadata.name for p in pending]
        for sb, api in tw.standbys():
            assert wait_until(lambda: all(bindings(api)[n] for n in names)), "backlog not bound"
        jb, tb = bindings(tw.apis[0]), bindings(tw.apis[1])
        assert tb == jb
        assert [tb[n] for n in names] == want
        time.sleep(0.1)
        (jrows, jpods), (trows, tpods) = mirror(tw.j.daemon), mirror(tw.t.daemon)
        assert tpods == jpods and trows.keys() == jrows.keys()
        for name, cols in jrows.items():
            for k, ref in cols.items():
                assert np.array_equal(trows[name][k], ref), f"{name}: h[{k!r}]"
        # Live deltas keep flowing after activation.
        tw.each("create", "pods", pod_wire("live"), namespace="default")
        for _, api in tw.standbys():
            assert wait_until(lambda: bindings(api)["live"])
        assert bindings(tw.apis[0])["live"] == bindings(tw.apis[1])["live"]
    finally:
        tw.stop()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_activate_is_idempotent_and_prewarms(pkg):
    api = APIServer()
    setup = JClient(JLocalTransport(api))
    setup.create("nodes", node_wire("n0", cpu=4))
    sb = (JStandby(JClient(JLocalTransport(api)), sync_timeout=30) if pkg == "jax"
          else WarmStandbyScheduler(Client(LocalTransport(api)), sync_timeout=30, daemon_factory=on_cpu))
    try:
        d1 = sb.activate()  # a cold activate prewarms first
        d2 = sb.activate()
        assert d1 is d2 and sb.warm and sb.active
        setup.create("pods", pod_wire("x"), namespace="default")
        assert wait_until(lambda: "x" in bound_names(setup))
    finally:
        sb.stop()
    assert not sb.warm and not sb.active


def test_kill_lets_the_session_go_and_stops_the_informers():
    api = APIServer()
    setup = JClient(JLocalTransport(api))
    setup.create("nodes", node_wire("n0", cpu=4))
    sb = WarmStandbyScheduler(Client(LocalTransport(api)), sync_timeout=30, daemon_factory=on_cpu)
    sb.activate()
    setup.create("pods", pod_wire("x"), namespace="default")
    assert wait_until(lambda: "x" in bound_names(setup))
    assert sb.daemon._session is not None
    sb.kill()
    assert not sb.active and not sb.warm
    assert sb.daemon._session is None and sb.daemon._inflight is None
    assert not sb.daemon._thread.is_alive()
    assert sb.config.pod_queue.pop(timeout=0) is None  # closed with the config
    # The killed daemon binds nothing more.
    setup.create("pods", pod_wire("y"), namespace="default")
    time.sleep(0.5)
    assert "y" not in bound_names(setup)


def test_a_failed_prewarm_stops_the_informers():
    api = APIServer()
    JClient(JLocalTransport(api)).create("nodes", node_wire("n0", cpu=4))

    def broken(_config):
        class Broken:
            def prewarm(self):
                raise RuntimeError("session build failed")

        return Broken()

    sb = WarmStandbyScheduler(Client(LocalTransport(api)), sync_timeout=30,
                              daemon_factory=broken)
    with pytest.raises(RuntimeError, match="session build failed"):
        sb.prewarm()
    assert not sb.warm
    refs = [getattr(r, "reflector", r) for r in sb.config._reflectors()]
    assert not any(r._thread is not None and r._thread.is_alive() for r in refs)


# -- HAScheduler over HTTP ----------------------------------------------------


def http_cluster():
    api = APIServer()
    srv = APIHTTPServer(api).start()

    def client():
        return Client(HTTPTransport(srv.address))

    c = JClient(JLocalTransport(api))
    for i in range(4):
        c.create("nodes", node_wire(f"n{i}", cpu=8))
    return srv, client, c


def replica(client_factory, name, **kw):
    return HAScheduler(
        client_factory(), name, lease_duration=2.0, renew_period=0.2, retry_period=0.2,
        standby_factory=kw.pop("standby_factory", None) or (
            lambda: WarmStandbyScheduler(client_factory(), sync_timeout=30, daemon_factory=on_cpu)),
        **kw,
    )


def test_failover_activates_the_warm_standby():
    srv, client_factory, c = http_cluster()
    ha = []
    try:
        ha = [replica(client_factory, n) for n in ("alpha", "beta")]
        for h in ha:
            h.start()
        assert wait_until(lambda: sum(h.is_leader for h in ha) == 1, timeout=60)
        leader = next(h for h in ha if h.is_leader)
        rival = next(h for h in ha if h is not leader)
        # The rival is warm while not leading; the leader's token is set
        # before its activation ends.
        assert wait_until(lambda: rival.standby is not None and rival.standby.warm)
        assert wait_until(lambda: leader.daemon is not None)
        assert rival.daemon is None
        assert rival.standby.daemon._session is not None
        first_token = leader.token
        c.create("pods", pod_wire("before"), namespace="default")
        assert wait_until(lambda: "before" in bound_names(c))
        # Crash the leader: renewals stop and its daemon dies, with no
        # release of the lease, which must expire.
        leader.elector._stop.set()
        leader.standby.kill()
        assert wait_until(lambda: rival.is_leader, timeout=30)
        assert rival.token > first_token
        pods, _ = c.list("pods", namespace="default")
        nodes, _ = c.list("nodes")
        want = schedule_backlog([Client._typed("pods", pod_wire("after"))],
                                nodes, [p for p in pods if p.spec.node_name], device="cpu")
        c.create("pods", pod_wire("after"), namespace="default")
        assert wait_until(lambda: "after" in bound_names(c), timeout=30)
        assert c.get("pods", "after", namespace="default").spec.node_name == want[0]
        # The crashed leader still believes; the store fences its token.
        assert rival.lease.validate(rival.token)
        assert not leader.lease.validate(first_token)
    finally:
        for h in ha:
            try:
                h.stop()
            except Exception:
                pass
        srv.stop()


def test_deposed_leader_rebuilds_a_warm_standby():
    srv, client_factory, c = http_cluster()
    ha = rival = None
    try:
        ha = replica(client_factory, "alpha").start()
        assert wait_until(lambda: ha.is_leader, timeout=60)
        first = ha.standby
        # alpha wedges: its renewals pause past the window.
        ha.elector._stop.set()
        ha.elector._thread.join(timeout=10)
        rival = replica(client_factory, "beta").start()
        assert wait_until(lambda: rival.is_leader, timeout=30)
        ha._deposed()  # the elector thread's path
        assert ha.token is None and not first.active
        assert first.daemon._session is None  # the killed session let go
        assert ha.standby is not None and ha.standby is not first and ha.standby.warm
        assert not ha.standby.active and ha.rebuild_failures == 0
    finally:
        for h in (ha, rival):
            if h is not None:
                try:
                    h.stop()
                except Exception:
                    pass
        srv.stop()


def test_a_failed_rebuild_is_counted_and_built_at_the_next_election():
    srv, client_factory, c = http_cluster()
    calls = []

    def factory():
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("no card")
        return WarmStandbyScheduler(client_factory(), sync_timeout=30, daemon_factory=on_cpu)

    ha = replica(client_factory, "alpha", standby_factory=factory)
    try:
        ha.start()
        assert wait_until(lambda: ha.is_leader, timeout=60)
        ha.elector._stop.set()
        ha.elector._thread.join(timeout=10)
        ha._deposed()
        assert ha.rebuild_failures == 1 and ha.standby is None
        ha._elected(ha.token or 7)  # the next election builds one
        assert ha.standby is not None and ha.standby.active and len(calls) == 3
        c.create("pods", pod_wire("z"), namespace="default")
        assert wait_until(lambda: "z" in bound_names(c), timeout=30)
    finally:
        ha.stop()
        srv.stop()


def test_a_replica_that_cannot_take_office_declines_the_lease():
    """alpha's standby cannot start its daemon, and a standby built at
    its next election cannot be built at all: each election is counted
    and declined, and beta takes the lease and binds."""
    srv, client_factory, c = http_cluster()
    calls = []

    def broken_daemon(config):
        daemon = on_cpu(config)

        def start():
            raise RuntimeError("launch failed")

        daemon.start = start
        return daemon

    def factory():
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("no card")
        return WarmStandbyScheduler(client_factory(), sync_timeout=30,
                                    daemon_factory=broken_daemon)

    alpha = replica(client_factory, "alpha", standby_factory=factory)
    beta = None
    try:
        alpha.start()
        assert wait_until(lambda: alpha.election_failures >= 2, timeout=30)
        assert len(calls) >= 2 and not alpha.is_leader and alpha.standby is None
        beta = replica(client_factory, "beta").start()
        assert wait_until(lambda: beta.is_leader and beta.daemon is not None, timeout=30)
        failures = alpha.election_failures
        for _ in range(10):
            assert not alpha.is_leader and not alpha.elector.is_leader
            time.sleep(0.1)
        c.create("pods", pod_wire("w"), namespace="default")
        assert wait_until(lambda: "w" in bound_names(c), timeout=30)
        assert beta.lease.validate(beta.token)
        assert alpha.election_failures == failures
    finally:
        for h in (alpha, beta):
            if h is not None:
                h.stop()
        srv.stop()
