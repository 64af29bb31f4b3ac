"""The port's autoscaler polls as the JAX autoscaler does.

Twin apiservers (the JAX package's `APIServer`) seeded alike; the JAX
`Autoscaler` (with a JAX `Descheduler`) drives one, the port's (with the
port's `Descheduler`, `device="cpu"`) the other, each over its own
package's client and a hollow node pool that creates and deletes Node
objects. Poll by poll the summaries must be equal, and after the polls
the pods, the nodes and the pool sizes. Grow, shrink by cordon and
drain, holding steady, and growth on the zero-headroom counter that a
capacity sample burns.
"""

import copy

import pytest
import torch

from kubernetes_tpu.client import Client as JClient
from kubernetes_tpu.client import LocalTransport as JLocalTransport
from kubernetes_tpu.controllers import autoscaler as jautoscaler
from kubernetes_tpu.controllers.descheduler import Descheduler as JDescheduler
from kubernetes_tpu.server.api import APIServer
from kubernetes_tpu.utils import capacity as jcapmod
from kubernetes_tpu.utils import rebalance as jrebmod
from kubernetes_tpu_torch.client.rest import Client, LocalTransport
from kubernetes_tpu_torch.controllers import autoscaler
from kubernetes_tpu_torch.controllers.descheduler import Descheduler
from kubernetes_tpu_torch.utils import capacity as capmod
from kubernetes_tpu_torch.utils import rebalance as rebmod
from tests.test_torch_descheduler import _norm, move_counters_kept, node_wire, pod_wire  # noqa: F401 (autouse)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_monitors(monkeypatch):
    monkeypatch.setattr(jrebmod, "DEFAULT", jrebmod.RebalanceMonitor())
    monkeypatch.setattr(jcapmod, "DEFAULT", jcapmod.CapacityMonitor())
    monkeypatch.setattr(rebmod, "DEFAULT", rebmod.RebalanceMonitor())
    monkeypatch.setattr(capmod, "DEFAULT", capmod.CapacityMonitor())


class Pool:
    """Hollow nodes n0..n{k-1}: grow creates the next, shrink deletes."""

    def __init__(self, client, name, start):
        self.client, self.name = client, name
        self.n = self.next = start
        self.shrunk = []

    def size(self):
        return self.n

    def node_names(self):
        return [f"n{j}" for j in range(self.next)]

    def grow(self, k):
        added = []
        for _ in range(k):
            name = f"n{self.next}"
            self.client.create("nodes", node_wire(name))
            added.append(name)
            self.next += 1
            self.n += 1
        return added

    def shrink(self, name):
        self.client.delete("nodes", name)
        self.shrunk.append(name)
        self.n -= 1


class Twin:
    def __init__(self, n_nodes, **kw):
        self.apis = [APIServer(), APIServer()]
        self.setups = [JClient(JLocalTransport(a)) for a in self.apis]
        for c in self.setups:
            for j in range(n_nodes):
                c.create("nodes", node_wire(f"n{j}"))
        jc, tc = self.setups[0], Client(LocalTransport(self.apis[1]))
        self.pools = [Pool(jc, "jax", n_nodes), Pool(tc, "port", n_nodes)]
        kw.setdefault("grow_after", 2)
        kw.setdefault("shrink_after", 2)
        self.j = jautoscaler.Autoscaler(jc, self.pools[0],
                                        descheduler=JDescheduler(jc, grace_period_seconds=0), **kw)
        self.t = autoscaler.Autoscaler(
            tc, self.pools[1], descheduler=Descheduler(tc, grace_period_seconds=0, device="cpu"),
            **kw)

    def each(self, verb, *args, **kw):
        return [getattr(c, verb)(*args, **kw) for c in self.setups]

    def bound(self, name, node, **kw):
        self.each("create", "pods", pod_wire(name, **kw))
        self.each("bind_bulk", [(name, node)])

    def poll(self):
        js, ts = self.j.sync_once(), self.t.sync_once()
        assert {**ts, "pool": "jax"} == js
        return ts

    def assert_same(self):
        lists = []
        for api in self.apis:
            lists.append(({p["metadata"]["name"]: _norm(p) for p in api.list("pods", "")["items"]},
                          {n["metadata"]["name"]: _norm(n) for n in api.list("nodes", "")["items"]}))
        assert lists[1] == lists[0]
        assert self.pools[1].size() == self.pools[0].size()
        assert self.pools[1].shrunk == self.pools[0].shrunk
        assert (autoscaler.POOL_SIZE.value(pool="port")
                == jautoscaler.POOL_SIZE.value(pool="jax") == self.pools[1].size())
        return lists[1]


def _events():
    return ({d: autoscaler.SCALE_EVENTS.value(direction=d) for d in ("up", "down")},
            {d: jautoscaler.SCALE_EVENTS.value(direction=d) for d in ("up", "down")})


def _deltas(before):
    after = _events()
    return [{d: a[d] - b[d] for d in a} for a, b in zip(after, before)]


def test_grows_on_a_sustained_backlog_as_jax():
    twin = Twin(2, max_size=3)
    twin.bound("f0", "n0", cpu="600m")
    twin.bound("f1", "n1", cpu="600m")
    twin.each("create", "pods", pod_wire("starving", cpu="600m"))
    before = _events()
    actions = [twin.poll()["action"] for _ in range(3)]
    assert "grow" in actions
    # At max_size the pool holds under starvation.
    for _ in range(4):
        assert twin.poll()["size"] == 3
    twin.assert_same()
    port, jax = _deltas(before)
    assert port == jax == {"up": 1, "down": 0}


def test_shrinks_by_cordon_and_drain_as_jax():
    twin = Twin(3, min_size=2)
    for name, node in (("k0", "n0"), ("k1", "n0"), ("k2", "n1"), ("k3", "n1"), ("mv", "n2")):
        twin.bound(name, node, cpu="100m")
    before = _events()
    actions = [twin.poll()["action"] for _ in range(3)]
    assert actions == ["none", "drain", "shrink"]
    pods, nodes = twin.assert_same()
    assert twin.pools[1].shrunk == ["n2"]
    assert "n2" not in nodes and twin.pools[1].size() == 2
    dest = pods["mv"]["metadata"]["annotations"]["rebalance.kubernetes-tpu.io/destination"]
    assert dest in ("n0", "n1") and not pods["mv"]["spec"].get("nodeName")
    assert _deltas(before)[0] == _deltas(before)[1] == {"up": 0, "down": 1}
    # The moved pod pends (no scheduler here): both pools grow back.
    assert [twin.poll()["action"] for _ in range(2)] == ["grow", "none"]
    twin.assert_same()


def test_holds_steady_under_mixed_load_as_jax():
    twin = Twin(2, low_util=0.2)
    twin.bound("busy", "n0", cpu="900m")
    for _ in range(5):
        assert twin.poll()["action"] == "none"
    twin.assert_same()


def test_grows_on_the_zero_headroom_counter_as_jax():
    """No pod pends, but each poll follows a capacity sample taken with
    a backlog and a probe without headroom: the counter rises and both
    pools grow."""
    twin = Twin(2)
    twin.bound("f0", "n0", cpu="900m")
    twin.bound("f1", "n1", cpu="900m")
    probes = [("big", 500.0, 256.0, 1)]
    jcapmod.DEFAULT.configure(probes)
    capmod.DEFAULT.configure(probes)
    jc, tc = twin.setups[0], Client(LocalTransport(twin.apis[1]))
    actions = []
    for _ in range(4):
        jcols, jnames = jcapmod.cluster_columns(jc.list("nodes")[0], jc.list("pods")[0])
        tcols, tnames = capmod.cluster_columns(tc.list("nodes")[0], tc.list("pods")[0])
        jbody = jcapmod.DEFAULT.sample(jcols, jnames, backlog_depth=3, oldest_age_s=1.0)
        tbody = capmod.DEFAULT.sample(copy.deepcopy(tcols), tnames, backlog_depth=3,
                                      oldest_age_s=1.0, device="cpu")
        assert tbody == jbody
        actions.append(twin.poll()["action"])
    assert actions.count("grow") >= 1
    twin.assert_same()


def test_the_default_descheduler_takes_the_autoscaler_s_device():
    api = APIServer()
    client = Client(LocalTransport(api))
    a = autoscaler.Autoscaler(client, Pool(client, "p", 0), device="cpu")
    assert str(a.descheduler.device) == "cpu"
