"""The port's replicated store and apiserver against the JAX package's.

A twin of `tests/test_replication.py`: each sequence runs once on the
JAX package (`kubernetes_tpu.store.replication` under its `APIServer`
and client) and once on the port's, with uids and timestamps patched
alike in both, and their statuses, versions, commit indexes and the
stores' WAL bytes must be equal.

- WAL shipping: quorum ack and convergence of two followers, a cluster
  of one, one dead follower among two, a lost quorum through a link
  that can be partitioned.
- Promotion: the promoted follower's WAL is the committed prefix of the
  leader's byte for byte, a write that never reached quorum is not
  exposed, a promoted follower refuses a stale leader.
- The HTTP plane: a write through a follower is forwarded to the
  leader and read back from the follower's own cache, one trace id
  across the hop, the `/healthz` replication subcheck and
  `/replication/status`, the rotating client and the Reflector's resumed
  watch.
- Mixed clusters over `HTTPLink`: a JAX leader ships to a port follower
  and a port leader to a JAX follower (the wire format and the WAL
  lines are the same); the follower converges and, once promoted,
  serves the committed prefix.
"""

import itertools
import json
import time
import types
import urllib.request

import pytest

from kubernetes_tpu.client import rest as jax_rest
from kubernetes_tpu.client.cache import Reflector as JaxReflector
from kubernetes_tpu.client.cache import ThreadSafeStore as JaxStore
from kubernetes_tpu.models import objects as jax_objects
from kubernetes_tpu.server import api as jax_api
from kubernetes_tpu.server import httpserver as jax_http
from kubernetes_tpu.store import kvstore as jax_kv
from kubernetes_tpu.store import replication as jax_repl
from kubernetes_tpu.utils import debug as jax_debug

from kubernetes_tpu_torch.client import rest as port_rest
from kubernetes_tpu_torch.client.cache import Reflector as PortReflector
from kubernetes_tpu_torch.client.cache import ThreadSafeStore as PortStore
from kubernetes_tpu_torch.models import objects as port_objects
from kubernetes_tpu_torch.server import api as port_api
from kubernetes_tpu_torch.server import httpserver as port_http
from kubernetes_tpu_torch.store import kvstore as port_kv
from kubernetes_tpu_torch.store import replication as port_repl
from kubernetes_tpu_torch.utils import debug as port_debug

STAMP = "2026-01-01T00:00:00Z"


def _pkg(name, api, http, kv, repl, rest, objs, reflector, store, debug):
    return types.SimpleNamespace(
        name=name, APIServer=api.APIServer, APIHTTPServer=http.APIHTTPServer,
        KVStore=kv.KVStore, Hub=repl.ReplicationHub, Follower=repl.FollowerReplica,
        LocalLink=repl.LocalLink, HTTPLink=repl.HTTPLink,
        ReplicationError=repl.ReplicationError, Client=rest.Client,
        LocalTransport=rest.LocalTransport, HTTPTransport=rest.HTTPTransport,
        APIError=(api.APIError, rest.APIError) if name == "port" else api.APIError,
        api_mod=api, obj_mod=objs, Reflector=reflector, Store=store, debug=debug)


JAX = _pkg("jax", jax_api, jax_http, jax_kv, jax_repl, jax_rest, jax_objects,
           JaxReflector, JaxStore, jax_debug)
PORT = _pkg("port", port_api, port_http, port_kv, port_repl, port_rest, port_objects,
            PortReflector, PortStore, port_debug)
BOTH = (JAX, PORT)


@pytest.fixture(autouse=True)
def same_uids_and_stamps(monkeypatch):
    """uids from a counter a package restarted for each test, the same
    fixed stamp in both, so the stores' records and WAL lines compare
    byte for byte."""
    for pkg in BOTH:
        counter = itertools.count(1)

        def uid(c=counter):
            return f"00000000-0000-4000-8000-{next(c):012d}"

        for mod in (pkg.api_mod, pkg.obj_mod):
            monkeypatch.setattr(mod, "new_uid", uid)
            monkeypatch.setattr(mod, "now_iso", lambda: STAMP)


@pytest.fixture(autouse=True)
def replication_series_kept():
    """Both packages' replication gauges as they were before each test
    (other files read the port's in their process)."""
    gauges = [m.COMMIT_INDEX for m in (jax_repl, port_repl)] + [
        m.FOLLOWER_LAG for m in (jax_repl, port_repl)]
    saved = [g.snapshot() for g in gauges]
    yield
    for g, values in zip(gauges, saved):
        with g._lock:
            g._values.clear()
            g._values.update(values)


def wait_until(cond, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def pod_wire(name, ns="default"):
    return {"kind": "Pod", "apiVersion": "v1", "metadata": {"name": name, "namespace": ns},
            "spec": {"containers": [{"name": "c", "image": "nginx"}]}}


def partitionable(pkg):
    """A LocalLink of `pkg` with a partition switch: the shipper sees a
    dead link, the follower stops receiving."""

    class PartitionableLink(pkg.LocalLink):
        def __init__(self, replica, name="follower"):
            super().__init__(replica, name)
            self.partitioned = False

        def append(self, lines, commit):
            if self.partitioned:
                raise ConnectionError(f"{self.name}: partitioned")
            return super().append(lines, commit)

    return PartitionableLink


def wal_bytes(store):
    with open(store._wal_path, "rb") as f:
        return f.read()


def steady(status):
    """A status without its liveness flags (a shipper's retry timing)."""
    out = dict(status)
    out["followers"] = [{k: v for k, v in f.items() if k != "alive"}
                        for f in status.get("followers", [])]
    return out


# -- WAL shipping --------------------------------------------------------


def quorum_and_convergence(pkg, tmp):
    leader = pkg.KVStore(data_dir=str(tmp / "leader"), snapshot_every=10**9)
    hub = pkg.Hub(leader).attach()
    api = pkg.APIServer(store=leader)
    api.replication = hub
    fs = [pkg.Follower(store=pkg.KVStore(data_dir=str(tmp / n), snapshot_every=10**9), name=n)
          for n in ("f1", "f2")]
    for f in fs:
        hub.add_follower(pkg.LocalLink(f, f.name))
    c = pkg.Client(pkg.LocalTransport(api))
    for i in range(20):
        c.create("pods", pod_wire(f"p{i}"))  # acks only at quorum
    assert hub.commit_index == leader.version
    assert wait_until(lambda: all(f.store.journaled_version == leader.version for f in fs))
    assert wait_until(lambda: all(f.store.version == leader.version for f in fs))
    assert wait_until(lambda: all(f["commitKnown"] == leader.version
                                  for f in hub.status()["followers"]))
    st = hub.status()
    assert st["role"] == "leader" and all(f["alive"] for f in st["followers"])
    out = {"hub": steady(st), "followers": [f.status() for f in fs],
           "commit": [hub.commit_index] + [f.commit_index for f in fs],
           "wal": [wal_bytes(leader)] + [wal_bytes(f.store) for f in fs]}
    hub.stop()
    return out


def test_quorum_ack_and_follower_convergence_match_jax(tmp_path):
    got = {pkg.name: quorum_and_convergence(pkg, tmp_path / pkg.name) for pkg in BOTH}
    assert got["port"] == got["jax"]
    # Each follower's WAL is the leader's since the join (the default
    # namespace came in the bootstrap), line for line.
    wal = got["port"]["wal"]
    assert wal[1] == wal[2] and wal[1] and wal[0].endswith(wal[1])


def single_node(pkg):
    leader = pkg.KVStore()
    hub = pkg.Hub(leader).attach()
    c = pkg.Client(pkg.LocalTransport(pkg.APIServer(store=leader)))
    c.create("pods", pod_wire("solo"))
    got = c.get("pods", "solo", namespace="default")
    return {"name": got.metadata.name, "status": hub.status(), "commit": hub.commit_index}


def test_single_node_cluster_acks_alone_as_jax():
    """No followers: the local fsync is the quorum (a majority of one)."""
    assert single_node(PORT) == single_node(JAX)


def one_dead_follower(pkg):
    leader = pkg.KVStore()
    hub = pkg.Hub(leader, ack_timeout_s=5.0).attach()
    api = pkg.APIServer(store=leader)
    f1, f2 = pkg.Follower(name="f1"), pkg.Follower(name="f2")
    l1 = partitionable(pkg)(f1, "f1")
    hub.add_follower(l1)
    hub.add_follower(pkg.LocalLink(f2, "f2"))
    l1.partitioned = True
    c = pkg.Client(pkg.LocalTransport(api))
    for i in range(5):
        c.create("pods", pod_wire(f"p{i}"))
    committed = (hub.commit_index, leader.version)
    lagging = f1.store.version
    l1.partitioned = False  # heal: the lagging follower catches up
    assert wait_until(lambda: f1.store.version == leader.version)
    assert wait_until(lambda: all(f["acked"] == leader.version
                                  for f in hub.status()["followers"]))
    out = {"committed": committed, "lagging": lagging, "healed": steady(hub.status()),
           "f1": f1.status()}
    hub.stop()
    return out


def test_one_dead_follower_does_not_block_acks_as_jax():
    """Leader and two followers: a majority is 2, so one partitioned
    follower lags alone while writes keep acking."""
    got, want = one_dead_follower(PORT), one_dead_follower(JAX)
    assert got == want
    assert got["committed"][0] == got["committed"][1]


def lost_quorum(pkg):
    leader = pkg.KVStore()
    hub = pkg.Hub(leader, ack_timeout_s=0.4).attach()
    api = pkg.APIServer(store=leader)
    f1 = pkg.Follower(name="f1")
    link = partitionable(pkg)(f1, "f1")
    hub.add_follower(link)
    link.partitioned = True
    c = pkg.Client(pkg.LocalTransport(api))
    with pytest.raises(pkg.ReplicationError) as err:
        c.create("pods", pod_wire("unacked"))
    out = {"journaled": leader.version, "commit": hub.commit_index, "f1": f1.status(),
           "error": str(err.value)}
    hub.stop()
    return out


def test_lost_quorum_refuses_to_ack_as_jax():
    """Leader and one follower, the follower partitioned: the write
    journals on the leader but its ack times out."""
    got = lost_quorum(PORT)
    assert got == lost_quorum(JAX)
    assert got["journaled"] > got["commit"]


# -- promotion -----------------------------------------------------------


def promoted_prefix(pkg, tmp, unacked):
    """30 acked pods (10 when `unacked`, then one write that never reaches
    quorum), the leader crashes, f1 is promoted."""
    leader = pkg.KVStore(data_dir=str(tmp / "leader"), snapshot_every=10**9)
    hub = pkg.Hub(leader, ack_timeout_s=0.4 if unacked else 5.0).attach()
    f1 = pkg.Follower(store=pkg.KVStore(data_dir=str(tmp / "f1"), snapshot_every=10**9),
                      name="f1")
    link = partitionable(pkg)(f1, "f1")
    hub.add_follower(link)
    c = pkg.Client(pkg.LocalTransport(pkg.APIServer(store=leader)))
    for i in range(10 if unacked else 30):
        c.create("pods", pod_wire(f"p{i}"))
    acked = leader.version
    assert wait_until(lambda: f1.store.journaled_version == acked)
    if unacked:
        link.partitioned = True
        with pytest.raises(pkg.ReplicationError):
            c.create("pods", pod_wire("torn"))
        assert leader.version > acked
    leader_wal = wal_bytes(leader)
    leader.crash()
    promoted = f1.promote()
    follower_wal = wal_bytes(promoted)
    assert follower_wal == leader_wal[:len(follower_wal)]
    assert promoted.version == acked
    nc = pkg.Client(pkg.LocalTransport(pkg.APIServer(store=promoted)))
    names = sorted(p.metadata.name for p in nc.list("pods", namespace="default")[0])
    if unacked:
        assert len(follower_wal) < len(leader_wal)
        with pytest.raises(pkg.APIError):
            nc.get("pods", "torn", namespace="default")
    nc.create("pods", pod_wire("after-failover"))
    assert nc.get("pods", "after-failover", namespace="default")
    hub.stop()
    return {"leader_wal": leader_wal, "follower_wal": follower_wal, "names": names,
            "status": f1.status(), "version": promoted.version}


@pytest.mark.parametrize("unacked", [False, True], ids=["committed_prefix", "unacked_write"])
def test_promotion_exposes_exactly_the_committed_prefix_as_jax(tmp_path, unacked):
    got = promoted_prefix(PORT, tmp_path / "port", unacked)
    want = promoted_prefix(JAX, tmp_path / "jax", unacked)
    assert got == want
    assert "torn" not in got["names"]


def test_promoted_follower_rejects_stale_leader_as_jax():
    out = {}
    for pkg in BOTH:
        f1 = pkg.Follower(name="f1")
        f1.promote()
        with pytest.raises(pkg.ReplicationError) as err:
            f1.append([], 5)
        out[pkg.name] = (str(err.value), f1.status())
    assert out["port"] == out["jax"]
    assert out["port"][1]["role"] == "leader"


# -- the HTTP plane ------------------------------------------------------


class Cluster:
    """A leader apiserver and two follower apiservers of one package
    over HTTP (the followers' links are HTTPLinks)."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.store = pkg.KVStore()
        self.api = pkg.APIServer(store=self.store)
        self.http = pkg.APIHTTPServer(self.api).start()
        self.hub = pkg.Hub(self.store).attach()
        self.api.replication = self.hub
        self.followers = []
        for name in ("f1", "f2"):
            rep = pkg.Follower(name=name)
            api = pkg.APIServer(store=rep.store)
            api.replication = rep
            api.leader_url = self.http.address
            http = pkg.APIHTTPServer(api).start()
            self.hub.add_follower(pkg.HTTPLink(http.address, name=name))
            self.followers.append((rep, api, http))

    def close(self):
        self.hub.stop()
        self.http.stop()
        for _, _, http in self.followers:
            http.stop()


@pytest.fixture
def clusters():
    made = []

    def make(pkg):
        made.append(Cluster(pkg))
        return made[-1]

    yield make
    for c in made:
        c.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, json.loads(resp.read())


def forwarded_and_fanout(cl):
    pkg = cl.pkg
    c = pkg.Client(pkg.HTTPTransport(cl.followers[0][2].address))
    created = c.create("pods", pod_wire("fwd"))
    assert wait_until(lambda: any(p.metadata.name == "fwd"
                                  for p in c.list("pods", namespace="default")[0]))
    lc = pkg.Client(pkg.HTTPTransport(cl.http.address))
    lc.create("pods", pod_wire("direct"))
    assert wait_until(lambda: any(p.metadata.name == "direct"
                                  for p in c.list("pods", namespace="default")[0]))
    assert wait_until(lambda: all(rep.store.version == cl.store.version
                                  for rep, _, _ in cl.followers))
    raw = {}
    for name, url in (("leader", cl.http.address), ("f1", cl.followers[0][2].address),
                      ("f2", cl.followers[1][2].address)):
        status, body = _get(url + "/api/v1/namespaces/default/pods")
        raw[name] = (status, body)
    return {"created": created.metadata.resource_version, "lists": raw}


def test_forwarded_write_and_fanout_read_match_jax(clusters):
    """A write through a follower is forwarded to the leader, acked at
    quorum and read back from the follower's own watch cache; a write to
    the leader reaches both followers. Every replica's LIST is equal,
    and equal to the JAX cluster's."""
    got = forwarded_and_fanout(clusters(PORT))
    want = forwarded_and_fanout(clusters(JAX))
    assert got == want
    lists = got["lists"]
    assert lists["leader"] == lists["f1"] == lists["f2"]


def test_forwarded_write_shares_one_trace_id(clusters):
    """The follower's request-log entry and the leader's carry one trace
    id: minted on the follower when the client sent none, the client's
    own when it sent one."""
    cl = clusters(PORT)
    f1 = cl.followers[0][2].address
    port_rest.Client(port_rest.HTTPTransport(f1)).create("pods", pod_wire("traced"))
    posts = [e for e in list(port_debug.DEFAULT_REQUEST_LOG._ring)
             if e[1] == "POST" and e[2].endswith("/pods")]
    assert len(posts) >= 2
    tids = {e[5] for e in posts[-2:]}
    assert len(tids) == 1 and tids.pop(), posts[-2:]
    req = urllib.request.Request(
        f1 + "/api/v1/namespaces/default/pods", data=json.dumps(pod_wire("traced2")).encode(),
        headers={"Content-Type": "application/json", "X-Trace-Id": "trace-fwd-port"},
        method="POST")
    urllib.request.urlopen(req, timeout=10).read()
    stamped = [e for e in list(port_debug.DEFAULT_REQUEST_LOG._ring)
               if e[5] == "trace-fwd-port"]
    assert len(stamped) == 2  # the follower's hop and the leader's


def health_views(cl):
    leader = cl.http.address
    f1 = cl.followers[0][2].address
    assert wait_until(lambda: all(f["commitKnown"] == cl.store.version
                                  for f in cl.hub.status()["followers"]))
    out = {"leader": _get(leader + "/healthz")[1]["checks"]["replication"],
           "f1": _get(f1 + "/healthz")[1]["checks"]["replication"],
           "status": _get(f1 + "/replication/status"),
           "leader_status": steady(_get(leader + "/replication/status")[1])}
    with urllib.request.urlopen(leader + "/debug/health", timeout=10) as resp:
        out["rollup"] = json.loads(resp.read())["components"]["replication"]
    bad = urllib.request.Request(leader + "/replication/append", data=b"{}", method="POST")
    try:
        urllib.request.urlopen(bad, timeout=10)
        out["append_to_leader"] = 200
    except urllib.error.HTTPError as e:
        out["append_to_leader"] = (e.code, json.loads(e.read()))
    return out


def test_healthz_replication_subcheck_and_status_match_jax(clusters):
    got = health_views(clusters(PORT))
    want = health_views(clusters(JAX))
    assert got == want
    assert got["leader"]["status"] == "ok" and got["leader"]["role"] == "leader"
    assert set(got["leader"]["followerLag"]) == {"f1", "f2"}
    assert got["f1"]["role"] == "follower" and "journaled" in got["status"][1]
    assert got["append_to_leader"][0] == 409  # the leader fronts no follower


def test_follower_forward_to_a_dead_leader_fails_fast():
    """A follower whose leader is gone answers a forwarded write at once
    with 502 (the client may rotate), never hangs."""
    pkg = PORT
    cl = Cluster(pkg)
    f1 = cl.followers[0][2].address
    cl.hub.stop()
    cl.http.stop()
    try:
        c = pkg.Client(pkg.HTTPTransport(f1))
        t0 = time.monotonic()
        with pytest.raises(port_rest.APIError) as err:
            c.create("pods", pod_wire("orphan"))
        assert err.value.code == 502 and time.monotonic() - t0 < 5.0
    finally:
        for _, _, http in cl.followers:
            http.stop()


def test_client_rotates_on_dead_endpoint_as_jax():
    """Two apiservers over one store; stopping the one the client is
    pinned to rotates its reads to the other inside the retry loop."""
    from urllib.parse import urlparse

    for pkg in BOTH:
        api = pkg.APIServer(store=pkg.KVStore())
        s1, s2 = pkg.APIHTTPServer(api).start(), pkg.APIHTTPServer(api).start()
        try:
            t = pkg.HTTPTransport([s1.address, s2.address])
            c = pkg.Client(t)
            c.create("pods", pod_wire("p0"))
            u1, u2 = urlparse(s1.address), urlparse(s2.address)
            assert (t.host, t.port) == (u1.hostname, u1.port)
            s1.stop(release_store=False)
            assert c.get("pods", "p0", namespace="default").metadata.name == "p0"
            assert (t.host, t.port) == (u2.hostname, u2.port)
        finally:
            for s in (s1, s2):
                try:
                    s.stop()
                except Exception:
                    pass
        assert pkg.HTTPTransport("http://127.0.0.1:1").endpoints == [("127.0.0.1", 1)]
        with pytest.raises(ValueError):
            pkg.HTTPTransport([])


def test_reflector_resumes_its_watch_after_rotation_as_jax():
    """A Reflector whose endpoint dies mid-watch rotates and resumes from
    its last resourceVersion: one LIST, and later events still arrive."""
    for pkg in BOTH:
        api = pkg.APIServer(store=pkg.KVStore())
        s1, s2 = pkg.APIHTTPServer(api).start(), pkg.APIHTTPServer(api).start()
        refl = None
        try:
            c = pkg.Client(pkg.HTTPTransport([s1.address, s2.address]))
            c.create("pods", pod_wire("pre"))
            cache = pkg.Store()
            refl = pkg.Reflector(c, "pods", cache, namespace="default").start()
            assert refl.wait_for_sync(10) and refl.list_count == 1
            s1.stop(release_store=False)
            pkg.Client(pkg.HTTPTransport(s2.address)).create("pods", pod_wire("post"))
            assert wait_until(lambda: cache.get("default/post") is not None), pkg.name
            assert refl.list_count == 1, pkg.name
        finally:
            if refl is not None:
                refl.stop()
            for s in (s1, s2):
                try:
                    s.stop()
                except Exception:
                    pass


# -- mixed clusters ------------------------------------------------------


@pytest.mark.parametrize("leader_pkg,follower_pkg", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_leader_port_follower", "port_leader_jax_follower"])
def test_mixed_cluster_converges_and_promotes(tmp_path, leader_pkg, follower_pkg):
    """One package's leader ships over HTTPLink to the other's follower
    apiserver: a late joiner bootstraps, writes through the follower are
    forwarded, the follower's WAL suffix equals the leader's lines, and
    the promoted follower serves every acked write and takes new ones."""
    leader = leader_pkg.KVStore(data_dir=str(tmp_path / "leader"), snapshot_every=10**9)
    lapi = leader_pkg.APIServer(store=leader)
    lhttp = leader_pkg.APIHTTPServer(lapi).start()
    hub = leader_pkg.Hub(leader).attach()
    lapi.replication = hub
    lc = leader_pkg.Client(leader_pkg.LocalTransport(lapi))
    lc.create("pods", pod_wire("before-join"))  # shipped by the bootstrap
    rep = follower_pkg.Follower(
        store=follower_pkg.KVStore(data_dir=str(tmp_path / "f1"), snapshot_every=10**9),
        name="f1")
    fapi = follower_pkg.APIServer(store=rep.store)
    fapi.replication = rep
    fapi.leader_url = lhttp.address
    fhttp = follower_pkg.APIHTTPServer(fapi).start()
    try:
        joined_at = leader.version
        hub.add_follower(leader_pkg.HTTPLink(fhttp.address, name="f1"))
        fc = follower_pkg.Client(follower_pkg.HTTPTransport(fhttp.address))
        for i in range(8):
            lc.create("pods", pod_wire(f"l{i}"))
            fc.create("pods", pod_wire(f"f{i}"))  # forwarded to the leader
        acked = leader.version
        assert hub.commit_index == acked
        assert wait_until(lambda: rep.store.version == acked)
        leader_names = sorted(p.metadata.name for p in lc.list("pods", namespace="default")[0])
        assert sorted(p.metadata.name for p in fc.list("pods", namespace="default")[0]) == \
            leader_names
        # The lines shipped after the join are the leader's WAL lines.
        lwal = wal_bytes(leader).splitlines(keepends=True)
        suffix = [ln for ln in lwal if json.loads(ln)["v"] > joined_at]
        assert wal_bytes(rep.store).splitlines(keepends=True)[-len(suffix):] == suffix
        hub.stop()
        lhttp.stop()
        leader.crash()
        promoted = rep.promote()
        fapi.leader_url = ""
        fapi.replication = None
        assert promoted.version == acked
        after = follower_pkg.Client(follower_pkg.HTTPTransport(fhttp.address))
        assert sorted(p.metadata.name for p in after.list("pods", namespace="default")[0]) == \
            leader_names
        after.create("pods", pod_wire("after-failover"))
        assert promoted.version == acked + 1
    finally:
        hub.stop()
        fhttp.stop()
        try:
            lhttp.stop()
        except Exception:
            pass
