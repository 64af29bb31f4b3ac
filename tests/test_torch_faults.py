"""The port's fault registry (`kubernetes_tpu_torch/utils/faults.py`) and
its 15 seams, against the JAX package's.

Twins of `tests/test_chaos.py`'s TestRegistry, TestKVStoreSites,
TestWatchResilience, TestHTTPRetries and TestKubeletSites on the port's
store, apiserver, client and kubelet, and beside them:

- one spec and seed fire every one of the 15 sites at the same call
  indices in both packages, over 1,000 calls a site;
- the spec grammar's errors are JAX's, word for word;
- a WAL torn by either package's seam recovers in the other's store;
- the lease sites (twins of `tests/test_lease.py`'s fault cases), the
  sampler's skipped beat, the descheduler's mid-move crash (the twin of
  `tests/test_rebalance.py`'s), and the daemon's eviction and commit
  seams driven through the twin daemons of `tests/test_torch_daemon.py`
  with the same rule armed in both registries.
"""

import queue
import threading
import time

import numpy as np
import pytest

from kubernetes_tpu.store import kvstore as jax_kv
from kubernetes_tpu.utils import faults as jax_faults
from kubernetes_tpu_torch.client.cache import Reflector, ThreadSafeStore
from kubernetes_tpu_torch.client.rest import APIError, Client, HTTPTransport, LocalTransport
from kubernetes_tpu_torch.server.api import APIServer
from kubernetes_tpu_torch.server.httpserver import APIHTTPServer
from kubernetes_tpu_torch.store.kvstore import KVStore
from kubernetes_tpu_torch.utils import faults
from tests.test_torch_daemon import (  # noqa: F401 (the twin daemons' fixtures)
    _one_torch_thread,
    fresh_capacity_monitors,
)

PACKAGES = (jax_faults, faults)


@pytest.fixture(autouse=True)
def _disarm():
    """Every test starts and ends with both registries disarmed."""
    for mod in PACKAGES:
        mod.clear()
        mod.reset_stats(reseed=0)
    yield
    for mod in PACKAGES:
        mod.clear()


def wait_until(cond, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def pod_wire(name):
    return {"kind": "Pod", "metadata": {"name": name, "namespace": "default"},
            "spec": {"containers": [{"name": "c", "image": "x"}]}}


# ---------------------------------------------------------------------------
# registry mechanics, on both modules
# ---------------------------------------------------------------------------


@pytest.fixture(params=["jax", "port"])
def reg(request):
    return jax_faults if request.param == "jax" else faults


class TestRegistry:
    def test_disabled_is_inert(self, reg):
        assert not reg.enabled()
        assert reg.fire(reg.WAL_FSYNC) is False
        assert reg.stats() == {}

    def test_per_site_determinism(self, reg):
        def run(interleave):
            reg.clear()
            reg.reset_stats(reseed=99)
            reg.inject(reg.WATCH_DROP, p=0.25, times=6)
            reg.inject(reg.HTTP_DELAY, p=0.5, delay_s=0.0)
            fired = []
            for i in range(60):
                if interleave:
                    reg.fire(reg.HTTP_DELAY)  # consumes ITS rng only
                if reg.fire(reg.WATCH_DROP):
                    fired.append(i)
            return fired

        a, b = run(False), run(True)
        assert a == b and len(a) == 6

    def test_budget_and_cadence_knobs(self, reg):
        rule = reg.inject(reg.WATCH_DROP, every=3, times=2, after=4)
        assert [i for i in range(1, 20) if reg.fire(reg.WATCH_DROP)] == [7, 10]
        assert rule.fired == 2

    def test_spec_roundtrip(self, reg):
        reg.configure("seed=5; kvstore.wal.fsync:every=10,times=2 ;"
                      "http.request.latency:p=0.5,delay=0.001")
        assert reg.enabled()
        by_site = {r["site"]: r for r in reg.rules()}
        assert by_site["kvstore.wal.fsync"]["every"] == 10
        assert by_site["http.request.latency"]["delay_s"] == 0.001
        reg.configure("")
        assert not reg.enabled()

    def test_stats_and_timeline(self, reg):
        reg.inject(reg.WATCH_DROP, every=2, times=2)
        for _ in range(5):
            reg.fire(reg.WATCH_DROP)
        assert reg.stats()[reg.WATCH_DROP.name] == {"calls": 5, "fired": 2}
        assert reg.timeline() == [(reg.WATCH_DROP.name, 2), (reg.WATCH_DROP.name, 4)]
        reg.reset_stats()
        assert reg.timeline() == []


def test_the_sites_are_jaxs():
    assert list(faults.SITES) == list(jax_faults.SITES)
    for name, site in faults.SITES.items():
        assert site.kind == jax_faults.SITES[name].kind, name


def test_error_kinds_raise_the_clients_classes():
    faults.inject(faults.WAL_FSYNC, every=1, times=1)
    with pytest.raises(faults.InjectedIOError):
        faults.fire(faults.WAL_FSYNC)
    assert isinstance(faults.InjectedIOError("x"), OSError)
    faults.clear()
    faults.inject(faults.HTTP_5XX, every=1, times=1)
    with pytest.raises(APIError) as ei:  # the client's class
        faults.fire(faults.HTTP_5XX)
    assert ei.value.code == 503 and ei.value.reason == "ServiceUnavailable"
    faults.clear()
    faults.inject(faults.HTTP_RESET, every=1, times=1)
    with pytest.raises(ConnectionResetError):
        faults.fire(faults.HTTP_RESET)


BAD_SPECS = [
    "no.such.site:p=1",
    "kvstore.wal.fsync:bogus=1",
    "kvstore.wal.fsync:times=2",
    "kvstore.wal.fsync:p=x",
    "seed=abc",
    "watch.stream.drop:every=1,delay",
]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_spec_errors_are_jaxs(spec):
    def error(mod):
        mod.clear()
        try:
            mod.configure(spec)
        except Exception as e:  # noqa: BLE001 - the class and text compared
            return type(e).__name__, str(e)
        return None

    want = error(jax_faults)
    assert want is not None and error(faults) == want


def test_inject_refuses_a_string_as_jax():
    for mod in PACKAGES:
        with pytest.raises(TypeError, match="KT008"):
            mod.inject("kvstore.wal.fsync", every=1)
        with pytest.raises(ValueError, match="ever fire"):
            mod.inject(mod.WAL_FSYNC)


def _firings(mod, spec, seed, calls=1000):
    mod.clear()
    mod.configure(spec, seed=seed)
    out = {}
    for name, site in mod.SITES.items():
        fired = []
        for i in range(1, calls + 1):
            try:
                if mod.fire(site, "x"):
                    fired.append(i)
            except Exception:  # error-kind sites raise their exception
                fired.append(i)
        out[name] = fired
    return out, mod.timeline(), mod.stats()


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_one_spec_fires_every_site_at_jaxs_indices(seed):
    rng = np.random.default_rng(seed)
    rules = []
    for name in jax_faults.SITES:
        if rng.random() < 0.5:
            knobs = f"p={round(float(rng.uniform(0.01, 0.3)), 3)}"
        else:
            knobs = f"every={int(rng.integers(2, 40))}"
        if rng.random() < 0.5:
            knobs += f",times={int(rng.integers(1, 30))}"
        if rng.random() < 0.3:
            knobs += f",after={int(rng.integers(1, 100))}"
        rules.append(f"{name}:{knobs},delay=0")
    spec = ";".join(rules)
    jax_out = _firings(jax_faults, spec, seed)
    port_out = _firings(faults, spec, seed)
    assert port_out == jax_out
    assert all(jax_out[0][name] for name in jax_faults.SITES)  # every site fired


# ---------------------------------------------------------------------------
# kvstore sites: torn write / fsync / snapshot rename + crash()
# ---------------------------------------------------------------------------


class TestKVStoreSites:
    def test_torn_write_is_unacked_and_truncated_on_replay(self, tmp_path):
        store = KVStore(data_dir=str(tmp_path))
        store.create("/registry/pods/default/a", pod_wire("a"))
        faults.inject(faults.WAL_TORN_WRITE, every=1, times=1)
        with pytest.raises(faults.FaultInjected):
            store.create("/registry/pods/default/b", pod_wire("b"))
        faults.clear()
        # The rollback: the dead store serves no object its WAL lost.
        with pytest.raises(Exception):
            store.get("/registry/pods/default/b")
        store.crash()
        recovered = KVStore(data_dir=str(tmp_path))
        try:
            objs, _ = recovered.list("/registry/pods/")
            assert [o["metadata"]["name"] for o in objs] == ["a"]
            recovered.create("/registry/pods/default/c", pod_wire("c"))
        finally:
            recovered.close()

    def test_torn_update_and_delete_roll_back(self, tmp_path):
        store = KVStore(data_dir=str(tmp_path))
        store.create("/registry/pods/default/a", pod_wire("a"))
        before = store.get("/registry/pods/default/a")
        faults.inject(faults.WAL_TORN_WRITE, every=1, times=1)
        changed = dict(before, spec={"containers": [{"name": "c", "image": "y"}]})
        with pytest.raises(faults.FaultInjected):
            store.atomic_update("/registry/pods/default/a", lambda cur: changed)
        assert store.get("/registry/pods/default/a") == before
        store.crash()
        store = KVStore(data_dir=str(tmp_path))
        faults.clear()
        faults.inject(faults.WAL_TORN_WRITE, every=1, times=1)
        with pytest.raises(faults.FaultInjected):
            store.delete("/registry/pods/default/a")
        assert store.get("/registry/pods/default/a")["metadata"]["name"] == "a"
        store.crash()
        recovered = KVStore(data_dir=str(tmp_path))
        try:
            assert recovered.get("/registry/pods/default/a") == before
        finally:
            recovered.close()

    def test_fsync_fault_refuses_the_ack_but_state_recovers(self, tmp_path):
        store = KVStore(data_dir=str(tmp_path))
        faults.inject(faults.WAL_FSYNC, every=1, times=1)
        with pytest.raises(faults.InjectedIOError):
            store.create("/registry/pods/default/x", pod_wire("x"))
        faults.clear()
        store.create("/registry/pods/default/y", pod_wire("y"))
        store.crash()
        recovered = KVStore(data_dir=str(tmp_path))
        try:
            objs, _ = recovered.list("/registry/pods/")
            assert {o["metadata"]["name"] for o in objs} == {"x", "y"}
        finally:
            recovered.close()

    def test_snapshot_rename_crash_keeps_previous_snapshot(self, tmp_path):
        store = KVStore(data_dir=str(tmp_path), snapshot_every=100000)
        for i in range(8):
            store.create(f"/registry/pods/default/p{i}", pod_wire(f"p{i}"))
        store.snapshot()
        store.create("/registry/pods/default/late", pod_wire("late"))
        faults.inject(faults.SNAPSHOT_RENAME, every=1, times=1)
        with pytest.raises(faults.InjectedIOError):
            store.snapshot()
        faults.clear()
        store.crash()
        recovered = KVStore(data_dir=str(tmp_path))
        try:
            objs, _ = recovered.list("/registry/pods/")
            assert len(objs) == 9
        finally:
            recovered.close()

    def test_crash_refuses_durability_acks_in_flight(self, tmp_path):
        store = KVStore(data_dir=str(tmp_path), serialized_writes=True)
        results: "queue.Queue" = queue.Queue()

        def writer(i):
            try:
                store.create(f"/registry/pods/default/w{i}", pod_wire(f"w{i}"))
                results.put(("ok", i))
            except Exception as e:
                results.put(("err", repr(e)))

        threads = [threading.Thread(target=writer, args=(i,), daemon=True) for i in range(8)]
        for t in threads:
            t.start()
        store.crash()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive(), "writer hung across crash()"
        outcomes = [results.get(timeout=1) for _ in range(8)]
        with pytest.raises(Exception):
            store.create("/registry/pods/default/late", pod_wire("late"))
        recovered = KVStore(data_dir=str(tmp_path))
        try:
            survived = {o["metadata"]["name"] for o in recovered.list("/registry/pods/")[0]}
            for kind, i in outcomes:
                if kind == "ok":
                    assert f"w{i}" in survived, f"acked write w{i} lost across crash+replay"
        finally:
            recovered.close()


@pytest.mark.parametrize("tear,recover", [("jax", "port"), ("port", "jax")])
def test_a_torn_wal_recovers_in_the_other_package(tmp_path, tear, recover):
    """The WAL is one format: a store of one package torn mid-append by
    its seam replays in the other's, which truncates the torn line and
    appends again; the replay equals the tearing package's own."""
    kv = {"jax": jax_kv, "port": __import__("kubernetes_tpu_torch.store.kvstore",
                                             fromlist=["KVStore"])}
    reg = {"jax": jax_faults, "port": faults}
    store = kv[tear].KVStore(data_dir=str(tmp_path))
    for i in range(5):
        store.create(f"/registry/pods/default/p{i}", pod_wire(f"p{i}"))
    store.atomic_update("/registry/pods/default/p1",
                        lambda cur: dict(cur, status={"phase": "Running"}))
    reg[tear].inject(reg[tear].WAL_TORN_WRITE, every=1, times=1)
    with pytest.raises(reg[tear].FaultInjected):
        store.create("/registry/pods/default/torn", pod_wire("torn"))
    reg[tear].clear()
    store.crash()
    with open(tmp_path / "wal.log", "rb") as f:
        assert not f.read().endswith(b"\n")  # the torn tail is on disk
    other = kv[recover].KVStore(data_dir=str(tmp_path))
    try:
        objs, version = other.list("/registry/pods/")
        assert [o["metadata"]["name"] for o in objs] == [f"p{i}" for i in range(5)]
        other.create("/registry/pods/default/after", pod_wire("after"))
        got = other.list("/registry/pods/")
    finally:
        other.close()
    own = kv[tear].KVStore(data_dir=str(tmp_path))
    try:
        assert own.list("/registry/pods/") == got
    finally:
        own.close()


# ---------------------------------------------------------------------------
# watch drop site + Reflector close-backoff
# ---------------------------------------------------------------------------


class TestWatchResilience:
    def test_forced_drop_forces_relist_and_converges(self):
        api = APIServer()
        client = Client(LocalTransport(api))
        store = ThreadSafeStore()
        faults.inject(faults.WATCH_DROP, every=1, times=6)
        refl = Reflector(client, "pods", store).start()
        try:
            assert refl.wait_for_sync()
            for i in range(5):
                client.create("pods", pod_wire(f"d{i}"), namespace="default")
            assert wait_until(lambda: len(store) == 5, timeout=30), (
                f"store never converged: {len(store)} of 5 (drops: {faults.stats()})")
            assert faults.stats()[faults.WATCH_DROP.name]["fired"] >= 1
        finally:
            refl.stop()

    def test_idle_close_backoff_does_not_tight_loop(self):
        api = APIServer()
        opened = []
        real_watch = api.watch

        def counting_watch(*a, **k):
            opened.append(time.monotonic())
            return real_watch(*a, **k)

        api.watch = counting_watch
        client = Client(LocalTransport(api))
        store = ThreadSafeStore()
        faults.inject(faults.WATCH_DROP, every=1)  # unbounded storm
        refl = Reflector(client, "pods", store).start()
        try:
            assert refl.wait_for_sync()
            t0 = time.monotonic()
            while time.monotonic() - t0 < 1.5:
                client.create("pods", pod_wire(f"s{time.monotonic_ns()}"), namespace="default")
                time.sleep(0.05)
            dials = len([t for t in opened if t >= t0])
            assert dials <= 20, f"{dials} watch dials in 1.5s"
        finally:
            refl.stop()

    def test_delay_site_stalls_but_delivers(self):
        api = APIServer()
        client = Client(LocalTransport(api))
        store = ThreadSafeStore()
        refl = Reflector(client, "pods", store).start()
        try:
            assert refl.wait_for_sync()
            faults.inject(faults.WATCH_DELAY, every=1, times=3, delay_s=0.05)
            for i in range(3):
                client.create("pods", pod_wire(f"w{i}"), namespace="default")
            assert wait_until(lambda: len(store) == 3, timeout=30)
            assert faults.stats()[faults.WATCH_DELAY.name]["fired"] == 3
        finally:
            refl.stop()


# ---------------------------------------------------------------------------
# HTTP transport retries
# ---------------------------------------------------------------------------


class TestHTTPRetries:
    @pytest.fixture
    def http_cluster(self):
        api = APIServer()
        srv = APIHTTPServer(api).start()
        yield api, srv
        srv.stop()

    def test_idempotent_get_retries_transient_5xx(self, http_cluster):
        _api, srv = http_cluster
        client = Client(HTTPTransport(srv.address))
        client.create("pods", pod_wire("r1"), namespace="default")
        faults.inject(faults.HTTP_5XX, every=1, times=2)
        assert client.get("pods", "r1", namespace="default").metadata.name == "r1"
        assert faults.stats()[faults.HTTP_5XX.name]["fired"] == 2

    def test_retry_budget_is_capped(self, http_cluster):
        _api, srv = http_cluster
        client = Client(HTTPTransport(srv.address, max_retries=2))
        faults.inject(faults.HTTP_5XX, every=1)
        with pytest.raises(APIError) as ei:
            client.get("pods", "whatever", namespace="default")
        assert ei.value.code == 503
        assert faults.stats()[faults.HTTP_5XX.name]["fired"] == 3  # 1 + 2 retries

    def test_5xx_on_a_post_is_not_retried(self, http_cluster):
        _api, srv = http_cluster
        client = Client(HTTPTransport(srv.address))
        faults.inject(faults.HTTP_5XX, every=1, times=1)
        with pytest.raises(APIError) as ei:
            client.create("pods", pod_wire("r5"), namespace="default")
        assert ei.value.code == 503
        assert faults.stats()[faults.HTTP_5XX.name] == {"calls": 1, "fired": 1}
        faults.clear()
        with pytest.raises(APIError) as ei:  # it never reached the server
            client.get("pods", "r5", namespace="default")
        assert ei.value.code == 404

    def test_connection_reset_retries_idempotent_only(self, http_cluster):
        _api, srv = http_cluster
        client = Client(HTTPTransport(srv.address))
        client.create("pods", pod_wire("r2"), namespace="default")
        faults.inject(faults.HTTP_RESET, every=1, times=1)
        assert client.get("pods", "r2", namespace="default").metadata.name == "r2"
        faults.clear()
        faults.inject(faults.HTTP_RESET, every=1, times=1)
        with pytest.raises(ConnectionError):
            client.create("pods", pod_wire("r3"), namespace="default")

    def test_latency_site_delays_but_succeeds(self, http_cluster):
        _api, srv = http_cluster
        client = Client(HTTPTransport(srv.address))
        client.create("pods", pod_wire("r4"), namespace="default")
        faults.inject(faults.HTTP_DELAY, every=1, times=3, delay_s=0.05)
        t0 = time.monotonic()
        assert client.get("pods", "r4", namespace="default").metadata.name == "r4"
        assert time.monotonic() - t0 >= 0.05

    def test_the_informer_rides_5xx_over_http(self, http_cluster):
        """A caller that recovers: the reflector's LIST and watch dial
        retry injected 503s (the client's class) and the store fills."""
        _api, srv = http_cluster
        client = Client(HTTPTransport(srv.address))
        for i in range(3):
            client.create("pods", pod_wire(f"i{i}"), namespace="default")
        faults.inject(faults.HTTP_5XX, every=1, times=2)
        store = ThreadSafeStore()
        refl = Reflector(client, "pods", store).start()
        try:
            assert refl.wait_for_sync(10)
            assert wait_until(lambda: len(store) == 3, timeout=30)
        finally:
            refl.stop()
        assert faults.stats()[faults.HTTP_5XX.name]["fired"] >= 1


# ---------------------------------------------------------------------------
# kubelet sites
# ---------------------------------------------------------------------------


class TestKubeletSites:
    def test_heartbeat_drop_skips_beats_without_killing_the_loop(self):
        from kubernetes_tpu_torch.kubelet.agent import Kubelet
        from kubernetes_tpu_torch.kubelet.runtime import FakeRuntime

        api = APIServer()
        kubelet = Kubelet(Client(LocalTransport(api)), node_name="hb-n0",
                          runtime=FakeRuntime(), heartbeat_period=0.2)
        kubelet.register_node()
        client = Client(LocalTransport(api))

        def beat_stamp():
            node = client.get_wire("nodes", "hb-n0")
            return node["status"]["conditions"][0]["lastHeartbeatTime"]

        kubelet._heartbeat()
        before = beat_stamp()
        faults.inject(faults.KUBELET_HEARTBEAT_DROP, every=1)
        time.sleep(1.1)
        kubelet._heartbeat()  # dropped: no write
        assert beat_stamp() == before
        faults.clear()
        time.sleep(1.1)  # now_iso has second granularity
        kubelet._heartbeat()
        assert beat_stamp() != before

    def test_terminating_stall_keeps_exactly_one_deleted(self):
        from kubernetes_tpu_torch.kubelet.agent import Kubelet
        from kubernetes_tpu_torch.kubelet.runtime import FakeRuntime

        api = APIServer()
        client = Client(LocalTransport(api))
        kubelet = Kubelet(Client(LocalTransport(api)), node_name="st-n0",
                          runtime=FakeRuntime(), heartbeat_period=5.0, sync_period=0.2)
        kubelet.start()
        deleted = []
        store = ThreadSafeStore()
        refl = Reflector(client, "pods", store,
                         on_event=lambda t, o: deleted.append(o) if t == "DELETED" else None)
        refl.start()
        try:
            assert refl.wait_for_sync()
            wire = dict(pod_wire("g0"), spec={"containers": [{"name": "c", "image": "x"}],
                                              "nodeName": "st-n0"})
            client.create("pods", wire, namespace="default")
            assert wait_until(lambda: client.get_wire("pods", "g0", "default")
                              .get("status", {}).get("phase") == "Running", timeout=30)
            faults.inject(faults.KUBELET_TERMINATING_STALL, every=1, delay_s=0.1)
            client.delete("pods", "g0", namespace="default", grace_period_seconds=1)
            assert wait_until(lambda: len(deleted) >= 1, timeout=30)
            time.sleep(0.5)
            assert len(deleted) == 1
            assert faults.stats()[faults.KUBELET_TERMINATING_STALL.name]["fired"] >= 1
        finally:
            refl.stop()
            kubelet.stop()


# ---------------------------------------------------------------------------
# lease sites (twins of tests/test_lease.py's fault cases)
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _leases(pkg, identities):
    if pkg == "jax":
        from kubernetes_tpu.client import Client as C
        from kubernetes_tpu.client import LocalTransport as T
        from kubernetes_tpu.server.api import APIServer as A
        from kubernetes_tpu.utils import lease
    else:
        from kubernetes_tpu_torch.utils import lease
        C, T, A = Client, LocalTransport, APIServer
    client, clock = C(T(A())), FakeClock()
    return clock, lease, {i: lease.LeaseClient(client, "kt-sched", i, lease_duration=5.0,
                                               clock=clock) for i in identities}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_renew_lost_demotes_at_its_own_expiry_never_before(pkg):
    reg = jax_faults if pkg == "jax" else faults
    clock, lease, lc = _leases(pkg, ["a", "b"])
    assert lc["a"].try_acquire() == 1
    rule = reg.inject(reg.LEASE_RENEW_LOST, every=1)
    clock.advance(2.0)
    with pytest.raises(reg.FaultInjected):
        lc["a"].try_acquire()  # the renewal is lost in flight
    assert rule.fired
    assert lc["a"].held_token() == 1  # never demote early
    clock.advance(3.2)
    assert lc["a"].held_token() is None  # never believe late
    reg.clear()
    assert lc["b"].try_acquire() == 2
    with pytest.raises(lease.LeaseFenceError):
        lc["a"].require(1)
    assert lc["b"].validate(2)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_clock_skew_belief_outlives_the_lease_and_the_token_fences(pkg):
    reg = jax_faults if pkg == "jax" else faults
    clock, lease, lc = _leases(pkg, ["a", "b"])
    assert lc["a"].try_acquire() == 1
    rule = reg.inject(reg.LEASE_CLOCK_SKEW, every=1, times=1)
    assert lc["a"].held_token() == 1  # trips the skew on a's clock
    assert rule.fired
    clock.advance(5.1)  # truly expired
    assert lc["a"].held_token() == 1
    assert lc["b"].try_acquire() == 2
    assert lc["a"].held_token() == 1  # still believes (stale)
    with pytest.raises(lease.LeaseFenceError):
        lc["a"].require(lc["a"].held_token())
    assert lc["b"].validate(2)


@pytest.mark.parametrize("seed", [10, 11])
def test_a_renew_lost_storm_plays_out_as_jax(seed):
    """The same schedule and the same seeded storm: the tokens each
    package's holders see step by step are equal."""
    def run(pkg):
        import random

        reg = jax_faults if pkg == "jax" else faults
        rng = random.Random(seed)
        clock, _lease, lc = _leases(pkg, ["a", "b"])
        reg.reset_stats(reseed=seed)
        reg.inject(reg.LEASE_RENEW_LOST, p=0.4)
        trace = []
        for _step in range(100):
            actor = rng.choice(["a", "b"])
            if rng.random() < 0.6:
                try:
                    got = lc[actor].try_acquire()
                except reg.FaultInjected:
                    got = "lost"
                rec = lc[actor].read()
                trace.append((actor, got, rec.token if rec else None))
            else:
                clock.advance(rng.uniform(0.3, 2.5))
            validated = [i for i in "ab" if lc[i].validate(lc[i].held_token())]
            assert len(validated) <= 1
        reg.clear()
        return trace, reg.timeline()

    assert run("port") == run("jax")


# ---------------------------------------------------------------------------
# the sampler's skipped beat
# ---------------------------------------------------------------------------


def test_timeseries_skip_degrades_to_the_surviving_samples():
    from kubernetes_tpu.utils import metrics as jmetrics
    from kubernetes_tpu.utils import timeseries as jts
    from kubernetes_tpu_torch.utils import metrics
    from kubernetes_tpu_torch.utils import timeseries as ts

    def run(reg, mmod, tsmod):
        registry = mmod.Registry()
        c = registry.counter("kt_skip_total", "skip test")
        r = tsmod.Retention()
        reg.inject(reg.TIMESERIES_SAMPLE_SKIP, every=3)
        touched = []
        for beat in range(9):
            c.inc(10)
            touched.append(r.sample_now(registry, now=100.0 + beat))
        reg.clear()
        return touched, r.rate("kt_skip_total", 8.0, now=108.0), r.increase(
            "kt_skip_total", 8.0, now=108.0)

    port = run(faults, metrics, ts)
    jax = run(jax_faults, jmetrics, jts)
    assert port == jax
    touched, rate, _inc = port
    assert [t == 0 for t in touched] == [b % 3 == 2 for b in range(9)]
    assert rate == pytest.approx(10.0)  # no extrapolation through the gaps


# ---------------------------------------------------------------------------
# the descheduler's mid-move crash (the twin of tests/test_rebalance.py's)
# ---------------------------------------------------------------------------


@pytest.fixture
def rebalance_state_kept(monkeypatch):
    """Fresh rebalance and capacity monitors, and the move counters put
    back after the test: other files compare them across the packages
    in the same worker."""
    from kubernetes_tpu_torch.utils import capacity as capmod
    from kubernetes_tpu_torch.utils import rebalance as rebmod

    monkeypatch.setattr(rebmod, "DEFAULT", rebmod.RebalanceMonitor())
    monkeypatch.setattr(capmod, "DEFAULT", capmod.CapacityMonitor())
    saved = {c: c.snapshot() for c in (rebmod.MOVES, rebmod.STRANDED)}
    yield
    for c, values in saved.items():
        with c._lock:
            c._values.clear()
            c._values.update(values)


def test_descheduler_crash_mid_move_strands_nothing(rebalance_state_kept):
    from kubernetes_tpu_torch.controllers.descheduler import Descheduler
    from kubernetes_tpu_torch.models.objects import REBALANCE_JOURNAL_LABEL
    from kubernetes_tpu_torch.utils import rebalance as rebmod
    from tests.test_rebalance import _node_wire, _pod_wire

    api = APIServer()
    client = Client(LocalTransport(api))
    for j in range(6):
        client.create("nodes", _node_wire(f"n{j}"))
    k = 0
    for j in range(6):
        for _ in range(3):
            client.create("pods", _pod_wire(f"p{k}"), namespace="default")
            assert client.bind_bulk([(f"p{k}", f"n{j}")])[0].get("status") == "Success"
            k += 1
    client.create("pods", _pod_wire("waiting", cpu="500m"), namespace="default")
    stranded_before = rebmod.STRANDED.value()
    rule = faults.inject(faults.DESCHED_MOVE_CRASH, p=1.0, times=1)
    d = Descheduler(client, grace_period_seconds=0, device="cpu")
    with pytest.raises(faults.FaultInjected):
        d.sync_once()
    assert rule.fired == 1
    tmpl, _ = client.list("podtemplates")
    assert len(tmpl) == 1  # the orphaned move intent
    assert REBALANCE_JOURNAL_LABEL in (tmpl[0].metadata.labels or {})
    names = lambda: {p.metadata.name for p in client.list("pods")[0]}  # noqa: E731
    assert len({f"p{k}" for k in range(18)} - names()) == 1  # evicted, not recreated
    faults.clear()
    assert d.recover() == 1  # the journal re-pends the pod
    assert client.list("podtemplates")[0] == []
    assert {f"p{k}" for k in range(18)} <= names()
    assert rebmod.STRANDED.value() == stranded_before
    assert rebmod.MOVES.value(outcome="recovered") >= 1


# ---------------------------------------------------------------------------
# the daemon's seams, through the twin daemons (same rule in both registries)
# ---------------------------------------------------------------------------


@pytest.fixture
def pairs():
    from tests.test_torch_daemon import Pair

    made = []

    def make(**kw):
        made.append(Pair(**kw))
        return made[-1]

    yield make
    for p in made:
        p.stop()


def _arm_both(site_name, **kw):
    for mod in PACKAGES:
        mod.reset_stats(reseed=3)
        mod.inject(mod.SITES[site_name], **kw)


def test_sched_evict_error_counts_evict_failed_and_records_no_nomination(pairs):
    from kubernetes_tpu.scheduler import daemon as jdaemon
    from kubernetes_tpu_torch.scheduler import daemon as tdaemon
    from tests.test_torch_daemon import pod_wire as rng_pod

    pair = pairs(seed=6, n_nodes=8, n_pods=0, services=0, eviction_grace_seconds=30)
    pair.capacity_timed += ("depth",)
    rng = np.random.default_rng(12)
    pair.each("create_bulk", "pods", [rng_pod(f"low{i}", rng, cpu="500m")
                                      for i in range(8 * 16)], namespace="default")
    pair.tick_all()
    failed0 = (jdaemon._PREEMPT_OUTCOMES.value(outcome="evict_failed"),
               tdaemon._PREEMPT_OUTCOMES.value(outcome="evict_failed"))
    _arm_both("scheduler.evict.error", every=1)
    pair.each("create_bulk", "pods", [rng_pod(f"hi{i}", rng, priority=100, cpu="1500m")
                                      for i in range(4)], namespace="default")
    pair.tick_all()
    failed = (jdaemon._PREEMPT_OUTCOMES.value(outcome="evict_failed") - failed0[0],
              tdaemon._PREEMPT_OUTCOMES.value(outcome="evict_failed") - failed0[1])
    assert failed[0] == failed[1] > 0
    assert faults.timeline() == jax_faults.timeline() and faults.timeline()
    for k in (0, 1):
        pods = pair.apis[k].list("pods", "default")["items"]
        assert not any(p["metadata"].get("deletionTimestamp") for p in pods)
        assert not any(p.get("status", {}).get("nominatedNodeName") for p in pods)
    assert pair.j._nominations == {} and pair.t._nominations == {}


def test_sched_commit_crash_lands_no_bind_and_a_fresh_daemon_binds_the_gang_whole(pairs):
    """The seam fires in both daemons' gang tick. The port's daemon
    raises it and lands no bind (departure (a): its next tick would
    raise it too, and the started daemon stops); a fresh daemon, rebuilt
    from LIST+watch, binds the gang whole. JAX's unstarted daemon falls
    back to its full re-lower tick, which binds the gang: the two
    clusters end with the same bindings."""
    from kubernetes_tpu_torch.models.objects import POD_GROUP_LABEL
    from kubernetes_tpu_torch.scheduler.daemon import (
        IncrementalBatchScheduler,
        SchedulerConfig,
    )
    from tests.test_torch_daemon import pod_wire as rng_pod

    pair = pairs(seed=4, n_nodes=8, n_pods=20, services=0)
    pair.tick_all()
    pair.each("create", "podgroups", {"kind": "PodGroup",
                                      "metadata": {"name": "gx", "namespace": "default"},
                                      "spec": {"minMember": 4}}, namespace="default")
    rng = np.random.default_rng(5)
    gang = [rng_pod(f"gx{i}", rng, labels={POD_GROUP_LABEL: "gx"}, cpu="200m")
            for i in range(4)]
    pair.each("create_bulk", "pods", gang, namespace="default")
    pair.settle()
    _arm_both("scheduler.commit.crash", every=1, times=1)
    with pytest.raises(faults.FaultInjected):
        pair.t.schedule_batch(timeout=0.05)
    assert not any(pair.bindings(1)[f"gx{i}"] for i in range(4))  # no bind landed
    try:
        pair.j.schedule_batch(timeout=0.05)
    except jax_faults.FaultInjected:
        pass
    assert faults.timeline() == jax_faults.timeline() == [("scheduler.commit.crash", 1)]
    for mod in PACKAGES:
        mod.clear()
    # The port's daemon dies; a fresh one rebuilds from LIST+watch.
    pair.t.kill()
    pair.tcfg.stop()
    assert pair.t._session is None
    tcfg = SchedulerConfig(Client(LocalTransport(pair.apis[1]))).start()
    assert tcfg.wait_for_sync()
    fresh = IncrementalBatchScheduler(tcfg, device="cpu")
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not all(
                pair.bindings(1)[f"gx{i}"] for i in range(4)):
            fresh.schedule_batch(timeout=0.2)
        while pair.j.schedule_batch(timeout=0.05):
            pass
        jb, tb = pair.bindings(0), pair.bindings(1)
        assert all(tb[f"gx{i}"] for i in range(4))
        assert tb == jb
    finally:
        fresh.stop()
