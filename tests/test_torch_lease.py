"""The port's fencing lease decides as the JAX package's.

Two apiservers (the JAX package's `APIServer`) each hold one lease: the
JAX `LeaseClient`s over one, the port's over the other, every identity
of both packages on one injected clock. The same seeded renew, release,
expire and steal schedules (`tests/test_lease.py:150-235`) go through
both, and after every step each identity's return value, its believed
token (`held_token`), `validate` of that belief, the stored record and
its annotations, and the count of elections must be equal.

The JAX module's fault seams are not ported (departure (c)); the same
situations come from the outside, the same for both packages: a client
whose renew write is dropped (it raises before the write lands), and a
holder whose clock runs slow by one lease duration. In every schedule
at most one identity's believed token validates, and the record's token
never goes back.

The two `LeaseElector`s (threads) are held to the same outcomes. What
a lease needs of the client is held to the JAX package's too: the
Endpoints record's round trip through serde, and the single-pod bind
over HTTP.
"""

import random
import time

import pytest

from kubernetes_tpu.client import Client as JClient
from kubernetes_tpu.client import LocalTransport as JLocalTransport
from kubernetes_tpu.server.api import APIServer
from kubernetes_tpu.utils import lease as jlease
from kubernetes_tpu_torch.client.rest import Client, LocalTransport
from kubernetes_tpu_torch.utils import lease

LEASE = "kt-sched"


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class DropWrites:
    """A client whose `update` raises before the write lands while
    `dropping` (a renew lost in flight); everything else passes."""

    def __init__(self, client):
        self.client = client
        self.dropping = False

    def update(self, *args, **kwargs):
        if self.dropping:
            raise ConnectionError("renew write dropped")
        return self.client.update(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.client, name)


def twins(identities, lease_duration=5.0, clock=None, clocks=None):
    """(the true clock, {identity: (JAX LeaseClient, port LeaseClient)}
    over twin apiservers, the two clients with their drop switches).
    Every identity reads the true clock, or its own from `clocks`."""
    clock = clock or FakeClock()
    jclient = DropWrites(JClient(JLocalTransport(APIServer())))
    pclient = DropWrites(Client(LocalTransport(APIServer())))
    out = {}
    for ident in identities:
        c = (clocks or {}).get(ident, clock)
        out[ident] = (
            jlease.LeaseClient(jclient, LEASE, ident, lease_duration=lease_duration, clock=c),
            lease.LeaseClient(pclient, LEASE, ident, lease_duration=lease_duration, clock=c),
        )
    return clock, out, (jclient, pclient)


def elections():
    return (jlease.ELECTIONS.value(tier="scheduler"), lease.ELECTIONS.value(tier="scheduler"))


def record_of(lc):
    """(holder, token, renewed) and the annotations of the stored lease."""
    rec = lc.read()
    if rec is None:
        return None, None
    obj = lc.client.get("endpoints", LEASE, namespace="kube-system")
    return (rec.holder, rec.token, rec.renewed), dict(obj.metadata.annotations)


def call(fn):
    """(value, exception type name) of one call."""
    try:
        return fn(), None
    except Exception as e:  # a dropped write propagates out of try_acquire
        return None, type(e).__name__


def assert_same(lc, step):
    """Both packages agree on every identity's view and on the record;
    returns the port's record and the validated believers."""
    validated = []
    for ident, (j, p) in lc.items():
        jt, pt = j.held_token(), p.held_token()
        assert jt == pt, f"{step}: {ident} believes {pt}, JAX {jt}"
        jv, pv = j.validate(jt), p.validate(pt)
        assert jv == pv, f"{step}: {ident} validates {pv}, JAX {jv}"
        if pv:
            validated.append(ident)
    j, p = next(iter(lc.values()))
    assert record_of(p) == record_of(j), step
    assert len(validated) <= 1, f"{step}: two validated holders {validated}"
    return p.read(), validated


def run_schedule(seed, identities, lease_duration, steps, p_acquire, p_release, drop=0.0,
                 advance=(0.2, 3.0), clock=None, clocks=None):
    rng = random.Random(seed)
    clock, lc, clients = twins(identities, lease_duration, clock, clocks)
    e0 = elections()
    last_token = 0
    for step in range(steps):
        actor = rng.choice(identities)
        action = rng.random()
        j, p = lc[actor]
        if action < p_acquire:
            dropped = rng.random() < drop
            for c in clients:
                c.dropping = dropped
            got = [call(j.try_acquire), call(p.try_acquire)]
            for c in clients:
                c.dropping = False
            assert got[1] == got[0], f"seed {seed} step {step}: {actor} got {got}"
        elif action < p_acquire + p_release:
            j.release()
            p.release()
        else:
            clock.advance(rng.uniform(*advance))
        rec, _ = assert_same(lc, f"seed {seed} step {step}")
        if rec is not None:
            assert rec.token >= last_token, f"seed {seed} step {step}: the token went back"
            last_token = rec.token
        d = [b - a for a, b in zip(e0, elections())]
        assert d[1] == d[0], f"seed {seed} step {step}: elections {d}"
    return lc


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_schedules_equal_jax(seed):
    """`tests/test_lease.py`'s randomized schedules, three identities,
    step for step."""
    lc = run_schedule(seed, ["a", "b", "c"], 5.0, 120, 0.55, 0.15)
    assert any(p.read() is not None for _, p in lc.values())


@pytest.mark.parametrize("seed", [10, 11])
def test_schedules_with_dropped_renew_writes_equal_jax(seed):
    """Four in ten acquire attempts lose their write in flight: holders
    may demote early, never two validated believers, never a token
    going back; both packages alike."""
    run_schedule(seed, ["a", "b"], 4.0, 100, 0.6, 0.0, drop=0.4, advance=(0.3, 2.5))


def test_first_acquire_renewal_and_steal():
    clock, lc, _ = twins(["a", "b"])
    assert [x.try_acquire() for x in lc["a"]] == [1, 1]
    assert [x.try_acquire() for x in lc["b"]] == [None, None]  # a live rival lease
    clock.advance(2.0)
    assert [x.try_acquire() for x in lc["a"]] == [1, 1]  # renewal: the same epoch
    clock.advance(5.1)  # expired on the true clock
    assert [x.try_acquire() for x in lc["b"]] == [2, 2]
    assert [x.held_token() for x in lc["a"]] == [None, None]
    with pytest.raises(jlease.LeaseFenceError):
        lc["a"][0].require(1)
    with pytest.raises(lease.LeaseFenceError):
        lc["a"][1].require(1)
    assert_same(lc, "steal")


def test_release_and_own_lapse():
    clock, lc, _ = twins(["a", "b"])
    assert [x.try_acquire() for x in lc["a"]] == [1, 1]
    for x in lc["a"]:
        x.release()
    assert [x.try_acquire() for x in lc["b"]] == [2, 2]  # no wait for expiry
    clock.advance(5.1)
    assert [x.try_acquire() for x in lc["b"]] == [3, 3]  # its own lapse: a new epoch
    assert_same(lc, "lapse")


def test_dropped_renew_believes_through_the_window_then_fences():
    """The renew's write vanishes: the holder believes only until its
    window lapses on its own clock, and its token fences once a rival
    steals."""
    clock, lc, clients = twins(["a", "b"])
    assert [x.try_acquire() for x in lc["a"]] == [1, 1]
    clock.advance(2.0)
    for c in clients:
        c.dropping = True
    assert [call(x.try_acquire)[1] for x in lc["a"]] == ["ConnectionError"] * 2
    for c in clients:
        c.dropping = False
    assert [x.held_token() for x in lc["a"]] == [1, 1]  # never demote early
    clock.advance(3.2)
    assert [x.held_token() for x in lc["a"]] == [None, None]  # never believe late
    assert [x.try_acquire() for x in lc["b"]] == [2, 2]
    assert [x.validate(1) for x in lc["a"]] == [False, False]
    assert_same(lc, "dropped renew")


def test_slow_clock_believer_is_fenced():
    """A holder whose clock runs slow by one lease duration believes an
    expired lease is live; the rival steals it regardless, and the
    store refuses the stale token: one validated believer."""
    true = FakeClock()
    skew = {"a": 0.0}
    clocks = {"a": lambda: true() - skew["a"]}
    _, lc, _ = twins(["a", "b"], clock=true, clocks=clocks)
    assert [x.try_acquire() for x in lc["a"]] == [1, 1]
    skew["a"] = 5.0  # from here a's clock reads one lease duration slow
    true.advance(5.1)
    assert [x.held_token() for x in lc["a"]] == [1, 1]  # still believes
    assert [x.try_acquire() for x in lc["b"]] == [2, 2]
    assert [x.held_token() for x in lc["a"]] == [1, 1]  # stale belief
    with pytest.raises(lease.LeaseFenceError):
        lc["a"][1].require(lc["a"][1].held_token())
    _, validated = assert_same(lc, "skew")
    assert validated == ["b"]


@pytest.mark.parametrize("seed", [20, 21])
def test_schedules_with_a_slow_clock_equal_jax(seed):
    """The randomized schedule with one identity's clock a lease
    duration slow throughout."""
    true = FakeClock()
    run_schedule(seed, ["a", "b", "c"], 5.0, 100, 0.55, 0.1, clock=true,
                 clocks={"a": lambda: true() - 5.0})


def wait_until(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_elector_leads_and_threads_the_token(pkg):
    mod, client = ((jlease, JClient(JLocalTransport(APIServer()))) if pkg == "jax"
                   else (lease, Client(LocalTransport(APIServer()))))
    seen = []
    e = mod.LeaseElector(mod.LeaseClient(client, LEASE, "a", lease_duration=1.5),
                         renew_period=0.05, retry_period=0.05, on_elected=seen.append).start()
    try:
        assert wait_until(lambda: e.is_leader)
        assert seen == [1]
    finally:
        e.stop()
    assert not e.is_leader
    # stop() released the lease: a rival takes it at once, a new epoch.
    assert mod.LeaseClient(client, LEASE, "b", lease_duration=1.5).try_acquire() == 2


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_exactly_one_elector_of_many_leads(pkg):
    mod, client = ((jlease, JClient(JLocalTransport(APIServer()))) if pkg == "jax"
                   else (lease, Client(LocalTransport(APIServer()))))
    electors = [mod.LeaseElector(mod.LeaseClient(client, LEASE, f"id{i}", lease_duration=1.5),
                                 renew_period=0.05, retry_period=0.05).start()
                for i in range(3)]
    try:
        assert wait_until(lambda: sum(e.is_leader for e in electors) == 1)
        time.sleep(0.3)
        assert sum(e.is_leader for e in electors) == 1
        leader = next(e for e in electors if e.is_leader)
        assert leader.token == 1
        assert leader.lease.validate(leader.token)
    finally:
        for e in electors:
            e.stop()


def test_endpoints_round_trip_equals_jax():
    """The record a lease lives in: the port's Endpoints decode and
    encode as the JAX package's serde does."""
    from kubernetes_tpu.models import serde as jserde
    from kubernetes_tpu.models.objects import Endpoints as JEndpoints
    from kubernetes_tpu_torch.models import serde
    from kubernetes_tpu_torch.models.objects import Endpoints

    wire = {"kind": "Endpoints", "apiVersion": "v1",
            "metadata": {"name": "web", "namespace": "default", "resourceVersion": "7",
                         "annotations": {lease.HOLDER_KEY: "a", lease.TOKEN_KEY: "3"}},
            "subsets": [{"addresses": [{"ip": "10.1.2.3",
                                        "targetRef": {"kind": "Pod", "name": "web-1"}}],
                         "ports": [{"name": "http", "port": 80, "protocol": "TCP"}]}]}
    got = serde.to_wire(serde.from_wire(Endpoints, wire))
    assert got == jserde.to_wire(jserde.from_wire(JEndpoints, wire))
    assert got["subsets"] == wire["subsets"]


def test_single_bind_over_http_equals_the_jax_client():
    """`Client.bind` (the per-pod scheduler's commit) over HTTP: the pod
    bound, and a second bind refused with the JAX client's 409."""
    from kubernetes_tpu.client import HTTPTransport as JHTTPTransport
    from kubernetes_tpu.server.httpserver import APIHTTPServer
    from kubernetes_tpu_torch.client.rest import HTTPTransport

    codes = []
    for pkg in ("jax", "port"):
        api = APIServer()
        setup = JClient(JLocalTransport(api))
        setup.create("nodes", {"kind": "Node", "metadata": {"name": "n0"}})
        setup.create("pods", {"kind": "Pod", "metadata": {"name": "p", "namespace": "default"},
                              "spec": {"containers": [{"name": "c", "image": "app"}]}},
                     namespace="default")
        srv = APIHTTPServer(api).start()
        try:
            c = (JClient(JHTTPTransport(srv.address)) if pkg == "jax"
                 else Client(HTTPTransport(srv.address)))
            c.bind("p", "n0", namespace="default")
            assert setup.get("pods", "p", namespace="default").spec.node_name == "n0"
            try:
                c.bind("p", "n0", namespace="default")
            except Exception as e:
                codes.append((type(e).__name__ == "APIError", e.code, e.reason))
        finally:
            srv.stop()
    assert codes[0] == codes[1] and codes[1][:2] == (True, 409)
