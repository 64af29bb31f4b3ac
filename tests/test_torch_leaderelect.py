"""The port's leader election and hot-standby wrapper behave as the JAX
package's (`utils/leaderelect.py`; reference contrib/pod-master).

- The lock's mechanics step for step: two apiservers (the JAX package's
  `APIServer`), the JAX `LeaderElector`s over one and the port's over
  the other, one seeded schedule of acquire/renew attempts and clock
  moves (`time.time` patched for the schedule): every attempt's answer
  and the stored lock's annotations equal.
- Threads: exactly one of many leads, a rival takes over when the leader
  stops, distinct locks are independent, in both packages.
- `HAHotStandby` runs a daemon only while leading: a standby stays idle,
  takes over when the leader stops, stops a daemon that finished
  building after leadership was lost, builds again after a failed build;
  and around the port's per-pod `Scheduler` it binds a pod, as the JAX
  wrapper around the JAX one does.
"""

import random
import threading
import time

import pytest

from kubernetes_tpu.client import Client as JClient
from kubernetes_tpu.client import LocalTransport as JLocalTransport
from kubernetes_tpu.server.api import APIServer
from kubernetes_tpu.utils import leaderelect as jle
from kubernetes_tpu_torch.client.rest import Client, LocalTransport
from kubernetes_tpu_torch.utils import leaderelect as ple

PKGS = ["jax", "port"]


def wait_until(cond, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def client_of(pkg, api):
    return JClient(JLocalTransport(api)) if pkg == "jax" else Client(LocalTransport(api))


def module_of(pkg):
    return jle if pkg == "jax" else ple


def elector(pkg, api, name, identity, **kw):
    kw.setdefault("lease_duration", 1.5)
    kw.setdefault("renew_period", 0.1)
    kw.setdefault("retry_period", 0.1)
    return module_of(pkg).LeaderElector(client_of(pkg, api), name, identity, **kw)


def annotations(pkg, api, name):
    try:
        obj = client_of(pkg, api).get("endpoints", name, namespace="kube-system")
    except Exception:
        return None
    return dict(obj.metadata.annotations)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lock_schedule_equals_jax(seed, monkeypatch):
    now = [5000.0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    rng = random.Random(seed)
    apis = {pkg: APIServer() for pkg in PKGS}
    idents = ["a", "b", "c"]
    electors = {pkg: {i: elector(pkg, apis[pkg], "cm", i, lease_duration=5.0) for i in idents}
                for pkg in PKGS}
    acquired = 0
    for step in range(150):
        actor = rng.choice(idents)
        if rng.random() < 0.6:
            got = [electors[pkg][actor]._try_acquire_or_renew() for pkg in PKGS]
            assert got[1] == got[0], f"seed {seed} step {step}: {actor} {got}"
            acquired += got[0]
        else:
            now[0] += rng.uniform(0.5, 4.0)
        assert annotations("port", apis["port"], "cm") == annotations("jax", apis["jax"], "cm")
    assert acquired


@pytest.mark.parametrize("pkg", PKGS)
def test_exactly_one_of_many_leads(pkg):
    api = APIServer()
    electors = [elector(pkg, api, "cm", f"id-{i}").start() for i in range(4)]
    try:
        assert wait_until(lambda: sum(e.is_leader for e in electors) == 1)
        time.sleep(0.5)  # stable: still exactly one
        assert sum(e.is_leader for e in electors) == 1
    finally:
        for e in electors:
            e.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_takeover_on_leader_death(pkg):
    api = APIServer()
    a = elector(pkg, api, "cm", "a").start()
    assert wait_until(lambda: a.is_leader)
    b = elector(pkg, api, "cm", "b").start()
    time.sleep(0.3)
    assert not b.is_leader  # a live lease respected
    a.stop()  # stops renewing; the lease expires
    try:
        assert wait_until(lambda: b.is_leader, timeout=15)
        assert annotations(pkg, api, "cm")[module_of(pkg).HOLDER_KEY] == "b"
    finally:
        b.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_distinct_locks_are_independent(pkg):
    api = APIServer()
    a = elector(pkg, api, "scheduler", "a").start()
    b = elector(pkg, api, "controller-manager", "b").start()
    try:
        assert wait_until(lambda: a.is_leader and b.is_leader)
    finally:
        a.stop()
        b.stop()


class FakeDaemon:
    """What a factory returns: started, then stopped."""

    def __init__(self, tag):
        self.tag = tag
        self.stopped = False

    def stop(self):
        self.stopped = True


def standby(pkg, api, identity, factory):
    return module_of(pkg).HAHotStandby(client_of(pkg, api), "cm", identity, factory,
                                       lease_duration=1.5, renew_period=0.1,
                                       retry_period=0.1).start()


@pytest.mark.parametrize("pkg", PKGS)
def test_hot_standby_runs_a_daemon_only_while_leading(pkg):
    api = APIServer()
    ha1 = standby(pkg, api, "one", lambda: FakeDaemon("one"))
    assert wait_until(lambda: ha1.active)
    ha2 = standby(pkg, api, "two", lambda: FakeDaemon("two"))
    try:
        time.sleep(0.4)
        assert not ha2.active  # the hot standby stays idle
        first = ha1.daemon
        ha1.stop()
        assert first.stopped and not ha1.active
        assert wait_until(lambda: ha2.active, timeout=15)
        assert ha2.daemon.tag == "two"
    finally:
        ha2.stop()
    assert not ha2.active


@pytest.mark.parametrize("pkg", PKGS)
def test_a_daemon_built_after_leadership_was_lost_is_stopped(pkg):
    """The build runs off the elector's thread; leadership lost while
    it runs leaves no daemon running."""
    gate = threading.Event()
    built = []

    def factory():
        gate.wait(10)
        d = FakeDaemon("late")
        built.append(d)
        return d

    ha = module_of(pkg).HAHotStandby(client_of(pkg, APIServer()), "cm", "x", factory)
    ha._up()
    ha._up()  # idempotent: one build at a time
    ha._down()
    gate.set()
    assert wait_until(lambda: built and built[0].stopped)
    assert len(built) == 1 and ha.daemon is None and not ha.active


@pytest.mark.parametrize("pkg", PKGS)
def test_a_failed_build_is_tried_again_at_the_next_renewal(pkg):
    calls = []

    def factory():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("first build fails")
        return FakeDaemon("second")

    ha = standby(pkg, APIServer(), "x", factory)
    try:
        assert wait_until(lambda: ha.active, timeout=15)
        assert len(calls) == 2 and ha.daemon.tag == "second"
    finally:
        ha.stop()


def _node(name):
    return {"kind": "Node", "metadata": {"name": name},
            "status": {"capacity": {"cpu": "4", "memory": "8Gi", "pods": "10"},
                       "conditions": [{"type": "Ready", "status": "True"}]}}


def _pod(name):
    return {"kind": "Pod", "metadata": {"name": name, "namespace": "default"},
            "spec": {"containers": [{"name": "c", "image": "app", "resources": {
                "limits": {"cpu": "500m", "memory": "256Mi"}}}]}}


@pytest.mark.parametrize("pkg", PKGS)
def test_hot_standby_around_the_per_pod_scheduler_binds(pkg):
    """The JAX command's `--leader-elect` shape around each package's
    per-pod Scheduler: the leader binds a pod; the standby binds the
    next one after the leader stops."""
    if pkg == "jax":
        from kubernetes_tpu.scheduler.daemon import Scheduler, SchedulerConfig
    else:
        from kubernetes_tpu_torch.scheduler.daemon import Scheduler, SchedulerConfig
    api = APIServer()
    setup = JClient(JLocalTransport(api))
    for j in range(3):
        setup.create("nodes", _node(f"n{j}"))

    def factory():
        cfg = SchedulerConfig(client_of(pkg, api)).start()
        cfg.wait_for_sync()
        return Scheduler(cfg).start()

    def node_of(name):
        return setup.get("pods", name, namespace="default").spec.node_name

    a = standby(pkg, api, "a", factory)
    b = None
    try:
        assert wait_until(lambda: a.active)
        b = standby(pkg, api, "b", factory)
        setup.create("pods", _pod("p0"), namespace="default")
        assert wait_until(lambda: node_of("p0"), timeout=20)
        assert not b.active
        a.stop()
        assert wait_until(lambda: b.active, timeout=20)
        setup.create("pods", _pod("p1"), namespace="default")
        assert wait_until(lambda: node_of("p1"), timeout=20)
        assert node_of("p1") != node_of("p0")  # the assumed p0 counts
    finally:
        a.stop()
        if b is not None:
            b.stop()
