"""The port's per-pod `Scheduler` and its command's routing equal the
JAX package's.

- Two apiservers (the JAX package's `APIServer`) are seeded alike from a
  numpy seed: Ready nodes, a NotReady one and an unschedulable one,
  services, bound pods, and pending pods of which some fit nowhere. The
  JAX `Scheduler` runs over one, the port's over the other, neither
  started: `schedule_one()` is called on both in step. Pod for pod the
  pod each popped, its node or the error, the bindings, the requeued
  pods (the tests take them from `_requeue_later` and send them back
  through each daemon's `_refetch_and_requeue`) and every event
  (reason, message, count) are equal.
- The bindings, in the order the port's daemon popped its pods, equal
  `schedule_backlog` of those pods in that order on the cluster as it
  was LISTed before the first pop (the premise of `chip_smoke.py`'s
  `daemon_scalar` leg).
- A bind that loses its race records FailedBinding and requeues; the
  bind TokenBucket is built and consulted alike; the started loop
  contains a step's crash; the Ready-filtered node lister lists alike.
- The command's routing: for every combination of the batch flags, a
  policy file, a sidecar and `--leader-elect`, `start_scheduler` of the
  port boots the daemon the JAX command boots (its class, cache form,
  mode, sidecar and the election's lock), or exits with the same
  message. The daemon classes are replaced by recorders in both
  packages, so nothing is started.
"""

import copy
import itertools
import json
import time

import numpy as np
import pytest

from kubernetes_tpu.client import Client as JClient
from kubernetes_tpu.client import LocalTransport as JLocalTransport
from kubernetes_tpu.scheduler import daemon as jdaemon
from kubernetes_tpu.server.api import APIServer
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.client.rest import Client, LocalTransport
from kubernetes_tpu_torch.scheduler import daemon as tdaemon
from kubernetes_tpu_torch.scheduler.batch import schedule_backlog


def wait_until(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def node_wire(name, rng, ready=True, unschedulable=False):
    cpu = int(rng.choice([2, 4, 8]))
    wire = {"kind": "Node",
            "metadata": {"name": name, "labels": {"zone": f"z{int(rng.integers(3))}",
                                                  "disk": ("ssd", "hdd")[int(rng.integers(2))]}},
            "status": {"capacity": {"cpu": str(cpu), "memory": f"{2 * cpu}Gi", "pods": "12"},
                       "conditions": [{"type": "Ready",
                                       "status": "True" if ready else "False"}]}}
    if unschedulable:
        wire["spec"] = {"unschedulable": True}
    return wire


def pod_wire(name, rng, cpu=None):
    container = {"name": "c", "image": "app", "resources": {"limits": {
        "cpu": cpu or f"{int(rng.choice([100, 250, 500, 1000]))}m",
        "memory": f"{int(rng.choice([64, 256, 512]))}Mi"}}}
    if rng.random() < 0.1:
        container["ports"] = [{"containerPort": 80, "hostPort": int(rng.choice([8080, 9090]))}]
    spec = {"containers": [container]}
    if rng.random() < 0.15:
        spec["nodeSelector"] = ({"disk": "ssd"} if rng.random() < 0.5
                                else {"zone": f"z{int(rng.integers(3))}"})
    return {"kind": "Pod",
            "metadata": {"name": name, "namespace": "default",
                         "labels": {"app": f"a{int(rng.integers(3))}"}},
            "spec": spec}


def service_wire(name, app):
    return {"kind": "Service", "metadata": {"name": name, "namespace": "default"},
            "spec": {"selector": {"app": app}, "ports": [{"port": 80}]}}


class ScalarPair:
    """The JAX per-pod Scheduler on one apiserver and the port's on a
    twin, not started; rejected pods are held for the test."""

    def __init__(self, seed=0, n_nodes=16, n_bound=24, n_pending=60, n_stuck=3, **cfg_kw):
        self.apis = [APIServer(), APIServer()]
        self.setups = [JClient(JLocalTransport(a)) for a in self.apis]
        rng = np.random.default_rng(seed)
        nodes = [node_wire(f"n{j}", rng, ready=j != 3, unschedulable=j == 5)
                 for j in range(n_nodes)]
        bound = [pod_wire(f"b{i}", rng) for i in range(n_bound)]
        pending = [pod_wire(f"p{i}", rng, cpu="64" if i % 20 == 7 else None)
                   for i in range(n_pending)]
        pending += [pod_wire(f"x{i}", rng, cpu="64") for i in range(n_stuck)]
        self.pending_names = [p["metadata"]["name"] for p in pending]
        for c in self.setups:
            for s in range(3):
                c.create("services", service_wire(f"s{s}", f"a{s}"), namespace="default")
            for n in nodes:
                c.create("nodes", n)
            c.create_bulk("pods", bound, namespace="default")
            usable = [j for j in range(n_nodes) if j not in (3, 5)]
            c.bind_bulk([(f"b{i}", f"n{usable[i * 5 % len(usable)]}") for i in range(n_bound)],
                        namespace="default")
            c.create_bulk("pods", pending, namespace="default")
        self.jcfg = jdaemon.SchedulerConfig(JClient(JLocalTransport(self.apis[0])),
                                            **cfg_kw).start()
        self.tcfg = tdaemon.SchedulerConfig(Client(LocalTransport(self.apis[1])),
                                            raw_scheduled_cache=False, **cfg_kw).start()
        assert self.jcfg.wait_for_sync() and self.tcfg.wait_for_sync()
        self.j = jdaemon.Scheduler(self.jcfg)
        self.t = tdaemon.Scheduler(self.tcfg)
        for d in (self.j, self.t):
            d.held, d.log = [], []
            d._requeue_later = lambda pod, _d=d: _d.held.append(pod)
            algo = d.config.algorithm
            schedule = algo.schedule

            def logged(pod, lister, _d=d, _schedule=schedule):
                try:
                    dest = _schedule(pod, lister)
                except Exception as e:
                    _d.log.append((pod.metadata.name, type(e).__name__, str(e)))
                    raise
                _d.log.append((pod.metadata.name, dest, ""))
                return dest

            algo.schedule = logged
        self.wait_queued(len(pending))

    def wait_queued(self, n):
        assert wait_until(lambda: len(self.jcfg.pod_queue) == n and len(self.tcfg.pod_queue) == n)

    def step_all(self):
        """schedule_one() on both until both queues are empty."""
        steps = 0
        while True:
            got = (self.j.schedule_one(timeout=0.2), self.t.schedule_one(timeout=0.2))
            assert got[1] == got[0], f"step {steps}: {got}"
            if not got[0]:
                return steps
            steps += 1

    def retry(self):
        n = len(self.t.held)
        for d in (self.j, self.t):
            held, d.held = d.held, []
            for pod in held:
                d._refetch_and_requeue(pod)
        self.wait_queued(n)

    def bindings(self, k):
        return {p["metadata"]["name"]: p["spec"].get("nodeName", "")
                for p in self.apis[k].list("pods", "default")["items"]}

    def events(self, k):
        (self.jcfg, self.tcfg)[k].client.flush_events(timeout=10)
        return sorted((ev["involvedObject"]["name"], ev["reason"], ev["message"],
                       int(ev.get("count", 1)))
                      for ev in self.apis[k].list("events", "default")["items"])

    def stop(self):
        for d in (self.j, self.t):
            d.stop()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedule_one_equals_jax(seed):
    pair = ScalarPair(seed)
    try:
        steps = pair.step_all()
        assert steps == len(pair.pending_names)
        assert pair.t.log == pair.j.log
        assert [p.metadata.name for p in pair.t.held] == [p.metadata.name for p in pair.j.held]
        assert pair.t.held, "no pod was requeued"
        assert pair.bindings(1) == pair.bindings(0)
        # The rejected pods come back and fail again alike (the counts
        # of their FailedScheduling events rise).
        pair.retry()
        pair.step_all()
        assert pair.t.log == pair.j.log
        assert pair.bindings(1) == pair.bindings(0)
        events = pair.events(1)
        assert events == pair.events(0)
        reasons = {r for _, r, _, _ in events}
        assert reasons == {"Scheduled", "FailedScheduling"}
        assert any(c == 2 for _, r, _, c in events if r == "FailedScheduling")
    finally:
        pair.stop()


def test_bindings_in_pop_order_equal_schedule_backlog():
    """The per-pod daemon's bindings, in its pop order, are the batch
    solve's of the same pods in that order on the cluster LISTed
    first."""
    pair = ScalarPair(4, n_pending=48, n_stuck=2)
    try:
        client = Client(LocalTransport(pair.apis[1]))
        pods, _ = client.list("pods", namespace="default")
        nodes, _ = client.list("nodes")
        services, _ = client.list("services", namespace="default")
        pair.step_all()
        order = [name for name, _, _ in pair.t.log]
        by_name = {p.metadata.name: p for p in pods}
        pending = [copy.deepcopy(by_name[n]) for n in order]
        want = schedule_backlog(pending, nodes, [p for p in pods if p.spec.node_name], services,
                                device="cpu")
        got = pair.bindings(1)
        assert [got[n] or None for n in order] == want
        assert want.count(None) >= 2
        assert pair.bindings(0) == got
    finally:
        pair.stop()


def test_lost_bind_records_failed_binding_and_requeues():
    pair = ScalarPair(5, n_pending=1, n_stuck=0)
    try:
        for d, setup in zip((pair.j, pair.t), pair.setups):
            binder = d.config.binder
            real = binder.bind

            def racing(name, node, namespace="default", _real=real, _setup=setup):
                # Another binder wins first: the apiserver answers 409.
                _setup.bind_bulk([(name, "n0")], namespace=namespace)
                return _real(name, node, namespace=namespace)

            binder.bind = racing
        assert pair.step_all() == 1
        assert [p.metadata.name for p in pair.t.held] == ["p0"] == [
            p.metadata.name for p in pair.j.held]
        events = pair.events(1)
        assert events == pair.events(0)
        assert [(n, r) for n, r, _, _ in events] == [("p0", "FailedBinding")]
        # The refetch finds it bound and drops it.
        for d in (pair.j, pair.t):
            d._refetch_and_requeue(d.held[0])
        assert len(pair.tcfg.pod_queue) == 0
    finally:
        pair.stop()


def test_bind_qps_builds_and_consults_the_token_bucket():
    pair = ScalarPair(6, n_pending=5, n_stuck=0, bind_qps=5.0)
    try:
        counts = []
        for cfg in (pair.jcfg, pair.tcfg):
            lim = cfg.bind_limiter
            assert (lim.qps, lim.burst) == (5.0, 20)
            n = [0]
            real = lim.accept

            def counted(_n=n, _real=real):
                _n[0] += 1
                _real()

            lim.accept = counted
            counts.append(n)
        pair.step_all()
        assert counts[0][0] == counts[1][0] == 5
    finally:
        pair.stop()
    assert tdaemon.SchedulerConfig(Client(LocalTransport(APIServer()))).bind_limiter is None


def test_ready_filtered_node_lister_equals_jax():
    pair = ScalarPair(7, n_pending=1, n_stuck=0)
    try:
        names = [[n.metadata.name for n in cfg.node_lister.list()]
                 for cfg in (pair.jcfg, pair.tcfg)]
        assert names[1] == names[0] and "n3" not in names[1] and "n5" not in names[1]
        assert pair.tcfg.node_lister.get("n3").metadata.name == "n3"
        with pytest.raises(KeyError):
            pair.tcfg.node_lister.get("absent")
    finally:
        pair.stop()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_started_scheduler_contains_a_crashed_step(pkg):
    mod = jdaemon if pkg == "jax" else tdaemon
    api = APIServer()
    setup = JClient(JLocalTransport(api))
    rng = np.random.default_rng(8)
    setup.create("nodes", node_wire("n0", rng))
    client = JClient(JLocalTransport(api)) if pkg == "jax" else Client(LocalTransport(api))
    cfg = mod.SchedulerConfig(client).start()
    assert cfg.wait_for_sync()
    real = cfg.algorithm.schedule
    calls = []

    def flaky(pod, lister):
        calls.append(pod.metadata.name)
        if len(calls) == 1:
            raise RuntimeError("a transient fault")
        return real(pod, lister)

    cfg.algorithm.schedule = flaky
    d = mod.Scheduler(cfg).start()
    try:
        setup.create("pods", pod_wire("a", rng, cpu="100m"), namespace="default")
        setup.create("pods", pod_wire("b", rng, cpu="100m"), namespace="default")
        assert wait_until(lambda: setup.get("pods", "b", namespace="default").spec.node_name)
        assert d._thread.is_alive()
        assert not setup.get("pods", "a", namespace="default").spec.node_name
    finally:
        d.stop()


# -- the command's routing ----------------------------------------------------


class Recorder:
    """Stands in for a daemon class: records what it was built with."""

    def __init__(self, kind):
        self.kind = kind

    def __call__(self, config, **kw):
        rec = self

        class Built:
            def start(self):
                return self

            def stop(self):
                pass

        b = Built()
        b.record = (rec.kind, config.raw, config.policy is not None, kw.get("mode"),
                    kw.get("sidecar_path"))
        return b


class FakeConfig:
    def __init__(self, client, provider_name="", policy=None, raw_scheduled_cache=False):
        self.raw, self.policy = raw_scheduled_cache, policy

    def start(self):
        return self

    def wait_for_sync(self, timeout=10.0):
        return True


class FakeHA:
    def __init__(self, client, lock_name, identity, factory):
        self.lock_name, self.identity, self.factory = lock_name, identity, factory

    def start(self):
        return ("ha", self.lock_name, self.identity, self.factory().record)


def _combos():
    out = []
    for batch, full, inc, mode, policy, sidecar, leader in itertools.product(
            (False, True), (False, True), (False, True), ("scan", "wave", "auto"),
            (False, True), (False, True), (False, True)):
        flags = (["--batch"] * batch + ["--batch-full-relower"] * full
                 + ["--batch-incremental"] * inc + ["--batch-mode", mode]
                 + ["--policy-config-file", "{policy}"] * policy
                 + ["--solver-sidecar", "/tmp/solver.sock"] * sidecar
                 + ["--leader-elect", "--leader-elect-identity", "me"] * leader)
        out.append(flags)
    return out


COMBOS = _combos()


@pytest.mark.parametrize("flags", COMBOS, ids=[" ".join(f) for f in COMBOS])
def test_command_routes_as_jax(flags, tmp_path, monkeypatch):
    from kubernetes_tpu.cmd import daemons as jcmd
    from kubernetes_tpu.utils import leaderelect as jle
    from kubernetes_tpu_torch.cmd import scheduler as tcmd
    from kubernetes_tpu_torch.utils import leaderelect as tle

    policy = tmp_path / "policy.json"
    policy.write_text(json.dumps(workload.FULL_VOCABULARY_POLICY))
    argv = [f.format(policy=policy) for f in flags]
    for mod, le in ((jdaemon, jle), (tdaemon, tle)):
        for name in ("Scheduler", "BatchScheduler", "IncrementalBatchScheduler"):
            monkeypatch.setattr(mod, name, Recorder(name))
        monkeypatch.setattr(mod, "SchedulerConfig", FakeConfig)
        monkeypatch.setattr(le, "HAHotStandby", FakeHA)

    def outcome(start):
        try:
            got = start()
        except SystemExit as e:
            return ("exit", str(e))
        return got if isinstance(got, tuple) else got.record

    want = outcome(lambda: jcmd.start_scheduler(jcmd.scheduler_parser().parse_args(argv),
                                                client=object()))
    got = outcome(lambda: tcmd.start_scheduler(
        tcmd.scheduler_parser().parse_args(argv + ["--device", "cpu"]), client=object()))
    assert got == want
