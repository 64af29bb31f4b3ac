"""The port's full re-lower `BatchScheduler` decides as the JAX one does.

Twin apiservers (the JAX package's `APIServer`) are seeded with the
same objects, as in `tests/test_torch_daemon.py`: the JAX
`BatchScheduler` drives one, the port's (`device="cpu"`, a typed
scheduled-pods cache) the other, neither started, so each tick is one
synchronous `schedule_batch()`. After every tick the tick sizes and the
capacity monitor's snapshot (but for Sinkhorn, whose decisions agree
to 99%), and after each batch of operations the bindings pod for pod
and the event counts, must be equal. Rejected pods are handed back by the test
through each daemon's own `_refetch_and_requeue`. Routes: the scan, the
wave and a lowerable policy (exact); Sinkhorn (99% of the decisions, its
stated tolerance); a policy with no device lowering (the scalar path,
exact); gangs and a priority burst with preemption; and the port's
sidecar, served in a thread on the CPU, against the JAX daemon solving
in process. A failing solve or sidecar is counted, raised, never solved
on the scalar path, and stops a started daemon.
"""

import os
import shutil
import tempfile
import threading

import numpy as np
import pytest

from kubernetes_tpu.client import Client as JClient
from kubernetes_tpu.client import LocalTransport as JLocalTransport
from kubernetes_tpu.scheduler import plugins as jplugins
from kubernetes_tpu.scheduler.daemon import BatchScheduler as JBatch
from kubernetes_tpu.scheduler.daemon import SchedulerConfig as JConfig
from kubernetes_tpu.server.api import APIServer
from kubernetes_tpu.utils import capacity as jcapmod
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.client.rest import Client, LocalTransport
from kubernetes_tpu_torch.models.objects import POD_GROUP_LABEL
from kubernetes_tpu_torch.ops import sidecar
from kubernetes_tpu_torch.ops.sidecar import SidecarError
from kubernetes_tpu_torch.scheduler import plugins
from kubernetes_tpu_torch.scheduler.daemon import BatchScheduler, SchedulerConfig
from kubernetes_tpu_torch.utils import capacity as capmod
from tests.test_torch_daemon import (  # noqa: F401 (the module's fixtures)
    N_NODES,
    N_PODS,
    Pair,
    _one_torch_thread,
    fresh_capacity_monitors,
    node_wire,
    pod_wire,
    service_wire,
    wait_until,
)


def _avoid_zone(args):
    def fits(pod, pods_on_node, node_name):
        return (args.node_lister.get(node_name).metadata.labels or {}).get("zone") != "z2"

    return fits


#: A policy with a custom predicate: it has no device lowering, so both
#: daemons run the configured plugins on their scalar paths.
UNLOWERABLE = {
    "kind": "Policy",
    "predicates": [{"name": "PodFitsResources"}, {"name": "PodFitsPorts"},
                   {"name": "MatchNodeSelector"}, {"name": "AvoidZoneZ2"}],
    "priorities": [{"name": "LeastRequestedPriority", "weight": 2},
                   {"name": "ServiceSpreadingPriority", "weight": 1}],
}
plugins.register_fit_predicate("AvoidZoneZ2", _avoid_zone)
jplugins.register_fit_predicate("AvoidZoneZ2", _avoid_zone)


def policy_node_wire(name, j, rng):
    """`node_wire` labelled as `workload.policy_objects` labels nodes:
    rack, ssd, retiring, and no zone on every eleventh."""
    node = node_wire(name, rng)
    labels = node["metadata"]["labels"]
    labels["rack"] = f"r{j % 10}"
    if j % 3 == 0:
        labels["ssd"] = "true"
    if j % 17 == 0:
        labels["retiring"] = "soon"
    if j % 11 == 0:
        del labels["zone"]
    return node


class BatchPair(Pair):
    """The JAX `BatchScheduler` on one apiserver and the port's on the
    other, both fed the same operations."""

    def __init__(self, seed=0, n_nodes=N_NODES, n_pods=N_PODS, services=2, max_batch=256,
                 policy=None, mode="scan", labelled=False, sidecar_path=None, **daemon_kw):
        self.apis = [APIServer(), APIServer()]
        self.setups = [JClient(JLocalTransport(a)) for a in self.apis]
        rng = np.random.default_rng(seed)
        nodes = [policy_node_wire(f"n{j}", j, rng) if labelled else node_wire(f"n{j}", rng)
                 for j in range(n_nodes)]
        pods = [pod_wire(f"p{i}", rng) for i in range(n_pods)]
        for c in self.setups:
            for s in range(services):
                c.create("services", service_wire(f"s{s}", f"a{s}"), namespace="default")
            for n in nodes:
                c.create("nodes", n)
            if pods:
                c.create_bulk("pods", pods, namespace="default")
        self.jcfg = JConfig(JClient(JLocalTransport(self.apis[0])), policy=policy).start()
        self.tcfg = SchedulerConfig(Client(LocalTransport(self.apis[1])), policy=policy,
                                    raw_scheduled_cache=False).start()
        assert self.jcfg.wait_for_sync() and self.tcfg.wait_for_sync()
        # A window long enough that a loaded host never cuts one tick
        # short on one side only.
        kw = dict(max_batch=max_batch, batch_window=0.2, mode=mode, **daemon_kw)
        self.j = JBatch(self.jcfg, **kw)
        self.t = BatchScheduler(self.tcfg, sidecar_path=sidecar_path,
                                device=None if sidecar_path else "cpu", **kw)
        self.j._record_decisions = lambda *a, **k: None
        self.compare_capacity = mode != "sinkhorn"
        for d, cfg in ((self.j, self.jcfg), (self.t, self.tcfg)):
            d.CAPACITY_IDLE_REFRESH_S = 0.0
            d.held = []
            d._requeue_many = lambda pods, epoch=None, _d=d: _d.held.extend(pods)
            d.deltas = 0

            def counted(kind, etype, obj, _d=d):
                _d.deltas += 1

            cfg.cluster_events = counted

    def reconcile(self):
        """Settle, then read each pod lister once: a bound pod's
        assumption is dropped only by a lister read that finds it in
        the scheduled-pods cache, so a pod deleted before any such read
        would stay assumed for the TTL, on one side or both, by timing."""
        self.settle()
        for cfg in (self.jcfg, self.tcfg):
            cfg.pod_lister.list()

    def assert_same(self, share=1.0):
        jb, tb = self.bindings(0), self.bindings(1)
        assert jb.keys() == tb.keys()
        same = sum(jb[n] == tb[n] for n in jb)
        assert same >= share * len(jb), f"{len(jb) - same} of {len(jb)} bindings differ"
        if share == 1.0:
            assert self.events(0) == self.events(1)
        return jb


@pytest.fixture
def batch_pair():
    made = []

    def make(**kw):
        made.append(BatchPair(**kw))
        return made[-1]

    yield make
    for p in made:
        p.stop()


@pytest.mark.parametrize("mode", ["scan", "wave"])
def test_backlog_ticks_match_jax(batch_pair, mode):
    pair = batch_pair(seed=21, mode=mode)
    assert pair.tick_all() == 3  # 600 pods at max_batch 256
    bound = pair.assert_same()
    assert sum(bool(v) for v in bound.values()) > N_PODS // 2
    assert pair.t.mode == mode
    assert pair.t.device_errors == 0 and pair.j.fallback_count == 0
    # Deletes, a new node and more pods: the next ticks re-lower all.
    pair.reconcile()
    for name in sorted(n for n, v in bound.items() if v)[::4]:
        pair.each("delete", "pods", name, namespace="default")
    pair.each("create", "nodes", node_wire("late0", np.random.default_rng(22)))
    pair.retry()
    rng = np.random.default_rng(23)
    pair.each("create_bulk", "pods", [pod_wire(f"q{i}", rng) for i in range(120)],
              namespace="default")
    pair.tick_all()
    pair.assert_same()


def test_sinkhorn_ticks_match_jax_within_its_tolerance(batch_pair):
    pair = batch_pair(seed=24, mode="sinkhorn", max_batch=1024)
    pair.tick_all()
    bound = pair.assert_same(share=0.99)
    assert sum(bool(v) for v in bound.values()) > N_PODS // 2
    assert pair.t.device_errors == 0 and pair.j.fallback_count == 0


@pytest.mark.parametrize("policy,mode,want", [
    (None, "auto", "scan"), (None, "sinkhorn", "sinkhorn"),
    (workload.FULL_VOCABULARY_POLICY, "wave", "scan"),
    (workload.FULL_VOCABULARY_POLICY, "sinkhorn", "scan"),
    (UNLOWERABLE, "wave", "wave"),
])
def test_modes_resolve_as_jax(policy, mode, want):
    """`auto` is the scan on one card; a lowerable policy forces a
    windowed mode to the policy scan; the scalar route keeps the mode
    it was given, as the JAX daemon does."""
    api = APIServer()
    daemons = [JBatch(JConfig(JClient(JLocalTransport(api)), policy=policy), mode=mode),
               BatchScheduler(SchedulerConfig(Client(LocalTransport(api)), policy=policy),
                              mode=mode, device="cpu")]
    assert [d.mode for d in daemons] == [want, want]
    assert daemons[0].policy_scalar == daemons[1].policy_scalar == (policy is UNLOWERABLE)


def test_lowerable_policy_matches_jax(batch_pair):
    """`FULL_VOCABULARY_POLICY` runs on the policy scan."""
    pair = batch_pair(seed=25, policy=workload.FULL_VOCABULARY_POLICY, labelled=True)
    assert not pair.t.policy_scalar and pair.t.spec is not None
    pair.tick_all()
    bound = pair.assert_same()
    assert sum(bool(v) for v in bound.values()) > N_PODS // 2
    retiring = {f"n{j}" for j in range(N_NODES) if j % 17 == 0}
    assert not any(v in retiring for v in bound.values())
    rng = np.random.default_rng(26)
    pair.each("create_bulk", "pods", [pod_wire(f"q{i}", rng) for i in range(100)],
              namespace="default")
    pair.tick_all()
    pair.assert_same()
    assert pair.j.fallback_count == 0


def test_unlowerable_policy_runs_the_scalar_path_as_jax(batch_pair):
    pair = batch_pair(seed=27, n_pods=300, policy=UNLOWERABLE)
    assert pair.t.policy_scalar and pair.j.policy_scalar and pair.t.device is None
    pair.tick_all()
    bound = pair.assert_same()
    zone = {n["metadata"]["name"]: n["metadata"]["labels"].get("zone")
            for n in pair.apis[1].list("nodes", "")["items"]}
    assert any(bound.values()) and not any(zone[v] == "z2" for v in bound.values() if v)


def test_gangs_match_jax(batch_pair):
    pair = batch_pair(seed=28, n_nodes=16, n_pods=40)
    pair.tick_all()
    pair.assert_same()
    rng = np.random.default_rng(29)
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


def test_priority_burst_preempts_as_jax(batch_pair):
    pair = batch_pair(seed=30, n_nodes=8, n_pods=0, services=0, eviction_grace_seconds=30)
    rng = np.random.default_rng(31)
    pair.each("create_bulk", "pods", [pod_wire(f"low{i}", rng, cpu="500m")
                                      for i in range(8 * 16)], namespace="default")
    pair.tick_all()
    pair.assert_same()
    pair.each("create_bulk", "pods", [pod_wire(f"hi{i}", rng, priority=100, cpu="1500m")
                                      for i in range(6)], namespace="default")
    # The preempting tick samples the caches as its own evictions and
    # nominations come back through the watch: its snapshot follows
    # timing. Both are compared once the caches hold them, on an idle
    # tick whose sample starts both monitors afresh (the trend ring
    # would keep the preempting tick's samples).
    pair.compare_capacity = False
    pair.tick_all()
    pair.assert_same()
    pair.settle()
    jcapmod.DEFAULT.reset()
    capmod.DEFAULT.reset()
    assert pair.j.schedule_batch(timeout=0.05) == pair.t.schedule_batch(timeout=0.05) == 0
    assert pair.assert_capacity_same()["stranded_node_count"] > 0

    def evicted(k):
        return sorted(p["metadata"]["name"] for p in pair.apis[k].list("pods", "default")["items"]
                      if p["metadata"].get("deletionTimestamp"))

    assert evicted(0) == evicted(1) and evicted(1)
    assert {k: v[:2] for k, v in pair.j._nominations.items()} == {
        k: v[:2] for k, v in pair.t._nominations.items()} != {}
    assert pair.events(0).get("Preempted") == pair.events(1).get("Preempted")


@pytest.fixture
def served_sidecar():
    """The port's sidecar served on the CPU in a thread, its socket in
    a short temporary directory."""
    root = tempfile.mkdtemp(prefix="ktt")
    path = os.path.join(root, "s.sock")
    stop = threading.Event()
    thread = threading.Thread(target=sidecar.serve, args=(path,),
                              kwargs={"device": "cpu", "stop": stop}, daemon=True)
    thread.start()
    assert wait_until(lambda: os.path.exists(path), timeout=10)
    yield path
    stop.set()
    thread.join(timeout=10)
    shutil.rmtree(root, ignore_errors=True)


def test_sidecar_route_matches_jax_in_process(batch_pair, served_sidecar):
    pair = batch_pair(seed=32, n_pods=400, sidecar_path=served_sidecar)
    assert pair.t.sidecar is not None and pair.t.device is None
    pair.tick_all()
    bound = pair.assert_same()
    assert sum(bool(v) for v in bound.values()) > 200
    assert pair.t.sidecar.last_kernel_launches is not None


def test_device_and_sidecar_errors_raise_and_are_counted(batch_pair, tmp_path):
    pair = batch_pair(seed=33, n_pods=50)
    pair.settle()

    def broken(*args, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    pair.t._solve = broken
    with pytest.raises(RuntimeError, match="illegal memory access"):
        pair.t.schedule_batch(timeout=0.05)
    assert pair.t.device_errors == 1 and not any(pair.bindings(1).values())

    api = APIServer()
    setup = JClient(JLocalTransport(api))
    setup.create("nodes", node_wire("n0", np.random.default_rng(34)))
    setup.create("pods", pod_wire("x", np.random.default_rng(35)), namespace="default")
    cfg = SchedulerConfig(Client(LocalTransport(api)), raw_scheduled_cache=False).start()
    assert cfg.wait_for_sync()
    daemon = BatchScheduler(cfg, sidecar_path=str(tmp_path / "absent.sock"))
    with pytest.raises(SidecarError):
        daemon.schedule_batch(timeout=0.5)
    assert daemon.device_errors == 1
    assert not setup.get("pods", "x", namespace="default").spec.node_name
    # Started, the daemon stops at the next failure.
    setup.create("pods", pod_wire("y", np.random.default_rng(36)), namespace="default")
    daemon.start()
    try:
        assert wait_until(lambda: not daemon._thread.is_alive())
        assert daemon.device_errors == 2
    finally:
        daemon.stop()
    assert not setup.get("pods", "y", namespace="default").spec.node_name


@pytest.mark.parametrize("flags,want", [
    ([], "scalar"),
    (["--batch"], "incremental"),
    (["--batch", "--batch-mode", "auto"], "incremental"),
    (["--batch", "--batch-full-relower"], "full"),
    (["--batch", "--policy-config-file", "{policy}"], "full"),
    (["--policy-config-file", "{unlowerable}"], "scalar"),
    (["--batch", "--solver-sidecar", "{socket}"], "full"),
    (["--batch", "--batch-mode", "wave", "--solver-sidecar", "{socket}"], "full"),
    (["--batch-incremental"], "incremental"),
    (["--batch-incremental", "--policy-config-file", "{policy}"], "exit"),
    (["--batch-incremental", "--solver-sidecar", "{socket}"], "exit"),
])
def test_command_routes_each_flag_combination(tmp_path, flags, want):
    """`cmd/scheduler.py` boots what the JAX command boots for each
    combination (without a batch flag the per-pod scheduler): the
    daemon's class, route, mode and the cache form it is given."""
    import json

    from kubernetes_tpu_torch.cmd import scheduler as cmd
    from kubernetes_tpu_torch.scheduler.daemon import (
        BatchScheduler,
        IncrementalBatchScheduler,
        Scheduler,
    )

    paths = {"policy": tmp_path / "policy.json", "unlowerable": tmp_path / "custom.json",
             "socket": tmp_path / "s.sock"}
    paths["policy"].write_text(json.dumps(workload.FULL_VOCABULARY_POLICY))
    paths["unlowerable"].write_text(json.dumps(UNLOWERABLE))
    argv = [f.format(**paths) for f in flags] + ["--device", "cpu", "--prewarm-buckets", "0"]
    args = cmd.scheduler_parser().parse_args(argv)
    if want == "exit":
        with pytest.raises(SystemExit, match="default policy only"):
            cmd.start_scheduler(args, client=Client(LocalTransport(APIServer())))
        return
    assert cmd.route(args) == want
    daemon = cmd.start_scheduler(args, client=Client(LocalTransport(APIServer())))
    try:
        if want == "scalar":
            assert type(daemon) is Scheduler and not isinstance(daemon, BatchScheduler)
            assert daemon.config.raw_scheduled_cache is False
            return
        incremental = isinstance(daemon, IncrementalBatchScheduler)
        assert incremental == (want == "incremental")
        assert daemon.config.raw_scheduled_cache == incremental
        assert daemon.mode == ("wave" if "wave" in flags else "scan")
        assert (daemon.sidecar is not None) == ("--solver-sidecar" in flags)
        assert daemon.policy_scalar == ("{unlowerable}" in flags)
        on_card = not daemon.policy_scalar and daemon.sidecar is None
        assert (daemon.device is not None) == on_card
    finally:
        daemon.stop()
