"""The port's SolverSession equals the JAX package's, tick by tick.

Every scenario drives a JAX session (`kubernetes_tpu.ops.SolverSession`,
the XLA scan on the CPU) and the port's session (`device="cpu"`, the
plain scan loop) through the same operations on the same objects. After
every tick the results, every column of the host mirror `h` and every
device leaf (`state_to_numpy(dev)` against the JAX session's arrays)
must be exactly equal, dtypes included; an operation that raises
RebuildRequired in one must raise it in the other.

Sessions of up to 128 nodes share one node bucket (N_cap = 128) and
ticks of up to 128 pods one pod bucket, so the JAX side compiles once
per service count."""

import copy
import random

import numpy as np
import pytest
import torch

from kubernetes_tpu.models.objects import (
    AWSElasticBlockStoreVolumeSource,
    GCEPersistentDiskVolumeSource,
    REBALANCE_DEST_ANNOTATION,
    Service,
    ServiceSpec,
    ObjectMeta,
    Volume,
)
from kubernetes_tpu.ops import RebuildRequired as JRebuildRequired
from kubernetes_tpu.ops import SessionGang as JSessionGang
from kubernetes_tpu.ops import SolverSession as JSolverSession
from kubernetes_tpu.scheduler.batch import schedule_backlog_scalar
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.ops import RebuildRequired, SessionGang, SolverSession
from kubernetes_tpu_torch.ops import scan_kernel
from kubernetes_tpu_torch.ops.matrices import state_from_numpy, state_to_numpy
from kubernetes_tpu_torch.scheduler.batch import schedule_backlog
from tests.test_incremental import mknode, mkpod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    several worker processes at once, and W x N tensor operations on
    every core from each of them would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Twin:
    """A JAX session and a port session fed the same operations."""

    def __init__(self, nodes, services=(), assigned=(), **kw):
        self.j = JSolverSession(nodes, services=services, assigned=assigned, **kw)
        self.t = SolverSession(nodes, services=services, assigned=assigned, device="cpu", **kw)
        self.assert_same("build")

    def do(self, op, *args):
        """Apply one operation to both; both return the same value or
        both raise RebuildRequired."""
        try:
            want = getattr(self.j, op)(*args)
        except JRebuildRequired:
            with pytest.raises(RebuildRequired):
                getattr(self.t, op)(*args)
            return RebuildRequired
        got = getattr(self.t, op)(*args)
        assert got == want, f"{op}{args}: port {got} != jax {want}"
        return got

    def add(self, *pods):
        for pod in pods:
            self.do("add_pending", pod)

    def solve(self):
        got = self.do("solve")
        self.assert_same("solve")
        return got

    def assert_same(self, what):
        j, t = self.j, self.t
        assert t.N_cap == j.N_cap and t.S == j.S
        assert t.node_names == j.node_names and t._pod_node == j._pod_node
        assert set(t.h) == set(j.h)
        for k, ref in j.h.items():
            got = t.h[k]
            assert got.dtype == ref.dtype and np.array_equal(got, ref), f"{what}: h[{k!r}]"
        dev = state_to_numpy(t.dev)
        assert set(dev) == set(j.dev)
        for k, leaf in j.dev.items():
            ref = np.asarray(leaf)
            assert dev[k].dtype == ref.dtype and np.array_equal(dev[k], ref), f"{what}: dev[{k!r}]"


def _svc(name, **selector):
    return Service(
        metadata=ObjectMeta(name=name, namespace="default"),
        spec=ServiceSpec(selector=selector),
    )


def _placed_copy(pod, node_name):
    placed = copy.deepcopy(pod)
    placed.spec.node_name = node_name
    placed.status.phase = "Running"
    return placed


class TestSessionBasics:
    """tests/test_incremental.py::TestSessionBasics on both packages."""

    def test_single_tick_matches_jax_and_scalar_oracle(self):
        nodes = [mknode(f"n{i}", cpu_milli=2000) for i in range(4)]
        pods = [mkpod(f"p{i}", cpu=500) for i in range(10)]
        tw = Twin(nodes)
        tw.add(*pods)
        got = dict(tw.solve())
        want = dict(zip([f"default/p{i}" for i in range(10)], schedule_backlog_scalar(pods, nodes)))
        assert got == want

    def test_capacity_spills_to_unschedulable(self):
        tw = Twin([mknode("n0", cpu_milli=1000)])
        tw.add(*[mkpod(f"p{i}", cpu=500) for i in range(3)])
        result = dict(tw.solve())
        assert sum(v is not None for v in result.values()) == 2
        assert result["default/p2"] is None

    def test_occupancy_carries_across_ticks(self):
        tw = Twin([mknode("n0", cpu_milli=1000)])
        tw.add(mkpod("a", cpu=600))
        assert dict(tw.solve()) == {"default/a": "n0"}
        tw.add(mkpod("b", cpu=600))
        assert dict(tw.solve()) == {"default/b": None}

    def test_delete_frees_occupancy(self):
        tw = Twin([mknode("n0", cpu_milli=1000)])
        tw.add(mkpod("a", cpu=600))
        tw.solve()
        assert tw.do("delete_assigned", "default/a")
        assert not tw.do("delete_assigned", "default/a")
        tw.add(mkpod("b", cpu=600))
        assert dict(tw.solve()) == {"default/b": "n0"}

    def test_delete_frees_host_port(self):
        tw = Twin([mknode("n0")])
        tw.add(mkpod("a", host_port=8080))
        tw.solve()
        tw.add(mkpod("b", host_port=8080))
        assert dict(tw.solve()) == {"default/b": None}
        tw.do("delete_assigned", "default/a")
        tw.add(mkpod("c", host_port=8080))
        assert dict(tw.solve()) == {"default/c": "n0"}

    def test_node_upsert_and_remove(self):
        tw = Twin([mknode("n0", cpu_milli=100)], node_capacity=8)
        tw.add(mkpod("a", cpu=500))
        assert dict(tw.solve()) == {"default/a": None}
        tw.do("upsert_node", mknode("n1", cpu_milli=4000))
        tw.add(mkpod("b", cpu=500))
        assert dict(tw.solve()) == {"default/b": "n1"}
        tw.do("remove_node", "n1")
        tw.do("remove_node", "n1")
        tw.add(mkpod("c", cpu=500))
        assert dict(tw.solve()) == {"default/c": None}

    def test_pinned_pod_survives_slot_recycling(self):
        tw = Twin([mknode("n0"), mknode("A")], node_capacity=2)
        tw.add(mkpod("p", node_name="A"))
        tw.do("remove_node", "A")
        tw.do("upsert_node", mknode("B"))  # reuses A's slot
        assert dict(tw.solve()) == {"default/p": None}
        tw.add(mkpod("q", node_name="C"))
        tw.do("remove_node", "B")
        tw.do("upsert_node", mknode("C"))
        assert dict(tw.solve()) == {"default/q": "C"}

    def test_soft_pin_falls_back_to_unpinned(self):
        tw = Twin([mknode("n0"), mknode("n1")])
        moved = mkpod("m")
        moved.metadata.annotations = {REBALANCE_DEST_ANNOTATION: "n1"}
        lost = mkpod("l")
        lost.metadata.annotations = {REBALANCE_DEST_ANNOTATION: "gone"}
        tw.add(moved, lost, mkpod("h", node_name="gone"))
        assert dict(tw.solve()) == {"default/m": "n1", "default/l": "n0", "default/h": None}

    @pytest.mark.parametrize("kind", ["labels", "ports", "volumes"])
    def test_vocab_overflow_raises_at_the_same_operation(self, kind):
        tw = Twin([mknode("n0")], label_words=1, port_words=1, vol_words=1)
        raised = None
        for i in range(40):  # one word holds 32 ids
            if kind == "labels":
                pod = mkpod(f"p{i}", node_selector={f"k{i}": "v"})
            elif kind == "ports":
                pod = mkpod(f"p{i}", host_port=9000 + i)
            else:
                pod = mkpod(f"p{i}")
                pod.spec.volumes = [
                    Volume(name="v", aws_elastic_block_store=AWSElasticBlockStoreVolumeSource(volume_id=f"e{i}"))
                ]
            if tw.do("add_pending", pod) is RebuildRequired:
                raised = i
                break
        assert raised == 32

    def test_node_label_vocab_overflow_raises_on_upsert(self):
        tw = Twin([mknode("n0")], label_words=1, node_capacity=64)
        outcomes = [
            tw.do("upsert_node", mknode(f"m{i}", labels={f"l{i}": "x"})) for i in range(34)
        ]
        assert outcomes.index(RebuildRequired) == 32

    def test_slot_exhaustion_raises_at_the_same_operation(self):
        tw = Twin([mknode(f"n{i}") for i in range(3)], node_capacity=4)
        assert tw.t.N_cap == 128
        outcomes = [tw.do("upsert_node", mknode(f"x{i}")) for i in range(130)]
        assert outcomes.index(RebuildRequired) == 125
        tw.do("remove_node", "x0")
        assert tw.do("upsert_node", mknode("y")) is None  # the freed slot is reused
        tw.add(mkpod("p", node_name="y"))
        assert dict(tw.solve()) == {"default/p": "y"}


def _seeded_churn(seed, mode="scan"):
    """The churn of TestChurnParity.test_seeded_churn on a Twin in `mode`."""
    pending, nodes, assigned, _ = workload.small_cluster(seed)
    services = [_svc(f"s{s}", app=f"a{s}") for s in range(4)] + [_svc("web", tier="web")]
    tw = Twin(nodes[:30], services=services, assigned=assigned, mode=mode)
    rng = random.Random(seed)
    names = [n.metadata.name for n in nodes[:30]]
    pods = list(pending)
    spare = list(nodes[30:]) + [mknode(f"extra{i}", labels={"zone": "b"}) for i in range(3)]
    live = [k for k in tw.t._pod_node]
    for tick in range(5):
        for _ in range(rng.randint(1, 3)):
            op = rng.random()
            if op < 0.3 and spare:
                node = spare.pop()
                tw.do("upsert_node", node)
                names.append(node.metadata.name)
            elif op < 0.5 and len(names) > 3:
                gone = names.pop(rng.randrange(len(names)))
                tw.do("remove_node", gone)
                live = [k for k in live if k in tw.t._pod_node]
            elif op < 0.8 and pods:
                foreign = copy.deepcopy(pods.pop())
                foreign.metadata.name += "-foreign"
                foreign.spec.node_name = rng.choice(names + ["ghost"])
                tw.do("add_assigned", foreign)
                tw.do("add_assigned", foreign)  # idempotent
            else:
                tw.do("upsert_node", mknode(rng.choice(names), cpu_milli=rng.choice([500, 8000])))
        for key in rng.sample(live, min(len(live), rng.randint(0, 6))):
            tw.do("delete_assigned", key)
            live.remove(key)
        batch = [pods.pop() for _ in range(min(len(pods), rng.randint(0, 30)))]
        for i, pod in enumerate(batch):
            if i % 7 == 3:
                pod.spec.node_name = ""
                pod.metadata.annotations = {REBALANCE_DEST_ANNOTATION: rng.choice(names + ["ghost"])}
        tw.add(*batch)
        results = tw.solve()
        if mode != "scan" and results:
            assert tw.t.last_stats == tw.j.last_stats, f"tick {tick}"
        live += [k for k, d in results if d is not None]
        for key, _dest in results:
            tw.do("has_assigned", key)
    return tw


class TestChurnParity:
    def test_churn_replay_matches_jax_and_fresh_solves(self):
        """tests/test_incremental.py::TestChurnParity: after every tick
        both sessions equal a fresh scalar solve from the surviving
        object state, and each other."""
        rng = random.Random(7)
        nodes = [
            mknode(f"n{i}", cpu_milli=rng.choice([2000, 4000]), labels={"zone": f"z{i % 2}"})
            for i in range(6)
        ]
        services = [_svc("svc", app="a")]
        tw = Twin(nodes, services=services)
        live = {}
        counter = 0
        for tick in range(6):
            batch = []
            for _ in range(rng.randrange(2, 6)):
                counter += 1
                pod = mkpod(
                    f"p{counter}",
                    cpu=rng.choice([200, 400, 800]),
                    labels={"app": "a"} if rng.random() < 0.5 else {},
                    node_selector={"zone": "z0"} if rng.random() < 0.3 else {},
                )
                batch.append(pod)
                tw.add(pod)
            for key in rng.sample(sorted(live), min(2, len(live))):
                tw.do("delete_assigned", key)
                del live[key]
            results = dict(tw.solve())
            assigned = [_placed_copy(pod, node) for pod, node in live.values()]
            want = schedule_backlog_scalar(batch, nodes, assigned=assigned, services=services)
            for pod, expect in zip(batch, want):
                key = f"default/{pod.metadata.name}"
                assert results[key] == expect, f"tick {tick}: {key}"
                if expect is not None:
                    live[key] = (pod, expect)

    @pytest.mark.parametrize("seed", range(4))
    def test_seeded_churn(self, seed):
        """Services, selectors, host ports, GCE and EBS volumes, hard and
        soft pins, node upsert and remove (with slot recycling), foreign
        pods by add_assigned (some overcommitting), deletes, and ticks
        of up to 100 pods, against a batch solve of the same state."""
        _seeded_churn(seed)

    @pytest.mark.parametrize("seed", range(4))
    def test_seeded_churn_wave_mode(self, seed):
        """The same churn in wave mode: the port's wave on the occupied
        prefix of the slot axis equals the JAX session's on all of it,
        results, host mirror and device state, tick by tick, and the
        telemetry triple too."""
        tw = _seeded_churn(seed, mode="wave")
        assert tw.t.last_stats == tw.j.last_stats and set(tw.t.last_stats) <= {"waves"}



    def test_add_assigned_overcommit_marks_the_row(self):
        tw = Twin([mknode("n0", cpu_milli=1000)])
        for i, cpu in enumerate((600, 600, 100)):
            assert tw.do("add_assigned", mkpod(f"f{i}", cpu=cpu, node_name="n0"))
        assert not tw.do("add_assigned", mkpod("f9", node_name="nowhere"))
        assert not tw.do("add_assigned", mkpod("f8"))
        assert bool(tw.t.h["over"][0])
        tw.add(mkpod("p", cpu=10))
        assert dict(tw.solve()) == {"default/p": None}
        tw.do("delete_assigned", "default/f1")
        tw.add(mkpod("q", cpu=10))
        assert dict(tw.solve()) == {"default/q": "n0"}


class _FullLaunchSession(SolverSession):
    """A session that launches over all N_cap slots."""

    n_launch = property(lambda self: self.N_cap)


def _cluster(n_nodes=4):
    return [mknode(f"n{j}") for j in range(n_nodes)]


class TestSessionPipeline:
    """tests/test_microtick.py::TestSessionPipeline on both packages,
    plus the port's pipelined churn, prewarm, staging and launch."""

    def test_solve_async_overlaps_deltas_consistently(self):
        tw = Twin(_cluster())
        tw.add(*[mkpod(f"a{i}") for i in range(6)])
        jh, th = tw.j.solve_async(), tw.t.solve_async()
        tw.add(mkpod("late"))
        tw.do("upsert_node", mknode("n1", cpu_milli=3000))  # dirty row mid-flight
        tw.do("delete_assigned", "default/never")
        first = th.result()
        assert first == jh.result() and len(first) == 6 and all(d for _k, d in first)
        assert th.done()
        tw.assert_same("after result")
        second = tw.solve()
        assert [k for k, _d in second] == ["default/late"]
        assert sum(len(l) for l in tw.t._assigned) == len(tw.t._pod_node) == 7
        assert tw.t.solve_async().result() == tw.j.solve_async().result() == []
        tw.assert_same("empty tick")

    def test_solve_async_auto_resolves_previous_tick(self):
        session = SolverSession(_cluster(), device="cpu")
        session.add_pending(mkpod("p0"))
        h1 = session.solve_async()
        assert h1.keys == ["default/p0"]
        session.add_pending(mkpod("p1"))
        h2 = session.solve_async()
        assert h1.done(), "second dispatch must resolve the first tick"
        assert [k for k, _ in h1.result()] == ["default/p0"]
        assert [k for k, _ in h2.result()] == ["default/p1"]

    def test_pipelined_churn_equals_synchronous(self):
        """workload.churn_replay with a tick in flight while the next
        tick's creates and deletes land gives the synchronous run's
        results, and after every result the device rows equal the host
        mirror wherever no delta is pending."""
        pods, nodes, services = workload.synthetic_objects(300, 24, seed=5)
        names = schedule_backlog(pods, nodes, services=services, device="cpu")
        assigned = [_placed_copy(p, n) for p, n in zip(pods, names) if n]
        runs = []
        for pipelined in (False, True):
            session = SolverSession(nodes, services, assigned, node_capacity=30, device="cpu")

            def check(k, results, session=session):
                dev = state_to_numpy(session.dev)
                clean = np.ones(session.N_cap, bool)
                clean[sorted(session._dirty)] = False
                for key, col in session.h.items():
                    assert np.array_equal(dev[key][clean], col[clean]), (k, key)

            ticks = workload.churn_replay(
                session, [f"default/{p.metadata.name}" for p in assigned], ticks=4, rate=30,
                seed=11, n_services=len(services), first_index=300, pipelined=pipelined,
                on_result=check,
            )
            assert all(t.deleted == 30 for t in ticks)
            assert set(ticks[-1].phases_s) >= {"lower", "delete", "upload", "solve", "readback", "commit"}
            runs.append([t.results for t in ticks])
        assert runs[0] == runs[1]
        assert sum(d is not None for tick in runs[0] for _k, d in tick) > 0

    def test_prewarm_leaves_state_untouched_and_counts_like_jax(self):
        tw = Twin(_cluster(), node_capacity=100)
        tw.add(mkpod("a"))
        tw.solve()
        tw.do("delete_assigned", "default/a")  # a dirty row prewarm must not flush
        before = {k: v.clone() for k, v in tw.t.dev.items()}
        h_before = {k: v.copy() for k, v in tw.t.h.items()}
        assert tw.t.prewarm(max_pod_bucket=256, max_scatter_width=64) == tw.j.prewarm(
            max_pod_bucket=256, max_scatter_width=64
        ) == 2 + 4
        assert tw.t.prewarm() == tw.j.prewarm()
        for k in before:
            assert before[k].equal(tw.t.dev[k]) and np.array_equal(h_before[k], tw.t.h[k])
        assert tw.t._dirty == {0}
        tw.add(mkpod("b"))
        tw.solve()

    def test_staged_pods_equal_jax(self):
        """The pod columns a tick uploads: buckets, fills, bitsets,
        pins resolved to slots (hard pin to an unknown node -2, soft pin
        -1), service ids."""
        tw = Twin(_cluster(), services=[_svc("s", app="x"), _svc("t", app="x")], pod_bucket=256)
        pods = [
            mkpod("a", labels={"app": "x"}, node_selector={"zone": "z"}, host_port=80),
            mkpod("b", node_name="n2"),
            mkpod("c", node_name="zz"),
            mkpod("d", cpu=0, mem="0"),
        ]
        pods[2].metadata.annotations = {}
        soft = mkpod("e")
        soft.metadata.annotations = {REBALANCE_DEST_ANNOTATION: "zz"}
        soft.spec.volumes = [
            Volume(name="g", gce_persistent_disk=GCEPersistentDiskVolumeSource(pd_name="pd", read_only=True))
        ]
        tw.add(*pods, soft)
        for reuse in (False, True):
            got = state_to_numpy(tw.t._pod_arrays(tw.t._pending) if reuse else
                                 tw.t._stage_arrays(tw.t._pending, 256, reuse=False))
            ref = tw.j._stage_arrays(tw.j._pending, 256, reuse=False)
            assert set(got) == set(ref)
            for k, leaf in ref.items():
                a = np.asarray(leaf)
                assert got[k].dtype == a.dtype and np.array_equal(got[k], a), k
        tw.solve()

    def test_prefix_launch_equals_full_launch(self, monkeypatch):
        """With 2,048 slots and 40 nodes a tick launches over 1,024
        rows; the same ticks launched over all 2,048 give the same
        results and state, and both equal the JAX session's."""
        pending, nodes, assigned, services = workload.small_cluster(4)
        nodes = nodes + [mknode(f"m{i}") for i in range(40 - len(nodes))]
        tw = Twin(nodes, services=services, assigned=assigned, node_capacity=2048)
        full = _FullLaunchSession(nodes, services, assigned, node_capacity=2048, device="cpu")
        launched = []
        real = scan_kernel.plain_scan_with_state

        def spy(pods, carry, weights):
            launched.append(carry["cpu_cap"].shape[0])
            return real(pods, carry, weights)

        monkeypatch.setattr(scan_kernel, "plain_scan_with_state", spy)
        assert tw.t.N_cap == 2048 and tw.t.n_launch == 1024
        for batch in (pending[:66], pending[66:]):
            tw.add(*batch)
            for pod in batch:
                full.add_pending(pod)
            assert tw.solve() == full.solve()
            dev_full = state_to_numpy(full.dev)
            for k, col in state_to_numpy(tw.t.dev).items():
                assert np.array_equal(col, dev_full[k]), k
        assert launched == [1024, 2048, 1024, 2048]
        tw.do("upsert_node", mknode("late"))
        tw.do("remove_node", nodes[0].metadata.name)
        assert tw.t.n_launch == 1024

    def test_resume_from_jax_state(self):
        """A port session whose device state is the JAX session's leaves
        (N_cap rows, u32 words, f32 counts) through state_from_numpy
        continues exactly as the JAX session does."""
        pending, nodes, assigned, services = workload.small_cluster(6)
        j = JSolverSession(nodes, services=services, assigned=assigned)
        t = SolverSession(nodes, services, assigned, device="cpu")
        for pod in pending[:40]:
            j.add_pending(pod)
        j.solve()
        for pod in pending[:40]:  # the host mirror follows the same tick
            t.add_pending(pod)
        t.solve()
        t.dev = state_from_numpy({}, {k: np.asarray(v) for k, v in j.dev.items()}, device="cpu")[1]
        tw = Twin.__new__(Twin)
        tw.j, tw.t = j, t
        tw.assert_same("resumed")
        tw.add(*pending[40:90])
        for key in list(t._pod_node)[:5]:
            tw.do("delete_assigned", key)
        tw.solve()

    def test_solve_gang_matches_jax(self):
        nodes = [mknode(f"n{j}", cpu_milli=1000) for j in range(3)]
        tw = Twin(nodes)
        tw.add(mkpod("warm", cpu=100))
        tw.solve()
        pods = [mkpod(f"a{i}", cpu=600) for i in range(2)]  # fits: 2 nodes
        pods += [mkpod(f"b{i}", cpu=600) for i in range(3)]  # needs 3 -> rejected
        pods += [mkpod(f"c{i}", cpu=300) for i in range(3)]  # ungrouped
        pods += [mkpod("d0", cpu=50)]  # group with one already bound
        tw.add(*pods)
        gangs = [
            ("default/ga", 2, 0, {"default/a0", "default/a1"}),
            ("default/gb", 3, 0, {"default/b0", "default/b1", "default/b2"}),
            ("default/gd", 2, 1, {"default/d0"}),
        ]
        got = tw.t.solve_gang([SessionGang(k, m, b, frozenset(p)) for k, m, b, p in gangs])
        ref = tw.j.solve_gang([JSessionGang(k, m, b, frozenset(p)) for k, m, b, p in gangs])
        assert got == ref and "default/gb" in got[1]
        assert all(dict(got[0])[f"default/b{i}"] is None for i in range(3))
        tw.assert_same("after solve_gang")
        assert tw.t.solve_gang([]) == tw.j.solve_gang([]) == ([], [])
        tw.solve()

    def test_unported_modes_raise(self):
        """Every mode of the JAX session is ported; a mode it does not
        have raises in both."""
        for mode in ("scan", "wave", "sinkhorn"):
            assert SolverSession(_cluster(), mode=mode, device="cpu").mode == mode
        with pytest.raises(ValueError):
            SolverSession(_cluster(), mode="warp", device="cpu")
        with pytest.raises(ValueError):
            JSolverSession(_cluster(), mode="warp")

    def test_launch_limit_at_session_widths(self):
        """At 4/4/4-word bitsets and 8 service ids a cluster holds
        27,840 node slots resident; a larger prefix runs in place on
        the same 16 CTAs, and only a plan forced to hold it resident is
        refused before any launch, naming the limit."""
        assert scan_kernel.max_nodes(4, 4, 4, 8) == 27840
        plan = scan_kernel.launch_plan(27840, 4, 4, 4, 8)
        assert (plan.cluster, plan.resident) == (16, True)
        plan = scan_kernel.launch_plan(28672, 4, 4, 4, 8)
        assert (plan.cluster, plan.resident) == (16, False)
        with pytest.raises(ValueError, match="27840"):
            scan_kernel.launch_plan(28672, 4, 4, 4, 8, resident=True)


class TestWindowedSessions:
    """The session's windowed modes against the JAX session's."""

    def test_wave_on_the_launch_prefix_equals_jax_on_all_slots(self):
        """2,048 node slots, 40 nodes: the port's wave runs over the
        first 1,024 rows, JAX's over all 2,048; every tick, the host
        mirror and the device state are equal."""
        nodes = [mknode(f"n{j}", cpu_milli=2000, labels={"zone": f"z{j % 3}"}) for j in range(40)]
        tw = Twin(nodes, services=[_svc("svc", app="a")], node_capacity=2048, mode="wave")
        assert tw.t.n_launch == 1024 < tw.t.N_cap == 2048
        for tick in range(3):
            tw.add(*[mkpod(f"t{tick}p{i}", cpu=300, labels={"app": "a"} if i % 2 else {})
                     for i in range(60)])
            results = tw.solve()
            assert sum(d is not None for _, d in results) > 0
            assert tw.t.last_stats == tw.j.last_stats and tw.t.last_stats["waves"] >= 1
            tw.do("delete_assigned", results[0][0])

    @pytest.mark.parametrize("seed", range(3))
    def test_sinkhorn_session_agrees_with_jax(self, seed):
        """Sinkhorn is held within its rounding: per tick the port's
        session names JAX's node for at least 95% of the pods, reports
        the telemetry triple, and its host mirror equals its device
        state."""
        pending, nodes, assigned, _ = workload.small_cluster(seed)
        services = [_svc(f"s{s}", app=f"a{s}") for s in range(4)]
        j = JSolverSession(nodes, services=services, assigned=assigned, mode="sinkhorn")
        t = SolverSession(nodes, services=services, assigned=assigned, mode="sinkhorn",
                          device="cpu")
        pods = list(pending)
        agree = total = 0
        for tick in range(3):
            batch = [pods.pop() for _ in range(min(len(pods), 12))]
            for pod in batch:
                j.add_pending(pod)
                t.add_pending(pod)
            got, want = t.solve(), j.solve()
            assert [k for k, _ in got] == [k for k, _ in want]
            agree += sum(a == b for a, b in zip(got, want))
            total += len(got)
            if got:
                assert set(t.last_stats) == {"waves", "sinkhorn_iters", "sinkhorn_residual"}
            dev = state_to_numpy(t.dev)
            for k, col in t.h.items():
                assert np.array_equal(dev[k], col), f"tick {tick}: dev[{k!r}] != h"
        assert total > 0 and agree / total >= 0.95


def _full_recompute(session, j):
    """Slot j's row recomputed whole from the node's spec and its pods,
    as the session did before it kept each node's constant part: every
    column zeroed, the capacities, labels and readiness read again from
    the spec, then the greedy fit in arrival order with the bitsets
    OR-ed and the service counts added pod by pod. Returns the row of
    every column."""
    from kubernetes_tpu_torch.models.columnar import MIB, bitset, node_is_ready
    from kubernetes_tpu_torch.models.objects import RESOURCE_CPU, RESOURCE_MEMORY, RESOURCE_PODS

    h = {k: np.array(v[j : j + 1]) for k, v in session.h.items()}
    for k in h:
        h[k][0] = 0
    node = session._node_specs[j]
    if node is None:
        return h
    cap = node.status.capacity or {}
    if RESOURCE_CPU in cap:
        h["cpu_cap"][0] = cap[RESOURCE_CPU].milli_value()
    if RESOURCE_MEMORY in cap:
        h["mem_cap"][0] = cap[RESOURCE_MEMORY].value() // MIB
    if RESOURCE_PODS in cap:
        h["pods_cap"][0] = cap[RESOURCE_PODS].value()
    h["labels"][0] = bitset(
        [session._vocab_id(session.label_vocab, session.LW, f"{k}={v}")
         for k, v in (node.metadata.labels or {}).items()],
        session.LW,
    )
    h["sched"][0] = node_is_ready(node)
    for lp in session._assigned[j]:
        fits_cpu = h["cpu_cap"][0] == 0 or h["cpu_fit"][0] + lp.cpu <= h["cpu_cap"][0]
        fits_mem = h["mem_cap"][0] == 0 or h["mem_fit"][0] + lp.mem_mib <= h["mem_cap"][0]
        if fits_cpu and fits_mem:
            h["cpu_fit"][0] += lp.cpu
            h["mem_fit"][0] += lp.mem_mib
        else:
            h["over"][0] = True
        h["cpu_used"][0] += lp.cpu
        h["mem_used"][0] += lp.mem_mib
        h["pods_used"][0] += 1
        h["uport"][0] |= bitset(lp.port_ids, session.PW)
        h["uvol_any"][0] |= bitset(lp.vol_any_ids, session.VW)
        h["uvol_rw"][0] |= bitset(lp.vol_rw_ids, session.VW)
        if len(lp.svc_topk):
            h["svc_counts"][0, lp.svc_topk] += 1.0
    return h


@pytest.mark.parametrize("seed", range(4))
def test_row_recompute_equals_the_full_recompute(seed):
    """Seeded creates (ticks, foreign pods with ports and volumes),
    deletes, node upserts (capacity and label changes) and removals on
    one session: after every operation, every row the operation rebuilt
    equals the full recompute of that row bit for bit, and so does every
    slot at the end."""
    pending, nodes, assigned, _ = workload.small_cluster(seed)
    services = [_svc(f"s{s}", app=f"a{s}") for s in range(4)] + [_svc("web", tier="web")]
    session = SolverSession(nodes[:30], services=services, assigned=assigned, device="cpu")
    rng = random.Random(100 + seed)
    names = [n.metadata.name for n in nodes[:30]]
    pods = list(pending)
    checked = 0

    def check(rows):
        nonlocal checked
        for j in rows:
            want = _full_recompute(session, j)
            for k, col in session.h.items():
                assert col[j : j + 1].dtype == want[k].dtype
                assert np.array_equal(col[j : j + 1], want[k]), f"slot {j}, column {k}"
            checked += 1

    for _ in range(40):
        op = rng.random()
        live = sorted(session._pod_node)
        if op < 0.35 and live:
            key = rng.choice(live)
            j = session._pod_node[key]
            session.delete_assigned(key)
            check([j])
        elif op < 0.55 and pods:
            foreign = copy.deepcopy(pods.pop())
            foreign.metadata.name += "-foreign"
            foreign.spec.node_name = rng.choice(names)
            session.add_assigned(foreign)
            check([session.node_index[foreign.spec.node_name]])
        elif op < 0.7:
            name = rng.choice(names)
            session.upsert_node(mknode(name, cpu_milli=rng.choice([500, 2000, 8000]),
                                       labels={"zone": rng.choice("ab")}))
            check([session.node_index[name]])
        elif op < 0.75 and len(names) > 5:
            gone = names.pop(rng.randrange(len(names)))
            j = session.node_index[gone]
            session.remove_node(gone)
            check([j])
        else:
            for pod in [pods.pop() for _ in range(min(len(pods), 8))]:
                session.add_pending(pod)
            touched = {j for _k, d in session.solve() if d is not None
                       for j in [session.node_index[d]]}
            check(sorted(touched))
    check([j for j in range(session.N_cap) if session.node_names[j] is not None])
    assert checked > 30
