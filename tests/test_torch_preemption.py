"""The port's preemption equals the JAX package's and the scalar rule.

Four paths decide the same preemptors on the same objects: the port's
`solve_preemption(device="cpu")` (through `preempt_backlog`), the JAX
package's device path (`preempt_backlog_tpu`, XLA on the CPU), the JAX
package's scalar yardstick and the port's copy of it. Decisions (node
and victims in eviction order) must be equal on every case. The
problem arrays and the per-node prefixes equal the JAX package's; the
gang guard equals its. One case shows where the JAX device path's f32
prefix sums split from the scalar rule, and that the port does not."""

import random

import numpy as np
import pytest
import torch

from kubernetes_tpu.models import objects as jobjects
from kubernetes_tpu.ops.preemption import build_preemption_problem as jbuild
from kubernetes_tpu.ops.preemption import candidate_prefixes_device as jprefixes
from kubernetes_tpu.ops.preemption import _selector_ok as jselector_ok
from kubernetes_tpu.scheduler.batch import preempt_backlog_scalar as jscalar
from kubernetes_tpu.scheduler.batch import preempt_backlog_tpu as jdevice
from kubernetes_tpu.scheduler.gang import GangGroup as JGangGroup
from kubernetes_tpu.scheduler.gang import drop_partial_gang_preemptions as jdrop
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.models import objects
from kubernetes_tpu_torch.models.objects import (
    POD_GROUP_LABEL,
    Container,
    Node,
    NodeCondition,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodSpec,
    ResourceRequirements,
)
from kubernetes_tpu_torch.models.quantity import Quantity, parse_quantity
from kubernetes_tpu_torch.ops import preemption
from kubernetes_tpu_torch.ops.preemption import (
    INFEASIBLE,
    PreemptionDecision,
    build_preemption_problem,
    candidate_prefixes,
)
from kubernetes_tpu_torch.scheduler.batch import preempt_backlog, preempt_backlog_scalar
from kubernetes_tpu_torch.scheduler.gang import GangGroup, drop_partial_gang_preemptions
from tests.test_solver_parity import TestPreemptionParity
from tests.torch_ktsan import torch_ktsan_guard  # noqa: F401 (runs the file sanitized)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _key(decisions):
    return [(d.key, d.node, d.victims) if d else None for d in decisions]


def _four_paths(preemptors, nodes, assigned):
    port = _key(preempt_backlog(preemptors, nodes, assigned, device="cpu"))
    paths = {
        "jax device": _key(jdevice(preemptors, nodes, assigned)),
        "jax scalar": _key(jscalar(preemptors, nodes, assigned)),
        "port scalar": _key(preempt_backlog_scalar(preemptors, nodes, assigned)),
    }
    for name, got in paths.items():
        for i, (a, b) in enumerate(zip(port, got)):
            assert a == b, f"preemptor #{i}: port {a} != {name} {b}"
    return port


def _node(name, cpu, mem_mib=8192, pods=10, labels=None, ready=True):
    return Node(
        metadata=ObjectMeta(name=name, labels=dict(labels or {})),
        status=NodeStatus(
            capacity={"cpu": Quantity.from_milli(cpu), "memory": parse_quantity(f"{mem_mib}Mi"),
                      "pods": Quantity.from_int(pods)},
            conditions=[NodeCondition(type="Ready", status="True" if ready else "False")],
        ),
    )


def _pod(name, cpu=100, mem_mib=64, priority=None, node="", labels=None):
    return Pod(
        metadata=ObjectMeta(name=name, namespace="default", labels=dict(labels or {})),
        spec=PodSpec(
            containers=[Container(name="c", resources=ResourceRequirements(limits={
                "cpu": Quantity.from_milli(cpu), "memory": parse_quantity(f"{mem_mib}Mi")}))],
            node_name=node, priority=priority,
        ),
    )


def test_priority_helpers_equal_the_jax_packages():
    assert objects.PREEMPT_LOWER_PRIORITY == jobjects.PREEMPT_LOWER_PRIORITY
    assert objects.PREEMPT_NEVER == jobjects.PREEMPT_NEVER
    assert objects.REBALANCE_DEST_ANNOTATION == jobjects.REBALANCE_DEST_ANNOTATION
    assert preemption.INFEASIBLE == np.int32(2**31 - 1)
    from kubernetes_tpu.ops.preemption import REASON_INFEASIBLE

    assert preemption.REASON_INFEASIBLE == REASON_INFEASIBLE
    pods = [_pod("a"), _pod("b", priority=7), _pod("c", priority=-3)]
    pods[1].metadata.namespace = ""
    pods[1].spec.preemption_policy = "Never"
    pods[2].metadata.deletion_timestamp = "2026-01-01T00:00:00Z"
    pods[2].spec.preemption_policy = "PreemptLowerPriority"
    for p in pods:
        for name in ("pod_priority", "pod_full_key", "pod_can_preempt", "pod_is_terminating"):
            assert getattr(objects, name)(p) == getattr(jobjects, name)(p), (name, p.metadata.name)
    d = PreemptionDecision("default/a", "n0", ("default/v",))
    assert d.to_wire() == {"pod": "default/a", "node": "n0", "victims": ["default/v"]}


def _same_problem(got, want):
    for field in ("node_names", "node_labels", "victim_keys"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("node_ready", "free_cpu", "free_mem", "free_pods", "v_cpu", "v_mem", "v_prio",
                  "v_node"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), field


@pytest.mark.parametrize("seed", range(8))
def test_build_preemption_problem_equals_jax(seed):
    preemptors, nodes, assigned = TestPreemptionParity._random_preemption_problem(seed)
    _same_problem(build_preemption_problem(nodes, assigned), jbuild(nodes, assigned))


def test_build_preemption_problem_equals_jax_on_port_objects():
    preemptors, nodes, assigned = workload.preemption_objects(40, 400, 8, seed=1)
    _same_problem(build_preemption_problem(nodes, assigned), jbuild(nodes, assigned))


@pytest.mark.parametrize("seed", range(40))
def test_four_paths_agree_on_random_clusters(seed):
    _four_paths(*TestPreemptionParity._random_preemption_problem(seed))


@pytest.mark.parametrize("seed", range(8))
def test_the_port_generator_is_the_jax_tests(seed):
    """`workload.random_preemption_problem` (what chip_smoke.py runs)
    draws the JAX test's clusters: the same problem arrays, the same
    decisions."""
    port = workload.random_preemption_problem(seed)
    jax = TestPreemptionParity._random_preemption_problem(seed)
    _same_problem(build_preemption_problem(port[1], port[2]), jbuild(jax[1], jax[2]))
    assert _four_paths(*port) == _key(jscalar(*jax))


def test_four_paths_agree_on_a_medium_cluster():
    """200 nodes filled to 85-100%, 2,000 bound pods, 32 preemptors."""
    preemptors, nodes, assigned = workload.preemption_objects(200, 2000, 32, seed=5)
    decisions = _four_paths(preemptors, nodes, assigned)
    granted = [d for d in decisions if d]
    assert len(granted) > 10 and any(len(d[2]) > 1 for d in granted)
    assert len({d[1] for d in granted}) > 1


@pytest.mark.parametrize("seed", range(6))
def test_candidate_prefixes_equal_jax(seed):
    """Per-node minimal prefix lengths and the last victim's priority of
    each preemptor against the cluster as built (no grants between)."""
    preemptors, nodes, assigned = TestPreemptionParity._random_preemption_problem(seed)
    problem = build_preemption_problem(nodes, assigned)
    state = preemption._State(problem, torch.device("cpu"))
    alive = np.ones(len(problem.victim_keys), bool)
    for pod in preemptors:
        cpu, mem = preemption._pod_request(pod)
        prio = objects.pod_priority(pod)
        ok = jselector_ok(problem, pod)
        assert np.array_equal(preemption._selector_ok(problem, pod), ok)
        assert np.array_equal(state.node_ok(pod).numpy(), ok)
        want_k, want_p, _, _ = jprefixes(
            problem.v_cpu, problem.v_mem, problem.v_prio, problem.v_node, alive,
            problem.free_cpu, problem.free_mem, problem.free_pods, ok, cpu, mem, prio)
        k, p, _, _ = candidate_prefixes(state, torch.from_numpy(ok), cpu, mem, prio)
        assert np.array_equal(k.numpy(), want_k.astype(np.int64))
        assert np.array_equal(p.numpy(), want_p.astype(np.int64))
        assert (k.numpy() < int(INFEASIBLE)).sum() == (want_k < int(INFEASIBLE)).sum()


def test_exact_freed_capacity_past_f32():
    """Freed capacity is summed exactly. One node holds a 2^25 m victim,
    so the JAX device path's f32 running sum over the whole victim axis
    stops counting every integer at the next node: there a 499 m victim
    reads as 500 m and alone seems to free the 500 m asked. The scalar
    rule (and the port) need both of that node's victims."""
    nodes = [_node("big", 40_000_000), _node("n1", 1000)]
    assigned = [_pod("huge", 2**25, priority=5, node="big"),
                _pod("b", 499, priority=1, node="n1"),
                _pod("c", 501, priority=1, node="n1")]
    preemptors = [_pod("hi", 500, mem_mib=0, priority=10)]
    port = _key(preempt_backlog(preemptors, nodes, assigned, device="cpu"))
    assert port == [("default/hi", "n1", ("default/b", "default/c"))]
    assert port == _key(jscalar(preemptors, nodes, assigned))
    assert port == _key(preempt_backlog_scalar(preemptors, nodes, assigned))
    assert _key(jdevice(preemptors, nodes, assigned)) == [("default/hi", "n1", ("default/b",))]


# -- the JAX package's TestVictimSelection cases, on port objects ---------


def test_minimal_prefix_lowest_priority_first():
    node = _node("n0", 1000)
    a, b, c = _pod("a", 400, priority=10, node="n0"), _pod("b", 400, priority=5, node="n0"), \
        _pod("c", 200, priority=20, node="n0")
    hi = _pod("hi", 500, priority=100)
    (dec,) = _four_paths([hi], [node], [a, b, c])
    # b (prio 5) alone frees 400 < 500; b + a frees 800 >= 500.
    assert dec == ("default/hi", "n0", ("default/b", "default/a"))


def test_no_domination_never_grants():
    node = _node("n0", 1000)
    a = _pod("a", 900, priority=100, node="n0")
    same = _pod("same", 500, priority=100)
    zero = _pod("zero", 500)
    assert _four_paths([same, zero], [node], [a]) == [None, None]


def test_never_policy_opts_out():
    node = _node("n0", 1000)
    a = _pod("a", 900, node="n0")
    hi = _pod("hi", 500, priority=100)
    hi.spec.preemption_policy = "Never"
    assert _four_paths([hi], [node], [a]) == [None]


def test_fitting_node_is_not_a_preemption_case():
    hi = _pod("hi", 500, priority=100)
    assert _four_paths([hi], [_node("n0", 4000)], []) == [None]


def test_terminating_victims_not_chosen_again():
    a = _pod("a", 900, node="n0")
    a.metadata.deletion_timestamp = "2026-01-01T00:00:00Z"
    hi = _pod("hi", 500, priority=100)
    assert _four_paths([hi], [_node("n0", 1000)], [a]) == [None]


def test_node_ranking_prefers_cheapest_victims():
    expensive = _pod("expensive", 900, priority=50, node="n0")
    cheap = _pod("cheap", 900, priority=1, node="n1")
    hi = _pod("hi", 500, priority=100)
    (dec,) = _four_paths([hi], [_node("n0", 1000), _node("n1", 1000)], [expensive, cheap])
    assert dec == ("default/hi", "n1", ("default/cheap",))


def test_grants_charge_the_next_preemptor():
    """Two preemptors on one node: the first takes the cheapest victims,
    the second sees the node as the first left it; a selector and a
    not-ready node narrow the choice."""
    nodes = [_node("n0", 2000, labels={"zone": "a"}), _node("n1", 2000, labels={"zone": "b"}),
             _node("n2", 2000, labels={"zone": "a"}, ready=False)]
    assigned = [_pod(f"v{i}", 500, priority=i % 3, node=f"n{i % 3}") for i in range(12)]
    preemptors = [_pod("p0", 900, priority=50), _pod("p1", 900, priority=40),
                  _pod("p2", 1500, priority=60, labels={}), _pod("p3", 600, priority=2)]
    preemptors[2].spec.node_selector = {"zone": "a"}
    decisions = _four_paths(preemptors, nodes, assigned)
    assert all(d is None or d[1] != "n2" for d in decisions)
    assert decisions[2] is not None and decisions[2][1] == "n0"


# -- the gang guard ---------------------------------------------------------


def _gang_pods(specs):
    return [_pod(name, labels={POD_GROUP_LABEL: group} if group else {}) for name, group in specs]


def _both_guards(unbound, candidates, decisions, covered=frozenset(), groups=()):
    jgroups = [JGangGroup(key=g.key, name=g.name, namespace=g.namespace,
                          min_member=g.min_member, bound=g.bound) for g in groups]
    got = drop_partial_gang_preemptions(unbound, candidates, decisions, covered, groups)
    want = jdrop(unbound, candidates, decisions, covered, jgroups)
    assert got == want
    return got


def test_gang_guard_cases():
    g0, g1 = _gang_pods([("g0", "gang"), ("g1", "gang")])
    (solo,) = _gang_pods([("solo", "")])
    d0 = PreemptionDecision("default/g0", "n0", ("default/v0",))
    d1 = PreemptionDecision("default/g1", "n1", ("default/v1",))
    ds = PreemptionDecision("default/solo", "n1", ("default/v1",))
    # Partial gang dropped, the ungrouped pod kept.
    out, dropped = _both_guards([g0, g1, solo], [g0, g1, solo], [d0, None, ds])
    assert out == [None, None, ds] and dropped == ["default/gang"]
    # Whole gang kept.
    assert _both_guards([g0, g1], [g0, g1], [d0, d1]) == ([d0, d1], [])
    # A member in backoff vetoes through minMember, until one is bound.
    group = GangGroup(key="default/gang", name="gang", namespace="default", min_member=3)
    assert _both_guards([g0, g1], [g0, g1], [d0, d1], groups=[group]) == \
        ([None, None], ["default/gang"])
    group.bound = 1
    assert _both_guards([g0, g1], [g0, g1], [d0, d1], groups=[group]) == ([d0, d1], [])
    # A member outside the candidates vetoes unless it is covered.
    assert _both_guards([g0, g1], [g0], [d0]) == ([None], ["default/gang"])
    assert _both_guards([g0, g1], [g0], [d0], covered=frozenset({"default/g1"})) == ([d0], [])


@pytest.mark.parametrize("seed", range(12))
def test_gang_guard_random(seed):
    rng = random.Random(seed)
    pods = _gang_pods([(f"p{i}", rng.choice(["", "g0", "g1", "g2"])) for i in range(rng.randint(1, 20))])
    for p in pods:
        p.metadata.namespace = rng.choice(["default", "", "other"])
    candidates = [p for p in pods if rng.random() < 0.8]
    decisions = [PreemptionDecision(objects.pod_full_key(p), "n0", ()) if rng.random() < 0.7 else None
                 for p in candidates]
    covered = frozenset(objects.pod_full_key(p) for p in pods if rng.random() < 0.1)
    groups = [GangGroup(key=f"{ns}/{g}", name=g, namespace=ns, min_member=rng.randint(0, 6),
                        bound=rng.randint(0, 2))
              for g in ("g0", "g1", "g2") for ns in ("default", "other") if rng.random() < 0.6]
    _both_guards(pods, candidates, decisions, covered, groups)
