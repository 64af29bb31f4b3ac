"""Policy specs in the port equal the JAX package's, bit for bit.

For every class of `tests/test_policy_lowering.py` (predicate subsets,
weights, labelsPresence present and absent, labelPreference, the five
serviceAffinity cases, serviceAntiAffinity with its zero-weight case,
label-less affinity, the 200 x 40 full vocabulary) and for seeded
random policy clusters, on the CPU:

- the port's `schedule_backlog(spec=...)` gives the JAX package's
  `schedule_backlog_tpu(spec=...)` names (its XLA scan here) and, where
  that suite holds the JAX package to it, `schedule_backlog_scalar`'s;
- the port's `solve_with_state` on the same staged state gives
  `_solve_with_state_xla`'s decisions and post-commit carry, `anchor`
  and `svc_total` included, dtypes included;
- `spec_from_policy`, `spec_from_keys` and `lower_spec` lower the same.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest

import tests.test_policy_lowering as jcases
from kubernetes_tpu.models import algspec as jalgspec
from kubernetes_tpu.models.columnar import build_snapshot as jbuild_snapshot
from kubernetes_tpu.ops import device_snapshot as jdevice_snapshot
from kubernetes_tpu.ops.solver import _solve_with_state_xla
from kubernetes_tpu.scheduler.batch import schedule_backlog_scalar, schedule_backlog_tpu
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.models import algspec
from kubernetes_tpu_torch.ops.matrices import (
    CARRY_KEYS,
    POLICY_CARRY_KEYS,
    state_from_numpy,
    state_to_numpy,
)
from kubernetes_tpu_torch.ops.solver import solve_with_state
from kubernetes_tpu_torch.scheduler.batch import schedule_backlog
from tests.test_solver_parity import mk_node, mk_pod

BASE = jcases.BASE_PREDS
mk_svc = jcases.mk_svc


def _state_parity(policy, pending, nodes, assigned, services):
    """Port solve_with_state vs _solve_with_state_xla on JAX's staging."""
    jspec = jalgspec.spec_from_policy(policy)
    snap = jbuild_snapshot(pending, nodes, assigned, services, spec=jspec)
    d = jdevice_snapshot(snap)
    pods = {k: np.asarray(v) for k, v in d.pods.items()}
    state = {k: np.asarray(v) for k, v in d.nodes.items()}
    rc, rs = _solve_with_state_xla(
        {k: jnp.asarray(v) for k, v in pods.items()},
        {k: jnp.asarray(v) for k, v in state.items()},
        d.weights, d.lowered,
    )
    rc, rs = np.asarray(rc), {k: np.asarray(v) for k, v in rs.items()}
    tp, tn = state_from_numpy(pods, state, device="cpu")
    lspec = algspec.LoweredSpec(*d.lowered)
    gc, gs = solve_with_state(tp, tn, tuple(d.weights), lspec)
    gc, gs = gc.numpy(), state_to_numpy(gs)
    assert gc.dtype == rc.dtype and np.array_equal(gc, rc), (
        f"{int((gc != rc).sum())}/{len(rc)} decisions differ"
    )
    keys = [k for k in CARRY_KEYS + POLICY_CARRY_KEYS if k in rs]
    if lspec.service_affinity or lspec.aa_weights:
        assert set(POLICY_CARRY_KEYS) <= set(keys)
    for k in keys:
        assert gs[k].dtype == rs[k].dtype, f"{k} dtype"
        assert np.array_equal(gs[k], rs[k]), f"carry field {k} differs"
    return gc[: snap.pods.count]


def _assert_policy(policy, pending, nodes, assigned=(), services=(), scalar=True):
    """Names equal the JAX package's (XLA scan, and scalar where its own
    suite requires parity), and the carry equals the XLA scan's."""
    jspec = jalgspec.spec_from_policy(policy)
    got = schedule_backlog(pending, nodes, assigned, services, device="cpu",
                           spec=algspec.spec_from_policy(policy))
    ref = schedule_backlog_tpu(pending, nodes, assigned, services, spec=jspec)
    assert got == ref, [i for i, (a, b) in enumerate(zip(got, ref)) if a != b][:10]
    if scalar:
        assert got == schedule_backlog_scalar(pending, nodes, assigned, services, spec=jspec)
    _state_parity(policy, pending, nodes, assigned, services)
    return got


# -- the spec plumbing ----------------------------------------------------


POLICIES = [jcases.AFFINITY_POLICY, jcases.TestFullVocabularyParity.POLICY,
            *workload.POLICY_SHAPES.values(),
            {"predicates": [{"name": "MyCustomPredicate"}], "priorities": []},
            {"predicates": BASE, "priorities": [
                {"name": "LeastRequestedPriority", "weight": 1},
                {"name": "BalancedResourceAllocation", "weight": 1},
                {"name": "ServiceSpreadingPriority", "weight": 1}]}]


@pytest.mark.parametrize("policy", POLICIES, ids=range(len(POLICIES)))
def test_spec_from_policy_and_lowering_match_jax(policy):
    spec, jspec = algspec.spec_from_policy(policy), jalgspec.spec_from_policy(policy)
    assert repr(spec) == repr(jspec)
    assert spec.is_default() == jspec.is_default()
    try:
        jlowered = jalgspec.lower_spec(jspec)
    except jalgspec.UnloweredPolicyError:
        with pytest.raises(algspec.UnloweredPolicyError):
            algspec.lower_spec(spec)
        return
    lowered = algspec.lower_spec(spec)
    assert tuple(lowered[0]) == tuple(jlowered[0]) and lowered[1] == jlowered[1]


def test_default_spec_and_spec_from_keys_match_jax():
    assert repr(algspec.DEFAULT_SPEC) == repr(jalgspec.DEFAULT_SPEC)
    assert algspec.DEFAULT_SPEC.is_default()
    keys = (["PodFitsResources", "HostName"], {"LeastRequestedPriority": 2})
    assert repr(algspec.spec_from_keys(*keys)) == repr(jalgspec.spec_from_keys(*keys))


def test_default_plus_argumented_priority_is_not_default():
    policy = {"predicates": BASE, "priorities": [
        {"name": "LeastRequestedPriority", "weight": 1},
        {"name": "BalancedResourceAllocation", "weight": 1},
        {"name": "ServiceSpreadingPriority", "weight": 1},
        {"name": "aa", "weight": 2, "argument": {"serviceAntiAffinity": {"label": "zone"}}},
    ]}
    assert not algspec.spec_from_policy(policy).is_default()
    nodes = [mk_node("n0", labels={"zone": "a"}), mk_node("n1", labels={"zone": "b"})]
    pods = [mk_pod(f"p{i}", labels={"app": "w"}) for i in range(4)]
    _assert_policy(policy, pods, nodes, services=[mk_svc("w", {"app": "w"})])


# -- labelsPresence and labelPreference --------------------------------


def _presence(label, presence):
    return {"name": "lp", "argument": {"labelsPresence": {"labels": [label], "presence": presence}}}


@pytest.mark.parametrize("presence", [True, False])
def test_node_label_presence(presence):
    label = "zone" if presence else "retiring"
    nodes = [mk_node("n0", labels={label: "x"}), mk_node("n1")]
    policy = {"predicates": BASE + [_presence(label, presence)],
              "priorities": [{"name": "LeastRequestedPriority", "weight": 1}]}
    got = _assert_policy(policy, [mk_pod(f"p{i}") for i in range(4)], nodes)
    assert set(got) == ({"n0"} if presence else {"n1"})


@pytest.mark.parametrize("case", ["prefers_labeled", "absence_with_weights"])
def test_label_preference(case):
    if case == "prefers_labeled":
        nodes = [mk_node("n0"), mk_node("n1", labels={"ssd": "true"})]
        prios = [{"name": "p", "weight": 1,
                  "argument": {"labelPreference": {"label": "ssd", "presence": True}}}]
    else:
        nodes = [mk_node("n0", labels={"old": "1"}), mk_node("n1")]
        prios = [{"name": "LeastRequestedPriority", "weight": 1},
                 {"name": "p", "weight": 5,
                  "argument": {"labelPreference": {"label": "old", "presence": False}}}]
    got = _assert_policy({"predicates": BASE, "priorities": prios}, [mk_pod("p0")], nodes)
    assert got == ["n1"]


# -- serviceAffinity ------------------------------------------------------


def _affinity_nodes():
    return jcases.TestServiceAffinity().nodes()


def _peer(node_name):
    peer = mk_pod("peer", labels={"app": "web"})
    peer.spec.node_name = node_name
    return peer


AFFINITY_CASES = {
    "no_peers_no_pin": ([mk_pod("p0", labels={"app": "web"})], []),
    "anchor_peer_pins_zone": ([mk_pod(f"p{i}", labels={"app": "web"}) for i in range(3)],
                              [_peer("n2")]),
    "node_selector_pin_overrides": (
        [mk_pod("p0", labels={"app": "web"}, selector={"zone": "a"})], [_peer("n2")]),
    "in_backlog_anchor": ([mk_pod(f"p{i}", labels={"app": "web"}) for i in range(6)], []),
    "anchor_on_unknown_node": ([mk_pod("p0", labels={"app": "web"})], [_peer("gone-node")]),
}


@pytest.mark.parametrize("case", sorted(AFFINITY_CASES))
def test_service_affinity(case):
    pending, assigned = AFFINITY_CASES[case]
    got = _assert_policy(jcases.AFFINITY_POLICY, pending, _affinity_nodes(), assigned,
                         [mk_svc("web", {"app": "web"})])
    if case == "anchor_peer_pins_zone":
        assert set(got) == {"n2"}
    if case == "anchor_on_unknown_node":
        assert got == [None]


def test_label_less_affinity_is_a_noop():
    policy = {"predicates": BASE + [{"name": "noop", "argument": {"serviceAffinity": {"labels": []}}}],
              "priorities": [{"name": "LeastRequestedPriority", "weight": 1}]}
    assert not algspec.lower_spec(algspec.spec_from_policy(policy))[0].service_affinity
    assert _assert_policy(policy, [mk_pod("p0")], [mk_node("n0")]) == ["n0"]


# -- serviceAntiAffinity --------------------------------------------------


def test_zero_weight_instance_does_not_misalign_columns():
    nodes = [mk_node("n0", labels={"zone": "a", "rack": "r1"}),
             mk_node("n1", labels={"zone": "a", "rack": "r2"})]
    policy = {"predicates": BASE, "priorities": [
        {"name": "dead", "weight": 0, "argument": {"serviceAntiAffinity": {"label": "zone"}}},
        {"name": "live", "weight": 2, "argument": {"serviceAntiAffinity": {"label": "rack"}}},
    ]}
    pods = [mk_pod(f"p{i}", labels={"app": "web"}) for i in range(4)]
    got = _assert_policy(policy, pods, nodes, services=[mk_svc("web", {"app": "web"})])
    assert got[0] != got[1]


def test_anti_affinity_spreads_across_zones():
    nodes = [mk_node("n0", labels={"zone": "a"}), mk_node("n1", labels={"zone": "b"}), mk_node("n2")]
    policy = {"predicates": BASE, "priorities": [
        {"name": "aa", "weight": 1, "argument": {"serviceAntiAffinity": {"label": "zone"}}}]}
    pods = [mk_pod(f"p{i}", labels={"app": "web"}) for i in range(4)]
    got = _assert_policy(policy, pods, nodes, services=[mk_svc("web", {"app": "web"})])
    assert "n2" not in got[:2]


def test_anti_affinity_counts_only_feasible_nodes():
    """A full node's peers leave its zone's count: zone a holds one full
    node with peers and one empty node, so the pod's score for zone a
    depends on the filter."""
    nodes = [mk_node("n0", cpu=200, labels={"zone": "a"}), mk_node("n1", labels={"zone": "a"}),
             mk_node("n2", labels={"zone": "b"})]
    assigned = []
    for k in range(3):
        peer = mk_pod(f"peer{k}", cpu=50, labels={"app": "web"})
        peer.spec.node_name = "n0"
        assigned.append(peer)
    policy = {"predicates": BASE, "priorities": [
        {"name": "aa", "weight": 1, "argument": {"serviceAntiAffinity": {"label": "zone"}}}]}
    pods = [mk_pod(f"p{i}", cpu=100, labels={"app": "web"}) for i in range(3)]
    _assert_policy(policy, pods, nodes, assigned, [mk_svc("web", {"app": "web"})])


# -- predicate subsets and weights -------------------------------------


def test_omitting_ports_allows_conflicts():
    policy = {"predicates": [{"name": "PodFitsResources"}],
              "priorities": [{"name": "LeastRequestedPriority", "weight": 1}]}
    pods = [mk_pod("p0", host_port=8080), mk_pod("p1", host_port=8080)]
    assert _assert_policy(policy, pods, [mk_node("n0")]) == ["n0", "n0"]


def test_weighted_priorities():
    policy = {"predicates": BASE, "priorities": [
        {"name": "LeastRequestedPriority", "weight": 3},
        {"name": "BalancedResourceAllocation", "weight": 2},
        {"name": "ServiceSpreadingPriority", "weight": 1},
        {"name": "EqualPriority", "weight": 4},
    ]}
    pods = [mk_pod(f"p{i}", cpu=300, mem_mib=256) for i in range(12)]
    nodes = [mk_node(f"n{j}", cpu=2000, mem_mib=2048) for j in range(4)]
    _assert_policy(policy, pods, nodes, services=[mk_svc("s", {"app": "x"})])


def test_full_vocabulary_200_x_40():
    pending, nodes, assigned, services = jcases.TestFullVocabularyParity().build(P=200, N=40, seed=11)
    _assert_policy(jcases.TestFullVocabularyParity.POLICY, pending, nodes, assigned, services)


# -- seeded random policy clusters -----------------------------------------


@pytest.mark.parametrize("shape", sorted(workload.POLICY_SHAPES))
@pytest.mark.parametrize("seed", range(3))
def test_policy_shapes_on_seeded_clusters(shape, seed):
    """Every policy shape on `workload.policy_cluster`: volumes, ports,
    pins (some to unknown nodes, where a pin without HostName means
    nothing), cordoned and not-ready nodes, services with an anchor on an
    unknown node. Held to the XLA scan (the scalar path is held to it
    only where the JAX package's own suite asks for exact parity)."""
    pending, nodes, assigned, services = workload.policy_cluster(seed)
    _assert_policy(workload.POLICY_SHAPES[shape], pending, nodes, assigned, services, scalar=False)


def _random_policy(rng):
    preds = [p for p in BASE if rng.random() < 0.7]
    if rng.random() < 0.5:
        preds.append(_presence(rng.choice(["zone", "rack", "ssd"]), rng.random() < 0.5))
    if rng.random() < 0.5:
        preds.append({"name": "sa", "argument": {"serviceAffinity": {
            "labels": rng.sample(["zone", "rack"], rng.randint(1, 2))}}})
    prios = [{"name": k, "weight": rng.choice([0, 1, 2, 5])}
             for k in ("LeastRequestedPriority", "BalancedResourceAllocation",
                       "ServiceSpreadingPriority")]
    for i in range(rng.randint(0, 3)):
        prios.append({"name": f"aa{i}", "weight": rng.choice([0, 1, 3]),
                      "argument": {"serviceAntiAffinity": {"label": rng.choice(["zone", "rack"])}}})
    if rng.random() < 0.5:
        prios.append({"name": "lp", "weight": rng.choice([1, 4]),
                      "argument": {"labelPreference": {"label": "ssd", "presence": rng.random() < 0.7}}})
    return {"predicates": preds, "priorities": prios}


@pytest.mark.parametrize("seed", range(8))
def test_random_policies_on_policy_objects(seed):
    rng = random.Random(seed)
    policy = _random_policy(rng)
    pending, nodes, assigned, services = workload.policy_objects(rng.randint(40, 160),
                                                                 rng.randint(5, 30), seed=seed)
    _assert_policy(policy, pending, nodes, assigned, services, scalar=False)


def test_policy_objects_are_deterministic():
    a = workload.policy_objects(300, 40, seed=4)
    b = workload.policy_objects(300, 40, seed=4)
    key = lambda objs: [(o.metadata.name, sorted((o.metadata.labels or {}).items()),
                         getattr(o.spec, "node_name", None)) for o in objs]
    for x, y in zip(a, b):
        assert key(x) == key(y)
    nodes = a[1]
    assert "zone" not in nodes[0].metadata.labels and nodes[3].metadata.labels["ssd"] == "true"
    assert nodes[17].metadata.labels["retiring"] == "soon" and nodes[5].metadata.labels["rack"] == "r5"
    assert len(a[2]) == 8 and all(p.spec.node_name for p in a[2])


@pytest.mark.parametrize("n_aa,n_aff", [(9, 1), (12, 1), (1, 9), (12, 9)])
def test_wide_policies_match_xla(n_aa, n_aff):
    """Nine and twelve anti-affinity instances and nine affinity labels,
    past what the policy scan kernel keeps in its arguments and
    registers: the port's names and carry equal the XLA scan's."""
    pending, nodes, assigned, services = workload.wide_objects(160, 40, seed=3)
    got = _assert_policy(workload.wide_policy(n_aa, n_aff), pending, nodes, assigned, services,
                         scalar=False)
    assert sum(g is not None for g in got) > 40
