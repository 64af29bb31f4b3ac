"""The port's scalar plugins and backlog loop decide as the JAX package's.

The port keeps its own copies of `models/labels.py` and the scheduler's
`types`, `predicates`, `priorities`, `generic` and `plugins` modules:
the full re-lower daemon's scalar route (a policy with no device
lowering) runs them. On seeded clusters (`workload.small_cluster`,
`workload.policy_cluster`, `workload.policy_objects`), the same objects
go through both packages:

- each predicate, pod by pod and node by node, and each priority
  function's scores, for the default provider and for
  `FULL_VOCABULARY_POLICY` (every argumented kind), exactly;
- label selectors parse and match alike;
- `schedule_backlog_scalar` gives the JAX package's names for the
  default spec, `FULL_VOCABULARY_POLICY` and a policy that does not
  lower (a custom predicate registered in both registries); for the
  lowerable specs also `schedule_backlog(device="cpu")`'s.
"""

import random

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from kubernetes_tpu.models import algspec as jalgspec
from kubernetes_tpu.models import labels as jlabels
from kubernetes_tpu.scheduler import batch as jbatch
from kubernetes_tpu.scheduler import generic as jgeneric
from kubernetes_tpu.scheduler import plugins as jplugins
from kubernetes_tpu.scheduler import types as jtypes
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.models import algspec, labels
from kubernetes_tpu_torch.models.algspec import UnloweredPolicyError, lower_spec
from kubernetes_tpu_torch.scheduler import generic, plugins, types
from kubernetes_tpu_torch.scheduler.batch import schedule_backlog, schedule_backlog_scalar

POLICIES = {"default": None, "full_vocabulary": workload.FULL_VOCABULARY_POLICY}


def _cases():
    out = [("small", seed, workload.small_cluster(seed)) for seed in range(4)]
    out += [("policy", seed, workload.policy_cluster(seed)) for seed in range(3)]
    out.append(("objects", 3, workload.policy_objects(120, 30, seed=3)))
    return out


CASES = _cases()
CASE_IDS = [f"{kind}{seed}" for kind, seed, _ in CASES]


def _plugins(pkg_plugins, pkg_types, policy, nodes, assigned, services):
    args = pkg_plugins.PluginFactoryArgs(
        pod_lister=pkg_types.StaticPodLister(list(assigned)),
        service_lister=pkg_types.StaticServiceLister(list(services)),
        node_lister=pkg_types.StaticNodeLister(list(nodes)),
    )
    spec = (pkg_plugins.spec_for_provider(pkg_plugins.DEFAULT_PROVIDER) if policy is None
            else pkg_plugins.spec_for_policy(policy))
    predicates, priorities = pkg_plugins.build_from_spec(spec, args)
    return args, predicates, priorities


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_each_predicate_matches_jax_on_every_pod_and_node(case, policy):
    _, _, (pending, nodes, assigned, services) = case
    targs, tpreds, _ = _plugins(plugins, types, POLICIES[policy], nodes, assigned, services)
    jargs, jpreds, _ = _plugins(jplugins, jtypes, POLICIES[policy], nodes, assigned, services)
    assert list(tpreds) == list(jpreds)
    tmachines = types.map_pods_to_machines(targs.pod_lister)
    jmachines = jtypes.map_pods_to_machines(jargs.pod_lister)
    assert {k: [p.metadata.name for p in v] for k, v in tmachines.items()} == \
        {k: [p.metadata.name for p in v] for k, v in jmachines.items()}
    checked = 0
    for pod in pending[:60]:
        for node in nodes:
            name = node.metadata.name
            for key in tpreds:
                got = tpreds[key](pod, tmachines.get(name, []), name)
                want = jpreds[key](pod, jmachines.get(name, []), name)
                assert got == want, f"{key} on {pod.metadata.name} x {name}"
                checked += 1
    assert checked > 0


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_each_priority_matches_jax(case, policy):
    _, _, (pending, nodes, assigned, services) = case
    targs, _, tprios = _plugins(plugins, types, POLICIES[policy], nodes, assigned, services)
    jargs, _, jprios = _plugins(jplugins, jtypes, POLICIES[policy], nodes, assigned, services)
    assert [c.weight for c in tprios] == [c.weight for c in jprios]
    for pod in pending[:40]:
        for tc, jc in zip(tprios, jprios):
            got = [(e.host, e.score) for e in tc.function(pod, targs.pod_lister, targs.node_lister)]
            want = [(e.host, e.score) for e in jc.function(pod, jargs.pod_lister, jargs.node_lister)]
            assert got == want
        tsched = generic.GenericScheduler({}, tprios, targs.pod_lister)
        got = generic.prioritize_nodes(pod, targs.pod_lister, tsched.prioritizers,
                                       targs.node_lister)
        want = jgeneric.prioritize_nodes(pod, jargs.pod_lister, jprios, jargs.node_lister)
        assert [(e.host, e.score) for e in got] == [(e.host, e.score) for e in want]


SELECTORS = ["", "zone=a", "zone==b", "zone!=c", "zone in (a, b)", "zone notin (a)", "ssd",
             "zone=a,ssd", "rack in (r1,r2),zone!=a", "!ssd"]


@pytest.mark.parametrize("text", SELECTORS)
def test_selectors_parse_and_match_alike(text):
    rng = random.Random(text)
    for _ in range(50):
        labelset = {k: rng.choice(["a", "b", "c", "r1", "r2", "true"])
                    for k in ("zone", "ssd", "rack") if rng.random() < 0.6}
        try:
            want = jlabels.parse(text).matches(labelset)
        except ValueError:
            with pytest.raises(ValueError):
                labels.parse(text)
            return
        assert labels.parse(text).matches(labelset) == want
        assert str(labels.parse(text)) == str(jlabels.parse(text))
    assert labels.selector_from_set({"zone": "a"}).matches({"zone": "a"})


@settings(max_examples=60, deadline=None)
@given(st.dictionaries(st.sampled_from(["zone", "rack", "ssd", "app"]),
                       st.sampled_from(["a", "b", "c", "true"]), max_size=4),
       st.dictionaries(st.sampled_from(["zone", "rack", "ssd", "app"]),
                       st.sampled_from(["a", "b", "c", "true"]), max_size=4))
def test_set_selectors_match_alike(selector, labelset):
    got = labels.selector_from_set(selector).matches(labelset)
    assert got == jlabels.selector_from_set(selector).matches(labelset)


def _scalar_both(pending, nodes, assigned, services, policy):
    if policy is None:
        return (schedule_backlog_scalar(pending, nodes, assigned, services),
                jbatch.schedule_backlog_scalar(pending, nodes, assigned, services))
    return (schedule_backlog_scalar(pending, nodes, assigned, services,
                                    spec=algspec.spec_from_policy(policy)),
            jbatch.schedule_backlog_scalar(pending, nodes, assigned, services,
                                           spec=jalgspec.spec_from_policy(policy)))


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_scalar_backlog_matches_jax_and_the_scan(case, policy):
    _, _, (pending, nodes, assigned, services) = case
    got, want = _scalar_both(pending, nodes, assigned, services, POLICIES[policy])
    assert got == want
    spec = None if POLICIES[policy] is None else algspec.spec_from_policy(POLICIES[policy])
    scan = schedule_backlog(pending, nodes, assigned, services, device="cpu", spec=spec)
    assert got == scan
    assert any(d is not None for d in got)


def _avoid_zone_c(args):
    def fits(pod, pods_on_node, node_name):
        return (args.node_lister.get(node_name).metadata.labels or {}).get("zone") != "c"

    return fits


UNLOWERABLE = {
    "kind": "Policy",
    "predicates": [{"name": "PodFitsResources"}, {"name": "PodFitsPorts"},
                   {"name": "AvoidZoneC"}],
    "priorities": [{"name": "LeastRequestedPriority", "weight": 2},
                   {"name": "ServiceSpreadingPriority", "weight": 1}],
}


@pytest.fixture(scope="module")
def avoid_zone_c():
    plugins.register_fit_predicate("AvoidZoneC", _avoid_zone_c)
    jplugins.register_fit_predicate("AvoidZoneC", _avoid_zone_c)
    yield UNLOWERABLE


@pytest.mark.parametrize("case", CASES[:4] + CASES[-1:], ids=CASE_IDS[:4] + CASE_IDS[-1:])
def test_unlowerable_policy_runs_its_plugins_as_jax_does(avoid_zone_c, case):
    _, _, (pending, nodes, assigned, services) = case
    with pytest.raises(UnloweredPolicyError):
        lower_spec(algspec.spec_from_policy(avoid_zone_c))
    got, want = _scalar_both(pending, nodes, assigned, services, avoid_zone_c)
    assert got == want
    zone_of = {n.metadata.name: (n.metadata.labels or {}).get("zone") for n in nodes}
    assert all(zone_of[d] != "c" for d in got if d is not None)


def test_ties_go_to_the_first_best_node_unless_an_rng_is_given():
    sched = generic.GenericScheduler({}, [], types.StaticPodLister([]))
    prio = [types.HostPriority("n2", 5), types.HostPriority("n0", 7), types.HostPriority("n1", 7)]
    assert sched.select_host(prio) == "n0"
    seeded = generic.GenericScheduler({}, [], types.StaticPodLister([]), rng=random.Random(1))
    assert {seeded.select_host(prio) for _ in range(40)} == {"n0", "n1"}
    with pytest.raises(generic.NoNodesError):
        sched.schedule(workload.small_cluster(0)[0][0], types.StaticNodeLister([]))
