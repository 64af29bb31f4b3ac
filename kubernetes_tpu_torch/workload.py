"""Seeded scheduling workloads built from the port's API objects.

`synthetic_objects` is the repo's benchmark backlog (the generator in
`__graft_entry__._synthetic_objects`, over this package's objects): the
same seed draws the same `random.Random` stream and yields the same
pods, nodes and services. `policy_objects` is that backlog with the node
labels and bound service peers that the full-vocabulary scheduler
policy (`FULL_VOCABULARY_POLICY`) reads; `policy_cluster` does the same
for `small_cluster`, under each policy of `POLICY_SHAPES`. `small_cluster` is a fuzz
cluster that exercises every predicate and commit path of the solver at
a few dozen pods and nodes. `churn_replay` drives an incremental session through
BASELINE config 5, continuous pod creates and deletes (the tick loop of
`bench.py`'s `_churn_figure`), with pods of `synthetic_objects`'
distribution. `preemption_objects` is a priority burst landing on a full
fleet; `random_capacity_args` and `random_rebalance_args` are the
seeded column generators of the JAX package's capacity and defrag
parity tests, and `backlog_probes` the capacity plane's probe set of a
backlog.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch.models.objects import (
    AWSElasticBlockStoreVolumeSource,
    Container,
    ContainerPort,
    GCEPersistentDiskVolumeSource,
    Node,
    NodeCondition,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodSpec,
    PodStatus,
    ResourceRequirements,
    Service,
    ServiceSpec,
    Volume,
)
from kubernetes_tpu_torch.models.columnar import mem_to_mib_ceil, pod_resource_limits
from kubernetes_tpu_torch.models.quantity import Quantity, parse_quantity
from kubernetes_tpu_torch.utils.capacity import DEFAULT_SLICE_SHAPES, probe_set
from kubernetes_tpu_torch.utils.tracing import PhaseTimer

Objects = Tuple[List[Pod], List[Node], List[Service]]


ZONES = tuple(f"z{i}" for i in range(4))


def _synthetic_pod(rng: random.Random, name: str, n_services: int) -> Pod:
    """One pod of `synthetic_objects`' distribution, drawing from `rng`
    in the generator's order: service, host port, cpu, memory, zone
    selector."""
    app = f"app{rng.randrange(n_services)}"
    ports = (
        [ContainerPort(container_port=80, host_port=30000 + rng.randrange(64))]
        if rng.random() < 0.05
        else []
    )
    limits = {
        "cpu": Quantity.from_milli(rng.choice([100, 250, 500, 1000])),
        "memory": parse_quantity(f"{rng.choice([64, 128, 256, 512])}Mi"),
    }
    selector = {"zone": rng.choice(ZONES)} if rng.random() < 0.1 else {}
    return Pod(
        metadata=ObjectMeta(name=name, namespace="default", labels={"app": app}),
        spec=PodSpec(
            containers=[
                Container(
                    name="c",
                    image="app",
                    ports=ports,
                    resources=ResourceRequirements(limits=limits),
                )
            ],
            node_selector=selector,
        ),
    )


def synthetic_objects(n_pods: int, n_nodes: int, seed: int = 0) -> Objects:
    """Realistic mixed-workload API objects (pods, nodes, services):
    nodes of 8/16/32 cores and 16/32/64 GiB in four zones, one service
    per hundred pods, 5% of pods with a host port and 10% with a zone
    selector."""
    rng = random.Random(seed)
    nodes = [
        Node(
            metadata=ObjectMeta(name=f"n{j}", labels={"zone": rng.choice(ZONES)}),
            status=NodeStatus(
                capacity={
                    "cpu": Quantity.from_milli(rng.choice([8000, 16000, 32000])),
                    "memory": parse_quantity(f"{rng.choice([16, 32, 64])}Gi"),
                    "pods": Quantity.from_int(110),
                },
                conditions=[NodeCondition(type="Ready", status="True")],
            ),
        )
        for j in range(n_nodes)
    ]
    services = [
        Service(
            metadata=ObjectMeta(name=f"svc{s}", namespace="default"),
            spec=ServiceSpec(selector={"app": f"app{s}"}),
        )
        for s in range(max(1, n_pods // 100))
    ]
    pods = [_synthetic_pod(rng, f"p{i}", len(services)) for i in range(n_pods)]
    return pods, nodes, services


_BASE_PREDICATES = [
    {"name": "PodFitsPorts"},
    {"name": "PodFitsResources"},
    {"name": "NoDiskConflict"},
    {"name": "MatchNodeSelector"},
    {"name": "HostName"},
]

#: A scheduler policy file (`scheduler --policy-config-file`) that uses
#: every kind of the reference's vocabulary: the base predicates,
#: labelsPresence present and absent, serviceAffinity on `zone`,
#: weighted default priorities, serviceAntiAffinity on `rack` and
#: labelPreference `ssd`.
FULL_VOCABULARY_POLICY = {
    "kind": "Policy",
    "predicates": _BASE_PREDICATES + [
        {"name": "zone-aff", "argument": {"serviceAffinity": {"labels": ["zone"]}}},
        {"name": "has-zone",
         "argument": {"labelsPresence": {"labels": ["zone"], "presence": True}}},
        {"name": "not-retiring",
         "argument": {"labelsPresence": {"labels": ["retiring"], "presence": False}}},
    ],
    "priorities": [
        {"name": "LeastRequestedPriority", "weight": 1},
        {"name": "BalancedResourceAllocation", "weight": 1},
        {"name": "ServiceSpreadingPriority", "weight": 2},
        {"name": "EqualPriority", "weight": 1},
        {"name": "zone-anti", "weight": 2,
         "argument": {"serviceAntiAffinity": {"label": "rack"}}},
        {"name": "prefer-ssd", "weight": 1,
         "argument": {"labelPreference": {"label": "ssd", "presence": True}}},
    ],
}


def policy_objects(n_pods: int, n_nodes: int, seed: int = 0, host_ports: int = 0):
    """(pending, nodes, assigned, services) for `FULL_VOCABULARY_POLICY`:
    `synthetic_objects`' backlog with node j labelled rack=r{j % 10},
    ssd=true when j % 3 == 0, retiring=soon when j % 17 == 0 and without
    its zone when j % 11 == 0; and n_pods // 200 (at least 8) bound
    service peers, so that anchors and zone counts start non-empty.
    With `host_ports`, pending pod i also asks for host port
    9000 + i % host_ports (70 of them need 4-word port bitsets).
    The same seed gives the same objects."""
    pending, nodes, services = synthetic_objects(n_pods, n_nodes, seed)
    for i, pod in enumerate(pending if host_ports > 0 else ()):
        container = pod.spec.containers[0]
        container.ports = list(container.ports or []) + [
            ContainerPort(container_port=8080, host_port=9000 + i % host_ports)]
    for j, node in enumerate(nodes):
        labels = node.metadata.labels
        labels["rack"] = f"r{j % 10}"
        if j % 3 == 0:
            labels["ssd"] = "true"
        if j % 17 == 0:
            labels["retiring"] = "soon"
        if j % 11 == 0:
            del labels["zone"]
    assigned = []
    for k in range(max(8, n_pods // 200)):
        peer = Pod(
            metadata=ObjectMeta(
                name=f"peer{k}", namespace="default",
                labels={"app": f"app{(2 * k) % len(services)}"},
            ),
            spec=PodSpec(
                containers=[Container(
                    name="c", image="app",
                    resources=ResourceRequirements(limits={
                        "cpu": Quantity.from_milli(100), "memory": parse_quantity("64Mi")}),
                )],
                node_name=f"n{(7 * k) % n_nodes}",
            ),
        )
        peer.status.phase = "Running"
        assigned.append(peer)
    return pending, nodes, assigned, services


def _anti(name: str, label: str, weight: int) -> dict:
    return {"name": name, "weight": weight,
            "argument": {"serviceAntiAffinity": {"label": label}}}


#: One scheduler policy per shape of the vocabulary, for the parity
#: checks of the policy solve: the predicate subsets and weights of
#: BASELINE configs 2 and 3, labelsPresence present and absent,
#: labelPreference, serviceAffinity, one and two serviceAntiAffinity
#: instances (beside a zero-weight one, which lowering drops), and the
#: full vocabulary.
POLICY_SHAPES = {
    "resources_least_requested": {  # BASELINE config 2
        "predicates": [{"name": "PodFitsResources"}],
        "priorities": [{"name": "LeastRequestedPriority", "weight": 1}],
    },
    "selector_balanced": {  # BASELINE config 3
        "predicates": [{"name": "MatchNodeSelector"}],
        "priorities": [{"name": "BalancedResourceAllocation", "weight": 1}],
    },
    "presence_absence_weighted": {
        "predicates": _BASE_PREDICATES + [
            {"name": "z", "argument": {"labelsPresence": {"labels": ["zone"], "presence": True}}},
            {"name": "r", "argument": {"labelsPresence": {"labels": ["retiring"],
                                                          "presence": False}}},
        ],
        "priorities": [
            {"name": "LeastRequestedPriority", "weight": 3},
            {"name": "BalancedResourceAllocation", "weight": 2},
            {"name": "ServiceSpreadingPriority", "weight": 1},
        ],
    },
    "label_preference": {
        "predicates": _BASE_PREDICATES,
        "priorities": [
            {"name": "LeastRequestedPriority", "weight": 1},
            {"name": "ssd", "weight": 5,
             "argument": {"labelPreference": {"label": "ssd", "presence": True}}},
            {"name": "old", "weight": 2,
             "argument": {"labelPreference": {"label": "retiring", "presence": False}}},
        ],
    },
    "service_affinity": {
        "predicates": _BASE_PREDICATES + [
            {"name": "za", "argument": {"serviceAffinity": {"labels": ["zone", "rack"]}}}],
        "priorities": [{"name": "LeastRequestedPriority", "weight": 1}],
    },
    "anti_affinity_one": {
        "predicates": _BASE_PREDICATES,
        "priorities": [_anti("spread-zone", "zone", 1)],
    },
    "anti_affinity_two": {
        "predicates": _BASE_PREDICATES,
        "priorities": [
            {"name": "ServiceSpreadingPriority", "weight": 1},
            _anti("dead", "zone", 0),
            _anti("spread-rack", "rack", 2),
            _anti("spread-zone", "zone", 3),
        ],
    },
    "full_vocabulary": FULL_VOCABULARY_POLICY,
}


def wide_policy(n_aa: int, n_aff: int) -> dict:
    """A policy with `n_aff` ServiceAffinity labels (zone, then a1, a2,
    ...) and `n_aa` ServiceAntiAffinity instances (rack, then s1, s2,
    ..., weights 1 to 3), beside the base predicates and the weighted
    default priorities: the shapes past the eight instances and eight
    labels the policy scan kernel keeps in its arguments and registers.
    `wide_objects` labels the nodes it reads."""
    predicates = list(_BASE_PREDICATES)
    if n_aff:
        labels = ["zone"] + [f"a{k}" for k in range(1, n_aff)]
        predicates.append({"name": "aff", "argument": {"serviceAffinity": {"labels": labels}}})
    priorities = [
        {"name": "LeastRequestedPriority", "weight": 1},
        {"name": "BalancedResourceAllocation", "weight": 1},
        {"name": "ServiceSpreadingPriority", "weight": 2},
    ] + [_anti(f"anti{i}", "rack" if i == 0 else f"s{i}", 1 + i % 3) for i in range(n_aa)]
    return {"kind": "Policy", "predicates": predicates, "priorities": priorities}


def wide_objects(n_pods: int, n_nodes: int, seed: int = 0, n_labels: int = 12):
    """`policy_objects` with the labels `wide_policy` reads on every
    node j: a1..a7 = v{(j // 20) % 2} (blocks of nodes), a8.. =
    w{j % 4}, so that an affinity label past the eighth still decides
    where a pod fits, and s_k = z{j % (k + 2)}, each instance its own
    zones."""
    pending, nodes, assigned, services = policy_objects(n_pods, n_nodes, seed)
    for j, node in enumerate(nodes):
        labels = node.metadata.labels
        for k in range(1, n_labels):
            labels[f"a{k}"] = f"v{(j // 20) % 2}" if k < 8 else f"w{j % 4}"
            labels[f"s{k}"] = f"z{j % (k + 2)}"
    return pending, nodes, assigned, services


def policy_cluster(seed: int) -> Tuple[List[Pod], List[Node], List[Pod], List[Service]]:
    """`small_cluster(seed)` with the node labels the policy shapes read
    (rack=r{j % 4}, ssd on j % 3 == 0, retiring on j % 5 == 0) and one
    more bound pod of every service, the first on a node the cluster
    does not know: that service's anchor fits its pods nowhere."""
    pending, nodes, assigned, services = small_cluster(seed)
    for j, node in enumerate(nodes):
        labels = node.metadata.labels
        labels["rack"] = f"r{j % 4}"
        if j % 3 == 0:
            labels["ssd"] = "true"
        if j % 5 == 0:
            labels["retiring"] = "soon"
    names = [n.metadata.name for n in nodes]
    for s, svc in enumerate(services):
        peer = Pod(
            metadata=ObjectMeta(name=f"peer{s}", namespace="default",
                                labels=dict(svc.spec.selector)),
            spec=PodSpec(
                containers=[Container(name="c", image="app")],
                node_name="gone" if s == 0 else names[(3 * s) % len(names)],
            ),
        )
        assigned.insert(0, peer)
    return pending, nodes, assigned, services


def _pod(rng: random.Random, name: str, n_services: int, node_names: List[str]) -> Pod:
    limits = {}
    cpu = rng.choice([0, 0, 50, 100, 500, 1500])
    mem = rng.choice([0, 16, 128, 1024])
    if cpu:
        limits["cpu"] = Quantity.from_milli(cpu)
    if mem:
        limits["memory"] = parse_quantity(f"{mem}Mi")
    ports = [
        ContainerPort(container_port=80, host_port=rng.choice([8080, 9090, 9100]))
        for _ in range(rng.choice([0, 0, 0, 1, 2]))
    ]
    volumes = []
    for k in range(rng.choice([0, 0, 0, 1, 2])):
        if rng.random() < 0.5:
            volumes.append(
                Volume(
                    name=f"v{k}",
                    gce_persistent_disk=GCEPersistentDiskVolumeSource(
                        pd_name=f"pd{rng.randrange(4)}",
                        read_only=rng.random() < 0.5,
                    ),
                )
            )
        else:
            volumes.append(
                Volume(
                    name=f"v{k}",
                    aws_elastic_block_store=AWSElasticBlockStoreVolumeSource(
                        volume_id=f"ebs{rng.randrange(3)}"
                    ),
                )
            )
    # Labels that match zero, one or several services (services select
    # on "app" and, for every third one, on "tier" as well).
    labels = {}
    if n_services and rng.random() < 0.7:
        labels["app"] = f"a{rng.randrange(n_services)}"
        if rng.random() < 0.5:
            labels["tier"] = rng.choice(["web", "db"])
    pinned = rng.choice(node_names + ["ghost"]) if rng.random() < 0.08 else ""
    return Pod(
        metadata=ObjectMeta(name=name, namespace="default", labels=labels),
        spec=PodSpec(
            containers=[
                Container(
                    name="c",
                    image="app",
                    ports=ports,
                    resources=ResourceRequirements(limits=limits),
                )
            ],
            volumes=volumes,
            node_selector=(
                {"zone": rng.choice(["a", "b", "c"])} if rng.random() < 0.3 else {}
            ),
            node_name=pinned,
        ),
    )


def small_cluster(seed: int) -> Tuple[List[Pod], List[Node], List[Pod], List[Service]]:
    """(pending, nodes, assigned, services) for one fuzz case: host
    ports, GCE and EBS volumes, pinned pods (some to an unknown node),
    zero-request pods, not-ready and cordoned nodes, pods in several
    services at once, and an odd service count."""
    rng = random.Random(seed)
    n_nodes = rng.randint(3, 40)
    n_services = rng.choice([0, 1, 3, 5, 7, 13])
    nodes = [
        Node(
            metadata=ObjectMeta(
                name=f"n{j}",
                labels={"zone": rng.choice(["a", "b", "c"])} if rng.random() < 0.8 else {},
            ),
            spec=NodeSpec(unschedulable=rng.random() < 0.05),
            status=NodeStatus(
                capacity={
                    "cpu": Quantity.from_milli(rng.choice([0, 1000, 2000, 4000, 8000])),
                    "memory": parse_quantity(f"{rng.choice([1024, 4096, 8192])}Mi"),
                    "pods": Quantity.from_int(rng.choice([3, 10, 40])),
                },
                conditions=[
                    NodeCondition(
                        type="Ready", status="True" if rng.random() > 0.1 else "False"
                    )
                ],
            ),
        )
        for j in range(n_nodes)
    ]
    services = []
    for s in range(n_services):
        selector = {"app": f"a{s}"}
        if s % 3 == 2:
            selector = {"tier": "web"}
        services.append(
            Service(
                metadata=ObjectMeta(name=f"s{s}", namespace="default"),
                spec=ServiceSpec(selector=selector),
            )
        )
    names = [n.metadata.name for n in nodes]
    assigned = []
    for i in range(rng.randint(0, 30)):
        a = _pod(rng, f"a{i}", n_services, names)
        a.spec.node_name = rng.choice(names)
        assigned.append(a)
    pending = [_pod(rng, f"p{i}", n_services, names) for i in range(rng.randint(1, 200))]
    return pending, nodes, assigned, services


def churn_pods(rng: random.Random, first: int, count: int, n_services: int) -> List[Pod]:
    """`count` new pods p{first}, p{first + 1}, ... drawn from `rng` with
    `synthetic_objects`' pod distribution over `n_services` services."""
    return [_synthetic_pod(rng, f"p{first + i}", n_services) for i in range(count)]


@dataclass
class ChurnTick:
    """One tick of a churn replay: its results, the deletes that found
    their pod, and its host wall and phase seconds (`lower` in
    add_pending, `delete`, and the session's `upload`, `solve`,
    `readback` and `commit`)."""

    results: List[Tuple[str, Optional[str]]]
    deleted: int
    wall_s: float
    phases_s: Dict[str, float]


def churn_replay(
    session,
    live: Sequence[str],
    ticks: int,
    rate: int,
    seed: int,
    n_services: int,
    first_index: int,
    pipelined: bool = False,
    on_result: Optional[Callable[[int, List[Tuple[str, Optional[str]]]], None]] = None,
) -> List[ChurnTick]:
    """Drive `session` (a SolverSession) through `ticks` churn ticks.

    Each tick creates `rate` pods (p{first_index}, ... of
    `synthetic_objects`' distribution over `n_services` services),
    deletes `rate` random pods of the live pool, and solves; the pods
    and the deletes come from `random.Random(seed)`. `live` is the
    initial pool (the keys of the session's assigned pods). A tick's
    placements join the pool after the next tick's deletes, so the same
    operations can be replayed with a tick in flight: with `pipelined`
    the tick launches by `solve_async`, and the next tick's creates and
    deletes are applied while it runs. Either way the session sees the
    same operations in the same order and makes the same decisions.

    `on_result(k, results)` is called once tick k's results are in and
    before the next launch; its time is not in any tick's wall. The
    session's `timer` is set to a fresh PhaseTimer for each tick."""
    rng = random.Random(seed)
    pool = list(live)
    late: List[str] = []
    records: List[ChurnTick] = []
    handle = None
    index = first_index

    def resolve(k: int) -> float:
        """Collect tick k's results; returns the seconds on_result took."""
        records[k].results = handle.result()
        pool.extend(key for key, dest in records[k].results if dest is not None)
        if on_result is None:
            return 0.0
        t0 = time.perf_counter()
        on_result(k, records[k].results)
        return time.perf_counter() - t0

    saved_timer = session.timer
    try:
        for k in range(ticks):
            pods = churn_pods(rng, index, rate, n_services)
            index += rate
            timer = PhaseTimer()
            session.timer = timer
            t0 = time.perf_counter()
            with timer.phase("lower"):
                for pod in pods:
                    session.add_pending(pod)
            deleted = 0
            with timer.phase("delete"):
                for _ in range(min(rate, len(pool))):
                    i = rng.randrange(len(pool))
                    pool[i], pool[-1] = pool[-1], pool[i]
                    deleted += session.delete_assigned(pool.pop())
            records.append(ChurnTick([], deleted, 0.0, timer.seconds))
            callback_s = 0.0
            if pipelined:
                if handle is not None:
                    callback_s = resolve(k - 1)
                handle = session.solve_async()
            else:
                pool.extend(late)
                records[k].results = session.solve()
                late = [key for key, dest in records[k].results if dest is not None]
            records[k].wall_s = time.perf_counter() - t0 - callback_s
            if not pipelined and on_result is not None:
                on_result(k, records[k].results)
        if pipelined and handle is not None:
            t0 = time.perf_counter()
            callback_s = resolve(ticks - 1)
            records[-1].wall_s += time.perf_counter() - t0 - callback_s
    finally:
        session.timer = saved_timer
    return records


BOUND_PRIORITIES = (0, 10, 100, 1000)
PREEMPTOR_PRIORITIES = (100, 1000, 10000)


def _limits_pod(name: str, cpu: int, mem_mib: int, priority: int) -> Pod:
    return Pod(
        metadata=ObjectMeta(name=name, namespace="default"),
        spec=PodSpec(
            containers=[Container(name="c", image="app", resources=ResourceRequirements(limits={
                "cpu": Quantity.from_milli(cpu), "memory": parse_quantity(f"{mem_mib}Mi")}))],
            priority=priority,
        ),
        status=PodStatus(phase="Running"),
    )


def preemption_objects(n_nodes: int, n_bound: int, n_preemptors: int, seed: int = 0):
    """(preemptors, nodes, bound) for a priority burst on a full fleet.

    Nodes: `synthetic_objects`' nodes (8/16/32 cores, 16/32/64 GiB, 110
    pods, four zones). Bound pods: `n_bound`, dealt round robin over the
    nodes, at priorities from BOUND_PRIORITIES; each node's pods split
    85-100% of one resource (cpu or memory, drawn per node) and 30-80%
    of the other, in integral milli-cores and MiB; 2% are Terminating
    or terminal. Preemptors: `n_preemptors` at priorities from
    PREEMPTOR_PRIORITIES, asking 2-8 cores and 4-16 GiB, more than most
    nodes have free; 10% carry a zone nodeSelector and 5% have
    PreemptionPolicy Never."""
    rng = random.Random(seed)
    _, nodes, _ = synthetic_objects(0, n_nodes, seed)
    per_node = [[] for _ in range(n_nodes)]
    for i in range(n_bound):
        per_node[i % n_nodes].append(i)
    bound: List[Optional[Pod]] = [None] * n_bound
    for j, node in enumerate(nodes):
        ids = per_node[j]
        if not ids:
            continue
        cap_cpu = node.status.capacity["cpu"].milli_value()
        cap_mem = node.status.capacity["memory"].value() // (1024 * 1024)
        full, part = rng.uniform(0.85, 1.0), rng.uniform(0.3, 0.8)
        cpu_frac, mem_frac = (full, part) if rng.random() < 0.5 else (part, full)
        weights = [rng.uniform(0.2, 1.0) for _ in ids]
        total = sum(weights)
        for w, i in zip(weights, ids):
            cpu = max(1, int(cap_cpu * cpu_frac * w / total))
            mem = max(1, int(cap_mem * mem_frac * w / total))
            pod = _limits_pod(f"b{i}", cpu, mem, rng.choice(BOUND_PRIORITIES))
            pod.spec.node_name = node.metadata.name
            r = rng.random()
            if r < 0.01:
                pod.metadata.deletion_timestamp = "2026-01-01T00:00:00Z"
            elif r < 0.02:
                pod.status.phase = rng.choice(["Succeeded", "Failed"])
            bound[i] = pod
    preemptors = []
    for i in range(n_preemptors):
        pod = _limits_pod(f"q{i}", rng.choice([2000, 4000, 8000]), rng.choice([4096, 8192, 16384]),
                          rng.choice(PREEMPTOR_PRIORITIES))
        pod.status.phase = "Pending"
        if rng.random() < 0.1:
            pod.spec.node_selector = {"zone": rng.choice(ZONES)}
        if rng.random() < 0.05:
            pod.spec.preemption_policy = "Never"
        preemptors.append(pod)
    return preemptors, nodes, [p for p in bound if p is not None]


def backlog_probes(pods: Sequence[Pod]):
    """The capacity plane's probes for a backlog: DEFAULT_SLICE_SHAPES
    and the p50, p90 and max of the pods' (cpu milli, mem MiB) shapes."""
    shapes = []
    for p in pods:
        cpu, mem = pod_resource_limits(p)
        shapes.append((float(cpu), float(mem_to_mib_ceil(mem))))
    return probe_set(DEFAULT_SLICE_SHAPES, shapes)


def random_capacity_args(seed: int):
    """Random occupancy columns and probe shapes for the capacity report
    (the generator of the JAX package's capacity parity tests): integral
    milli-cpu and MiB columns, dead and overcommitted nodes, dead and
    zero-request probes."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    q = int(rng.integers(1, 12))
    cpu_cap = rng.choice([0.0, 1000.0, 2000.0, 4000.0, 8000.0], n).astype(np.float32)
    mem_cap = rng.choice([0.0, 1024.0, 4096.0, 8192.0], n).astype(np.float32)
    pods_cap = rng.choice([0.0, 3.0, 10.0, 40.0, 110.0], n).astype(np.float32)
    cpu_fit = np.floor(cpu_cap * rng.random(n) * 1.2).astype(np.float32)
    mem_fit = np.floor(mem_cap * rng.random(n) * 1.2).astype(np.float32)
    pods_used = np.floor(pods_cap * rng.random(n)).astype(np.float32)
    over = rng.random(n) < 0.1
    sched = rng.random(n) > 0.15
    probe_cpu = rng.choice([0.0, 50.0, 100.0, 250.0, 500.0, 2000.0], q).astype(np.float32)
    probe_mem = rng.choice([0.0, 16.0, 64.0, 256.0, 2048.0], q).astype(np.float32)
    probe_min = rng.integers(1, 9, q).astype(np.int32)
    probe_live = rng.random(q) > 0.2
    return (
        cpu_cap, mem_cap, pods_cap, cpu_fit, mem_fit, pods_used, over,
        sched, probe_cpu, probe_mem, probe_min, probe_live,
    )


def random_rebalance_args(seed: int):
    """`random_capacity_args(seed)` plus a movable worklist and a budget
    for the defrag plan (the generator of the JAX package's defrag
    parity tests): N from 1 to 300, Q from 1 to 12, sources out of range
    (-2 to N + 1), dead and forced rows, budgets 0 to D + 3."""
    (
        cpu_cap, mem_cap, pods_cap, cpu_fit, mem_fit, pods_used, over,
        sched, probe_cpu, probe_mem, probe_min, probe_live,
    ) = random_capacity_args(seed)
    rng = np.random.default_rng(seed + 7919)
    n = cpu_cap.shape[0]
    d = int(rng.integers(1, 80))
    pod_cpu = rng.choice([0.0, 50.0, 100.0, 250.0, 600.0, 2000.0], d).astype(np.float32)
    pod_mem = rng.choice([0.0, 16.0, 64.0, 512.0, 2048.0], d).astype(np.float32)
    pod_node = rng.integers(-2, n + 2, d).astype(np.int32)
    pod_live = rng.random(d) > 0.2
    pod_force = rng.random(d) < 0.15
    move_budget = np.int32(rng.integers(0, d + 4))
    return (
        cpu_cap, mem_cap, pods_cap, cpu_fit, mem_fit, pods_used, over,
        sched, pod_cpu, pod_mem, pod_node, pod_live, pod_force,
        probe_cpu, probe_mem, probe_min, probe_live, move_budget,
    )


def tied_rebalance_args(n: int, d: int, budget: int, src: Optional[Sequence[int]] = None):
    """n identical half-full nodes and d identical forced rows (sources
    `src`, else row i on node i mod n): every feasible node ties on the
    best-fit key, so the lowest index must win across threads and
    warps."""
    ones = np.ones(n, np.float32)
    pod_node = np.arange(d, dtype=np.int32) % n if src is None else np.asarray(src, np.int32)
    return (ones * 4000.0, ones * 8192.0, ones * 40.0, ones * 2000.0, ones * 4096.0, ones * 10.0,
            np.zeros(n, bool), np.ones(n, bool),
            np.full(d, 250.0, np.float32), np.full(d, 512.0, np.float32),
            pod_node, np.ones(d, bool), np.ones(d, bool),
            np.asarray([300.0, 1000.0], np.float32), np.asarray([256.0, 1024.0], np.float32),
            np.ones(2, np.int32), np.ones(2, bool), np.int32(budget))


def with_random_probes(args, q: int, seed: int = 0):
    """Defrag plan arguments `args` with q random probes in place of
    theirs (a fifth of them dead)."""
    rng = np.random.default_rng(seed)
    probes = (rng.choice([0.0, 100.0, 250.0, 500.0, 2000.0], q).astype(np.float32),
              rng.choice([0.0, 64.0, 256.0, 2048.0], q).astype(np.float32),
              np.ones(q, np.int32), rng.random(q) > 0.2)
    return tuple(args[:13]) + probes + tuple(args[17:])


def consolidation_args():
    """The canonical defrag case: three 500m pods spread over three
    1000m nodes leave 500m shards a 700m probe cannot use; pairing two
    up frees a node."""
    ones = np.ones(4, np.float32)
    return (
        ones * 1000.0, ones * 1024.0, ones * 40.0,
        np.asarray([500.0, 500.0, 500.0, 0.0], np.float32),
        np.asarray([64.0, 64.0, 64.0, 0.0], np.float32),
        np.asarray([1.0, 1.0, 1.0, 0.0], np.float32),
        np.zeros(4, bool), np.ones(4, bool),
        np.asarray([500.0] * 3 + [0.0], np.float32),
        np.asarray([64.0] * 3 + [0.0], np.float32),
        np.asarray([0, 1, 2, -1], np.int32),
        np.asarray([True, True, True, False]),
        np.zeros(4, bool),
        np.asarray([700.0], np.float32),
        np.asarray([256.0], np.float32),
        np.asarray([1], np.int32),
        np.asarray([True]),
        np.int32(8),
    )


def _limits(cpu: int, mem_mib: int) -> Dict[str, Quantity]:
    limits = {}
    if cpu:
        limits["cpu"] = Quantity.from_milli(cpu)
    if mem_mib:
        limits["memory"] = parse_quantity(f"{mem_mib}Mi")
    return limits


def random_preemption_problem(seed: int):
    """(preemptors, nodes, assigned) of one small preemption fuzz case
    (the generator of the JAX package's preemption parity tests, drawing
    the same stream): 1-8 nodes, some not ready, in zones a and b; up to
    24 bound pods at priorities 0-100, some Terminating or terminal;
    1-5 preemptors, some with a zone selector or PreemptionPolicy Never."""
    rng = random.Random(seed)
    N = rng.randint(1, 8)
    nodes = []
    for j in range(N):
        cpu = rng.choice([1000, 2000, 4000])
        mem = rng.choice([1024, 2048, 4096])
        pods = rng.randint(2, 8)
        labels = {"zone": rng.choice(["a", "b"])}
        ready = rng.random() > 0.1
        nodes.append(Node(
            metadata=ObjectMeta(name=f"n{j}", labels=labels),
            status=NodeStatus(
                capacity={"cpu": Quantity.from_milli(cpu), "memory": parse_quantity(f"{mem}Mi"),
                          "pods": Quantity.from_int(pods)},
                conditions=[NodeCondition(type="Ready", status="True" if ready else "False")],
            ),
        ))
    assigned = []
    for i in range(rng.randint(0, 24)):
        limits = _limits(rng.choice([0, 100, 300, 500, 900]), rng.choice([0, 64, 256, 512]))
        p = Pod(metadata=ObjectMeta(name=f"a{i}", namespace="default"),
                spec=PodSpec(containers=[Container(name="c", image="x",
                                                   resources=ResourceRequirements(limits=limits))]))
        p.spec.node_name = f"n{rng.randrange(N)}"
        p.spec.priority = rng.choice([0, 0, 5, 10, 50, 100])
        if rng.random() < 0.1:
            p.metadata.deletion_timestamp = "2026-01-01T00:00:00Z"
        if rng.random() < 0.1:
            p.status.phase = rng.choice(["Succeeded", "Failed"])
        assigned.append(p)
    preemptors = []
    for i in range(rng.randint(1, 5)):
        limits = _limits(rng.choice([200, 600, 1200, 2500]), rng.choice([128, 512, 1024]))
        selector = {"zone": rng.choice(["a", "b"])} if rng.random() < 0.3 else {}
        p = Pod(metadata=ObjectMeta(name=f"p{i}", namespace="default"),
                spec=PodSpec(containers=[Container(name="c", image="x",
                                                   resources=ResourceRequirements(limits=limits))],
                             node_selector=selector))
        p.spec.priority = rng.choice([0, 20, 60, 200])
        if rng.random() < 0.15:
            p.spec.preemption_policy = "Never"
        preemptors.append(p)
    return preemptors, nodes, assigned
