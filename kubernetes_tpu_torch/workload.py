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
distribution.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
    ResourceRequirements,
    Service,
    ServiceSpec,
    Volume,
)
from kubernetes_tpu_torch.models.quantity import Quantity, parse_quantity
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
