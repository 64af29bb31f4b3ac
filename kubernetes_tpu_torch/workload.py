"""Seeded scheduling workloads built from the port's API objects.

`synthetic_objects` is the repo's benchmark backlog (the generator in
`__graft_entry__._synthetic_objects`, over this package's objects): the
same seed draws the same `random.Random` stream and yields the same
pods, nodes and services. `small_cluster` is a fuzz cluster that
exercises every predicate and commit path of the solver at a few dozen
pods and nodes.
"""

from __future__ import annotations

import random
from typing import List, Tuple

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

Objects = Tuple[List[Pod], List[Node], List[Service]]


def synthetic_objects(n_pods: int, n_nodes: int, seed: int = 0) -> Objects:
    """Realistic mixed-workload API objects (pods, nodes, services):
    nodes of 8/16/32 cores and 16/32/64 GiB in four zones, one service
    per hundred pods, 5% of pods with a host port and 10% with a zone
    selector."""
    rng = random.Random(seed)
    zones = [f"z{i}" for i in range(4)]
    nodes = [
        Node(
            metadata=ObjectMeta(name=f"n{j}", labels={"zone": rng.choice(zones)}),
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
    pods = []
    for i in range(n_pods):
        app = f"app{rng.randrange(len(services))}"
        ports = (
            [ContainerPort(container_port=80, host_port=30000 + rng.randrange(64))]
            if rng.random() < 0.05
            else []
        )
        pods.append(
            Pod(
                metadata=ObjectMeta(
                    name=f"p{i}", namespace="default", labels={"app": app}
                ),
                spec=PodSpec(
                    containers=[
                        Container(
                            name="c",
                            image="app",
                            ports=ports,
                            resources=ResourceRequirements(
                                limits={
                                    "cpu": Quantity.from_milli(
                                        rng.choice([100, 250, 500, 1000])
                                    ),
                                    "memory": parse_quantity(
                                        f"{rng.choice([64, 128, 256, 512])}Mi"
                                    ),
                                }
                            ),
                        )
                    ],
                    node_selector=(
                        {"zone": rng.choice(zones)} if rng.random() < 0.1 else {}
                    ),
                ),
            )
        )
    return pods, nodes, services


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
