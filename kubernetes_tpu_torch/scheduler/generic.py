"""Generic scheduler: filter -> score -> select.

Reference: plugin/pkg/scheduler/generic_scheduler.go:60-171. One
deliberate deviation: selectHost breaks score ties by picking the
lowest node index in list order (optionally seeded-random like the
reference's `random.Int() % len(hosts)`), so the scalar and TPU batch
paths are bit-for-bit comparable. The reference randomizes ties.

The port's copy of `kubernetes_tpu/scheduler/generic.py`, line for
line: the scalar path of the full re-lower daemon (a policy that does
not lower to the card) and the yardstick the card's decisions are held
to. Pure Python; no torch.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Set

from kubernetes_tpu_torch.models.objects import Pod
from kubernetes_tpu_torch.scheduler.types import (
    FitPredicate,
    HostPriority,
    PriorityConfig,
    StaticNodeLister,
    StaticPodLister,
    map_pods_to_machines,
)
from kubernetes_tpu_torch.scheduler.priorities import equal_priority


class NoNodesError(Exception):
    """ErrNoNodesAvailable."""


class FitError(Exception):
    """No node fits; carries per-node failed predicate names."""

    def __init__(self, pod: Pod, failed_predicates: Dict[str, Set[str]]):
        self.pod = pod
        self.failed_predicates = failed_predicates
        super().__init__(
            f"pod {pod.metadata.name!r} fits on no node: "
            + "; ".join(
                f"{node}: {sorted(names)}"
                for node, names in sorted(failed_predicates.items())
            )
        )


def find_nodes_that_fit(
    pod: Pod,
    pod_lister: StaticPodLister,
    predicates: Dict[str, FitPredicate],
    nodes: List,
):
    """generic_scheduler.go:106-134 — the O(pods x nodes x predicates)
    hot loop the TPU path matricizes."""
    filtered = []
    machine_to_pods = map_pods_to_machines(pod_lister)
    failed: Dict[str, Set[str]] = {}
    for node in nodes:
        name = node.metadata.name
        fits = True
        for pred_name, predicate in predicates.items():
            if not predicate(pod, machine_to_pods.get(name, []), name):
                fits = False
                failed.setdefault(name, set()).add(pred_name)
                break
        if fits:
            filtered.append(node)
    return filtered, failed


def prioritize_nodes(
    pod: Pod,
    pod_lister: StaticPodLister,
    priority_configs: Sequence[PriorityConfig],
    minion_lister: StaticNodeLister,
) -> List[HostPriority]:
    """generic_scheduler.go:142-171: weighted sum of per-function scores."""
    if not priority_configs:
        return equal_priority(pod, pod_lister, minion_lister)
    combined: Dict[str, int] = {}
    for config in priority_configs:
        if config.weight == 0:
            continue
        for entry in config.function(pod, pod_lister, minion_lister):
            combined[entry.host] = combined.get(entry.host, 0) + entry.score * config.weight
    return [HostPriority(host, score) for host, score in combined.items()]


class GenericScheduler:
    def __init__(
        self,
        predicates: Dict[str, FitPredicate],
        prioritizers: Sequence[PriorityConfig],
        pod_lister: StaticPodLister,
        rng: Optional[random.Random] = None,
    ):
        self.predicates = predicates
        self.prioritizers = list(prioritizers)
        self.pod_lister = pod_lister
        self.rng = rng  # None => deterministic first-best tie-break

    def schedule(self, pod: Pod, minion_lister: StaticNodeLister) -> str:
        nodes = minion_lister.list()
        if not nodes:
            raise NoNodesError()
        filtered, failed = find_nodes_that_fit(
            pod, self.pod_lister, self.predicates, nodes
        )
        priority_list = prioritize_nodes(
            pod, self.pod_lister, self.prioritizers, StaticNodeLister(filtered)
        )
        if not priority_list:
            raise FitError(pod, failed)
        return self.select_host(priority_list)

    def select_host(self, priority_list: List[HostPriority]) -> str:
        """generic_scheduler.go:90-102; ties broken deterministically by
        list order unless an rng is supplied."""
        if not priority_list:
            raise ValueError("empty priority list")
        best = max(e.score for e in priority_list)
        hosts = [e.host for e in priority_list if e.score == best]
        if self.rng is not None:
            return hosts[self.rng.randrange(len(hosts))]
        return hosts[0]
