"""Gang scheduling: PodGroup partitioning and all-or-nothing acceptance.

The counterpart of `kubernetes_tpu/scheduler/gang.py`, with its span
tree: `gang_solve` runs under a `gang` span and times each round's
acceptance reduction as phase `gang_accept` (also into an optional
PhaseTimer). Group outcomes are the returned accepted and rejected
lists; the scheduler daemon counts them, and its atomic commits'
rollbacks, in `gang_solve_outcomes_total` (OUTCOMES).

- pods join a group through the POD_GROUP_LABEL label naming a PodGroup
  in their namespace;
- `partition_backlog` splits a drained backlog into GangGroups, each
  with the group's minMember and the count of members already bound
  (earlier ticks count toward the gang);
- `gang_solve` wraps a backlog solver in the acceptance loop: solve,
  reduce the placed members per group, reject every group short of
  minMember, and re-solve the surviving backlog from scratch against
  the same cluster state, until no group is newly rejected. Re-solving
  keeps the sequential decisions of every path equal: downstream
  choices depend on the whole committed prefix.

`drop_partial_gang_preemptions` guards preemption grants: a gang
member preempts for the whole gang or not at all.

NumPy is imported where a solve counts members, not at import: the
controller-manager's gang controller imports this module for
`OUTCOMES` and `pod_is_live`, and its process loads no numpy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.models.objects import POD_GROUP_LABEL, Pod, pod_full_key
from kubernetes_tpu_torch.utils import metrics
from kubernetes_tpu_torch.utils.tracing import PhaseTimer, phase, span, timing

#: Group-level outcomes: accepted and rejected by a tick's acceptance
#: loop, bind_rollback when an atomic commit conflicted server-side.
OUTCOMES = metrics.DEFAULT.counter(
    "gang_solve_outcomes_total",
    "PodGroup gang outcomes by kind",
    ("outcome",),
)


def pod_group_name(pod: Pod) -> str:
    """The PodGroup this pod belongs to ('' = ungrouped)."""
    return (pod.metadata.labels or {}).get(POD_GROUP_LABEL, "")


def pod_is_live(pod: Pod) -> bool:
    """Gang membership counts live pods only: a terminal or terminating
    member keeps its label and nodeName but no longer holds a slot, so
    crediting it would let its replacement bind below minMember."""
    return (
        pod.status.phase not in ("Succeeded", "Failed")
        and not pod.metadata.deletion_timestamp
    )


def group_key(namespace: str, name: str) -> str:
    return f"{namespace or 'default'}/{name}"


@dataclass
class GangGroup:
    """One PodGroup's slice of a drained backlog."""

    key: str  # "namespace/name"
    name: str
    namespace: str
    min_member: int
    indices: List[int] = field(default_factory=list)  # positions in pending
    bound: int = 0  # members already bound (count toward minMember)


def partition_backlog(
    pending: Sequence[Pod],
    assigned: Sequence[Pod] = (),
    min_member_of: Optional[Callable[[str, str], Optional[int]]] = None,
) -> List[GangGroup]:
    """The backlog's gang groups, sorted by key (ungrouped pods are
    absent). `min_member_of(namespace, name)` gives a group's minMember;
    None (an unknown group) degrades it to minMember 0, ordinary per-pod
    scheduling. Live members in `assigned` with a node count as bound."""
    groups: Dict[str, GangGroup] = {}
    for i, pod in enumerate(pending):
        name = pod_group_name(pod)
        if not name:
            continue
        ns = pod.metadata.namespace or "default"
        key = group_key(ns, name)
        g = groups.get(key)
        if g is None:
            mm = min_member_of(ns, name) if min_member_of is not None else None
            g = groups[key] = GangGroup(
                key=key, name=name, namespace=ns, min_member=int(mm or 0)
            )
        g.indices.append(i)
    if groups:
        for pod in assigned:
            name = pod_group_name(pod)
            if not name or not pod.spec.node_name or not pod_is_live(pod):
                continue
            g = groups.get(group_key(pod.metadata.namespace or "default", name))
            if g is not None:
                g.bound += 1
    return [groups[k] for k in sorted(groups)]


def member_counts_host(
    placed: np.ndarray, group_ids: np.ndarray, num_groups: int
) -> np.ndarray:
    """NumPy twin of `ops.matrices.gang_member_counts`."""
    import numpy as np

    mask = placed & (group_ids >= 0)
    return np.bincount(
        group_ids[mask], minlength=num_groups
    ).astype(np.int32)[:num_groups]


Solver = Callable[
    [Sequence[Pod], Sequence[object], Sequence[Pod], Sequence[object]],
    List[Optional[str]],
]


def gang_solve(
    solver: Solver,
    pending: Sequence[Pod],
    nodes,
    assigned: Sequence[Pod] = (),
    services=(),
    groups: Sequence[GangGroup] = (),
    counts_fn: Optional[Callable] = None,
    timer: Optional[PhaseTimer] = None,
) -> Tuple[List[Optional[str]], List[GangGroup], List[GangGroup]]:
    """Solve `pending` with group-level all-or-nothing acceptance.

    Returns (destinations, accepted_groups, rejected_groups), the
    destinations aligned with `pending`; every pod of a rejected group
    maps to None. Each round re-solves the surviving backlog, so the
    capacity a rejected gang would have taken goes to the rest. It ends
    within len(groups) + 1 rounds: each round converges or rejects at
    least one more group."""
    import numpy as np

    counts_fn = counts_fn or member_counts_host
    n = len(pending)
    if not groups:
        return list(solver(pending, nodes, assigned, services)), [], []
    group_ids = np.full(n, -1, np.int32)
    for gi, g in enumerate(groups):
        for i in g.indices:
            group_ids[i] = gi
    destinations: List[Optional[str]] = [None] * n
    rejected: set = set()
    with timing(timer), span("gang", groups=len(groups), pods=n):
        while True:
            active = [i for i in range(n) if group_ids[i] not in rejected]
            dests = (
                solver([pending[i] for i in active], nodes, assigned, services)
                if active
                else []
            )
            destinations = [None] * n
            for i, d in zip(active, dests):
                destinations[i] = d
            with phase("gang_accept", groups=len(groups)):
                placed = np.fromiter(
                    (d is not None for d in destinations), bool, count=n
                )
                counts = counts_fn(placed, group_ids, len(groups))
            newly = [
                gi
                for gi, g in enumerate(groups)
                if gi not in rejected
                and int(counts[gi]) + g.bound < g.min_member
            ]
            if not newly:
                break
            rejected.update(newly)
    accepted = [g for gi, g in enumerate(groups) if gi not in rejected]
    denied = [g for gi, g in enumerate(groups) if gi in rejected]
    return destinations, accepted, denied


def drop_partial_gang_preemptions(
    unbound: Sequence[Pod],
    candidates: Sequence[Pod],
    decisions: Sequence[Optional[object]],
    covered_keys: frozenset = frozenset(),
    groups: Sequence[GangGroup] = (),
) -> Tuple[List[Optional[object]], List[str]]:
    """A preemptor that belongs to a PodGroup preempts for the whole
    gang or not at all, so that no victim dies for a gang the
    all-or-nothing solve then refuses. A gang's grants stand only if

    - every unbound member visible this tick got a grant this pass or
      already holds a nomination (`covered_keys`); a member left out of
      `candidates` vetoes too;
    - where `groups` names the gang, grants, covered and already-bound
      members together reach its minMember (members in backoff are not
      in `unbound`).

    `decisions` aligns with `candidates`. Returns the filtered decisions
    and the dropped gangs' keys."""
    need: Dict[str, set] = {}
    for pod in unbound:
        name = pod_group_name(pod)
        if name:
            key = group_key(pod.metadata.namespace or "default", name)
            need.setdefault(key, set()).add(pod_full_key(pod))
    if not need:
        return list(decisions), []
    granted = {
        pod_full_key(c): i
        for i, (c, d) in enumerate(zip(candidates, decisions))
        if d is not None
    }
    floor_of = {g.key: (g.min_member, g.bound) for g in groups}
    out = list(decisions)
    dropped: List[str] = []
    for gkey, keys in sorted(need.items()):
        ok_count = sum(1 for k in keys if k in granted or k in covered_keys)
        min_member, bound = floor_of.get(gkey, (0, 0))
        if ok_count == len(keys) and ok_count + bound >= min_member:
            continue
        had_any = False
        for k in keys:
            i = granted.get(k)
            if i is not None:
                out[i] = None
                had_any = True
        if had_any:
            dropped.append(gkey)
    return out, dropped
