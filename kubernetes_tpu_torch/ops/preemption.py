"""Preemption on the card: minimal-victim selection as masked tensors.

The counterpart of `kubernetes_tpu/ops/preemption.py`. The selection
rule is the reference's, shared with the scalar yardstick
(`scheduler/batch.py preempt_backlog_scalar`):

- a node's candidate victims are its live, non-terminating assigned
  pods of strictly lower priority, ordered (priority asc, arrival idx
  asc);
- a node's victim set is the shortest prefix of that order whose freed
  cpu, memory and pod slots let the preemptor fit; a node where the
  preemptor fits with no eviction is not a candidate;
- the winner minimises (priority of the prefix's last victim, victim
  count, node index);
- preemptors run highest priority first, each grant charged before the
  next: its victims leave the alive mask and its request lands on the
  node, net of the freed capacity.

How the card does it (plain PyTorch, no hand kernel: there is no
per-step chain, only one launch sequence a preemptor):

- the victims are sorted once per problem by (node, priority, index), so
  each node's victims form one run; `v_prio < p_prio` keeps a prefix of
  each run, and victims already granted drop out by the alive mask;
- per-node prefix sums of the eligible victims' cpu, memory and count
  are a cumulative sum minus the node's offset, in float64. Requests
  and free capacity are integers (milli-cores, MiB, slots), so every
  sum is exact, as the scalar's Python floats are. (The JAX device path
  sums in float32 over the whole victim axis, which stops counting
  every integer past 2^24.) Unlimited capacity is +inf, as in both;
- the winner is picked on the card as the lexicographic minimum of
  (last victim's priority, count, node index), by three masked minima;
- a grant updates the alive mask, the free capacity and the record of
  who took which victim on the card. Nothing is read back until every
  preemptor has run: then the winners' nodes and the victims' owners
  come back in one copy each, and the victims of each grant are listed
  in eviction order;
- the nodeSelector masks are built once, per (key, value) pair.

Inputs: a `PreemptionProblem` of this module or of the JAX package's
(a dataclass of NumPy arrays and lists, read by attribute), and pods of
either package. Errors raise; nothing falls back to the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch import DeviceLike, resolve_device
from kubernetes_tpu_torch.models.columnar import (
    MIB,
    mem_to_mib_ceil,
    node_is_ready,
    pod_resource_limits,
)
from kubernetes_tpu_torch.models.objects import (
    RESOURCE_CPU,
    RESOURCE_MEMORY,
    RESOURCE_PODS,
    Node,
    Pod,
    pod_can_preempt,
    pod_full_key,
    pod_is_terminating,
    pod_priority,
)

#: Sentinel "no feasible victim prefix" for per-node k arrays.
INFEASIBLE = np.int32(2**31 - 1)

#: The rejection reason recorded for a preemptor no node could be freed
#: for (the JAX package's wording).
REASON_INFEASIBLE = (
    "no node can free enough capacity by evicting strictly "
    "lower-priority pods"
)

_I64_MAX = torch.iinfo(torch.int64).max


@dataclass
class PreemptionDecision:
    """One granted preemption: evict `victims` (pod keys, eviction
    order) on `node`, then nominate `key` there."""

    key: str  # preemptor pod key "ns/name"
    node: str
    victims: Tuple[str, ...]

    def to_wire(self) -> dict:
        """The /debug/decisions shape of a granted preemption."""
        return {"pod": self.key, "node": self.node, "victims": list(self.victims)}


@dataclass
class PreemptionProblem:
    """Host-lowered cluster state for one preemption pass."""

    node_names: List[str]
    node_labels: List[Dict[str, str]]
    node_ready: np.ndarray  # bool[N]
    free_cpu: np.ndarray  # f64[N], +inf = unlimited
    free_mem: np.ndarray
    free_pods: np.ndarray
    victim_keys: List[str]
    v_cpu: np.ndarray  # f64[V] milli-cores
    v_mem: np.ndarray  # f64[V] MiB
    v_prio: np.ndarray  # i64[V]
    v_node: np.ndarray  # i32[V]


def _pod_request(pod: Pod) -> Tuple[float, float]:
    cpu, mem = pod_resource_limits(pod)
    return float(cpu), float(mem_to_mib_ceil(mem))


def build_preemption_problem(nodes: Sequence[Node], assigned: Sequence[Pod]) -> PreemptionProblem:
    """Lower nodes and assigned pods into the preemption arrays. Every
    assigned pod charges its node (a Terminating victim holds its
    capacity until it exits); only live, non-terminating pods become
    victim rows."""
    nodes = list(nodes)
    index = {n.metadata.name: j for j, n in enumerate(nodes)}
    N = len(nodes)
    free_cpu = np.full(N, np.inf)
    free_mem = np.full(N, np.inf)
    free_pods = np.full(N, np.inf)
    ready = np.zeros(N, bool)
    labels: List[Dict[str, str]] = []
    for j, node in enumerate(nodes):
        cap = node.status.capacity or {}
        if RESOURCE_CPU in cap and cap[RESOURCE_CPU].milli_value() > 0:
            free_cpu[j] = cap[RESOURCE_CPU].milli_value()
        if RESOURCE_MEMORY in cap and cap[RESOURCE_MEMORY].value() > 0:
            free_mem[j] = cap[RESOURCE_MEMORY].value() // MIB
        if RESOURCE_PODS in cap and cap[RESOURCE_PODS].value() > 0:
            free_pods[j] = cap[RESOURCE_PODS].value()
        ready[j] = node_is_ready(node) and not node.spec.unschedulable
        labels.append(node.metadata.labels or {})
    keys: List[str] = []
    v_cpu: List[float] = []
    v_mem: List[float] = []
    v_prio: List[int] = []
    v_node: List[int] = []
    for pod in assigned:
        j = index.get(pod.spec.node_name, -1)
        if j < 0:
            continue
        cpu, mem = _pod_request(pod)
        free_cpu[j] -= cpu
        free_mem[j] -= mem
        free_pods[j] -= 1
        if pod.status.phase in ("Succeeded", "Failed") or pod_is_terminating(pod):
            continue  # occupies, but is not (or no longer) a candidate
        keys.append(pod_full_key(pod))
        v_cpu.append(cpu)
        v_mem.append(mem)
        v_prio.append(pod_priority(pod))
        v_node.append(j)
    return PreemptionProblem(
        node_names=[n.metadata.name for n in nodes],
        node_labels=labels,
        node_ready=ready,
        free_cpu=free_cpu,
        free_mem=free_mem,
        free_pods=free_pods,
        victim_keys=keys,
        v_cpu=np.asarray(v_cpu, np.float64),
        v_mem=np.asarray(v_mem, np.float64),
        v_prio=np.asarray(v_prio, np.int64),
        v_node=np.asarray(v_node, np.int32),
    )


def _selector_ok(problem, pod: Pod) -> np.ndarray:
    """bool[N]: node ready AND labels satisfy the pod's nodeSelector."""
    sel = pod.spec.node_selector or {}
    ok = np.asarray(problem.node_ready, bool).copy()
    if sel:
        for j, labels in enumerate(problem.node_labels):
            if ok[j] and any(labels.get(k) != v for k, v in sel.items()):
                ok[j] = False
    return ok


class _State:
    """One problem on the device: the victims sorted by (node, priority,
    index) with their requests as rows (cpu, memory, one slot), each
    node's offset into that order, the free capacity as the same three
    rows, the alive mask and the record of grants."""

    def __init__(self, problem, device: torch.device):
        v_node = np.asarray(problem.v_node, np.int64)
        v_prio = np.asarray(problem.v_prio, np.int64)
        V = v_node.shape[0]
        self.N = N = len(problem.node_names)
        order = np.lexsort((np.arange(V), v_prio, v_node))
        counts = np.bincount(v_node, minlength=N)[:N] if V else np.zeros(N, np.int64)
        start = np.concatenate([[0], np.cumsum(counts)[:-1]]) if N else np.zeros(0, np.int64)
        need = np.stack([np.asarray(problem.v_cpu, np.float64)[order],
                         np.asarray(problem.v_mem, np.float64)[order], np.ones(V)])
        free = np.stack([np.asarray(problem.free_cpu, np.float64),
                         np.asarray(problem.free_mem, np.float64),
                         np.asarray(problem.free_pods, np.float64)])

        def dev(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

        self.device = device
        self.order = order
        self.node = dev(v_node[order], torch.int64)
        self.prio = dev(v_prio[order], torch.int64)
        self.need = dev(need, torch.float64)  # (3, V): cpu, mem, 1
        self.start = dev(start, torch.int64)
        self.free = dev(free, torch.float64)  # (3, N): cpu, mem, slots
        self.alive = torch.ones(V, dtype=torch.bool, device=device)
        # taken[t]: the position in the run order of the preemptor that
        # evicts sorted victim t (-1: none).
        self.taken = torch.full((V,), -1, dtype=torch.int32, device=device)
        self.ready = dev(np.asarray(problem.node_ready, bool), torch.bool)
        self.arange_n = torch.arange(N, dtype=torch.int64, device=device)
        self._labels = problem.node_labels
        self._pair_masks: Dict[Tuple[str, str], torch.Tensor] = {}

    def node_ok(self, pod: Pod) -> torch.Tensor:
        """bool[N] on the device: ready and the nodeSelector holds, from
        one cached mask per (key, value) pair."""
        ok = self.ready
        for k, v in sorted((pod.spec.node_selector or {}).items()):
            mask = self._pair_masks.get((k, v))
            if mask is None:
                mask = torch.as_tensor(
                    np.asarray([labels.get(k) == v for labels in self._labels], bool),
                    device=self.device,
                )
                self._pair_masks[(k, v)] = mask
            ok = ok & mask
        return ok

    def request(self, p_cpu: float, p_mem: float) -> torch.Tensor:
        """(3, 1): what the preemptor needs free (cpu, memory, one slot)."""
        return torch.tensor([[p_cpu], [p_mem], [1.0]], dtype=torch.float64, device=self.device)


def candidate_prefixes(state: _State, node_ok: torch.Tensor, p_cpu: float, p_mem: float,
                       p_prio: int):
    """One preemptor's per-node minimal victim prefixes on the device:
    (k_min i64[N], INFEASIBLE where no prefix fits or the preemptor fits
    already; maxp i64[N], the priority of the prefix's last victim, 0
    where infeasible; eligible b[V] and freed (3, V), the per-node
    prefix sums of the eligible victims' cpu, memory and count, in the
    sorted order)."""
    N = state.N
    need = state.request(p_cpu, p_mem)
    eligible = state.alive & (state.prio < p_prio)
    # Per-node inclusive prefix sums: the global cumulative sum minus the
    # sum before the node's first victim (exact: integers in float64).
    csum = torch.cumsum(state.need * eligible, dim=1)
    before = torch.cat([csum.new_zeros(3, 1), csum], dim=1)[:, state.start]
    freed = csum - before[:, state.node]
    rank = freed[2].to(torch.int64)
    fits = eligible & node_ok[state.node] & (state.free[:, state.node] + freed >= need).all(dim=0)
    big = int(INFEASIBLE)
    k_min = torch.full((N,), big, dtype=torch.int64, device=state.device)
    k_min.scatter_reduce_(0, state.node, torch.where(fits, rank, big), "amin")
    fits0 = node_ok & (state.free >= need).all(dim=0)
    k_min = torch.where(fits0, big, k_min)
    # The prefix's last victim is the k-th eligible one of the node's
    # run: its priority is the largest of the prefix.
    last = fits & (rank == k_min[state.node])
    maxp = torch.zeros(N, dtype=torch.int64, device=state.device)
    maxp.scatter_add_(0, state.node, torch.where(last, state.prio, 0))
    return k_min, maxp, eligible, freed


def _grant(state: _State, slot: int, node_ok, p_cpu, p_mem, p_prio, winners) -> None:
    """Pick this preemptor's node on the device and charge the grant:
    the lexicographic minimum of (maxp, k, node index) over the nodes
    with a feasible prefix. No host read."""
    k_min, maxp, eligible, freed = candidate_prefixes(state, node_ok, p_cpu, p_mem, p_prio)
    feasible = k_min < int(INFEASIBLE)
    m_prio = torch.where(feasible, maxp, _I64_MAX).amin()
    tied = feasible & (maxp == m_prio)
    m_k = torch.where(tied, k_min, _I64_MAX).amin()
    j = torch.where(tied & (k_min == m_k), state.arange_n, state.N).amin()
    found = j < state.N
    chosen = eligible & (state.node == j) & (freed[2] <= m_k)
    state.alive &= ~chosen
    state.taken.masked_fill_(chosen, slot)
    # The node gains the victims' cpu, memory and slots and loses the
    # preemptor's (slots: k - 1).
    delta = (state.need * chosen).sum(dim=1, keepdim=True) - state.request(p_cpu, p_mem)
    state.free.index_add_(1, torch.clamp(j, max=state.N - 1).view(1), delta * found)
    winners[slot] = torch.where(found, j, -1)


def solve_preemption(problem, preemptors: Sequence[Pod],
                     device: DeviceLike = None) -> List[Optional[PreemptionDecision]]:
    """Victim selection for each preemptor on `device` (default: the
    CUDA card; raises without one). Preemptors run highest priority
    first; each grant marks its victims dead and charges the preemptor's
    request onto the node (net of the freed capacity), so later
    preemptors see the cluster after it. Returns decisions aligned with
    `preemptors` (None: no feasible node, may not preempt, or dominates
    no victim)."""
    device = resolve_device(device)
    out: List[Optional[PreemptionDecision]] = [None] * len(preemptors)
    runs = []
    for i in sorted(range(len(preemptors)), key=lambda t: (-pod_priority(preemptors[t]), t)):
        pod = preemptors[i]
        if pod_priority(pod) > 0 and pod_can_preempt(pod):
            runs.append(i)
    if not runs or not problem.node_names:
        return out
    state = _State(problem, device)
    winners = torch.full((len(runs),), -1, dtype=torch.int64, device=device)
    for slot, i in enumerate(runs):
        pod = preemptors[i]
        cpu, mem = _pod_request(pod)
        _grant(state, slot, state.node_ok(pod), cpu, mem, pod_priority(pod), winners)
    nodes = winners.cpu().numpy()
    taken = state.taken.cpu().numpy()
    t = np.nonzero(taken >= 0)[0]
    t = t[np.argsort(taken[t], kind="stable")]  # by grant; eviction order within one
    bounds = np.searchsorted(taken[t], np.arange(len(runs) + 1))
    for slot, i in enumerate(runs):
        j = int(nodes[slot])
        if j < 0:
            continue
        victims = state.order[t[bounds[slot]:bounds[slot + 1]]]
        out[i] = PreemptionDecision(
            key=pod_full_key(preemptors[i]),
            node=problem.node_names[j],
            victims=tuple(problem.victim_keys[v] for v in victims),
        )
    return out
