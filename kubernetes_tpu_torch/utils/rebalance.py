"""The defrag planner's host half: the movable worklist, the plan and its
gang-atomic, budget-clipped grouping, and the rebalance monitor.

The counterpart of `kubernetes_tpu/utils/rebalance.py`. Series, under
the JAX names: `rebalance_moves_total{outcome}` (planned, evicted,
rebound, recovered, failed, stranded), `rebalance_score_improvement`
and `rebalance_moves_per_improvement` (one observation a defrag cycle),
`rebalance_stranded_pods_total`. `RebalanceMonitor` (`DEFAULT`) keeps
the outcome table, the last plan and cycle and a trend ring of the
improvement, the snapshot the JAX package serves as `/debug/rebalance`;
the descheduler (`controllers/descheduler.py`) feeds it.

`planned` is counted in the series by `build_plan`, for every plan it
returns (as since the port's first planner), not when the descheduler
executes a plan as in JAX; `RebalanceMonitor.record_move("planned")`
adds to the outcome table only, where the JAX descheduler counts both,
so the table equals the JAX one. `build_plan` stages the
movable pods largest first (best-fit-decreasing, the order the plan
expects), runs `ops/rebalance.py plan_moves` (K2 on the card) against
the occupancy columns, then drops every gang whose movable members were
only partly replanned and clips the budget by group, best summed gain
first, forced drains always kept.

One deliberate departure: the JAX `build_plan` and `fragment_score`
catch every exception and return None. These do not: a device, build or
kernel error propagates to the caller. None still means what it means
there when nothing failed: nothing movable, or no budget.

Nothing pads the node or the pod axis (PyTorch has no executable to
reuse across shapes); padding changes no output. Phases of an optional
PhaseTimer: `stage` (host worklist and arrays), `plan` (the plan, read
back) and `group` (host grouping and clipping).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch import DeviceLike, resolve_device
from kubernetes_tpu_torch.models.columnar import mem_to_mib_ceil, pod_resource_limits
from kubernetes_tpu_torch.models.objects import (
    POD_GROUP_LABEL,
    REBALANCE_DEST_ANNOTATION,
    pod_full_key,
    pod_is_terminating,
)
from kubernetes_tpu_torch.ops.rebalance import plan_moves
from kubernetes_tpu_torch.utils.capacity import COLUMN_KEYS, probe_arrays
from kubernetes_tpu_torch.utils import metrics
from kubernetes_tpu_torch.utils.debug import cold_report
from kubernetes_tpu_torch.utils.profiler import RATIO_BUCKETS
from kubernetes_tpu_torch.utils.tracing import PhaseTimer, phase, timing

MOVES = metrics.DEFAULT.counter(
    "rebalance_moves_total",
    "Descheduler move pipeline by outcome: planned/evicted/rebound/"
    "failed/stranded",
    ("outcome",),
)

IMPROVEMENT = metrics.DEFAULT.histogram(
    "rebalance_score_improvement",
    "Per-defrag-cycle drop in the cluster fragmentation score "
    "(score_before - score_after, clamped at 0)",
    buckets=RATIO_BUCKETS,
)
MOVES_PER_IMPROVEMENT = metrics.DEFAULT.histogram(
    "rebalance_moves_per_improvement",
    "Evictions spent per unit of measured fragmentation-score "
    "improvement in one defrag cycle (saturates at the ladder cap "
    "when a cycle moves pods without moving the score)",
)
STRANDED = metrics.DEFAULT.counter(
    "rebalance_stranded_pods_total",
    "Pods evicted by a defrag move that never re-bound (move journal "
    "recovery exhausted)",
)

#: Observed into the efficiency histogram when a cycle executes moves
#: and the score does not improve.
EFFICIENCY_SATURATION = 120.0

#: Length of the monitor's ring of per-cycle improvements.
TREND_LEN = 120

#: The JAX package pads the movable worklist to pow2 buckets >= this.
POD_BUCKET_MIN = 8

#: Default per-cycle move budget (the descheduler's).
DEFAULT_MOVE_BUDGET = 32


def movable_pods(pods) -> List:
    """The defrag worklist of a pod listing: bound, live phase, not
    Terminating, not itself a replacement mid-move (carrying the
    destination annotation)."""
    out = []
    for p in pods:
        if not p.spec.node_name:
            continue
        if p.status.phase in ("Succeeded", "Failed"):
            continue
        if pod_is_terminating(p):
            continue
        if (p.metadata.annotations or {}).get(REBALANCE_DEST_ANNOTATION):
            continue
        out.append(p)
    return out


def stage_rows(cols: Dict[str, np.ndarray], node_names: Sequence[Optional[str]], pods,
               forced_nodes: Sequence[str] = ()):
    """The movable worklist largest first (cpu, then memory, descending;
    the name breaks ties) and its row arrays: (rows, pod_cpu f32[D],
    pod_mem f32[D], pod_node i32[D], pod_live bool[D], pod_force
    bool[D]); rows are (cpu, mem, pod)."""
    forced = frozenset(forced_nodes)
    index = {str(name): j for j, name in enumerate(node_names) if name is not None}
    rows = []
    for p in movable_pods(pods):
        cpu, mem = pod_resource_limits(p)
        rows.append((float(cpu), float(mem_to_mib_ceil(mem)), p))
    rows.sort(key=lambda r: (-r[0], -r[1], r[2].metadata.name))
    d = len(rows)
    pod_cpu = np.fromiter((r[0] for r in rows), np.float32, d)
    pod_mem = np.fromiter((r[1] for r in rows), np.float32, d)
    pod_node = np.fromiter((index.get(r[2].spec.node_name, -1) for r in rows), np.int32, d)
    pod_live = pod_node >= 0
    pod_force = np.fromiter((r[2].spec.node_name in forced for r in rows), bool, d)
    return rows, pod_cpu, pod_mem, pod_node, pod_live, pod_force


def _gang_key(p) -> str:
    g = (p.metadata.labels or {}).get(POD_GROUP_LABEL, "")
    ns = p.metadata.namespace or "default"
    return f"{ns}/{g}" if g else ""


def group_plan(rows, node_names, pod_force, dest, moved, gain, move_budget: int,
               score_before: float, score_after: float) -> dict:
    """The plan dict from the per-row results: gang-atomic (a gang
    partly replanned moves not at all), then the budget clipped by
    group, forced groups first, then best summed gain, then the group
    key."""
    moves = []
    gang_total: Dict[str, int] = {}
    gang_moved: Dict[str, int] = {}
    for i, (_cpu, _mem, p) in enumerate(rows):
        g = _gang_key(p)
        if g:
            gang_total[g] = gang_total.get(g, 0) + 1
            if moved[i]:
                gang_moved[g] = gang_moved.get(g, 0) + 1
        if not moved[i]:
            continue
        j = int(dest[i])
        to = node_names[j] if j < len(node_names) and node_names[j] is not None else None
        if to is None:
            continue  # a destination on a free slot: unusable
        moves.append({
            "pod": pod_full_key(p),
            "name": p.metadata.name,
            "namespace": p.metadata.namespace or "default",
            "from": p.spec.node_name,
            "to": str(to),
            "gain": int(gain[i]),
            "forced": bool(pod_force[i]),
            "group": g or pod_full_key(p),
            "gang": bool(g),
        })

    partial = {g for g, tot in gang_total.items() if 0 < gang_moved.get(g, 0) < tot}
    n_planned = len(moves)
    moves = [m for m in moves if m["group"] not in partial]

    groups: Dict[str, dict] = {}
    for m in moves:
        e = groups.setdefault(
            m["group"],
            {"group": m["group"], "moves": 0, "gain": 0, "forced": False, "gang": m["gang"]},
        )
        e["moves"] += 1
        e["gain"] += m["gain"]
        e["forced"] = e["forced"] or m["forced"]
    ranked = sorted(groups.values(), key=lambda e: (not e["forced"], -e["gain"], e["group"]))
    kept_groups = set()
    used = 0
    for e in ranked:
        if used + e["moves"] > move_budget and not e["forced"]:
            continue
        kept_groups.add(e["group"])
        used += e["moves"]
    moves = [m for m in moves if m["group"] in kept_groups]

    before = float(score_before)
    after = float(score_after)
    return {
        "kind": "RebalancePlan",
        "score_before": round(before, 6),
        "score_after": round(after, 6),
        "improvement": round(max(before - after, 0.0), 6),
        "move_budget": int(move_budget),
        "movable_pods": len(rows),
        "planned_moves": n_planned,
        "dropped_partial_gangs": sorted(partial),
        "moves": moves,
        "groups": [dict(e) for e in ranked if e["group"] in kept_groups],
    }


def _node_columns(cols: Dict[str, np.ndarray]):
    return tuple(cols[k] for k in COLUMN_KEYS)


def build_plan(
    cols: Dict[str, np.ndarray],
    node_names: Sequence[Optional[str]],
    pods,
    probes: Sequence[Tuple[str, float, float, int]],
    move_budget: int = DEFAULT_MOVE_BUDGET,
    forced_nodes: Sequence[str] = (),
    device: DeviceLike = None,
    timer: Optional[PhaseTimer] = None,
) -> Optional[dict]:
    """One defrag plan on `device` (default: the CUDA card; raises
    without one): the plan dict, or None when nothing is movable or the
    budget is not positive. Errors raise."""
    device = resolve_device(device)
    move_budget = int(move_budget)
    with timing(timer):
        with phase("stage"):
            rows, pod_cpu, pod_mem, pod_node, pod_live, pod_force = stage_rows(
                cols, node_names, pods, forced_nodes)
            if not rows or move_budget <= 0:
                return None
            probe = probe_arrays(probes)
        with phase("plan"):
            out = plan_moves(*_node_columns(cols), pod_cpu, pod_mem, pod_node, pod_live,
                             pod_force, *probe, move_budget, device=device)
            dest, moved, gain, _n, before, after = (t.cpu().numpy() for t in out)
        with phase("group"):
            plan = group_plan(rows, node_names, pod_force, dest, moved, gain, move_budget,
                              before, after)
    if plan and plan["moves"]:
        MOVES.inc(len(plan["moves"]), outcome="planned")
    return plan


def fragment_score(cols: Dict[str, np.ndarray], probes: Sequence[Tuple[str, float, float, int]],
                   device: DeviceLike = None) -> float:
    """The fragmentation score of the occupancy columns under the probe
    set: the plan with no rows, whose score_before is the score. Errors
    raise."""
    device = resolve_device(device)
    empty = np.zeros(0, np.float32)
    out = plan_moves(*_node_columns(cols), empty, empty, np.zeros(0, np.int32),
                     np.zeros(0, bool), np.zeros(0, bool), *probe_arrays(probes), 0,
                     device=device)
    return float(out[4])


class RebalanceMonitor:
    """The process's rebalance bookkeeping: the outcome table, the last
    plan and cycle, the trend ring and the snapshot. Thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._trend: deque = deque(maxlen=TREND_LEN)
        self.samples = 0
        self._last_plan: Optional[dict] = None
        self._last_cycle: Optional[dict] = None
        self._outcomes: Dict[str, int] = {}

    def reset(self) -> None:
        with self._lock:
            self._trend.clear()
            self.samples = 0
            self._last_plan = None
            self._last_cycle = None
            self._outcomes = {}

    def record_move(self, outcome: str, count: int = 1) -> None:
        """`count` moves reached `outcome`: the series (but for
        `planned`, which `build_plan` counted) and the outcome table;
        `stranded` also counts in `rebalance_stranded_pods_total`."""
        if count <= 0:
            return
        if outcome != "planned":
            MOVES.inc(count, outcome=outcome)
        if outcome == "stranded":
            STRANDED.inc(count)
        with self._lock:
            self._outcomes[outcome] = self._outcomes.get(outcome, 0) + count

    def record_plan(self, plan: dict) -> None:
        with self._lock:
            self._last_plan = plan

    def record_cycle(self, score_before: float, score_after: float, moves_executed: int,
                     trigger: str = "periodic") -> dict:
        """One executed cycle: the improvement and efficiency
        histograms, the trend ring; returns the cycle's summary."""
        improvement = max(float(score_before) - float(score_after), 0.0)
        IMPROVEMENT.observe(improvement)
        if moves_executed > 0:
            MOVES_PER_IMPROVEMENT.observe(
                min(moves_executed / improvement, EFFICIENCY_SATURATION) if improvement > 0
                else EFFICIENCY_SATURATION)
        cycle = {
            "trigger": trigger,
            "score_before": round(float(score_before), 6),
            "score_after": round(float(score_after), 6),
            "improvement": round(improvement, 6),
            "moves_executed": int(moves_executed),
        }
        with self._lock:
            self.samples += 1
            self._trend.append(round(improvement, 6))
            self._last_cycle = cycle
        return cycle

    def snapshot(self) -> dict:
        """The latest plan, cycle and outcomes; `sampled: false` before
        the first cycle."""
        with self._lock:
            if self.samples == 0:
                return cold_report("rebalance")
            return {
                "kind": "RebalanceReport",
                "sampled": True,
                "samples": self.samples,
                "last_plan": dict(self._last_plan or {}),
                "last_cycle": dict(self._last_cycle or {}),
                "moves": list((self._last_plan or {}).get("moves", [])),
                "outcomes": dict(self._outcomes),
                "trend": list(self._trend),
            }


DEFAULT = RebalanceMonitor()
