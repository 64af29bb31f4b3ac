"""Scheduling flight recorder: a bounded per-decision ring.

The port's copy of `kubernetes_tpu/utils/flightrecorder.py` (reference
lineage: the per-predicate failure reasons of generic_scheduler.go's
FitError, upgraded from a flattened string to queryable records).

Each tick of a scheduler daemon appends one `Decision` per drained pod
(outcome, chosen node, and for a bounded subset the per-node predicate
verdicts and the winner's score decomposition) and one `SolveRecord`
(mode, duration, wave and Sinkhorn convergence), both carrying the
tick's trace id, so `/debug/decisions` and `/debug/solves` join against
`/debug/traces`. The preemption pass and the descheduler amend a pod's
newest decision (`record_preemption`).

Bounds: at most `_CONFIG["ring"]` decisions (4,096, newest win) and 512
solve records; verdict tables for at most `explain_limit` pods a tick
(64) with `explain_top_k` feasible candidates (3) and
`explain_failed_nodes` infeasible nodes (16) each. A 50k-pod drain
records 50k outcomes but never 50k tables. This is host bookkeeping;
the readback it stores runs in `ops.pipeline.explain_backlog` on the
daemon's card.

The solve telemetry lands here too: the iterations a solve ran
(`scheduler_solve_iterations{mode}`), Sinkhorn's last residual
(`scheduler_sinkhorn_residual`), and the figures parked for the daemon
that ran the solve (`take_last_solve_telemetry`, consumed once).

The sanitizer's `flightrecorder.ring` lock guards the rings and
`flightrecorder.lastsolve` the parked solve figures, under JAX's names
(`utils/sanitizer.py`).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from kubernetes_tpu_torch.utils import metrics, sanitizer

#: Decision outcome events recorded, by outcome: one a drained pod a
#: tick (bound / unschedulable / bind_error / bind_conflict /
#: gang_rejected) plus one a preemption verdict (preempt_*,
#: rebalance_nominated). An event counter, not a ring gauge.
DECISIONS_TOTAL = metrics.DEFAULT.counter(
    "scheduler_decisions_total",
    "Decision outcome events recorded by the flight recorder (solve "
    "outcomes plus preemption verdicts), by outcome",
    ("outcome",),
)

#: Final Sinkhorn column-mass residual (log domain) of the latest solve.
SINKHORN_RESIDUAL = metrics.DEFAULT.gauge(
    "scheduler_sinkhorn_residual",
    "Final Sinkhorn column-mass residual (log domain) of the latest solve",
)

#: Device solve iterations per solve, by mode. Buckets are powers of two:
#: iteration counts, not seconds.
SOLVE_ITERATIONS = metrics.DEFAULT.histogram(
    "scheduler_solve_iterations",
    "Device solve iterations per solve (waves / Sinkhorn price updates)",
    ("mode",),
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096),
)

_LAST_SOLVE_LOCK = sanitizer.lock("flightrecorder.lastsolve")
_LAST_SOLVE: Optional[dict] = None


def observe_solve_telemetry(mode: str, iterations: int, residual: Optional[float] = None,
                            waves: Optional[int] = None) -> None:
    """One solve's convergence telemetry: the iteration histogram, the
    residual gauge for the Sinkhorn family, and the figures parked for
    take_last_solve_telemetry(), so the daemon that ran a wave or
    Sinkhorn batch solve (whose wrappers return placements only) can
    stamp them on its SolveRecord."""
    global _LAST_SOLVE
    SOLVE_ITERATIONS.observe(float(iterations), mode=mode)
    if residual is not None:
        SINKHORN_RESIDUAL.set(float(residual))
    with _LAST_SOLVE_LOCK:
        _LAST_SOLVE = {
            "mode": mode,
            "iterations": int(iterations),
            "waves": int(waves if waves is not None else iterations),
            "residual": None if residual is None else float(residual),
        }


def take_last_solve_telemetry() -> Optional[dict]:
    """Pop the latest solve's telemetry (None when nothing is parked).
    Consume-once: a later tick never inherits stale figures."""
    global _LAST_SOLVE
    with _LAST_SOLVE_LOCK:
        tele, _LAST_SOLVE = _LAST_SOLVE, None
        return tele


#: Decision sinks: callables (pod_key, outcome) called for every
#: decision, outside the ring lock; a sink's raise is swallowed.
_DECISION_SINKS: List = []


def add_decision_sink(fn) -> None:
    """Sinks must be idempotent a pod key: a decision is announced once
    early (notify_decision_sinks, before the explain readback) and again
    when the records land (record())."""
    _DECISION_SINKS.append(fn)


def notify_decision_sinks(pods_outcomes) -> None:
    """The early announcement of a tick's outcomes, before the explain
    readback, which may take longer than a fast pod's whole life."""
    for pod, outcome in pods_outcomes:
        for sink in _DECISION_SINKS:
            try:
                sink(pod, outcome)
            except Exception:
                pass  # a broken sink must not sink the tick


_CONFIG = {
    # Decision ring bound (newest win).
    "ring": 4096,
    # Solve-record ring bound (one entry a tick).
    "solve_ring": 512,
    # Feasible candidates kept with their score decomposition, and
    # infeasible nodes listed one by one (the rest fold into
    # reasonCounts).
    "explain_top_k": 3,
    "explain_failed_nodes": 16,
    # Pods a tick that get verdict tables (0 disables the capture;
    # outcome records always land).
    "explain_limit": 64,
}


def configure(ring: Optional[int] = None, solve_ring: Optional[int] = None,
              explain_top_k: Optional[int] = None, explain_failed_nodes: Optional[int] = None,
              explain_limit: Optional[int] = None) -> None:
    if ring is not None:
        _CONFIG["ring"] = int(ring)
    if solve_ring is not None:
        _CONFIG["solve_ring"] = int(solve_ring)
    if explain_top_k is not None:
        _CONFIG["explain_top_k"] = int(explain_top_k)
    if explain_failed_nodes is not None:
        _CONFIG["explain_failed_nodes"] = int(explain_failed_nodes)
    if explain_limit is not None:
        _CONFIG["explain_limit"] = int(explain_limit)


def explain_top_k() -> int:
    return _CONFIG["explain_top_k"]


def explain_failed_nodes() -> int:
    return _CONFIG["explain_failed_nodes"]


def explain_limit() -> int:
    return _CONFIG["explain_limit"]


def _wall_stamp() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(time.time()))


@dataclass
class Decision:
    """One pod's scheduling decision in one tick."""

    pod: str  # "namespace/name"
    tick: int
    trace_id: str
    mode: str
    outcome: str
    node: str = ""  # the chosen node ("" when unplaced)
    group: str = ""  # the PodGroup key of a gang member
    # Explain verdicts (for at most explain_limit pods a tick): the
    # top-k feasible candidates with their score decomposition and the
    # infeasible nodes listed one by one; the rest in reason_counts.
    verdicts: List[dict] = field(default_factory=list)
    reason_counts: Dict[str, int] = field(default_factory=dict)
    feasible_nodes: int = -1  # -1: no verdicts captured
    total_nodes: int = 0
    # The preemption verdict (amended by the preemption pass).
    nominated_node: str = ""
    victims: Tuple[str, ...] = ()
    reason: str = ""
    time: str = field(default_factory=_wall_stamp)

    def attach(self, entry: dict) -> None:
        """Fold one `ops.pipeline.explain_backlog` entry (the verdict
        table) into this decision."""
        self.feasible_nodes = int(entry.get("feasibleNodes", 0))
        self.total_nodes = int(entry.get("totalNodes", 0))
        self.verdicts = list(entry.get("nodes", ()))
        self.reason_counts = dict(entry.get("reasonCounts", {}))

    def to_dict(self) -> dict:
        d = {
            "pod": self.pod,
            "tick": self.tick,
            "traceId": self.trace_id,
            "mode": self.mode,
            "outcome": self.outcome,
            "time": self.time,
        }
        if self.node:
            d["node"] = self.node
        if self.group:
            d["group"] = self.group
        if self.feasible_nodes >= 0:
            d["feasibleNodes"] = self.feasible_nodes
            d["totalNodes"] = self.total_nodes
            d["nodes"] = self.verdicts
            d["reasonCounts"] = self.reason_counts
        if self.nominated_node:
            d["nominatedNode"] = self.nominated_node
            d["victims"] = list(self.victims)
        if self.reason:
            d["reason"] = self.reason
        return d


@dataclass
class SolveRecord:
    """One tick's solve, with its convergence telemetry."""

    tick: int
    trace_id: str
    mode: str
    pods: int
    duration_s: float
    waves: int = 0
    sinkhorn_iterations: int = 0
    sinkhorn_residual: Optional[float] = None
    incremental: bool = False
    time: str = field(default_factory=_wall_stamp)

    def to_dict(self) -> dict:
        d = {
            "tick": self.tick,
            "traceId": self.trace_id,
            "mode": self.mode,
            "pods": self.pods,
            "duration_s": round(self.duration_s, 6),
            "time": self.time,
        }
        if self.incremental:
            d["incremental"] = True
        if self.waves:
            d["waves"] = self.waves
        if self.sinkhorn_iterations:
            d["sinkhornIterations"] = self.sinkhorn_iterations
        if self.sinkhorn_residual is not None:
            d["sinkhornResidual"] = round(self.sinkhorn_residual, 6)
        return d


class FlightRecorder:
    """Bounded rings of decisions and solve records (newest win)."""

    def __init__(self):
        self._lock = sanitizer.lock("flightrecorder.ring")
        self._decisions: List[Decision] = []
        self._solves: List[SolveRecord] = []
        self._tick = 0

    def next_tick(self) -> int:
        with self._lock:
            self._tick += 1
            return self._tick

    def record(self, decisions: Iterable[Decision]) -> None:
        decisions = list(decisions)
        with self._lock:
            self._decisions.extend(decisions)
            cap = _CONFIG["ring"]
            if len(self._decisions) > cap:
                del self._decisions[: len(self._decisions) - cap]
        for d in decisions:
            DECISIONS_TOTAL.inc(outcome=d.outcome)
            for sink in _DECISION_SINKS:
                try:
                    sink(d.pod, d.outcome)
                except Exception:
                    pass  # a broken sink must not sink the tick

    def record_solve(self, rec: SolveRecord) -> None:
        with self._lock:
            self._solves.append(rec)
            cap = _CONFIG["solve_ring"]
            if len(self._solves) > cap:
                del self._solves[: len(self._solves) - cap]

    def record_preemption(self, pod: str, outcome: str, node: str = "",
                          victims: Tuple[str, ...] = (), reason: str = "") -> None:
        """Fold a preemption verdict into the pod's newest decision, or
        append a record of its own when there is none (it rotated out
        of the ring, or the pod was never drained: a descheduler
        move)."""
        with self._lock:
            for d in reversed(self._decisions):
                if d.pod == pod:
                    d.outcome = outcome
                    d.nominated_node = node
                    d.victims = tuple(victims)
                    d.reason = reason
                    break
            else:
                self._decisions.append(Decision(
                    pod=pod, tick=self._tick, trace_id="", mode="", outcome=outcome,
                    nominated_node=node, victims=tuple(victims), reason=reason,
                ))
                cap = _CONFIG["ring"]
                if len(self._decisions) > cap:
                    del self._decisions[: len(self._decisions) - cap]
        DECISIONS_TOTAL.inc(outcome=outcome)

    def ring_stats(self) -> Tuple[int, int]:
        """(recorded decisions, configured capacity)."""
        with self._lock:
            return len(self._decisions), _CONFIG["ring"]

    def attach(self, decision: Decision, entry: dict) -> None:
        """`Decision.attach` under the ring's lock: a decision already in
        the ring is amended whole, never read half-amended."""
        with self._lock:
            decision.attach(entry)

    def clear(self) -> None:
        with self._lock:
            self._decisions.clear()
            self._solves.clear()

    @staticmethod
    def _pod_matches(key: str, pod: str) -> bool:
        """A decision's 'ns/name' key against a query that is the full
        key or a bare pod name."""
        return key == pod or ("/" not in pod and key.endswith("/" + pod))

    def decisions(self, pod: str = "", limit: int = 64) -> dict:
        limit = max(0, limit)  # limit 0 means none, not one
        out = []
        # Rendered under the lock: the commit worker amends records in
        # the ring (`attach`, `record_preemption`) while a server reads.
        with self._lock:
            for d in reversed(self._decisions):  # newest first
                if len(out) >= limit:
                    break
                if pod and not self._pod_matches(d.pod, pod):
                    continue
                out.append(d.to_dict())
        return {"kind": "DecisionList", "decisions": out}

    def solves(self, limit: int = 64) -> dict:
        with self._lock:
            entries = list(self._solves)
        return {"kind": "SolveList",
                "solves": [r.to_dict() for r in reversed(entries)][: max(0, limit)]}


DEFAULT = FlightRecorder()


def render_decisions_json(pod: str = "", limit: int = 64) -> str:
    return json.dumps(DEFAULT.decisions(pod=pod, limit=limit))


def render_solves_json(limit: int = 64) -> str:
    return json.dumps(DEFAULT.solves(limit=limit))


# -- rendering (`ktctl explain`) -----------------------------------------


def format_decision(d: dict) -> str:
    """Render one decision dict as the per-node 'why / why not' table."""
    head = (f"DECISION {d.get('pod', '')}  tick {d.get('tick', 0)}"
            f"  mode {d.get('mode', '') or '-'}  outcome {d.get('outcome', '')}")
    if d.get("node"):
        head += f" -> {d['node']}"
    if d.get("traceId"):
        head += f"  trace {d['traceId']}"
    lines = [head]
    if d.get("group"):
        lines.append(f"  pod group: {d['group']}")
    if d.get("nominatedNode"):
        victims = ", ".join(d.get("victims", ())) or "<none>"
        lines.append(f"  nominated {d['nominatedNode']} evicting [{victims}]")
    if d.get("reason"):
        lines.append(f"  reason: {d['reason']}")
    nodes = d.get("nodes", ())
    if "feasibleNodes" in d:
        lines.append(f"  {d['feasibleNodes']}/{d.get('totalNodes', 0)} nodes feasible")
    if nodes:
        width = max(len(v.get("node", "")) for v in nodes) + 2
        for v in nodes:
            if v.get("ok"):
                comps = v.get("components", {})
                detail = f"score {v.get('score', 0)}"
                if comps:
                    detail += " (" + ", ".join(f"{k} {val}" for k, val in comps.items()) + ")"
                lines.append(f"  {v.get('node', ''):<{width}}feasible    {detail}")
            else:
                lines.append(f"  {v.get('node', ''):<{width}}infeasible  "
                             + ", ".join(v.get("reasons", ())))
    counts = d.get("reasonCounts")
    if counts:
        lines.append("  why not: " + ", ".join(f"{k} x{v}" for k, v in sorted(counts.items())))
    return "\n".join(lines)
