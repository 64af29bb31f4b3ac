"""Declarative SLO engine over the metrics registry.

The port's copy of `kubernetes_tpu/utils/slo.py`, with the same
objectives, targets and verdict ladder. An `Objective` names a metric
series, a percentile and a target; `evaluate` turns the registry into
pass / warn / burn verdicts, served at `GET /debug/slo` by the
scheduler daemon's health server and by the apiserver.

Verdict ladder (worst wins):

    pass     within target (and outside the warn band)
    no_data  the series has no samples
    warn     inside the warn band, or a warn-severity objective breached
    burn     a gate-severity objective breached (error budget burning)

Objective kinds:

    quantile_max  series percentile must stay <= target (latency SLOs;
                  multiple matching label sets evaluate as the worst)
    counter_max   the summed counter must stay <= target
    gauge_max     the worst live gauge value must stay <= target
    value_max     a directly supplied figure must stay <= target
    value_min     a directly supplied figure must stay >= target

Windows: `window_s` is real when the retention plane
(`utils/timeseries.py`) has history, as in the JAX engine: quantile_max
evaluates the interpolated quantile of the window's bucket deltas,
counter_max the windowed increase, gauge_max the windowed max, so a
recovered burn returns to `pass` within one window. Without history
(the sampler never started: the scheduler's process, unit tests)
objectives fall back to the lifetime-cumulative series; each entry
carries `windowed: true|false`. The apiserver's process starts the
sampler (`cmd/daemons.apiserver_main`). An objective whose series a
process never registers (the apiserver's watch and replication series
in the scheduler's process) reads `no_data`, as in JAX's; the lease's series is observed by
the port's lease client (`utils/lease.py`), as the JAX one's is in a
process that runs its lease-elected scheduler.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from kubernetes_tpu_torch.utils import metrics

#: Verdict severity order — worst() picks the rightmost.
_RANK = {"pass": 0, "no_data": 1, "warn": 2, "burn": 3}


def worst(*verdicts: str) -> str:
    """The most severe of the given verdicts (pass < no_data < warn <
    burn); 'no_data' when none are given."""
    out = None
    for v in verdicts:
        if out is None or _RANK.get(v, 0) > _RANK.get(out, 0):
            out = v
    return out if out is not None else "no_data"


@dataclass(frozen=True)
class Objective:
    """One service-level objective against one metric series."""

    name: str
    series: str
    target: float
    #: quantile_max|counter_max|gauge_max|value_max|value_min
    kind: str = "quantile_max"
    percentile: float = 0.99
    #: Label filter as (name, value) pairs (hashable for frozen);
    #: partial filters evaluate the worst matching label set.
    labels: Tuple[Tuple[str, str], ...] = ()
    #: gate -> breach is "burn"; warn -> breach is only ever "warn"
    #: (advisory objectives, like bench's throughput floors on CI CPUs).
    severity: str = "gate"
    #: For max kinds: values above warn_ratio*target verdict "warn"
    #: before the target is breached. 0 disables the warn band.
    warn_ratio: float = 0.75
    #: Evaluation window: when > 0 and the retention plane has history
    #: for the series, the objective verdicts the window's deltas;
    #: otherwise the lifetime-cumulative fallback.
    window_s: float = 0.0
    description: str = ""


def verdict_for_value(obj: Objective, value: Optional[float]) -> str:
    """Verdict for a directly supplied figure (a benchmark's entry
    point; also the final step of every registry evaluation)."""
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return "no_data"
    breach = "warn" if obj.severity == "warn" else "burn"
    if obj.kind == "value_min":
        return "pass" if value >= obj.target else breach
    if value > obj.target:
        return breach
    if (
        obj.kind in ("quantile_max", "value_max", "gauge_max")
        and obj.warn_ratio
        and value > obj.warn_ratio * obj.target
    ):
        return "warn"
    return "pass"


def _matching_label_sets(metric, labels: Dict[str, str]):
    """Label-value dicts of the metric's live series matching the
    (possibly partial) filter."""
    for values in metric.label_values():
        lm = dict(zip(metric.label_names, values))
        if all(lm.get(k) == v for k, v in labels.items()):
            yield lm


def evaluate_objective(obj: Objective, registry=None, history=None) -> dict:
    """Evaluate one objective. Returns the report entry: measured value,
    p50/p99 context, sample count, and the verdict. `history` is the
    retention plane (default: `timeseries.DEFAULT`); with a window and
    enough samples the verdict comes from the window's deltas, else
    from the lifetime-cumulative series."""
    registry = metrics.DEFAULT if registry is None else registry
    if history is None:
        from kubernetes_tpu_torch.utils import timeseries

        history = timeseries.DEFAULT
    labels = dict(obj.labels)
    entry = {
        "name": obj.name,
        "series": obj.series,
        "kind": obj.kind,
        "target": obj.target,
        "severity": obj.severity,
        "samples": 0,
    }
    if labels:
        entry["labels"] = labels
    if obj.kind.startswith("quantile"):
        entry["percentile"] = obj.percentile
    if obj.description:
        entry["description"] = obj.description
    if obj.window_s > 0:
        entry["windowS"] = obj.window_s
    metric = registry.get(obj.series) if hasattr(registry, "get") else None
    if metric is None:
        entry["verdict"] = "no_data"
        return entry
    # A series of the wrong shape (a counter where a histogram is
    # expected) is unmeasurable, not a crash.
    needed = "quantile" if obj.kind == "quantile_max" else "value"
    if not hasattr(metric, needed):
        entry["verdict"] = "no_data"
        return entry
    use_window = (
        obj.window_s > 0
        and history is not None
        and getattr(history, "sampled", False)
    )
    value: Optional[float] = None
    windowed = False
    if obj.kind == "counter_max":
        if use_window:
            # Windowed increase summed across matching label sets; a
            # series whose ring lacks two samples contributes nothing.
            w_total: Optional[float] = None
            for lm in _matching_label_sets(metric, labels):
                inc = history.increase(obj.series, obj.window_s, lm)
                if inc is not None:
                    w_total = (w_total or 0.0) + inc
            if w_total is not None:
                value = w_total
                entry["samples"] = int(w_total)
                windowed = True
        if not windowed:
            # A counter with no series yet is zero: verdict pass,
            # samples 0 (the report's `sampled` flag stays untouched).
            total = 0.0
            for lm in _matching_label_sets(metric, labels):
                total += metric.value(**lm)
            value = total
            entry["samples"] = int(total)
    elif obj.kind == "gauge_max":
        # Watermark: the worst live (or windowed-max) value across
        # matching label sets.
        n_sets = 0
        for lm in _matching_label_sets(metric, labels):
            if use_window:
                v = history.max_over_time(obj.series, obj.window_s, lm)
                if v is not None:
                    windowed = True
                else:
                    v = metric.value(**lm)
            else:
                v = metric.value(**lm)
            n_sets += 1
            if value is None or v > value:
                value = v
        entry["samples"] = n_sets
    elif obj.kind == "quantile_max":
        samples = 0
        p50 = None
        if use_window:
            for lm in _matching_label_sets(metric, labels):
                q = history.quantile_over_time(
                    obj.series, obj.percentile, obj.window_s, lm
                )
                if q is None:
                    continue
                windowed = True
                # The worst matching label set carries the verdict.
                if value is None or q > value:
                    value = q
                q50 = history.quantile_over_time(obj.series, 0.5, obj.window_s, lm)
                if q50 is not None and (p50 is None or q50 > p50):
                    p50 = q50
                hw = history.hist_window(obj.series, obj.window_s, lm)
                samples += hw[0] if hw is not None else 0
        if not windowed:
            for lm in _matching_label_sets(metric, labels):
                q = metric.quantile(obj.percentile, **lm)
                if math.isnan(q):
                    continue
                if value is None or q > value:
                    value = q
                q50 = metric.quantile(0.5, **lm)
                if not math.isnan(q50) and (p50 is None or q50 > p50):
                    p50 = q50
                count = getattr(metric, "count", None)
                samples += count(**lm) if count is not None else 0
        entry["samples"] = samples
        if p50 is not None:
            entry["p50"] = round(p50, 6)
        if value is not None:
            entry["p99" if obj.percentile >= 0.99 else "value"] = round(value, 6)
    else:
        # value_max / value_min verdict figures the caller supplies
        # (verdict_for_value); here they report no_data.
        entry["verdict"] = "no_data"
        return entry
    entry["windowed"] = windowed
    if value is not None:
        entry["value"] = round(value, 6)
    entry["verdict"] = verdict_for_value(obj, value)
    return entry


#: The default objective set, what /debug/slo serves and ``ktctl slo``
#: renders. Latency targets are the reference's e2e bars (99% of
#: scheduling decisions < 1 s; density.go's 5 s pod-startup watermark);
#: the advisory (warn-severity) objectives chart direction without
#: failing CI CPU boxes.
DEFAULT_OBJECTIVES: Tuple[Objective, ...] = (
    Objective(
        "pod_startup_latency", "pod_startup_latency_seconds", target=5.0,
        labels=(("milestone", "running"),), window_s=300.0,
        description="watch-visible create -> kubelet Running, p99",
    ),
    Objective(
        "pod_bound_latency", "pod_startup_latency_seconds", target=1.0,
        labels=(("milestone", "bound"),), window_s=300.0,
        description="watch-visible create -> binding visible, p99 "
        "(the reference's 99%-in-1s scheduling SLO)",
    ),
    Objective(
        "pod_decision_latency", "pod_startup_latency_seconds", target=1.0,
        labels=(("milestone", "decision"),), severity="warn",
        window_s=300.0,
        description="watch-visible create -> flight-recorder decision, p99",
    ),
    Objective(
        "watch_fanout_lag", "watch_fanout_lag_versions", target=4096.0,
        severity="warn", warn_ratio=0.0, window_s=300.0,
        description="store versions a watch delivery trails the applied "
        "watermark by, p99",
    ),
    Objective(
        "watch_stream_drops", "watch_streams_dropped_total",
        kind="counter_max", target=0.0, window_s=300.0,
        description="slow-consumer watch streams dropped (forced relists)",
    ),
    Objective(
        "solve_phase_latency", "scheduler_phase_seconds", target=1.0,
        labels=(("phase", "solve"),), severity="warn", window_s=300.0,
        description="device solve dispatch phase, p99",
    ),
    Objective(
        "solver_compile_churn", "solver_xla_compiles_total",
        kind="counter_max", target=64.0, severity="warn",
        description="solver compiles observed; shape-bucket padding "
        "keeps this bounded (the recompilation sentinel)",
    ),
    Objective(
        "capacity_fragmentation", "cluster_fragmentation_score",
        target=0.5, severity="warn",
        description="cluster fragmentation score (stranded capacity for "
        "the canonical probe-pod shapes), p99 — sustained high scores "
        "mean the free capacity exists but is unusable shards",
    ),
    Objective(
        "capacity_zero_headroom", "capacity_zero_headroom_ticks_total",
        kind="counter_max", target=0.0,
        description="scheduler ticks where pods were waiting and some "
        "live probe shape had ZERO cluster headroom — capacity "
        "starvation no reshuffle can fix",
    ),
    Objective(
        "rebalance_efficiency", "rebalance_moves_per_improvement",
        target=64.0, severity="warn",
        description="evictions spent per unit of measured "
        "fragmentation-score improvement, p99 — a defrag cycle must "
        "pay for its disruption (moves are cheap only when the score "
        "actually drops)",
    ),
    Objective(
        "rebalance_stranded_pods", "rebalance_stranded_pods_total",
        kind="counter_max", target=0.0,
        description="pods evicted by a defrag move that never "
        "re-bound (journal recovery exhausted) — the "
        "stranded-pod-after-defrag gate",
    ),
    # The HA tier: replication and lease health. Warn severity:
    # advisory. Their series are the apiserver's.
    Objective(
        "replication_follower_lag", "replication_follower_lag_versions",
        kind="gauge_max", target=4096.0, severity="warn", warn_ratio=0.0,
        window_s=300.0,
        description="store versions the slowest follower trails the "
        "leader's commit index by (worst follower; sustained lag is "
        "the pre-quorum-loss signal)",
    ),
    Objective(
        "lease_renew_latency", "lease_renew_latency_seconds", target=1.0,
        severity="warn", window_s=300.0,
        description="lease acquire/renew CAS round-trip, p99 — must "
        "stay well under the 5s lease window or holders start "
        "demoting themselves on slow storage",
    ),
)


#: Bench gate objectives: figures a benchmark supplies
#: (verdict_for_value). The throughput floors are warn-severity: they
#: chart the API-plane targets without failing CPU CI boxes.
BENCH_OBJECTIVES: Dict[str, Objective] = {
    "bind_latency_slo": Objective(
        "bind_latency_slo", "bind_latency_p99_s", target=0.1,
        kind="value_max", warn_ratio=0.0,
        description="p99 create -> binding watch-visible over the real "
        "HTTP control plane; 100ms is the always-resident incremental "
        "loop's bar at 1k nodes (bench callers may widen via "
        "gate_s, e.g. for the reference 1s SLO on CPU CI boxes)",
    ),
    "churn_api_slo": Objective(
        "churn_api_slo", "churn_api_pods_per_sec", target=25000.0,
        kind="value_min", severity="warn",
        description="API-plane bulk churn ingestion floor",
    ),
    "pod_crud_slo": Objective(
        "pod_crud_slo", "pod_crud_ops_per_sec", target=20000.0,
        kind="value_min", severity="warn",
        description="bulk CRUD ops floor over HTTP",
    ),
    "failover_to_first_bind_s": Objective(
        "failover_to_first_bind_s", "failover_to_first_bind_p99_s",
        target=1.0, kind="value_max", warn_ratio=0.0,
        description="scheduler-leader kill -> the warm standby's first "
        "bind watch-visible, p99; the warm-standby path (prewarmed "
        "SolverSession + hot informers + lease takeover) must land "
        "this under a second — the cold path pays LIST + session "
        "build + bucket compile and cannot",
    ),
}


def evaluate(objectives: Optional[Iterable[Objective]] = None, registry=None,
             history=None) -> dict:
    """The SLOReport dict (the /debug/slo body): an entry an objective,
    the worst measured verdict overall, and whether any objective has
    samples (`sampled`)."""
    objectives = DEFAULT_OBJECTIVES if objectives is None else objectives
    entries: List[dict] = [evaluate_objective(o, registry=registry, history=history)
                           for o in objectives]
    # An objective with no data yet must not drag a healthy overall
    # verdict to no_data; all no_data reports no_data.
    measured = [e["verdict"] for e in entries if e["verdict"] != "no_data"]
    return {
        "kind": "SLOReport",
        "verdict": worst(*measured) if measured else "no_data",
        "sampled": any(e["samples"] for e in entries),
        "objectives": entries,
    }


def with_target(obj: Objective, target: float) -> Objective:
    """The objective with a different target (bench knobs like
    ``gate_s`` tune the gate without forking the definition)."""
    return dataclasses.replace(obj, target=float(target))
