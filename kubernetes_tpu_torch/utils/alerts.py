"""Multi-window multi-burn-rate alerting over the retention plane.

The SLO engine (utils/slo.py) answers "is the objective met right
now"; this module answers the operator question "is the error budget
burning fast enough that a human should move" — the Site Reliability
Workbook ch. 5 recipe: a rule fires only when BOTH a long and a short
window exceed the threshold (the long window proves significance, the
short window proves the burn is still happening, and their conjunction
is what keeps a recovered burn from paging for hours). Two window
pairs ship by default — fast (1h/5m at 14.4x budget burn) catches
budget-exhausting incidents in minutes, slow (6h/30m at 6x) catches
smolder — scaled uniformly by ``clock_scale`` so soak/CI runs exercise
the same rules on compressed clocks (``KT_ALERT_SCALE``).

Each :class:`AlertRule` names a retained series and a measurement kind
(``quantile`` / ``counter_rate`` / ``gauge_max`` — windowed queries
against utils/timeseries.py, never lifetime cumulatives), and runs a
``pending -> firing -> resolved`` state machine: ``for_s`` hold-down
before firing (flap suppression on top of the window conjunction),
``resolve_s`` clear-hysteresis before resolving. Every transition
increments ``alert_transitions_total{rule,state}``, updates
``alerts_firing{rule}``, appends to the bounded transition log (the
soak oracle's firing timeline), and posts a cluster Event through the
attached poster — exactly once per transition.

Default rules cover the signals each telemetry plane owes an operator:
bind latency, watch fan-out lag + drop storms, replication follower
lag, lease renewal latency, backlog pressure, and fragmentation burn.

Surfaces: ``GET /debug/alerts`` / ``ktctl alerts`` render
:func:`AlertEngine.snapshot`; the engine evaluates as a sampler hook
(timeseries.SAMPLER) so rule evaluation shares the retention cadence.

A copy of `kubernetes_tpu/utils/alerts.py` over the port's registry
and retention plane, on the sanitizer's `alerts.engine` lock
(`utils/sanitizer.py`). Departure: `evaluate` posts a pass's transition
Events after it releases that lock (JAX's posts them under it: a client
request, and the recorder's first thread start, under a lock, which the
sanitizer reports).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.utils import metrics, sanitizer, timeseries

FIRING = metrics.DEFAULT.gauge(
    "alerts_firing",
    "1 while the named alert rule is in the firing state",
    labels=("rule",),
)
TRANSITIONS = metrics.DEFAULT.counter(
    "alert_transitions_total",
    "Alert state-machine transitions by entered state",
    labels=("rule", "state"),
)


@dataclass(frozen=True)
class BurnWindow:
    """One (long, short) window pair. ``burn`` is the budget-burn
    multiplier applied to counter_rate thresholds (the SRE Workbook
    factors); quantile/gauge watermarks compare against the bare
    threshold — their target IS the line."""

    long_s: float
    short_s: float
    burn: float = 1.0


#: SRE Workbook ch. 5 defaults: 14.4x over 1h/5m exhausts a 30d budget
#: in ~2 days (page-worthy); 6x over 6h/30m in ~5 days (ticket-worthy).
FAST = BurnWindow(long_s=3600.0, short_s=300.0, burn=14.4)
SLOW = BurnWindow(long_s=21600.0, short_s=1800.0, burn=6.0)


@dataclass(frozen=True)
class AlertRule:
    """One declarative burn-rate rule over one retained series."""

    name: str
    series: str
    threshold: float
    #: quantile (windowed histogram quantile) | counter_rate (windowed
    #: per-second rate) | gauge_max (windowed max watermark).
    kind: str = "quantile"
    percentile: float = 0.99
    labels: Tuple[Tuple[str, str], ...] = ()
    windows: Tuple[BurnWindow, ...] = (FAST, SLOW)
    #: page -> humans move now; ticket -> next business day.
    severity: str = "ticket"
    #: Hold-down: the condition must hold this long before pending
    #: promotes to firing (0 = fire immediately).
    for_s: float = 60.0
    #: Hysteresis: the condition must stay clear this long before
    #: firing resolves (0 = resolve immediately).
    resolve_s: float = 120.0
    description: str = ""


DEFAULT_RULES: Tuple[AlertRule, ...] = (
    AlertRule(
        "bind_latency_burn", "pod_startup_latency_seconds", threshold=1.0,
        kind="quantile", labels=(("milestone", "bound"),), severity="page",
        description="windowed p99 create->bound above the 1s scheduling "
        "SLO in both burn windows",
    ),
    AlertRule(
        "watch_fanout_lag", "watch_fanout_lag_versions", threshold=4096.0,
        kind="quantile",
        description="watch deliveries trailing the applied watermark — "
        "consumers are reading the past",
    ),
    AlertRule(
        "watch_drop_storm", "watch_streams_dropped_total", threshold=0.02,
        kind="counter_rate", severity="page",
        description="slow-consumer watch drops burning the relist "
        "budget (threshold is drops/s; burn factors scale it)",
    ),
    AlertRule(
        "replication_follower_lag", "replication_follower_lag_versions",
        threshold=1024.0, kind="gauge_max",
        description="a kvstore follower trailing the leader's commit "
        "index — the pre-quorum-loss signal the HA plane owes",
    ),
    AlertRule(
        "lease_renew_latency", "lease_renew_latency_seconds", threshold=1.0,
        kind="quantile",
        description="lease CAS round-trips creeping toward the lease "
        "window; holders demote themselves when renews can't land",
    ),
    AlertRule(
        "backlog_pressure", "scheduler_backlog_pressure", threshold=256.0,
        kind="gauge_max",
        description="pending-pod backlog watermark (depth x oldest "
        "age) sustained above the capacity plane's pressure line",
    ),
    AlertRule(
        "fragmentation_burn", "cluster_fragmentation_score", threshold=0.5,
        kind="quantile",
        description="cluster fragmentation score burning: free "
        "capacity exists but is unusable shards — defrag is owed",
    ),
)


def _match(label_set: Dict[str, str], labels: Tuple[Tuple[str, str], ...]):
    return all(label_set.get(k) == v for k, v in labels)


class AlertEngine:
    """The rule evaluator + per-rule state machines. One engine per
    process (module DEFAULT); re-entrant callers share state under the
    engine lock. ``clock_scale`` multiplies every window, hold-down,
    and hysteresis (soak/CI compress hours into seconds without
    forking the rules)."""

    MAX_TRANSITIONS = 512

    def __init__(
        self,
        retention: Optional[timeseries.Retention] = None,
        rules: Tuple[AlertRule, ...] = DEFAULT_RULES,
        clock_scale: Optional[float] = None,
    ):
        self.retention = retention if retention is not None else timeseries.DEFAULT
        self.rules = tuple(rules)
        if clock_scale is None:
            clock_scale = float(os.environ.get("KT_ALERT_SCALE", "1.0"))
        self.clock_scale = clock_scale
        self._lock = sanitizer.lock("alerts.engine")
        self._state: Dict[str, dict] = {}
        self._transitions: List[dict] = []
        self._evaluations = 0
        self._post_event: Optional[Callable[..., None]] = None

    # -- wiring --------------------------------------------------------

    def configure(
        self,
        rules: Optional[Tuple[AlertRule, ...]] = None,
        clock_scale: Optional[float] = None,
        retention: Optional[timeseries.Retention] = None,
    ) -> "AlertEngine":
        """Re-point the engine (soak/bench/tests); state resets —
        rules with different windows must not inherit hold-downs."""
        with self._lock:
            if rules is not None:
                self.rules = tuple(rules)
            if clock_scale is not None:
                self.clock_scale = float(clock_scale)
            if retention is not None:
                self.retention = retention
            self._state.clear()
            self._transitions.clear()
            self._evaluations = 0
        return self

    def attach_events(self, client, source: str = "alert-engine") -> None:
        """Post transition Events through `client.record_event` (the
        broadcaster dedupes repeats; a failed post never blocks the
        state machine)."""

        def post(rule: AlertRule, old: str, new: str, value) -> None:
            involved = {
                "kind": "Alert",
                "metadata": {"name": rule.name, "namespace": "default"},
            }
            v = "n/a" if value is None else f"{value:.4g}"
            client.record_event(
                involved,
                reason=f"Alert{new.capitalize()}",
                message=(
                    f"alert {rule.name} {old} -> {new} "
                    f"(value {v}, threshold {rule.threshold:g}, "
                    f"severity {rule.severity})"
                ),
                source=source,
            )

        self._post_event = post

    # -- evaluation ----------------------------------------------------

    def _measure(
        self, rule: AlertRule, window_s: float, labels: Dict[str, str],
        now: Optional[float],
    ) -> Optional[float]:
        r = self.retention
        if rule.kind == "quantile":
            return r.quantile_over_time(
                rule.series, rule.percentile, window_s, labels, now=now
            )
        if rule.kind == "counter_rate":
            return r.rate(rule.series, window_s, labels, now=now)
        return r.max_over_time(rule.series, window_s, labels, now=now)

    def _worst(
        self, rule: AlertRule, window_s: float, now: Optional[float],
    ) -> Optional[float]:
        """Worst measured value across the rule's matching label sets
        (the slo engine's worst-set semantics)."""
        sets = [
            ls
            for ls in self.retention.label_sets(rule.series)
            if _match(ls, rule.labels)
        ]
        worst = None
        for ls in sets:
            v = self._measure(rule, window_s, ls, now)
            if v is not None and (worst is None or v > worst):
                worst = v
        return worst

    def _condition(
        self, rule: AlertRule, now: Optional[float],
    ) -> Tuple[bool, Optional[float], Optional[dict]]:
        """(active, worst short-window value, tripped window info):
        active iff ANY window pair has BOTH its long and short windows
        above the (burn-scaled) threshold."""
        scale = self.clock_scale
        value = None
        for w in rule.windows:
            eff = rule.threshold * (
                w.burn if rule.kind == "counter_rate" else 1.0
            )
            v_long = self._worst(rule, w.long_s * scale, now)
            if v_long is None or v_long <= eff:
                continue
            v_short = self._worst(rule, w.short_s * scale, now)
            if value is None or (v_short is not None and v_short > value):
                value = v_short
            if v_short is not None and v_short > eff:
                return True, v_short, {
                    "longS": w.long_s, "shortS": w.short_s,
                    "burn": w.burn, "threshold": eff,
                }
        if value is None:
            # Nothing tripped: report the fastest window's current
            # reading for the snapshot (may be None — no data).
            value = self._worst(
                rule, rule.windows[0].short_s * scale, now
            ) if rule.windows else None
        return False, value, None

    def _transition(
        self, st: dict, rule: AlertRule, new: str, now: float, value,
    ) -> dict:
        old = st["state"]
        st["state"] = new
        st["since"] = now
        row = {
            "rule": rule.name,
            "from": old,
            "to": new,
            "t_mono": now,
            "wall": time.time(),
            "value": value,
        }
        self._transitions.append(row)
        if len(self._transitions) > self.MAX_TRANSITIONS:
            del self._transitions[: -self.MAX_TRANSITIONS]
        TRANSITIONS.inc(rule=rule.name, state=new)
        FIRING.set(1.0 if new == "firing" else 0.0, rule=rule.name)
        return row

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation pass over every rule; returns the transitions
        it caused. Runs as a timeseries.SAMPLER hook, so by default
        alerting costs exactly one pass per retention sweep."""
        t = time.monotonic() if now is None else now
        out: List[dict] = []
        rules: Dict[str, AlertRule] = {}
        with self._lock:
            self._evaluations += 1
            for rule in self.rules:
                active, value, hit = self._condition(rule, now)
                st = self._state.setdefault(
                    rule.name,
                    {"state": "inactive", "since": t, "clear_since": None},
                )
                st["value"] = value
                st["window"] = hit
                state = st["state"]
                rules[rule.name] = rule
                if active:
                    st["clear_since"] = None
                    if state in ("inactive", "resolved"):
                        if rule.for_s * self.clock_scale > 0:
                            out.append(
                                self._transition(st, rule, "pending", t, value)
                            )
                        else:
                            out.append(
                                self._transition(st, rule, "firing", t, value)
                            )
                    elif state == "pending" and (
                        t - st["since"] >= rule.for_s * self.clock_scale
                    ):
                        out.append(
                            self._transition(st, rule, "firing", t, value)
                        )
                else:
                    if state == "pending":
                        # Flap suppressed: the hold-down ate the blip.
                        out.append(
                            self._transition(st, rule, "inactive", t, value)
                        )
                    elif state == "firing":
                        if st["clear_since"] is None:
                            st["clear_since"] = t
                        if (
                            t - st["clear_since"]
                            >= rule.resolve_s * self.clock_scale
                        ):
                            out.append(
                                self._transition(st, rule, "resolved", t, value)
                            )
        # Transition Events post after the lock is released: a post is a
        # client request (a socket round trip over HTTP), and it starts
        # the recorder's thread the first time. Departure from JAX's
        # engine, which posts under its lock (a sanitizer finding).
        post = self._post_event
        if post is not None:
            for row in out:
                try:
                    post(rules[row["rule"]], row["from"], row["to"], row["value"])
                except Exception:
                    pass  # events are observability, never control flow
        return out

    # -- introspection -------------------------------------------------

    @property
    def sampled(self) -> bool:
        """The miss contract: an unmeasured cluster (no evaluations,
        or a retention plane that never sampled) reads unsampled."""
        with self._lock:
            evals = self._evaluations
        return evals > 0 and self.retention.sampled

    def firing(self) -> List[str]:
        with self._lock:
            return sorted(
                name
                for name, st in self._state.items()
                if st["state"] == "firing"
            )

    def transitions(self) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._transitions]

    def snapshot(self) -> dict:
        """The /debug/alerts payload (ktctl alerts' data source)."""
        now = time.monotonic()
        with self._lock:
            rules = []
            for rule in self.rules:
                st = self._state.get(rule.name)
                row = {
                    "name": rule.name,
                    "series": rule.series,
                    "kind": rule.kind,
                    "severity": rule.severity,
                    "threshold": rule.threshold,
                    "state": st["state"] if st else "inactive",
                    "windows": [
                        {"longS": w.long_s, "shortS": w.short_s,
                         "burn": w.burn}
                        for w in rule.windows
                    ],
                }
                if rule.kind == "quantile":
                    row["percentile"] = rule.percentile
                if rule.labels:
                    row["labels"] = dict(rule.labels)
                if rule.description:
                    row["description"] = rule.description
                if st is not None:
                    row["sinceS"] = round(max(0.0, now - st["since"]), 3)
                    if st.get("value") is not None:
                        row["value"] = round(st["value"], 6)
                    if st.get("window") is not None:
                        row["trippedWindow"] = st["window"]
                rules.append(row)
            return {
                "kind": "AlertReport",
                "sampled": self._evaluations > 0 and self.retention.sampled,
                "clockScale": self.clock_scale,
                "evaluations": self._evaluations,
                "firing": sorted(
                    n for n, st in self._state.items()
                    if st["state"] == "firing"
                ),
                "rules": rules,
                "transitions": [dict(r) for r in self._transitions[-64:]],
            }


#: Process-global engine over the process-global retention store.
DEFAULT = AlertEngine()


def ensure_started(
    interval_s: Optional[float] = None, client=None,
) -> AlertEngine:
    """Boot the health plane: start the retention sampler and ride its
    cadence with DEFAULT's evaluation (idempotent; daemons, local-up,
    soak, and bench all call this). With a client, transition Events
    post to the cluster."""
    if client is not None:
        DEFAULT.attach_events(client)
    sampler = timeseries.ensure_started(interval_s=interval_s)
    sampler.add_hook(_evaluate_default)
    return DEFAULT


def _evaluate_default() -> None:
    DEFAULT.evaluate()
