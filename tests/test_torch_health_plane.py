"""The port's health plane against the JAX package's.

`utils/timeseries.py` (retention rings and windowed queries),
`utils/alerts.py` (burn-rate rules and their state machines) and the
windowed path of `utils/slo.py`: each package gets a registry of its
own holding the series the rules read, the same observations from a
numpy seed, sweeps at the same fake times and rule evaluations at the
same instants (the last ones a run's start on the monotonic clock, so
the SLO engine's windows, read at the present, hold them). The windowed
figures, the retention snapshot, every alert transition and state, and
the SLO report must be equal (wall clock stamps aside).
"""

import time

import numpy as np
import pytest

from kubernetes_tpu.utils import alerts as jax_alerts
from kubernetes_tpu.utils import metrics as jax_metrics
from kubernetes_tpu.utils import slo as jax_slo
from kubernetes_tpu.utils import timeseries as jax_ts

from kubernetes_tpu_torch.utils import alerts as port_alerts
from kubernetes_tpu_torch.utils import metrics as port_metrics
from kubernetes_tpu_torch.utils import slo as port_slo
from kubernetes_tpu_torch.utils import timeseries as port_ts

PACKAGES = {
    "jax": (jax_metrics, jax_ts, jax_alerts, jax_slo),
    "port": (port_metrics, port_ts, port_alerts, port_slo),
}
def _registry(metrics):
    reg = metrics.Registry()
    series = {
        "startup": reg.histogram("pod_startup_latency_seconds", "h", ("milestone",)),
        "drops": reg.counter("watch_streams_dropped_total", "c"),
        "pressure": reg.gauge("scheduler_backlog_pressure", "g"),
        "lag": reg.histogram("watch_fanout_lag_versions", "h", ("resource",),
                             buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 1024, 4096, 16384,
                                      65536)),
        "phase": reg.histogram("scheduler_phase_seconds", "h", ("phase",)),
    }
    return reg, series


def _drive(name, seed, steps=40, step_s=5.0):
    metrics, ts, alerts, slo = PACKAGES[name]
    reg, s = _registry(metrics)
    retention = ts.Retention(retain_samples=64)
    engine = alerts.AlertEngine(retention=retention, clock_scale=0.02)
    rng = np.random.default_rng(seed)
    # Whole seconds: every sample time and difference is exact, whatever
    # the start.
    t0 = float(int(time.monotonic()) - int(steps * step_s))
    figures = []
    for k in range(steps):
        now = t0 + k * step_s
        burning = 10 <= k < 25  # a latency and drop burn that recovers
        for _ in range(int(rng.integers(5, 40))):
            lat = float(rng.gamma(2.0, 1.5 if burning else 0.1))
            s["startup"].observe(lat, milestone="bound")
            s["startup"].observe(lat / 2, milestone="decision")
            s["lag"].observe(float(rng.integers(0, 5000 if burning else 8)), resource="pods")
            s["phase"].observe(float(rng.gamma(2.0, 0.01)), phase="solve")
        if burning:
            s["drops"].inc(float(rng.integers(0, 3)))
        s["pressure"].set(float(rng.integers(0, 600 if burning else 50)))
        retention.sample_now(reg, now=now)
        transitions = engine.evaluate(now=now)
        figures.append({
            "transitions": [{k: (v - t0 if k == "t_mono" else v) for k, v in t.items()
                             if k != "wall"} for t in transitions],
            "p99": retention.quantile_over_time("pod_startup_latency_seconds", 0.99, 30.0,
                                                {"milestone": "bound"}, now=now),
            "rate": retention.rate("watch_streams_dropped_total", 30.0, {}, now=now),
            "increase": retention.increase("watch_streams_dropped_total", 60.0, {}, now=now),
            "max": retention.max_over_time("scheduler_backlog_pressure", 30.0, {}, now=now),
            "avg": retention.avg_over_time("scheduler_backlog_pressure", 30.0, {}, now=now),
            "delta": retention.delta("scheduler_backlog_pressure", 30.0, {}, now=now),
            "hist": retention.hist_window("watch_fanout_lag_versions", 30.0,
                                          {"resource": "pods"}, now=now),
        })
    snap = engine.snapshot()
    for rule in snap["rules"]:
        rule.pop("sinceS", None)
    for t in snap["transitions"]:
        t.pop("wall", None)
        t["t_mono"] -= t0
    return {
        "figures": figures,
        "alerts": snap,
        "retention": retention.snapshot(),
        "windowed": retention.snapshot(series="pod_startup_latency_seconds", window_s=60.0),
        "slo": slo.evaluate(registry=reg, history=retention),
        "slo_lifetime": slo.evaluate(registry=reg, history=ts.Retention()),
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_health_plane_matches_jax(seed):
    jax_run, port_run = _drive("jax", seed), _drive("port", seed)
    assert port_run["figures"] == jax_run["figures"]
    assert port_run["retention"] == jax_run["retention"]
    assert port_run["windowed"] == jax_run["windowed"]
    assert port_run["alerts"] == jax_run["alerts"]
    # Descriptions of the SLO objectives are each package's prose.
    for run in (jax_run, port_run):
        for report in (run["slo"], run["slo_lifetime"]):
            for entry in report["objectives"]:
                entry.pop("description", None)
    assert port_run["slo"] == jax_run["slo"]
    assert port_run["slo_lifetime"] == jax_run["slo_lifetime"]
    fired = {t["rule"] for f in port_run["figures"] for t in f["transitions"] if t["to"] == "firing"}
    assert "bind_latency_burn" in fired
    assert any(e.get("windowed") for e in port_run["slo"]["objectives"])
    assert not any(e.get("windowed") for e in port_run["slo_lifetime"]["objectives"])
