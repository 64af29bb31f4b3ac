"""The port's SLO engine verdicts as the JAX package's.

Two registries, one of each package's `utils/metrics.py`, are fed the
same observations from a numpy seed: every series of the default
objectives, registered with the kind its objective reads (a histogram
for quantile_max, a counter for counter_max, a gauge for gauge_max),
with label sets that match the objective's filter and some that do
not. `slo.evaluate(registry=)` of the port must equal the JAX engine's
lifetime-cumulative report (the JAX call is given a retention plane that
has not sampled, the state of a process without one), entry for entry.
Two objective descriptions are worded differently in the port (their
JAX text names the JAX compiler and a TPU-specific bar) and are
compared apart.
"""

import types

import numpy as np
import pytest

from kubernetes_tpu.utils import metrics as jmetrics
from kubernetes_tpu.utils import slo as jslo
from kubernetes_tpu_torch.utils import metrics, slo

@pytest.fixture(autouse=True)
def no_apiserver_series_kept():
    """The port's apiserver and replication series (`sli.WATCH_LAG`,
    `replication.FOLLOWER_LAG` and `COMMIT_INDEX`) and the retention
    plane's history, empty during each test and as they were after it:
    an earlier test in the same process that served a port apiserver's
    watch or replicated a store fed them, and this file evaluates the
    objectives of a process that never did."""
    from kubernetes_tpu_torch.store import replication
    from kubernetes_tpu_torch.utils import sli, timeseries

    series = [(sli.WATCH_LAG, "_stats"), (replication.FOLLOWER_LAG, "_values"),
              (replication.COMMIT_INDEX, "_values")]
    saved = []
    for metric, attr in series:
        with metric._lock:
            saved.append(dict(getattr(metric, attr)))
            getattr(metric, attr).clear()
    hist = timeseries.DEFAULT
    with hist._lock:
        saved_hist = (dict(hist._rings), dict(hist._meta), hist._samples)
        hist._rings.clear()
        hist._meta.clear()
        hist._samples = 0
    yield
    for (metric, attr), values in zip(series, saved):
        with metric._lock:
            getattr(metric, attr).clear()
            getattr(metric, attr).update(values)
    with hist._lock:
        hist._rings.clear()
        hist._rings.update(saved_hist[0])
        hist._meta.clear()
        hist._meta.update(saved_hist[1])
        hist._samples = saved_hist[2]


#: A retention plane that never sampled: the JAX engine's lifetime path.
NO_HISTORY = types.SimpleNamespace(sampled=False)
#: Objectives whose description the port words differently.
REWORDED = {"solver_compile_churn", "bind_latency_slo"}


def _feed(pkg_metrics, objectives, seed, scale):
    """A registry of `pkg_metrics` with every objective's series fed the
    same seeded observations, `scale` times the objective's target."""
    reg = pkg_metrics.Registry()
    rng = np.random.default_rng(seed)
    made = {}
    for obj in objectives:
        names = tuple(k for k, _ in obj.labels) + ("shard",)
        if obj.series not in made:
            if obj.kind == "quantile_max":
                made[obj.series] = reg.histogram(obj.series, "", names)
            elif obj.kind == "counter_max":
                made[obj.series] = reg.counter(obj.series, "", names)
            elif obj.kind == "gauge_max":
                made[obj.series] = reg.gauge(obj.series, "", names)
            else:
                continue
        metric = made[obj.series]
        for shard in ("a", "b"):
            labels = dict(obj.labels, shard=shard)
            if obj.kind == "quantile_max":
                for v in rng.exponential(scale * max(obj.target, 1e-3) / 3, size=50):
                    metric.observe(float(v), **labels)
            elif obj.kind == "counter_max":
                metric.inc(float(rng.integers(0, 3)) * scale, **labels)
            else:
                metric.set(float(rng.uniform(0, 2 * scale * obj.target)), **labels)
        if obj.labels:  # a label set the filter must leave out
            other = {k: "other" for k, _ in obj.labels}
            other["shard"] = "a"
            if obj.kind == "quantile_max":
                metric.observe(1e6, **other)
            elif obj.kind == "counter_max":
                metric.inc(1e6, **other)
            else:
                metric.set(1e6, **other)
    return reg


def _split(report):
    entries = []
    for e in report["objectives"]:
        e = dict(e)
        desc = e.pop("description", None)
        entries.append((e, desc))
    return {k: v for k, v in report.items() if k != "objectives"}, entries


@pytest.mark.parametrize("scale", [0.0, 0.5, 0.9, 3.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_matches_jax(seed, scale):
    jreg = _feed(jmetrics, jslo.DEFAULT_OBJECTIVES, seed, scale)
    treg = _feed(metrics, slo.DEFAULT_OBJECTIVES, seed, scale)
    (jhead, jentries), (thead, tentries) = (
        _split(jslo.evaluate(registry=jreg, history=NO_HISTORY)),
        _split(slo.evaluate(registry=treg)))
    assert thead == jhead
    assert [e for e, _ in tentries] == [e for e, _ in jentries]
    for (e, tdesc), (_, jdesc) in zip(tentries, jentries):
        if e["name"] not in REWORDED:
            assert tdesc == jdesc, e["name"]
    assert thead["kind"] == "SLOReport"
    if scale == 3.0:
        assert thead["verdict"] == "burn"


def test_empty_registry_reads_no_data_as_jax():
    want = jslo.evaluate(registry=jmetrics.Registry(), history=NO_HISTORY)
    got = slo.evaluate(registry=metrics.Registry())
    assert _split(got)[0] == _split(want)[0] == {"kind": "SLOReport", "verdict": "no_data",
                                                "sampled": False}
    assert [e for e, _ in _split(got)[1]] == [e for e, _ in _split(want)[1]]


def test_objectives_and_ladder_match_jax():
    """Names, series, targets, kinds, labels and severities of both
    objective sets, and verdicts of supplied figures."""
    def fields(o):
        return (o.name, o.series, o.target, o.kind, o.percentile, o.labels, o.severity,
                o.warn_ratio, o.window_s)

    assert [fields(o) for o in slo.DEFAULT_OBJECTIVES] == [
        fields(o) for o in jslo.DEFAULT_OBJECTIVES]
    assert {k: fields(o) for k, o in slo.BENCH_OBJECTIVES.items()} == {
        k: fields(o) for k, o in jslo.BENCH_OBJECTIVES.items()}
    for key, obj in slo.BENCH_OBJECTIVES.items():
        jobj = jslo.BENCH_OBJECTIVES[key]
        for value in (None, float("nan"), 0.0, obj.target * 0.5, obj.target * 0.8,
                      obj.target, obj.target * 1.01, obj.target * 10):
            assert slo.verdict_for_value(obj, value) == jslo.verdict_for_value(jobj, value)
        moved = slo.with_target(obj, 2.5)
        assert moved.target == 2.5 and fields(moved) == fields(jslo.with_target(jobj, 2.5))
    for verdicts in ((), ("pass",), ("pass", "warn"), ("no_data", "pass"), ("burn", "warn"),
                     ("warn", "no_data", "burn", "pass")):
        assert slo.worst(*verdicts) == jslo.worst(*verdicts)


def test_series_this_process_never_has_read_no_data():
    """On the port's own registry the apiserver's series (watch,
    replication) are absent and read no_data, as in the JAX scheduler's
    process. (The lease's series is the port's own: its lease client
    observes it, below.)"""
    report = slo.evaluate()
    by_name = {e["name"]: e for e in report["objectives"]}
    for name in ("watch_fanout_lag", "replication_follower_lag"):
        assert by_name[name]["verdict"] == "no_data" and by_name[name]["samples"] == 0
    assert all(e.get("windowed", False) is False for e in report["objectives"])


def test_lease_client_feeds_the_lease_objective_as_jax():
    """Each package's LeaseClient observes `lease_renew_latency_seconds`
    in its own default registry, and the lease objective reads it: the
    same acquire and renew rounds add the same samples to both, and both
    verdicts pass (in-process CAS rounds, far under the 1 s target)."""
    from kubernetes_tpu.client import Client as JClient
    from kubernetes_tpu.client import LocalTransport as JLocalTransport
    from kubernetes_tpu.server.api import APIServer
    from kubernetes_tpu.utils import lease as jlease
    from kubernetes_tpu_torch.client.rest import Client, LocalTransport
    from kubernetes_tpu_torch.utils import lease

    def lease_entry(pkg_slo, **kw):
        return next(e for e in pkg_slo.evaluate(**kw)["objectives"]
                    if e["name"] == "lease_renew_latency")

    before = (lease_entry(jslo, history=NO_HISTORY)["samples"], lease_entry(slo)["samples"])
    clients = (jlease.LeaseClient(JClient(JLocalTransport(APIServer())), "l", "a"),
               lease.LeaseClient(Client(LocalTransport(APIServer())), "l", "a"))
    for c in clients:
        assert [c.try_acquire() for _ in range(3)] == [1, 1, 1]
    after = (lease_entry(jslo, history=NO_HISTORY), lease_entry(slo))
    assert [a["samples"] - b for a, b in zip(after, before)] == [3, 3]
    assert [a["verdict"] for a in after] == ["pass", "pass"]
