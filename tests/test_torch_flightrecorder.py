"""The port's flight recorder records what the JAX package's records.

- Twin daemons with the JAX daemon's decision records on: the harnesses
  of `tests/test_torch_daemon.py` (incremental) and
  `tests/test_torch_batch_daemon.py` (full re-lower), neither daemon
  started, the port's on `device="cpu"`. After every tick both rings'
  `decisions()` and `solves()` are equal, verdict tables included, on
  every field but `time`, `traceId` and `duration_s` (of a trace id,
  whether one is set must agree). Ticks with unschedulable pods, gangs
  with `gang_rejected`, a priority burst whose preemption pass amends
  records with each `preempt_*` outcome, a wave and a Sinkhorn
  `BatchScheduler` (waves, iterations, residual), and the policy routes
  (outcomes without tables).
- The descheduler twin: each executed move's `rebalance_nominated`
  record.
- The recorder's unit cases of `tests/test_explain.py`, run on both
  modules alike.
- The span tree: sampling at rates 0 and 1, an explicit id bypassing
  it, the pod cap, the merge by trace id and the pod filter, driven
  through both modules with the same calls.
"""

import numpy as np
import pytest

from kubernetes_tpu.utils import flightrecorder as jfr
from kubernetes_tpu.utils import tracing as jtracing
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.models.objects import POD_GROUP_LABEL
from kubernetes_tpu_torch.utils import flightrecorder as fr
from kubernetes_tpu_torch.utils import tracing
from tests.test_torch_batch_daemon import UNLOWERABLE, BatchPair
from tests.test_torch_daemon import (  # noqa: F401 (the module's fixtures)
    Pair,
    _one_torch_thread,
    fresh_capacity_monitors,
    pod_wire,
)

#: Fields that differ between two runs by nature.
VARYING = ("time", "traceId", "duration_s")
MODULES = (jfr, fr)
LIMITS = dict(ring=4096, solve_ring=512, explain_top_k=3, explain_failed_nodes=16,
              explain_limit=64)


@pytest.fixture(autouse=True)
def fresh_recorders(monkeypatch):
    """A fresh ring in each package, JAX's default limits, nothing
    parked, every trace sampled."""
    for mod in MODULES:
        monkeypatch.setattr(mod, "DEFAULT", mod.FlightRecorder())
        mod.configure(**LIMITS)
        mod.take_last_solve_telemetry()
    for mod in (jtracing, tracing):
        mod.configure(sample_rate=1.0, log_threshold_s=0.0, max_pods=8192)
    yield
    for mod in MODULES:
        mod.configure(**LIMITS)
    for mod in (jtracing, tracing):
        mod.configure(sample_rate=1.0, log_threshold_s=0.0, max_pods=8192)


def strip(d: dict) -> dict:
    out = {k: v for k, v in d.items() if k not in VARYING}
    out["traced"] = bool(d.get("traceId"))
    return out


def rings(mod):
    rec = mod.DEFAULT
    return ([strip(d) for d in rec.decisions(limit=1 << 20)["decisions"]],
            [strip(s) for s in rec.solves(limit=1 << 20)["solves"]])


def assert_rings_same():
    (jd, js), (td, ts) = rings(jfr), rings(fr)
    assert len(td) == len(jd) and len(ts) == len(js)
    for want, got in zip(jd, td):
        assert got == want, want["pod"]
    assert ts == js
    return td, ts


class Recording:
    """A twin whose JAX daemon records decisions (the harness switches
    it off), with the rings compared after every tick."""

    def records_on(self):
        del self.j._record_decisions
        return self

    def tick_all(self):
        ticks = 0
        while True:
            self.settle()
            nj, nt = self.j.schedule_batch(timeout=0.05), self.t.schedule_batch(timeout=0.05)
            assert nj == nt, f"tick {ticks}: jax took {nj} pods, the port {nt}"
            assert_rings_same()
            if nj == 0:
                return ticks
            ticks += 1


class RecPair(Recording, Pair):
    pass


class RecBatchPair(Recording, BatchPair):
    pass


@pytest.fixture
def twins():
    made = []

    def make(kind, **kw):
        made.append((RecPair if kind == "incremental" else RecBatchPair)(**kw).records_on())
        return made[-1]

    yield make
    for p in made:
        p.stop()


def outcomes(decisions):
    return {d["outcome"] for d in decisions}


@pytest.mark.parametrize("kind", ["incremental", "full"])
def test_backlog_records_match_jax(twins, kind):
    """600 pods on 64 nodes: bound and unschedulable outcomes, the first
    64 pods of each tick with verdict tables (unbound ones first)."""
    pair = twins(kind, seed=1 if kind == "incremental" else 21)
    assert pair.tick_all() == 3
    pair.assert_same()
    decisions, solves = assert_rings_same()
    assert len(decisions) == 600 and len(solves) == 3
    assert {"bound", "unschedulable"} <= outcomes(decisions)
    assert all(s.get("incremental") for s in solves) == (kind == "incremental")
    tables = [d for d in decisions if "nodes" in d]
    assert len(tables) == 3 * 64
    stuck = [d for d in tables if d["outcome"] == "unschedulable"]
    assert stuck and all(d["feasibleNodes"] == 0 and d["reasonCounts"] for d in stuck)
    assert all(d["feasibleNodes"] > 0 for d in tables if d["outcome"] == "bound")


@pytest.mark.parametrize("kind", ["incremental", "full"])
def test_gang_records_match_jax(twins, kind):
    pair = twins(kind, seed=5, n_nodes=16, n_pods=40)
    pair.tick_all()
    for name, min_member in (("met", 4), ("short", 6)):
        pair.each("create", "podgroups", {"kind": "PodGroup",
                                          "metadata": {"name": name, "namespace": "default"},
                                          "spec": {"minMember": min_member}},
                  namespace="default")
    rng = np.random.default_rng(11)
    gangs = []
    for name, members in (("met", 4), ("short", 3)):
        gangs += [pod_wire(f"{name}{i}", rng, labels={POD_GROUP_LABEL: name}, cpu="200m")
                  for i in range(members)]
    pair.each("create_bulk", "pods", gangs, namespace="default")
    pair.tick_all()
    decisions, _ = assert_rings_same()
    by_pod = {}
    for d in reversed(decisions):
        by_pod[d["pod"]] = d
    assert all(by_pod[f"default/met{i}"]["group"] == "default/met" for i in range(4))
    assert {by_pod[f"default/short{i}"]["outcome"] for i in range(3)} == {"gang_rejected"}


@pytest.mark.parametrize("kind", ["incremental", "full"])
def test_priority_burst_amends_records_as_jax(twins, kind):
    """A full cluster, then high-priority pods: nominated ones, one that
    fits no node (infeasible), a gang with an infeasible member (its
    feasible members' grants dropped), and a burst whose evictions all
    fail."""
    pair = twins(kind, seed=6, n_nodes=8, n_pods=0, services=0, eviction_grace_seconds=30)
    rng = np.random.default_rng(12)
    pair.each("create_bulk", "pods", [pod_wire(f"low{i}", rng, cpu="500m")
                                      for i in range(8 * 16)], namespace="default")
    pair.tick_all()
    burst = [pod_wire(f"hi{i}", rng, priority=100, cpu="1500m") for i in range(4)]
    burst.append(pod_wire("huge", rng, priority=100, cpu="64"))
    pair.each("create_bulk", "pods", burst, namespace="default")
    pair.tick_all()
    pair.each("create", "podgroups", {"kind": "PodGroup",
                                      "metadata": {"name": "g", "namespace": "default"},
                                      "spec": {"minMember": 3}}, namespace="default")
    gang = [pod_wire(f"g{i}", rng, priority=100, labels={POD_GROUP_LABEL: "g"},
                     cpu="64" if i == 2 else "1500m") for i in range(3)]
    pair.each("create_bulk", "pods", gang, namespace="default")
    pair.tick_all()

    def refuse(*a, **k):
        raise RuntimeError("eviction refused")

    for cfg in (pair.jcfg, pair.tcfg):
        cfg.client.evict = refuse
    pair.each("create", "pods", pod_wire("late", rng, priority=100, cpu="1500m"),
              namespace="default")
    pair.tick_all()
    decisions, _ = assert_rings_same()
    assert {"preempt_nominated", "preempt_infeasible", "preempt_gang_partial",
            "preempt_evict_failed"} <= outcomes(decisions)
    nominated = [d for d in decisions if d["outcome"] == "preempt_nominated"]
    assert all(d["nominatedNode"] and d["victims"] for d in nominated)
    assert {k: v[:2] for k, v in pair.j._nominations.items()} == {
        k: v[:2] for k, v in pair.t._nominations.items()}


@pytest.mark.parametrize("mode,seed,n_pods", [("wave", 21, 600), ("sinkhorn", 24, 120)])
def test_wave_and_sinkhorn_solve_records_match_jax(twins, mode, seed, n_pods):
    """The batch wrappers park their figures and the daemon stamps them
    on its SolveRecord: waves, and Sinkhorn's iterations and residual."""
    pair = twins("full", seed=seed, mode=mode, n_pods=n_pods, max_batch=1024)
    pair.tick_all()
    _, solves = assert_rings_same()
    assert solves and all(s["mode"] == mode and s["waves"] > 0 for s in solves)
    if mode == "sinkhorn":
        assert all(s["sinkhornIterations"] > 0 and "sinkhornResidual" in s for s in solves)
    assert fr.take_last_solve_telemetry() is None


@pytest.mark.parametrize("policy", ["lowerable", "unlowerable"])
def test_policy_routes_record_outcomes_without_tables(twins, policy):
    if policy == "lowerable":
        pair = twins("full", seed=25, policy=workload.FULL_VOCABULARY_POLICY, labelled=True)
    else:
        pair = twins("full", seed=27, n_pods=300, policy=UNLOWERABLE)
    pair.tick_all()
    decisions, _ = assert_rings_same()
    assert decisions and not any("nodes" in d for d in decisions)
    assert {"bound", "unschedulable"} & outcomes(decisions)


@pytest.fixture
def jax_move_counters_kept():
    """The JAX package's move counters as they were before the test: its
    exposition golden (`tests/test_metrics_exposition.py`) reads them
    from a process that may have run this file first."""
    from kubernetes_tpu.utils import rebalance as jreb

    saved = {c: c.snapshot() for c in (jreb.MOVES, jreb.STRANDED)}
    yield
    for c, values in saved.items():
        with c._lock:
            c._values.clear()
            c._values.update(values)


def test_descheduler_moves_record_as_jax(jax_move_counters_kept):
    from tests.test_torch_descheduler import Twin, fresh_monitors  # noqa: F401
    from tests.test_torch_descheduler import pod_wire as dpod_wire

    twin = Twin()
    twin.fragment()
    twin.each("create", "pods", dpod_wire("waiting", cpu="500m"))
    j, t = twin.deschedulers()
    out = twin.both(j, t, "sync_once")
    assert out["moves_executed"] > 0
    twin.assert_same()
    decisions, _ = assert_rings_same()
    moves = [d for d in decisions if d["outcome"] == "rebalance_nominated"]
    assert len(moves) == out["moves_executed"]
    assert all(d["nominatedNode"] and d["reason"].startswith("defrag move from ")
               for d in moves)


# -- the recorder's unit cases, on both modules ---------------------------


@pytest.mark.parametrize("mod", MODULES, ids=["jax", "port"])
def test_ring_is_bounded_newest_win(mod):
    mod.configure(ring=8)
    mod.DEFAULT.record(mod.Decision(pod=f"default/p{i}", tick=1, trace_id="t", mode="scan",
                                    outcome="bound", node="n0") for i in range(20))
    assert mod.DEFAULT.ring_stats() == (8, 8)
    got = mod.DEFAULT.decisions(limit=100)["decisions"]
    assert [d["pod"] for d in got] == [f"default/p{i}" for i in range(19, 11, -1)]


def test_unit_cases_match_jax():
    """Limit 0, consume-once telemetry, the pod filter by key and by bare
    name, and an amending preemption, each through both modules."""
    def limit_zero(mod):
        mod.DEFAULT.record([mod.Decision(pod="default/p0", tick=1, trace_id="", mode="scan",
                                         outcome="bound", node="n0")])
        mod.DEFAULT.record_solve(mod.SolveRecord(tick=1, trace_id="", mode="scan", pods=1,
                                                 duration_s=0.1))
        return (mod.DEFAULT.decisions(limit=0), mod.DEFAULT.decisions(limit=-3),
                mod.DEFAULT.solves(limit=0))

    def telemetry(mod):
        mod.observe_solve_telemetry("sinkhorn", 24, residual=0.5, waves=3)
        mod.observe_solve_telemetry("wave", 7)
        return mod.take_last_solve_telemetry(), mod.take_last_solve_telemetry()

    def pod_filter(mod):
        mod.DEFAULT.clear()
        mod.DEFAULT.record([
            mod.Decision(pod="ns1/web", tick=1, trace_id="", mode="scan", outcome="bound",
                         node="n0"),
            mod.Decision(pod="ns2/web", tick=1, trace_id="", mode="scan",
                         outcome="unschedulable"),
        ])
        return ([strip(d) for d in mod.DEFAULT.decisions(pod="ns1/web")["decisions"]],
                [strip(d) for d in mod.DEFAULT.decisions(pod="web")["decisions"]],
                [strip(d) for d in mod.DEFAULT.decisions(pod="eb")["decisions"]])

    def amend(mod):
        mod.DEFAULT.clear()
        before = mod.DECISIONS_TOTAL.value(outcome="preempt_nominated")
        mod.DEFAULT.record([mod.Decision(pod="default/hi", tick=3, trace_id="abc", mode="scan",
                                         outcome="unschedulable")])
        mod.DEFAULT.record_preemption("default/hi", "preempt_nominated", node="n2",
                                      victims=("default/lo",))
        mod.DEFAULT.record_preemption("default/other", "rebalance_nominated", node="n1",
                                      reason="defrag move from n0 (gain 2)")
        got = mod.DEFAULT.decisions(limit=10)["decisions"]
        return ([strip(d) for d in got], got[-1]["traceId"],
                mod.DECISIONS_TOTAL.value(outcome="preempt_nominated") - before)

    for case in (limit_zero, telemetry, pod_filter, amend):
        want, got = (case(mod) for mod in MODULES)
        assert got == want, case.__name__
    assert want[0][0]["outcome"] == "rebalance_nominated" and want[1] == "abc" and want[2] == 1
    d = fr.DEFAULT.decisions(pod="hi")["decisions"][0]
    assert fr.format_decision(d) == jfr.format_decision(d)


def test_verdict_table_renders_as_jax():
    entry = {"pod": "default/x", "feasibleNodes": 1, "totalNodes": 3,
             "nodes": [{"node": "n0", "ok": True, "score": 12,
                        "components": {"leastRequested": 7, "balanced": 5, "spreading": 0}},
                       {"node": "n1", "ok": False, "reasons": ["PodFitsResources"]}],
             "reasonCounts": {"PodFitsResources": 2}}
    out = []
    for mod in MODULES:
        d = mod.Decision(pod="default/x", tick=2, trace_id="t", mode="scan", outcome="bound",
                         node="n0", group="default/g")
        d.attach(entry)
        out.append((strip(d.to_dict()), mod.format_decision(d.to_dict())))
    assert out[1] == out[0]


def test_attach_waits_for_the_ring_lock():
    """A table is folded into a decision in the ring under the ring's
    lock, so a reader rendering under it never sees half a table."""
    import threading

    d = fr.Decision(pod="default/x", tick=1, trace_id="", mode="scan", outcome="bound",
                    node="n0")
    fr.DEFAULT.record([d])
    entry = {"feasibleNodes": 1, "totalNodes": 2, "nodes": [{"node": "n0", "ok": True}],
             "reasonCounts": {"PodFitsResources": 1}}
    with fr.DEFAULT._lock:
        t = threading.Thread(target=fr.DEFAULT.attach, args=(d, entry))
        t.start()
        t.join(0.2)
        assert t.is_alive() and d.feasible_nodes == -1
    t.join(5)
    got = fr.DEFAULT.decisions()["decisions"][0]
    assert (got["feasibleNodes"], got["totalNodes"], got["nodes"], got["reasonCounts"]) == (
        1, 2, entry["nodes"], entry["reasonCounts"])


def test_deferred_tables_wait_out_the_tick_and_its_quiet():
    """The deferred bound-pod tables attach only once the solve loop has
    been quiet for _EXPLAIN_QUIET_S after its last tick ended: never
    while a tick runs, however long it runs."""
    import math
    import time

    pair = Pair(n_nodes=8, n_pods=4)
    try:
        d = pair.t
        seen, calls = [], []
        traced = d._traced_tick
        d._traced_tick = lambda *a: seen.append(d._last_busy_mono) or traced(*a)
        pair.settle()
        assert d.schedule_batch(timeout=0.05) == 4
        assert seen == [math.inf] and d._last_busy_mono <= time.monotonic()
        d._attach_verdicts = lambda *a, only=None: calls.append(only)
        d._deferred_explain.append(([], {}, [], [], None, 64))
        for busy in (math.inf, time.monotonic()):
            d._last_busy_mono = busy
            d._run_deferred_explain()
            assert calls == [] and len(d._deferred_explain) == 1
        d._last_busy_mono = time.monotonic() - d._EXPLAIN_QUIET_S - 0.01
        d._run_deferred_explain()
        assert calls == ["bound"] and not d._deferred_explain
        # An idle tick that resolves the in-flight tick is busy too; one
        # with nothing in flight leaves the quiet as it was.
        marks = []
        d._inflight = object()
        d._resolve_inflight = lambda prefer_inline=False: marks.append(d._last_busy_mono) or (
            setattr(d, "_inflight", None))
        quiet = d._last_busy_mono
        assert d.schedule_batch(timeout=0) == 0
        assert marks == [math.inf] and quiet < d._last_busy_mono <= time.monotonic()
        quiet = d._last_busy_mono
        assert d.schedule_batch(timeout=0) == 0
        assert marks == [math.inf] and d._last_busy_mono == quiet
    finally:
        pair.stop()


def test_prewarmed_session_runs_the_explain_readback_once(monkeypatch):
    from kubernetes_tpu_torch.scheduler import daemon as daemon_mod

    pair = Pair(n_nodes=8, n_pods=4)
    try:
        calls = []
        monkeypatch.setattr(daemon_mod, "explain_backlog",
                            lambda pods, nodes, device=None: calls.append(
                                ([p.metadata.name for p in pods], len(nodes), device)))
        pair.t._build_session()
        assert calls == []
        pair.t.prewarm_buckets = 8
        pair.t._build_session()
        assert calls == [(["explain-prewarm"], 1, pair.t.device)]
    finally:
        pair.stop()


# -- the span tree ------------------------------------------------------------


def _drive_traces(mod, seed):
    """The same calls on one tracing module; its buffer's traces less
    the varying fields, and what the filter returns."""
    mod.DEFAULT_BUFFER.clear()
    mod._RNG.seed(seed)
    mod.configure(sample_rate=1.0, max_pods=3)
    with mod.trace("tick", pods=["a", "b"], start=None) as tr:
        tr.step("drained")
        tr.child("enqueue", pods=2, mode="scan")
        with mod.trace("nested", pod="c"):
            mod.note_pods(["d", "e"])
        with mod.span("bind", pods=2) as sp:
            sp.note(ok=True)
        tid = mod.current_trace_id()
    mod.configure(sample_rate=0.0)
    with mod.trace("sampled-out", pods=["z"]) as sp:
        sampled_out = (sp is mod.NULL_SPAN, mod.current_trace_id())
    with mod.trace("remote", trace_id=tid, pod="f"):
        pass  # an explicit id bypasses the sampler, and merges
    with mod.trace("explicit", trace_id="feedface", pods=["y"]):
        pass
    mod.configure(sample_rate=0.5)
    drawn = []
    for i in range(40):
        with mod.trace(f"half{i}") as sp:
            drawn.append(sp is not mod.NULL_SPAN)
    mod.configure(sample_rate=1.0, max_pods=8192)

    def norm(d):
        if isinstance(d, dict):
            return {k: norm(v) for k, v in d.items()
                    if k not in ("traceId", "start", "duration_s", "start_s", "at_s")}
        if isinstance(d, list):
            return [norm(v) for v in d]
        return d

    traces = mod.DEFAULT_BUFFER.to_dicts(limit=100)["traces"]
    by_id = {t["traceId"]: t for t in traces}
    return (norm(traces), norm(mod.DEFAULT_BUFFER.to_dicts(pod="f")["traces"]),
            norm(mod.DEFAULT_BUFFER.to_dicts(pod="y", limit=1)["traces"]),
            norm(mod.DEFAULT_BUFFER.to_dicts(pod="nobody")["traces"]), sampled_out, drawn,
            len(by_id[tid]["spans"]), by_id[tid].get("podsTruncated"))


def test_span_tree_matches_jax():
    """Rates 0, 1 and 0.5 (the same draws from a seeded sampler), an
    explicit id, the cap of pods a trace keeps, the merge by id and the
    pod filter."""
    want, got = _drive_traces(jtracing, 7), _drive_traces(tracing, 7)
    assert got == want
    traces, by_f, by_y, nobody, sampled_out, drawn, spans, truncated = got
    assert sampled_out == (True, "") and 0 < sum(drawn) < 40
    assert spans == 2 and truncated is True
    assert len(by_f) == 1 and len(by_y) == 1 and nobody == []
    assert by_f[0]["pods"] == ["a", "b", "c", "f"]
    tree = by_f[0]["spans"][0]
    assert [c["name"] for c in tree["children"]] == ["enqueue", "nested", "bind"]
    assert tree["steps"][0]["label"] == "drained"
    assert tracing.format_trace(tracing.DEFAULT_BUFFER.to_dicts(pod="y")["traces"][0]).startswith(
        "TRACE feedface")


def test_phases_are_observed_when_sampled_out():
    """A sampled-out trace still feeds the phase histogram and attached
    timers, as before the sampler came back."""
    timer = tracing.PhaseTimer()
    before = tracing.PHASE_SECONDS.count(phase="explain")
    tracing.configure(sample_rate=0.0)
    try:
        with tracing.timing(timer), tracing.trace("tick") as tr:
            assert tr is tracing.NULL_SPAN
            with tracing.phase("explain", pods=1):
                pass
    finally:
        tracing.configure(sample_rate=1.0)
    assert tracing.PHASE_SECONDS.count(phase="explain") == before + 1
    assert "explain" in timer.seconds
