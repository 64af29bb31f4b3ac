"""The port's telemetry plane equals the JAX package's on the same calls.

- The metrics registry (`utils/metrics.py`): the exposition text of one
  sequence of observations, escapes, histogram buckets, summary
  quantiles and `bucket_quantile` equal the JAX module's, character for
  character.
- The span tree (`utils/tracing.py`): one small `solve_backlog_pipelined`
  on the CPU (scan, wave and Sinkhorn) and the batch wrappers record the
  JAX pipeline's span names, nesting and fields; a PhaseTimer reads the
  same seconds as the `scheduler_phase_seconds` histogram.
- The transfer bytes (`utils/sli.py`) of those solves equal the JAX
  package's, h2d and d2h.
- `observe_tick` (`utils/profiler.py`) clamps as the JAX one does, and a
  session tick carries the duty-cycle fields of the JAX PendingSolve.
- The kernel ledger (`ops/ledger.py`): the plain calls of each kernel
  equal the JAX `traced_jit` calls of its counterpart for the same
  calls, and the launches equal `.launches`.

Tolerance: exact everywhere (numbers compared with ==)."""

import math
import time

import numpy as np
import pytest
import torch

from kubernetes_tpu.models import algspec as jalgspec
from kubernetes_tpu.ops import ledger as jledger
from kubernetes_tpu.ops.pipeline import solve_backlog_pipelined as jpipelined
from kubernetes_tpu.scheduler.batch import schedule_backlog_tpu as jschedule
from kubernetes_tpu.scheduler.batch import schedule_backlog_wave as jschedule_wave
from kubernetes_tpu.scheduler.batch import schedule_backlog_sinkhorn as jschedule_sinkhorn
from kubernetes_tpu.utils import metrics as jmetrics
from kubernetes_tpu.utils import profiler as jprofiler
from kubernetes_tpu.utils import rebalance as jrebmod
from kubernetes_tpu.utils import sli as jsli
from kubernetes_tpu.utils import tracing as jtracing
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.models import algspec
from kubernetes_tpu_torch.ops import SolverSession, ledger, policy_scan, rebalance, scan_kernel
from kubernetes_tpu_torch.ops.pipeline import solve_backlog_pipelined
from kubernetes_tpu_torch.scheduler.batch import (
    schedule_backlog,
    schedule_backlog_sinkhorn,
    schedule_backlog_wave,
)
from kubernetes_tpu_torch.utils import metrics, profiler, sli, tracing
from kubernetes_tpu_torch.utils import rebalance as rebmod


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain loops run thousands of tiny torch ops: one intra-op
    thread keeps them fast under parallel test workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# -- the metrics registry -------------------------------------------------


def _observe(mod):
    """One sequence of observations into a fresh registry of `mod`."""
    reg = mod.Registry()
    c = reg.counter("t_requests_total", 'Requests by "code"\\ and path\nsecond line', ("code", "path"))
    c.inc(code="200", path='/a"b\\c\nd')
    c.inc(2.5, code="500", path="/")
    g = reg.gauge("t_depth", "Queue depth")
    g.set(7.0)
    g.set(-1.25)
    s = reg.summary("t_latency_summary_seconds", "Summary", ("op",))
    h = reg.histogram("t_latency_seconds", "Histogram", ("op",))
    h2 = reg.histogram("t_ratio", "Ratios", buckets=(0.1, 0.5, 1.0))
    rng = np.random.default_rng(3)
    for v in rng.exponential(0.2, size=300).tolist() + [0.0, 0.005, 130.0]:
        s.observe(v, op="solve")
        h.observe(v, op="solve")
        h2.observe(min(v, 2.0))
    h.observe(0.3, op="bind")
    return reg, h


def test_exposition_text_equals_jax():
    reg, h = _observe(metrics)
    jreg, jh = _observe(jmetrics)
    assert reg.render() == jreg.render()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        a, b = h.quantile(q, op="solve"), jh.quantile(q, op="solve")
        assert a == b or (math.isnan(a) and math.isnan(b))
    assert math.isnan(h.quantile(0.5, op="none")) and math.isnan(jh.quantile(0.5, op="none"))


@pytest.mark.parametrize("counts,q", [
    ((0, 0, 0), 0.5), ((1, 0, 0), 0.5), ((3, 5, 2), 0.9), ((0, 4, 0), 0.25), ((2, 2, 2), 1.0),
])
def test_bucket_quantile_equals_jax(counts, q):
    bounds = (0.1, 0.5, 1.0)
    total = sum(counts)
    a = metrics.bucket_quantile(bounds, counts, total, q)
    b = jmetrics.bucket_quantile(bounds, counts, total, q)
    assert a == b or (math.isnan(a) and math.isnan(b))
    assert metrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS


# -- spans, transfers and ledger calls of one small solve -----------------


def _strip(d):
    """A span dict without its times: (name, fields, children)."""
    return (d["name"], d.get("fields", {}), [_strip(c) for c in d.get("children", ())])


def _traced(trace_mod, fn):
    # An explicit id keeps the JAX trace out of its sampler's reach.
    kw = {"trace_id": "telemetry-test"} if trace_mod is jtracing else {}
    with trace_mod.trace("test", **kw) as root:
        out = fn()
    return out, _strip(root.to_dict(root.start))


def _transfers(sli_mod):
    return {d: sli_mod.TRANSFER_BYTES.value(direction=d) for d in ("h2d", "d2h")}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _jcalls(kernel):
    for row in jledger.DEFAULT.rows():
        if row["kernel"] == kernel:
            return row["calls"]
    return 0


@pytest.fixture(scope="module")
def backlog():
    return workload.synthetic_objects(300, 20, seed=4)


@pytest.mark.parametrize("mode", ["scan", "wave", "sinkhorn"])
def test_pipelined_spans_transfers_and_calls_equal_jax(backlog, mode):
    """Three chunks of 128: the JAX pipeline's span tree (lower with the
    pod count, upload, then lower, upload and solve a chunk with its
    index, readback), its h2d and d2h bytes, and in scan mode one plain
    scan call a chunk against JAX's `solver._solve_with_state_xla`."""
    pods, nodes, services = backlog
    t0, j0 = _transfers(sli), _transfers(jsli)
    c0, jc0, l0 = (ledger.DEFAULT.calls("scan_kernel", "plain"),
                   _jcalls("solver._solve_with_state_xla"), scan_kernel.scan_with_state.launches)
    lc0 = ledger.DEFAULT.calls("scan_kernel", "cuda")
    got, tree = _traced(tracing, lambda: solve_backlog_pipelined(
        pods, nodes, services=services, chunk=128, mode=mode, device="cpu"))
    t1 = _transfers(sli)
    want, jtree = _traced(jtracing, lambda: jpipelined(
        pods, nodes, services=services, chunk=128, mode=mode))
    j1 = _transfers(jsli)
    if mode != "sinkhorn":
        assert got == want
    assert tree == jtree
    assert [c[0] for c in tree[2]] == ["lower", "upload"] + ["lower", "upload", "solve"] * 3 + ["readback"]
    assert _delta(t1, t0) == _delta(j1, j0) and _delta(t1, t0)["h2d"] > 0
    if mode == "scan":
        calls = ledger.DEFAULT.calls("scan_kernel", "plain") - c0
        assert calls == _jcalls("solver._solve_with_state_xla") - jc0 == 3
        # No launch on the CPU: the ledger's launches are the counter's.
        assert (ledger.DEFAULT.calls("scan_kernel", "cuda") - lc0
                == scan_kernel.scan_with_state.launches - l0 == 0)


@pytest.mark.parametrize("mode", ["scan", "wave", "sinkhorn"])
def test_batch_spans_and_transfers_equal_jax(backlog, mode):
    """The batch wrappers: lower, upload, solve (with the solver's fields:
    the mode, or the solver and its waves and Sinkhorn telemetry),
    readback. Sinkhorn agrees with JAX within its rounding, so its
    telemetry fields are compared by name."""
    pods, nodes, services = backlog
    port, jax_ = {"scan": (schedule_backlog, jschedule), "wave": (schedule_backlog_wave, jschedule_wave),
                  "sinkhorn": (schedule_backlog_sinkhorn, jschedule_sinkhorn)}[mode]
    t0, j0 = _transfers(sli), _transfers(jsli)
    jc0 = _jcalls("solver._solve_xla")
    c0 = ledger.DEFAULT.calls("scan_kernel", "plain")
    got, tree = _traced(tracing, lambda: port(pods, nodes, services=services, device="cpu"))
    t1 = _transfers(sli)
    want, jtree = _traced(jtracing, lambda: jax_(pods, nodes, services=services))
    j1 = _transfers(jsli)
    if mode == "sinkhorn":
        strip = lambda t: (t[0], sorted(t[1]), [strip(c) for c in t[2]])  # noqa: E731
        assert strip(tree) == strip(jtree)
    else:
        assert got == want and tree == jtree
    assert [c[0] for c in tree[2]] == ["lower", "upload", "solve", "readback"]
    assert _delta(t1, t0) == _delta(j1, j0) and _delta(t1, t0)["h2d"] > 0
    if mode == "scan":
        assert ledger.DEFAULT.calls("scan_kernel", "plain") - c0 == _jcalls("solver._solve_xla") - jc0 == 1


def test_phase_timer_reads_the_histogram(backlog):
    """A PhaseTimer and scheduler_phase_seconds see one measurement of
    each phase."""
    pods, nodes, services = backlog
    hist = tracing.PHASE_SECONDS
    names = ("lower", "upload", "solve", "readback")
    before = {p: hist.snapshot().get((p,), (0, 0.0, ()))[:2] for p in names}
    timer = tracing.PhaseTimer()
    solve_backlog_pipelined(pods, nodes, services=services, chunk=128, device="cpu", timer=timer)
    after = {p: hist.snapshot()[(p,)][:2] for p in names}
    assert set(timer.seconds) == set(names)
    for p in names:
        count = after[p][0] - before[p][0]
        assert count == (4 if p in ("lower", "upload") else 3 if p == "solve" else 1)
        assert after[p][1] - before[p][1] == pytest.approx(timer.seconds[p], rel=0, abs=1e-9)


def test_policy_and_rebalance_calls_equal_jax():
    """One policy solve: one plain policy scan call against one JAX
    `solver._solve_xla` call; one defrag plan: one plain K2 call against
    one JAX `rebalance.plan_moves` call. Each ledger row carries the
    launch's cost."""
    pending, nodes, assigned, services = workload.policy_cluster(2)
    spec = algspec.spec_from_policy(workload.FULL_VOCABULARY_POLICY)
    jspec = jalgspec.spec_from_policy(workload.FULL_VOCABULARY_POLICY)
    c0, jc0 = ledger.DEFAULT.calls("policy_scan_kernel", "plain"), _jcalls("solver._solve_xla")
    l0 = policy_scan.policy_scan_with_state.launches
    got = schedule_backlog(pending, nodes, assigned, services, spec=spec, device="cpu")
    assert got == jschedule(pending, nodes, assigned, services, spec=jspec)
    assert ledger.DEFAULT.calls("policy_scan_kernel", "plain") - c0 == _jcalls("solver._solve_xla") - jc0 == 1
    assert policy_scan.policy_scan_with_state.launches == l0

    from tests.test_torch_rebalance import PROBES, _pods
    from tests.test_rebalance import _cols

    names = [f"n{j}" for j in range(6)]
    cols, rpods = _cols(6, cpu_fit=600.0, pods_used=3.0), _pods({n: 3 for n in names})
    c0, jc0 = ledger.DEFAULT.calls("rebalance_kernel", "plain"), _jcalls("rebalance.plan_moves")
    plan = rebmod.build_plan(cols, names, rpods, PROBES, device="cpu")
    assert plan == jrebmod.build_plan(cols, names, rpods, PROBES)
    assert ledger.DEFAULT.calls("rebalance_kernel", "plain") - c0 == _jcalls("rebalance.plan_moves") - jc0 == 1
    row = next(r for r in ledger.DEFAULT.rows() if (r["kernel"], r["impl"]) == ("rebalance_kernel", "plain"))
    shape = next(s for s in row["shapes"] if s["signature"] == f"N=6,D={len(rpods)},Q=1")
    assert shape["flops"] == rebalance.cost(6, len(rpods), 1)["flops"] > 0
    assert shape["bytes_accessed"] == rebalance.cost(6, len(rpods), 1)["bytes_accessed"]
    assert shape["calls"] >= 1 and shape["cost_status"] == "ok"


def test_capacity_sample_and_planned_moves_feed_the_series():
    """`utils.capacity.sample` returns the capacity report and observes
    it: headroom per probe, one score, one allocatable share, one
    utilisation a live node and resource. `build_plan` counts its
    planned moves under rebalance_moves_total{outcome="planned"}."""
    from kubernetes_tpu_torch.ops.capacity import capacity_report
    from kubernetes_tpu_torch.utils import capacity
    from tests.test_torch_rebalance import PROBES, _pods
    from tests.test_rebalance import _cols

    args = workload.random_rebalance_args(3)
    cols = dict(zip(capacity.COLUMN_KEYS, args[:8]))
    probes = [("small", 100.0, 64.0, 1), ("wide", 900.0, 512.0, 4)]
    frag0, util0 = capacity.FRAG_SCORE.count(), capacity.NODE_UTIL.count(resource="cpu")
    got = capacity.sample(cols, probes, device="cpu")
    want = capacity_report(*args[:8], *capacity.probe_arrays(probes), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [capacity.HEADROOM.value(shape=n) for n, *_ in probes] == [float(h) for h in want[4]]
    live = int((np.asarray(cols["sched"]) & ~np.asarray(cols["over"])).sum())
    assert capacity.FRAG_SCORE.count() - frag0 == 1
    assert capacity.NODE_UTIL.count(resource="cpu") - util0 == live

    names = [f"n{j}" for j in range(6)]
    cols, rpods = _cols(6, cpu_fit=600.0, pods_used=3.0), _pods({n: 3 for n in names})
    m0 = rebmod.MOVES.value(outcome="planned")
    plan = rebmod.build_plan(cols, names, rpods, PROBES, device="cpu")
    assert plan["moves"] and rebmod.MOVES.value(outcome="planned") - m0 == len(plan["moves"])


def test_ledger_rows_and_summary():
    led = ledger.KernelLedger()
    led.note_call("k", "cuda", "P=1", lambda: {"flops": 10, "bytes_accessed": 5})
    led.note_call("k", "cuda", "P=1", lambda: pytest.fail("cost is worked out once a shape"))
    led.note_call("k", "plain")
    led.record_build("k", "cuda", 1.5)
    rows = led.rows()
    assert [(r["kernel"], r["impl"], r["calls"], r["compiles"]) for r in rows] == [
        ("k", "cuda", 2, 1), ("k", "plain", 1, 0)]
    assert rows[0]["shapes"] == [{"signature": "P=1", "calls": 2, "flops": 10.0, "bytes_accessed": 5.0,
                                  "cost_status": "ok", "arithmetic_intensity": 2.0}]
    summary = led.summary()
    assert (summary["kernels"], summary["rows"], summary["calls_total"], summary["compiles"]) == (1, 2, 3, 1)
    assert summary["top_flops"] == [{"kernel": "k", "impl": "cuda", "flops": 10.0}]
    led.reset()
    assert led.rows() == []


# -- duty cycle -----------------------------------------------------------


def _fresh_tick_series(monkeypatch, mod, metrics_mod):
    """`mod`'s three tick series swapped for fresh ones (same names and
    buckets) in a fresh registry, so earlier observations in the process
    do not count."""
    reg = metrics_mod.Registry()
    for attr in ("DUTY_CYCLE", "OVERLAP"):
        old = getattr(mod, attr)
        monkeypatch.setattr(mod, attr, reg.histogram(old.name, old.help, buckets=old.buckets))
    monkeypatch.setattr(mod, "DEVICE_BUSY", reg.counter(mod.DEVICE_BUSY.name, mod.DEVICE_BUSY.help))
    return reg


def test_observe_tick_clamps_equal_jax(monkeypatch):
    """The same ticks, clamps included (no busy window, no period,
    negative blocked time, over-long windows), give the JAX series'
    exposition text exactly."""
    reg = _fresh_tick_series(monkeypatch, profiler, metrics)
    jreg = _fresh_tick_series(monkeypatch, jprofiler, jmetrics)
    ticks = [(0.5, 1.0, 0.1), (2.0, 1.0, 0.0), (0.3, 0.3, 0.9), (0.0, 1.0, 0.0),
             (0.1, 0.0, 0.0), (-1.0, 1.0, 0.0), (0.25, 0.5, -0.1), (1e-9, 1.0, 1e-9)]
    for t in ticks:
        profiler.observe_tick(*t)
        jprofiler.observe_tick(*t)
    assert profiler.RATIO_BUCKETS == jprofiler.RATIO_BUCKETS
    assert profiler.DUTY_CYCLE.count() == 5  # three ticks have no busy window or period
    assert reg.render() == jreg.render()


def test_session_tick_carries_duty_fields(backlog):
    pods, nodes, services = backlog
    session = SolverSession(nodes, services, device="cpu")
    for pod in pods[:40]:
        session.add_pending(pod)
    t0 = _transfers(sli)
    handle = session.solve_async()
    assert handle.dispatch_s >= 0.0 and handle.resolved_mono == 0.0
    results = handle.result()
    assert len(results) == 40
    assert handle.dispatched_mono <= handle.resolved_mono
    assert 0.0 <= handle.block_s <= handle.resolved_mono - handle.dispatched_mono + handle.dispatch_s
    moved = _delta(_transfers(sli), t0)
    assert moved["d2h"] == 4 * 128  # the choices of the 128-pod bucket
    assert moved["h2d"] > 0


def test_device_telemetry_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sli.observe_device_telemetry()
    assert sli.XLA_CACHE_ENTRIES.value() >= 0
    assert sli.nbytes_of({"a": np.zeros(3, np.int32), "b": torch.zeros(2, dtype=torch.int64)}) == 28


def test_capture_device_trace_writes_a_trace_and_refuses_to_nest(tmp_path):
    """torch.profiler around a short sleep (here on the CPU only): a
    Chrome trace in the directory asked for; a second capture while one
    runs raises TraceInProgress, as the JAX capture does."""
    import threading

    out = {}
    started = threading.Event()

    def capture():
        started.set()
        out.update(profiler.capture_device_trace(0.5, out_dir=str(tmp_path)))

    worker = threading.Thread(target=capture)
    worker.start()
    started.wait(5)
    deadline = time.monotonic() + 5
    while not profiler._CAPTURE_ACTIVE[0] and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(profiler.TraceInProgress):
        profiler.capture_device_trace(0.1)
    worker.join(timeout=30)
    assert not worker.is_alive()
    assert out["dir"] == str(tmp_path) and out["seconds"] == 0.5
    assert out["files"] == ["trace.json"]
    assert profiler.MAX_TRACE_SECONDS == jprofiler.MAX_TRACE_SECONDS
