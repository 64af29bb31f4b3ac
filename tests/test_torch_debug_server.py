"""The port's health and debug server answers as the JAX package's.

The port's `cmd/daemons.HealthServer` is started beside the JAX
package's apiserver over HTTP, and both packages' rings are filled with
the same contents (decisions, solve records, and traces built with
fixed clocks). Every `/debug/*` view of the port must then return the
body the JAX apiserver returns for the same path: the decision, solve
and trace lists with their query parameters, the capacity and
rebalance planes, the 400s of bad numbers and formats, the 409 of a
capture already running and the 503 of an unavailable profiler. A 404
lists the port's own views. `/healthz` turns 500 once the daemon's loop
thread dies, and the JAX package's `ktctl explain` and `ktctl trace`,
given a client on the port's address, print what they print against the
JAX apiserver; so does the port's CLI over the port's client.

Also here: the port's HTTP client stamps the tick's trace id on its
requests, so the apiserver records the bind under the tick's id, as
it does for the JAX daemon's; `_start_health`'s rules; and the port's
command serving its views on the CPU.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from kubernetes_tpu.cli import ktctl
from kubernetes_tpu.client import Client as JClient
from kubernetes_tpu.client import HTTPTransport as JHTTPTransport
from kubernetes_tpu.client import LocalTransport as JLocalTransport
from kubernetes_tpu.scheduler.daemon import IncrementalBatchScheduler as JDaemon
from kubernetes_tpu.scheduler.daemon import SchedulerConfig as JConfig
from kubernetes_tpu.server.api import APIServer
from kubernetes_tpu.server.httpserver import APIHTTPServer
from kubernetes_tpu.utils import capacity as jcapmod
from kubernetes_tpu.utils import flightrecorder as jfr
from kubernetes_tpu.utils import profiler as jprofiler
from kubernetes_tpu.utils import rebalance as jrebmod
from kubernetes_tpu.utils import tracing as jtracing
from kubernetes_tpu_torch.client.rest import Client, HTTPTransport, LocalTransport
from kubernetes_tpu_torch.cmd import daemons
from kubernetes_tpu_torch.cmd.scheduler import scheduler_parser
from kubernetes_tpu_torch.ops import ledger
from kubernetes_tpu_torch.scheduler.daemon import IncrementalBatchScheduler, SchedulerConfig
from kubernetes_tpu_torch.utils import capacity as capmod
from kubernetes_tpu_torch.utils import flightrecorder as fr
from kubernetes_tpu_torch.utils import profiler
from kubernetes_tpu_torch.utils import rebalance as rebmod
from kubernetes_tpu_torch.utils import tracing
from tests.test_torch_daemon import _one_torch_thread, node_wire, pod_wire, wait_until  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMP = "2026-01-02T03:04:05Z"


def get(url):
    """(status, content type, body) of a GET."""
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


def fill(fr_mod, tr_mod):
    """The same ring contents in one package's recorder and buffer."""
    rec = fr_mod.DEFAULT
    table = {"pod": "default/p1", "feasibleNodes": 1, "totalNodes": 3,
             "nodes": [{"node": "n0", "ok": True, "score": 14,
                        "components": {"leastRequested": 8, "balanced": 6, "spreading": 0}},
                       {"node": "n1", "ok": False, "reasons": ["PodFitsResources"]}],
             "reasonCounts": {"PodFitsResources": 1, "MatchNodeSelector": 1}}
    stuck = {"pod": "ns1/web", "feasibleNodes": 0, "totalNodes": 3,
             "nodes": [{"node": f"n{j}", "ok": False, "reasons": ["PodFitsResources"]}
                       for j in range(3)], "reasonCounts": {"PodFitsResources": 3}}
    for tick, tid in ((1, "aaaa"), (2, "bbbb")):
        rec.next_tick()
        rec.record_solve(fr_mod.SolveRecord(tick=tick, trace_id=tid, mode="scan", pods=3,
                                            duration_s=0.0123456789, incremental=True,
                                            time=STAMP))
    rec.record_solve(fr_mod.SolveRecord(tick=3, trace_id="cccc", mode="sinkhorn", pods=2,
                                        duration_s=0.5, waves=3, sinkhorn_iterations=41,
                                        sinkhorn_residual=0.01234567, time=STAMP))
    decisions = [
        fr_mod.Decision(pod="default/p0", tick=1, trace_id="aaaa", mode="scan",
                        outcome="bound", node="n2", time=STAMP),
        fr_mod.Decision(pod="default/p1", tick=2, trace_id="bbbb", mode="scan",
                        outcome="bound", node="n0", group="default/g", time=STAMP),
        fr_mod.Decision(pod="ns1/web", tick=2, trace_id="bbbb", mode="scan",
                        outcome="unschedulable", time=STAMP),
        fr_mod.Decision(pod="ns2/web", tick=2, trace_id="bbbb", mode="scan",
                        outcome="unschedulable", time=STAMP),
    ]
    decisions[1].attach(table)
    decisions[2].attach(stuck)
    rec.record(decisions)
    rec.record_preemption("ns2/web", "preempt_nominated", node="n1", victims=("default/lo",))
    rec.record_preemption("default/moved", "rebalance_nominated", node="n0",
                          reason="defrag move from n1 (gain 2)")
    for tid, start, pods in (("aaaa", 100.0, ["p0"]), ("bbbb", 200.0, ["p1", "web"])):
        tr = tr_mod.Trace("schedule_batch", trace_id=tid, start=start)
        tr.start_wall = 1.7e9
        tr.root.child("enqueue", start=start, end=start + 0.001, pods=len(pods), mode="scan")
        tr.root.child("solve", start=start + 0.002, end=start + 0.25)
        tr.root.steps.append((start + 0.1, "readback"))
        tr.root.end = start + 0.3
        tr.note_pods(pods)
        tr_mod.DEFAULT_BUFFER.record(tr)
    # The apiserver's span of the bind, under the tick's id.
    tr = tr_mod.Trace("POST /api/v1/namespaces/default/bulkbindings", trace_id="bbbb", start=200.2)
    tr.start_wall = 1.7e9
    tr.root.end = 200.21
    tr.note_pods(["p1"])
    tr_mod.DEFAULT_BUFFER.record(tr)


@pytest.fixture
def servers(monkeypatch):
    """(the JAX apiserver's address, the port's HealthServer address),
    both packages' rings holding the same contents."""
    for mod in (jfr, fr):
        monkeypatch.setattr(mod, "DEFAULT", mod.FlightRecorder())
    for mod in (jtracing, tracing):
        monkeypatch.setattr(mod, "DEFAULT_BUFFER", mod.TraceBuffer())
    monkeypatch.setattr(jcapmod, "DEFAULT", jcapmod.CapacityMonitor())
    monkeypatch.setattr(capmod, "DEFAULT", capmod.CapacityMonitor())
    monkeypatch.setattr(jrebmod, "DEFAULT", jrebmod.RebalanceMonitor())
    monkeypatch.setattr(rebmod, "DEFAULT", rebmod.RebalanceMonitor())
    fill(jfr, jtracing)
    fill(fr, tracing)
    jsrv = APIHTTPServer(APIServer()).start()
    health = daemons.HealthServer(0).start()
    try:
        yield jsrv.address, health.address
    finally:
        health.stop()
        jsrv.stop()


SAME_BODY = [
    "/debug/decisions", "/debug/decisions?limit=2", "/debug/decisions?pod=web",
    "/debug/decisions?pod=ns1/web", "/debug/decisions?pod=default/p1&limit=1",
    "/debug/decisions?limit=0", "/debug/decisions?pod=nobody",
    "/debug/solves", "/debug/solves?limit=1", "/debug/solves?limit=-2",
    "/debug/traces", "/debug/traces?pod=p1", "/debug/traces?limit=1",
    "/debug/traces?pod=nobody",
    "/debug/capacity", "/debug/rebalance",
    "/debug/decisions?limit=x", "/debug/solves?limit=1.5", "/debug/traces?limit=",
    "/debug/profile?seconds=x", "/debug/profile?seconds=0.1&format=bogus",
    "/debug/device-profile?seconds=x",
]


@pytest.mark.parametrize("path", SAME_BODY)
def test_debug_views_answer_as_the_jax_apiserver(servers, path):
    jaddr, taddr = servers
    want, got = get(jaddr + path), get(taddr + path)
    assert got[0] == want[0] and got[1] == want[1]
    assert json.loads(got[2]) == json.loads(want[2])


def test_a_capture_in_progress_and_an_unavailable_profiler(servers, monkeypatch):
    jaddr, taddr = servers
    for mod in (jprofiler, profiler):
        monkeypatch.setattr(mod, "capture_device_trace", lambda seconds=2.0, _m=mod: (
            _ for _ in ()).throw(_m.TraceInProgress("a device trace capture is already in "
                                                    "progress")))
    for want, got in [(get(jaddr + "/debug/device-profile?seconds=0.1"),
                       get(taddr + "/debug/device-profile?seconds=0.1"))]:
        assert got[0] == want[0] == 409 and json.loads(got[2]) == json.loads(want[2])
    for mod in (jprofiler, profiler):
        monkeypatch.setattr(mod, "capture_device_trace", lambda seconds=2.0, _m=mod: (
            _ for _ in ()).throw(_m.ProfilerUnavailable("no profiler here")))
    want, got = get(jaddr + "/debug/device-profile"), get(taddr + "/debug/device-profile")
    assert got[0] == want[0] == 503 and json.loads(got[2]) == json.loads(want[2])


def test_unknown_views_stacks_profile_slo_and_kernels(servers, monkeypatch):
    jaddr, taddr = servers
    want, got = get(jaddr + "/debug/nope"), get(taddr + "/debug/nope")
    assert got[0] == want[0] == 404
    jstatus, status = json.loads(want[2]), json.loads(got[2])
    assert {k: v for k, v in status.items() if k != "message"} == {
        k: v for k, v in jstatus.items() if k != "message"}
    assert all(f"/debug/{v}" in status["message"] for v in daemons.DEBUG_VIEWS)
    assert get(taddr + "/nope")[0] == 404
    code, ctype, body = get(taddr + "/debug/stacks")
    assert code == 200 and ctype == get(jaddr + "/debug/stacks")[1] and "--- thread" in body
    code, ctype, body = get(taddr + "/debug/profile?seconds=0.1&format=collapsed")
    assert code == 200 and ctype == get(jaddr + "/debug/profile?seconds=0.1")[1]
    code, _, body = get(taddr + "/debug/profile?seconds=0.1")
    assert code == 200 and body.startswith("sampling profile:")
    jslo_body, slo_body = json.loads(get(jaddr + "/debug/slo")[2]), json.loads(
        get(taddr + "/debug/slo")[2])
    assert slo_body["kind"] == jslo_body["kind"] == "SLOReport"
    assert [o["name"] for o in slo_body["objectives"]] == [
        o["name"] for o in jslo_body["objectives"]]
    ledger.DEFAULT.note_call("scan_kernel", "plain")
    body = json.loads(get(taddr + "/debug/kernels")[2])
    assert body == json.loads(json.dumps(ledger.DEFAULT.to_dict()))
    assert set(body) == set(json.loads(get(jaddr + "/debug/kernels")[2])) == {"kernels",
                                                                              "summary"}
    monkeypatch.delitem(sys.modules, "kubernetes_tpu_torch.ops.ledger")
    assert json.loads(daemons.serve_debug("kernels", {})[0]) == {
        "kernels": [], "summary": {"compiles": 0}}


def test_device_profile_returns_a_directory(servers):
    _, taddr = servers
    code, _, body = get(taddr + "/debug/device-profile?seconds=0.1")
    assert code == 200
    info = json.loads(body)
    try:
        assert os.path.isdir(info["dir"]) and "trace.json" in info["files"]
    finally:
        shutil.rmtree(info["dir"], ignore_errors=True)


@pytest.mark.parametrize("argv", [
    ["explain", "pod", "p1"], ["explain", "pod", "web", "-n", "ns2"],
    ["explain", "pod", "web", "-n", "ns1", "--limit", "4"], ["explain", "pod", "moved"],
    ["explain", "pod", "p1", "-o", "json"], ["explain", "pod", "missing"],
    ["trace"], ["trace", "p1"], ["trace", "web", "-o", "json"], ["trace", "missing"],
])
def test_ktctl_reads_the_port_s_views(servers, capsys, argv):
    jaddr, taddr = servers
    out = []
    for addr in (jaddr, taddr):
        rc = ktctl.main(list(argv), client=JClient(JHTTPTransport(addr)))
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    assert out[1] == out[0]
    assert (out[0][0] == 1) == ("missing" in argv)


@pytest.mark.parametrize("argv", [
    ["explain", "pod", "p1"], ["explain", "pod", "web", "-n", "ns1", "--limit", "4"],
    ["explain", "pod", "moved"], ["explain", "pod", "p1", "-o", "yaml"],
    ["explain", "pod", "missing"], ["trace"], ["trace", "p1", "-o", "json"],
    ["trace", "missing"],
])
def test_port_ktctl_reads_the_port_s_views_as_jax_ktctl_reads_jax_s(servers, capsys, argv):
    """The port's CLI over the port's HTTP transport on the port's views
    prints what JAX's CLI prints on JAX's."""
    from kubernetes_tpu_torch.cli import ktctl as port_ktctl

    jaddr, taddr = servers
    out = []
    for main, client in ((ktctl.main, JClient(JHTTPTransport(jaddr))),
                         (port_ktctl.main, Client(HTTPTransport(taddr)))):
        rc = main(list(argv), client=client)
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    assert out[1] == out[0]
    assert (out[0][0] == 1) == ("missing" in argv)


def test_healthz_turns_500_when_the_loop_dies(monkeypatch):
    api = APIServer()
    setup = JClient(JLocalTransport(api))
    setup.create("nodes", node_wire("n0", np.random.default_rng(0)))
    cfg = SchedulerConfig(Client(LocalTransport(api))).start()
    assert cfg.wait_for_sync()
    daemon = IncrementalBatchScheduler(cfg, device="cpu")
    daemon.prewarm()
    monkeypatch.setattr(daemon._session, "solve_async",
                        lambda: (_ for _ in ()).throw(RuntimeError("device lost")))
    health = daemons.HealthServer(0, [daemons._loop_alive_check(daemon)]).start()
    try:
        assert get(health.address + "/healthz")[::2] == (200, "ok")
        daemon.start()
        assert get(health.address + "/healthz")[::2] == (200, "ok")
        code, _, body = get(health.address + "/metrics")
        assert code == 200 and "scheduler_phase_seconds" in body
        setup.create("pods", pod_wire("x", np.random.default_rng(1)), namespace="default")
        assert wait_until(lambda: not daemon._thread.is_alive())
        assert get(health.address + "/healthz")[::2] == (500, "loop not running")
    finally:
        health.stop()
        daemon.stop()


def test_start_health_rules(capsys):
    args = scheduler_parser().parse_args([])
    assert args.healthz_port == 10251
    args.healthz_port = -1
    assert daemons._start_health(args, []) is None
    taken = daemons.HealthServer(0).start()
    try:
        args.healthz_port = taken.port
        assert daemons._start_health(args, []) is None
        assert f"healthz port {taken.port} unavailable" in capsys.readouterr().err
        args.healthz_port = 0
        srv = daemons._start_health(args, [lambda: (False, "broken"), lambda: 1 / 0])
        try:
            code, _, body = get(srv.address + "/healthz")
            assert code == 500 and body == "broken; ZeroDivisionError: division by zero"
        finally:
            srv.stop()
    finally:
        taken.stop()


def test_binds_are_recorded_under_the_tick_s_trace_id_as_jax(monkeypatch):
    """The JAX daemon and the port's, each over HTTP to an apiserver of
    its own, tick once: the apiserver records each bulk bind under the
    tick's trace id, with the bound pods."""
    for mod in (jfr, fr):
        monkeypatch.setattr(mod, "DEFAULT", mod.FlightRecorder())
    monkeypatch.setattr(jtracing, "DEFAULT_BUFFER", jtracing.TraceBuffer())
    for mod in (jtracing, tracing):
        mod.configure(sample_rate=1.0)
    rng = np.random.default_rng(3)
    nodes = [node_wire(f"n{j}", rng) for j in range(4)]
    pods = [pod_wire(f"p{i}", rng, cpu="100m") for i in range(12)]
    srvs, daemons_ = [], []
    try:
        for k in range(2):
            api = APIServer()
            setup = JClient(JLocalTransport(api))
            for n in nodes:
                setup.create("nodes", n)
            setup.create_bulk("pods", pods, namespace="default")
            srvs.append(APIHTTPServer(api).start())
        jcfg = JConfig(JClient(JHTTPTransport(srvs[0].address))).start()
        tcfg = SchedulerConfig(Client(HTTPTransport(srvs[1].address))).start()
        assert jcfg.wait_for_sync() and tcfg.wait_for_sync()
        assert wait_until(lambda: len(jcfg.pod_queue) == len(tcfg.pod_queue) == 12)
        daemons_ = [JDaemon(jcfg), IncrementalBatchScheduler(tcfg, device="cpu")]
        assert [d.schedule_batch(timeout=0.5) for d in daemons_] == [12, 12]
        ids = [mod.DEFAULT.solves()["solves"][0]["traceId"] for mod in (jfr, fr)]
        assert all(ids) and ids[0] != ids[1]
        traces = {t["traceId"]: t for t in jtracing.DEFAULT_BUFFER.to_dicts(limit=512)["traces"]}
        seen = []
        for tid in ids:
            binds = [s for s in traces[tid]["spans"] if s["name"].endswith("/bulkbindings")]
            seen.append(([s["name"] for s in binds], set(traces[tid]["pods"])))
        assert seen[1][0] == seen[0][0] == ["POST /api/v1/namespaces/default/bulkbindings"]
        bound = {p.metadata.name for p in tcfg.client.list("pods", namespace="default")[0]
                 if p.spec.node_name}
        assert seen[1][1] == bound and bound <= seen[0][1]
    finally:
        for d in daemons_:
            d.stop()
        for s in srvs:
            s.stop()


def test_the_command_serves_its_views_on_the_cpu():
    """`python -m kubernetes_tpu_torch.cmd.scheduler --batch --device cpu
    --healthz-port 0` binds a pod, and its debug server shows the
    decision, the solve and the trace; SIGTERM ends it with 0."""
    api = APIServer()
    setup = JClient(JLocalTransport(api))
    rng = np.random.default_rng(5)
    for j in range(3):
        setup.create("nodes", node_wire(f"n{j}", rng))
    srv = APIHTTPServer(api).start()
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubernetes_tpu_torch.cmd.scheduler", "--server", srv.address,
         "--batch", "--device", "cpu", "--prewarm-buckets", "0", "--healthz-port", "0"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    try:
        assert wait_until(lambda: any(ln.startswith("healthz serving on") for ln in lines), 60)
        addr = "http://" + next(ln for ln in lines if ln.startswith("healthz")).split()[-1]
        assert get(addr + "/healthz")[::2] == (200, "ok")
        setup.create("pods", pod_wire("p", rng, cpu="100m"), namespace="default")
        assert wait_until(lambda: setup.get("pods", "p", namespace="default").spec.node_name, 60)
        node = setup.get("pods", "p", namespace="default").spec.node_name

        def decision():
            got = json.loads(get(addr + "/debug/decisions?pod=p")[2])["decisions"]
            return got[0] if got else None

        assert wait_until(lambda: decision() is not None, 30)
        d = decision()
        assert d["outcome"] == "bound" and d["node"] == node and d["pod"] == "default/p"
        solves = json.loads(get(addr + "/debug/solves")[2])["solves"]
        assert solves and solves[0]["incremental"] and solves[0]["pods"] >= 1
        traces = json.loads(get(addr + "/debug/traces?pod=p")[2])["traces"]
        assert traces and "p" in traces[0]["pods"]
        assert 'scheduler_decisions_total{outcome="bound"} 1' in get(addr + "/metrics")[2]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        srv.stop()
