"""The port's ktctl against the JAX package's, twin by twin.

Each package's `APIServer` is seeded with the same objects (made from a
seed with numpy); the same argv goes through JAX's
`kubernetes_tpu.cli.ktctl.main(argv, client=...)` and the port's
`kubernetes_tpu_torch.cli.ktctl.main`, over each package's
`LocalTransport` and over each package's HTTP server, and the exit
codes, stdout and stderr must be equal with uids, timestamps,
resourceVersions and the servers' addresses masked (uids and stamps
are patched alike as well). After every mutating command the two
stores must hold the same objects. Covered: the command set (the
port's parser has JAX's subcommands and flags), every resource
command, `-o json|yaml|name`, the server's error path, each record
command's miss contract, `get --watch`, `proxy` and `port-forward`,
the kubeconfig commands and files read across packages, the rolling
updater, scaler and reaper on each package's per-pod scheduler,
controller-manager and fake-runtime kubelets, the examples through the
port's `local-up-cluster`, and a `ktctl` process that loads neither
torch, numpy nor JAX. The departures the port's docstrings state
(`(gpu)`, PyYAML only where YAML is read or written) are held too.
"""

import contextlib
import copy
import faulthandler
import io
import itertools
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
import yaml

from kubernetes_tpu.cli import ktctl as jax_ktctl
from kubernetes_tpu.cli import updater as jax_updater
from kubernetes_tpu.client import kubeconfig as jax_kubeconfig
from kubernetes_tpu.client import rest as jax_rest
from kubernetes_tpu.controllers import ControllerManager as JaxControllerManager
from kubernetes_tpu.kubelet import FakeRuntime as JaxFakeRuntime
from kubernetes_tpu.kubelet import Kubelet as JaxKubelet
from kubernetes_tpu.models import objects as jax_objects
from kubernetes_tpu.ops import ledger as jax_ledger
from kubernetes_tpu.scheduler import daemon as jax_daemon
from kubernetes_tpu.server import api as jax_api
from kubernetes_tpu.server import httpserver as jax_http
from kubernetes_tpu.server.registry import unique_resources
from kubernetes_tpu.utils import alerts as jax_alerts
from kubernetes_tpu.utils import capacity as jax_capacity
from kubernetes_tpu.utils import flightrecorder as jax_flightrecorder
from kubernetes_tpu.utils import metrics as jax_metrics
from kubernetes_tpu.utils import rebalance as jax_rebalance
from kubernetes_tpu.utils import timeseries as jax_timeseries
from kubernetes_tpu.utils import tracing as jax_tracing

from kubernetes_tpu_torch.cli import ktctl as port_ktctl
from kubernetes_tpu_torch.cli import updater as port_updater
from kubernetes_tpu_torch.client import kubeconfig as port_kubeconfig
from kubernetes_tpu_torch.client import rest as port_rest
from kubernetes_tpu_torch.controllers import ControllerManager as PortControllerManager
from kubernetes_tpu_torch.kubelet import FakeRuntime as PortFakeRuntime
from kubernetes_tpu_torch.kubelet import Kubelet as PortKubelet
from kubernetes_tpu_torch.models import apiobjects as port_apiobjects
from kubernetes_tpu_torch.models import objects as port_objects
from kubernetes_tpu_torch.ops import ledger as port_ledger
from kubernetes_tpu_torch.scheduler import daemon as port_daemon
from kubernetes_tpu_torch.server import api as port_api
from kubernetes_tpu_torch.server import httpserver as port_http
from kubernetes_tpu_torch.utils import alerts as port_alerts
from kubernetes_tpu_torch.utils import capacity as port_capacity
from kubernetes_tpu_torch.utils import flightrecorder as port_flightrecorder
from kubernetes_tpu_torch.utils import metrics as port_metrics
from kubernetes_tpu_torch.utils import rebalance as port_rebalance
from kubernetes_tpu_torch.utils import timeseries as port_timeseries
from kubernetes_tpu_torch.utils import tracing as port_tracing

from tests.test_torch_apiserver import jax_request_latency_kept  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
STAMP = "2026-01-01T00:00:00Z"

JAX = types.SimpleNamespace(
    name="jax", ktctl=jax_ktctl, updater=jax_updater, kubeconfig=jax_kubeconfig, rest=jax_rest,
    api=jax_api, http=jax_http, objects=jax_objects, daemon=jax_daemon,
    RC=jax_objects.ReplicationController, ControllerManager=JaxControllerManager,
    Kubelet=JaxKubelet, FakeRuntime=JaxFakeRuntime,
    records={jax_tracing: ("DEFAULT_BUFFER", jax_tracing.TraceBuffer),
             jax_flightrecorder: ("DEFAULT", jax_flightrecorder.FlightRecorder),
             jax_capacity: ("DEFAULT", jax_capacity.CapacityMonitor),
             jax_rebalance: ("DEFAULT", jax_rebalance.RebalanceMonitor),
             jax_alerts: ("DEFAULT", jax_alerts.AlertEngine),
             jax_metrics: ("DEFAULT", jax_metrics.Registry),
             jax_timeseries: ("DEFAULT", jax_timeseries.Retention),
             jax_ledger: ("DEFAULT", jax_ledger.CompileLedger)})
PORT = types.SimpleNamespace(
    name="port", ktctl=port_ktctl, updater=port_updater, kubeconfig=port_kubeconfig,
    rest=port_rest, api=port_api, http=port_http, objects=port_objects, daemon=port_daemon,
    RC=port_apiobjects.ReplicationController, ControllerManager=PortControllerManager,
    Kubelet=PortKubelet, FakeRuntime=PortFakeRuntime,
    records={port_tracing: ("DEFAULT_BUFFER", port_tracing.TraceBuffer),
             port_flightrecorder: ("DEFAULT", port_flightrecorder.FlightRecorder),
             port_capacity: ("DEFAULT", port_capacity.CapacityMonitor),
             port_rebalance: ("DEFAULT", port_rebalance.RebalanceMonitor),
             port_alerts: ("DEFAULT", port_alerts.AlertEngine),
             port_metrics: ("DEFAULT", port_metrics.Registry),
             port_timeseries: ("DEFAULT", port_timeseries.Retention),
             port_ledger: ("DEFAULT", port_ledger.KernelLedger)})
BOTH = (JAX, PORT)

#: The store's resources compared after a mutating command (component
#: statuses are probed live and hold nothing).
STORED = [i.name for i in unique_resources() if i.name != "componentstatuses"]

_MASKS = (
    (re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}"), "<uid>"),
    (re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d(\.\d+)?Z"), "<stamp>"),
    (re.compile(r"(\"resourceVersion\": \")\d+\""), r'\1<rv>"'),
    (re.compile(r"(resourceVersion: )'\d+'"), r"\1<rv>"),
)


def mask(text, *addresses):
    for pattern, repl in _MASKS:
        text = pattern.sub(repl, text)
    for addr in addresses:
        text = text.replace(addr, "<server>")
    return text


@pytest.fixture(autouse=True)
def same_uids_stamps_and_cold_records(monkeypatch):
    """One uid counter a package and the same fixed stamp in both; each
    package's process-wide records (traces, decisions, capacity,
    rebalance, alerts, metrics, retention, the kernel ledger) fresh, as
    in a process that has served nothing yet."""
    for pkg in BOTH:
        counter = itertools.count(1)

        def uid(c=counter):
            return f"00000000-0000-4000-8000-{next(c):012d}"

        for mod in (pkg.api, pkg.objects):
            monkeypatch.setattr(mod, "new_uid", uid)
            monkeypatch.setattr(mod, "now_iso", lambda: STAMP)
        for mod, (attr, cls) in pkg.records.items():
            monkeypatch.setattr(mod, attr, cls())


@pytest.fixture(autouse=True)
def no_personal_kubeconfig(monkeypatch, tmp_path):
    """No kubeconfig of the machine is read: the default paths point
    into the test's directory and the variables are unset."""
    for var in ("KTCONFIG", "KUBECONFIG"):
        monkeypatch.delenv(var, raising=False)
    for pkg in BOTH:
        monkeypatch.setattr(pkg.kubeconfig, "DEFAULT_PATHS", (str(tmp_path / "no-config"),))


def run(pkg, argv, client=None, addresses=()):
    """(exit code, stdout, stderr) of one ktctl call, masked; a
    SystemExit is ("exit", its code)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = pkg.ktctl.main(list(argv), client=client)
        except SystemExit as e:
            rc = ("exit", e.code)
    return rc, mask(out.getvalue(), *addresses), mask(err.getvalue(), *addresses)


# ---------------------------------------------------------------------------
# Objects and twins
# ---------------------------------------------------------------------------


def seeded_objects(seed):
    """[(resource, namespace, wire)] for a small cluster from `seed`:
    nodes (some not Ready, one cordoned), pods (some bound, labelled by
    tier), an RC, services, a pod group, a priority class, a namespace
    and events about the first pod."""
    rng = np.random.default_rng(seed)
    out = []
    n_nodes, n_pods = 3, 6
    tiers = ["web", "db", "cache"]
    for i in range(n_nodes):
        ready = "True" if rng.random() < 0.75 else "False"
        out.append(("nodes", "", {
            "kind": "Node", "metadata": {"name": f"n-{i}", "labels": {"zone": f"z{i % 2}"}},
            "spec": {"unschedulable": bool(i == n_nodes - 1)},
            "status": {"capacity": {"cpu": str(int(rng.choice([2, 4, 8]))),
                                    "memory": f"{int(rng.choice([4, 8, 16]))}Gi",
                                    "pods": "110"},
                       "conditions": [{"type": "Ready", "status": ready}]}}))
    for i in range(n_pods):
        tier = tiers[int(rng.integers(0, len(tiers)))]
        spec = {"containers": [{"name": "c", "image": f"img-{tier}:{int(rng.integers(1, 4))}",
                                "resources": {"limits": {
                                    "cpu": f"{int(rng.integers(1, 5)) * 100}m",
                                    "memory": f"{int(rng.integers(1, 5)) * 64}Mi"}}}]}
        if rng.random() < 0.5:
            spec["nodeName"] = f"n-{int(rng.integers(0, n_nodes))}"
        out.append(("pods", "default", {"kind": "Pod", "metadata": {
            "name": f"p-{i}", "labels": {"tier": tier, "idx": str(i)}}, "spec": spec}))
    out.append(("replicationcontrollers", "default", {
        "kind": "ReplicationController", "metadata": {"name": "front"},
        "spec": {"replicas": int(rng.integers(1, 4)), "selector": {"tier": "web"},
                 "template": {"metadata": {"labels": {"tier": "web"}},
                              "spec": {"containers": [{"name": "c", "image": "img-web:1"}]}}}}))
    for i, tier in enumerate(tiers[:2]):
        labels = {"kubernetes.io/cluster-service": "true"} if i == 0 else {}
        out.append(("services", "default", {
            "kind": "Service", "metadata": {"name": f"svc-{tier}", "labels": labels},
            "spec": {"selector": {"tier": tier},
                     "ports": [{"port": int(rng.integers(80, 9000))}]}}))
    out.append(("podgroups", "default", {"kind": "PodGroup", "metadata": {"name": "gang"},
                                         "spec": {"minMember": 2}}))
    out.append(("priorityclasses", "", {"kind": "PriorityClass",
                                        "metadata": {"name": "high"}, "value": 1000}))
    out.append(("namespaces", "", {"kind": "Namespace", "metadata": {"name": "team-a"}}))
    for i, reason in enumerate(("Scheduled", "Pulled")):
        out.append(("events", "default", {
            "kind": "Event", "metadata": {"name": f"p-0.{i}"},
            "involvedObject": {"kind": "Pod", "name": "p-0", "namespace": "default"},
            "reason": reason, "message": f"{reason} p-0", "source": {"component": "test"},
            "firstTimestamp": STAMP, "lastTimestamp": STAMP}))
    return out


class Twins:
    """An apiserver a package seeded alike, each reached through its own
    package's transport ("local" or "http")."""

    def __init__(self, transport, seed=0):
        self.transport = transport
        self.api, self.client, self.servers, self.addresses = {}, {}, {}, []
        for pkg in BOTH:
            api = pkg.api.APIServer()
            for resource, ns, wire in seeded_objects(seed):
                api.create(resource, ns, copy.deepcopy(wire))
            self.api[pkg.name] = api
            if transport == "http":
                srv = pkg.http.APIHTTPServer(api).start()
                self.servers[pkg.name] = srv
                self.addresses.append(srv.address)
                self.client[pkg.name] = pkg.rest.Client(pkg.rest.HTTPTransport(srv.address))
            else:
                self.client[pkg.name] = pkg.rest.Client(pkg.rest.LocalTransport(api))

    def server_flags(self, pkg):
        """`--server URL` of this package's HTTP server (none in-process)."""
        srv = self.servers.get(pkg.name)
        return ["--server", srv.address] if srv else []

    def run(self, pkg, argv, with_server=False):
        argv = list(argv) + (self.server_flags(pkg) if with_server else [])
        return run(pkg, argv, self.client[pkg.name], self.addresses)

    def both(self, argv, with_server=False):
        """Run argv on both; returns (jax's result, port's result)."""
        return self.run(JAX, argv, with_server), self.run(PORT, argv, with_server)

    def stores(self):
        out = {}
        for pkg in BOTH:
            api = self.api[pkg.name]
            out[pkg.name] = {r: sorted(mask(json.dumps(o, sort_keys=True))
                                       for o in api.list(r, "")["items"]) for r in STORED}
        return out

    def close(self):
        for srv in self.servers.values():
            srv.stop()


@pytest.fixture(params=["local", "http"])
def twins(request):
    t = Twins(request.param)
    yield t
    t.close()


def assert_same(twins, script, tmp_path=None, with_server=False):
    """Every argv of `script` gives the same result on both; after each,
    the stores are equal. Returns the port's results."""
    results = []
    for argv in script:
        j, p = twins.both(argv, with_server)
        assert p == j, (argv, j, p)
        stores = twins.stores()
        assert stores["port"] == stores["jax"], argv
        results.append(p)
    return results


# ---------------------------------------------------------------------------
# The command set
# ---------------------------------------------------------------------------


def _subparsers(parser):
    return next(a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction").choices


def _flags(parser):
    return sorted((a.dest, tuple(a.option_strings), a.default, a.type, tuple(a.choices or ()),
                   a.required, str(a.nargs)) for a in parser._actions if a.dest != "help")


def _commands(build):
    out = {}
    for name, sub in _subparsers(build()).items():
        out[name] = sub
        if name == "config":
            for cname, csub in _subparsers(sub).items():
                out[f"config {cname}"] = csub
    return out


@pytest.mark.parametrize("command", sorted(_commands(jax_ktctl.build_parser)))
def test_parser_has_jax_commands_and_flags(command):
    port = _commands(port_ktctl.build_parser)
    assert sorted(port) == sorted(_commands(jax_ktctl.build_parser))
    jax = _commands(jax_ktctl.build_parser)[command]
    assert _flags(port[command]) == _flags(jax)
    defaults = {k: v for k, v in vars(jax.parse_args([])).items() if k != "fn"} if (
        not any(a.required for a in jax._actions)) else {}
    if defaults:
        assert {k: v for k, v in vars(port[command].parse_args([])).items()
                if k != "fn"} == defaults


# ---------------------------------------------------------------------------
# Resource commands, both transports
# ---------------------------------------------------------------------------


READS = [
    ["get", "pods"], ["get", "pods", "-o", "json"], ["get", "pods", "-o", "yaml"],
    ["get", "pods", "-o", "name"], ["get", "po", "p-0"], ["get", "pods", "p-1", "-o", "yaml"],
    ["get", "pods", "-l", "tier=web"], ["get", "pods", "-A"], ["get", "nodes"],
    ["get", "no", "-o", "json"], ["get", "rc"], ["get", "rc", "front", "-o", "json"],
    ["get", "svc"], ["get", "ep"], ["get", "events"], ["get", "ns"], ["get", "pg"], ["get", "pc"],
    ["get", "secrets"], ["get", "pods", "-n", "team-a"],
    ["describe", "pod", "p-0"], ["describe", "rc", "front"], ["describe", "node", "n-1"],
    ["api-resources"], ["api-versions"], ["cluster-info"],
]

ERRORS = [
    ["get", "pods", "missing"], ["get", "frobs"], ["describe", "svc", "missing"],
    ["delete", "pods", "missing"], ["scale", "rc", "missing", "--replicas", "2"],
    ["logs", "p-0"], ["logs", "missing"], ["exec", "p-0", "--", "ls"],
    ["label", "pod", "missing", "a=b"], ["expose", "svc", "svc-web", "--port", "80"],
    ["scale", "svc", "svc-web", "--replicas", "2"], ["delete", "pods"],
    ["delete", "pods", "p-0", "-l", "tier=web"], ["update", "rc", "front"],
    ["update", "rc", "front", "--patch", "{not json"], ["rolling-update", "front"],
]


@pytest.mark.parametrize("script", [READS, ERRORS], ids=["reads", "errors"])
def test_reads_and_errors_match_jax(twins, script):
    results = assert_same(twins, script)
    if script is ERRORS:
        rc, _, err = results[0]
        assert rc == 1 and err.startswith("Error from server (NotFound): ")


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


RC_YAML = """
kind: ReplicationController
metadata:
  name: web
spec:
  replicas: 2
  selector: {app: web}
  template:
    metadata:
      labels: {app: web}
    spec:
      containers:
      - name: main
        image: nginx
        resources:
          limits: {cpu: 100m, memory: 64Mi}
"""


def test_writes_match_jax(twins, tmp_path):
    """create (JSON, YAML, a directory, a List, a duplicate), apply,
    update (-f and --patch), label, scale, run, expose, delete (name,
    selector, file), stop: outputs and stores equal after each."""
    rc_json = _write(tmp_path, "web-rc.json", open(os.path.join(EXAMPLES, "web-rc.json")).read())
    rc_yaml = _write(tmp_path, "rc.yaml", RC_YAML.replace("name: web", "name: yweb"))
    d = tmp_path / "dir"
    d.mkdir()
    for i in range(2):
        (d / f"pod{i}.json").write_text(json.dumps({
            "kind": "Pod", "metadata": {"name": f"dirpod{i}", "labels": {"app": "dir"}},
            "spec": {"containers": [{"name": "c", "image": "x"}]}}))
    (d / "notes.txt").write_text("ignored")
    empty = tmp_path / "empty"
    empty.mkdir()
    listing = _write(tmp_path, "list.json", json.dumps({"kind": "List", "items": [
        {"kind": "Service", "metadata": {"name": "listed"},
         "spec": {"selector": {"app": "dir"}, "ports": [{"port": 81}]}},
        {"kind": "Secret", "metadata": {"name": "listed"}, "data": {"k": "dg=="}}]}))
    changed = json.load(open(rc_json))
    changed["spec"]["replicas"] = 5
    rc_changed = _write(tmp_path, "web-rc-5.json", json.dumps(changed))
    script = [
        ["create", "-f", rc_json], ["create", "-f", rc_json], ["create", "-f", rc_yaml],
        ["create", "-f", str(d)], ["create", "-f", str(empty)], ["create", "-f", listing],
        ["apply", "-f", rc_changed], ["apply", "-f", os.path.join(EXAMPLES, "web-service.json")],
        ["update", "-f", rc_json], ["update", "rc", "yweb", "--patch", '{"spec": {"replicas": 7}}'],
        ["label", "pod", "p-0", "tier=db"], ["label", "pod", "p-0", "tier=db", "--overwrite"],
        ["label", "pod", "p-0", "extra=1", "idx-"], ["label", "pod", "p-0", "bad"],
        ["scale", "rc", "front", "--replicas", "5"], ["run", "app1", "--image", "nginx", "-r", "3"],
        ["expose", "rc", "app1", "--port", "80", "--target-port", "8080",
         "--service-name", "app1-svc"],
        ["get", "svc", "app1-svc", "-o", "json"], ["delete", "pods", "-l", "app=dir"],
        ["delete", "pods", "-l", "app=none"], ["delete", "-f", listing],
        ["delete", "rc", "yweb"], ["stop", "rc", "app1"], ["stop", "pods", "p-1"],
        ["delete", "pod", "p-2", "--grace-period", "0"], ["get", "pods"], ["get", "rc"],
    ]
    results = assert_same(twins, script)
    assert results[0][1] == "replicationcontrollers/web created\n"
    assert results[1] == (1, "", 'Error from server (Conflict): replicationcontrollers "web" '
                                 'already exists\n')
    assert results[4][0] == ("exit", f"error: no manifests in directory {str(empty)!r}")


def test_server_commands_match_jax(twins):
    """version, api-versions, cluster-info and top over each transport;
    with `--server` over HTTP the server's own answers (JAX's /version
    says tpu where the port's says gpu)."""
    with_server = twins.transport == "http"
    for argv in (["api-versions"], ["cluster-info"], ["top", "nodes"], ["top", "pods"]):
        j, p = twins.both(argv, with_server)
        assert p == j, (argv, j, p)
    j, p = twins.both(["version"], with_server)
    assert p[0] == j[0] == 0
    assert p[1] == j[1].replace("(tpu)", "(gpu)") and "(gpu)" in p[1]


RECORDS = [
    ["trace"], ["trace", "p-0"], ["explain", "pod", "p-0"], ["explain", "svc", "svc-web"],
    ["slo"], ["profile", "kernels"], ["profile"], ["top", "capacity"], ["top", "health"],
    ["rebalance"], ["rebalance", "plan"], ["alerts"], ["top", "cluster"],
    ["trace", "-o", "json"], ["slo", "-o", "yaml"],
]


def test_record_miss_contracts_match_jax(twins):
    """Each record command on a process (or server) that has recorded
    nothing: exit 1, nothing on stdout, JAX's message on stderr."""
    results = assert_same(twins, RECORDS)
    misses = dict(zip(map(tuple, RECORDS), results))
    for argv, message in ((("trace",), "no traces recorded"),
                          (("trace", "p-0"), 'no trace recorded for pod "p-0"'),
                          (("explain", "pod", "p-0"), 'no decision recorded for pod "p-0"'),
                          (("slo",), "no SLI samples recorded"),
                          (("profile", "kernels"), "no compiles recorded"),
                          (("top", "capacity"), "no capacity samples recorded"),
                          (("top", "health"), "no health samples recorded"),
                          (("rebalance",), "no rebalance samples recorded"),
                          (("alerts",), "no alert evaluations recorded")):
        assert misses[argv] == (1, "", message + "\n"), argv
    assert misses[("explain", "svc", "svc-web")][0] == ("exit", "error: explain supports pods only")
    assert misses[("top", "cluster")][0] == 0


#: How long a watch test waits for its stream or its events before it
#: fails with every thread's stack.
WATCH_DEADLINE_S = 60.0


def run_watch(twins, pkg, argv, names):
    """One `get -w` call of `pkg` while a thread creates `names`. The
    creates start once the command's watch stream exists (a fixed sleep
    raced the command's own start under a loaded machine: a
    `--watch-only` stream opened after the creates waits for them
    forever), and a watchdog closes the stream if the events have not
    all come within WATCH_DEADLINE_S, dumping every thread's stack and
    failing the test."""
    client = twins.client[pkg.name]
    opened, expired = threading.Event(), threading.Event()
    streams = []

    def watch(*args, **kw):
        stream = type(client).watch(client, *args, **kw)
        streams.append(stream)
        opened.set()
        return stream

    def later():
        if opened.wait(WATCH_DEADLINE_S):
            for name in names:
                client.create("pods", {"kind": "Pod", "metadata": {"name": name},
                                       "spec": {"containers": [{"name": "c", "image": "x"}]}},
                              namespace="default")

    def expire():
        expired.set()
        faulthandler.dump_traceback(file=sys.__stderr__, all_threads=True)
        for stream in streams:
            stream.close()

    client.watch = watch
    t = threading.Thread(target=later, daemon=True)
    watchdog = threading.Timer(WATCH_DEADLINE_S, expire)
    t.start()
    watchdog.start()
    try:
        got = twins.run(pkg, argv)
    finally:
        watchdog.cancel()
        del client.watch
        t.join(WATCH_DEADLINE_S)
    assert opened.is_set() and not expired.is_set(), (
        f"{pkg.name} {argv}: the watch got no stream or not all of {names} within "
        f"{WATCH_DEADLINE_S} s (stacks on stderr)")
    return got


def test_watch_streams_changes_as_jax(twins):
    """`get pods -w` lists, then prints one row an event; `--watch-only`
    skips the list."""
    outs = {}
    for pkg in BOTH:
        outs[pkg.name] = [
            run_watch(twins, pkg, argv, names)
            for argv, names in ((["get", "pods", "-w", "--watch-events", "2", "-o", "name"],
                                 ("w1", "w2")),
                                (["get", "pods", "--watch-only", "--watch-events", "1"], ("w3",)),
                                (["get", "pods", "w4", "-w", "--watch-events", "1", "-o", "json"],
                                 ("w5", "w4")))
        ]
    assert outs["port"] == outs["jax"]
    listed, watch_only, named = outs["port"]
    assert listed[1].splitlines()[-2:] == ["pods/w1", "pods/w2"] and "pods/p-0" in listed[1]
    assert "p-0" not in watch_only[1] and "w3" in watch_only[1]
    # The named list is empty; the watch prints w4 alone.
    assert named[1].startswith('{\n  "kind": "List"') and '"name": "w4"' in named[1]
    assert '"name": "w5"' not in named[1]


# ---------------------------------------------------------------------------
# PyYAML only where YAML is read or written
# ---------------------------------------------------------------------------


def _json_manifests():
    out = []
    for root, _, files in os.walk(EXAMPLES):
        out += [os.path.join(root, f) for f in sorted(files) if f.endswith(".json")]
    return sorted(out)


@pytest.mark.parametrize("path", _json_manifests(), ids=lambda p: os.path.relpath(p, EXAMPLES))
def test_json_manifests_read_as_yaml_reads_them(path):
    text = open(path).read()
    assert port_ktctl._parse_manifests(text) == list(yaml.safe_load_all(text))
    assert port_ktctl.load_manifests(path) == jax_ktctl.load_manifests(path)


def test_without_pyyaml_json_works_and_yaml_says_so(monkeypatch, tmp_path):
    client = port_rest.Client(port_rest.LocalTransport(port_api.APIServer()))
    monkeypatch.setitem(sys.modules, "yaml", None)  # `import yaml` raises ImportError
    rc, out, _ = run(PORT, ["create", "-f", os.path.join(EXAMPLES, "web-rc.json")], client)
    assert (rc, out) == (0, "replicationcontrollers/web created\n")
    assert run(PORT, ["get", "rc", "web", "-o", "json"], client)[0] == 0
    for argv in (["create", "-f", _write(tmp_path, "rc.yaml", RC_YAML)],
                 ["get", "rc", "web", "-o", "yaml"], ["describe", "rc", "web"]):
        rc, _, _ = run(PORT, argv, client)
        assert rc[0] == "exit" and "PyYAML is not installed" in rc[1], argv
    kc = _write(tmp_path, "kc.yaml", "current-context: x\n")
    with pytest.raises(port_kubeconfig.KubeconfigError, match="PyYAML"):
        port_kubeconfig.load_kubeconfig(kc)


# ---------------------------------------------------------------------------
# proxy and port-forward
# ---------------------------------------------------------------------------


def test_proxy_relays_as_jax():
    bodies = {}
    for pkg in BOTH:
        api = pkg.api.APIServer()
        for resource, ns, wire in seeded_objects(1):
            api.create(resource, ns, copy.deepcopy(wire))
        srv = pkg.http.APIHTTPServer(api).start()
        proxy = pkg.ktctl._ProxyServer(srv.address, {"X-Test": "1"}, port=0).serve_background()
        try:
            base = f"http://127.0.0.1:{proxy.port}"
            with urllib.request.urlopen(base + "/api/v1/namespaces/default/pods/p-0",
                                        timeout=10) as resp:
                got = [mask(resp.read().decode())]
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(base + "/etc/passwd", timeout=10)
            got.append(e.value.code)
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(base + "/api/v1/namespaces/default/pods/none", timeout=10)
            got.append((e.value.code, mask(e.value.read().decode())))
        finally:
            proxy.stop()
            srv.stop()
        bodies[pkg.name] = got
    assert bodies["port"] == bodies["jax"]
    assert json.loads(bodies["port"][0])["metadata"]["name"] == "p-0"
    assert bodies["port"][1:] == [404, (404, bodies["port"][2][1])]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_until(cond, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def test_port_forward_logs_and_exec_through_the_ports_apiserver(tmp_path):
    """A pod of the port's process runtime serving HTTP: `port-forward`
    tunnels a GET through the port's apiserver and kubelet (a websocket
    each hop), `logs` and `exec` answer through the same relay, and each
    output equals the JAX CLI's against the same server."""
    from kubernetes_tpu_torch.kubelet.process_runtime import ProcessRuntime

    api = port_api.APIServer()
    srv = port_http.APIHTTPServer(api).start()
    runtime = ProcessRuntime(str(tmp_path / "kubelet"), node_name="node-1")
    kubelet = PortKubelet(port_rest.Client(port_rest.LocalTransport(api)), node_name="node-1",
                          runtime=runtime, heartbeat_period=0.5, sync_period=0.2,
                          serve_http=True).start()
    backend = _free_port()
    program = ("import http.server\n"
               "class Quiet(http.server.SimpleHTTPRequestHandler):\n"
               "    def log_message(self, *args):\n"
               "        pass\n"
               "print('serving', flush=True)\n"
               f"http.server.HTTPServer(('127.0.0.1', {backend}), Quiet).serve_forever()\n")
    try:
        port_rest.Client(port_rest.LocalTransport(api)).create("pods", {
            "kind": "Pod", "metadata": {"name": "web", "namespace": "default"},
            "spec": {"nodeName": "node-1", "containers": [{
                "name": "web", "image": "httpd", "command": [sys.executable, "-c", program],
                "ports": [{"containerPort": backend}]}]}}, namespace="default")

        def serving():
            try:
                with socket.create_connection(("127.0.0.1", backend), timeout=0.2):
                    return True
            except OSError:
                return False

        assert _wait_until(serving), "the pod never served"
        direct = urllib.request.urlopen(f"http://127.0.0.1:{backend}/", timeout=10).read()
        ready, stop = threading.Event(), threading.Event()
        t = threading.Thread(target=port_ktctl.forward_port,
                             args=(srv.address, "web", 0, backend),
                             kwargs={"ready_event": ready, "stop_event": stop}, daemon=True)
        t.start()
        assert ready.wait(5)
        try:
            for _ in range(2):  # two connections through one forwarder
                body = urllib.request.urlopen(f"http://127.0.0.1:{ready.port}/",
                                              timeout=10).read()
                assert body == direct
        finally:
            stop.set()
            t.join(timeout=5)
        outs = {}
        for pkg in BOTH:
            client = pkg.rest.Client(pkg.rest.HTTPTransport(srv.address))
            outs[pkg.name] = [run(pkg, argv, client) for argv in (
                ["logs", "web"], ["logs", "web", "--tail", "1"],
                ["logs", "web", "-f", "--follow-rounds", "1"],
                ["exec", "web", "--", sys.executable, "-c", "print('in', 6 * 7)"],
                ["exec", "web", "--", sys.executable, "-c", "import sys; sys.exit(3)"])]
        assert outs["port"] == outs["jax"]
        assert outs["port"][0] == (0, "serving\n", "")
        assert outs["port"][3] == (0, "in 42\n", "") and outs["port"][4][0] == 3
    finally:
        kubelet.stop()
        for uid in list(runtime.list_pods()):
            runtime.kill_pod(uid)
        srv.stop()


# ---------------------------------------------------------------------------
# kubeconfig
# ---------------------------------------------------------------------------


def _config_script(path):
    kc = ["--kubeconfig", path]
    return [
        ["config", *kc, "set-cluster", "prod", "--server-url", "http://10.1.2.3:8080"],
        ["config", *kc, "set-cluster", "prod", "--server-url", "http://10.1.2.4:8080"],
        ["config", *kc, "set-credentials", "alice", "--token", "sekrit"],
        ["config", *kc, "set-credentials", "bob", "--username", "bob", "--password", "pw"],
        ["config", *kc, "set-context", "prod-ctx", "--cluster", "prod", "--user", "alice",
         "--ctx-namespace", "team1"],
        ["config", *kc, "set-context", "bob-ctx", "--cluster", "prod", "--user", "bob"],
        ["config", *kc, "use-context", "nope"],
        ["config", *kc, "use-context", "prod-ctx"],
        ["namespace", *kc], ["namespace", *kc, "team2"], ["namespace", *kc],
        ["config", *kc, "set", "preferences", "x"], ["config", *kc, "unset", "preferences"],
        ["config", *kc, "set", "a.b", "x"], ["config", *kc, "view"],
    ]


def test_config_commands_write_the_same_file_as_jax(tmp_path):
    files = {}
    outs = {}
    for pkg in BOTH:
        path = str(tmp_path / f"{pkg.name}.config")
        outs[pkg.name] = [run(pkg, argv) for argv in _config_script(path)]
        files[pkg.name] = open(path).read()
    outs["port"] = [(rc, o.replace("port.config", "jax.config"), e) for rc, o, e in outs["port"]]
    assert outs["port"] == outs["jax"]
    assert files["port"] == files["jax"]
    assert outs["port"][6] == (1, "", 'error: no context exists with the name: "nope"\n')
    assert outs["port"][10][1] == "team2\n"


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)], ids=["jax-to-port",
                                                                          "port-to-jax"])
def test_kubeconfig_files_load_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "config")
    for argv in _config_script(path):
        run(writer, argv)
    for context in (None, "prod-ctx", "bob-ctx"):
        got = reader.kubeconfig.load_kubeconfig(path, context=context)
        want = writer.kubeconfig.load_kubeconfig(path, context=context)
        assert vars(got) == vars(want)
        assert got.auth_headers() == want.auth_headers()
    assert reader.kubeconfig.load_kubeconfig(path).token == "sekrit"
    assert reader.kubeconfig.load_kubeconfig(path, "bob-ctx").auth_headers()[
        "Authorization"].startswith("Basic ")


def test_kubeconfig_errors_match_jax(tmp_path, monkeypatch):
    """An unknown context and an explicit missing path are errors (exit
    1, the same message); a missing default gives the local defaults;
    $KTCONFIG is read."""
    path = str(tmp_path / "config")
    for argv in _config_script(path):
        run(JAX, argv)
    for pkg in BOTH:
        with pytest.raises(pkg.kubeconfig.KubeconfigError, match="not found"):
            pkg.kubeconfig.load_kubeconfig(str(tmp_path / "absent"))
        with pytest.raises(pkg.kubeconfig.KubeconfigError, match="context 'gone' not found"):
            pkg.kubeconfig.load_kubeconfig(path, context="gone")
        assert vars(pkg.kubeconfig.load_kubeconfig()) == vars(pkg.kubeconfig.ClientConfig())
    for argv in (["get", "pods", "--kubeconfig", str(tmp_path / "absent")],
                 ["get", "pods", "--kubeconfig", path, "--context", "gone"]):
        assert run(PORT, argv) == run(JAX, argv)
        assert run(PORT, argv)[0] == 1
    monkeypatch.setenv("KTCONFIG", path)
    for pkg in BOTH:
        assert pkg.kubeconfig.load_kubeconfig().server == "http://10.1.2.4:8080"
        assert pkg.kubeconfig.config_path() == path


def test_kubeconfig_server_and_credentials_reach_the_server(tmp_path):
    """With no `--server`, the CLI finds the server and a bearer token in
    the kubeconfig and sends the token on requests and watches."""
    seen = []
    for pkg in BOTH:
        api = pkg.api.APIServer()
        srv = pkg.http.APIHTTPServer(api).start()
        try:
            path = str(tmp_path / f"{pkg.name}.config")
            for argv in (["config", "--kubeconfig", path, "set-cluster", "c", "--server-url",
                          srv.address],
                         ["config", "--kubeconfig", path, "set-credentials", "u", "--token", "t0k"],
                         ["config", "--kubeconfig", path, "set-context", "x", "--cluster", "c",
                          "--user", "u", "--ctx-namespace", "team-a"],
                         ["config", "--kubeconfig", path, "use-context", "x"]):
                assert run(pkg, argv)[0] == 0
            manifest = _write(tmp_path, "svc.json", json.dumps({
                "kind": "Service", "metadata": {"name": "web"},
                "spec": {"selector": {"app": "web"}, "ports": [{"port": 80}]}}))
            rc, out, err = run(pkg, ["create", "--kubeconfig", path, "-f", manifest])
            assert (rc, err) == (0, ""), err
            assert api.get("services", "team-a", "web")["metadata"]["namespace"] == "team-a"
            seen.append((rc, out))
        finally:
            srv.stop()
    assert seen[0] == seen[1]
    headers = []

    class Recorder(port_rest.HTTPTransport):
        def _attempt(self, verb, path, payload, hdrs, raw=False):
            headers.append(dict(hdrs))
            return super()._attempt(verb, path, payload, hdrs, raw)

    srv = port_http.APIHTTPServer(port_api.APIServer()).start()
    try:
        t = Recorder(srv.address, headers={"Authorization": "Bearer t0k"})
        t.request("GET", "list", ("pods", "default", "", ""))
        stream = port_rest.Client(t).watch("pods", namespace="default")
        stream.close()
        assert headers and all(h.get("Authorization") == "Bearer t0k" for h in headers)
        assert t.get_json("/debug/kernels")["kernels"] == []
        assert json.loads(t.get_text("/healthz"))["status"] == "ok"
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# The rolling updater, the scaler and the reaper on live clusters
# ---------------------------------------------------------------------------


def rc_wire(name, replicas, labels, image="app:v1"):
    return {"kind": "ReplicationController", "metadata": {"name": name, "namespace": "default"},
            "spec": {"replicas": replicas, "selector": dict(labels),
                     "template": {"metadata": {"labels": dict(labels)},
                                  "spec": {"containers": [{
                                      "name": "main", "image": image,
                                      "resources": {"limits": {"cpu": "100m",
                                                               "memory": "64Mi"}}}]}}}}


@contextlib.contextmanager
def live_cluster(pkg):
    """JAX's `tests/test_kubectl_tier.py` fixture in `pkg`: an
    apiserver, two fake-runtime kubelets, the per-pod scheduler and the
    controller-manager, each on its own LocalTransport client."""
    api = pkg.api.APIServer()

    def new_client():
        return pkg.rest.Client(pkg.rest.LocalTransport(api))

    kubelets = [pkg.Kubelet(new_client(), node_name=name, runtime=pkg.FakeRuntime(),
                            heartbeat_period=0.5, sync_period=0.2).start()
                for name in ("node-1", "node-2")]
    cfg = pkg.daemon.SchedulerConfig(new_client()).start()
    assert cfg.wait_for_sync()
    scheduler = pkg.daemon.Scheduler(cfg).start()
    manager = pkg.ControllerManager(new_client()).start()
    try:
        yield api, new_client()
    finally:
        manager.stop()
        scheduler.stop()
        for k in kubelets:
            k.stop()


def _pods(api, selector=""):
    items = api.list("pods", "default", selector)["items"]
    return sorted(((p["metadata"]["name"], p["status"].get("phase"),
                    p["metadata"].get("labels", {}).get("deployment"),
                    p["spec"]["containers"][0]["image"]) for p in items), key=str)


def _running(api, selector):
    return [p for p in _pods(api, selector) if p[1] == "Running"]


def _rollout(pkg, api, client):
    """JAX's tier scenarios, one after another, summarised."""
    up = pkg.updater
    out = {}
    client.create("replicationcontrollers", rc_wire("web", 3, {"app": "web"}))
    assert _wait_until(lambda: len(_running(api, "app=web")) == 3)
    new_rc = pkg.ktctl.serde.from_wire(
        pkg.RC, rc_wire("web-v2", 3, {"app": "web", "deployment": "v2"}, image="app:v2"))
    said = []
    survivor = up.RollingUpdater(client, poll_interval=0.05, timeout=30.0,
                                 progress=said.append).update("web", new_rc, namespace="default")
    rc = api.get("replicationcontrollers", "default", "web")
    out["rolling"] = (survivor, said, rc["spec"]["replicas"],
                      rc["spec"]["template"]["spec"]["containers"][0]["image"],
                      rc["spec"]["selector"])
    assert _wait_until(lambda: len(_running(api, "deployment=v2")) == 3)
    assert _wait_until(lambda: not [p for p in _running(api, "app=web") if p[2] is None])
    out["new_pods"] = sorted((p[1], p[2], p[3]) for p in _running(api, "deployment=v2"))
    with pytest.raises(ValueError) as e:
        up.RollingUpdater(client).update("web", pkg.ktctl.serde.from_wire(
            pkg.RC, rc_wire("web-v3", 1, rc["spec"]["selector"])), namespace="default")
    out["same_selector"] = str(e.value)
    client.create("replicationcontrollers", rc_wire("sized", 1, {"app": "sized"}))
    assert _wait_until(lambda: len(_running(api, "app=sized")) == 1)
    up.Scaler(client).scale("sized", 3, namespace="default", wait=True, timeout=20.0)
    out["scaled"] = api.get("replicationcontrollers", "default", "sized")["spec"]["replicas"]
    assert _wait_until(lambda: len(_running(api, "app=sized")) == 3)
    up.Reaper(client, timeout=20.0).stop("replicationcontrollers", "sized", namespace="default")
    out["reaped"] = [r["metadata"]["name"]
                     for r in api.list("replicationcontrollers", "default")["items"]]
    assert _wait_until(lambda: not _running(api, "app=sized"), timeout=5)
    return out


def test_updater_scaler_and_reaper_match_jax_on_live_clusters():
    """JAX's tier scenarios on each package's cluster: the same progress,
    RCs and new pods. The port's updater waits for the old RC's pods to
    drain (its docstring's departure), so no pod of the old RC is left;
    JAX's may leave some, owned by no RC, so the old pods are not
    compared."""
    got, left = {}, {}
    for pkg in BOTH:
        with live_cluster(pkg) as (api, client):
            got[pkg.name] = _rollout(pkg, api, client)
            left[pkg.name] = _pods(api, "app=web")
    assert got["port"] == got["jax"]
    assert got["port"]["rolling"][:4] == ("web", [
        "Scaling web-v2 up to 1", "Scaling web down to 2", "Scaling web-v2 up to 2",
        "Scaling web down to 1", "Scaling web-v2 up to 3", "Scaling web down to 0"], 3, "app:v2")
    assert got["port"]["new_pods"] == [("Running", "v2", "app:v2")] * 3
    assert [p[1:] for p in left["port"]] == [("Running", "v2", "app:v2")] * 3
    assert got["port"]["scaled"] == 3 and got["port"]["reaped"] == ["web"]


def test_ktctl_rolling_update_and_stop_match_jax_on_live_clusters():
    """`rolling-update --image` derives the new RC with a deployment key,
    prints JAX's progress lines and renames it back; `scale` and `stop`
    follow; the RCs left are equal."""
    got = {}
    for pkg in BOTH:
        with live_cluster(pkg) as (api, client):
            client.create("replicationcontrollers", rc_wire("web", 2, {"app": "web"}))
            assert _wait_until(lambda: len(_running(api, "app=web")) == 2)
            results = [run(pkg, ["rolling-update", "web", "--image", "app:v9",
                                 "--poll-interval", "0.05"], client)]
            selector = ",".join(f"{k}={v}" for k, v in sorted(api.get(
                "replicationcontrollers", "default", "web")["spec"]["selector"].items()))
            results.append(selector)
            assert _wait_until(lambda: [p[3] for p in _running(api, selector)] == ["app:v9"] * 2)
            results.append(run(pkg, ["scale", "rc", "web", "--replicas", "3"], client))
            assert _wait_until(lambda: len(_running(api, selector)) == 3)
            results.append(run(pkg, ["stop", "rc", "web", "--timeout", "20"], client))
            assert _wait_until(lambda: not _running(api, selector), timeout=5)
            results.append(sorted(r["metadata"]["name"]
                                  for r in api.list("replicationcontrollers", "default")["items"]))
            if pkg is PORT:  # no pod of the old RC was left behind
                assert _wait_until(lambda: not _pods(api, "app=web"), timeout=5)
            got[pkg.name] = results
    assert got["port"] == got["jax"]
    assert got["port"][0][1].splitlines()[-1] == "replicationcontroller/web rolling updated"
    assert got["port"][3] == (0, "replicationcontrollers/web stopped\n", "")


def test_scaler_retries_a_conflict_from_the_ports_transports():
    """A concurrent writer changes the RC between the scaler's read and
    its write: the apiserver answers 409, which reaches the scaler as the
    client's APIError over both transports and is retried."""
    for transport in ("local", "http"):
        api = port_api.APIServer()
        srv = port_http.APIHTTPServer(api).start() if transport == "http" else None
        try:
            def new_client():
                t = (port_rest.HTTPTransport(srv.address) if srv
                     else port_rest.LocalTransport(api))
                return port_rest.Client(t)

            client, other = new_client(), new_client()
            client.create("replicationcontrollers", rc_wire("c", 1, {"app": "c"}))
            bumped = []

            class Racing:
                def __getattr__(self, name):
                    return getattr(client, name)

                def get_wire(self, resource, name, namespace=""):
                    wire = client.get_wire(resource, name, namespace=namespace)
                    if not bumped:
                        rival = copy.deepcopy(wire)
                        rival["metadata"].setdefault("labels", {})["touched"] = "1"
                        other.update(resource, rival, namespace=namespace)
                        bumped.append(1)
                    return wire

            port_updater.Scaler(Racing(), interval=0.01).scale("c", 4, namespace="default")
            rc = api.get("replicationcontrollers", "default", "c")
            assert bumped and rc["spec"]["replicas"] == 4
            assert rc["metadata"]["labels"] == {"touched": "1"}
        finally:
            if srv:
                srv.stop()


# ---------------------------------------------------------------------------
# The examples on the port's local-up-cluster, and the CLI's process
# ---------------------------------------------------------------------------


def test_examples_deploy_on_the_ports_local_up_cluster_and_top_reports(capsys):
    """JAX's `tests/test_cmd.py` examples test on the port's cluster: the
    example RC and service through the port's CLI, their pods Running,
    then `top nodes` and `top pods` from the kubelets' stats."""
    from kubernetes_tpu_torch.cmd import localup

    args = localup.build_parser().parse_args(["--port", "0", "--nodes", "2", "--device", "cpu",
                                              "--no-kube-proxy"])
    cluster = localup.LocalCluster(args).start()
    try:
        server = cluster.http.address
        for manifest in ("web-rc.json", "web-service.json"):
            assert port_ktctl.main(["create", "-f", os.path.join(EXAMPLES, manifest),
                                    "--server", server]) == 0
        assert _wait_until(lambda: sum(
            p["status"].get("phase") == "Running"
            for p in cluster.api.list("pods", "default", "app=web")["items"]) == 3)
        capsys.readouterr()
        assert port_ktctl.main(["top", "nodes", "--server", server]) == 0
        out = capsys.readouterr().out
        assert out.startswith("NAME") and "node-0" in out and "node-1" in out
        rows = [line.split() for line in out.splitlines()[1:]]
        assert sum(int(r[1]) for r in rows) == 3  # the PODS column
        assert port_ktctl.main(["top", "pods", "--server", server]) == 0
        out = capsys.readouterr().out
        rows = [line.split() for line in out.splitlines()[1:]]
        assert out.startswith("POD-UID") and len(rows) == 3  # a container a pod
        assert {r[1] for r in rows} == {"web"}
    finally:
        cluster.stop()


_FOOTPRINT = """
import json, runpy, sys
sys.argv = ["ktctl"] + sys.argv[1:]
try:
    runpy.run_module(sys.argv.pop(1), run_name="__main__")
except SystemExit as e:
    rc = e.code
heavy = sorted(m for m in sys.modules
               if m.split(".")[0] in ("torch", "numpy", "jax", "jaxlib", "kubernetes_tpu"))
print(json.dumps({"rc": rc, "heavy": heavy}), file=sys.stderr)
"""


def test_a_ktctl_process_loads_no_torch_numpy_or_jax():
    """`python -m kubernetes_tpu_torch.cli` and `hyperkube ktctl` as
    processes: `create -f` and `get pods` against the port's apiserver
    load neither torch, numpy nor anything of JAX."""
    srv = port_http.APIHTTPServer(port_api.APIServer()).start()
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    try:
        seen = []
        for module, argv in (
                ("kubernetes_tpu_torch.cli", ["create", "-f",
                                              os.path.join(EXAMPLES, "web-rc.json")]),
                ("kubernetes_tpu_torch.cli", ["get", "pods", "-o", "json"]),
                ("kubernetes_tpu_torch.cmd.hyperkube", ["ktctl", "get", "rc"])):
            proc = subprocess.run([sys.executable, "-c", _FOOTPRINT, module, *argv,
                                   "--server", srv.address],
                                  cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
            report = json.loads(proc.stderr.strip().splitlines()[-1])
            assert report == {"rc": 0, "heavy": []}, (argv, proc.stderr)
            seen.append(proc.stdout)
        assert seen[0] == "replicationcontrollers/web created\n"
        assert json.loads(seen[1])["kind"] == "List"
        assert seen[2].split()[:6] == ["NAME", "DESIRED", "CURRENT", "SELECTOR", "AGE", "web"]
    finally:
        srv.stop()
