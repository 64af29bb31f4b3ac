"""The port's local-up-cluster and cluster-up against the JAX package's.

- `cmd/localup.build_parser` has JAX's flags and one more, `--device`.
- `LocalCluster` with JAX's default flags, beside JAX's on the same
  flags: a pod created over HTTP is scheduled and Running, the nodes
  register, the componentstatuses are healthy and after `stop()` the
  scheduler reports unhealthy, in both alike (the twin of
  `tests/test_cmd.py::TestLocalUpCluster`). The kube-proxy's `ip` runner
  (`proxy/portal._ip`) is a recorder in both packages: no test here
  installs a loopback address.
- `LocalCluster --batch-scheduler --device cpu --kubelet-http
  --cluster-dns --no-kube-proxy` (the smoke's leg at a small size): an
  RC's pods reach Running on HTTP kubelets through the incremental
  daemon's plain K1 (its ledger calls on `/debug/kernels`), the DNS addon
  resolves the RC's service on its own port, and the monitor and log
  aggregator addons of both packages read the cluster's kubelets over
  HTTP alike.
- The kube-dns service published at 10.0.0.10 answers through the
  proxy's portal (the twin of `tests/test_addons_debug.py::
  TestKubeDNSService`, with the recorder the portal falls back to its
  rule table, as it would without privileges).
- `hyperkube local-up-cluster` as a child: it prints its address and
  DNS port, serves, and SIGINT stops it with exit code 0.
- `cmd/clusterup`: `plan(inv)` equals JAX's on seeded inventories with
  the module paths mapped and the scheduler's `--device` taken out;
  the ssh provider's dry run prints the same plan; the local provider
  brings a cluster up (apiserver, leader-elected control plane pairs,
  kubelets, the DNS and monitoring addons) that runs an RC, and `down`
  stops every process; the ssh provider runs the same through the
  `SSH_BASE` shim of `tests/test_clusterup.py`, which replays ssh's
  argument joining on this host.
"""

import json
import os
import re
import signal
import socket
import struct
import subprocess
import sys
import time
import types
import urllib.request

import numpy as np
import pytest

from kubernetes_tpu.client import rest as jax_rest
from kubernetes_tpu.cmd import clusterup as jax_clusterup
from kubernetes_tpu.cmd import localup as jax_localup
from kubernetes_tpu.proxy import portal as jax_portal
from kubernetes_tpu.utils import alerts as jax_alerts
from kubernetes_tpu.utils import timeseries as jax_timeseries

from kubernetes_tpu_torch.client import rest as port_rest
from kubernetes_tpu_torch.cmd import clusterup as port_clusterup
from kubernetes_tpu_torch.cmd import localup as port_localup
from kubernetes_tpu_torch.proxy import portal as port_portal
from kubernetes_tpu_torch.utils import alerts as port_alerts
from kubernetes_tpu_torch.utils import timeseries as port_timeseries

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = types.SimpleNamespace(name="jax", rest=jax_rest, localup=jax_localup, portal=jax_portal,
                            alerts=jax_alerts, timeseries=jax_timeseries)
PORT = types.SimpleNamespace(name="port", rest=port_rest, localup=port_localup,
                             portal=port_portal, alerts=port_alerts,
                             timeseries=port_timeseries)
BOTH = (JAX, PORT)


def wait_until(cond, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


class _Recorder:
    """Stands in for `portal._ip`: records each `ip` command and answers
    as a successful `ip` would. Nothing reaches the network stack."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return subprocess.CompletedProcess(["ip", *args], 0, "", "")


@pytest.fixture(autouse=True)
def no_loopback_and_no_health_plane_left(monkeypatch):
    """The `ip` runner is a recorder in both packages; after the test
    each package's process-wide sampler is stopped and the retention
    store and alert engine emptied, so no later test in this worker
    inherits them."""
    recorders = {}
    for pkg in BOTH:
        recorders[pkg.name] = _Recorder()
        monkeypatch.setattr(pkg.portal, "_ip", recorders[pkg.name])
        monkeypatch.setattr(pkg.portal.LoopbackPortals, "_supported", None)
    yield recorders
    for pkg in BOTH:
        pkg.timeseries.SAMPLER.stop()
        pkg.timeseries.DEFAULT.reset()
        pkg.alerts.DEFAULT.configure()
        pkg.alerts.DEFAULT._post_event = None


def _flags(parser):
    return sorted((a.dest, tuple(a.option_strings), a.default, a.type, tuple(a.choices or ()))
                  for a in parser._actions if a.dest != "help")


def test_parser_has_jax_flags_and_device():
    port = _flags(port_localup.build_parser())
    jax = _flags(jax_localup.build_parser())
    assert [f for f in port if f[0] != "device"] == jax
    assert [f for f in port if f[0] == "device"] == [
        ("device", ("--device",), "cuda", None, ("cuda", "cpu"))]


POD = {"kind": "Pod", "metadata": {"name": "up1", "namespace": "default"},
       "spec": {"containers": [{"name": "c", "image": "x",
                                "resources": {"limits": {"cpu": "100m", "memory": "64Mi"}}}]}}


def test_full_cluster_schedules_pods_over_http_as_jax(no_loopback_and_no_health_plane_left):
    got = {}
    for pkg in BOTH:
        args = pkg.localup.build_parser().parse_args(["--port", "0", "--nodes", "2"])
        cluster = pkg.localup.LocalCluster(args).start()
        try:
            client = pkg.rest.Client(pkg.rest.HTTPTransport(cluster.http.address))
            client.create("pods", json.loads(json.dumps(POD)), namespace="default")

            def running():
                pod = cluster.api.get("pods", "default", "up1")
                return (pod.get("status") or {}).get("phase") == "Running" and pod["spec"].get(
                    "nodeName")

            assert wait_until(running)
            nodes = sorted(n["metadata"]["name"] for n in cluster.api.list("nodes", "")["items"])
            comps = {c["metadata"]["name"]: [x["status"] for x in c["conditions"]
                                             if x["type"] == "Healthy"]
                     for c in cluster.api.list("componentstatuses", "")["items"]}
            proxy = (cluster.proxy is not None, cluster.proxy.proxier.has_real_portals)
        finally:
            cluster.stop()
        got[pkg.name] = (nodes, comps, proxy, cluster._scheduler_health()[0],
                         no_loopback_and_no_health_plane_left[pkg.name].calls)
    assert got["port"] == got["jax"]
    assert got["port"][:4] == (["node-0", "node-1"], {"etcd-0": ["True"], "scheduler": ["True"],
                                                      "controller-manager": ["True"]},
                               (True, True), False)


def dns_query_raw(port, name, host="127.0.0.1", txid=0x1234):
    q = struct.pack(">HHHHHH", txid, 0x0100, 1, 0, 0, 0)
    q += b"".join(bytes([len(p)]) + p.encode() for p in name.strip(".").split("."))
    q += b"\x00" + struct.pack(">HH", 1, 1)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.settimeout(3.0)
    try:
        s.sendto(q, (host, port))
        return s.recvfrom(512)[0]
    finally:
        s.close()


def resolved(data):
    an = struct.unpack(">H", data[6:8])[0]
    return socket.inet_ntoa(data[-4:]) if an else None


def rc_wire(name, replicas):
    return {"kind": "ReplicationController", "metadata": {"name": name, "namespace": "default"},
            "spec": {"replicas": replicas, "selector": {"app": name},
                     "template": {"metadata": {"labels": {"app": name}},
                                  "spec": {"containers": [{"name": "c", "image": "x"}]}}}}


def test_batch_cluster_on_the_cpu_runs_an_rc_with_its_addons(capfd):
    """The smoke's `local_up` leg at a small size, on the CPU."""
    from kubernetes_tpu.addons.logging import ClusterLogAggregator as JaxLogs
    from kubernetes_tpu.addons.monitoring import ClusterMonitor as JaxMonitor

    from kubernetes_tpu_torch.addons.logging import ClusterLogAggregator as PortLogs
    from kubernetes_tpu_torch.addons.monitoring import ClusterMonitor as PortMonitor

    args = port_localup.build_parser().parse_args(
        ["--port", "0", "--nodes", "4", "--batch-scheduler", "--device", "cpu",
         "--kubelet-http", "--cluster-dns", "--no-kube-proxy", "--prewarm-buckets", "8"])
    cluster = port_localup.LocalCluster(args).start()
    addons = []
    try:
        assert re.search(rf"DNS serves on 127\.0\.0\.1:{cluster.dns.port} only",
                         capfd.readouterr().err)
        url = cluster.http.address
        client = port_rest.Client(port_rest.HTTPTransport(url))
        client.create("replicationcontrollers", rc_wire("web", 24), namespace="default")
        client.create("services", {"kind": "Service",
                                   "metadata": {"name": "web", "namespace": "default"},
                                   "spec": {"selector": {"app": "web"}, "ports": [{"port": 80}]}},
                      namespace="default")

        def running():
            pods, _ = client.list_wire("pods", "default")
            return sum(p["status"].get("phase") == "Running" for p in pods)

        assert wait_until(lambda: running() == 24, timeout=60), running()
        nodes = {p["spec"]["nodeName"] for p in client.list_wire("pods", "default")[0]}
        assert nodes <= {f"node-{i}" for i in range(4)} and len(nodes) > 1
        with urllib.request.urlopen(url + "/debug/kernels", timeout=10) as r:
            kernels = json.loads(r.read())["kernels"]
        assert any(k["kernel"] == "scan_kernel" and k["impl"] == "plain" and k["calls"] > 0
                   for k in kernels)
        ip = client.get_wire("services", "web", namespace="default")["spec"]["clusterIP"]
        assert wait_until(lambda: resolved(dns_query_raw(
            cluster.dns.port, "web.default.svc.cluster.local")) == ip)
        # The monitor and log addons of both packages, over HTTP.
        for k in cluster.kubelets:
            k.runtime.read_logs = lambda uid, container, tail=None: "booted\nserving\n"
        views = {}
        for name, rest, monitor, logs in (("jax", jax_rest, JaxMonitor, JaxLogs),
                                          ("port", port_rest, PortMonitor, PortLogs)):
            mon = monitor(rest.Client(rest.HTTPTransport(url)), url, resolution=0.2).start()
            agg = logs(rest.Client(rest.HTTPTransport(url)), poll_interval=3600).start()
            addons += [mon, agg]
            assert wait_until(lambda: len(mon._serve("/api/v1/model/nodes")[1]["items"]) == 4)
            pods = mon._serve("/api/v1/model/namespaces/default/pods")
            series = mon._serve("/api/v1/model/nodes/node-0/metrics/pods")[1]
            agg.collect_once()
            views[name] = (mon._serve("/api/v1/model/nodes"), pods[0],
                           sorted(series), sorted((e.pod, e.line) for e in agg.search("")))
        assert views["port"][:3] == views["jax"][:3]
        assert sorted(views["port"][3]) == sorted(views["jax"][3])
        assert len(views["port"][3]) == 48
    finally:
        for a in addons:
            a.stop()
        cluster.stop()


def test_kube_dns_through_the_proxy_portal_as_jax(no_loopback_and_no_health_plane_left):
    """The twin of TestKubeDNSService: the addon published as kube-dns at
    10.0.0.10 with a real-portal proxy whose `ip` commands the recorder
    takes; the VIP bind fails, the portal falls back to its rule-table
    listener, and a query through it resolves a service in both."""
    seen = {}
    for pkg in BOTH:
        from importlib import import_module

        api_mod = import_module(pkg.rest.__name__.replace("client.rest", "server.api"))
        dns_mod = import_module(pkg.rest.__name__.replace("client.rest", "addons.dns"))
        config = import_module(pkg.rest.__name__.replace("client.rest", "proxy.config"))
        api = api_mod.APIServer()
        client = pkg.rest.Client(pkg.rest.LocalTransport(api))
        dns = dns_mod.ClusterDNS(client).start()
        proxy = None
        try:
            dns.publish(client)
            dns.publish(client)  # a restart: no conflict
            svc = api.get("services", "default", "kube-dns")
            client.create("services", {"kind": "Service",
                                       "metadata": {"name": "web", "namespace": "default"},
                                       "spec": {"selector": {"app": "web"},
                                                "ports": [{"name": "http", "port": 80}],
                                                "clusterIP": "10.0.0.77"}},
                          namespace="default")
            proxy = config.ProxyServer(client, real_portals=True).start()
            portal = None
            assert wait_until(lambda: proxy.resolve_portal("10.0.0.10", 53, "UDP") is not None)
            portal = proxy.resolve_portal("10.0.0.10", 53, "UDP")
            answer = None
            deadline = time.monotonic() + 10
            while answer != "10.0.0.77" and time.monotonic() < deadline:
                try:
                    answer = resolved(dns_query_raw(portal[1], "web.default.svc.cluster.local",
                                                    host=portal[0]))
                except OSError:
                    time.sleep(0.1)
            eps = api.get("endpoints", "default", "kube-dns")["subsets"][0]["ports"][0]["port"]
            seen[pkg.name] = (svc["spec"]["clusterIP"], eps == dns.port, answer,
                              proxy.proxier.has_real_portals,
                              no_loopback_and_no_health_plane_left[pkg.name].calls)
        finally:
            if proxy is not None:
                proxy.stop()
            dns.stop()
    assert seen["port"] == seen["jax"]
    assert seen["port"][:4] == ("10.0.0.10", True, "10.0.0.77", True)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_command_serves_and_stops_on_sigint():
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubernetes_tpu_torch.cmd.hyperkube", "local-up-cluster",
         "--port", "0", "--nodes", "1", "--no-kube-proxy", "--cluster-dns"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("cluster up: apiserver at http://"), (line, proc.stderr.read())
        url = line.split(" at ")[1].strip()
        err = ""
        while not re.search(r"127\.0\.0\.1:(\d+) only", err):
            err = proc.stderr.readline()
            assert err, "no DNS line on the child's stderr"
        dns_port = int(re.search(r"127\.0\.0\.1:(\d+) only", err).group(1))
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            assert r.status == 200
        master = json.loads(urllib.request.urlopen(
            url + "/api/v1/namespaces/default/services/kubernetes", timeout=10).read())
        assert wait_until(lambda: resolved(dns_query_raw(
            dns_port, "kubernetes.default")) == master["spec"]["clusterIP"])
        with open(f"/proc/{proc.pid}/maps") as f:
            assert "libcuda" not in f.read()  # the per-pod scheduler opens no card
    finally:
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
        out = proc.stdout.read()
        proc.stdout.close()
        proc.stderr.close()
    assert rc == 0 and "cluster stopped" in out


# -- cluster-up ------------------------------------------------------------------


def seeded_inventory(seed):
    rng = np.random.default_rng(seed)
    inv = {"master": {"host": str(rng.choice(["127.0.0.1", "10.0.0.1"])),
                      "port": int(rng.integers(1024, 60000))},
           "control_plane_replicas": int(rng.integers(1, 4)),
           "batch_scheduler": bool(rng.integers(0, 2)),
           "nodes": [{"name": f"n{i}", "host": f"10.0.1.{i}"}
                     for i in range(int(rng.integers(0, 4)))],
           "runtime": str(rng.choice(["fake", "process"])),
           "addons": [a for a in ("dns", "monitoring") if rng.integers(0, 2)]}
    if rng.integers(0, 2):
        inv["master"]["data_dir"] = f"/var/lib/kt-{seed}"
    for node in inv["nodes"]:
        if rng.integers(0, 2):
            node["root_dir"] = f"/srv/{node['name']}"
    if rng.integers(0, 2):
        inv["device"] = str(rng.choice(["cuda", "cpu"]))
    return inv


def jax_to_port(argv):
    """JAX's argv with the port's module paths."""
    if argv[1] == jax_clusterup.HYPERKUBE:
        return [argv[0], "-m", "kubernetes_tpu_torch.cmd.hyperkube", *argv[2:]]
    return [a.replace("kubernetes_tpu.addons", "kubernetes_tpu_torch.addons") for a in argv]


def without_device(role, argv, device):
    if role.startswith("scheduler"):
        i = argv.index("--device")
        assert argv[i + 1] == device
        return argv[:i] + argv[i + 2:]
    assert "--device" not in argv
    return argv


@pytest.mark.parametrize("seed", range(10))
def test_plan_is_jax_plan_with_the_ports_modules(seed, tmp_path):
    inv = seeded_inventory(seed)
    path = tmp_path / "inv.json"
    path.write_text(json.dumps(inv))
    jax_inv = jax_clusterup.load_inventory(str(path))
    port_inv = port_clusterup.load_inventory(str(path))
    assert port_inv == dict(jax_inv, device=inv.get("device", "cuda"))
    jax_steps = jax_clusterup.plan(jax_inv)
    port_steps = port_clusterup.plan(port_inv)
    assert [(h, r, without_device(r, a, port_inv["device"])) for h, r, a in port_steps] == [
        (h, r, jax_to_port(a)) for h, r, a in jax_steps]
    assert not any("kubernetes_tpu." in " ".join(a) or a[1].endswith("bin/hyperkube")
                   for _h, _r, a in port_steps)


def test_ssh_dry_run_prints_the_plan(tmp_path, capsys):
    inv = seeded_inventory(3)
    path = tmp_path / "inv.json"
    path.write_text(json.dumps(inv))
    assert port_clusterup.up_main(["-i", str(path), "--provider", "ssh", "--dry-run"]) == 0
    out = capsys.readouterr().out.splitlines()
    steps = port_clusterup.plan(port_clusterup.load_inventory(str(path)))
    assert out == [f"[{h}] {r}: {' '.join(a)}" for h, r, a in steps]
    assert not (tmp_path / ".kube-cluster").exists()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _alive(pid):
    """Whether `pid` runs (a zombie, killed but not yet reaped, does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_local_provider_up_runs_an_rc_and_down_stops_all(tmp_path):
    port = _free_port()
    inv = {"master": {"host": "127.0.0.1", "port": port, "data_dir": str(tmp_path / "data")},
           "control_plane_replicas": 1, "batch_scheduler": False,
           "nodes": [{"name": "cn-0", "host": "127.0.0.1"}], "runtime": "fake",
           "device": "cpu", "addons": ["dns", "monitoring"]}
    state = str(tmp_path / "state")
    assert port_clusterup.up(inv, state) == 0
    comps = json.load(open(os.path.join(state, "cluster.json")))["components"]
    pids = [c["pid"] for c in comps.values()]
    try:
        server = f"http://127.0.0.1:{port}"
        client = port_rest.Client(port_rest.HTTPTransport(server))
        assert wait_until(lambda: len(client.list_wire("nodes")[0]) == 1, timeout=90)
        client.create("replicationcontrollers", rc_wire("w", 3), namespace="default")
        assert wait_until(lambda: sum(p["status"].get("phase") == "Running"
                                      for p in client.list_wire("pods", "default")[0]) == 3,
                          timeout=90)
        services = lambda ns: {s["metadata"]["name"]: s  # noqa: E731
                               for s in client.list_wire("services", ns)[0]}
        assert wait_until(lambda: "kube-dns" in services("default")
                          and "monitoring-heapster" in services("kube-system"), timeout=60)
        assert services("default")["kube-dns"]["spec"]["clusterIP"] == "10.0.0.10"
        eps = client.get_wire("endpoints", "monitoring-heapster", namespace="kube-system")
        addr = eps["subsets"][0]["addresses"][0]["ip"]
        mport = eps["subsets"][0]["ports"][0]["port"]

        def model_nodes():
            try:
                with urllib.request.urlopen(f"http://{addr}:{mport}/api/v1/model/nodes",
                                            timeout=3) as r:
                    return json.loads(r.read()).get("items", [])
            except OSError:
                return []

        assert wait_until(lambda: model_nodes() == ["cn-0"], timeout=60)
    finally:
        assert port_clusterup.down(state) == 0
    assert wait_until(lambda: not any(_alive(p) for p in pids), timeout=15)
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2)


def test_ssh_provider_executes_through_the_shim(tmp_path, monkeypatch):
    """The remote path (quoting, pidfile, teardown by ssh) run for real
    through tests/test_clusterup.py's shim: it joins the command words
    with spaces and hands them to a shell, as ssh does."""
    shim = tmp_path / "fake-ssh"
    shim.write_text("#!/bin/sh\nshift\n[ \"$1\" = \"--\" ] && shift\nexec sh -c \"$*\"\n")
    shim.chmod(0o755)
    monkeypatch.setattr(port_clusterup, "SSH_BASE", (str(shim),))
    port = _free_port()
    inv = {"master": {"host": "127.0.1.1", "port": port, "data_dir": str(tmp_path / "data")},
           "control_plane_replicas": 1, "nodes": [{"name": "sn-0", "host": "127.0.1.2"}],
           "runtime": "fake", "device": "cpu", "addons": []}
    state = str(tmp_path / "state")
    assert port_clusterup.up(inv, state, provider="ssh") == 0
    pids = []
    try:
        comps = json.load(open(os.path.join(state, "cluster.json")))["components"]

        def live_pid(info):
            try:
                pid = int(open(info["pidfile"]).read())
                os.kill(pid, 0)
                return pid
            except (OSError, ValueError):
                return None

        for role, info in comps.items():
            assert info["remote"] is True, role
            assert wait_until(lambda: live_pid(info) is not None, timeout=15), role
            pids.append(live_pid(info))

            def cmdline(pid=pids[-1]):
                with open(f"/proc/{pid}/cmdline") as f:
                    return f.read().split("\0")

            # The pidfile names the shell, which then execs the server.
            assert wait_until(lambda: "kubernetes_tpu_torch.cmd.hyperkube" in cmdline(),
                              timeout=15), cmdline()
        client = port_rest.Client(port_rest.HTTPTransport(f"http://127.0.1.1:{port}"))
        assert wait_until(lambda: len(client.list_wire("nodes")[0]) == 1, timeout=90)
    finally:
        assert port_clusterup.down(state) == 0
    assert wait_until(lambda: not any(_alive(p) for p in pids), timeout=15)
