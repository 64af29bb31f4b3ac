"""The port's hyperkube command and its apiserver as a child process.

`python -m kubernetes_tpu_torch.cmd.hyperkube apiserver --port P`
answers /healthz, serves creates and LISTs, loads neither torch nor
anything of the JAX package, takes the auth files (basic and token under
an ABAC policy) and, with `--data-dir`, recovers every object after a
SIGKILL. `scheduler` is the port's command. `controller-manager
--server URL` runs the port's controllers against the apiserver child:
its /healthz answers while they run, an RC gets its pods and its status,
and its process loads neither torch nor the JAX package; with
`--cloud-provider fake` it runs the cloud controllers beside them.
`kubelet` and `proxy` are the port's commands: `--help` names each, a
`--fake-runtime` kubelet child registers its node with an in-process
apiserver, and a `--no-real-portals` proxy child answers /healthz; both
processes map neither torch nor CUDA. `local-up-cluster` is the port's
command, and so is `ktctl` (the port's CLI); an unknown server exits 1.
The apiserver's and
the controller-manager's flags are JAX's.
"""

import base64
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    return dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(port, method, path, body=None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


class Apiserver:
    """The command as a child on a free port; up when /healthz is 200."""

    def __init__(self, *flags):
        self.port = _free_port()
        self.cmd = [sys.executable, "-m", "kubernetes_tpu_torch.cmd.hyperkube", "apiserver",
                    "--port", str(self.port), *flags]
        self.start()

    def start(self):
        self.proc = subprocess.Popen(self.cmd, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            assert self.proc.poll() is None, self.proc.stdout.read()
            try:
                if _request(self.port, "GET", "/healthz")[0] == 200:
                    return
            except OSError:
                pass
            time.sleep(0.1)
        raise AssertionError("the apiserver did not answer /healthz")

    def mapped(self):
        with open(f"/proc/{self.proc.pid}/maps") as f:
            return f.read()

    def stop(self, sig=signal.SIGTERM):
        if self.proc.poll() is None:
            self.proc.send_signal(sig)
            self.proc.wait(timeout=30)
        self.proc.stdout.close()
        return self.proc.returncode


POD = {"kind": "Pod", "metadata": {"name": "p0"},
       "spec": {"containers": [{"name": "c", "image": "nginx"}]}}


def test_apiserver_serves_and_loads_no_torch_and_no_jax_package():
    srv = Apiserver()
    try:
        code, health = _request(srv.port, "GET", "/healthz")
        assert code == 200 and health["status"] == "ok"
        assert _request(srv.port, "POST", "/api/v1/nodes", {"metadata": {"name": "n0"}})[0] == 201
        code, pod = _request(srv.port, "POST", "/api/v1/namespaces/default/pods", POD)
        assert code == 201 and pod["metadata"]["uid"]
        code, listed = _request(srv.port, "GET", "/api/v1/namespaces/default/pods")
        assert code == 200 and [p["metadata"]["name"] for p in listed["items"]] == ["p0"]
        # Every view of this process, the scheduler's rings too, is
        # answered without loading torch.
        for view in ("alerts", "timeseries", "health", "slo", "capacity", "rebalance",
                     "kernels", "decisions", "solves", "traces"):
            assert _request(srv.port, "GET", f"/debug/{view}")[0] == 200, view
        maps = srv.mapped()
        assert "libtorch" not in maps and "libcuda" not in maps
    finally:
        assert srv.stop() == 0


def test_apiserver_with_auth_files(tmp_path):
    (tmp_path / "basic").write_text("secret,alice,1\n")
    (tmp_path / "token").write_text("tok,carol,3\n")
    (tmp_path / "policy").write_text(json.dumps({"user": "alice"}) + "\n"
                                     + json.dumps({"user": "carol", "readonly": True}) + "\n")
    srv = Apiserver("--basic-auth-file", str(tmp_path / "basic"),
                    "--token-auth-file", str(tmp_path / "token"),
                    "--authorization-policy-file", str(tmp_path / "policy"))
    try:
        pods = "/api/v1/namespaces/default/pods"
        basic = {"Authorization": "Basic " + base64.b64encode(b"alice:secret").decode()}
        assert _request(srv.port, "GET", pods)[0] == 401
        assert _request(srv.port, "POST", pods, POD, basic)[0] == 201
        assert _request(srv.port, "GET", pods, headers={"Authorization": "Bearer tok"})[0] == 200
        assert _request(srv.port, "POST", pods, POD, {"Authorization": "Bearer tok"})[0] == 403
        assert _request(srv.port, "GET", pods, headers={"Authorization": "Bearer no"})[0] == 401
    finally:
        srv.stop()


def test_durable_apiserver_recovers_after_sigkill(tmp_path):
    srv = Apiserver("--data-dir", str(tmp_path / "data"))
    try:
        for j in range(3):
            _request(srv.port, "POST", "/api/v1/nodes", {"metadata": {"name": f"n{j}"}})
        _request(srv.port, "POST", "/api/v1/namespaces/default/pods", POD)
        code, _ = _request(srv.port, "POST", "/api/v1/namespaces/default/bindings",
                           {"metadata": {"name": "p0"}, "target": {"kind": "Node", "name": "n2"}})
        assert code == 201
        before = [_request(srv.port, "GET", p)[1] for p in ("/api/v1/nodes",
                                                            "/api/v1/namespaces/default/pods")]
        srv.stop(signal.SIGKILL)
        srv.start()
        after = [_request(srv.port, "GET", p)[1] for p in ("/api/v1/nodes",
                                                           "/api/v1/namespaces/default/pods")]
        # Items equal; the list's version moves on, as the restarted
        # apiserver publishes its own service and endpoints again.
        assert [x["items"] for x in after] == [x["items"] for x in before]
        code, pod = _request(srv.port, "POST", "/api/v1/namespaces/default/pods",
                             dict(POD, metadata={"name": "p1"}))
        assert code == 201
        acked = int(before[1]["metadata"]["resourceVersion"])
        assert int(pod["metadata"]["resourceVersion"]) > acked
    finally:
        srv.stop()


@pytest.mark.parametrize("server,rc,says", [
    # No subcommand: the port's ktctl parser asks for one (argparse's 2).
    ("ktctl", 2, "usage: ktctl"), ("frobnicator", 1, "unknown server")])
def test_unported_and_unknown_servers(server, rc, says):
    """Every server of the JAX command is routed to the port's (ktctl to
    `cli/ktctl.main`); an unknown one exits 1."""
    from kubernetes_tpu_torch.cmd import hyperkube

    proc = subprocess.run([sys.executable, "-m", "kubernetes_tpu_torch.cmd.hyperkube", server],
                          cwd=REPO, env=_env(), capture_output=True, text=True, timeout=60)
    assert proc.returncode == rc and says in proc.stderr
    assert "not yet ported" not in proc.stderr
    assert set(hyperkube.SERVERS) == {
        "apiserver", "scheduler", "controller-manager", "kubelet", "proxy", "ktctl",
        "local-up-cluster"}
    assert not hasattr(hyperkube, "NOT_PORTED")


def test_local_up_cluster_route_is_the_ports_command():
    """`hyperkube local-up-cluster` reaches the port's `cmd/localup`:
    its `--help` names the port's flag `--device`; without a card a
    batch cluster raises before it serves, and nothing of the JAX
    package runs."""
    from kubernetes_tpu_torch.cmd import hyperkube, localup

    assert hyperkube.SERVERS["local-up-cluster"].__name__ == "_local_up_cluster"
    proc = subprocess.run([sys.executable, "-m", "kubernetes_tpu_torch.cmd.hyperkube",
                           "local-up-cluster", "--help"],
                          cwd=REPO, env=_env(), capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and "tpu-local-up-cluster" in proc.stdout
    assert "--device {cuda,cpu}" in proc.stdout and "--cluster-dns" in proc.stdout
    assert localup.build_parser().parse_args([]).device == "cuda"
    proc = subprocess.run([sys.executable, "-m", "kubernetes_tpu_torch.cmd.hyperkube",
                           "local-up-cluster", "--batch-scheduler", "--port", "0"],
                          cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "CUDA" in proc.stderr and "cluster up" not in proc.stdout


def test_scheduler_route_is_the_ports_command():
    proc = subprocess.run([sys.executable, "-m", "kubernetes_tpu_torch.cmd.hyperkube", "scheduler",
                           "--help"], cwd=REPO, env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and "--batch-incremental" in proc.stdout
    proc = subprocess.run([sys.executable, "-m", "kubernetes_tpu_torch.cmd.hyperkube"],
                          cwd=REPO, env=_env(), capture_output=True, text=True, timeout=60)
    assert proc.returncode == 1 and ("apiserver, controller-manager, ktctl, kubelet, "
                                     "local-up-cluster, proxy, scheduler" in proc.stdout)


def test_apiserver_flags_are_jax_flags():
    from kubernetes_tpu.cmd import daemons as jax_daemons

    from kubernetes_tpu_torch.cmd import daemons

    def flags(parser):
        return sorted((a.dest, tuple(a.option_strings), a.default, a.type)
                      for a in parser._actions if a.dest != "help")

    assert flags(daemons.apiserver_parser()) == flags(jax_daemons.apiserver_parser())
    assert flags(daemons.controller_manager_parser()) == flags(
        jax_daemons.controller_manager_parser())


def test_apiserver_path_imports_no_jax_package_and_no_torch():
    code = (
        "import sys\n"
        "from kubernetes_tpu_torch.cmd import daemons, hyperkube\n"
        "srv = daemons.start_apiserver(daemons.apiserver_parser().parse_args(['--port', '0']))\n"
        "srv.api.create('pods', 'default', {'metadata': {'name': 'p'},\n"
        "    'spec': {'containers': [{'name': 'c', 'image': 'x'}]}})\n"
        "srv.stop()\n"
        "print(sorted(m for m in sys.modules if m == 'kubernetes_tpu'\n"
        "             or m.startswith('kubernetes_tpu.')), 'torch' in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[] False"


def _get_text(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_controller_manager_gives_an_rc_its_pods():
    """`hyperkube controller-manager --server URL` against the port's
    apiserver child: /healthz is 200 while its controllers run, an RC of
    3 replicas gets 3 pods from its template and status.replicas 3, and
    scaled to 1 it keeps one; its process maps neither torch nor CUDA."""
    srv = Apiserver()
    health = _free_port()
    cm = subprocess.Popen(
        [sys.executable, "-m", "kubernetes_tpu_torch.cmd.hyperkube", "controller-manager",
         "--server", f"http://127.0.0.1:{srv.port}", "--healthz-port", str(health)],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 60
        while True:
            assert cm.poll() is None, cm.stdout.read()
            try:
                if _get_text(health, "/healthz") == (200, "ok"):
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "the controller-manager's /healthz never answered"
            time.sleep(0.1)
        rc = {"kind": "ReplicationController", "metadata": {"name": "web"},
              "spec": {"replicas": 3, "selector": {"app": "web"},
                       "template": {"metadata": {"labels": {"app": "web"}},
                                    "spec": {"containers": [{"name": "c", "image": "nginx"}]}}}}
        rcs = "/api/v1/namespaces/default/replicationcontrollers"
        assert _request(srv.port, "POST", rcs, rc)[0] == 201

        def state():
            pods = _request(srv.port, "GET", "/api/v1/namespaces/default/pods")[1]["items"]
            got = _request(srv.port, "GET", rcs + "/web")[1]
            return (sorted(p["metadata"]["generateName"] for p in pods),
                    (got.get("status") or {}).get("replicas"))

        deadline = time.monotonic() + 60
        while state() != (["web-"] * 3, 3):
            assert time.monotonic() < deadline, state()
            time.sleep(0.1)
        code, got = _request(srv.port, "GET", rcs + "/web")
        got["spec"]["replicas"] = 1
        assert _request(srv.port, "PUT", rcs + "/web", got)[0] == 200
        deadline = time.monotonic() + 60
        while state() != (["web-"], 1):
            assert time.monotonic() < deadline, state()
            time.sleep(0.1)
        code, metrics = _get_text(health, "/metrics")
        assert code == 200 and "replication_controller_syncs_total" in metrics
        with open(f"/proc/{cm.pid}/maps") as f:
            maps = f.read()
        assert "libtorch" not in maps and "libcuda" not in maps
    finally:
        cm.send_signal(signal.SIGTERM)
        assert cm.wait(timeout=30) == 0
        cm.stdout.close()
        srv.stop()


def test_controller_manager_runs_the_cloud_controllers_with_a_provider():
    """`hyperkube controller-manager --cloud-provider fake` against the
    port's apiserver child serves /healthz with the three cloud
    controllers among its controllers, their sync counters on /metrics,
    maps neither torch nor CUDA, and stops on SIGTERM with 0."""
    srv = Apiserver()
    health = _free_port()
    cm = subprocess.Popen(
        [sys.executable, "-m", "kubernetes_tpu_torch.cmd.hyperkube", "controller-manager",
         "--server", f"http://127.0.0.1:{srv.port}", "--healthz-port", str(health),
         "--cloud-provider", "fake"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 60
        while True:
            assert cm.poll() is None, cm.stdout.read()
            try:
                code, text = _get_text(health, "/metrics")
                if code == 200 and "route_syncs_total{" in text and (
                        "service_lb_syncs_total{" in text):
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "the cloud controllers never synced"
            time.sleep(0.1)
        assert _get_text(health, "/healthz") == (200, "ok")
        with open(f"/proc/{cm.pid}/maps") as f:
            maps = f.read()
        assert "libtorch" not in maps and "libcuda" not in maps
    finally:
        cm.send_signal(signal.SIGTERM)
        assert cm.wait(timeout=30) == 0
        cm.stdout.close()
        srv.stop()


def test_controller_manager_path_imports_no_jax_package_and_no_torch():
    """Building and starting every controller of the manager loads
    neither torch (nor numpy) nor anything of the JAX package."""
    code = (
        "import sys\n"
        "from kubernetes_tpu_torch.client.rest import Client, LocalTransport\n"
        "from kubernetes_tpu_torch.cmd import daemons, hyperkube\n"
        "from kubernetes_tpu_torch.server.api import APIServer\n"
        "args = daemons.controller_manager_parser().parse_args([])\n"
        "mgr = daemons.start_controller_manager(args, Client(LocalTransport(APIServer())))\n"
        "n = len(mgr.controllers)\n"
        "mgr.stop()\n"
        "print(sorted(m for m in sys.modules if m == 'kubernetes_tpu'\n"
        "             or m.startswith('kubernetes_tpu.')), 'torch' in sys.modules, n)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[] False 9"


def _await_line(proc, word, timeout=60):
    """Read the child's output until a line holding `word` (the command
    prints it once it serves, just before it waits for a signal)."""
    import queue

    lines = queue.Queue()
    proc.reader = threading.Thread(
        target=lambda: [lines.put(x) for x in iter(proc.stdout.readline, "")], daemon=True)
    proc.reader.start()
    deadline = time.monotonic() + timeout
    while True:
        left = deadline - time.monotonic()
        assert left > 0, f"no {word!r} line from the child"
        try:
            line = lines.get(timeout=left)
        except queue.Empty:
            continue
        if word in line:
            return line


def _wait_for(proc, cond, what, timeout=60):
    deadline = time.monotonic() + timeout
    while True:
        assert proc.poll() is None, proc.stdout.read()
        try:
            if cond():
                return
        except OSError:
            pass
        assert time.monotonic() < deadline, what
        time.sleep(0.1)


@pytest.mark.parametrize("server", ["kubelet", "proxy"])
def test_node_routes_are_the_ports_commands(server):
    """The routes that exited 2 while the node side was not ported now
    reach the port's commands: `--help` names each, and each serves
    against an apiserver in this process, its process mapping neither
    torch nor CUDA."""
    from kubernetes_tpu_torch.cmd import hyperkube
    from kubernetes_tpu_torch.server.api import APIServer
    from kubernetes_tpu_torch.server.httpserver import APIHTTPServer

    assert server in hyperkube.SERVERS
    cmd = [sys.executable, "-m", "kubernetes_tpu_torch.cmd.hyperkube", server]
    proc = subprocess.run(cmd + ["--help"], cwd=REPO, env=_env(), capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0 and f"usage: tpu-{server}" in proc.stdout
    srv = APIHTTPServer(APIServer()).start()
    health = _free_port()
    flags = (["--node-name", "hk-node", "--fake-runtime"] if server == "kubelet"
             else ["--no-real-portals", "--healthz-port", str(health)])
    child = subprocess.Popen(cmd + ["--server", srv.address, *flags], cwd=REPO, env=_env(),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        if server == "kubelet":
            def registered():
                node = srv.api.get("nodes", "", "hk-node")
                return node["status"]["daemonEndpoints"]["kubeletEndpoint"]["port"] > 0

            _wait_for(child, lambda: _ok(registered), "the kubelet never registered its node")
            port = srv.api.get("nodes", "", "hk-node")["status"]["daemonEndpoints"][
                "kubeletEndpoint"]["port"]
            assert _get_text(port, "/healthz") == (200, "ok")
        else:
            _wait_for(child, lambda: _get_text(health, "/healthz") == (200, "ok"),
                      "the proxy's /healthz never answered")
        _await_line(child, "running")
        with open(f"/proc/{child.pid}/maps") as f:
            maps = f.read()
        assert "libtorch" not in maps and "libcuda" not in maps
    finally:
        child.send_signal(signal.SIGTERM)
        try:
            code = child.wait(timeout=60)
        except subprocess.TimeoutExpired:
            child.kill()
            code = child.wait()
        assert code == 0
        if getattr(child, "reader", None) is not None:
            child.reader.join(timeout=10)  # it ends at the output's end
        child.stdout.close()
        srv.stop()


def _ok(cond):
    try:
        return cond()
    except Exception:
        return False
