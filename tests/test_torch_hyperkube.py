"""The port's hyperkube command and its apiserver as a child process.

`python -m kubernetes_tpu_torch.cmd.hyperkube apiserver --port P`
answers /healthz, serves creates and LISTs, loads neither torch nor
anything of the JAX package, takes the auth files (basic and token under
an ABAC policy) and, with `--data-dir`, recovers every object after a
SIGKILL. `scheduler` is the port's command; a server the port does not
have yet exits 2 naming itself; an unknown one exits 1. The apiserver's
flags are JAX's.
"""

import base64
import json
import os
import signal
import socket
import subprocess
import sys
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
    ("controller-manager", 2, "not yet ported"), ("kubelet", 2, "not yet ported"),
    ("proxy", 2, "not yet ported"), ("ktctl", 2, "not yet ported"),
    ("local-up-cluster", 2, "not yet ported"), ("frobnicator", 1, "unknown server")])
def test_unported_and_unknown_servers(server, rc, says):
    from kubernetes_tpu_torch.cmd import hyperkube

    proc = subprocess.run([sys.executable, "-m", "kubernetes_tpu_torch.cmd.hyperkube", server],
                          cwd=REPO, env=_env(), capture_output=True, text=True, timeout=60)
    assert proc.returncode == rc and says in proc.stderr
    assert set(hyperkube.SERVERS) | set(hyperkube.NOT_PORTED) >= {
        "apiserver", "scheduler", "controller-manager", "kubelet", "proxy", "ktctl",
        "local-up-cluster"}


def test_scheduler_route_is_the_ports_command():
    proc = subprocess.run([sys.executable, "-m", "kubernetes_tpu_torch.cmd.hyperkube", "scheduler",
                           "--help"], cwd=REPO, env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and "--batch-incremental" in proc.stdout
    proc = subprocess.run([sys.executable, "-m", "kubernetes_tpu_torch.cmd.hyperkube"],
                          cwd=REPO, env=_env(), capture_output=True, text=True, timeout=60)
    assert proc.returncode == 1 and "apiserver, scheduler" in proc.stdout


def test_apiserver_flags_are_jax_flags():
    from kubernetes_tpu.cmd import daemons as jax_daemons

    from kubernetes_tpu_torch.cmd import daemons

    def flags(parser):
        return sorted((a.dest, tuple(a.option_strings), a.default, a.type)
                      for a in parser._actions if a.dest != "help")

    assert flags(daemons.apiserver_parser()) == flags(jax_daemons.apiserver_parser())


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
