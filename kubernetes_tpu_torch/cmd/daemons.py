"""Daemon entry points: the apiserver, the controller-manager, and a
daemon's health listener.

The port's copy of the apiserver half of `kubernetes_tpu/cmd/daemons.py`
(reference: cmd/kube-apiserver/app/server.go:82-185): `apiserver_parser`
with every flag of JAX's (address, port, admission control, the basic
and token auth files, the ABAC policy file, the durable store's
`--data-dir` with `--data-fsync` / `--no-data-fsync`, TLS with a client
CA, `--max-requests-inflight`), `start_apiserver` and `apiserver_main`,
which also starts the health plane (the retention sampler and the alert
engine, `utils/timeseries.py`, `utils/alerts.py`). The apiserver is
host code: nothing on its path touches the card, and its process loads
neither torch nor numpy. One departure: the auth files build a working
union authenticator (the JAX command's does not; ROADMAP queue 3).

And the port's copy of `HealthServer`, `_loop_alive_check` and
`_start_health` (reference: every daemon mounts healthz and prometheus
handlers on its own port, the scheduler's on 10251,
plugin/cmd/kube-scheduler/app/server.go:105-109):

- `GET /healthz`: 200 `ok` when every check passes, else 500 with the
  problems joined by "; ". A check is a callable returning (ok, msg).
- `GET /metrics`: the port's registry (`utils.metrics.DEFAULT`) in the
  Prometheus text format.
- `GET /debug/<view>`: the scheduler's debug views, rendered by
  `utils.debug.render_view`, which the port's apiserver shares, with
  the query parameters, status codes and bodies of the JAX apiserver's
  handlers. The JAX package serves them from the process that holds
  the rings; the port's rings live in its scheduler's process, so they
  are mounted here. `traces?pod=&limit=`, `decisions?pod=&limit=`, `solves?limit=`,
  `slo`, `capacity`, `rebalance`, `kernels` (`ops.ledger.DEFAULT`, read
  from `sys.modules`, so a process that never launched a kernel reports
  none), `device-profile?seconds=` (409 while a capture runs, 503 when
  the profiler is unavailable), `stacks` and `profile?seconds=&format=`.
  A bad number is a 400 and an unknown view a 404 listing these, each a
  `Status` body. The apiserver's own views (`requests`, `alerts`,
  `timeseries`, `health`) are served by the apiserver.

And the port's copy of the controller-manager half of JAX's module
(reference: cmd/kube-controller-manager/app/controllermanager.go):
`controller_manager_parser` with every flag of JAX's (`--server`,
`--cloud-provider`, `--node-grace-period`, `--node-eviction-timeout`,
`--healthz-port` 10252, `--leader-elect` and `--leader-elect-identity`
over `utils/leaderelect.HAHotStandby` with the lock
`kube-controller-manager`), `start_controller_manager`,
`_manager_health_check` and `controller_manager_main`. The manager is
host code (`controllers/manager.py`): its process loads neither torch
nor numpy at start. `--cloud-provider NAME` resolves through the port's
registry (`cloudprovider.get_provider`: `fake` or `gpu`; an unknown
name raises its `KeyError`) and adds the cloud controllers; `gpu`
reads the card inventory, which loads torch and opens a CUDA context
in this process.

And the port's copy of the node half (reference: cmd/kubelet/app and
cmd/kube-proxy/app): `kubelet_parser`, `start_kubelet` and
`kubelet_main` (a `Kubelet` on the fake, process or sandbox runtime,
serving its HTTP API, `kubelet/`), and `proxy_parser`, `start_proxy`
and `proxy_main` (a `ProxyServer`, `proxy/`, with `/healthz` and
`/metrics` on `--healthz-port`, default 10249), with JAX's flags and
defaults. `--real-portals` is the default, as in JAX's command, and
installs each service's cluster IP on the loopback device where the
process may; `--no-real-portals` keeps every portal an ephemeral
listener behind the rule table. Both processes load neither torch nor
numpy.

The JAX package's `ktctl explain` and `ktctl trace`, given a client on
this listener's address, read `/debug/decisions` and `/debug/traces`
here as they read them from the JAX apiserver.
"""

from __future__ import annotations

import argparse
import http.server
import json
import signal
import sys
import threading
from typing import Callable, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlparse

from kubernetes_tpu_torch.client.rest import APIError

#: The debug views this listener serves.
DEBUG_VIEWS = ("traces", "decisions", "solves", "slo", "capacity", "rebalance", "kernels",
               "device-profile", "stacks", "profile")

Check = Callable[[], Tuple[bool, str]]


def serve_debug(view: str, query: dict) -> Tuple[str, str]:
    """(body, content type) of one of this listener's debug views
    (`utils.debug.render_view`); raises APIError, which the server
    answers with a `Status` body."""
    from kubernetes_tpu_torch.utils import debug

    try:
        return debug.render_view(view, query, DEBUG_VIEWS)
    except debug.ViewError as e:
        raise APIError(e.code, e.reason, e.message)


class HealthServer:
    """The /healthz, /metrics and /debug listener of one daemon.
    `checks` are callables returning (ok, msg); /healthz is 200 only
    when all pass (a raising check fails with its exception)."""

    def __init__(self, port: int, checks: Optional[Sequence[Check]] = None,
                 host: str = "127.0.0.1"):
        from kubernetes_tpu_torch.utils import metrics

        checks = list(checks or [])

        class Handler(http.server.BaseHTTPRequestHandler):
            disable_nagle_algorithm = True

            def log_message(self, fmt, *a):  # noqa: N802
                pass

            def _send(self, code, payload, ctype="text/plain"):
                data = payload.encode() if isinstance(payload, str) else payload
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802
                parsed = urlparse(self.path)
                query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
                parts = [s for s in parsed.path.split("/") if s]
                if parts == ["healthz"]:
                    problems = []
                    for check in checks:
                        try:
                            ok, msg = check()
                        except Exception as e:
                            ok, msg = False, f"{type(e).__name__}: {e}"
                        if not ok:
                            problems.append(msg)
                    if problems:
                        self._send(500, "; ".join(problems))
                    else:
                        self._send(200, "ok")
                elif parts == ["metrics"]:
                    self._send(200, metrics.DEFAULT.render(), "text/plain; version=0.0.4")
                elif parts and parts[0] == "debug":
                    try:
                        body, ctype = serve_debug("/".join(parts[1:]), query)
                    except APIError as e:
                        status = {"kind": "Status", "apiVersion": "v1", "status": "Failure",
                                  "reason": e.reason, "message": e.message, "code": e.code}
                        self._send(e.code, json.dumps(status), "application/json")
                        return
                    self._send(200, body, ctype)
                else:
                    self._send(404, "not found")

        self.httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        kwargs={"poll_interval": 0.1}, daemon=True)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def address(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> "HealthServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def _loop_alive_check(daemon) -> Check:
    """Healthy while the daemon's loop thread is alive (a daemon with no
    loop thread, as the leader-election wrapper, reports ok)."""

    def check():
        t = getattr(daemon, "_thread", None)
        if t is None:
            return True, "ok"
        return t.is_alive(), "ok" if t.is_alive() else "loop not running"

    return check


def _start_health(args, checks: List[Check]) -> Optional[HealthServer]:
    """Bind the daemon's healthz port when enabled (negative disables).
    A port that is taken prints a warning and the daemon runs on: a
    daemon must not die because its health port is taken."""
    port = getattr(args, "healthz_port", -1)
    if port is None or port < 0:
        return None
    try:
        srv = HealthServer(port, checks).start()
    except OSError as e:
        print(f"warning: healthz port {port} unavailable: {e}", file=sys.stderr)
        return None
    print(f"healthz serving on 127.0.0.1:{srv.port}", flush=True)
    return srv


def _server_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--server", "-s", default="http://127.0.0.1:8080",
                   help="apiserver base URL")


def _wait_forever() -> None:
    stop = threading.Event()

    def handler(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, handler)
    signal.signal(signal.SIGINT, handler)
    stop.wait()


# -- apiserver --------------------------------------------------------


def apiserver_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu-apiserver")
    p.add_argument("--address", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument(
        "--admission-control", default="",
        help="comma-separated admission plugin names (default chain "
        "when empty)",
    )
    p.add_argument("--basic-auth-file", default="")
    p.add_argument("--token-auth-file", default="")
    p.add_argument("--authorization-policy-file", default="")
    p.add_argument(
        "--data-dir", default="",
        help="directory for the durable store (WAL + snapshots); empty "
        "keeps master state in memory only. Plays etcd's role in the "
        "reference (hack/local-up-cluster.sh:152-153).",
    )
    p.add_argument(
        "--data-fsync", dest="data_fsync", action="store_true",
        default=True,
        help="fsync WAL records before acking writes (group-committed "
        "across concurrent writers). ON by default: etcd's contract is "
        "fsync-before-ack.",
    )
    p.add_argument(
        "--no-data-fsync", dest="data_fsync", action="store_false",
        help="trade power-loss durability for write latency: WAL "
        "records flush to the OS (survives process death, NOT power "
        "loss) and acks don't wait for the disk",
    )
    p.add_argument("--tls-cert-file", default="")
    p.add_argument("--tls-private-key-file", default="")
    p.add_argument(
        "--client-ca-file", default="",
        help="CA bundle for x509 client-certificate authentication "
        "(CommonName = user, Organizations = groups; "
        "pkg/apiserver/authn.go:35)",
    )
    p.add_argument(
        "--max-requests-inflight", type=int, default=400,
        help="cap on concurrently-served non-long-running API requests "
        "(429 beyond it; 0 disables). Reference: "
        "cmd/kube-apiserver --max-requests-inflight / "
        "pkg/apiserver/handlers.go MaxInFlightLimit.",
    )
    return p


def start_apiserver(args):
    """Returns the running APIHTTPServer."""
    from kubernetes_tpu_torch.server.api import APIServer
    from kubernetes_tpu_torch.server.httpserver import APIHTTPServer

    store = None
    if getattr(args, "data_dir", ""):
        from kubernetes_tpu_torch.store.kvstore import KVStore

        store = KVStore(
            data_dir=args.data_dir, fsync=getattr(args, "data_fsync", True)
        )
    api = APIServer(store=store)
    if args.admission_control:
        from kubernetes_tpu_torch.server import admission as adm

        api.admission = adm.new_from_plugins(
            api, [n for n in args.admission_control.split(",") if n]
        )
    authenticator = authorizer = None
    if args.basic_auth_file or args.token_auth_file:
        from kubernetes_tpu_torch.server import auth

        # Basic as the password half, tokens as the bearer list (the JAX
        # command passes one list as the password half, so its basic
        # auth answers 500 and every bearer token 401).
        authenticator = auth.UnionAuthenticator(
            password=(auth.PasswordAuthenticator.from_file(args.basic_auth_file)
                      if args.basic_auth_file else None),
            tokens=([auth.TokenAuthenticator.from_file(args.token_auth_file)]
                    if args.token_auth_file else []),
        )
    if args.authorization_policy_file:
        from kubernetes_tpu_torch.server import auth

        authorizer = auth.ABACAuthorizer.from_file(args.authorization_policy_file)
    return APIHTTPServer(
        api,
        host=args.address,
        port=args.port,
        authenticator=authenticator,
        authorizer=authorizer,
        publish_master=True,
        max_in_flight=getattr(args, "max_requests_inflight", 400),
        tls_cert_file=getattr(args, "tls_cert_file", ""),
        tls_key_file=getattr(args, "tls_private_key_file", ""),
        client_ca_file=getattr(args, "client_ca_file", ""),
    ).start()


def apiserver_main(argv: Optional[List[str]] = None) -> int:
    args = apiserver_parser().parse_args(argv)
    srv = start_apiserver(args)
    # The health plane (retention sampler and alert engine) lives in the
    # apiserver's process: /debug/alerts, /debug/timeseries and
    # /debug/health read it there. KT_TIMESERIES=0 opts out.
    from kubernetes_tpu_torch.client.rest import Client, LocalTransport
    from kubernetes_tpu_torch.utils import alerts, timeseries

    alerts.ensure_started(client=Client(LocalTransport(srv.api)))
    print(f"apiserver listening on {srv.address}", flush=True)
    try:
        _wait_forever()
    finally:
        timeseries.SAMPLER.stop()
        srv.stop()
    return 0


# -- controller manager ----------------------------------------------


def controller_manager_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu-controller-manager")
    _server_flag(p)
    p.add_argument("--cloud-provider", default="",
                   help="cloud provider name (e.g. 'gpu', 'fake')")
    p.add_argument("--node-grace-period", type=float, default=40.0)
    p.add_argument("--node-eviction-timeout", type=float, default=20.0)
    p.add_argument("--healthz-port", type=int, default=10252,
                   help="own /healthz + /metrics port (negative disables)")
    p.add_argument("--leader-elect", action="store_true",
                   help="run hot-standby: only the lease holder is active")
    p.add_argument("--leader-elect-identity", default="")
    return p


def start_controller_manager(args, client=None):
    """The started ControllerManager, or under `--leader-elect` a started
    `HAHotStandby` that builds and starts one while it holds the
    `kube-controller-manager` lock."""
    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.cmd.scheduler import _maybe_ha
    from kubernetes_tpu_torch.controllers.manager import ControllerManager

    client = client or Client(HTTPTransport(args.server))
    provider = None
    if args.cloud_provider:
        from kubernetes_tpu_torch import cloudprovider

        provider = cloudprovider.get_provider(args.cloud_provider)

    def factory():
        return ControllerManager(
            client,
            cloud_provider=provider,
            node_grace_period=args.node_grace_period,
            node_eviction_timeout=args.node_eviction_timeout,
        ).start()

    return _maybe_ha(args, client, "kube-controller-manager", factory)


def _manager_health_check(mgr) -> Check:
    def check():
        if not hasattr(mgr, "controllers"):
            # The leader-election wrapper: no controllers of its own
            # while standby; the live manager is inside it when leading.
            return True, "ok"
        running = getattr(mgr, "running", True)
        n = len(mgr.controllers or [])
        if not running:
            return False, "controller manager stopped"
        return n > 0, f"{n} controllers running" if n else "no controllers"

    return check


def controller_manager_main(argv: Optional[List[str]] = None) -> int:
    args = controller_manager_parser().parse_args(argv)
    mgr = start_controller_manager(args)
    health = _start_health(args, [_manager_health_check(mgr)])
    print(f"controller-manager running against {args.server}", flush=True)
    try:
        _wait_forever()
    finally:
        mgr.stop()
        if health:
            health.stop()
    return 0


# -- kubelet ----------------------------------------------------------


def kubelet_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu-kubelet")
    _server_flag(p)
    p.add_argument("--node-name", required=True)
    p.add_argument("--root-dir", default="")
    p.add_argument("--manifest-dir", default="")
    p.add_argument("--manifest-url", default="",
                   help="poll this URL for static pod manifests (config/http.go)")
    p.add_argument("--cpu", default="4")
    p.add_argument("--memory", default="8Gi")
    p.add_argument("--max-pods", type=int, default=110)
    p.add_argument("--fake-runtime", action="store_true",
                   help="in-memory runtime (integration testing); default is the "
                   "process runtime when --root-dir is set")
    p.add_argument("--container-runtime", default="",
                   choices=["", "fake", "process", "sandbox"],
                   help="runtime backend (reference: kubelet --container_runtime "
                   "docker|rkt). sandbox = namespace-isolated pods + image store "
                   "(needs root + util-linux); default: process when --root-dir "
                   "is set, else fake")
    p.add_argument("--http-port", type=int, default=0)
    p.add_argument("--cluster-dns", default="",
                   help="DNS VIP injected into containers as "
                   "KUBERNETES_CLUSTER_DNS (reference: kubelet --cluster-dns "
                   "writes pod resolv.conf)")
    p.add_argument("--cluster-domain", default="cluster.local")
    return p


def start_kubelet(args, client=None):
    """The started `Kubelet` on the runtime the flags choose, serving
    its HTTP API on `--http-port` (0: a free port, published in the
    node's daemon endpoints)."""
    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.kubelet.agent import Kubelet
    from kubernetes_tpu_torch.kubelet.runtime import FakeRuntime

    client = client or Client(HTTPTransport(args.server))
    choice = getattr(args, "container_runtime", "") or (
        "fake" if args.fake_runtime or not args.root_dir else "process")
    if choice == "fake":
        runtime = FakeRuntime()
    elif choice == "sandbox":
        from kubernetes_tpu_torch.kubelet.sandbox_runtime import (
            SandboxRuntime,
            sandbox_supported,
        )

        if not args.root_dir:
            raise SystemExit("--container-runtime sandbox needs --root-dir")
        if not sandbox_supported():
            raise SystemExit("sandbox runtime unavailable (needs root + unshare/nsenter)")
        runtime = SandboxRuntime(args.root_dir, node_name=args.node_name)
    else:
        from kubernetes_tpu_torch.kubelet.process_runtime import ProcessRuntime

        if not args.root_dir:
            raise SystemExit("--container-runtime process needs --root-dir")
        runtime = ProcessRuntime(args.root_dir, node_name=args.node_name)
    if getattr(args, "cluster_dns", ""):
        # --cluster-dns/--cluster-domain reach containers as env (the
        # reference writes them into each pod's resolv.conf).
        runtime.cluster_dns = args.cluster_dns
        runtime.cluster_domain = getattr(args, "cluster_domain", "cluster.local")
    return Kubelet(
        client,
        node_name=args.node_name,
        runtime=runtime,
        cpu=args.cpu,
        memory=args.memory,
        max_pods=args.max_pods,
        manifest_dir=args.manifest_dir or None,
        manifest_url=args.manifest_url or None,
        root_dir=args.root_dir or None,
        serve_http=True,
        http_port=args.http_port,
    ).start()


def kubelet_main(argv: Optional[List[str]] = None) -> int:
    args = kubelet_parser().parse_args(argv)
    kubelet = start_kubelet(args)
    port = kubelet.http.port if kubelet.http else "-"
    print(f"kubelet {args.node_name} running (http port {port})", flush=True)
    try:
        _wait_forever()
    finally:
        kubelet.stop()
    return 0


# -- proxy ------------------------------------------------------------


def proxy_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu-proxy")
    _server_flag(p)
    p.add_argument("--bind-address", default="127.0.0.1")
    p.add_argument("--real-portals", action="store_true", default=True,
                   help="install service VIPs on loopback and bind listeners at "
                   "clusterIP:port (the openPortal/iptables analog; needs root, "
                   "falls back to rule-table portals otherwise)")
    p.add_argument("--no-real-portals", dest="real_portals", action="store_false")
    p.add_argument("--healthz-port", type=int, default=10249,
                   help="own /healthz + /metrics port (reference per-daemon "
                   "defaults: scheduler 10251, controller-manager 10252, proxy "
                   "10249); negative disables")
    return p


def start_proxy(args, client=None):
    """The started `ProxyServer` against `--server`."""
    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.proxy.config import ProxyServer

    client = client or Client(HTTPTransport(args.server))
    return ProxyServer(client, listen_ip=args.bind_address,
                       real_portals=getattr(args, "real_portals", False)).start()


def proxy_main(argv: Optional[List[str]] = None) -> int:
    args = proxy_parser().parse_args(argv)
    proxy = start_proxy(args)
    health = _start_health(args, [lambda: (True, "ok")])
    print(f"proxy running against {args.server}", flush=True)
    try:
        _wait_forever()
    finally:
        proxy.stop()
        if health:
            health.stop()
    return 0
