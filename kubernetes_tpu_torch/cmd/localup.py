"""local-up-cluster: a whole cluster in one process.

Reference: hack/local-up-cluster.sh — start etcd + apiserver +
controller-manager + scheduler + kubelet + proxy locally and print how
to talk to it. Here the store is in-process, daemons share it over
LocalTransport, and the apiserver speaks real HTTP for clients.

The port's copy of `kubernetes_tpu/cmd/localup.py`: `build_parser` with
JAX's flags and defaults, `LocalCluster` and `main`, every server the
port's (`server/`, `controllers/`, `scheduler/daemon.py`, `kubelet/`,
`proxy/`, `addons/`, `cloudprovider/`). One flag more, the port's rule
for entry points: `--device {cuda,cpu}` (default `cuda`, the scheduler
command's flag) is where the batch scheduler solves; with `cuda` and no
card, `LocalCluster` raises before anything starts. The per-pod
scheduler (no batch flag) touches no card. Departures:

- `--kubelet-http` kubelets talk to the apiserver through the port's
  `HTTPTransport`, one keep-alive connection a kubelet thread (the JAX
  client's `serialize=True`, one shared connection a kubelet, is not
  ported);
- `main` flushes its two lines, so a parent reading its output through
  a pipe sees the apiserver's address at once, and prints them inside
  the block whose `finally` stops the cluster, so a SIGINT that lands
  while they are written still stops it;
- `--cloud-provider` resolves through the port's registry (`fake`,
  `gpu`; not `tpu`).

With `--cluster-dns` and no real-portal kube-proxy (`--no-kube-proxy`
included), the DNS addon serves on its own bound port and says so on
stderr; the loopback probe of the kube-dns address runs only with a
real-portal proxy. `stop()` stops the process-wide retention sampler
(`utils/timeseries.SAMPLER`), which `start()` boots with the alert
engine.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from kubernetes_tpu_torch.client.rest import Client, LocalTransport


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu-local-up-cluster")
    p.add_argument("--address", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--nodes", type=int, default=2)
    p.add_argument(
        "--process-runtime", action="store_true",
        help="pods become real OS processes (default: fake runtime)",
    )
    p.add_argument(
        "--sandbox-runtime", action="store_true",
        help="pods become namespace-isolated process groups with an "
        "image store (the rkt-analog backend; needs root + util-linux)",
    )
    p.add_argument(
        "--cloud-provider", default="",
        help="register nodes from a cloud provider (e.g. 'gpu')",
    )
    p.add_argument(
        "--batch-scheduler", action="store_true",
        help="batch scheduling on the card; boots the always-resident "
        "incremental session daemon (device-resident cluster state, "
        "event-driven micro-ticks, pipelined commits) unless "
        "--batch-full-relower",
    )
    p.add_argument(
        "--batch-mode", default="scan",
        choices=["scan", "wave", "sinkhorn", "auto"],
        help="device solver mode for --batch-scheduler (scan = "
        "sequential-parity referee; wave/sinkhorn = high-throughput; "
        "auto = the scan on one card)",
    )
    p.add_argument(
        "--batch-incremental", action="store_true",
        help="device-resident session across scheduler ticks; implies "
        "--batch-scheduler (what --batch-scheduler boots anyway; the "
        "flag remains for compatibility)",
    )
    p.add_argument(
        "--batch-full-relower", action="store_true",
        help="with --batch-scheduler: the per-tick full-relower "
        "BatchScheduler instead of the incremental session",
    )
    p.add_argument(
        "--prewarm-buckets", type=int, default=128,
        help="run the session's launches at every pod bucket up to "
        "this size at session build (0 disables) — a fresh bucket "
        "never stalls a live tick",
    )
    p.add_argument(
        "--no-kube-proxy", dest="kube_proxy", action="store_false",
        default=True, help="skip the in-process kube-proxy",
    )
    p.add_argument(
        "--cluster-dns", action="store_true",
        help="start the DNS addon and publish it as the kube-dns "
        "service at 10.0.0.10 (cluster/addons/dns analog)",
    )
    p.add_argument(
        "--kubelet-http", action="store_true",
        help="kubelets talk to the apiserver over real HTTP instead of "
        "in-process calls (the reference's actual topology: watch "
        "fan-out, heartbeats and status writeback all cross the wire)",
    )
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where the batch scheduler solves (default: the CUDA card)",
    )
    return p


class LocalCluster:
    """Assembled cluster; start() everything, stop() tears down."""

    def __init__(self, args):
        from kubernetes_tpu_torch.controllers.manager import ControllerManager
        from kubernetes_tpu_torch.scheduler.daemon import (
            BatchScheduler,
            IncrementalBatchScheduler,
            Scheduler,
            SchedulerConfig,
        )
        from kubernetes_tpu_torch.server.api import APIServer
        from kubernetes_tpu_torch.server.httpserver import APIHTTPServer

        self.args = args
        # --batch-scheduler boots the always-resident incremental
        # session daemon unless the caller opts back into the per-tick
        # full relower.
        incremental = getattr(args, "batch_incremental", False) or (
            args.batch_scheduler
            and not getattr(args, "batch_full_relower", False)
        )
        device = None
        if args.batch_scheduler or incremental:
            # Resolved before anything starts: no card and no
            # `--device cpu` raises here.
            from kubernetes_tpu_torch import default_device

            device = "cpu" if getattr(args, "device", "cuda") == "cpu" else default_device()
        self.api = APIServer()
        self.http = APIHTTPServer(
            self.api, host=args.address, port=args.port, publish_master=True,
            max_in_flight=400,
        )
        self.kubelets = []
        self._tmp_roots = []
        self._kubelet_http = getattr(args, "kubelet_http", False)
        if not self._kubelet_http:
            # In-process transport: build now. HTTP kubelets are built
            # in start(), once the apiserver's port is known.
            self._build_kubelets(self._client)
        self.scheduler_config = SchedulerConfig(
            self._client(), raw_scheduled_cache=incremental
        )
        if device is not None:
            mode = getattr(args, "batch_mode", "scan")
            if incremental:
                prewarm = getattr(args, "prewarm_buckets", 0)
                self.scheduler_cls = lambda cfg: IncrementalBatchScheduler(
                    cfg, mode=mode, prewarm_buckets=prewarm, device=device
                )
            else:
                self.scheduler_cls = lambda cfg: BatchScheduler(
                    cfg, mode=mode, device=device
                )
        else:
            self.scheduler_cls = Scheduler
        self.scheduler = None
        provider = None
        if args.cloud_provider:
            from kubernetes_tpu_torch import cloudprovider

            provider = cloudprovider.get_provider(args.cloud_provider)
        self.manager = ControllerManager(self._client(), cloud_provider=provider)

    def _client(self) -> Client:
        return Client(LocalTransport(self.api))

    def _build_kubelets(self, client_factory) -> None:
        import tempfile as _tempfile

        from kubernetes_tpu_torch.kubelet.agent import Kubelet
        from kubernetes_tpu_torch.kubelet.runtime import FakeRuntime

        sandbox = getattr(self.args, "sandbox_runtime", False)
        if sandbox:
            from kubernetes_tpu_torch.kubelet.sandbox_runtime import sandbox_supported

            if not sandbox_supported():
                # Fail loudly: pods silently running UNsandboxed would
                # look isolated while providing nothing.
                raise SystemExit(
                    "--sandbox-runtime unavailable "
                    "(needs root + unshare/nsenter)"
                )
        for i in range(self.args.nodes):
            if sandbox:
                from kubernetes_tpu_torch.kubelet.sandbox_runtime import SandboxRuntime

                root = _tempfile.mkdtemp(prefix=f"ktpu-node-{i}-")
                self._tmp_roots.append(root)
                runtime = SandboxRuntime(root, node_name=f"node-{i}")
            elif self.args.process_runtime:
                from kubernetes_tpu_torch.kubelet.process_runtime import ProcessRuntime

                root = _tempfile.mkdtemp(prefix=f"ktpu-node-{i}-")
                self._tmp_roots.append(root)
                runtime = ProcessRuntime(root, node_name=f"node-{i}")
            else:
                runtime = FakeRuntime()
                root = None
            self.kubelets.append(
                Kubelet(
                    client_factory(),
                    node_name=f"node-{i}",
                    runtime=runtime,
                    root_dir=root,
                    serve_http=True,
                )
            )

    def start(self) -> "LocalCluster":
        self.http.start()
        if self._kubelet_http:
            from kubernetes_tpu_torch.client.rest import HTTPTransport

            self._build_kubelets(lambda: Client(HTTPTransport(self.http.address)))
        for kubelet in self.kubelets:
            kubelet.start()
        self.scheduler_config.start()
        self.scheduler_config.wait_for_sync()
        self.scheduler = self.scheduler_cls(self.scheduler_config).start()
        self.manager.start()
        # kube-proxy (hack/local-up-cluster.sh starts one too). Real
        # portals when we can install VIPs on loopback (root), so
        # service cluster IPs are actually dialable by any process —
        # e.g. the guestbook frontend using REDIS_MASTER_SERVICE_HOST.
        self.proxy = None
        if getattr(self.args, "kube_proxy", True):
            from kubernetes_tpu_torch.proxy.config import ProxyServer

            self.proxy = ProxyServer(
                self._client(), real_portals=True
            ).start()
        self.dns = None
        if getattr(self.args, "cluster_dns", False):
            from kubernetes_tpu_torch.addons import ClusterDNS

            client = self._client()
            self.dns = ClusterDNS(client).start()
            # Only advertise the well-known VIP when something will
            # actually listen there: a real-portal kube-proxy AND a
            # bindable 10.0.0.10:53 (CAP_NET_ADMIN alone doesn't imply
            # low-port bind rights). Otherwise the addon still serves
            # on its own bound port, but a dead kube-dns service must
            # not be published.
            if (
                self.proxy is not None
                and self.proxy.proxier.has_real_portals
                and self._dns_vip_bindable("10.0.0.10", 53)
            ):
                self.dns.publish(client)
                # Containers get the resolver address the reference
                # kubelet would write into resolv.conf.
                for kubelet in self.kubelets:
                    kubelet.runtime.cluster_dns = "10.0.0.10"
            else:
                print(
                    "warning: --cluster-dns without real portals; "
                    f"DNS serves on 127.0.0.1:{self.dns.port} only "
                    "(kube-dns service not published)",
                    file=sys.stderr,
                )
        # Live component health (componentstatuses; the reference
        # master registers etcd + scheduler + controller-manager,
        # pkg/master/master.go getServersToValidate).
        self.api.register_component(
            "etcd-0", lambda: (True, "store serving")
        )
        self.api.register_component("scheduler", self._scheduler_health)
        self.api.register_component(
            "controller-manager", self._manager_health
        )
        # Health plane: retention sampler + burn-rate alert engine
        # (utils/alerts wires the sampler hook; alert state transitions
        # surface as cluster Events through this client). Honors
        # KT_TIMESERIES=0 for processes that must not grow a sampler
        # thread.
        from kubernetes_tpu_torch.utils import alerts

        alerts.ensure_started(client=self._client())
        return self

    @staticmethod
    def _dns_vip_bindable(ip: str, port: int) -> bool:
        """Probe that the kube-dns VIP:port can actually be bound (the
        proxier will do exactly this once the service appears)."""
        import socket

        from kubernetes_tpu_torch.proxy.portal import LoopbackPortals

        portals = LoopbackPortals()
        if not portals.acquire(ip):
            return False
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                s.bind((ip, port))
                return True
            except OSError:
                return False
            finally:
                s.close()
        finally:
            portals.release(ip)

    def _scheduler_health(self):
        sched = self.scheduler
        alive = (
            sched is not None
            and sched._thread is not None
            and sched._thread.is_alive()
        )
        return alive, "ok" if alive else "scheduler loop not running"

    def _manager_health(self):
        running = getattr(self.manager, "running", False)
        n = len(self.manager.controllers)
        if not running:
            return False, "controller manager stopped"
        return n > 0, f"{n} controllers running" if n else "no controllers"

    def stop(self) -> None:
        import shutil

        from kubernetes_tpu_torch.utils import timeseries

        # The sampler is module-global (one per process, like the
        # metrics registry); local-up owns the process, so tearing the
        # cluster down stops it — tests must not leak the thread.
        timeseries.SAMPLER.stop()
        if getattr(self, "dns", None) is not None:
            self.dns.stop()
        if getattr(self, "proxy", None) is not None:
            self.proxy.stop()
        self.manager.stop()
        if self.scheduler is not None:
            self.scheduler.stop()
        for kubelet in self.kubelets:
            kubelet.stop()
            # Kill remaining pod processes before removing their roots.
            for uid in list(kubelet.runtime.list_pods()):
                try:
                    kubelet.runtime.kill_pod(uid)
                except Exception:
                    pass
        self.http.stop()
        for root in self._tmp_roots:
            shutil.rmtree(root, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    cluster = LocalCluster(args).start()
    try:
        print(f"cluster up: apiserver at {cluster.http.address}", flush=True)
        print(f"  python -m kubernetes_tpu_torch.cli --server {cluster.http.address} "
              "get nodes", flush=True)
        from kubernetes_tpu_torch.cmd.daemons import _wait_forever

        _wait_forever()
    finally:
        cluster.stop()
        print("cluster stopped", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
