"""Addon runner: DNS + monitoring as a standalone process.

Reference: cluster addons run as cluster workloads deployed by
cluster/addons manifests; here (no container images) they run as one
daemon process per cluster, started by cmd/clusterup.py or by hand:

    python -m kubernetes_tpu_torch.addons --server http://master:8080 \\
        --dns --monitoring --publish

The port's copy of `kubernetes_tpu/addons/__main__.py`, with its flags
and output; cmd/clusterup.py starts it for an inventory's addons.
"""

from __future__ import annotations

import argparse
import signal
import threading


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu-addons")
    p.add_argument("--server", "-s", default="http://127.0.0.1:8080")
    p.add_argument("--dns", action="store_true")
    p.add_argument("--dns-ip", default="10.0.0.10")
    p.add_argument("--dns-port", type=int, default=0)
    p.add_argument("--monitoring", action="store_true")
    p.add_argument("--monitoring-ip", default="10.0.0.11")
    p.add_argument("--monitoring-port", type=int, default=0)
    p.add_argument(
        "--publish", action="store_true",
        help="register kube-dns / monitoring-heapster Services",
    )
    p.add_argument(
        "--endpoint-host", default="127.0.0.1",
        help="the address OTHER hosts reach this addon process at "
        "(published in the Services' Endpoints; loopback only works "
        "on single-host clusters)",
    )
    args = p.parse_args(argv)

    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport

    def client():
        return Client(HTTPTransport(args.server))

    daemons = []
    if args.dns:
        from kubernetes_tpu_torch.addons.dns import ClusterDNS

        dns = ClusterDNS(client(), port=args.dns_port).start()
        if args.publish:
            dns.publish(
                client(), cluster_ip=args.dns_ip, host=args.endpoint_host
            )
        daemons.append(dns)
        print(f"dns serving on udp port {dns.port}")
    if args.monitoring:
        from kubernetes_tpu_torch.addons.monitoring import ClusterMonitor

        mon = ClusterMonitor(
            client(), args.server, port=args.monitoring_port
        ).start()
        if args.publish:
            mon.publish(
                client(),
                cluster_ip=args.monitoring_ip,
                host=args.endpoint_host,
            )
        daemons.append(mon)
        print(f"monitoring model api on port {mon.port}")
    if not daemons:
        p.error("nothing to run: pass --dns and/or --monitoring")

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    for d in daemons:
        d.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
