"""Cluster monitoring addon: the heapster analog.

Reference: cluster/addons/cluster-monitoring — heapster scrapes every
node's cAdvisor through the kubelet, aggregates node/pod resource
series, and serves a REST model that dashboards (InfluxDB/Grafana in
the reference) consume. Here one small daemon plays heapster's role:

- a node Informer tracks the fleet; every `resolution` seconds each
  node's kubelet /stats is pulled THROUGH the apiserver node proxy
  (the same path `ktctl top` reads once — this keeps history);
- per-node and per-pod time series are kept in bounded ring buffers
  (window seconds of history);
- a heapster-model-shaped REST API serves them:
    GET /api/v1/model/nodes
    GET /api/v1/model/nodes/{node}/metrics
    GET /api/v1/model/nodes/{node}/metrics/{metric}
    GET /api/v1/model/namespaces/{ns}/pods
    GET /api/v1/model/namespaces/{ns}/pods/{pod}/metrics/{metric}
  each metric endpoint returning {"metrics": [{"timestamp", "value"}],
  "latestTimestamp"} like heapster's model API;
- publish() registers the monitoring-heapster Service + Endpoints in
  kube-system (like the reference addon's service manifest), so
  consumers discover it by name.

Node metrics: pods, containers, memory_rss_bytes, disk_used_fraction.
Pod metrics: memory_rss_bytes, restarts, uptime_seconds.

The port's copy of `kubernetes_tpu/addons/monitoring.py`. Nodes and
pods are decoded into the whole model (`models/apiobjects.py`);
`publish` catches the client's `APIError`.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Deque, Dict, Optional, Tuple
from urllib.parse import urlparse

from kubernetes_tpu_torch.client.cache import Informer
from kubernetes_tpu_torch.client.rest import APIError
from kubernetes_tpu_torch.models import serde
from kubernetes_tpu_torch.models.apiobjects import Node, Pod

NODE_METRICS = ("pods", "containers", "memory_rss_bytes", "disk_used_fraction")
POD_METRICS = ("memory_rss_bytes", "restarts", "uptime_seconds")


def _iso(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts))


class _Series:
    """Bounded (timestamp, value) ring."""

    def __init__(self, window: float, resolution: float):
        self.points: Deque[Tuple[float, float]] = deque(
            maxlen=max(2, int(window / max(resolution, 0.1)))
        )

    def add(self, ts: float, value: float) -> None:
        self.points.append((ts, value))

    def render(self) -> dict:
        pts = [
            {"timestamp": _iso(t), "value": v} for t, v in self.points
        ]
        return {
            "metrics": pts,
            "latestTimestamp": pts[-1]["timestamp"] if pts else "",
        }


class ClusterMonitor:
    def __init__(
        self,
        client,
        server_url: str,
        resolution: float = 5.0,
        window: float = 600.0,
        port: int = 0,
        host: str = "127.0.0.1",
    ):
        self.client = client
        self.server_url = server_url.rstrip("/")
        self.resolution = resolution
        self.window = window
        # Deletion hooks prune the series map: under pod churn every
        # revision mints new names, and without pruning both memory
        # and the model listings grow forever (heapster expires stale
        # entries the same way).
        self.nodes = Informer(
            client, "nodes",
            decode=lambda w: serde.from_wire(Node, w),
            on_delete=lambda n: self._prune("node", n.metadata.name),
        )
        self.pods = Informer(
            client, "pods",
            decode=lambda w: serde.from_wire(Pod, w),
            on_delete=lambda p: self._prune(
                "pod", f"{p.metadata.namespace}/{p.metadata.name}"
            ),
        )
        self._lock = threading.Lock()
        # (scope, key, metric) -> _Series; scope "node" keys by node
        # name, scope "pod" keys by "namespace/name".
        self._series: Dict[Tuple[str, str, str], _Series] = {}
        self._tombstones: Dict[Tuple[str, str], float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        monitor = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *a):  # noqa: N802
                pass

            def do_GET(self):  # noqa: N802
                try:
                    code, body = monitor._serve(urlparse(self.path).path)
                except Exception as e:
                    code, body = 500, {"error": str(e)}
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True

    # -- scraping -----------------------------------------------------

    def _scrape_node(self, name: str) -> None:
        url = f"{self.server_url}/api/v1/nodes/{name}/proxy/stats"
        with urllib.request.urlopen(url, timeout=5) as resp:
            stats = json.loads(resp.read())
        now = time.time()  # per-scrape stamp, not round-start
        pods = stats.get("pods", {})
        containers = sum(len(cs) for cs in pods.values())
        rss = sum(
            c.get("rssBytes", 0) for cs in pods.values() for c in cs
        )
        disk = stats.get("disk", {}).get("usedFraction", 0.0)
        self._add("node", name, "pods", now, len(pods))
        self._add("node", name, "containers", now, containers)
        self._add("node", name, "memory_rss_bytes", now, rss)
        self._add("node", name, "disk_used_fraction", now, disk)
        # Pod attribution: stats key by uid; the pod cache maps uids to
        # namespace/name (heapster does the same join via the API).
        by_uid = {
            p.metadata.uid: p
            for p in self.pods.store.list()
            if p.metadata.uid
        }
        for uid, cs in pods.items():
            pod = by_uid.get(uid)
            if pod is None:
                continue
            key = f"{pod.metadata.namespace}/{pod.metadata.name}"
            self._add(
                "pod", key, "memory_rss_bytes", now,
                sum(c.get("rssBytes", 0) for c in cs),
            )
            self._add(
                "pod", key, "restarts", now,
                sum(c.get("restartCount", 0) for c in cs),
            )
            self._add(
                "pod", key, "uptime_seconds", now,
                max((c.get("uptimeSeconds", 0) for c in cs), default=0),
            )

    def _prune(self, scope: str, key: str) -> None:
        with self._lock:
            for k in [
                k for k in self._series if k[0] == scope and k[1] == key
            ]:
                del self._series[k]
            # Tombstone: an in-flight scrape that joined against the
            # pre-delete pod cache must not resurrect the series after
            # this one-and-only prune (the DELETE event never refires).
            now = time.time()
            self._tombstones[(scope, key)] = now
            # Sweep expired tombstones here (deletes are the only
            # source of growth): under revision churn names never
            # return, so _add's rebirth branch would never collect
            # them and the map would grow forever.
            horizon = now - 2 * self.resolution
            for k in [k for k, t in self._tombstones.items() if t < horizon]:
                del self._tombstones[k]

    def _add(self, scope: str, key: str, metric: str, ts: float, v: float):
        with self._lock:
            dead = self._tombstones.get((scope, key))
            if dead is not None:
                if ts <= dead + 2 * self.resolution:
                    return  # stale in-flight scrape of a deleted object
                del self._tombstones[(scope, key)]  # genuinely reborn
            s = self._series.get((scope, key, metric))
            if s is None:
                s = self._series[(scope, key, metric)] = _Series(
                    self.window, self.resolution
                )
            s.add(ts, float(v))

    def _loop(self) -> None:
        # Scrapes run in parallel: one dead kubelet must not stall the
        # whole round by its timeout (sequential polling of N nodes
        # with K down costs K x 5s per round and gaps every series).
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=8) as pool:
            while not self._stop.is_set():
                futures = [
                    pool.submit(self._scrape_node, node.metadata.name)
                    for node in self.nodes.store.list()
                ]
                for f in futures:
                    try:
                        f.result(timeout=10)
                    except Exception:
                        pass  # node gone / kubelet down: skip this round
                self._stop.wait(self.resolution)

    # -- model API ----------------------------------------------------

    def _serve(self, path: str) -> Tuple[int, object]:
        parts = tuple(p for p in path.split("/") if p)
        if parts == ("healthz",):
            return 200, {"ok": True}
        if parts[:3] != ("api", "v1", "model"):
            return 404, {"error": "try /api/v1/model/..."}
        rest = parts[3:]
        with self._lock:
            if rest == ("nodes",):
                names = sorted(
                    {k for s, k, _m in self._series if s == "node"}
                )
                return 200, {"items": names}
            if len(rest) >= 2 and rest[0] == "nodes":
                node = rest[1]
                if rest[2:] == ("metrics",) or not rest[2:]:
                    return 200, {"items": list(NODE_METRICS)}
                if len(rest) == 4 and rest[2] == "metrics":
                    s = self._series.get(("node", node, rest[3]))
                    if s is None:
                        return 404, {"error": f"no series {rest[3]!r} for {node!r}"}
                    return 200, s.render()
            if len(rest) >= 3 and rest[0] == "namespaces" and rest[2] == "pods":
                ns = rest[1]
                if len(rest) == 3:
                    pods = sorted(
                        k.split("/", 1)[1]
                        for s, k, _m in self._series
                        if s == "pod" and k.startswith(ns + "/")
                    )
                    return 200, {"items": sorted(set(pods))}
                if len(rest) == 6 and rest[4] == "metrics":
                    s = self._series.get(("pod", f"{ns}/{rest[3]}", rest[5]))
                    if s is None:
                        return 404, {"error": "no such series"}
                    return 200, s.render()
                if len(rest) == 5 and rest[4] == "metrics":
                    return 200, {"items": list(POD_METRICS)}
        return 404, {"error": f"unknown model path {path!r}"}

    # -- lifecycle ----------------------------------------------------

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "ClusterMonitor":
        self.nodes.start()
        self.pods.start()
        self.nodes.wait_for_sync(10)
        self.pods.wait_for_sync(10)
        threading.Thread(
            target=self.httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            daemon=True,
        ).start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.nodes.stop()
        self.pods.stop()
        if self._thread:
            self._thread.join(timeout=5)

    def publish(
        self,
        client,
        cluster_ip: str = "10.0.0.11",
        namespace: str = "kube-system",
        host: str = "127.0.0.1",
    ) -> None:
        """Register monitoring-heapster Service + Endpoints (the
        reference addon's manifests, cluster/addons/cluster-monitoring)."""
        svc = {
            "kind": "Service",
            "apiVersion": "v1",
            "metadata": {
                "name": "monitoring-heapster",
                "namespace": namespace,
                "labels": {"kubernetes.io/cluster-service": "true"},
            },
            "spec": {
                "clusterIP": cluster_ip,
                "ports": [{"port": 80, "protocol": "TCP"}],
            },
        }
        try:
            client.create("services", svc, namespace=namespace)
        except APIError as e:
            if e.code != 409:
                raise
        ep = {
            "kind": "Endpoints",
            "apiVersion": "v1",
            "metadata": {
                "name": "monitoring-heapster", "namespace": namespace,
            },
            "subsets": [
                {
                    "addresses": [{"ip": host}],
                    "ports": [{"port": self.port, "protocol": "TCP"}],
                }
            ],
        }
        try:
            client.create("endpoints", ep, namespace=namespace)
        except APIError as e:
            if e.code != 409:
                raise
            client.update("endpoints", ep, namespace=namespace)
