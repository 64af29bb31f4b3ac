"""The kubelet daemon.

The port's copy of `kubernetes_tpu/kubelet/agent.py`. Reference:
pkg/kubelet/kubelet.go (syncLoop :1657, syncPod :1092), pod_workers.go
(per-pod serialized workers), status_manager.go (apiserver writeback),
prober (liveness/readiness), and node registration/heartbeats
(cmd/kubelet/app/server.go + NodeStatus).

Sources of truth:
- apiserver watch filtered to spec.nodeName == this node (the
  reference's apiserver source, pkg/kubelet/config/apiserver.go);
- optional static-pod manifest dir (file source, config/file.go) —
  mirrored to the apiserver as "<name>-<node>" pods like mirror pods.

Departures from the JAX kubelet:

- Pods, nodes and services are decoded into the whole object model,
  `models/apiobjects.py`: the port's `Client` types pods and nodes with
  the trimmed `models/objects.py`, which has no container statuses,
  probes, volumes, env, addresses or daemon endpoints. The pod informer
  decodes its LIST and watch with it, the heartbeat reads and writes the
  node in wire form (`Client.get_wire`, `Client.update_status_wire`),
  and a mirror pod's owner is read from the wire form. A node written
  back through the trimmed model would lose its addresses and its
  kubelet port, and the apiserver's log and exec relay would have
  nowhere to go.
- A Terminating pod that the server still holds Pending while its
  containers run gets its status written once before the kill
  (`_report_lagging_status`); the JAX kubelet writes none for it.
- The sync pool starts its workers after releasing its lock (JAX's
  starts them under it, a blocking wait the lock sanitizer reports).

The chaos seams (`kubelet.heartbeat.drop`, `kubelet.terminating.stall`;
`utils/faults.py`) and the sanitizer's `kubelet.syncpool` lock sit where
JAX's do.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from typing import Dict, List, Optional

from kubernetes_tpu_torch.client.cache import Informer
from kubernetes_tpu_torch.client.rest import APIError
from kubernetes_tpu_torch.models import serde
from kubernetes_tpu_torch.models.apiobjects import (
    ContainerStatus,
    Node,
    NodeAddress,
    NodeCondition,
    Pod,
    PodCondition,
    Service,
    now_iso,
)
from kubernetes_tpu_torch.models.quantity import parse_quantity
from kubernetes_tpu_torch.kubelet.runtime import ContainerRuntime, FakeRuntime
from kubernetes_tpu_torch.utils import faults, metrics, sanitizer, tracing

_LOG = logging.getLogger("kubernetes_tpu_torch.kubelet")

# Histogram (was a summary): bucketed sync latencies aggregate across
# every kubelet in the fleet, which a per-instance summary can't.
_SYNC_LATENCY = metrics.DEFAULT.histogram(
    "kubelet_sync_pod_latency_seconds", "Pod sync latency", ("node",)
)
_PODS_RUNNING = metrics.DEFAULT.gauge(
    "kubelet_running_pods", "Pods running on this node", ("node",)
)


def _decode_pod(wire: dict) -> Pod:
    return serde.from_wire(Pod, wire)


def _decode_node(wire: dict) -> Node:
    return serde.from_wire(Node, wire)


def _proc_rss(pid: str) -> int:
    """Resident set bytes from /proc (cadvisor-stats analog)."""
    try:
        with open(f"/proc/{int(pid)}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


class _SyncPool:
    """Per-pod serialized sync over a small ELASTIC worker pool.

    The reference dedicates a goroutine per pod (pod_workers.go:91-123);
    goroutines are cheap, Python threads are not — spawning one per pod
    update was measurably expensive at 100 kubelets x 30 pods. The pool
    keeps the same contract: syncs for one pod never overlap (a pod is
    'running' while synced; updates arriving meanwhile coalesce into one
    re-run with the latest spec), different pods sync concurrently.

    Elasticity is the reference's isolation property on a budget: when
    every worker is busy (a slow volume mount, a wedged probe) and more
    work queues, transient workers spawn up to `max_workers`, then
    retire after a few idle seconds — so two stuck pods can't starve
    the other 28 on the node, without carrying a thread per pod."""

    def __init__(self, sync_fn, workers: int = 2, max_workers: int = 16):
        import queue

        self._sync = sync_fn
        self._q: "queue.Queue[Optional[str]]" = queue.Queue()
        self._lock = sanitizer.lock("kubelet.syncpool")
        self._pending: Dict[str, Pod] = {}  # key -> latest un-synced spec
        self._running: set = set()  # keys currently inside sync_fn
        self._max = max_workers
        self._nworkers = 0
        self._idle = 0
        self._stopping = False
        for _ in range(workers):
            self._spawn_locked(transient=False).start()

    def _spawn_locked(self, transient: bool) -> threading.Thread:
        # caller holds self._lock (or init, pre-concurrency) and starts
        # the worker once it has released it: Thread.start waits for the
        # thread to run, a wait the sanitizer reports under a lock (JAX's
        # pool starts it under the lock).
        self._nworkers += 1
        return threading.Thread(
            target=self._worker, args=(transient,), daemon=True
        )

    def update(self, key: str, pod: Pod) -> None:
        spawned = None
        with self._lock:
            if self._stopping:
                return
            queued = key in self._pending
            self._pending[key] = pod
            if queued or key in self._running:
                return  # will be picked up by the queued entry / re-run
            if self._idle == 0 and self._nworkers < self._max:
                spawned = self._spawn_locked(transient=True)
            # Enqueue UNDER the lock: a timing-out transient worker's
            # retire path checks queue emptiness under this same lock,
            # so a key can never land unseen between its last check and
            # its exit (which would strand the pod until some other
            # pod's update spawned a worker).
            self._q.put(key)
        if spawned is not None:
            spawned.start()

    def forget(self, key: str) -> None:
        with self._lock:
            self._pending.pop(key, None)

    def _worker(self, transient: bool) -> None:
        import queue

        while True:
            with self._lock:
                self._idle += 1
            try:
                key = self._q.get(timeout=5.0 if transient else None)
            except queue.Empty:
                # Idle timeout: retire — unless work raced in (update()
                # enqueues under the same lock, so this check is
                # ordered against every put).
                with self._lock:
                    self._idle -= 1
                    if not self._q.empty():
                        continue
                    self._nworkers -= 1
                return
            with self._lock:
                self._idle -= 1
            if key is None:
                with self._lock:
                    self._nworkers -= 1
                return
            with self._lock:
                if key in self._running:
                    # Owned by another worker (duplicate token: forget()
                    # dropped the pending entry, then update() re-enqueued
                    # the same key). Leave _pending intact — the owner's
                    # finally-path sees it and requeues, preserving the
                    # 'syncs for one pod never overlap' contract.
                    pod = None
                else:
                    pod = self._pending.pop(key, None)
                    if pod is not None:
                        self._running.add(key)
            if pod is None:
                continue
            try:
                self._sync(pod)
            except Exception:
                # Crash containment (util.HandleCrash) — with evidence.
                _LOG.exception("pod sync for %s crashed", key)
            finally:
                with self._lock:
                    self._running.discard(key)
                    requeue = key in self._pending
                if requeue:
                    self._q.put(key)

    def stop(self) -> None:
        with self._lock:
            self._stopping = True
            n = self._nworkers
        for _ in range(n):
            self._q.put(None)


class Kubelet:
    def __init__(
        self,
        client,
        node_name: str,
        runtime: Optional[ContainerRuntime] = None,
        cpu: str = "4",
        memory: str = "8Gi",
        max_pods: int = 110,
        labels: Optional[Dict[str, str]] = None,
        heartbeat_period: float = 5.0,
        sync_period: float = 3.0,
        manifest_dir: Optional[str] = None,
        manifest_url: Optional[str] = None,
        root_dir: Optional[str] = None,
        mounter=None,
        serve_http: bool = False,
        http_port: int = 0,
    ):
        self.client = client
        self.node_name = node_name
        self.runtime = runtime or FakeRuntime()
        # HTTP API (reference kubelet port 10250, pkg/kubelet/server.go).
        self.http: Optional[object] = None
        self._serve_http = serve_http
        self._http_port = http_port
        # Volume subsystem: active when a root dir is configured
        # (reference: kubelet --root-dir, default /var/lib/kubelet).
        self.volumes = None
        if root_dir:
            from kubernetes_tpu_torch.volumes import VolumeHost, VolumePluginManager

            self.volumes = VolumePluginManager(
                VolumeHost(
                    root_dir=root_dir,
                    client=client,
                    mounter=mounter,
                    node_name=node_name,
                )
            )
        self.cpu = cpu
        self.memory = memory
        self.max_pods = max_pods
        self.labels = labels or {}
        self.heartbeat_period = heartbeat_period
        self.sync_period = sync_period
        self.manifest_dir = manifest_dir
        self.manifest_url = manifest_url
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._sync_pool = _SyncPool(self._sync_pod, workers=2)
        # Terminating pods this kubelet has acknowledged (uid -> True
        # once the Killing event went out): dedup so the grace window's
        # repeated syncs emit one event, not one per resync tick.
        self._terminating: Dict[str, bool] = {}
        # Last status wire-form successfully WRITTEN per pod uid (the
        # reference's status_manager.go map). Dedup must compare
        # against what we know reached the apiserver — comparing
        # against a locally mutated pod object let one failed write
        # (409 during the bind/status race) suppress every retry.
        self._last_status: Dict[str, dict] = {}
        self._hb_node: Optional[Node] = None  # cached across heartbeats
        self._volumes_mounted: set = set()
        from kubernetes_tpu_torch.kubelet.probes import ProbeTracker

        self._probes = ProbeTracker()
        # Resource managers (container GC / disk / OOM watcher —
        # pkg/kubelet/{container_gc,image_manager,disk_manager,
        # oom_watcher}.go). GC and disk need an artifact root, which
        # only real runtimes have (ProcessRuntime.root).
        from kubernetes_tpu_torch.kubelet.managers import (
            ContainerGC,
            DiskManager,
            OOMWatcher,
        )

        self._oom = OOMWatcher(client, node_name)
        self.disk = None
        self.container_gc = None
        self.image_manager = None
        runtime_root = getattr(self.runtime, "root", None)
        if runtime_root:
            self.disk = DiskManager(runtime_root)
            self.container_gc = ContainerGC(
                runtime_root,
                self.runtime,
                min_age_s=30.0,
                disk=self.disk,
                desired_uids=self._desired_uids,
            )
        # Image GC needs an image substrate, which only runtimes with a
        # store carry (SandboxRuntime.images; reference:
        # image_manager.go against docker's image list).
        if getattr(self.runtime, "images", None) is not None:
            from kubernetes_tpu_torch.kubelet.managers import ImageManager

            self.image_manager = ImageManager(
                self.runtime.images,
                high_bytes=256 * 1024 * 1024,
                low_bytes=192 * 1024 * 1024,
            )
        self.housekeeping_period = 10.0
        self.pods = Informer(
            client,
            "pods",
            field_selector=f"spec.nodeName={node_name}",
            decode=_decode_pod,
            on_add=self._dispatch,
            on_update=self._dispatch,
            on_delete=self._handle_delete,
        )
        # Service informer feeding service-discovery env vars into
        # containers (reference: kubelet.go makeEnvironmentVariables +
        # pkg/kubelet/envvars). Only runtimes that inject env carry the
        # attribute (ProcessRuntime.service_env).
        self.services: Optional[Informer] = None
        if hasattr(self.runtime, "service_env"):
            self.services = Informer(
                client,
                "services",
                decode=lambda w: serde.from_wire(Service, w),
                on_add=self._services_changed,
                on_update=self._services_changed,
                on_delete=self._services_changed,
            )

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "Kubelet":
        if self._serve_http:
            from kubernetes_tpu_torch.kubelet.server import KubeletServer

            self.http = KubeletServer(self, port=self._http_port).start()
        self.register_node()
        if self.services is not None:
            self.services.start()
            self.services.wait_for_sync()
            self._services_changed(None)
        self.pods.start()
        self.pods.wait_for_sync()
        targets = [self._heartbeat_loop, self._resync_loop]
        if self.container_gc is not None:
            targets.append(self._housekeeping_loop)
        for target in targets:
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        if self.manifest_dir:
            t = threading.Thread(target=self._manifest_loop, daemon=True)
            t.start()
            self._threads.append(t)
        if self.manifest_url:
            t = threading.Thread(target=self._manifest_url_loop, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        self._sync_pool.stop()
        self.pods.stop()
        if self.services is not None:
            self.services.stop()
        if self.http is not None:
            self.http.stop()
        for t in self._threads:
            t.join(timeout=2)

    # -- node registration + heartbeat (NodeStatus) -------------------

    def _fill_status(self, node: Node) -> None:
        node.status.conditions = [self._ready_condition()]
        node.status.capacity = {
            "cpu": parse_quantity(self.cpu),
            "memory": parse_quantity(self.memory),
            "pods": parse_quantity(str(self.max_pods)),
        }
        node.status.addresses = [
            NodeAddress(type="InternalIP", address="127.0.0.1")
        ]
        if self.http is not None:
            node.status.daemon_endpoints.kubelet_endpoint.port = self.http.port

    def register_node(self) -> None:
        node = Node()
        node.metadata.name = self.node_name
        node.metadata.labels = dict(self.labels)
        self._fill_status(node)
        try:
            self.client.create("nodes", node)
        except APIError as e:
            if e.code != 409:
                raise
            self._heartbeat()  # already registered: refresh status

    def _ready_condition(self) -> NodeCondition:
        return NodeCondition(
            type="Ready",
            status="True",
            last_heartbeat_time=now_iso(),
            reason="KubeletReady",
            message="kubelet is posting ready status",
        )

    def _heartbeat(self) -> None:
        # One RPC per beat, not two: status PUTs are server-side
        # read-modify-writes (no client resourceVersion CAS), so the
        # node object from the last beat is reusable — the GET is only
        # needed on the first beat or after an error (node deleted /
        # apiserver restarted). At 100 kubelets the get+put pair doubled
        # heartbeat traffic exactly when delayed beats read as death.
        if faults.enabled() and faults.fire(
            faults.KUBELET_HEARTBEAT_DROP, self.node_name
        ):
            return  # chaos seam: a lost beat, not a dead kubelet
        node = self._hb_node
        if node is None:
            try:
                node = _decode_node(self.client.get_wire("nodes", self.node_name))
            except APIError:
                self.register_node()
                return
        self._fill_status(node)
        try:
            self._hb_node = _decode_node(self.client.update_status_wire("nodes", node))
        except APIError:
            self._hb_node = None  # refetch (or re-register) next beat

    def _heartbeat_loop(self) -> None:
        # Phase jitter: a fleet of kubelets started together would
        # otherwise beat in lockstep — at 1000 nodes the synchronized
        # herd of status PUTs convoys on the apiserver (the reference
        # spreads --node-status-update-frequency load the same way).
        import random as _random

        if self._stop.wait(_random.uniform(0, self.heartbeat_period)):
            return
        try:
            self._heartbeat()
        except Exception:
            _LOG.debug("node heartbeat failed; retrying", exc_info=True)
        while not self._stop.wait(self.heartbeat_period):
            try:
                self._heartbeat()
            except Exception:
                _LOG.debug("node heartbeat failed; retrying", exc_info=True)

    def _services_changed(self, _obj) -> None:
        """Recompute the runtime's PER-NAMESPACE service env maps
        (captured by containers at START; churn never restarts running
        ones). Namespaced like the reference (getServiceEnvVarMap
        filters to the pod's namespace) — one global map would leak
        env vars across namespaces and let same-named services in
        different namespaces clobber each other."""
        from kubernetes_tpu_torch.kubelet.envvars import from_services

        try:
            by_ns: Dict[str, list] = {}
            for svc in self.services.store.list():
                by_ns.setdefault(
                    svc.metadata.namespace or "default", []
                ).append(svc)
            self.runtime.service_env = {
                ns: from_services(svcs) for ns, svcs in by_ns.items()
            }
        except Exception:
            # No retry can fix a deterministic recompute bug — at least
            # make it visible instead of freezing env at a stale value.
            import traceback

            print(
                f"kubelet {self.node_name}: service env recompute failed:",
                file=sys.stderr,
            )
            traceback.print_exc()

    def _desired_uids(self) -> set:
        return {
            p.metadata.uid or p.metadata.name for p in self.pods.store.list()
        }

    def _housekeeping_loop(self) -> None:
        """Container GC + image GC + disk reclaim + OOM-dedup prune."""
        while not self._stop.wait(self.housekeeping_period):
            try:
                self.container_gc.gc()
                if self.image_manager is not None:
                    in_use = {
                        c.image
                        for cs in self.runtime.list_pods().values()
                        for c in cs
                    }
                    self.image_manager.gc(in_use)
                self._oom.prune(self.runtime.list_pods())
            except Exception:
                _LOG.exception("housekeeping pass failed")

    # -- HTTP API data (reference /spec + /stats, cadvisor-backed) ----

    def node_spec(self) -> dict:
        """Machine spec (reference GET /spec/, cadvisor MachineInfo)."""
        return {
            "nodeName": self.node_name,
            "capacity": {
                "cpu": self.cpu,
                "memory": self.memory,
                "pods": str(self.max_pods),
            },
            "labels": dict(self.labels),
        }

    def node_stats(self) -> dict:
        """Node + per-pod container stats (reference GET /stats/...;
        process runtimes report real RSS from /proc)."""
        pods = {}
        for uid, containers in self.runtime.list_pods().items():
            stats = []
            for c in containers:
                entry = {
                    "name": c.name,
                    "state": c.state,
                    "restartCount": c.restart_count,
                    "uptimeSeconds": round(
                        max(0.0, time.monotonic() - c.started_at), 3
                    ),
                }
                if c.container_id.startswith("proc://"):
                    entry["rssBytes"] = _proc_rss(c.container_id[7:])
                stats.append(entry)
            pods[uid] = stats
        out = {"nodeName": self.node_name, "pods": pods}
        if self.disk is not None:
            usage = self.disk.usage()
            out["disk"] = {
                "capacityBytes": usage.capacity_bytes,
                "availableBytes": usage.available_bytes,
                "usedFraction": round(usage.used_fraction, 4),
            }
        return out

    # -- pod sync -----------------------------------------------------

    def _key(self, pod: Pod) -> str:
        return f"{pod.metadata.namespace}/{pod.metadata.name}"

    def _dispatch(self, pod: Pod) -> None:
        self._sync_pool.update(self._key(pod), pod)

    def _handle_delete(self, pod: Pod) -> None:
        uid = pod.metadata.uid or pod.metadata.name
        self.runtime.kill_pod(uid)
        if self.volumes is not None:
            try:
                self.volumes.teardown_pod_volumes(uid)
            except Exception:
                # Retried by the resync tick's orphan GC (the uid is no
                # longer desired, and on-disk volume dirs re-surface it
                # via volumes.list_pod_uids) — but a teardown that keeps
                # failing must be visible, not silent.
                _LOG.exception("volume teardown for pod %s failed", uid)
        self._volumes_mounted.discard(uid)
        self._probes.forget(uid + "/")
        self._last_status.pop(uid, None)
        self._terminating.pop(uid, None)
        self._sync_pool.forget(self._key(pod))

    def _resync_loop(self) -> None:
        """Periodic full resync + orphan GC (syncLoop tick). Initial
        phase jitter: see _heartbeat_loop."""
        import random as _random

        if self._stop.wait(_random.uniform(0, self.sync_period)):
            return
        while not self._stop.wait(self.sync_period):
            try:
                pods = self.pods.store.list()
                known_uids = set()
                for pod in pods:
                    known_uids.add(pod.metadata.uid or pod.metadata.name)
                    self._dispatch(pod)
                # Orphan GC over the UNION of runtime pods and on-disk
                # volume dirs: after a kubelet restart the runtime may
                # have forgotten a pod whose volumes still exist.
                orphans = set(self.runtime.list_pods())
                if self.volumes is not None:
                    orphans.update(self.volumes.list_pod_uids())
                for uid in orphans - known_uids:
                    try:
                        self.runtime.kill_pod(uid)
                        if self.volumes is not None:
                            self.volumes.teardown_pod_volumes(uid)
                    except Exception:
                        # One bad orphan must not stall the tick — but
                        # a teardown that fails every pass (wedged
                        # mount, permission rot) needs evidence, not
                        # silence; the next tick retries it anyway.
                        _LOG.exception("orphan teardown for %s failed", uid)
                    self._volumes_mounted.discard(uid)
                _PODS_RUNNING.set(len(pods), node=self.node_name)
            except Exception:
                _LOG.exception("pod resync tick failed")

    def _sync_pod(self, pod: Pod) -> None:
        """One reconciliation of a single pod (kubelet.go:1092), under
        a sync-loop trace so a pod's kubelet-side story lands in the
        same /debug/traces surface as its scheduling."""
        # record_threshold_s: a no-op resync sync (fake runtimes,
        # already-converged pods) finishes in microseconds and runs for
        # EVERY pod EVERY tick — recording those would flood the shared
        # trace ring and evict the scheduling traces. Syncs that did
        # real work (mounts, container starts, status writes) clear
        # 10ms easily and are kept.
        with tracing.trace(
            "kubelet_sync_pod", pod=pod.metadata.name,
            record_threshold_s=0.01,
        ) as sp:
            sp.note(node=self.node_name)
            self._sync_pod_inner(pod)

    @staticmethod
    def _deletion_deadline(pod: Pod) -> Optional[float]:
        """Epoch seconds of the graceful-delete deadline (the apiserver
        stamps deletionTimestamp = delete time + grace)."""
        import calendar

        ts = pod.metadata.deletion_timestamp
        if not ts:
            return None
        try:
            return calendar.timegm(time.strptime(ts, "%Y-%m-%dT%H:%M:%SZ"))
        except ValueError:
            return 0.0  # unparseable stamp: treat as already expired

    def _sync_terminating(self, pod: Pod) -> None:
        """Graceful termination (reference: killPod with grace →
        status-manager force delete). The pod stays Terminating —
        containers running, capacity charged — until the stamped
        deadline, then this kubelet kills it and confirms with a
        grace-0 delete so watchers see exactly one DELETED."""
        uid = pod.metadata.uid or pod.metadata.name
        # Chaos seam: the confirm path stalls (wedged volume teardown,
        # slow runtime kill) — grace handling and the exactly-one-
        # DELETED contract must survive the lag, not race it.
        faults.fire(faults.KUBELET_TERMINATING_STALL, uid)
        if not self._terminating.get(uid):
            self._terminating[uid] = True
            try:
                self.client.record_event(
                    pod, "Killing",
                    f"Stopping pod {pod.metadata.name} "
                    f"(grace {pod.metadata.deletion_grace_period_seconds or 0}s)",
                    source=f"kubelet/{self.node_name}",
                )
            except Exception:
                _LOG.exception("Killing event for %s failed to record", uid)
        deadline = self._deletion_deadline(pod)
        if deadline is not None and time.time() < deadline:
            return  # grace still running; the resync tick re-checks
        self.runtime.kill_pod(uid)
        if self.volumes is not None:
            try:
                self.volumes.teardown_pod_volumes(uid)
            except Exception:
                _LOG.exception("volume teardown for pod %s failed", uid)
        self._volumes_mounted.discard(uid)
        try:
            self.client.delete(
                "pods", pod.metadata.name,
                namespace=pod.metadata.namespace or "default",
                grace_period_seconds=0,
            )
        except APIError as e:
            if e.code != 404:  # already gone is success
                _LOG.warning(
                    "force delete of terminated pod %s failed: %s", uid, e
                )

    def _sync_pod_inner(self, pod: Pod) -> None:
        import copy as _copy

        start = time.monotonic()
        if pod.metadata.deletion_timestamp:
            self._report_lagging_status(pod)
            self._sync_terminating(pod)
            return
        if pod.status.phase in ("Succeeded", "Failed"):
            return
        uid = pod.metadata.uid or pod.metadata.name
        # Work on a private status: the incoming pod is the informer
        # store's own object (server state) and must not carry local
        # mutations — a locally flipped phase would poison both the
        # terminal-phase early-return above and status dedup below.
        pod = _copy.copy(pod)
        pod.status = _copy.deepcopy(pod.status)

        # Volumes first (kubelet.go:1135 mountExternalVolumes): a pod
        # whose volumes can't materialize must not start containers.
        # Mounted once per pod instance — re-running every resync tick
        # would hammer the apiserver (secret/claim GETs) and rewrite
        # secret files non-atomically under running containers.
        if (
            self.volumes is not None
            and pod.spec.volumes
            and uid not in self._volumes_mounted
        ):
            try:
                self.volumes.mount_pod_volumes(pod)
            except Exception:
                _LOG.exception("volume mount for pod %s failed", uid)
                return  # retried by the resync tick
            self._volumes_mounted.add(uid)

        # Probes may demand restarts before the runtime sync.
        with tracing.span("probes"):
            self._run_probes(pod, uid)

        with tracing.span("runtime_sync"):
            containers = self.runtime.sync_pod(pod)
        for c in containers:
            self._probes.note_started(f"{uid}/{c.name}", c.started_at)
        self._oom.observe(pod, containers)

        # Restart policy (dockertools/manager.go:1287+), decided PER
        # CONTAINER: Always restarts any exited container; OnFailure
        # only those that exited nonzero (a completed exit-0 workload
        # container must stay completed).
        policy = pod.spec.restart_policy
        restarted = False
        for c in containers:
            if c.state != "exited":
                continue
            if policy == "Always" or (policy == "OnFailure" and c.exit_code != 0):
                self.runtime.restart_container(uid, c.name)
                restarted = True
        if restarted:
            containers = self.runtime.sync_pod(pod)  # refresh statuses
        self._write_status(pod, uid, containers)
        _SYNC_LATENCY.observe(time.monotonic() - start, node=self.node_name)

    def _report_lagging_status(self, pod: Pod) -> None:
        """A Terminating pod keeps its containers through its grace
        period. When the server still holds it Pending while they run
        (its Running write was lost to an apiserver crash, and the delete
        came before the next sync), the status is written once before the
        kill, so the server never shows a pod that ran as one that never
        started. Departure from the JAX kubelet, which writes no status
        for a Terminating pod (found by the soak's apiserver_restart
        epoch: ROADMAP queue 3)."""
        import copy as _copy

        if pod.status.phase != "Pending":
            return
        uid = pod.metadata.uid or pod.metadata.name
        containers = self.runtime.list_pods().get(uid) or []
        if not any(c.state == "running" for c in containers):
            return
        pod = _copy.copy(pod)
        pod.status = _copy.deepcopy(pod.status)
        self._write_status(pod, uid, containers)

    def _write_status(self, pod: Pod, uid: str, containers) -> None:
        """The pod's status from its containers, written unless the
        server or the last successful write already holds it. `pod` is a
        private copy (its status is changed here)."""
        phase = self._pod_phase(pod, containers)
        statuses = [
            ContainerStatus(
                name=c.name,
                state={c.state: {}},
                ready=self._container_ready(uid, c.name, c.state),
                restart_count=c.restart_count,
                image=c.image,
                container_id=c.container_id,
            )
            for c in containers
        ]
        ready = all(s.ready for s in statuses) and bool(statuses)
        old_wire = serde.to_wire(pod.status)
        pod.status.phase = phase
        pod.status.host_ip = "127.0.0.1"
        # Host-network runtimes (ProcessRuntime) expose containers on
        # the host's own address, so that IS the pod IP — the reference
        # kubelet reports the node IP for HostNetwork pods. Sandboxed
        # fakes keep the deterministic synthetic IP.
        pod.status.pod_ip = (
            getattr(self.runtime, "host_network_ip", "") or self._pod_ip(uid)
        )
        if not pod.status.start_time:
            pod.status.start_time = now_iso()
        # Ready-transition timestamping (telemetry plane): stamp
        # lastTransitionTime when the condition FLIPS and carry the
        # prior stamp when it doesn't — the Running/Ready instant must
        # survive every later status rewrite, and re-stamping each sync
        # would defeat status dedup below (a self-sustaining write
        # loop). pod.status still holds the server's view here (the
        # private copy above), so prev_ready is the stored condition.
        ready_str = "True" if ready else "False"
        prev_ready = next(
            (c for c in pod.status.conditions or () if c.type == "Ready"),
            None,
        )
        transition = (
            prev_ready.last_transition_time
            if prev_ready is not None
            and prev_ready.status == ready_str
            and prev_ready.last_transition_time
            else now_iso()
        )
        pod.status.conditions = [
            PodCondition(
                type="Ready", status=ready_str,
                last_transition_time=transition,
            )
        ]
        pod.status.container_statuses = statuses
        # Status dedup (reference: status_manager.go) — an unchanged
        # write would bounce back through the watch and re-trigger this
        # sync, a self-sustaining hot loop. Two comparisons: against
        # the server's view (old_wire, from the informer object) and
        # against the last write KNOWN to have succeeded — a failed
        # write leaves no record, so the next resync tick retries
        # instead of silently stranding the pod at its server phase.
        new_wire = serde.to_wire(pod.status)
        if new_wire == old_wire:
            self._last_status[uid] = new_wire  # in sync with the server
        elif self._last_status.get(uid) != new_wire:
            try:
                with tracing.span("status_write"):
                    self.client.update_status(
                        "pods", pod,
                        namespace=pod.metadata.namespace or "default",
                    )
                self._last_status[uid] = new_wire
            except APIError:
                self._last_status.pop(uid, None)  # retry next resync

    def _pod_ip(self, uid: str) -> str:
        # Deterministic fake pod IP from the uid (dataplane tests use it).
        h = abs(hash(uid))
        return f"10.{(h >> 16) % 256}.{(h >> 8) % 256}.{h % 254 + 1}"

    def _pod_phase(self, pod: Pod, containers) -> str:
        """Phase derivation (reference: kubelet.go GetPodStatus logic)."""
        if not containers:
            return "Pending"
        states = [c.state for c in containers]
        codes = [c.exit_code for c in containers]
        if all(s == "exited" for s in states):
            if pod.spec.restart_policy == "Never":
                return "Failed" if any(codes) else "Succeeded"
            if pod.spec.restart_policy == "OnFailure" and not any(codes):
                return "Succeeded"
        if any(s == "running" for s in states):
            return "Running"
        return "Pending"

    # -- probes -------------------------------------------------------

    def _run_probes(self, pod: Pod, uid: str) -> None:
        """Liveness + readiness probes, all three transports
        (exec/HTTP/TCP — pkg/probe/, prober/prober.go). Liveness
        failures past the threshold kill the container so restart
        policy brings it back; readiness failures only flip the
        container un-ready (and thus the pod out of Endpoints)."""
        from kubernetes_tpu_torch.kubelet.probes import run_probe

        for c in pod.spec.containers:
            key = f"{uid}/{c.name}"
            live = c.liveness_probe
            if live is not None and not self._probes.in_initial_delay(key, live):
                healthy = run_probe(live, pod, c.name, self.runtime)
                if self._probes.liveness(key, healthy):
                    if hasattr(self.runtime, "fail_container"):
                        self.runtime.fail_container(uid, c.name, exit_code=137)
                    self.client.record_event(
                        pod, "Unhealthy",
                        f"Liveness probe failed for {c.name}; restarting",
                        source=f"kubelet/{self.node_name}",
                    )
            readiness = c.readiness_probe
            if readiness is not None:
                if self._probes.in_initial_delay(key, readiness):
                    # Not probed yet -> not ready (readiness defaults
                    # to failure until the first success).
                    if self._probes.ready(key) is None:
                        self._probes.set_ready(key, False)
                else:
                    self._probes.set_ready(
                        key, run_probe(readiness, pod, c.name, self.runtime)
                    )

    def _container_ready(self, uid: str, name: str, state: str) -> bool:
        """running AND (no readiness probe, or latest verdict true)."""
        if state != "running":
            return False
        verdict = self._probes.ready(f"{uid}/{name}")
        return True if verdict is None else verdict

    # -- static pods (file source, config/file.go) --------------------

    _STATIC_SOURCE_ANNOTATION = "kubernetes-tpu.io/static-source"

    def _apply_static(
        self, applied: Dict[str, tuple], key: str, content: str, source: str
    ) -> None:
        """Apply one static-pod manifest (by source key) as a mirror
        pod; edits replace, unchanged content no-ops, failures retry
        next tick (reference: config/{file,http}.go + mirror pods).

        Mirrors are annotated with their SOURCE: with both a manifest
        dir and a manifest URL configured, a same-named pod must not be
        cross-claimed through the 409 branch, or one source's removal
        would delete a mirror the other source then never recreates."""
        try:
            wire = json.loads(content)
        except json.JSONDecodeError:
            return
        name = wire.get("metadata", {}).get("name", "")
        if not name:
            return
        prev = applied.get(key)
        if prev is not None and prev[0] == content:
            return  # unchanged
        mirror = f"{name}-{self.node_name}"
        ns = wire.get("metadata", {}).get("namespace", "default")
        wire["metadata"]["name"] = mirror
        wire["metadata"].setdefault("annotations", {})[
            self._STATIC_SOURCE_ANNOTATION
        ] = source
        wire.setdefault("spec", {})["nodeName"] = self.node_name
        try:
            if prev is not None:
                # Edited: replace the mirror pod. The old applied entry
                # is dropped FIRST — if the new create then fails, a
                # revert to the previous content must not hit the
                # 'unchanged' early-return and strand the pod.
                applied.pop(key, None)
                try:
                    self.client.delete("pods", prev[1], namespace=prev[2])
                except APIError:
                    pass
            self.client.create("pods", wire, namespace=ns)
            applied[key] = (content, mirror, ns)
        except APIError as e:
            if e.code == 409:
                # Adopt our OWN previous mirror (kubelet restart).
                # Anything else — another source's mirror, or an
                # annotation-less user pod that happens to collide with
                # the mirror name — stays theirs: adopting it would let
                # a later manifest edit DELETE a pod we never created.
                try:
                    existing = self.client.get_wire("pods", mirror, namespace=ns)
                    owner = (existing.get("metadata", {}).get("annotations") or {}).get(
                        self._STATIC_SOURCE_ANNOTATION
                    )
                except APIError:
                    return
                if owner == source:
                    applied[key] = (content, mirror, ns)

    def _remove_static(self, applied: Dict[str, tuple], key: str) -> None:
        _, mirror, ns = applied.pop(key)
        try:
            self.client.delete("pods", mirror, namespace=ns)
        except APIError:
            pass

    def _manifest_loop(self) -> None:
        """Static-pod file source (reference: config/file.go)."""
        applied: Dict[str, tuple] = {}
        while not self._stop.wait(2.0):
            try:
                files = {
                    f for f in os.listdir(self.manifest_dir) if f.endswith(".json")
                }
            except OSError:
                continue
            # Removed manifests: delete their mirror pods.
            for fname in list(applied):
                if fname not in files:
                    self._remove_static(applied, fname)
            for fname in sorted(files):
                path = os.path.join(self.manifest_dir, fname)
                try:
                    with open(path) as f:
                        content = f.read()
                except OSError:
                    continue
                self._apply_static(applied, fname, content, source="file")

    def _manifest_url_loop(self) -> None:
        """Static-pod URL source (reference: config/http.go — the
        kubelet polls --manifest-url for a pod manifest or a list)."""
        import urllib.error
        import urllib.request

        applied: Dict[str, tuple] = {}
        while not self._stop.wait(2.0):
            try:
                with urllib.request.urlopen(self.manifest_url, timeout=10) as r:
                    body = r.read().decode(errors="replace")
            except (urllib.error.URLError, OSError):
                continue  # unreachable: keep the last applied state
            try:
                wire = json.loads(body)
            except json.JSONDecodeError:
                continue
            # Shape-validate before acting: a parseable-but-wrong body
            # ({}, null, an error JSON) must KEEP the last good config
            # like a fetch failure does — only a well-formed Pod or
            # PodList may add/remove static pods. An explicit empty
            # PodList legitimately clears them.
            if not isinstance(wire, dict):
                continue
            if wire.get("kind", "").endswith("List"):
                docs = [d for d in wire.get("items", []) if isinstance(d, dict)]
            elif wire.get("kind") == "Pod":
                docs = [wire]
            else:
                continue
            keys = set()
            for doc in docs:
                meta = doc.get("metadata", {})
                name = meta.get("name", "")
                if not name:
                    continue
                # Namespace in the key: same-named pods in different
                # namespaces are distinct and must not thrash.
                key = f"url:{meta.get('namespace', 'default')}/{name}"
                if key in keys:
                    continue  # duplicate entry in one payload: first wins
                keys.add(key)
                self._apply_static(
                    applied, key, json.dumps(doc, sort_keys=True), source="url"
                )
            for key in list(applied):
                if key not in keys:
                    self._remove_static(applied, key)
