"""Hollow-node soak harness: the full API→solve→bind→kubelet loop under
a deterministic fault schedule.

Reference shape: kubemark hollow nodes (real kubelets over a no-op
container runtime) driving the real control plane, crossed with a
Jepsen-style seeded fault schedule. Everything here is REAL code under
test — the durable kvstore (WAL + snapshots on a data dir), the
apiserver with its watch cache, the incremental micro-tick scheduler,
and a fleet of genuine ``Kubelet`` agents with ``FakeRuntime`` — only
the containers are hollow. Faults come from the registered sites in
``kubernetes_tpu_torch/utils/faults.py`` plus two process-level moves the
registry can't express: an apiserver "kill -9" (``KVStore.crash()`` +
replay into a fresh store/APIServer on the same data dir) and an abrupt
scheduler-daemon kill (queued commits dropped, no flush — the fresh
daemon must rebuild its SolverSession from LIST+watch and converge).

After every fault epoch an invariant checker asserts the contracts the
test suite defines on the happy path:

- **replay consistency**: kvstore LIST == the watch-derived mirror
  (no pod lost or duplicated across WAL replay / re-lists);
- **bind immutability**: a pod's nodeName never changes once set
  (no double-bind across daemon restarts — the server-side bind guard,
  observed end to end);
- **gang all-or-nothing**: no PodGroup sits half-bound;
- **exactly-one-DELETED**: no (key, uid) ever sees two DELETED events;
- **nominations recovered or expired**: preemptors holding a
  nomination eventually bind (or their nomination ages out and they
  re-solve) — including across a daemon restart that lost the
  nomination table;
- **SLO series advancing**: the lifecycle SLI milestones
  (decision/bound/running) kept counting through every fault;
- **alert oracle**: fault epochs declare the burn-rate alert rules
  they must fire (``expected_alerts`` in the schedule); the checker
  asserts each one transitioned to ``firing`` during its epoch and
  that every alert resolved by end of run. The engine runs on
  compressed clocks (``SOAK_ALERT_SCALE``) with drill-tuned
  thresholds, exercising the same rule/state-machine code production
  runs. Fault epochs with no declared alerts are reported in the
  artifact as coverage gaps (not failures).

Determinism: the fault *schedule* — epoch order, armed rule parameters,
wave sizes — is a pure function of ``--seed`` (``build_schedule``), and
each fault site fires on a per-site seeded sequence (utils/faults.py),
so a rerun with the same seed arms the same timeline. The artifact
records both the schedule and the realized per-site firing log.

Usage::

    python -m kubernetes_tpu_torch.soak --nodes 1000 --seed 7     # full default schedule
    python -m kubernetes_tpu_torch.soak --nodes 200 --seed 7 \
        --epochs baseline,apiserver_restart,daemon_restart_mid_gang   # CI smoke
    python -m kubernetes_tpu_torch.soak --nodes 6 --seed 11 --device cpu \
        --no-fsync --epochs baseline,apiserver_restart    # the plain path, no card

Exit status 0 iff the run completed with ZERO invariant violations.

The port's copy of the JAX package's soak harness (`tools/soak.py`), on
the port's modules: the same 11 ``EPOCHS``, ``build_schedule`` (entry
for entry the JAX one's for a seed), the ``InvariantChecker``, the
alert oracle and the artifact's keys. Departures:

- ``--device`` (default ``cuda``) is where the incremental daemon (K1),
  the descheduler and the autoscaler (K2, the capacity sample) run;
  with ``cuda`` and no card, ``run_soak`` raises before anything
  starts. The warm standby of ``leader_kill_each_tier`` builds its
  daemon on the same device.
- The checks read pods in wire form (``Client.list_wire``): the port's
  trimmed pod model has no ``nominatedNodeName``, which the
  nominations invariant reads.
- The restartable transport hands each call to a ``LocalTransport``
  over the live apiserver, which raises the client's ``APIError``
  (the class the port's components catch); so does its 503 while the
  apiserver is down.
"""

from __future__ import annotations

import argparse
import json
import queue as _queue
import random
import shutil
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch import DeviceLike, default_device
from kubernetes_tpu_torch.client.cache import Reflector, ThreadSafeStore
from kubernetes_tpu_torch.client.rest import APIError, Client, LocalTransport, Transport
from kubernetes_tpu_torch.controllers.autoscaler import Autoscaler
from kubernetes_tpu_torch.controllers.descheduler import Descheduler
from kubernetes_tpu_torch.kubelet.agent import Kubelet
from kubernetes_tpu_torch.kubelet.runtime import FakeRuntime
from kubernetes_tpu_torch.models.objects import (
    POD_GROUP_LABEL,
    REBALANCE_DEST_ANNOTATION,
    REBALANCE_JOURNAL_LABEL,
)
from kubernetes_tpu_torch.scheduler.daemon import (
    IncrementalBatchScheduler,
    SchedulerConfig,
)
from kubernetes_tpu_torch.scheduler.standby import WarmStandbyScheduler
from kubernetes_tpu_torch.server.api import APIServer
from kubernetes_tpu_torch.store.kvstore import KVStore
from kubernetes_tpu_torch.store.replication import (
    FollowerReplica,
    LocalLink,
    ReplicationHub,
)
from kubernetes_tpu_torch.utils import alerts as alertmod
from kubernetes_tpu_torch.utils import capacity as capmod
from kubernetes_tpu_torch.utils import faults, sli, tracing
from kubernetes_tpu_torch.utils import timeseries as tsmod

#: Epoch registry order — the full default schedule. build_schedule
#: derives per-epoch parameters from the seed; the order is fixed so
#: early epochs warm the cluster the later ones stress.
EPOCHS = (
    "baseline",
    "watch_drops",
    "wal_fsync",
    "apiserver_restart",
    "daemon_restart_mid_gang",
    "preemption_storm",
    "defrag_churn",
    "defrag_daemon_crash",
    "pool_elastic",
    "leader_kill_each_tier",
    "final",
)

#: Alert-engine clock compression for the run: 1h/5m burn windows
#: become 6s/0.5s, the 60s hold-down 0.1s, the 120s hysteresis 0.2s —
#: the soak exercises the production state machine, not production
#: patience. Short windows must stay a few sampler beats wide
#: (ALERT_SAMPLE_S below) or windowed rates degrade to no-data.
SOAK_ALERT_SCALE = 1.0 / 600.0

#: Retention sampler cadence during the soak (seconds).
ALERT_SAMPLE_S = 0.25


def _soak_alert_rules() -> tuple:
    """DEFAULT_RULES with drill-tuned thresholds: the fault schedule's
    storms are small by production standards (a dozen watch drops, a
    few-percent fragmentation score), so the drill lowers the two
    oracle'd thresholds to levels the armed faults must cross while
    keeping every rule's kind, windows, and state machine intact."""
    import dataclasses

    drill = {
        # ~1 drop per fast-long window trips it (prod: 0.02/s budget).
        "watch_drop_storm": 0.005,
        # Between the fleet's ambient windowed p99 (measured ~0.010
        # clean, ~0.016 right after a defrag consolidates) and the
        # fragmenting fill's score (~0.037): fires only while the
        # shard pattern holds, resolves once the descheduler pairs
        # the fillers up and the windows drain.
        "fragmentation_burn": 0.02,
    }
    return tuple(
        dataclasses.replace(r, threshold=drill[r.name])
        if r.name in drill else r
        for r in alertmod.DEFAULT_RULES
    )


# -- wire helpers (mirror objects arrive typed from LIST, wire dicts
# -- from the watch stream; both shapes answer the same questions) -----


def _meta(obj) -> Tuple[str, str, str]:
    """(namespace-or-default, name, uid) over wire dicts or typed pods."""
    if isinstance(obj, dict):
        m = obj.get("metadata", {})
        return m.get("namespace") or "default", m.get("name", ""), m.get("uid", "")
    m = obj.metadata
    return m.namespace or "default", m.name, m.uid


def _pod_key(obj) -> str:
    ns, name, _ = _meta(obj)
    return f"{ns}/{name}"


def _node_of(obj) -> str:
    if isinstance(obj, dict):
        return obj.get("spec", {}).get("nodeName", "") or ""
    return obj.spec.node_name or ""


def _terminating(obj) -> bool:
    if isinstance(obj, dict):
        return bool(obj.get("metadata", {}).get("deletionTimestamp"))
    return bool(obj.metadata.deletion_timestamp)


def _nominated(obj) -> str:
    if isinstance(obj, dict):
        return obj.get("status", {}).get("nominatedNodeName", "") or ""
    return getattr(obj.status, "nominated_node_name", "") or ""


def _annotations(obj) -> dict:
    if isinstance(obj, dict):
        return obj.get("metadata", {}).get("annotations") or {}
    return obj.metadata.annotations or {}


def _pod_wire(
    name, cpu="100m", mem="64Mi", group="", priority=None, node="",
) -> dict:
    labels = {POD_GROUP_LABEL: group} if group else {}
    spec: dict = {
        "containers": [
            {"name": "c", "image": "hollow",
             "resources": {"limits": {"cpu": cpu, "memory": mem}}}
        ]
    }
    if priority is not None:
        spec["priority"] = priority
    if node:
        # Born bound (the static-pod create shape): the defrag epochs
        # need an EXACT fragmented placement the live solver can never
        # race — a create-then-bind window would let it pack the wave.
        spec["nodeName"] = node
    return {
        "kind": "Pod",
        "metadata": {"name": name, "namespace": "default", "labels": labels},
        "spec": spec,
    }


def _pg_wire(name, min_member) -> dict:
    return {
        "kind": "PodGroup",
        "apiVersion": "v1",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {"minMember": min_member},
    }


def _wait_until(cond, timeout, interval=0.1) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


# -- restartable in-process control plane ------------------------------


class RestartableTransport(Transport):
    """LocalTransport against a SWAPPABLE apiserver: the soak cluster
    replaces its APIServer across a simulated crash, and every client
    in the process follows the swap. While the "process" is down,
    requests fail with 503 — the same transient failure an HTTP client
    would see — so components exercise their retry/re-list paths."""

    def __init__(self, cluster: "SoakCluster"):
        self._cluster = cluster

    def _api(self) -> LocalTransport:
        api = self._cluster.api
        if api is None:
            raise APIError(
                503, "ServiceUnavailable", "apiserver restarting (soak)"
            )
        return LocalTransport(api)

    def request(self, verb, op, args, body=None, patch_type=None):
        api = self._api()
        with tracing.span(f"api.{op}"):
            return api.request(verb, op, args, body, patch_type=patch_type)

    def watch(self, resource, namespace, since, lsel, fsel):
        return self._api().watch(resource, namespace, since, lsel, fsel)


class SoakCluster:
    """Durable store + apiserver + incremental scheduler + hollow-node
    fleet, all in-process, with crash/restart controls."""

    def __init__(
        self,
        n_nodes: int,
        data_dir: str,
        heartbeat_period: float = 20.0,
        sync_period: float = 3.0,
        max_batch: int = 4096,
        fsync: bool = True,
        device: DeviceLike = "cpu",
    ):
        self.n_nodes = n_nodes
        self.device = device
        self.data_dir = data_dir
        self.heartbeat_period = heartbeat_period
        self.sync_period = sync_period
        self.max_batch = max_batch
        self.fsync = fsync
        self.api: Optional[APIServer] = None
        self.store: Optional[KVStore] = None
        self.transport = RestartableTransport(self)
        self.kubelets: List[Kubelet] = []
        self.scheduler: Optional[IncrementalBatchScheduler] = None
        self.scheduler_config: Optional[SchedulerConfig] = None
        self.restarts = {"apiserver": 0, "scheduler": 0}

    def client(self) -> Client:
        return Client(self.transport)

    # -- lifecycle -----------------------------------------------------

    def _build_store(self) -> KVStore:
        # serialized_writes: the 1000-kubelet thread herd is exactly
        # the shape the single hot applier exists for.
        return KVStore(
            data_dir=self.data_dir,
            serialized_writes=True,
            fsync=self.fsync,
            snapshot_every=8192,
        )

    def start(self) -> "SoakCluster":
        self.store = self._build_store()
        self.api = APIServer(store=self.store)
        self._build_scheduler()
        # Hollow fleet: REAL kubelets, no containers. Registration +
        # informer sync ride a small pool so a 1000-node fleet comes
        # up in seconds, not serially.
        self.kubelets = [
            Kubelet(
                self.client(),
                node_name=f"hn-{i}",
                runtime=FakeRuntime(),
                heartbeat_period=self.heartbeat_period,
                sync_period=self.sync_period,
            )
            for i in range(self.n_nodes)
        ]
        work: "_queue.SimpleQueue" = _queue.SimpleQueue()
        for k in self.kubelets:
            work.put(k)
        errors: List[str] = []

        def starter():
            while True:
                try:
                    k = work.get_nowait()
                except _queue.Empty:
                    return
                try:
                    k.start()
                except Exception as e:  # noqa: BLE001 - collected below
                    errors.append(f"{k.node_name}: {e!r}")

        threads = [
            threading.Thread(target=starter, daemon=True)
            for _ in range(min(16, max(2, self.n_nodes // 8)))
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise RuntimeError(f"hollow fleet start failed: {errors[:3]}")
        return self

    def _build_scheduler(self) -> None:
        cfg = SchedulerConfig(self.client(), raw_scheduled_cache=True)
        cfg.start()
        if not cfg.wait_for_sync(timeout=60):
            raise RuntimeError("scheduler caches never synced")
        self.scheduler_config = cfg
        self.scheduler = IncrementalBatchScheduler(
            cfg, max_batch=self.max_batch, device=self.device
        ).start()

    # -- chaos controls ------------------------------------------------

    def restart_apiserver(self) -> None:
        """kill -9 the apiserver: crash the store (no final fsync, no
        graceful watcher drain beyond closing streams — queued writers
        fail with StoreClosedError), then recover a fresh store from
        the SAME data dir (snapshot + WAL replay, version clock intact)
        and swap in a new APIServer. Every informer in the process
        re-lists through the transport's 503 window."""
        self.restarts["apiserver"] += 1
        old, self.api = self.store, None
        try:
            if old is not None:
                old.crash()
            self.store = self._build_store()
            self.api = APIServer(store=self.store)
        except Exception:
            self.api = None
            raise

    def restart_scheduler(self) -> None:
        """Abrupt daemon kill: stop the solve loop, DROP queued commit
        jobs unexecuted (a dead process commits nothing), abandon the
        in-flight solve, then boot a fresh daemon whose SolverSession
        rebuilds from LIST+watch. Pods whose commits died stay Pending
        until the new daemon's informers feed them back in."""
        self.restarts["scheduler"] += 1
        sched, cfg = self.scheduler, self.scheduler_config
        self.scheduler = None
        self.scheduler_config = None
        if sched is not None:
            # stop() would flush queued commits — a crash doesn't.
            sched.kill()
        if cfg is not None:
            try:
                cfg.stop()
            except Exception:
                pass
        self._build_scheduler()

    def stop(self) -> None:
        for k in self.kubelets:
            try:
                k.stop()
            except Exception:
                pass
        sched, self.scheduler = self.scheduler, None
        if sched is not None:
            try:
                sched.stop()
            except Exception:
                pass
        cfg, self.scheduler_config = self.scheduler_config, None
        if cfg is not None:
            try:
                cfg.stop()
            except Exception:
                pass
        store, self.store = self.store, None
        self.api = None
        if store is not None:
            store.close()

    def node_pool(
        self, name: str = "elastic", cpu: str = "8", memory: str = "16Gi"
    ) -> "HollowNodePool":
        """An elastic hollow-node group for the Autoscaler (duck-typed
        pool provider: name/size()/grow()/shrink()/node_names())."""
        return HollowNodePool(self, name=name, cpu=cpu, memory=memory)


class HollowNodePool:
    """Autoscaler pool provider over the hollow fleet: ``grow`` boots
    REAL kubelets (they register their Node and heartbeat like the
    base fleet), ``shrink`` retires one — stop the kubelet, delete the
    Node object. The pool only ever touches nodes it created, so the
    base fleet is never a shrink victim."""

    def __init__(
        self,
        cluster: SoakCluster,
        name: str = "elastic",
        cpu: str = "8",
        memory: str = "16Gi",
    ):
        self.cluster = cluster
        self.name = name
        self.cpu = cpu
        self.memory = memory
        self._members: Dict[str, Kubelet] = {}
        self._serial = 0

    def size(self) -> int:
        return len(self._members)

    def node_names(self) -> List[str]:
        return sorted(self._members)

    def grow(self, k: int) -> List[str]:
        added = []
        for _ in range(k):
            nm = f"{self.name}-{self._serial}"
            self._serial += 1
            kb = Kubelet(
                self.cluster.client(),
                node_name=nm,
                runtime=FakeRuntime(),
                cpu=self.cpu,
                memory=self.memory,
                heartbeat_period=self.cluster.heartbeat_period,
                sync_period=self.cluster.sync_period,
            )
            kb.start()
            self._members[nm] = kb
            self.cluster.kubelets.append(kb)
            added.append(nm)
        return added

    def shrink(self, name: str) -> None:
        kb = self._members.pop(name, None)
        if kb is None:
            return
        try:
            kb.stop()
        except Exception:
            pass
        try:
            self.cluster.kubelets.remove(kb)
        except ValueError:
            pass
        try:
            self.cluster.client().delete("nodes", name)
        except APIError as e:
            if e.code != 404:
                raise


# -- watch-derived mirror + event invariants ---------------------------


class WatchMirror:
    """A second, independent consumer of the pods watch: a Reflector-fed
    mirror whose contents the checker compares against authoritative
    LISTs, plus per-event invariants caught AS THEY HAPPEN — duplicate
    DELETED per (key, uid) and a bound pod's nodeName changing."""

    def __init__(self, client: Client):
        self.store = ThreadSafeStore(key_func=_pod_key)
        self.violations: List[dict] = []
        self._deleted: Dict[Tuple[str, str], int] = {}
        self._node_of: Dict[str, str] = {}  # uid -> first bound node
        self._lock = threading.Lock()
        self.reflector = Reflector(
            client, "pods", self.store, on_event=self._on_event
        )

    def start(self) -> "WatchMirror":
        self.reflector.start()
        return self

    def stop(self) -> None:
        self.reflector.stop()

    def _on_event(self, etype: str, obj) -> None:
        key = _pod_key(obj)
        _ns, _name, uid = _meta(obj)
        if etype == "DELETED":
            if not uid:
                return
            with self._lock:
                n = self._deleted.get((key, uid), 0) + 1
                self._deleted[(key, uid)] = n
                self._node_of.pop(uid, None)
            if n > 1:
                self.violations.append({
                    "invariant": "exactly_one_deleted",
                    "detail": f"{key} (uid {uid}) saw DELETED x{n}",
                })
            return
        node = _node_of(obj)
        if not node or not uid:
            return
        with self._lock:
            prev = self._node_of.get(uid)
            if prev is None:
                self._node_of[uid] = node
        if prev is not None and prev != node:
            self.violations.append({
                "invariant": "bind_immutable",
                "detail": f"{key} (uid {uid}) rebound {prev} -> {node}",
            })

    def bound_node(self, key: str) -> str:
        obj = self.store.get(key)
        return _node_of(obj) if obj is not None else ""

    def has(self, key: str) -> bool:
        return self.store.get(key) is not None

    def snapshot(self) -> Dict[str, Tuple[str, str]]:
        """key -> (uid, node) for every pod the mirror holds."""
        out = {}
        for obj in self.store.list():
            ns, name, uid = _meta(obj)
            out[f"{ns}/{name}"] = (uid, _node_of(obj))
        return out


# -- invariant checker -------------------------------------------------


class InvariantChecker:
    def __init__(self, cluster: SoakCluster, mirror: WatchMirror):
        self.cluster = cluster
        self.mirror = mirror
        self.violations: List[dict] = []
        self._sli_start = self._sli_counts()
        self._sli_prev = dict(self._sli_start)
        self.capacity_timeline: List[dict] = []
        self._cap_prev = self._cap_samples()
        self._alerts_t0 = time.monotonic()

    @staticmethod
    def _sli_counts() -> Dict[str, int]:
        return {
            m: sli.STARTUP_LATENCY.count(milestone=m)
            for m in ("decision", "bound", "running")
        }

    @staticmethod
    def _cap_samples() -> int:
        return int(capmod.DEFAULT.snapshot().get("samples", 0))

    def _viol(self, epoch: str, invariant: str, detail: str) -> None:
        self.violations.append(
            {"epoch": epoch, "invariant": invariant, "detail": detail}
        )

    def _list_pods(self, client: Client):
        pods, version = client.list_wire("pods", namespace="default")
        return pods, version

    def quiesce(self, client: Client, timeout: float = 60.0) -> bool:
        """Wait until the scheduler has no backlog or in-flight tick.
        (Mirror freshness is NOT waited on here — the pods watch only
        advances on pod events while heartbeats bump the store version
        forever; the consistency check below retries on content.)"""
        def settled():
            sched = self.cluster.scheduler
            if sched is None or self.cluster.store is None:
                return False
            return not len(sched.config.pod_queue) and sched._inflight is None

        return _wait_until(settled, timeout, interval=0.2)

    def check(
        self, epoch: str, client: Client, entry: Optional[dict] = None,
    ) -> None:
        """Run every invariant; append violations (never raises)."""
        self.quiesce(client)
        # Event-stream invariants detected live by the mirror.
        while self.mirror.violations:
            v = self.mirror.violations.pop(0)
            self._viol(epoch, v["invariant"], v["detail"])
        self._check_store_vs_mirror(epoch, client)
        self._check_gangs(epoch, client)
        self._check_nominations(epoch, client)
        self._check_move_journal(epoch, client)
        self._check_slo_epoch(epoch)
        self._check_capacity_epoch(epoch)
        self._check_alerts_epoch(epoch, entry)

    def _check_alerts_epoch(
        self, epoch: str, entry: Optional[dict],
    ) -> None:
        """The alert oracle: every rule the schedule declared for this
        epoch must have been FIRING at some point during it — a
        ``-> firing`` transition since the previous epoch's check, a
        ``firing -> resolved`` transition since then (it was firing
        inside the epoch before resolving), or a firing state still
        held over from a condition that never cleared. The high-water
        mark advances regardless of outcome so a late firing can't
        retroactively satisfy the next epoch."""
        expected = list((entry or {}).get("expected_alerts") or ())
        engine = alertmod.DEFAULT

        def fired_since(rule: str) -> bool:
            if any(
                t["rule"] == rule
                and (t["to"] == "firing" or t["from"] == "firing")
                and t["t_mono"] >= self._alerts_t0
                for t in engine.transitions()
            ):
                return True
            return rule in engine.firing()

        for rule in expected:
            # The storm ran during the epoch; firing may still be one
            # hold-down beat away when the churn settles.
            if not _wait_until(
                lambda: fired_since(rule), timeout=15.0, interval=0.25
            ):
                states = {
                    r["name"]: r["state"]
                    for r in engine.snapshot()["rules"]
                }
                self._viol(
                    epoch, "alert_fired",
                    f"expected alert {rule} never fired during the "
                    f"epoch (states: {states})",
                )
        self._alerts_t0 = time.monotonic()

    def _check_slo_epoch(self, epoch: str) -> None:
        """Every SLI milestone series must advance across EVERY epoch
        (each epoch binds a fresh wave, so new decision/bound/running
        observations are owed). The kubelet's running stamp is
        watch-driven and may trail the last bind by a sync beat —
        wait, then flag."""
        prev = self._sli_prev
        last = [prev]

        def advanced():
            now = self._sli_counts()
            last[0] = now
            return all(now[m] > prev[m] for m in now)

        if not _wait_until(advanced, timeout=30.0, interval=0.5):
            stalled = [m for m in last[0] if last[0][m] <= prev[m]]
            self._viol(
                epoch, "slo_series_advancing",
                f"milestones stalled across the epoch: {stalled} "
                f"(prev={prev}, now={last[0]})",
            )
        self._sli_prev = last[0]

    def _check_capacity_epoch(self, epoch: str) -> None:
        """The capacity monitor must take at least one new sample per
        epoch (per resolved tick + idle refresh) — a stalled
        counter means the fragmentation/headroom plane went dark under
        faults. The advance is also recorded as a per-epoch timeline
        row in the artifact."""
        prev = self._cap_prev

        def advanced():
            return self._cap_samples() > prev

        if not _wait_until(advanced, timeout=30.0, interval=0.5):
            self._viol(
                epoch, "capacity_sampling_advancing",
                f"capacity samples stalled across the epoch "
                f"(prev={prev}, now={self._cap_samples()})",
            )
        snap = capmod.DEFAULT.snapshot()
        self._cap_prev = int(snap.get("samples", 0))
        row = {"epoch": epoch, "samples": self._cap_prev}
        if snap.get("sampled"):
            row.update({
                "fragmentation_score": snap["fragmentation_score"],
                "slice_alloc_success_rate": snap[
                    "slice_alloc_success_rate"
                ],
                "stranded_node_count": snap["stranded_node_count"],
                "backlog_pressure": snap["backlog"]["pressure"],
            })
        self.capacity_timeline.append(row)

    def _check_store_vs_mirror(self, epoch: str, client: Client) -> None:
        """kvstore LIST == watch-derived mirror (retrying while the
        watch catches up): no pod lost or duplicated across replay."""
        last_diff = [""]

        def consistent():
            try:
                pods, _v = self._list_pods(client)
            except Exception as e:  # mid-restart: retry
                last_diff[0] = f"LIST failed: {e!r}"
                return False
            truth = {}
            for p in pods:
                ns, name, uid = _meta(p)
                truth[f"{ns}/{name}"] = (uid, _node_of(p))
            mirror = self.mirror.snapshot()
            if truth == mirror:
                return True
            missing = sorted(set(truth) - set(mirror))[:3]
            extra = sorted(set(mirror) - set(truth))[:3]
            drift = sorted(
                k for k in set(truth) & set(mirror) if truth[k] != mirror[k]
            )[:3]
            last_diff[0] = (
                f"missing_from_mirror={missing} phantom_in_mirror={extra} "
                f"drift={drift} (|store|={len(truth)} |mirror|={len(mirror)})"
            )
            return False

        if not _wait_until(consistent, timeout=30.0, interval=0.5):
            self._viol(epoch, "replay_consistency", last_diff[0])

    def _check_gangs(self, epoch: str, client: Client) -> None:
        """No PodGroup may SETTLE half-bound: fewer than minMember
        members bound while others sit Pending."""
        def no_half_bound():
            try:
                groups, _ = client.list("podgroups", namespace="default")
                pods, _ = self._list_pods(client)
            except Exception:
                return False
            members: Dict[str, List] = {}
            for p in pods:
                if isinstance(p, dict):
                    g = p.get("metadata", {}).get("labels", {}).get(
                        POD_GROUP_LABEL, ""
                    )
                else:
                    g = (p.metadata.labels or {}).get(POD_GROUP_LABEL, "")
                if g:
                    members.setdefault(g, []).append(p)
            for pg in groups:
                name = pg.metadata.name
                mem = members.get(name, [])
                live = [p for p in mem if not _terminating(p)]
                bound = [p for p in live if _node_of(p)]
                pending = [p for p in live if not _node_of(p)]
                if bound and pending and len(bound) < pg.spec.min_member:
                    self._last_gang = (
                        f"gang {name}: {len(bound)} bound < minMember "
                        f"{pg.spec.min_member} with {len(pending)} pending"
                    )
                    return False
            return True

        self._last_gang = ""
        if not _wait_until(no_half_bound, timeout=45.0, interval=0.5):
            self._viol(epoch, "gang_all_or_nothing", self._last_gang)

    def _check_nominations(self, epoch: str, client: Client) -> None:
        """Every pod holding a nomination either binds or sheds it
        (expiry + re-solve) — including across daemon restarts that
        lost the in-memory nomination table."""
        def resolved():
            try:
                pods, _ = self._list_pods(client)
            except Exception:
                return False
            stuck = [
                _pod_key(p) for p in pods
                if _nominated(p) and not _node_of(p) and not _terminating(p)
            ]
            self._last_nom = f"nominated-but-unbound: {stuck[:5]}"
            return not stuck

        self._last_nom = ""
        if not _wait_until(resolved, timeout=60.0, interval=0.5):
            self._viol(epoch, "nominations_recovered", self._last_nom)

    def _check_move_journal(self, epoch: str, client: Client) -> None:
        """The descheduler's move journal must drain: a PodTemplate
        entry outliving its epoch means a defrag move was neither
        completed nor recovered — exactly the stranded-pod state the
        rebalance SLO gate burns on. Trivially empty outside the
        defrag epochs."""
        last = [""]

        def drained():
            try:
                entries, _ = client.list(
                    "podtemplates", label_selector=REBALANCE_JOURNAL_LABEL
                )
            except Exception:
                return False
            orphans = [e.metadata.name for e in entries]
            last[0] = f"orphaned move journals: {orphans[:5]}"
            return not orphans

        if not _wait_until(drained, timeout=30.0, interval=0.5):
            self._viol(epoch, "defrag_journal_drained", last[0])

    def check_slo_advancing(self, epoch: str) -> None:
        now = self._sli_counts()
        stalled = [
            m for m in now
            if now[m] <= self._sli_start[m]
        ]
        if stalled:
            self._viol(
                epoch, "slo_series_advancing",
                f"milestones never advanced across the run: {stalled} "
                f"(start={self._sli_start}, end={now})",
            )


# -- churn driver ------------------------------------------------------


class ChurnDriver:
    """Creates/binds/deletes pod waves through a fault-tolerant client:
    every API call retries through restart windows, and a wave
    reconciles (re-creates pods lost to unacked torn writes) rather
    than assuming its creates stuck."""

    def __init__(self, cluster: SoakCluster, mirror: WatchMirror, rng):
        self.cluster = cluster
        self.mirror = mirror
        self.rng = rng
        self.client = cluster.client()
        self.bind_latencies: List[float] = []
        self.rebalance_log: List[dict] = []
        self.failover_bind_s: List[float] = []
        self._serial = 0

    # -- fault-tolerant verbs -----------------------------------------

    def _retrying(self, fn, timeout: float = 30.0):
        deadline = time.monotonic() + timeout
        while True:
            try:
                return fn()
            except Exception:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.25)

    def create_pods(self, wires: List[dict], tolerate: bool = False) -> None:
        for start in range(0, len(wires), 512):
            chunk = wires[start:start + 512]

            def put(chunk=chunk):
                res = self.client.create_bulk(
                    "pods", chunk, namespace="default"
                )
                bad = [
                    r for r in res
                    if r.get("status") != "Success" and r.get("code") != 409
                ]
                if bad and not tolerate:
                    raise RuntimeError(f"bulk create failed: {bad[:2]}")

            try:
                self._retrying(put)
            except Exception:
                if not tolerate:
                    raise

    def reconcile_missing(self, wires: List[dict]) -> int:
        """Re-create wave pods the store does not hold (a torn-write
        'create' the crash un-did was never acked — the client's job is
        to reconcile by reading current state and retrying)."""
        recreated = 0
        for w in wires:
            name = w["metadata"]["name"]

            def ensure(w=w, name=name):
                try:
                    self.client.get("pods", name, namespace="default")
                except APIError as e:
                    if e.code != 404:
                        raise
                    self.client.create("pods", w, namespace="default")
                    return True
                return False

            try:
                if self._retrying(ensure):
                    recreated += 1
            except Exception:
                pass
        return recreated

    def wait_bound(self, names: List[str], timeout: float) -> List[str]:
        """Wait for binds via the mirror; records per-pod latencies.
        Returns names that never bound (caller decides severity)."""
        t0 = time.monotonic()
        pending = {f"default/{n}" for n in names}
        seen_at: Dict[str, float] = {}
        deadline = t0 + timeout
        while pending and time.monotonic() < deadline:
            for key in list(pending):
                if self.mirror.bound_node(key):
                    seen_at[key] = time.monotonic() - t0
                    pending.discard(key)
            if pending:
                time.sleep(0.1)
        self.bind_latencies.extend(seen_at.values())
        return sorted(k.split("/", 1)[1] for k in pending)

    def delete_pods(self, names: List[str], graceful_frac: float = 0.5) -> None:
        """Half graceful (the kubelet Terminating confirm path), half
        immediate; waits until every key leaves the mirror."""
        graceful = [n for n in names if self.rng.random() < graceful_frac]
        graceful_set = set(graceful)
        for n in names:

            def rm(n=n):
                try:
                    self.client.delete(
                        "pods", n, namespace="default",
                        grace_period_seconds=1 if n in graceful_set else None,
                    )
                except APIError as e:
                    if e.code != 404:
                        raise

            try:
                self._retrying(rm)
            except Exception:
                pass
        gone = lambda: all(  # noqa: E731
            not self.mirror.has(f"default/{n}") for n in names
        )
        # Graceful deletes confirm at grace + the kubelet's next resync
        # tick; generous bound (invariant checks re-verify after).
        _wait_until(gone, timeout=90.0, interval=0.25)

    def delete_group(self, gname: str, names: List[str]) -> None:
        self.delete_pods(names, graceful_frac=0.0)

        def rm():
            try:
                self.client.delete("podgroups", gname, namespace="default")
            except APIError as e:
                if e.code != 404:
                    raise

        try:
            self._retrying(rm)
        except Exception:
            pass

    # -- waves ---------------------------------------------------------

    def next_prefix(self, tag: str) -> str:
        self._serial += 1
        # Epoch names carry underscores; pod names must be DNS-safe.
        return f"soak-{tag.replace('_', '-')}-{self._serial}"

    def plain_wave(
        self, n_pods: int, tag: str, bind_timeout: float = 90.0,
        tolerate: bool = False,
    ) -> List[str]:
        """Create → bind → delete a wave of plain pods. Returns the
        names that never bound."""
        prefix = self.next_prefix(tag)
        names = [f"{prefix}-{i}" for i in range(n_pods)]
        wires = [_pod_wire(n) for n in names]
        self.create_pods(wires, tolerate=tolerate)
        self.reconcile_missing(wires)
        unbound = self.wait_bound(names, bind_timeout)
        self.delete_pods(names)
        return unbound


# -- the schedule ------------------------------------------------------


def build_schedule(
    seed: int, epochs: Optional[List[str]] = None, n_nodes: int = 200
) -> List[dict]:
    """The deterministic fault timeline: one entry per epoch with every
    armed-rule parameter and wave size resolved from the seed. Pure —
    calling it twice with the same inputs returns identical schedules
    (the reproducibility half of the acceptance bar)."""
    rng = random.Random(f"soak-schedule:{seed}")
    wave = max(32, min(2 * n_nodes, 512))
    chosen = list(epochs) if epochs else list(EPOCHS)
    unknown = set(chosen) - set(EPOCHS)
    if unknown:
        raise ValueError(
            f"unknown epoch(s) {sorted(unknown)}; known: {', '.join(EPOCHS)}"
        )
    out = []
    for name in EPOCHS:  # fixed order regardless of selection order
        if name not in chosen:
            continue
        entry: dict = {"epoch": name, "wave_pods": wave}
        if name == "watch_drops":
            entry["rule"] = {
                "site": faults.WATCH_DROP.name,
                "p": round(rng.uniform(0.02, 0.08), 3),
                "times": rng.randrange(6, 14),
            }
            # The alert oracle: this storm MUST trip the drop-rate
            # burn rule while the epoch runs (and resolve by run end).
            entry["expected_alerts"] = ["watch_drop_storm"]
        elif name == "wal_fsync":
            entry["rule"] = {
                "site": faults.WAL_FSYNC.name,
                "every": rng.randrange(20, 60),
                "times": rng.randrange(4, 10),
            }
        elif name == "apiserver_restart":
            entry["rule"] = {
                "site": faults.WAL_TORN_WRITE.name,
                "every": rng.randrange(40, 120),
                "times": 1,
            }
        elif name == "daemon_restart_mid_gang":
            entry["rule"] = {
                "site": faults.SCHED_COMMIT_CRASH.name,
                # Armed only once the warm-up wave is fully bound, so
                # the FIRST commit job after arming — the gang tick —
                # is the one that dies.
                "every": 1,
                "times": 1,
            }
            entry["warmup_pods"] = 8
            entry["gangs"] = max(2, wave // 64)
            entry["gang_size"] = rng.randrange(3, 6)
        elif name == "preemption_storm":
            entry["rule"] = {
                "site": faults.SCHED_EVICT_ERROR.name,
                "p": round(rng.uniform(0.3, 0.6), 3),
                "times": rng.randrange(8, 24),
            }
            entry["preemptors"] = max(4, n_nodes // 50)
        elif name in ("defrag_churn", "defrag_daemon_crash"):
            # Fragmenting fill: three 1000m fillers per 4000m hollow
            # node leave a 1000m shard everywhere — movable (a filler
            # fits another node's shard) yet useless to a 2000m probe,
            # so the probes pend until the descheduler pairs fillers
            # up. The crash variant arms DESCHED_MOVE_CRASH so the
            # daemon dies mid-plan with the journal as the only
            # survivor.
            entry["fillers_per_node"] = 3
            entry["probe_pods"] = max(2, min(6, n_nodes // 64))
            # The measured score depends on the backlog-quantile
            # window (earlier epochs' small shapes dilute it), so the
            # threshold must sit safely below the fragmented-state
            # score — the trigger under test is "crossed with pending
            # backlog", not a calibrated absolute level.
            entry["frag_threshold"] = round(rng.uniform(0.01, 0.03), 3)
            entry["move_budget"] = rng.randrange(8, 17)
            # The fragmenting fill pushes the measured score past the
            # drill threshold (0.008 < the 0.01 floor above): the
            # fragmentation burn rule must fire while the shards pend.
            entry["expected_alerts"] = ["fragmentation_burn"]
            if name == "defrag_daemon_crash":
                entry["rule"] = {
                    "site": faults.DESCHED_MOVE_CRASH.name,
                    # Fires on the 2nd move of the cycle: at least one
                    # move completed, one is torn mid-protocol.
                    "every": 2,
                    "times": 1,
                }
        elif name == "leader_kill_each_tier":
            # HA failover drill: kvstore leader crash → follower
            # promotion, then scheduler leader kill → warm-standby
            # activation. Process-level moves, no armed fault rule.
            entry["trickle_pods"] = max(4, wave // 32)
        elif name == "pool_elastic":
            # Backlog no base node can hold (6000m > the fleet's 4000m
            # nodes); only grown 8000m pool nodes fit it. After the
            # backlog drains and is deleted, sustained idle shrinks
            # the pool back to zero through cordon-drain.
            entry["big_pods"] = rng.randrange(2, 5)
            entry["grow_after"] = 2
            entry["shrink_after"] = 3
        out.append(entry)
    return out


def _resolve(device: DeviceLike):
    """``cpu`` as asked; anything else the CUDA card, raising without
    one (the port never falls back to the CPU on its own)."""
    if str(device) == "cpu":
        return "cpu"
    if device is None or str(device) == "cuda":
        return default_device()
    return device


def _arm(rule: dict) -> "faults.FaultRule":
    site = faults.SITES[rule["site"]]
    kw = {k: v for k, v in rule.items() if k != "site"}
    return faults.inject(site, **kw)


# -- the run -----------------------------------------------------------


def run_soak(
    n_nodes: int = 200,
    seed: int = 0,
    epochs: Optional[List[str]] = None,
    data_dir: Optional[str] = None,
    fsync: bool = True,
    verbose: bool = True,
    device: DeviceLike = "cuda",
) -> dict:
    """Execute the schedule; returns the artifact dict (see __main__).
    Leaves the fault registry disarmed regardless of outcome. `device`
    is where K1 and K2 run: ``cuda`` (the card; raises before anything
    starts without one) or ``cpu`` (their plain versions)."""
    device = _resolve(device)

    def log(msg: str) -> None:
        if verbose:
            print(f"[soak +{time.monotonic() - t_start:6.1f}s] {msg}",
                  flush=True)

    t_start = time.monotonic()
    faults.clear()
    faults.reset_stats(reseed=seed)
    schedule = build_schedule(seed, epochs, n_nodes=n_nodes)
    tmp = None
    if data_dir is None:
        tmp = tempfile.mkdtemp(prefix="kt-soak-")
        data_dir = tmp
    # Kubelet cadences scale with fleet size: at 1000 nodes a 3s
    # resync period means ~333 full pod-resyncs/s of pure GIL churn —
    # the reference scales --node-status-update-frequency the same way.
    cluster = SoakCluster(
        n_nodes, data_dir, fsync=fsync, device=device,
        heartbeat_period=max(20.0, n_nodes / 25.0),
        sync_period=max(3.0, n_nodes / 100.0),
    )
    log(f"starting cluster: {n_nodes} hollow nodes, seed {seed}, "
        f"data dir {data_dir}")
    cluster.start()
    log("fleet up")
    # Health plane on compressed clocks: fresh retention, drill-tuned
    # rules, transition Events posted to the cluster under test. The
    # engine and sampler are the production singletons — the oracle
    # exercises the same code local-up/daemons run.
    tsmod.DEFAULT.reset()
    alertmod.DEFAULT.configure(
        rules=_soak_alert_rules(), clock_scale=SOAK_ALERT_SCALE,
    )
    alertmod.ensure_started(
        interval_s=ALERT_SAMPLE_S, client=cluster.client()
    )
    mirror = WatchMirror(cluster.client()).start()
    checker = InvariantChecker(cluster, mirror)
    driver = ChurnDriver(cluster, mirror, rng=random.Random(f"churn:{seed}"))
    epoch_reports: List[dict] = []
    n_before_final: Optional[int] = None
    n_first_fault = 0
    try:
        for entry in schedule:
            name = entry["epoch"]
            log(f"epoch {name}: {entry}")
            t0 = time.monotonic()
            if name == "final":
                n_before_final = len(driver.bind_latencies)
            elif name != "baseline" and not n_first_fault:
                n_first_fault = len(driver.bind_latencies)
            unbound: List[str] = []
            try:
                unbound = _run_epoch(cluster, driver, entry)
            except Exception as e:
                checker._viol(name, "epoch_crashed", repr(e))
            finally:
                faults.clear()
            if unbound:
                checker._viol(
                    name, "backlog_drained",
                    f"{len(unbound)} pods never bound: {unbound[:5]}",
                )
            checker.check(name, driver.client, entry)
            cycles = [
                c for c in driver.rebalance_log if c["epoch"] == name
            ]
            if cycles and checker.capacity_timeline:
                # The acceptance figure: the measured score moved.
                # Each cycle is its own measured before/after pair;
                # the row carries the best one.
                best = max(cycles, key=lambda c: c["improvement"])
                checker.capacity_timeline[-1].update({
                    "fragmentation_score_before": best["score_before"],
                    "fragmentation_score_after": best["score_after"],
                    "rebalance_moves": sum(
                        c["moves_executed"] for c in cycles
                    ),
                })
            epoch_reports.append({
                "epoch": name,
                "wall_s": round(time.monotonic() - t0, 2),
                "violations_so_far": len(checker.violations),
            })
            log(f"epoch {name} done ({epoch_reports[-1]['wall_s']}s, "
                f"{len(checker.violations)} violation(s) so far)")
        checker.check_slo_advancing("end")
        # Resolution half of the oracle: with every fault disarmed and
        # the final clean wave bound, nothing may still be firing —
        # the short burn windows drain in seconds at SOAK_ALERT_SCALE,
        # then the scaled hysteresis resolves the rule.
        if not _wait_until(
            lambda: not alertmod.DEFAULT.firing(),
            timeout=60.0, interval=0.5,
        ):
            checker._viol(
                "end", "alerts_resolved",
                f"still firing after the clean final epoch: "
                f"{alertmod.DEFAULT.firing()}",
            )
    finally:
        faults.clear()
        tsmod.SAMPLER.stop()
        try:
            mirror.stop()
        except Exception:
            pass
        try:
            cluster.stop()
        except Exception:
            pass
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)

    lat = sorted(driver.bind_latencies)
    # The post-fault figure: what the final (clean, after-every-fault)
    # epoch measured; when no final epoch was selected, everything
    # from the FIRST fault epoch on (never the clean baseline — it
    # would flatter the figure).
    post_start = n_before_final if n_before_final is not None else n_first_fault
    post_slice = sorted(driver.bind_latencies[post_start:])

    def _p(q, xs):
        return round(xs[min(len(xs) - 1, int(q * (len(xs) - 1)))], 4) \
            if xs else None

    alert_snap = alertmod.DEFAULT.snapshot()
    artifact = {
        "seed": seed,
        "nodes": n_nodes,
        "schedule": schedule,
        "epochs": epoch_reports,
        "restarts": cluster.restarts,
        "faults_injected": faults.stats(),
        "fault_timeline": [list(t) for t in faults.timeline()],
        "pods_bound": len(lat),
        "bind_p50_s": _p(0.50, lat),
        "bind_p99_s": _p(0.99, lat),
        "post_fault_bind_p50_s": _p(0.50, post_slice),
        "post_fault_bind_p99_s": _p(0.99, post_slice),
        "capacity_timeline": checker.capacity_timeline,
        "rebalance_cycles": driver.rebalance_log,
        "failover_to_first_bind_s": driver.failover_bind_s,
        "alerts": {
            "clock_scale": SOAK_ALERT_SCALE,
            "rules_evaluated": len(alertmod.DEFAULT.rules),
            "evaluations": alert_snap["evaluations"],
            "firing_at_end": alert_snap["firing"],
            # The firing timeline: every state transition the run
            # caused, in order (the oracle's evidence trail).
            "timeline": alertmod.DEFAULT.transitions(),
            # Fault epochs that declared no expected alerts — reported
            # coverage gaps, not failures: each is a storm the alert
            # plane does not yet oracle.
            "coverage_gaps": sorted(
                e["epoch"] for e in schedule
                if e.get("rule") and not e.get("expected_alerts")
            ),
        },
        "invariant_violations": checker.violations,
        "wall_s": round(time.monotonic() - t_start, 1),
    }
    return artifact


def _run_epoch(cluster: SoakCluster, driver: ChurnDriver, entry: dict):
    """One epoch: arm → churn (+ process-level moves) → return pods
    that never bound. The caller disarms and runs the checker."""
    name = entry["epoch"]
    wave = entry["wave_pods"]
    if name in ("baseline", "final"):
        return driver.plain_wave(wave, name)
    if name == "watch_drops":
        _arm(entry["rule"])
        return driver.plain_wave(wave, name, bind_timeout=120.0)
    if name == "wal_fsync":
        _arm(entry["rule"])
        # Writes may FAIL (flushed-not-durable acks refused): tolerate
        # and reconcile — that is the client contract under storage
        # faults.
        prefix = driver.next_prefix(name)
        names = [f"{prefix}-{i}" for i in range(wave)]
        wires = [_pod_wire(n) for n in names]
        driver.create_pods(wires, tolerate=True)
        faults.clear()
        driver.reconcile_missing(wires)
        unbound = driver.wait_bound(names, 120.0)
        driver.delete_pods(names)
        return unbound
    if name == "apiserver_restart":
        rule = _arm(entry["rule"])
        prefix = driver.next_prefix(name)
        names = [f"{prefix}-{i}" for i in range(wave)]
        wires = [_pod_wire(n) for n in names]
        driver.create_pods(wires, tolerate=True)
        # Wait (briefly) for the torn-write to fire mid-churn — the
        # store is DEAD from that instant (writes refused, exactly as
        # a real mid-append death) — then kill -9 and recover on the
        # same data dir.
        _wait_until(lambda: rule.fired > 0, timeout=10.0)
        faults.clear()
        cluster.restart_apiserver()
        driver.reconcile_missing(wires)
        unbound = driver.wait_bound(names, 240.0)
        driver.delete_pods(names)
        return unbound
    if name == "daemon_restart_mid_gang":
        gangs, gang_size = entry["gangs"], entry["gang_size"]
        prefix = driver.next_prefix(name)
        # Warm-up wave binds CLEAN first; arming after it means the
        # next commit job — the gang tick — is the one that dies.
        warmup = [f"{prefix}-w{i}" for i in range(entry["warmup_pods"])]
        driver.create_pods([_pod_wire(n) for n in warmup])
        driver.wait_bound(warmup, 90.0)
        rule = _arm(entry["rule"])
        groups = []
        for g in range(gangs):
            gname = f"{prefix}-g{g}"
            driver._retrying(
                lambda gname=gname: driver.client.create(
                    "podgroups", _pg_wire(gname, gang_size),
                    namespace="default",
                )
            )
            names = [f"{gname}-m{i}" for i in range(gang_size)]
            driver.create_pods([_pod_wire(n, group=gname) for n in names])
            groups.append((gname, names))
        # The commit crash fires mid-stream; kill the daemon while its
        # session still carries charges for never-bound pods.
        _wait_until(lambda: rule.fired > 0, timeout=15.0)
        faults.clear()
        cluster.restart_scheduler()
        all_names = [n for _g, ns in groups for n in ns]
        unbound = driver.wait_bound(all_names, 150.0)
        for gname, names in groups:
            driver.delete_group(gname, names)
        driver.delete_pods(warmup)
        return unbound
    if name == "preemption_storm":
        # Saturate every node with a low-priority filler, then launch
        # high-priority preemptors that fit NOWHERE without evictions —
        # under injected eviction failures.
        prefix = driver.next_prefix(name)
        fillers = [f"{prefix}-fill-{i}" for i in range(cluster.n_nodes)]
        driver.create_pods(
            [_pod_wire(n, cpu="3") for n in fillers]
        )
        driver.wait_bound(fillers, 150.0)
        _arm(entry["rule"])
        preemptors = [
            f"{prefix}-hi-{i}" for i in range(entry["preemptors"])
        ]
        driver.create_pods(
            [_pod_wire(n, cpu="2", priority=100) for n in preemptors]
        )
        # Preemptors must bind: nominate → evict (some injected
        # failures, retried) → victims drain grace → bind.
        unbound = driver.wait_bound(preemptors, 180.0)
        faults.clear()
        driver.delete_pods(preemptors)
        driver.delete_pods(fillers, graceful_frac=0.0)
        return unbound
    if name == "defrag_churn":
        return _run_defrag_epoch(cluster, driver, entry, crash=False)
    if name == "defrag_daemon_crash":
        return _run_defrag_epoch(cluster, driver, entry, crash=True)
    if name == "pool_elastic":
        return _run_pool_epoch(cluster, driver, entry)
    if name == "leader_kill_each_tier":
        return _run_leader_kill_epoch(cluster, driver, entry)
    raise ValueError(f"unknown epoch {name!r}")


def _run_leader_kill_epoch(
    cluster: SoakCluster, driver: ChurnDriver, entry: dict
) -> List[str]:
    """Kill the leader of EACH HA control-plane tier, mid-churn.

    Tier 1 (kvstore): a ReplicationHub forms a leader+follower pair
    around the live store (write acks gated on the follower's journal
    — quorum of 2), the leader crashes mid-wave, and the PROMOTED
    follower — serving exactly the committed prefix — backs a fresh
    APIServer. Every acked write must survive; the replay-consistency
    invariant re-verifies after the epoch.

    Tier 2 (scheduler): a WarmStandbyScheduler prewarms against the
    live cluster (informers hot, SolverSession device-resident), the
    active daemon is killed abruptly, a trickle of pods lands with NO
    scheduler running, and the standby's activation must bind them —
    the kill→first-bind wall time is the artifact's
    failover_to_first_bind_s sample."""
    name = entry["epoch"]
    prefix = driver.next_prefix(name)
    wave = entry["wave_pods"]

    # ---- tier 1: kvstore leader ------------------------------------
    follower = FollowerReplica(store=KVStore(), name="soak-standby")
    hub = ReplicationHub(cluster.store, name="soak-leader").attach()
    hub.add_follower(LocalLink(follower, "soak-standby"))
    names = [f"{prefix}-kv-{i}" for i in range(wave)]
    wires = [_pod_wire(n) for n in names]
    half = wave // 2
    driver.create_pods(wires[:half], tolerate=True)
    # Crash the leader mid-wave. A real crash never stops the hub
    # cleanly — crash first (in-flight writers die with the store),
    # then retire the shippers so nothing parks on a dead quorum.
    cluster.restarts["apiserver"] += 1
    old, cluster.api = cluster.store, None
    try:
        old.crash()
    except Exception:
        pass
    hub.stop()
    promoted = follower.promote()
    cluster.store = promoted
    cluster.api = APIServer(store=promoted)
    # The second half of the wave lands on the promoted store; the
    # first half reconciles (unacked creates may have died with the
    # old leader — acked ones MUST be in the promoted store already).
    driver.create_pods(wires[half:], tolerate=True)
    driver.reconcile_missing(wires)
    unbound = driver.wait_bound(names, 240.0)

    # ---- tier 2: scheduler leader ----------------------------------
    standby = WarmStandbyScheduler(
        cluster.client(), sync_timeout=120.0,
        daemon_factory=lambda cfg: IncrementalBatchScheduler(
            cfg, device=cluster.device
        ),
    )
    standby.prewarm()
    # Abrupt kill: queued commits dropped, no flush, no abdication.
    cluster.restarts["scheduler"] += 1
    sched, cfg = cluster.scheduler, cluster.scheduler_config
    cluster.scheduler = None
    cluster.scheduler_config = None
    t_kill = time.monotonic()
    if sched is not None:
        sched.kill()
    if cfg is not None:
        try:
            cfg.stop()
        except Exception:
            pass
    # Trickled pods land with no scheduler alive...
    trickle = [f"{prefix}-fo-{i}" for i in range(entry["trickle_pods"])]
    driver.create_pods([_pod_wire(n) for n in trickle], tolerate=True)
    # ...then the warm standby activates and its first tick drains
    # the accumulated deltas.
    standby.activate()
    first_bound = _wait_until(
        lambda: any(
            driver.mirror.bound_node(f"default/{n}") for n in trickle
        ),
        timeout=120.0,
    )
    if first_bound:
        driver.failover_bind_s.append(
            round(time.monotonic() - t_kill, 4)
        )
    unbound += driver.wait_bound(trickle, 120.0)
    # The standby IS the scheduler now: hand its daemon/config to the
    # cluster so later epochs and stop() manage the live pair.
    cluster.scheduler = standby.daemon
    cluster.scheduler_config = standby.config
    driver.delete_pods(trickle)
    driver.delete_pods(names)
    return unbound


def _run_defrag_epoch(
    cluster: SoakCluster, driver: ChurnDriver, entry: dict, crash: bool
) -> List[str]:
    """Fragmenting churn → descheduler cycle(s) → probes bind. Every
    node gets `fillers_per_node` 1000m fillers bound DIRECTLY (the
    exact stranded placement, not the solver's), then 2000m probes
    pend against the 1000m shards until the defrag plan pairs fillers
    up. The crash variant kills the daemon mid-move (the armed
    DESCHED_MOVE_CRASH site raises between eviction and recreation)
    and a FRESH daemon must recover from the journal — the evicted
    pod re-pends and binds, stranding nothing."""
    name = entry["epoch"]
    prefix = driver.next_prefix(name)
    nodes = sorted(k.node_name for k in cluster.kubelets)
    wires: List[dict] = []
    fillers: List[str] = []
    for j, node in enumerate(nodes):
        for i in range(entry["fillers_per_node"]):
            nm = f"{prefix}-f{j}-{i}"
            fillers.append(nm)
            wires.append(_pod_wire(nm, cpu="1", node=node))
    driver.create_pods(wires)
    _wait_until(
        lambda: all(
            driver.mirror.bound_node(f"default/{n}") for n in fillers
        ),
        timeout=60.0,
    )
    probes = [f"{prefix}-p{i}" for i in range(entry["probe_pods"])]
    s0 = int(capmod.DEFAULT.snapshot().get("samples", 0))
    driver.create_pods([_pod_wire(n, cpu="2", mem="512Mi") for n in probes])
    # Let the daemon take a capacity sample with the probes pending so
    # the backlog quantiles join the probe set the planner optimizes.
    _wait_until(
        lambda: int(capmod.DEFAULT.snapshot().get("samples", 0)) > s0,
        timeout=15.0,
    )

    def fresh_daemon() -> Descheduler:
        return Descheduler(
            cluster.client(),
            frag_threshold=entry["frag_threshold"],
            move_budget=entry["move_budget"],
            disruption_cap=entry["move_budget"],
            wait_timeout_s=10.0,
            device=cluster.device,
        )

    desched = fresh_daemon()
    if crash:
        rule = _arm(entry["rule"])
        try:
            desched.sync_once()
        except Exception:
            pass  # the daemon "died" mid-move; the journal survives
        faults.clear()
        if not rule.fired:
            raise RuntimeError(
                "DESCHED_MOVE_CRASH armed but never fired mid-defrag"
            )
        desched = fresh_daemon()  # the restarted process

    def moves_settled() -> bool:
        # Every pin-annotated replacement has rebound: planning the
        # next cycle against a mid-flight cluster (evictees still
        # re-pending) reads as emptier than it is and churns moves
        # with no improvement.
        try:
            pods, _ = cluster.client().list_wire("pods")
        except Exception:
            return False
        return all(
            _node_of(p)
            for p in pods
            if _annotations(p).get(REBALANCE_DEST_ANNOTATION)
        )

    pending_probes = set(probes)
    for _ in range(entry["probe_pods"] + 2):
        summary = desched.sync_once()
        if summary.get("triggered"):
            driver.rebalance_log.append({
                "epoch": name,
                "score_before": summary["score_before"],
                "score_after": summary["score_after"],
                "improvement": summary["improvement"],
                "moves_executed": summary["moves_executed"],
                "recovered": summary.get("recovered", 0),
            })
            if summary.get("moves_executed"):
                _wait_until(moves_settled, timeout=30.0)
        pending_probes = {
            p for p in pending_probes
            if not driver.mirror.bound_node(f"default/{p}")
        }
        if not pending_probes:
            break
        time.sleep(0.5)
    unbound = driver.wait_bound(probes, 150.0)
    # One settling pass: completed moves flip to `rebound`, stale pins
    # are swept — with the backlog drained it plans nothing new.
    desched.sync_once()
    driver.delete_pods(probes, graceful_frac=0.0)
    driver.delete_pods(fillers, graceful_frac=0.0)
    return unbound


def _run_pool_epoch(
    cluster: SoakCluster, driver: ChurnDriver, entry: dict
) -> List[str]:
    """Elastic node-pool loop: a backlog no base node can hold starves
    the autoscaler into growing 8-CPU hollow nodes; once the backlog
    binds and is deleted, sustained idle cordon-drain-shrinks the pool
    back to empty — through the descheduler's eviction path, never a
    force-delete."""
    name = entry["epoch"]
    prefix = driver.next_prefix(name)
    pool = cluster.node_pool(name=f"{prefix}-nd")
    scaler = Autoscaler(
        cluster.client(),
        pool,
        min_size=0,
        max_size=max(4, entry["big_pods"]),
        grow_after=entry["grow_after"],
        grow_step=1,
        shrink_after=entry["shrink_after"],
        low_util=0.9,
        descheduler=Descheduler(
            cluster.client(), wait_timeout_s=10.0, device=cluster.device
        ),
        device=cluster.device,
    )
    big = [f"{prefix}-big-{i}" for i in range(entry["big_pods"])]
    driver.create_pods([_pod_wire(n, cpu="6", mem="1Gi") for n in big])
    deadline = time.monotonic() + 180.0
    while time.monotonic() < deadline:
        scaler.sync_once()
        if all(driver.mirror.bound_node(f"default/{n}") for n in big):
            break
        time.sleep(1.0)
    unbound = driver.wait_bound(big, 30.0)
    driver.delete_pods(big, graceful_frac=0.0)
    deadline = time.monotonic() + 180.0
    while pool.size() > 0 and time.monotonic() < deadline:
        scaler.sync_once()
        time.sleep(1.0)
    leftover = pool.node_names()
    if leftover:
        for nm in list(leftover):
            pool.shrink(nm)  # later epochs must see the base fleet
        raise RuntimeError(
            f"autoscaler never drained the elastic pool: {leftover}"
        )
    return unbound


# -- CLI ---------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m kubernetes_tpu_torch.soak",
        description="hollow-node chaos soak (see module docstring)",
    )
    p.add_argument("--nodes", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--epochs", default="",
        help=f"comma-separated subset of: {','.join(EPOCHS)} "
        "(default: all)",
    )
    p.add_argument(
        "--no-fsync", dest="fsync", action="store_false", default=True,
        help="trade the fsync-before-ack contract for wall time",
    )
    p.add_argument("--data-dir", default="", help="default: a tempdir")
    p.add_argument("--out", default="", help="write the JSON artifact here")
    p.add_argument("--quiet", action="store_true")
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where K1 and K2 run (cuda: the card, raising without one)",
    )
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    epochs = [e.strip() for e in args.epochs.split(",") if e.strip()] or None
    artifact = run_soak(
        n_nodes=args.nodes,
        seed=args.seed,
        epochs=epochs,
        data_dir=args.data_dir or None,
        fsync=args.fsync,
        verbose=not args.quiet,
        device=args.device,
    )
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(artifact, f, indent=2, sort_keys=True)
    fired = sum(s["fired"] for s in artifact["faults_injected"].values())
    print(json.dumps({
        k: artifact[k]
        for k in ("seed", "nodes", "pods_bound", "bind_p99_s",
                  "post_fault_bind_p99_s", "restarts", "wall_s")
    }, sort_keys=True))
    al = artifact["alerts"]
    fired_rules = sorted({
        t["rule"] for t in al["timeline"] if t["to"] == "firing"
    })
    print(
        f"alerts: {len(al['timeline'])} transition(s), "
        f"fired={','.join(fired_rules) or 'none'}, "
        f"firing-at-end={','.join(al['firing_at_end']) or 'none'}"
        + (
            f", coverage-gaps={','.join(al['coverage_gaps'])}"
            if al["coverage_gaps"] else ""
        )
    )
    if artifact["invariant_violations"]:
        print(f"soak FAILED: {len(artifact['invariant_violations'])} "
              "invariant violation(s):", file=sys.stderr)
        for v in artifact["invariant_violations"]:
            print(f"  [{v['epoch']}] {v['invariant']}: {v['detail']}",
                  file=sys.stderr)
        return 1
    print(f"soak OK: {fired} fault(s) fired across "
          f"{len(artifact['epochs'])} epoch(s), "
          f"{artifact['pods_bound']} pods bound, zero invariant violations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
