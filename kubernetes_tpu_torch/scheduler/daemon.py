"""The scheduler daemons: watch-fed caches -> schedule -> bind.

The port's copy of the daemons of `kubernetes_tpu/scheduler/daemon.py`
(reference: plugin/pkg/scheduler/scheduler.go, factory/factory.go):

- `SchedulerConfig` wires the caches: the unassigned-pod FIFO fed by a
  `spec.nodeName=` reflector; informers for the scheduled pods, nodes,
  services and podgroups whose deltas reach a daemon through the
  `cluster_events` hook; the assumed-pod modeler and its merged pod
  lister; the Ready-filtered node lister; the binder, the optional bind
  `TokenBucket` (`bind_qps`) and the retry `Backoff`; the algorithm spec
  of the policy file, or else of the algorithm provider, and the scalar
  plugin set built from it (`algorithm`, a `GenericScheduler`).
- `Scheduler` is the per-pod daemon (scheduler.go:109-158): each step
  pops one pod, runs the scalar plugins over the Ready nodes, binds it
  with one POST and assumes it; a pod that fits nowhere or whose bind
  fails gets an event (FailedScheduling, FailedBinding) and is queued
  again after its backoff (`_requeue_later`). Host only: it never
  touches a card. Its loop contains crashes as JAX's does (a step that
  raises waits 0.1 s and goes on). The retry code the batch daemons
  share lives here too.
- `BatchScheduler` (a `Scheduler`, as in JAX) is the full re-lower
  daemon: each tick drains the
  queue (a 0.02 s window, up to 65,536 pods, highest priority first),
  lowers the whole cluster from the caches, solves once and commits
  inline on the tick's thread. Its route is decided once, at
  construction: a policy that lowers to the card runs
  `schedule_backlog(spec=...)` (the policy scan kernel; a wave or
  Sinkhorn mode is forced to the scan, with a warning); a policy with no
  device lowering runs `schedule_backlog_scalar(spec=...)`, logged once;
  a sidecar path solves through `ops.sidecar.SidecarSolver` (phase
  `solve_sidecar`); otherwise `schedule_backlog`,
  `schedule_backlog_wave` or `schedule_backlog_sinkhorn` on the card.
  Gangs go through `scheduler.gang.gang_solve` around whichever solver
  runs; preemption follows the binds. The scalar and sidecar routes
  never touch this process's card: their victim selection is
  `preempt_backlog_scalar` (as in JAX), and they resolve no device.
- `IncrementalBatchScheduler` (a `BatchScheduler`, as in JAX) keeps a
  `SolverSession` on the card across ticks: watch deltas patch node
  rows, and each tick uploads only its pending pods. The drain is
  event-driven (one wake event fed by queue arrivals, deltas and commit
  releases, with a coalescing window once a sweep finds `COALESCE_MIN`
  pods). Tick k's binds run on one commit worker thread while tick k+1
  solves (`solve_async`), and the worker keeps tick order. Gang ticks
  solve synchronously through `solve_gang`; accepted groups commit with
  `bind_bulk(atomic=True)`. Pods the solve cannot place go through the
  preemption pass (victim selection on the card,
  `scheduler.batch.preempt_backlog`) and back to the queue after their
  backoff, released early when capacity frees. The default policy only.

What the two batch daemons share lives in `BatchScheduler`: gang
groups, atomic group binds, preemption, the handling of bind outcomes,
the flight recorder and the capacity plane.

Every tick with pods is one trace (`tracing.trace("schedule_batch")`,
its pod set for the pod filter, an `enqueue` child from the drain's
start) and lands in `utils.flightrecorder.DEFAULT` after its binds and
before the preemption pass (`_record_decisions`): one SolveRecord
(mode, pods, solve seconds, the waves and Sinkhorn figures, `incremental`)
and one Decision a pod (bound, bind_conflict, bind_error,
unschedulable or gang_rejected, node, group). For the default spec on
the daemon's card, up to `explain_limit()` pods a tick (unbound ones
first) get their per-node verdict tables from `ops.pipeline.
explain_backlog` in phase `explain`: unbound pods against the
occupancy after the solve, bound ones against the one before it. The
policy, scalar and sidecar routes record outcomes without tables. The
preemption pass then amends the unbound pods' newest records
(preempt_infeasible, preempt_gang_partial, preempt_evict_failed,
preempt_nominated). The started incremental daemon records on its
commit worker, in tick order, and sheds: unbound pods are explained
inline, bound pods' tables of the newest four ticks wait until the
solve loop has been quiet for `_EXPLAIN_QUIET_S` with no tick running
or in flight, and the worker's idle wait attaches them (departure (h)).

Each resolved tick ends with a capacity sample (`_sample_capacity`,
phase `capacity`): the backlog's shapes noted, the
session's host columns (or, with no session, `cluster_columns` of the
caches) reported by `utils.capacity.DEFAULT` on the daemon's card (on
the CPU for the scalar and sidecar routes, which keep no card), with the
queue's depth and the age of the pod at its head. An idle tick samples
when no sample was taken for `CAPACITY_IDLE_REFRESH_S`, and `start()`
warms the report on a thread. The sample feeds
`capacity_zero_headroom_ticks_total`, which an autoscaler in the same
process reads (`controllers/autoscaler.py`).

Started (`start()`), a daemon runs its loop on a thread; a daemon that
was never started ticks synchronously, one `schedule_batch()` a call,
with commits inline. The JAX incremental daemon's fixed-tick mode
(`microticks=False`) and its tuning arguments (`pod_bucket`,
`coalesce_min`, `commit_depth`) are not carried: the port runs their
defaults. `--batch-mode auto` resolves as in JAX
(`scheduler.batch.resolve_batch_mode`): the daemons thread no device
mesh through their solves, as JAX's do not, so auto is the scan unless
`KT_MESH_DEVICES=N` names a mesh of N CUDA devices (`env_mesh`); then
it is the wave, run unsharded in the daemon's one process, as in JAX.
A sharded solve is the backlog entry points' `mesh=`.

Departures from the JAX daemons:

- (a) Failures. In the incremental daemon a `RebuildRequired` or a
  service-set change invalidates the session, and the same tick's pods
  are solved again on a session rebuilt from the caches (the JAX daemon
  falls to its full re-lower tick instead; both are the exact
  sequential solve, so the decisions are the same when the tick held the
  whole queue: the JAX fallback queues the tick's pods again behind the
  rest). A session is built with vocabularies sized from the caches and
  the tick's pods (`vocab_widths`: every token with a quarter more of
  headroom), so a rebuild holds what overflowed the old one; the JAX
  session keeps 128 tokens each, and its daemon re-lowers every tick of
  a cluster that has more. Should the rebuilt session overflow too
  (tokens that arrived during the rebuild), the tick's pods go back to
  the queue for the next tick: capacity is not a device error. Any
  other exception of a tick, in either daemon, is not caught: it is
  logged, counted in `device_errors`, and raised out of
  `schedule_batch`, and `run()` then stops the daemon. The JAX
  `BatchScheduler` solves such a tick again on its scalar path when the
  card or the sidecar fails; the port's does not, so a broken card or
  sidecar never schedules on the CPU. The scalar path runs only for a
  policy that has no device lowering.
- (b) Preemption's victim selection runs on the card only (the scalar
  and sidecar routes: `preempt_backlog_scalar`, as in JAX); its errors
  propagate as in (a). On the commit worker the error is kept and
  raised by the next `schedule_batch`.
- (c) Closed: the chaos seams (`scheduler.commit.crash`,
  `scheduler.evict.error`) and the sanitizer's `scheduler.capacity` lock
  sit where JAX's do (`utils/faults.py`, `utils/sanitizer.py`).
- (d) Telemetry errors. An error of the explain readback on the card
  is a tick error as in (a) (inline), or a commit worker error as in
  (b) (the deferred half); an error of the capacity sample is a tick
  error as in (a). The JAX daemon logs each at debug level and drops
  it. The backlog's age in the capacity sample is that of the queue's
  head pod by its creation stamp (the JAX daemon reads the lifecycle
  collector of an apiserver in its own process).
- (e) The scheduled-pods cache defaults to the wire form
  (`raw_scheduled_cache=True`), which the incremental daemon wants: its
  session tracks its own bound pods, so fully decoding every bind and
  delete event would be the reflector threads' main cost under churn.
  The JAX config defaults to the typed form. The full re-lower daemon
  reads every scheduled pod each tick, so its command builds the
  config with `raw_scheduled_cache=False`, as the JAX command does.
- (f) Closed: the per-pod `Scheduler` is here, and the command boots it
  without a batch flag, as JAX's does (`cmd/scheduler.py`).
- (g) A pod the incremental daemon drains while its session still holds
  the pod's key (a pod recreated under the name of one whose delete has
  not reached the session yet, as a descheduler's replacement is, or a
  stale copy of a pod bound since) goes to the retry backoff, which
  refetches it and queues it again if it is still pending. The JAX
  daemon drops it from the tick, and it comes back only with its next
  watch event: for a replacement, the nomination sweep 30 s on, which
  also unpins it.
- (h) Explain cadence. The deferred bound-pod tables wait for
  `_EXPLAIN_QUIET_S` after the end of the solve loop's last tick (an
  idle tick that resolves the in-flight one counts); the JAX daemon
  counts from the tick's start, so a tick longer than that
  opens its gate while pods keep arriving, and the capture (the
  lowering of every node, the pod lister's decode of every bound pod)
  then holds the interpreter on the commit worker during the load. A
  session built with `prewarm_buckets` also runs the explain readback
  once, on one node, so the first pod explained pays no first use of
  the readback's operations on the card.
- (i) A tick's decisions reach the decision sinks (the lifecycle
  collector's decision milestone) before its binds land, and again with
  its records; the JAX daemon announces them after its binds, which a
  hollow kubelet can outrun (ROADMAP queue 3).
"""

from __future__ import annotations

import collections
import copy
import logging
import math
import queue
import threading
import time
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch import DeviceLike, resolve_device
from kubernetes_tpu_torch.client.cache import FIFO, Informer, Reflector, ThreadSafeStore
from kubernetes_tpu_torch.client.rest import APIError
from kubernetes_tpu_torch.models import serde
from kubernetes_tpu_torch.models.algspec import UnloweredPolicyError, lower_spec
from kubernetes_tpu_torch.models.columnar import (
    mem_to_mib_ceil,
    node_is_ready,
    pod_resource_limits,
)
from kubernetes_tpu_torch.models.objects import (
    Node,
    Pod,
    PodGroup,
    Service,
    parse_iso,
    pod_can_preempt,
    pod_full_key,
    pod_priority,
)
from kubernetes_tpu_torch.ops.incremental import (
    RebuildRequired,
    SessionGang,
    SolverSession,
    vocab_widths,
)
from kubernetes_tpu_torch.ops.pipeline import explain_backlog, gang_member_counts_device
from kubernetes_tpu_torch.ops.preemption import REASON_INFEASIBLE
from kubernetes_tpu_torch.scheduler import gang
from kubernetes_tpu_torch.scheduler.batch import (
    BATCH_MODES,
    preempt_backlog,
    preempt_backlog_scalar,
    resolve_batch_mode,
    schedule_backlog,
    schedule_backlog_scalar,
    schedule_backlog_sinkhorn,
    schedule_backlog_wave,
)
from kubernetes_tpu_torch.scheduler.generic import FitError, GenericScheduler, NoNodesError
from kubernetes_tpu_torch.scheduler.modeler import SimpleModeler
from kubernetes_tpu_torch.scheduler.plugins import (
    DEFAULT_PROVIDER,
    PluginFactoryArgs,
    build_from_spec,
    spec_for_policy,
    spec_for_provider,
)
from kubernetes_tpu_torch.scheduler.types import StaticServiceLister
from kubernetes_tpu_torch.utils import (
    capacity,
    faults,
    flightrecorder,
    metrics,
    profiler,
    sanitizer,
    sli,
    tracing,
)
from kubernetes_tpu_torch.utils.ratelimit import Backoff, TokenBucket

_LOG = logging.getLogger("kubernetes_tpu_torch.scheduler")

_E2E_LATENCY = metrics.DEFAULT.histogram(
    "scheduler_e2e_scheduling_latency_seconds",
    "E2e scheduling latency (scheduling algorithm + binding)",
)
_ALGO_LATENCY = metrics.DEFAULT.histogram(
    "scheduler_scheduling_algorithm_latency_seconds", "Scheduling algorithm latency"
)
_BIND_LATENCY = metrics.DEFAULT.histogram(
    "scheduler_binding_latency_seconds", "Binding latency"
)
_SCHEDULED = metrics.DEFAULT.counter(
    "scheduler_pods_scheduled_total", "Pods successfully bound", ("result",)
)
_PREEMPT_VICTIMS = metrics.DEFAULT.counter(
    "preemption_victims_total", "Pods evicted to make room for higher-priority pods"
)
_PREEMPT_OUTCOMES = metrics.DEFAULT.counter(
    "preemption_solve_outcomes_total", "Per-preemptor preemption solve outcomes by kind",
    ("outcome",),
)
_PREEMPT_NOMINATED = metrics.DEFAULT.gauge(
    "preemption_active_nominations", "Pending pods currently holding a nominated node"
)

#: The apiserver's grace for an eviction that names none.
DEFAULT_EVICTION_GRACE_SECONDS = 5

#: Seconds past the victims' grace a nomination stays live before the
#: preemptor may preempt again (covers the kubelet's confirm lag).
NOMINATION_SLACK_SECONDS = 10.0


#: The pod a prewarmed session's explain readback runs once.
_EXPLAIN_WARM_POD = {
    "metadata": {"name": "explain-prewarm", "namespace": "default"},
    "spec": {"containers": [{"name": "c", "image": "app", "resources": {
        "limits": {"cpu": "100m", "memory": "64Mi"}}}]},
}


def _decode_pod(wire: dict) -> Pod:
    return serde.from_wire(Pod, wire)


def _decode_node(wire: dict) -> Node:
    return serde.from_wire(Node, wire)


def _decode_service(wire: dict) -> Service:
    return serde.from_wire(Service, wire)


def _decode_podgroup(wire: dict) -> PodGroup:
    return serde.from_wire(PodGroup, wire)


def _key(pod: Pod) -> str:
    return f"{pod.metadata.namespace or 'default'}/{pod.metadata.name}"


class _StoreServiceLister(StaticServiceLister):
    """The services cache as the scalar plugins' service lister."""

    def __init__(self, store: ThreadSafeStore):
        self.store = store

    @property
    def services(self) -> List[Service]:
        return self.store.list()


class _StoreNodeLister:
    """Ready-filtered node lister (reference: StoreToNodeLister with its
    NodeCondition filter, factory.go:166,209): what the per-pod
    scheduler places onto."""

    def __init__(self, store: ThreadSafeStore):
        self.store = store

    def list(self) -> List[Node]:
        return [n for n in self.store.list() if node_is_ready(n)]

    def get(self, name: str) -> Node:
        # Nodes are cluster-scoped: the store's key is the bare name.
        node = self.store.get(name)
        if node is None:
            raise KeyError(f"node {name!r} not found")
        return node


class SchedulerConfig:
    """Wires the caches (reference: factory.CreateFromKeys).

    `raw_scheduled_cache` keeps the scheduled-pods cache in wire form,
    decoded on access (departure (e): the port's default, for the
    incremental daemon); False decodes each event, the form the full
    re-lower and per-pod daemons read. `policy` (a policy document), or
    else `provider_name`, gives `algorithm_spec` and the scalar plugin
    set the per-pod daemon runs (`algorithm`); the incremental daemon
    refuses any but the default. `bind_qps` > 0 throttles the per-pod
    daemon's binds (a burst of 20, factory.go:43-46); the batch daemons
    never throttle their bulk binds."""

    #: Seconds an assumed binding counts before the watch must confirm it.
    ASSUME_TTL_S = 30.0

    def __init__(
        self,
        client,
        provider_name: str = DEFAULT_PROVIDER,
        policy: Optional[dict] = None,
        raw_scheduled_cache: bool = True,
        bind_qps: float = 0.0,
    ):
        self.client = client
        self.raw_scheduled_cache = raw_scheduled_cache
        # Unassigned pods -> FIFO (factory.go:180-186). A DELETED event
        # (the pod bound or removed) needs only its key.
        self.pod_queue = FIFO()
        self._pod_reflector = Reflector(
            client, "pods", self.pod_queue, field_selector="spec.nodeName=",
            decode=_decode_pod, decode_deleted=False,
        )
        # Delta hook (kind, event type, object), called from the
        # reflector threads: a subscriber must only enqueue.
        self.cluster_events: Optional[Callable[[str, str, object], None]] = None

        def _emit(kind: str, etype: str):
            def handler(obj, _k=kind, _e=etype):
                cb = self.cluster_events
                if cb is not None:
                    cb(_k, _e, obj)
            return handler

        self.scheduled_pods = Informer(
            client, "pods", field_selector="spec.nodeName!=",
            decode=None if raw_scheduled_cache else _decode_pod,
            on_add=_emit("pod", "ADDED"), on_update=_emit("pod", "MODIFIED"),
            on_delete=_emit("pod", "DELETED"), decode_deleted=False,
        )
        self.nodes = Informer(
            client, "nodes", decode=_decode_node,
            on_add=_emit("node", "ADDED"), on_update=_emit("node", "MODIFIED"),
            on_delete=_emit("node", "DELETED"),
        )
        self.services = Informer(
            client, "services", decode=_decode_service,
            on_add=_emit("service", "ADDED"), on_update=_emit("service", "MODIFIED"),
            on_delete=_emit("service", "DELETED"),
        )
        # Gang partitioning reads PodGroup specs here, not by a LIST a tick.
        self.podgroups = Informer(client, "podgroups", decode=_decode_podgroup)

        # A LIST lands typed pods in the cache and the watch wire dicts.
        def _scheduled_typed() -> List[Pod]:
            return [_decode_pod(p) if isinstance(p, dict) else p
                    for p in self.scheduled_pods.store.list()]

        self.modeler = SimpleModeler(scheduled_pods=_scheduled_typed, ttl=self.ASSUME_TTL_S)
        self.pod_lister = self.modeler.pod_lister()
        self.node_lister = _StoreNodeLister(self.nodes.store)
        self.service_lister = _StoreServiceLister(self.services.store)
        self.algorithm_spec = (spec_for_policy(policy) if policy is not None
                               else spec_for_provider(provider_name))
        self.predicates, self.priorities = build_from_spec(
            self.algorithm_spec,
            PluginFactoryArgs(pod_lister=self.pod_lister, service_lister=self.service_lister,
                              node_lister=self.node_lister))
        self.algorithm = GenericScheduler(self.predicates, self.priorities, self.pod_lister)
        self.binder = client
        self.backoff = Backoff(initial=1.0, max_backoff=60.0)
        self.bind_limiter = TokenBucket(bind_qps, 20) if bind_qps > 0 else None

    def _reflectors(self):
        return (self._pod_reflector, self.scheduled_pods, self.nodes, self.services,
                self.podgroups)

    def start(self) -> "SchedulerConfig":
        for x in self._reflectors():
            x.start()
        return self

    def wait_for_sync(self, timeout: float = 10.0) -> bool:
        return all(x.wait_for_sync(timeout) for x in self._reflectors())

    def stop(self) -> None:
        self.pod_queue.close()
        for x in self._reflectors():
            x.stop()


def lowers(spec) -> bool:
    """Whether an algorithm spec has a device lowering (the default spec
    has)."""
    try:
        lower_spec(spec)
    except UnloweredPolicyError:
        return False
    return True


class Scheduler:
    """The per-pod daemon (reference: scheduler.go:109-158); see the
    module text. Host only."""

    def __init__(self, config: SchedulerConfig):
        self.config = config
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Capacity-freed signal: a retry backoff is an event wait, and a
        # capacity event (the incremental daemon's pod DELETED or node
        # ADDED delta) bumps the epoch, releasing every backlogged pod.
        # The other daemons have no delta feed: their waits run out.
        self._capacity_cond = threading.Condition(
            sanitizer.lock("scheduler.capacity")
        )
        self._capacity_epoch = 0

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "Scheduler":
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._capacity_cond:
            self._capacity_cond.notify_all()  # wake the backoff waits
        self.config.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _step(self) -> None:
        self.schedule_one()

    def run(self) -> None:
        """Step until stopped. Crash containment (reference:
        util.HandleCrash around every control loop): a step that raises
        waits 0.1 s and the loop goes on."""
        while not self._stop.is_set():
            try:
                self._step()
            except Exception:
                _LOG.debug("scheduling step failed", exc_info=True)
                if not self._stop.is_set():
                    self._stop.wait(0.1)

    def schedule_one(self, timeout: Optional[float] = 0.5) -> bool:
        """Pop one pending pod, schedule it over the Ready nodes, bind
        and assume it; False when no pod came within `timeout`
        (scheduler.go:113-158)."""
        cfg = self.config
        pod = cfg.pod_queue.pop(timeout=timeout)
        if pod is None:
            return False
        if pod.spec.node_name:
            return True  # raced: already bound
        if cfg.bind_limiter is not None:
            cfg.bind_limiter.accept()
        start = time.monotonic()
        with tracing.trace("schedule_one", pod=pod.metadata.name) as tr:
            tr.step("enqueue")
            try:
                t0 = time.monotonic()
                with tracing.span("algorithm"):
                    dest = cfg.algorithm.schedule(pod, cfg.node_lister)
                _ALGO_LATENCY.observe(time.monotonic() - t0)
            except (FitError, NoNodesError, KeyError) as e:
                # KeyError: a node left the cache between the list and a
                # predicate's lookup; an unschedulable attempt, retried.
                _SCHEDULED.inc(result="unschedulable")
                cfg.client.record_event(pod, "FailedScheduling", str(e), source="scheduler")
                self._requeue_later(pod)
                return True
            try:
                t0 = time.monotonic()
                # "bind_one", not "bind": one pod's POST and a tick's bulk
                # commit do not share a series.
                with tracing.phase("bind_one"):
                    cfg.binder.bind(pod.metadata.name, dest,
                                    namespace=pod.metadata.namespace or "default")
                _BIND_LATENCY.observe(time.monotonic() - t0)
            except APIError as e:
                _SCHEDULED.inc(result="bind_error")
                cfg.client.record_event(pod, "FailedBinding", str(e), source="scheduler")
                self._requeue_later(pod)
                return True
            # Assume, so the capacity is held before the watch confirms
            # (scheduler.go:142-157).
            pod.spec.node_name = dest
            cfg.modeler.assume_pod(pod)
            _SCHEDULED.inc(result="scheduled")
            _E2E_LATENCY.observe(time.monotonic() - start)
            cfg.client.record_event(pod, "Scheduled",
                                    f"Successfully assigned {pod.metadata.name} to {dest}",
                                    source="scheduler")
            return True

    # -- retries ------------------------------------------------------

    def _capacity_freed(self) -> None:
        with self._capacity_cond:
            self._capacity_epoch += 1
            self._capacity_cond.notify_all()

    def _backoff_wait(self, delay: float, epoch: Optional[int] = None) -> bool:
        """Wait out a retry backoff, returning early (True) when capacity
        frees or the daemon stops. `epoch` is the capacity epoch the
        failed solve read its state at (None: now), so capacity freed
        between that solve and this wait still releases at once."""
        deadline = time.monotonic() + delay
        with self._capacity_cond:
            base = self._capacity_epoch if epoch is None else epoch
            while not self._stop.is_set():
                if self._capacity_epoch != base:
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._capacity_cond.wait(min(remaining, 5.0))
        return False

    def _refetch_and_requeue(self, pod: Pod) -> None:
        """Re-fetch `pod` and queue it again if still pending; drop it
        only when the apiserver says it is gone (404). Any other error
        retries with the snapshot (the bind's emptiness check still
        guards against a double assignment)."""
        try:
            fresh = self.config.client.get("pods", pod.metadata.name,
                                           namespace=pod.metadata.namespace or "default")
        except APIError as e:
            if e.code == 404:
                return
            fresh = pod
        except Exception:
            fresh = pod
        if not fresh.spec.node_name:
            self.config.pod_queue.add(fresh)

    def _requeue_later(self, pod: Pod) -> None:
        """One pod's retry after its backoff on a thread of its own, then
        re-fetched (factory.go:257-286)."""
        delay = self.config.backoff.duration(f"{pod.metadata.namespace}/{pod.metadata.name}")

        def later():
            self._backoff_wait(delay)
            if self._stop.is_set():
                return
            self._refetch_and_requeue(pod)

        threading.Thread(target=later, daemon=True).start()

    def _requeue_many(self, pods: List[Pod], epoch: Optional[int] = None) -> None:
        """One worker thread queues the rejected set again at each pod's
        backoff deadline (factory.go:257-286); one capacity event
        releases the whole set."""
        if not pods:
            return
        now = time.monotonic()
        schedule = sorted(
            (now + self.config.backoff.duration(f"{p.metadata.namespace}/{p.metadata.name}"), i)
            for i, p in enumerate(pods)
        )

        def worker():
            released = False
            for deadline, i in schedule:
                wait = deadline - time.monotonic()
                if wait > 0 and not released:
                    released = self._backoff_wait(wait, epoch)
                if self._stop.is_set():
                    return
                self._refetch_and_requeue(pods[i])

        threading.Thread(target=worker, daemon=True).start()


class BatchScheduler(Scheduler):
    """The full re-lower batch daemon (see the module text).

    `device` is where the card routes solve (None: the CUDA card,
    raising without one; not resolved by the scalar and sidecar
    routes); `mode` the solver, scan, wave, sinkhorn or auto (the scan);
    `sidecar_path` a solver sidecar's socket. A tick drains up to
    `max_batch` pods within `batch_window` seconds of the first; victims
    of a preemption get `eviction_grace_seconds` to exit."""

    def __init__(
        self,
        config: SchedulerConfig,
        max_batch: int = 65536,
        batch_window: float = 0.02,
        mode: str = "scan",
        sidecar_path: Optional[str] = None,
        eviction_grace_seconds: Optional[int] = None,
        device: DeviceLike = None,
    ):
        mode = resolve_batch_mode(mode)
        if mode not in BATCH_MODES:
            raise ValueError(f"unknown batch mode {mode!r}")
        super().__init__(config)
        self.mode = mode
        self.max_batch = max_batch
        self.batch_window = batch_window
        self.eviction_grace_seconds = (
            DEFAULT_EVICTION_GRACE_SECONDS if eviction_grace_seconds is None
            else int(eviction_grace_seconds)
        )
        # Ticks (and, in the incremental daemon, commit jobs) that
        # raised: departure (a).
        self.device_errors = 0
        self._errors_lock = threading.Lock()
        # pod key -> (node, priority, monotonic expiry) of a nomination.
        self._nominations: Dict[str, Tuple[str, int, float]] = {}
        self._missing_groups: Dict[str, float] = {}
        # The route, decided once: a non-default spec lowers to the
        # policy scan or pins the daemon to the scalar path.
        spec = config.algorithm_spec
        self.spec = None if spec.is_default() else spec
        self.policy_scalar = self.spec is not None and not lowers(self.spec)
        if self.policy_scalar:
            _LOG.warning("scheduler policy is not device-lowerable; batch mode will run the "
                         "configured plugins on the scalar path")
        elif self.spec is not None and self.mode != "scan":
            _LOG.warning("batch mode %r does not support non-default scheduler policy; "
                         "using the policy-aware scan solver instead", self.mode)
            self.mode = "scan"
        self.sidecar = None
        if sidecar_path and not self.policy_scalar:
            from kubernetes_tpu_torch.ops.sidecar import SidecarSolver

            self.sidecar = SidecarSolver(sidecar_path)
        on_card = not self.policy_scalar and self.sidecar is None
        self.device = resolve_device(device) if on_card else None
        self._solve = self._route()
        # The gang acceptance reducer: on the card with the solve, else
        # gang_solve's host reducer.
        self._counts_fn = (partial(gang_member_counts_device, device=self.device)
                           if on_card else None)
        # The capacity report runs with the solve, or on the CPU for the
        # routes that keep no card.
        self._capacity_device = self.device if on_card else resolve_device("cpu")
        self._capacity_sampled_mono = 0.0

    def _route(self) -> Callable:
        """The tick's solver, (pending, nodes, assigned, services) ->
        node names."""
        if self.policy_scalar:
            return partial(schedule_backlog_scalar, spec=self.spec)
        if self.sidecar is not None:
            sidecar, mode, spec = self.sidecar, self.mode, self.spec

            def solve_sidecar(pending, nodes, assigned, services):
                # The whole round trip: the sidecar's own phases run in
                # its process.
                with tracing.phase("solve_sidecar", mode=mode):
                    return sidecar.solve(pending, nodes, assigned, services, mode=mode, spec=spec)

            return solve_sidecar
        if self.mode == "wave":
            return partial(schedule_backlog_wave, device=self.device)
        if self.mode == "sinkhorn":
            return partial(schedule_backlog_sinkhorn, device=self.device)
        return partial(schedule_backlog, device=self.device, spec=self.spec)

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "BatchScheduler":
        self._warm_capacity()
        return super().start()

    def run(self) -> None:
        """Tick until stopped; a tick that raises stops the daemon
        (departure (a))."""
        while not self._stop.is_set():
            try:
                self.schedule_batch()
            except Exception:
                _LOG.error("the scheduler stops after a failed tick")
                self._stop.set()

    # -- gangs ------------------------------------------------------------

    def _gang_groups(self, pending: List[Pod], assigned=None):
        """The drained backlog's PodGroups (empty when no pod carries the
        group label). Specs come from the podgroups informer; a miss
        makes one read-through LIST, and a group absent from that LIST
        is remembered as deleted for 30 s. None when the LIST failed
        transiently: the caller defers the grouped pods rather than
        scheduling them one by one."""
        needed = {
            gang.group_key(p.metadata.namespace or "default", name)
            for p in pending
            for name in (gang.pod_group_name(p),)
            if name
        }
        if not needed:
            return []
        by_key = {gang.group_key(pg.metadata.namespace, pg.metadata.name): pg
                  for pg in self.config.podgroups.store.list()}
        now = time.monotonic()
        missing = {k for k in needed - by_key.keys() if self._missing_groups.get(k, 0.0) <= now}
        if missing:
            try:
                pgs, _ = self.config.client.list("podgroups")
            except APIError as e:
                if e.code in (400, 404):
                    return []  # the resource is not served
                return None
            except Exception:
                return None
            by_key = {gang.group_key(pg.metadata.namespace, pg.metadata.name): pg for pg in pgs}
            if len(self._missing_groups) > 4096:
                self._missing_groups.clear()
            for k in needed - by_key.keys():
                self._missing_groups[k] = time.monotonic() + 30.0

        def min_member_of(ns: str, name: str):
            pg = by_key.get(gang.group_key(ns, name))
            return pg.spec.min_member if pg is not None else None

        if assigned is None:
            assigned = self.config.pod_lister.list()
        return gang.partition_backlog(pending, assigned=assigned, min_member_of=min_member_of)

    @staticmethod
    def _split_deferred_gangs(pending: List[Pod]) -> Tuple[List[Pod], List[Pod]]:
        """(ungrouped, grouped): grouped pods wait for resolvable specs."""
        ungrouped = [p for p in pending if not gang.pod_group_name(p)]
        grouped = [p for p in pending if gang.pod_group_name(p)]
        return ungrouped, grouped

    def _bind_groups_atomic(self, group_binds, outcome) -> None:
        """Commit each accepted group with bind_bulk(atomic=True): a
        conflict rejects the whole group server-side, and its pods come
        back 409 Aborted."""
        for _gkey, (ns, items) in sorted(group_binds.items()):
            results = self.config.binder.bind_bulk(items, namespace=ns, atomic=True)
            for (pod_name, _dest), res in zip(items, results):
                outcome[(ns, pod_name)] = res
            if any(r.get("status") != "Success" for r in results):
                gang.OUTCOMES.inc(outcome="bind_rollback")

    @staticmethod
    def _bind_retryable(res: dict) -> bool:
        """A failed bind that should requeue: a plain 409 means another
        binder won (drop the pod); 409 Aborted means its gang's atomic
        batch rolled back (still pending)."""
        return res.get("code") != 409 or res.get("reason") == "Aborted"

    # -- commits ------------------------------------------------------------

    def _commit(self, decided, gkey_of: Dict[str, str], denied_keys):
        """Bind a tick's decisions, `decided` (pod, node or None) in
        order: FailedScheduling for the unplaced, the placed ones in one
        bulk call per namespace and each accepted group atomically, then
        Scheduled and the modeler's assumption for each success.
        `gkey_of` maps a pod key to its group, `denied_keys` holds the
        rejected groups. Returns the pods to requeue, and the bind
        outcome of each placed pod by key (bound, bind_conflict or
        bind_error)."""
        cfg = self.config
        # The decision milestone is announced before any bind lands: a
        # hollow kubelet can run a pod before the tick's records do, and
        # the lifecycle collector drops a pod's track once it runs, so a
        # decision announced after the bind is lost (the JAX daemon
        # announces after its binds; the soak's SLO check then flakes).
        flightrecorder.notify_decision_sinks((_key(pod), "") for pod, _dest in decided)
        by_ns: Dict[str, List] = {}
        group_binds: Dict[str, Tuple[str, List[Tuple[str, str]]]] = {}
        placed: List[Tuple[Pod, str]] = []
        rejected: List[Pod] = []
        for pod, dest in decided:
            key = _key(pod)
            if dest is None:
                _SCHEDULED.inc(result="unschedulable")
                gkey = gkey_of.get(key)
                message = (f'pod group "{gkey}" rejected: fewer than minMember pods schedulable'
                           if gkey in denied_keys else "no node fits")
                cfg.client.record_event(pod, "FailedScheduling", message, source="scheduler")
                rejected.append(pod)
                continue
            ns = pod.metadata.namespace or "default"
            gkey = gkey_of.get(key)
            if gkey is not None:
                group_binds.setdefault(gkey, (ns, []))[1].append((pod.metadata.name, dest))
            else:
                by_ns.setdefault(ns, []).append((pod.metadata.name, dest))
            placed.append((pod, dest))

        t0 = time.monotonic()
        outcome: Dict[Tuple[str, str], dict] = {}
        with tracing.phase("bind", pods=len(placed)):
            try:
                for ns, items in by_ns.items():
                    for (pod_name, _dest), res in zip(items, cfg.binder.bind_bulk(items,
                                                                                 namespace=ns)):
                        outcome[(ns, pod_name)] = res
                self._bind_groups_atomic(group_binds, outcome)
            except Exception:
                _LOG.warning("bulk bind failed; unrecorded pods retry", exc_info=True)
        if by_ns or group_binds:
            _BIND_LATENCY.observe(time.monotonic() - t0)

        bind_outcome: Dict[str, str] = {}
        for pod, dest in placed:
            ns = pod.metadata.namespace or "default"
            key = f"{ns}/{pod.metadata.name}"
            res = outcome.get((ns, pod.metadata.name), {})
            if res.get("status") == "Success":
                pod.spec.node_name = dest
                cfg.modeler.assume_pod(pod)
                self._nominations.pop(key, None)
                _SCHEDULED.inc(result="scheduled")
                bind_outcome[key] = "bound"
                cfg.client.record_event(pod, "Scheduled",
                                        f"Successfully assigned {pod.metadata.name} to {dest}",
                                        source="scheduler")
            elif not self._bind_retryable(res):
                # Someone else bound it; the pod is not ours to retry.
                self._bind_failed(key)
                _SCHEDULED.inc(result="bind_conflict")
                bind_outcome[key] = "bind_conflict"
            else:
                self._bind_failed(key)
                _SCHEDULED.inc(result="bind_error")
                bind_outcome[key] = "bind_error"
                rejected.append(pod)
        return rejected, bind_outcome

    @staticmethod
    def _decision_rows(decided, gkey_of: Dict[str, str], denied_keys, bind_outcome):
        """The flight recorder's rows of a committed tick: (pod, node or
        None, outcome, group key or None) in the tick's order."""
        rows = []
        for pod, dest in decided:
            key = _key(pod)
            gkey = gkey_of.get(key)
            if dest is None:
                oc = "gang_rejected" if gkey in denied_keys else "unschedulable"
            else:
                oc = bind_outcome.get(key, "bind_error")
            rows.append((pod, dest, oc, gkey))
        return rows

    def _bind_failed(self, key: str) -> None:
        """A placed pod's bind did not succeed (the incremental daemon
        releases its session charge)."""

    # -- preemption -------------------------------------------------------

    def _maybe_preempt(self, unbound: List[Pod], nodes, assigned, groups=()) -> int:
        """Preemption over a tick's unplaceable pods: victim selection,
        the gang guard, then nominate and evict gracefully. Preemptors
        stay in the requeue loop and bind through an ordinary solve once
        their victims exit. Returns nominations granted."""
        now = time.monotonic()
        for key in [k for k, (_, _, exp) in self._nominations.items() if exp <= now]:
            del self._nominations[key]
        candidates = [p for p in unbound if pod_priority(p) > 0 and pod_can_preempt(p)
                      and pod_full_key(p) not in self._nominations]
        _PREEMPT_NOMINATED.set(len(self._nominations))
        if not candidates:
            return 0
        with tracing.phase("preempt", pods=len(candidates)):
            return self._preempt(candidates, unbound, nodes, assigned, now, groups)

    def _preempt(self, candidates, unbound, nodes, assigned, now, groups=()) -> int:
        cfg = self.config
        if self.device is None:
            # The scalar and sidecar routes never touch this process's card.
            decisions = preempt_backlog_scalar(candidates, nodes, assigned)
        else:
            decisions = preempt_backlog(candidates, nodes, assigned, device=self.device)
        solved = list(decisions)
        decisions, dropped = gang.drop_partial_gang_preemptions(
            unbound, candidates, decisions, covered_keys=frozenset(self._nominations),
            groups=groups or (),
        )
        for gkey in dropped:
            _PREEMPT_OUTCOMES.inc(outcome="gang_partial")
            _LOG.info("preemption for pod group %s dropped: not every unbound member could "
                      "be granted a nomination", gkey)
        granted = 0
        for pod, dec, pre_guard in zip(candidates, decisions, solved):
            if dec is None:
                # Either way the pod's decision gains the preemption
                # verdict; a grant the gang guard dropped is counted by
                # its group's gang_partial above.
                if pre_guard is None:
                    _PREEMPT_OUTCOMES.inc(outcome="infeasible")
                    flightrecorder.DEFAULT.record_preemption(
                        pod_full_key(pod), "preempt_infeasible", reason=REASON_INFEASIBLE)
                else:
                    flightrecorder.DEFAULT.record_preemption(
                        pod_full_key(pod), "preempt_gang_partial",
                        reason="pod group preemption dropped: not every unbound member could "
                               "be granted a nomination")
                continue
            ns = pod.metadata.namespace or "default"
            key = pod_full_key(pod)
            evicted = gone = 0
            for vkey in dec.victims:
                vns, _, vname = vkey.partition("/")
                try:
                    # Chaos seam: an injected eviction failure takes the
                    # broad-except path a real transport outage takes:
                    # counted evict_failed below, no nomination recorded,
                    # retried next tick.
                    faults.fire(faults.SCHED_EVICT_ERROR, vkey)
                    cfg.client.evict(vname, namespace=vns,
                                     grace_period_seconds=self.eviction_grace_seconds)
                except APIError as e:
                    if e.code == 404:
                        gone += 1  # already gone: the capacity is free anyway
                        continue
                    _LOG.warning("eviction of %s failed: %s", vkey, e)
                    continue
                except Exception:
                    _LOG.exception("eviction of %s failed", vkey)
                    continue
                evicted += 1
                cfg.client.record_event(
                    {"kind": "Pod", "metadata": {"name": vname, "namespace": vns}},
                    "Preempted", f"Preempted by {key} on node {dec.node}",
                    source="scheduler", namespace=vns,
                )
            _PREEMPT_VICTIMS.inc(evicted)
            if evicted + gone == 0:
                # Nothing freed: a nomination would only hold the
                # preemptor back for grace + slack. Retry next tick.
                _PREEMPT_OUTCOMES.inc(outcome="evict_failed")
                flightrecorder.DEFAULT.record_preemption(
                    key, "preempt_evict_failed", node=dec.node, victims=dec.victims,
                    reason="every victim eviction failed; retrying")
                continue
            try:
                cfg.client.patch("pods", pod.metadata.name,
                                 {"status": {"nominatedNodeName": dec.node}}, namespace=ns)
            except Exception:
                _LOG.debug("nominatedNodeName write for %s failed", key, exc_info=True)
            _PREEMPT_OUTCOMES.inc(outcome="nominated")
            flightrecorder.DEFAULT.record_preemption(key, "preempt_nominated", node=dec.node,
                                                     victims=dec.victims)
            self._nominations[key] = (
                dec.node, pod_priority(pod),
                now + self.eviction_grace_seconds + NOMINATION_SLACK_SECONDS,
            )
            # The nominated pod must contest the freed capacity the tick
            # it appears, not after a grown backoff.
            cfg.backoff.reset(key)
            granted += 1
        _PREEMPT_NOMINATED.set(len(self._nominations))
        return granted

    # -- the capacity plane -------------------------------------------------

    #: Seconds without a sample after which an idle tick takes one.
    CAPACITY_IDLE_REFRESH_S = 2.0

    def _warm_capacity(self) -> None:
        """One report at the cluster's node count on a thread of its own,
        so the first sample does not pay the device's warm-up."""
        def warm():
            try:
                capacity.DEFAULT.warm(len(self.config.nodes.store.list()),
                                      device=self._capacity_device)
            except Exception:
                _LOG.debug("capacity warm failed", exc_info=True)

        threading.Thread(target=warm, daemon=True, name="capacity-warm").start()

    def _backlog_age_s(self) -> float:
        """Seconds since the creation of the pod at the queue's head (0
        with an empty queue or no stamp)."""
        head = self.config.pod_queue.peek()
        born = parse_iso(head.metadata.creation_timestamp) if head is not None else None
        return max(time.time() - born, 0.0) if born is not None else 0.0

    def _sample_capacity(self, pending: Optional[List[Pod]] = None) -> None:
        """One capacity sample in its own `capacity` phase: the pending
        pods' shapes noted, then the report of the session's host
        columns, or with no session of the caches' columns. Raises what
        the report raises."""
        cfg = self.config
        if pending:
            shapes = []
            for pod in pending:
                cpu, mem = pod_resource_limits(pod)
                shapes.append((float(cpu), float(mem_to_mib_ceil(mem))))
            capacity.DEFAULT.note_backlog_shapes(shapes)
        session = getattr(self, "_session", None)
        with tracing.phase("capacity"):
            if session is not None:
                cols, names = capacity.session_columns(session)
            else:
                cols, names = capacity.cluster_columns(cfg.nodes.store.list(),
                                                       cfg.pod_lister.list())
            capacity.DEFAULT.sample(cols, names, backlog_depth=len(cfg.pod_queue),
                                    oldest_age_s=self._backlog_age_s(),
                                    device=self._capacity_device)
        self._capacity_sampled_mono = time.monotonic()

    def _refresh_capacity_idle(self) -> None:
        """An idle tick's sample, when none was taken for
        CAPACITY_IDLE_REFRESH_S: the series keep moving on a quiet
        cluster."""
        if time.monotonic() - self._capacity_sampled_mono < self.CAPACITY_IDLE_REFRESH_S:
            return
        self._sample_capacity()

    # -- the flight recorder ------------------------------------------------

    def _record_decisions(self, rows, nodes, services, assigned_pre, solve_s=0.0,
                          stats=None) -> None:
        """One SolveRecord for the tick and one Decision a drained pod
        (outcome, node, group), with bounded per-node verdict tables
        captured in their own `explain` phase on the daemon's card.
        `rows` are (pod, node or None, outcome, group key or None);
        `assigned_pre` is the occupancy before the solve (None: the pod
        lister's less this tick's binds, the incremental daemon's
        shape). Runs before the preemption pass, which amends the
        unbound pods' records. Raises what the readback raises."""
        if not rows:
            return
        sli.observe_device_telemetry()
        # A wave or Sinkhorn batch solve parks its figures; take them
        # (once) for this record. The incremental daemon passes the
        # session's stats, and the pop still runs so that a later tick
        # never inherits them.
        tele = flightrecorder.take_last_solve_telemetry()
        if not stats and tele is not None and tele["mode"] == self.mode:
            stats = {"waves": tele["waves"]}
            if self.mode == "sinkhorn":
                stats["sinkhorn_iters"] = tele["iterations"]
                stats["sinkhorn_residual"] = tele["residual"]
        stats = stats or {}
        tick = flightrecorder.DEFAULT.next_tick()
        trace_id = tracing.current_trace_id()
        flightrecorder.DEFAULT.record_solve(flightrecorder.SolveRecord(
            tick=tick, trace_id=trace_id, mode=self.mode, pods=len(rows), duration_s=solve_s,
            waves=int(stats.get("waves", 0)),
            sinkhorn_iterations=int(stats.get("sinkhorn_iters", 0)),
            sinkhorn_residual=stats.get("sinkhorn_residual"),
            incremental=bool(stats.get("incremental", False)),
        ))
        decisions: Dict[str, flightrecorder.Decision] = {}
        for pod, dest, outcome, gkey in rows:
            key = _key(pod)
            decisions[key] = flightrecorder.Decision(
                pod=key, tick=tick, trace_id=trace_id, mode=self.mode, outcome=outcome,
                node=dest or "", group=gkey or "",
            )
        # Announce the outcomes before the readback; record() announces
        # again (sinks are idempotent).
        flightrecorder.notify_decision_sinks((d.pod, d.outcome) for d in decisions.values())
        limit = flightrecorder.explain_limit()
        # Verdict tables only for the default spec on this process's
        # card: the readback evaluates the default pipeline, and the
        # sidecar route keeps off the card. A pipelined daemon sheds:
        # unbound pods are explained inline, bound pods' tables wait for
        # the commit worker's idle drain.
        shed = self._explain_shed()
        has_unbound = any(dest is None for _p, dest, _o, _g in rows)
        if limit > 0 and self.spec is None and self.sidecar is None:
            if not shed or has_unbound:
                with tracing.phase("explain", pods=min(len(rows), limit)):
                    self._attach_verdicts(rows, decisions, nodes, services, assigned_pre, limit,
                                          only="unbound" if shed else None)
            if shed:
                # The Decision objects live in the ring, so the drain
                # amends the records readers see.
                self._queue_deferred_explain(
                    (rows, decisions, nodes, services, assigned_pre, limit))
        flightrecorder.DEFAULT.record(decisions.values())

    def _attach_verdicts(self, rows, decisions, nodes, services, assigned_pre, limit,
                         only: Optional[str] = None) -> None:
        """Per-node verdicts from the explain readback on the daemon's
        card. Unbound pods against the occupancy after the solve (why
        they are stuck now), bound pods against the one before it (the
        view they won under); unbound pods have the first claim on the
        budget. `only` restricts the pass to "unbound" (the pipelined
        daemon's inline half) or "bound" (its deferred half). The pod
        lister is read here, so a wire-form scheduled cache decodes only
        when verdicts are captured."""
        unbound = [pod for pod, dest, _, _ in rows if dest is None][:limit]
        budget = 0 if only == "unbound" else limit - len(unbound)
        if only == "bound":
            unbound = []
        bound = []
        for pod, dest, _, _ in rows:
            if dest is None or budget <= 0:
                continue
            # A bound pod's spec.nodeName already names its node: explain
            # the view before the bind, or the HostName predicate would
            # pin the verdict to the answer.
            ep = copy.deepcopy(pod)
            ep.spec.node_name = ""
            bound.append(ep)
            budget -= 1
        post = self.config.pod_lister.list()
        if assigned_pre is None:
            bound_keys = {_key(pod) for pod, dest, outcome, _ in rows
                          if dest is not None and outcome == "bound"}
            assigned_pre = [q for q in post if pod_full_key(q) not in bound_keys]
        top_k = flightrecorder.explain_top_k()
        max_failed = flightrecorder.explain_failed_nodes()
        for pods, occupancy in ((bound, assigned_pre), (unbound, post)):
            if not pods:
                continue
            for entry in explain_backlog(pods, nodes, occupancy, services, device=self.device,
                                         top_k=top_k, max_failed=max_failed):
                d = decisions.get(entry["pod"])
                if d is not None:
                    flightrecorder.DEFAULT.attach(d, entry)

    def _explain_shed(self) -> bool:
        """Whether bound pods' verdict tables wait off the tick's path
        (the started incremental daemon); this daemon never sheds."""
        return False

    def _queue_deferred_explain(self, ctx) -> None:
        """Take a deferred bound-table context (only a shedding daemon
        queues one)."""

    # -- the tick -----------------------------------------------------------

    def _observe_informer_staleness(self) -> None:
        """scheduler_informer_staleness_seconds per cache: seconds since
        it last processed a delta or re-list."""
        cfg = self.config
        now = time.monotonic()
        for resource, ref in (
            ("pods_pending", cfg._pod_reflector),
            ("pods_scheduled", cfg.scheduled_pods.reflector),
            ("nodes", cfg.nodes.reflector),
            ("services", cfg.services.reflector),
            ("podgroups", cfg.podgroups.reflector),
        ):
            if ref.last_event_mono:
                sli.INFORMER_STALENESS.set(now - ref.last_event_mono, resource=resource)

    def _drain(self, timeout: Optional[float]) -> List[Pod]:
        """The first pod (waiting up to `timeout`), then what arrives
        within `batch_window` of it, up to `max_batch`. Highest priority
        first, stable within a priority: the order that holds a nominated
        pod's freed capacity against lower-priority pods."""
        first = self.config.pod_queue.pop(timeout=timeout)
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.batch_window
        while len(batch) < self.max_batch:
            wait = deadline - time.monotonic()
            pod = self.config.pod_queue.pop(timeout=max(0.0, wait))
            if pod is None:
                break
            batch.append(pod)
        batch = [p for p in batch if not p.spec.node_name]
        batch.sort(key=lambda p: -(p.spec.priority or 0))
        return batch

    def schedule_batch(self, timeout: Optional[float] = 0.5) -> int:
        """One drain, solve and commit; returns the pods processed.
        Raises what the tick raised (departure (a))."""
        try:
            return self._tick(timeout)
        except Exception:
            self._count_error()
            _LOG.exception("scheduling tick failed")
            raise

    def _count_error(self) -> None:
        with self._errors_lock:
            self.device_errors += 1

    def _tick(self, timeout: Optional[float]) -> int:
        t_drain = time.monotonic()
        self._observe_informer_staleness()
        sli.observe_device_telemetry()
        pending = self._drain(timeout)
        if not pending:
            self._refresh_capacity_idle()
            return 0
        # One trace a tick: the pod set rides it for the pod filter, and
        # its phase spans tell each pod's story.
        with tracing.trace("schedule_batch", pods=(p.metadata.name for p in pending),
                           start=t_drain) as tr:
            tr.child("enqueue", start=t_drain, end=time.monotonic(), pods=len(pending),
                     mode=self.mode)
            return self._solve_and_commit(pending)

    def _solve_and_commit(self, pending: List[Pod]) -> int:
        """The whole cluster from the caches, one solve (in gangs'
        acceptance loop when the tick has groups), the commit inline."""
        cfg = self.config
        start = time.monotonic()
        nodes = cfg.nodes.store.list()  # unfiltered; the lowering reads readiness
        assigned = cfg.pod_lister.list()
        services = cfg.service_lister.list()
        groups = self._gang_groups(pending, assigned)
        deferred: List[Pod] = []
        if groups is None:
            pending, deferred = self._split_deferred_gangs(pending)
            self._requeue_many(deferred)
            groups = []
            if not pending:
                return len(deferred)
        t0 = time.monotonic()
        if groups:
            destinations, _accepted, denied = gang.gang_solve(
                self._solve, pending, nodes, assigned, services, groups,
                counts_fn=self._counts_fn,
            )
        else:
            destinations, denied = self._solve(pending, nodes, assigned, services), []
        solve_s = time.monotonic() - t0
        _ALGO_LATENCY.observe(solve_s)
        gkey_of = {_key(pending[i]): g.key for g in groups for i in g.indices}
        denied_keys = {g.key for g in denied}
        decided = list(zip(pending, destinations))
        rejected, bind_outcome = self._commit(decided, gkey_of, denied_keys)
        # The records land before the preemption pass amends them.
        self._record_decisions(self._decision_rows(decided, gkey_of, denied_keys, bind_outcome),
                               nodes, services, assigned, solve_s=solve_s)
        unbound = [p for p, d in zip(pending, destinations) if d is None]
        if unbound:
            # This tick's binds were assumed into the modeler since
            # `assigned` was read.
            self._maybe_preempt(unbound, nodes, cfg.pod_lister.list(), groups=groups)
        self._requeue_many(rejected)
        self._sample_capacity(pending)
        _E2E_LATENCY.observe(time.monotonic() - start)
        return len(pending) + len(deferred)


class IncrementalBatchScheduler(BatchScheduler):
    """Session-backed batch daemon on one card (see the module text).

    `device` is the session's (None: the CUDA card, raising without
    one); `mode` the tick solver, scan, wave, sinkhorn or auto (the
    scan). `max_batch` bounds a tick; `prewarm_buckets` pre-runs the
    session's launches at every pod bucket up to it when the session is
    built; victims of a preemption get `eviction_grace_seconds` to
    exit."""

    #: A sweep of at least this many pods waits BATCH_WINDOW_S for more.
    COALESCE_MIN = 64
    BATCH_WINDOW_S = 0.02
    #: Queued commit jobs at most: a solve loop that outruns the
    #: apiserver blocks instead of growing a bind backlog.
    COMMIT_DEPTH = 4
    #: Seconds the solve loop must be quiet, from the end of its last
    #: tick, before deferred bound-pod tables attach (their lowering
    #: contends for the interpreter with live ticks).
    _EXPLAIN_QUIET_S = 0.5

    def __init__(
        self,
        config: SchedulerConfig,
        max_batch: int = 65536,
        mode: str = "scan",
        eviction_grace_seconds: Optional[int] = None,
        prewarm_buckets: int = 0,
        device: DeviceLike = None,
    ):
        super().__init__(config, max_batch=max_batch, mode=mode,
                         eviction_grace_seconds=eviction_grace_seconds, device=device)
        if self.spec is not None:
            raise ValueError("incremental batch mode supports the default policy only")
        self.prewarm_buckets = prewarm_buckets
        # Sessions rebuilt.
        self.rebuilds = 0
        self._session: Optional[SolverSession] = None
        self._event_q: "collections.deque" = collections.deque()
        # Session charge releases the commit worker asks for, applied
        # on the solve loop (the session is single-threaded).
        self._release_q: "collections.deque" = collections.deque()
        self._wake = threading.Event()
        config.pod_queue.attach_wake(self._wake)
        self._commit_q: "queue.Queue" = queue.Queue(maxsize=self.COMMIT_DEPTH)
        self._commit_thread: Optional[threading.Thread] = None
        self._worker_error: Optional[BaseException] = None
        # Deferred bound-pod explain contexts, the newest four ticks.
        self._deferred_explain: "collections.deque" = collections.deque(maxlen=4)
        self._last_busy_mono = 0.0
        # Duty-cycle baseline: when the previous tick resolved.
        self._last_tick_resolved_mono = 0.0
        # The dispatched, unresolved tick: (PendingSolve, ctx).
        self._inflight = None
        self._inflight_keys: frozenset = frozenset()
        config.cluster_events = self._on_cluster_event

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "IncrementalBatchScheduler":
        self._warm_capacity()
        if self._commit_thread is None:
            self._commit_thread = threading.Thread(target=self._commit_worker, daemon=True)
            self._commit_thread.start()
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the loop and the informers, then flush the pipeline in
        order: the queued commit jobs first, then the outstanding solve,
        whose commit now runs inline. A run thread still alive after the
        join keeps its in-flight tick (resolving it from here would race
        that thread)."""
        self._stop.set()
        with self._capacity_cond:
            self._capacity_cond.notify_all()
        self.config.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)
        error = None
        if self._thread is None or not self._thread.is_alive():
            try:
                self._flush_commits()
                self._resolve_inflight()
            except Exception as e:
                self._count_error()
                _LOG.exception("flushing the in-flight tick on stop failed")
                error = e
        else:
            _LOG.warning("scheduler run thread still alive at stop; its in-flight tick "
                         "stays unresolved")
        worker = self._commit_thread
        if worker is not None:
            self._commit_thread = None
            self._commit_q.put(None)
            worker.join(timeout=10)
        if error is not None:
            raise error

    def kill(self) -> None:
        """Abrupt death: queued commit jobs are dropped unexecuted and the
        in-flight solve abandoned, as a killed process would. Recovery
        is a fresh daemon that rebuilds its session from LIST+watch, so
        once the loop has ended the session and the abandoned solve are
        let go, and their card memory with them."""
        self._stop.set()
        try:
            while True:
                self._commit_q.get_nowait()
                self._commit_q.task_done()
        except queue.Empty:
            pass
        self._commit_q.put(None)
        if self._thread is not None:
            self._thread.join(timeout=10)
        worker = self._commit_thread
        if worker is not None:
            self._commit_thread = None
            worker.join(timeout=10)
        if self._thread is None or not self._thread.is_alive():
            self._session = None
            self._inflight = None

    def prewarm(self) -> None:
        """Build the session (and run its prewarm launches) now, so the
        first pod pays neither."""
        if self._session is None:
            self._session = self._build_session()

    # -- deltas -----------------------------------------------------------

    def _on_cluster_event(self, kind: str, etype: str, obj) -> None:
        """From the reflector threads: enqueue and wake only."""
        self._event_q.append((kind, etype, obj))
        if (kind == "node" and etype == "ADDED") or (kind == "pod" and etype == "DELETED"):
            # Capacity freed. Not node MODIFIED: status heartbeats would
            # defeat the backoff.
            self._capacity_freed()
        self._wake.set()

    @staticmethod
    def _obj_key(obj) -> str:
        """The session's pod key of a typed pod or a wire dict."""
        if isinstance(obj, dict):
            m = obj.get("metadata", {})
            return f"{m.get('namespace') or 'default'}/{m.get('name', '')}"
        return _key(obj)

    def _apply_events(self, session) -> bool:
        """Drain watch deltas into the session. False when it must be
        rebuilt (the service set changed). Pod deltas come in wire form
        from the watch and typed from a re-list: deletes use the key
        alone; pods bound by someone else decode on demand."""
        while self._event_q:
            kind, etype, obj = self._event_q.popleft()
            if kind == "service":
                return False
            if kind == "node":
                if etype == "DELETED":
                    session.remove_node(obj.metadata.name)
                else:
                    session.upsert_node(obj)
            elif kind == "pod":
                key = self._obj_key(obj)
                if etype == "DELETED":
                    session.delete_assigned(key)
                elif not session.has_assigned(key):
                    session.add_assigned(_decode_pod(obj) if isinstance(obj, dict) else obj)
        return True

    def _build_session(self, pending: List[Pod] = ()) -> SolverSession:
        """A session from the caches. Deltas queued so far are dropped
        first (the snapshot holds them; later ones replay idempotently),
        and so are pending releases (they name the old session's
        charges). The pod lister adds pods bound but not yet seen by the
        watch. Node slots: 1.25 x the nodes, at least 64. Vocabularies:
        every token of the nodes, the assigned pods, the queued pods and
        the tick's `pending` pods, with headroom (`vocab_widths`)."""
        cfg = self.config
        self._event_q.clear()
        self._release_q.clear()
        nodes = cfg.nodes.store.list()
        assigned = cfg.pod_lister.list()
        lw, pw, vw = vocab_widths(nodes, [*assigned, *cfg.pod_queue.list(), *pending])
        session = SolverSession(
            nodes, services=cfg.service_lister.list(), assigned=assigned,
            label_words=lw, port_words=pw, vol_words=vw,
            node_capacity=max(64, int(len(nodes) * 1.25)), mode=self.mode, device=self.device,
        )
        if self.prewarm_buckets:
            t0 = time.monotonic()
            n = session.prewarm(self.prewarm_buckets)
            if nodes:
                explain_backlog([_decode_pod(_EXPLAIN_WARM_POD)], nodes[:1], device=self.device)
            _LOG.info("session prewarm: %d launches and the explain readback in %.1fs "
                      "(pod buckets up to %d)", n, time.monotonic() - t0, self.prewarm_buckets)
        return session

    # -- the commit pipeline ----------------------------------------------

    @property
    def _pipelined(self) -> bool:
        """Commits ride the worker and solves stay in flight across
        ticks only while the started daemon runs."""
        t = self._commit_thread
        return t is not None and t.is_alive() and not self._stop.is_set()

    def _commit_worker(self) -> None:
        while True:
            try:
                job = self._commit_q.get(timeout=0.1)
            except queue.Empty:
                # An idle gap: attach deferred bound-pod tables.
                try:
                    self._run_deferred_explain()
                except Exception as e:
                    self._worker_failed(e, "deferred explain capture failed")
                continue
            try:
                if job is None:
                    return
                self._commit_job(job)
            except Exception as e:
                self._worker_failed(e, "commit job failed")
            finally:
                self._commit_q.task_done()

    def _worker_failed(self, error: BaseException, what: str) -> None:
        """Departure (b): the commit worker's error is counted and kept
        for the next schedule_batch to raise, and the daemon stops."""
        self._count_error()
        _LOG.exception("%s; the scheduler stops", what)
        self._worker_error = error
        self._stop.set()
        self._wake.set()

    def _explain_shed(self) -> bool:
        # Started, bound pods' tables always wait: the readback is a
        # device round trip of its own and would sit on the next pod's
        # bind latency. Unbound pods are explained inline; a daemon
        # ticked by hand captures everything synchronously.
        return self._pipelined

    def _queue_deferred_explain(self, ctx) -> None:
        self._deferred_explain.append(ctx)

    def _run_deferred_explain(self) -> None:
        """The commit worker's idle half of verdict capture: bound-pod
        tables attached to decisions already in the ring, once the solve
        loop has been quiet for _EXPLAIN_QUIET_S since its last tick ended
        and no tick is running or in flight.
        The deque keeps the newest ticks, and the occupancy is read at
        attach time, shortly after the binds. Raises what the readback
        raises."""
        if not self._deferred_explain:
            return
        if (time.monotonic() - self._last_busy_mono < self._EXPLAIN_QUIET_S
                or self._inflight is not None):
            return
        try:
            ctx = self._deferred_explain.popleft()
        except IndexError:
            return
        rows, decisions, nodes, services, assigned_pre, limit = ctx
        with tracing.phase("explain", pods=min(len(rows), limit)):
            self._attach_verdicts(rows, decisions, nodes, services, assigned_pre, limit,
                                  only="bound")

    def _flush_commits(self) -> None:
        """Barrier: every queued commit job has run (before a rebuild
        reads the pod lister)."""
        t = self._commit_thread
        if t is not None and t.is_alive():
            self._commit_q.join()

    def _release(self, key: str) -> None:
        """Route a session charge release back to the solve loop."""
        self._release_q.append(key)
        self._wake.set()

    def _drain_releases(self) -> None:
        while self._release_q:
            key = self._release_q.popleft()
            if self._session is not None:
                self._session.delete_assigned(key)

    def _resolve_inflight(self, prefer_inline: bool = False) -> int:
        """Wait for the outstanding tick's readback, then hand its commit
        on. Returns the pods resolved. `prefer_inline` (nothing else
        queued) commits on this thread when the worker is idle."""
        inflight, self._inflight = self._inflight, None
        self._inflight_keys = frozenset()
        if inflight is None:
            return 0
        handle, ctx = inflight
        results = handle.result()
        self._observe_device_profile(handle)
        self._finish_tick(handle._session, results, ctx,
                          ctx.get("stage_s", 0.0) + handle.dispatch_s + handle.block_s,
                          prefer_inline=prefer_inline)
        return len(ctx["pending"])

    def _observe_device_profile(self, handle) -> None:
        """Duty cycle and overlap of one resolved tick: the in-flight
        window (launch to result()) over the resolve-to-resolve period,
        into profiler.observe_tick. The first tick only sets the
        baseline."""
        if not handle.pending:
            return
        start, end = handle.dispatched_mono, handle.resolved_mono
        if not start or not end or end <= start:
            return
        prev = self._last_tick_resolved_mono
        self._last_tick_resolved_mono = end
        if not prev or end <= prev:
            return
        profiler.observe_tick(end - start, end - prev, handle.block_s)

    def _finish_tick(self, session, results, ctx, solve_s, prefer_inline=False) -> None:
        ctx["solve_s"] = solve_s
        stats = dict(getattr(session, "last_stats", {}) or {})
        stats["incremental"] = True
        ctx["stats"] = stats
        _ALGO_LATENCY.observe(solve_s)
        self._submit_commit(results, ctx, prefer_inline=prefer_inline)
        # The columns this very tick solved against.
        self._sample_capacity(ctx.get("pending"))

    def _submit_commit(self, results, ctx, prefer_inline=False) -> None:
        if self._pipelined and not (prefer_inline and self._commit_q.unfinished_tasks == 0):
            self._commit_q.put((results, ctx))
        else:
            self._commit_job((results, ctx))
            self._drain_releases()

    def _commit_job(self, job) -> None:
        """Commit one resolved tick: bulk binds (accepted gangs
        atomically), Scheduled and FailedScheduling events, releases
        routed back to the solve loop, the preemption pass, requeues.
        Runs on the commit worker while the pipeline is live, inline
        otherwise; never touches the session."""
        # Chaos seam: the daemon "dies" between solve and commit. The job
        # raises before any bind lands, the session keeps charges for pods
        # that never bound, and recovery is a daemon restart that rebuilds
        # its session from LIST+watch (the soak's daemon_restart_mid_gang).
        faults.fire(faults.SCHED_COMMIT_CRASH)
        results, ctx = job
        cfg = self.config
        by_key = {_key(p): p for p in ctx["pending"]}
        decided = [(by_key[key], dest) for key, dest in results if key in by_key]
        rejected, bind_outcome = self._commit(decided, ctx["gkey_of"], ctx["denied_keys"])
        # The records land before the preemption pass amends them; the
        # occupancy before the solve is the pod lister's less this
        # tick's binds.
        self._record_decisions(
            self._decision_rows(decided, ctx["gkey_of"], ctx["denied_keys"], bind_outcome),
            cfg.nodes.store.list(), cfg.service_lister.list(), None,
            solve_s=ctx.get("solve_s", 0.0), stats=ctx.get("stats") or {"incremental": True})
        # Victims come from the watch caches, not the session; their
        # exits come back as ordinary pod DELETED deltas.
        unbound = [by_key[key] for key, dest in results if dest is None and key in by_key]
        if unbound:
            self._maybe_preempt(unbound, cfg.nodes.store.list(), cfg.pod_lister.list(),
                                groups=ctx["groups"])
        self._requeue_many(rejected, epoch=ctx.get("epoch"))
        _E2E_LATENCY.observe(time.monotonic() - ctx["start"])

    # -- the tick -----------------------------------------------------------

    def _sweep(self) -> List[Pod]:
        """Non-blocking drain of what is queued, up to max_batch."""
        q = self.config.pod_queue
        batch: List[Pod] = []
        while len(batch) < self.max_batch:
            pod = q.pop(timeout=0.0)
            if pod is None:
                break
            batch.append(pod)
        return batch

    def _drain(self, timeout: Optional[float]) -> List[Pod]:
        """The tick's pods: what is queued, or what the wake event brings
        within `timeout` (never waiting with a solve in flight: the
        caller must resolve it), with a coalescing window once a sweep
        found COALESCE_MIN pods. Highest priority first, stable within a
        priority (so arrival order holds): the order that holds a
        nominated pod's freed capacity against lower-priority pods."""
        batch = self._sweep()
        if not batch:
            if self._inflight is not None:
                return []
            self._wake.clear()
            batch = self._sweep()  # re-check after the clear: no lost wake
            if not batch:
                if not self._wake.wait(timeout):
                    return []
                batch = self._sweep()
                if not batch:
                    return []
        self._wake.clear()
        if self.COALESCE_MIN <= len(batch) < self.max_batch:
            deadline = time.monotonic() + self.BATCH_WINDOW_S
            while len(batch) < self.max_batch:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    break
                pod = self.config.pod_queue.pop(timeout=wait)
                if pod is None:
                    break
                batch.append(pod)
        batch = [p for p in batch if not p.spec.node_name]
        batch.sort(key=lambda p: -(p.spec.priority or 0))
        return batch

    def _topup(self, pending: List[Pod]) -> List[Pod]:
        """Stage pods that arrived while the previous tick's resolve
        blocked into the tick about to launch. A gang member, or a pod
        that outranks the tick's lowest priority, goes back to the queue
        and heads the next tick instead. On an error every popped pod
        is queued again before it propagates."""
        session = self._session
        if session is None:
            return []
        room = self.max_batch - len(pending)
        if room <= 0:
            return []
        q = self.config.pod_queue
        seen = {_key(p) for p in pending}
        floor = min(((p.spec.priority or 0) for p in pending), default=0)
        extra: List[Pod] = []
        held: List[Pod] = []
        while len(extra) < room:
            pod = q.pop(timeout=0.0)
            if pod is None:
                break
            try:
                if pod.spec.node_name:
                    continue
                if gang.pod_group_name(pod) or (pod.spec.priority or 0) > floor:
                    q.add(pod)
                    break
                key = _key(pod)
                if key in seen or key in self._inflight_keys:
                    continue
                if session.has_assigned(key):
                    held.append(pod)
                    continue
                seen.add(key)
                session.add_pending(pod)
                extra.append(pod)
            except Exception:
                for p in extra + held + [pod]:
                    q.add(p)
                raise
        self._requeue_many(held)
        return extra

    def schedule_batch(self, timeout: Optional[float] = 0.5) -> int:
        """One drain, solve and commit; returns the pods processed.
        Raises what the tick raised (departure (a)), or the commit
        worker's error."""
        error, self._worker_error = self._worker_error, None
        if error is not None:
            raise error
        return super().schedule_batch(timeout)

    def _bind_failed(self, key: str) -> None:
        # Release our charge; a true binding by another binder arrives
        # by the watch and charges the right row.
        self._release(key)

    def _tick(self, timeout: Optional[float]) -> int:
        t_drain = time.monotonic()
        self._observe_informer_staleness()
        sli.observe_device_telemetry()
        pending = self._drain(timeout)
        if not pending:
            # Flush the in-flight tick (its readback overlapped the
            # wait), inline: nothing else is queued. Its commit is a
            # tick's work: the deferred explain drain waits it out.
            if self._inflight is not None:
                self._last_busy_mono = math.inf
                try:
                    self._resolve_inflight(prefer_inline=True)
                finally:
                    self._last_busy_mono = time.monotonic()
            if self._session is not None:
                # Keep the session current while idle.
                self._drain_releases()
                try:
                    if not self._apply_events(self._session):
                        self._session = None
                except RebuildRequired:
                    self._session = None
            elif self.prewarm_buckets and self.config.wait_for_sync(0):
                self._session = self._build_session()
            else:
                # The next build snapshots the caches anyway.
                self._event_q.clear()
            self._refresh_capacity_idle()
            return 0
        # The deferred explain drain waits out the tick, then
        # _EXPLAIN_QUIET_S from its end (departure (h)).
        self._last_busy_mono = math.inf
        try:
            return self._traced_tick(pending, t_drain)
        finally:
            self._last_busy_mono = time.monotonic()

    def _traced_tick(self, pending: List[Pod], t_drain: float) -> int:
        with tracing.trace("schedule_batch", pods=(p.metadata.name for p in pending),
                           start=t_drain) as tr:
            tr.child("enqueue", start=t_drain, end=time.monotonic(), pods=len(pending),
                     mode=self.mode, incremental=True)
            try:
                return self._session_solve_and_commit(pending)
            except RebuildRequired:
                # Departure (a): solve the same pods again, once, on a
                # session rebuilt from the caches.
                self._invalidate()
            try:
                return self._session_solve_and_commit(pending)
            except RebuildRequired:
                # Tokens arrived during the rebuild: the next tick
                # rebuilds over them.
                _LOG.info("rebuilt session overflowed; %d pods wait for the next tick",
                          len(pending))
                self._invalidate()
                for pod in pending:
                    self.config.pod_queue.add(pod)
                return 0

    def _invalidate(self) -> None:
        """Drop the session after the in-flight tick and the queued
        commits are done (a rebuild reads the pod lister, and a bind
        not yet committed would be in neither it nor the modeler)."""
        self._resolve_inflight()
        self._flush_commits()
        self._session = None
        self.rebuilds += 1

    def _session_solve_and_commit(self, pending: List[Pod]) -> int:
        start = time.monotonic()
        t0 = start
        if self._session is None:
            self._resolve_inflight()
            self._flush_commits()
            self._session = self._build_session(pending)
        # Capacity baseline for this tick's backoffs, before the deltas.
        with self._capacity_cond:
            epoch = self._capacity_epoch
        self._drain_releases()
        if not self._apply_events(self._session):
            self._invalidate()
            self._session = self._build_session(pending)
        groups = self._gang_groups(pending)
        deferred: List[Pod] = []
        if groups is None:
            pending, deferred = self._split_deferred_gangs(pending)
            self._requeue_many(deferred)
            groups = []
        # A drained pod bound elsewhere since (its watch event charged
        # the session), or still in flight from the previous tick, is
        # not staged: a second charge would orphan the true one. One the
        # session holds under its key is refetched after its backoff: a
        # pod recreated under its old name (a descheduler's move) waits
        # there for its old incarnation's delete to reach the session.
        held = []
        with tracing.phase("lower", pods=len(pending)):
            for pod in pending:
                key = _key(pod)
                if key in self._inflight_keys:
                    continue
                if self._session.has_assigned(key):
                    held.append(pod)
                else:
                    self._session.add_pending(pod)
        self._requeue_many(held, epoch=epoch)
        ctx = {
            "pending": pending,
            "groups": groups,
            "gkey_of": {_key(pending[i]): g.key for g in groups for i in g.indices},
            "denied_keys": set(),
            "start": start,
            "epoch": epoch,
        }
        if groups:
            # Gang ticks run synchronously: the acceptance loop solves
            # to a fixed point on a resolved session.
            self._resolve_inflight()
            gangs = [
                SessionGang(key=g.key, min_member=g.min_member, bound=g.bound,
                            pod_keys=frozenset(_key(pending[i]) for i in g.indices))
                for g in groups
            ]
            results, denied_keys = self._session.solve_gang(gangs)
            ctx["denied_keys"] = set(denied_keys)
            for g in gangs:
                gang.OUTCOMES.inc(outcome="rejected" if g.key in ctx["denied_keys"]
                                  else "accepted")
            self._finish_tick(self._session, results, ctx, time.monotonic() - t0)
            return len(pending) + len(deferred)
        # Pipelined dispatch: resolve the previous tick (its commit then
        # rides the worker, overlapping this solve), top up with what
        # arrived meanwhile, launch, and return without waiting.
        self._resolve_inflight()
        pending = pending + self._topup(pending)
        ctx["pending"] = pending
        ctx["stage_s"] = time.monotonic() - t0
        handle = self._session.solve_async()
        if self._pipelined:
            self._inflight = (handle, ctx)
            self._inflight_keys = frozenset(handle.keys)
            return len(pending) + len(deferred)
        results = handle.result()
        self._observe_device_profile(handle)
        self._finish_tick(self._session, results, ctx,
                          ctx["stage_s"] + handle.dispatch_s + handle.block_s)
        return len(pending) + len(deferred)
