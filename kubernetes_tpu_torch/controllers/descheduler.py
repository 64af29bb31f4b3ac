"""The descheduler: the continuous-rebalancing control loop.

The port of `kubernetes_tpu/controllers/descheduler.py`. When the
cluster's fragmentation score crosses the threshold while pods wait,
the free capacity exists but lies in shards no pending pod fits; only
moving bound pods helps. Each cycle plans moves with
`utils/rebalance.build_plan` (K2, `csrc/rebalance_kernel.cu`, on the
card) and carries them out by graceful eviction and recreation; the
descheduler never force-deletes a pod.

A move:

1. journals its intent as a PodTemplate labelled
   `REBALANCE_JOURNAL_LABEL` (value: the destination) holding the pod's
   metadata and whole spec, before the eviction;
2. evicts the pod gracefully (the eviction subresource; 404 means gone
   already and counts as evicted);
3. waits for the pod to leave the store (at most `wait_timeout_s`; a
   timeout leaves the journal for recovery);
4. recreates the pod (same name, a new uid) with nodeName blanked and
   `REBALANCE_DEST_ANNOTATION` naming the destination, which the
   scheduler's lowering honours as a HostName pin, then patches its
   `status.nominatedNodeName`; the scheduler daemon rebinds it there;
   the flight recorder's newest decision of the pod is amended to
   `rebalance_nominated` at the destination;
5. deletes the journal entry.

Every cycle first replays orphaned journal entries (`recover`): an
entry whose pod is missing recreates it, one whose pod exists is
dropped, and a 4xx on the recreate counts the pod as stranded. It then
settles nominations (`_sweep_nominations`): a recreated pod that bound
has its pin blanked (`rebound`), one still pending past
`nomination_ttl_s` too (`failed`: it re-enters the solve unpinned).
A gang group's recreated members bind in one atomic `bind_bulk`. At
most `disruption_cap` evictions a cycle, a whole group counting, the
first group always allowed.

The journal and the replacement are built from the wire form of the
pod (`Client.list_wire`): metadata name, namespace, labels and
annotations, and the whole spec as the apiserver holds it, so no field
the port's typed objects leave out is lost in a move. The planner
reads typed pods.

Departures from the JAX controller:

- `build_plan` and `fragment_score` raise on an error (a device, build
  or kernel fault), and so does `sync_once`; the started loop catches
  it, logs it and counts `descheduler_syncs_total{result="error"}`, as
  the JAX loop does for any error. Nothing falls back to the plain
  version. The port's `fragment_score` never returns None, so the
  measured score is never the plan's forecast.
- `rebalance_moves_total{outcome="planned"}` is counted by `build_plan`
  for every plan (see `utils/rebalance.py`).

The `descheduler.move.crash` chaos seam (`utils/faults.py`) sits where
JAX's does, between the eviction and the replacement's create.

`device` (None: the CUDA card, raising without one) is where K2 and the
score run. Phases of an attached `PhaseTimer` (`tracing.timing`):
`recover`, `sweep`, `list`, `columns`, `build_plan`'s `stage`, `plan`
and `group`, `execute` and `measure` (the second LIST and the score).
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence

from kubernetes_tpu_torch import DeviceLike, resolve_device
from kubernetes_tpu_torch.client.rest import APIError
from kubernetes_tpu_torch.models.objects import (
    REBALANCE_DEST_ANNOTATION,
    REBALANCE_JOURNAL_LABEL,
    parse_iso,
)
from kubernetes_tpu_torch.utils import capacity as capacity_mon
from kubernetes_tpu_torch.utils import faults, flightrecorder, metrics, tracing
from kubernetes_tpu_torch.utils import rebalance as rebalance_mon
from kubernetes_tpu_torch.utils.capacity import cluster_columns
from kubernetes_tpu_torch.utils.rebalance import DEFAULT_MOVE_BUDGET, build_plan, fragment_score

_LOG = logging.getLogger("kubernetes_tpu_torch.controllers.descheduler")

_SYNCS = metrics.DEFAULT.counter("descheduler_syncs_total", "Descheduler sync passes",
                                 ("result",))

#: Journal PodTemplate name prefix (one entry per move in flight).
JOURNAL_PREFIX = "rebalance-move-"

_TERMINAL = ("Succeeded", "Failed")


def _wire_key(obj: dict) -> str:
    meta = obj.get("metadata") or {}
    return f"{meta.get('namespace') or 'default'}/{meta.get('name', '')}"


def _meta(name: str, namespace: str, labels=None, annotations=None) -> dict:
    """ObjectMeta on the wire as the JAX serde writes it: empty maps
    left out."""
    meta = {"name": name, "namespace": namespace}
    if labels:
        meta["labels"] = dict(labels)
    if annotations:
        meta["annotations"] = dict(annotations)
    return meta


class Descheduler:
    """Periodic or triggered defragmenter. `sync_once()` works without
    `start()` (it LISTs what it reads); the started thread adds the
    period."""

    def __init__(
        self,
        client,
        sync_period: float = 10.0,
        frag_threshold: float = 0.5,
        move_budget: int = DEFAULT_MOVE_BUDGET,
        disruption_cap: int = 4,
        grace_period_seconds: int = 0,
        nomination_ttl_s: float = 30.0,
        wait_timeout_s: float = 5.0,
        device: DeviceLike = None,
    ):
        self.client = client
        self.sync_period = sync_period
        self.frag_threshold = float(frag_threshold)
        self.move_budget = int(move_budget)
        self.disruption_cap = int(disruption_cap)
        self.grace_period_seconds = int(grace_period_seconds)
        self.nomination_ttl_s = float(nomination_ttl_s)
        self.wait_timeout_s = float(wait_timeout_s)
        self.device = resolve_device(device)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Descheduler":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=3)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.sync_once()
                _SYNCS.inc(result="ok")
            except Exception:
                _LOG.exception("descheduler sync failed")
                _SYNCS.inc(result="error")
            self._stop.wait(self.sync_period)

    # -- the cycle ---------------------------------------------------------

    def _cluster(self):
        """(typed nodes, typed pods) by LIST."""
        return self.client.list("nodes")[0], self.client.list("pods")[0]

    def sync_once(self, force: bool = False, forced_nodes: Sequence[str] = ()) -> dict:
        """One pass: journal recovery, the nomination sweep, the trigger,
        the plan, its moves and the measured score. Returns the cycle's
        summary. Raises what the plan or the score raise."""
        with tracing.phase("recover"):
            recovered = self.recover()
        with tracing.phase("sweep"):
            self._sweep_nominations()
        with tracing.phase("list"):
            nodes, pods = self._cluster()
        with tracing.phase("columns"):
            cols, names = cluster_columns(nodes, pods)
        probes = capacity_mon.DEFAULT.probe_set()
        pending = [p for p in pods if not p.spec.node_name and p.status.phase not in _TERMINAL]

        plan = build_plan(cols, names, pods, probes, move_budget=self.move_budget,
                          forced_nodes=forced_nodes, device=self.device)
        summary = {"kind": "DeschedulerCycle", "recovered": recovered, "triggered": False,
                   "moves_executed": 0}
        if plan is None:
            return summary
        rebalance_mon.DEFAULT.record_plan(plan)
        if forced_nodes:
            # A drain moves the named nodes' pods and nothing else: the
            # plan's other gainful moves would evict pods nobody asked to
            # touch.
            keep = {m["group"] for m in plan["moves"] if m["forced"]}
            plan = dict(plan)
            plan["moves"] = [m for m in plan["moves"] if m["group"] in keep]

        triggered = (force or bool(forced_nodes)
                     or (plan["score_before"] >= self.frag_threshold and bool(pending)))
        summary["score_before"] = plan["score_before"]
        if not triggered or not plan["moves"]:
            return summary
        summary["triggered"] = True

        with tracing.phase("execute", moves=len(plan["moves"])):
            executed = self._execute(plan)
        rebalance_mon.DEFAULT.record_move("planned", len(plan["moves"]))

        # The score after comes from a fresh LIST, not the plan's forecast.
        with tracing.phase("measure"):
            nodes, pods = self._cluster()
            cols, _ = cluster_columns(nodes, pods)
            after = fragment_score(cols, probes, device=self.device)
        trigger = "drain" if forced_nodes else ("forced" if force else "periodic")
        summary.update(rebalance_mon.DEFAULT.record_cycle(plan["score_before"], after, executed,
                                                          trigger=trigger))
        summary["moves_executed"] = executed
        return summary

    def drain_node(self, node_name: str) -> dict:
        """A forced cycle that moves every pod off `node_name`, whatever
        the gain, by the same graceful moves (the autoscaler's drain)."""
        return self.sync_once(force=True, forced_nodes=(node_name,))

    # -- recovery and the sweep ---------------------------------------------

    def recover(self) -> int:
        """Replay orphaned move journals: the pod of an entry is gone, so
        the descheduler stopped between eviction and recreation; recreate
        it (it pends and binds). An entry whose pod exists is dropped.
        Returns the pods recreated."""
        try:
            entries, _ = self.client.list_wire("podtemplates",
                                               label_selector=REBALANCE_JOURNAL_LABEL)
        except APIError:
            return 0
        recovered = 0
        for entry in entries:
            meta = entry.get("metadata") or {}
            labels = meta.get("labels") or {}
            if REBALANCE_JOURNAL_LABEL not in labels:
                continue
            ns = meta.get("namespace") or "default"
            template = entry.get("template") or {}
            name = (template.get("metadata") or {}).get("name", "")
            if not name:
                self._delete_journal(meta.get("name", ""), ns)
                continue
            try:
                self.client.get_wire("pods", name, namespace=ns)
                exists = True
            except APIError as e:
                if e.code != 404:
                    continue  # cannot tell: leave the journal
                exists = False
            if exists:
                self._delete_journal(meta.get("name", ""), ns)
                continue
            try:
                self.client.create("pods", self._replacement(
                    template, labels.get(REBALANCE_JOURNAL_LABEL, "")), namespace=ns)
                rebalance_mon.DEFAULT.record_move("recovered")
                recovered += 1
                self._delete_journal(meta.get("name", ""), ns)
            except APIError as e:
                if e.code == 409:
                    self._delete_journal(meta.get("name", ""), ns)
                elif 400 <= e.code < 500:
                    # Refused for good: the evicted pod is stranded, and
                    # the entry goes so the count cannot repeat.
                    rebalance_mon.DEFAULT.record_move("stranded")
                    self._delete_journal(meta.get("name", ""), ns)
                # 5xx or transport: keep the journal for the next cycle.
        return recovered

    def _sweep_nominations(self) -> None:
        """Settle nominations: a recreated pod that bound completes its
        move (pin blanked, `rebound`); one still pending past the TTL
        has its pin blanked (`failed`; it pends unpinned)."""
        try:
            pods, _ = self.client.list_wire("pods")
        except APIError:
            return
        now = time.time()
        for p in pods:
            meta = p.get("metadata") or {}
            if not (meta.get("annotations") or {}).get(REBALANCE_DEST_ANNOTATION, ""):
                continue
            if (p.get("spec") or {}).get("nodeName"):
                outcome = "rebound"
            else:
                born = parse_iso(meta.get("creationTimestamp", ""))
                if born is not None and now - born < self.nomination_ttl_s:
                    continue  # still within its window
                outcome = "failed"
            try:
                # Blanked, not removed: the pin and the movable filter
                # both read the annotation's truth.
                self.client.patch(
                    "pods", meta.get("name", ""),
                    {"metadata": {"annotations": {REBALANCE_DEST_ANNOTATION: ""}}},
                    namespace=meta.get("namespace") or "default")
                rebalance_mon.DEFAULT.record_move(outcome)
            except APIError:
                continue

    # -- execution ---------------------------------------------------------

    def _execute(self, plan: dict) -> int:
        """The plan's move groups under the disruption cap. Returns the
        evictions made."""
        pods, _ = self.client.list_wire("pods")
        by_key = {_wire_key(p): p for p in pods}
        groups: Dict[str, List[dict]] = {}
        for m in plan["moves"]:
            groups.setdefault(m["group"], []).append(m)

        executed = 0
        for moves in groups.values():
            if executed and executed + len(moves) > self.disruption_cap:
                break  # the cap holds; the first group is exempt
            is_gang = any(m["gang"] for m in moves)
            done = []
            for m in moves:
                pod = by_key.get(m["pod"])
                if pod is None:
                    continue
                if self._move(pod, m, defer_bind=is_gang):
                    executed += 1
                    done.append(m)
            if is_gang and done:
                self._commit_gang(done)
        return executed

    def _move(self, pod: dict, m: dict, defer_bind: bool = False) -> bool:
        """One journal, evict, recreate and nominate move of the wire pod
        `pod`. True when the eviction landed."""
        meta = pod.get("metadata") or {}
        ns = meta.get("namespace") or "default"
        name = meta.get("name", "")
        journal_name = f"{JOURNAL_PREFIX}{name}"
        template = {
            "metadata": _meta(name, ns, meta.get("labels"), meta.get("annotations")),
            "spec": copy.deepcopy(pod.get("spec") or {}),
        }
        journal = {
            "kind": "PodTemplate", "apiVersion": "v1",
            "metadata": _meta(journal_name, ns, {REBALANCE_JOURNAL_LABEL: m["to"]}),
            "template": template,
        }
        try:
            self.client.create("podtemplates", journal, namespace=ns)
        except APIError as e:
            if e.code != 409:  # an orphan of an earlier cycle is fine
                rebalance_mon.DEFAULT.record_move("failed")
                return False
        try:
            self.client.evict(name, namespace=ns, grace_period_seconds=self.grace_period_seconds)
        except APIError as e:
            if e.code != 404:  # gone already: evicted
                rebalance_mon.DEFAULT.record_move("failed")
                self._delete_journal(journal_name, ns)
                return False
        rebalance_mon.DEFAULT.record_move("evicted")
        try:
            self.client.record_event(
                pod, "RebalanceEvict",
                f"defragmentation move {m['from']} -> {m['to']} (gain {m['gain']})",
                source="descheduler", namespace=ns)
        except APIError:
            pass

        # THE crash window: the pod is evicted, the replacement does
        # not exist yet. Only the journal stands between a crash here
        # and a stranded pod — which is exactly what the chaos soak's
        # mid-defrag kill epoch asserts.
        faults.fire(faults.DESCHED_MOVE_CRASH, m["pod"])

        if not self._wait_gone(name, ns):
            # Terminating, not yet gone: the journal stays, and recovery
            # recreates the pod once the store lets it go.
            return True
        try:
            self.client.create("pods", self._replacement(template, m["to"]), namespace=ns)
        except APIError:
            rebalance_mon.DEFAULT.record_move("failed")
            return True  # the journal stays: recovery replays it
        if not defer_bind:
            try:
                self.client.patch("pods", name, {"status": {"nominatedNodeName": m["to"]}},
                                  namespace=ns)
            except APIError:
                pass
        flightrecorder.DEFAULT.record_preemption(
            m["pod"], "rebalance_nominated", node=m["to"],
            reason=f"defrag move from {m['from']} (gain {m['gain']})")
        self._delete_journal(journal_name, ns)
        return True

    def _commit_gang(self, done: List[dict]) -> None:
        """Bind a gang group's recreated members at their destinations in
        one atomic bind_bulk (a conflict rejects the whole batch; the
        pods then pend pinned and the scheduler places them)."""
        ns = done[0]["namespace"]
        try:
            self.client.bind_bulk([(m["name"], m["to"]) for m in done], namespace=ns,
                                  atomic=True)
            rebalance_mon.DEFAULT.record_move("rebound", len(done))
            for m in done:
                try:
                    self.client.patch(
                        "pods", m["name"],
                        {"metadata": {"annotations": {REBALANCE_DEST_ANNOTATION: ""}}},
                        namespace=ns)
                except APIError:
                    pass
        except APIError:
            pass

    # -- plumbing ----------------------------------------------------------

    @staticmethod
    def _replacement(template: dict, dest: str) -> dict:
        """The evicted pod's next incarnation, in wire form: its name,
        namespace, labels, annotations and whole spec, nodeName blanked,
        pinned at `dest`, Pending (the server gives it a new uid)."""
        meta = template.get("metadata") or {}
        spec = copy.deepcopy(template.get("spec") or {})
        spec.pop("nodeName", None)
        annotations = dict(meta.get("annotations") or {})
        if dest:
            annotations[REBALANCE_DEST_ANNOTATION] = dest
        return {
            "kind": "Pod", "apiVersion": "v1",
            "metadata": _meta(meta.get("name", ""), meta.get("namespace") or "default",
                              meta.get("labels"), annotations),
            "spec": spec,
            "status": {"phase": "Pending"},
        }

    def _wait_gone(self, name: str, ns: str) -> bool:
        deadline = time.time() + self.wait_timeout_s
        while time.time() < deadline:
            try:
                self.client.get_wire("pods", name, namespace=ns)
            except APIError as e:
                return e.code == 404
            time.sleep(0.05)
        return False

    def _delete_journal(self, name: str, ns: str) -> None:
        try:
            self.client.delete("podtemplates", name, namespace=ns)
        except APIError:
            pass
