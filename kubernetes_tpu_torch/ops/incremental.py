"""Incremental solver session: device-resident cluster state under churn.

The counterpart of `kubernetes_tpu/ops/incremental.py` on one torch
device. The NODE state (occupancy, bitsets, service counts:
the large, long-lived half of the problem) stays on the device:

- a tick stages only its pending pods and runs the sequential-parity
  scan (`solver.solve_with_state`, the CUDA scan kernel on a card),
  which commits each placement into the device carry in place;
- a pod deletion touches one node row: the host mirror `h` recomputes
  that row (greedy-fit order, as the reference's MapPodsToMachines)
  and the next tick scatters the dirty rows onto the device first;
- vocabularies (labels, hostPorts, volumes) and the service set are
  frozen at session start with headroom; overflow, like running out of
  node slots, raises RebuildRequired and the owner builds a new session
  from its host store.

The layout is the JAX session's: N_cap = pow2(max(node_capacity,
nodes)) slots, 4-word bitsets by default (the daemon sizes them with
`vocab_widths` instead), SVC_K = 8 service ids a pod, svc_counts
(N_cap, max(1, services)) f32, bitset words int32 on the device and u32
in `h`. Pending pods pad to the same power-of-two buckets and dirty
scatters to the same widths.

What differs from the JAX session:

- A tick solves over the occupied prefix of the slot axis: the first
  `n_launch` rows (the highest occupied slot + 1, rounded up to 1,024,
  at most N_cap). Rows past it hold no node (unschedulable, all zero),
  so no decision changes (for the windowed modes the node index, and so
  the tie hash, is the same on the prefix), and slot recycling and
  RebuildRequired stay as in JAX. Past 27,840 rows at these widths the
  scan kernel reads its slices in place instead of from shared
  memory.
- The kernel updates the carry in place instead of donating it, and
  everything that touches the device (dirty-row scatter, pod upload,
  launch, readback) is ordered on the device's current stream.
- Host staging for uploads is pinned and used from two sets in turn; a
  set is rewritten only after the event recorded behind its last copies
  has completed. `solve_async` starts the choices' copy into pinned
  memory and records an event; `PendingSolve.result()` waits on that
  event alone.
- Modes "wave" and "sinkhorn" run `ops/wave.py` / `ops/sinkhorn.py` on
  the resident carry, whose wave loop reads one flag back a wave, so
  their `solve_async` returns once the tick's waves are done; the
  tick's telemetry lands in `last_stats` at `result()`, as in JAX. No
  mesh: the port runs on one card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch import DeviceLike, resolve_device
from kubernetes_tpu_torch.models.columnar import (
    MIB,
    SVC_K,
    ServiceMatcher,
    Vocab,
    bitset,
    mem_to_mib_ceil,
    node_is_ready,
    pod_host_ports,
    pod_key,
    pod_resource_limits,
    pod_volumes,
)
from kubernetes_tpu_torch.models.objects import (
    REBALANCE_DEST_ANNOTATION,
    RESOURCE_CPU,
    RESOURCE_MEMORY,
    RESOURCE_PODS,
    Node,
    Pod,
    Service,
)
from kubernetes_tpu_torch.ops.matrices import BITSET_KEYS
from kubernetes_tpu_torch.ops.matrices import pow2_bucket as _bucket
from kubernetes_tpu_torch.ops.matrices import state_from_numpy
from kubernetes_tpu_torch.ops.pipeline import gang_member_counts_device
from kubernetes_tpu_torch.ops.sinkhorn import solve_sinkhorn_with_state
from kubernetes_tpu_torch.ops.solver import DEFAULT_WEIGHTS, solve_with_state
from kubernetes_tpu_torch.ops.wave import solve_waves_with_state
from kubernetes_tpu_torch.utils import flightrecorder, sli
from kubernetes_tpu_torch.utils.tracing import PhaseTimer, phase, timing

Tensors = Dict[str, torch.Tensor]

#: The slot axis a tick launches over is a multiple of this many rows.
LAUNCH_ROWS = 1024


class RebuildRequired(Exception):
    """Capacity (vocab words / node slots / services) exhausted: build
    a fresh session from the authoritative host store."""


@dataclass
class SessionGang:
    """One PodGroup's stake in a session tick (the session's mirror of
    scheduler.gang.GangGroup, keyed by pod keys instead of backlog
    indices: the session addresses pods by key)."""

    key: str  # "namespace/name"
    min_member: int
    bound: int  # members already bound before this tick
    pod_keys: frozenset  # this tick's pending members


def _host_view(t: torch.Tensor, key: str) -> np.ndarray:
    """A host tensor as numpy, sharing memory; bitset words as u32."""
    a = t.numpy()
    return a.view(np.uint32) if key in BITSET_KEYS else a


class _HostStaging:
    """Host buffers for host-to-device copies, used from two sets in
    turn. On a card the buffers are pinned and the copies do not block
    the host; `take()` hands out a set only after the event recorded
    behind its last copies has completed, so the host never writes a
    buffer that a queued copy still reads. On the CPU the buffers are
    plain memory and the copies return the buffers themselves."""

    def __init__(self, device: torch.device):
        self.device = device
        self._sets: Tuple[Dict, Dict] = ({}, {})
        self._events: List[Optional[torch.cuda.Event]] = [None, None]
        self._turn = 0

    def take(self) -> int:
        turn = self._turn
        self._turn ^= 1
        event = self._events[turn]
        if event is not None:
            event.synchronize()
            self._events[turn] = None
        return turn

    def buffer(self, turn: int, name: str, shape, dtype) -> torch.Tensor:
        key = (name, tuple(shape), dtype)
        buf = self._sets[turn].get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, pin_memory=self.device.type == "cuda")
            self._sets[turn][key] = buf
        return buf

    def upload(self, turn: int, host: Tensors) -> Tensors:
        out = {k: v.to(self.device, non_blocking=True) for k, v in host.items()}
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self._events[turn] = event
        return out


class PendingSolve:
    """One in-flight session tick: the scan has been launched and the
    choices' device-to-host copy queued behind it, with an event
    recorded after the copy. ``result()`` waits on that event, applies
    the host-mirror commits, and returns the same
    ``[(pod_key, node_name | None)]`` list ``solve()`` does.

    Between launch and ``result()`` the owner may ``add_pending`` (the
    next tick's staging), apply node and pod deltas (``upsert_node``,
    ``delete_assigned``, ``add_assigned``: their row recomputes miss
    the in-flight placements, which ``result()`` then adds to the same
    rows) and do any host work. Only the next dirty-row flush and launch
    need the tick to be finished: ``solve_async`` resolves an
    outstanding handle itself."""

    __slots__ = (
        "_session", "pending", "assignment", "event", "tele",
        "dispatch_s", "block_s", "dispatched_mono", "resolved_mono",
        "_done", "_result",
    )

    def __init__(self, session, pending, assignment, event, tele=(None, None, None),
                 dispatch_s=0.0):
        self._session = session
        self.pending = pending
        self.assignment = assignment  # host int32 tensor (pinned on a card)
        self.event = event  # recorded after the readback copy; None on the CPU
        self.tele = tele  # (waves, Sinkhorn iterations, residual), None where not run
        self.dispatch_s = dispatch_s  # host seconds of the flush, staging and launch
        # Duty-cycle accounting (utils/profiler.py): the in-flight window
        # is dispatched_mono -> resolved_mono; block_s of it is host time
        # spent blocked in result(), the readback and the commits.
        self.block_s = 0.0
        self.dispatched_mono = time.monotonic()
        self.resolved_mono = 0.0
        self._done = assignment is None
        self._result: List[Tuple[str, Optional[str]]] = []

    @property
    def keys(self) -> List[str]:
        """Pod keys of the in-flight tick (placement unknown until
        result())."""
        return [lp.key for lp in self.pending]

    def done(self) -> bool:
        return self._done

    def result(self) -> List[Tuple[str, Optional[str]]]:
        if not self._done:
            self._session._finish_solve(self)
        return self._result


@dataclass
class _LoweredPod:
    """Host-side lowered pod row (everything solve() needs)."""

    key: str
    cpu: float
    mem_mib: float
    zero_req: bool
    sel_ids: List[int]
    port_ids: List[int]
    vol_any_ids: List[int]
    vol_rw_ids: List[int]
    # Pinned NODE NAME ("" = unpinned), resolved to a slot index at
    # staging time: slots are recycled across node churn, so an index
    # resolved at add time could point at a different node.
    pinned_name: str
    svc: int
    # The top-SVC_K matching service ids: the exact set the device
    # commit adds to, so the host mirror stays equal to the device.
    svc_topk: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    # Soft pin (a rebalance nomination, not spec.nodeName): an unknown
    # destination resolves to unpinned (-1) instead of infeasible (-2).
    pin_soft: bool = False
    # The port and volume ids as bit masks (bit i = id i): a node row's
    # bitsets are the OR of its pods' masks.
    port_mask: int = 0
    vol_any_mask: int = 0
    vol_rw_mask: int = 0


def _mask(ids: Sequence[int]) -> int:
    m = 0
    for i in ids:
        m |= 1 << i
    return m


def _words(mask: int, words: int) -> np.ndarray:
    """A bit mask as `words` u32 bitset words (the layout of `bitset`)."""
    return np.array([(mask >> (32 * w)) & 0xFFFFFFFF for w in range(words)], np.uint32)


def vocab_widths(nodes: Sequence[Node], pods: Sequence[Pod]) -> Tuple[int, int, int]:
    """(label, port, volume) bitset words that hold every token of
    `nodes` and `pods` (node labels, the pods' nodeSelector pairs,
    hostPorts and exclusive volumes) with a quarter more, at least 32
    tokens, of headroom, and never fewer than the default 4 words: a
    session built over these objects cannot overflow its vocabularies."""
    labels = {f"{k}={v}" for n in nodes for k, v in (n.metadata.labels or {}).items()}
    ports, vols = set(), set()
    for pod in pods:
        labels.update(f"{k}={v}" for k, v in (pod.spec.node_selector or {}).items())
        ports.update(pod_host_ports(pod))
        vols.update(v for v, _ in pod_volumes(pod))

    def words(n: int) -> int:
        return max(4, -(-(n + max(32, n // 4)) // 32))

    return words(len(labels)), words(len(ports)), words(len(vols))


class SolverSession:
    """Long-lived incremental scheduling session over one cluster, on
    `device` (default: the CUDA card; raises without one). `timer`, if
    given, collects the upload/solve/readback/commit wall seconds of
    each tick."""

    #: (key, pad value, torch dtype, trailing width attribute) of the
    #: staged pod columns; padding slots are pinned to -2 (never
    #: placeable).
    _STAGE = (
        ("cpu", 0, torch.float32, None),
        ("mem", 0, torch.float32, None),
        ("zero_req", 0, torch.bool, None),
        ("sel", 0, torch.int32, "LW"),
        ("port", 0, torch.int32, "PW"),
        ("vol_any", 0, torch.int32, "VW"),
        ("vol_rw", 0, torch.int32, "VW"),
        ("pinned", -2, torch.int32, None),
        ("svc", -1, torch.int32, None),
        ("svc_ids", -1, torch.int32, "SVC_K"),
    )

    def __init__(
        self,
        nodes: Sequence[Node],
        services: Sequence[Service] = (),
        assigned: Sequence[Pod] = (),
        label_words: int = 4,
        port_words: int = 4,
        vol_words: int = 4,
        node_capacity: int = 0,
        mode: str = "scan",
        pod_bucket: int = 0,
        device: DeviceLike = None,
        timer: Optional[PhaseTimer] = None,
    ):
        # Tick solver: "scan" replays the sequential-parity policy;
        # "wave" and "sinkhorn" batch each tick's backlog.
        if mode not in ("scan", "wave", "sinkhorn"):
            raise ValueError(f"unknown session mode {mode!r}")
        self.mode = mode
        self.device = resolve_device(device)
        self.timer = timer
        nodes = list(nodes)
        self.services = list(services)
        # pod_bucket > 0 pads every tick's pending upload to at least
        # this bucket.
        self.pod_bucket = pod_bucket
        self.LW, self.PW, self.VW = label_words, port_words, vol_words
        self.S = max(1, len(self.services))
        self._matcher = ServiceMatcher(self.services)
        self.N_cap = _bucket(max(node_capacity, len(nodes), 1))
        self.label_vocab, self.port_vocab, self.vol_vocab = Vocab(), Vocab(), Vocab()

        self.node_names: List[Optional[str]] = [None] * self.N_cap
        self.node_index: Dict[str, int] = {}
        # Assigned pods per node slot, in arrival order (the greedy-fit
        # recompute on delete follows this order, as the reference's
        # MapPodsToMachines list order does).
        self._assigned: List[List[_LoweredPod]] = [[] for _ in range(self.N_cap)]
        self._pod_node: Dict[str, int] = {}
        self._node_specs: List[Optional[Node]] = [None] * self.N_cap
        # Per slot, the node's constant columns (`_node_constants`).
        self._node_const: List[Optional[Dict[str, object]]] = [None] * self.N_cap

        self.h = self._empty_node_columns()
        for node in nodes:
            self._admit_node(node)
        for pod in assigned:
            lp = self._lower_pod(pod)
            j = self.node_index.get(pod.spec.node_name)
            if j is None:
                continue
            self._assigned[j].append(lp)
            self._pod_node[lp.key] = j
        for j in range(self.N_cap):
            if self.node_names[j] is not None:
                self._recompute_node_row(j)

        self._pending: List[_LoweredPod] = []
        self.dev: Tensors = self._upload_all()
        self._dirty: set = set()
        # The last resolved tick's telemetry: waves, and for Sinkhorn
        # sinkhorn_iters and sinkhorn_residual (the JAX session's keys).
        self.last_stats: Dict[str, float] = {}
        # The (at most one) in-flight tick and the staging buffer sets.
        self._inflight: Optional[PendingSolve] = None
        self._pod_staging = _HostStaging(self.device)
        self._row_staging = _HostStaging(self.device)

    # -- lowering -----------------------------------------------------

    def _vocab_id(self, vocab: Vocab, words: int, token: str) -> int:
        i = vocab.id(token)
        if i >= words * 32:
            raise RebuildRequired(f"vocab overflow: {token!r}")
        return i

    def _lower_pod(self, pod: Pod) -> _LoweredPod:
        cpu, mem = pod_resource_limits(pod)
        sel_ids = [
            self._vocab_id(self.label_vocab, self.LW, f"{k}={v}")
            for k, v in sorted((pod.spec.node_selector or {}).items())
        ]
        port_ids = [
            self._vocab_id(self.port_vocab, self.PW, str(p))
            for p in pod_host_ports(pod)
        ]
        vols = pod_volumes(pod)
        vol_any = [self._vocab_id(self.vol_vocab, self.VW, v) for v, _ in vols]
        vol_rw = [self._vocab_id(self.vol_vocab, self.VW, v) for v, rw in vols if rw]
        ids, first = self._matcher.membership_ids(pod)
        # A pod the descheduler recreated after a defrag eviction carries
        # its planned destination as an annotation: a soft HostName pin.
        pinned_name = pod.spec.node_name or ""
        pin_soft = False
        if not pinned_name:
            pinned_name = (pod.metadata.annotations or {}).get(
                REBALANCE_DEST_ANNOTATION, ""
            )
            pin_soft = bool(pinned_name)
        return _LoweredPod(
            svc_topk=ids[:SVC_K],
            key=pod_key(pod),
            cpu=float(cpu),
            mem_mib=float(mem_to_mib_ceil(mem)),
            zero_req=(cpu == 0 and mem == 0),
            sel_ids=sel_ids,
            port_ids=port_ids,
            vol_any_ids=vol_any,
            vol_rw_ids=vol_rw,
            pinned_name=pinned_name,
            pin_soft=pin_soft,
            svc=first,
            port_mask=_mask(port_ids),
            vol_any_mask=_mask(vol_any),
            vol_rw_mask=_mask(vol_rw),
        )

    # -- node columns (host mirror) -----------------------------------

    def _empty_node_columns(self) -> Dict[str, np.ndarray]:
        N = self.N_cap
        return {
            "cpu_cap": np.zeros(N, np.float32),
            "mem_cap": np.zeros(N, np.float32),
            "pods_cap": np.zeros(N, np.float32),
            "cpu_fit": np.zeros(N, np.float32),
            "mem_fit": np.zeros(N, np.float32),
            "over": np.zeros(N, bool),
            "cpu_used": np.zeros(N, np.float32),
            "mem_used": np.zeros(N, np.float32),
            "pods_used": np.zeros(N, np.float32),
            "labels": np.zeros((N, self.LW), np.uint32),
            "uport": np.zeros((N, self.PW), np.uint32),
            "uvol_any": np.zeros((N, self.VW), np.uint32),
            "uvol_rw": np.zeros((N, self.VW), np.uint32),
            "svc_counts": np.zeros((N, self.S), np.float32),
            "sched": np.zeros(N, bool),
        }

    def _admit_node(self, node: Node) -> int:
        name = node.metadata.name
        j = self.node_index.get(name)
        if j is None:
            try:
                j = self.node_names.index(None)
            except ValueError:
                raise RebuildRequired("node slots exhausted")
            self.node_names[j] = name
            self.node_index[name] = j
        self._node_specs[j] = node
        self._node_const[j] = None  # worked out again at the next recompute
        return j

    def _node_constants(self, node: Node) -> Dict[str, object]:
        """The part of a node's row that its pods do not change:
        capacities, the label bitset and readiness, kept per slot from
        the node's first recompute until it is upserted or removed, so a
        pod delete rebuilds only the occupancy part. (Worked out at the
        recompute, not at admission, so label ids are handed out in the
        order they always were.)"""
        cap = node.status.capacity or {}
        const: Dict[str, object] = {
            "cpu_cap": np.float32(cap[RESOURCE_CPU].milli_value() if RESOURCE_CPU in cap else 0),
            "mem_cap": np.float32(cap[RESOURCE_MEMORY].value() // MIB if RESOURCE_MEMORY in cap else 0),
            "pods_cap": np.float32(cap[RESOURCE_PODS].value() if RESOURCE_PODS in cap else 0),
        }
        const["labels"] = bitset(
            [
                self._vocab_id(self.label_vocab, self.LW, f"{k}={v}")
                for k, v in (node.metadata.labels or {}).items()
            ],
            self.LW,
        )
        const["sched"] = node_is_ready(node)
        return const

    def _recompute_node_row(self, j: int) -> None:
        """Rebuild slot j's row: the node's cached constants, then the
        occupancy of its assigned pods in arrival order (the greedy fit
        of the reference's MapPodsToMachines), summed in f32 one add at a
        time as the full recompute does. Deletes can't be expressed as
        bitset increments, so the occupancy is recomputed whole."""
        h = self.h
        for k in h:
            h[k][j] = 0
        node = self._node_specs[j]
        if node is None:
            return
        const = self._node_const[j]
        if const is None:
            const = self._node_const[j] = self._node_constants(node)
        for k, v in const.items():
            h[k][j] = v
        pods = self._assigned[j]
        if not pods:
            return
        cap_c, cap_m = const["cpu_cap"], const["mem_cap"]
        zero = np.float32(0.0)
        fit_c = fit_m = used_c = used_m = n = zero
        over = False
        port = vol_any = vol_rw = 0
        svc: Dict[int, int] = {}
        for lp in pods:
            # np.float32 + float stays f32 (NEP 50): one rounding an add.
            fits_cpu = cap_c == 0 or fit_c + lp.cpu <= cap_c
            fits_mem = cap_m == 0 or fit_m + lp.mem_mib <= cap_m
            if fits_cpu and fits_mem:
                fit_c = fit_c + lp.cpu
                fit_m = fit_m + lp.mem_mib
            else:
                over = True
            used_c = used_c + lp.cpu
            used_m = used_m + lp.mem_mib
            n = n + 1
            port |= lp.port_mask
            vol_any |= lp.vol_any_mask
            vol_rw |= lp.vol_rw_mask
            for sid in lp.svc_topk.tolist():
                svc[sid] = svc.get(sid, 0) + 1
        h["cpu_fit"][j], h["mem_fit"][j], h["over"][j] = fit_c, fit_m, over
        h["cpu_used"][j], h["mem_used"][j], h["pods_used"][j] = used_c, used_m, n
        for key, mask, words in (("uport", port, self.PW), ("uvol_any", vol_any, self.VW),
                                 ("uvol_rw", vol_rw, self.VW)):
            if mask:
                h[key][j] = _words(mask, words)
        if svc:
            h["svc_counts"][j, list(svc)] = list(svc.values())

    def _apply_commit_host(self, j: int, lp: _LoweredPod) -> None:
        """Mirror of the device commit: keeps the host rows equal to
        the device carry for nodes no delete touched."""
        h = self.h
        h["cpu_fit"][j] += lp.cpu
        h["mem_fit"][j] += lp.mem_mib
        h["cpu_used"][j] += lp.cpu
        h["mem_used"][j] += lp.mem_mib
        h["pods_used"][j] += 1
        if lp.port_mask:
            h["uport"][j] |= _words(lp.port_mask, self.PW)
        if lp.vol_any_mask:
            h["uvol_any"][j] |= _words(lp.vol_any_mask, self.VW)
        if lp.vol_rw_mask:
            h["uvol_rw"][j] |= _words(lp.vol_rw_mask, self.VW)
        if len(lp.svc_topk):
            h["svc_counts"][j, lp.svc_topk] += 1.0

    # -- device transfer ----------------------------------------------

    def _upload_all(self) -> Tensors:
        """The whole host mirror as fresh device tensors."""
        sli.note_transfer("h2d", sli.nbytes_of(self.h))
        return state_from_numpy({}, self.h, self.device)[1]

    def _scatter_rows(self, dev: Tensors, idx: List[int]) -> None:
        """dev[k][idx] = h[k][idx] for every key: the rows are staged
        with their indices, copied up, and written by one index_copy_
        per key, all on the current stream."""
        stage = self._row_staging
        turn = stage.take()
        width = len(idx)
        host = {"_idx": stage.buffer(turn, "_idx", (width,), torch.int64)}
        host["_idx"].numpy()[:] = idx
        for k, col in self.h.items():
            buf = stage.buffer(turn, k, (width,) + col.shape[1:], dev[k].dtype)
            _host_view(buf, k)[:] = col[idx]
            host[k] = buf
        moved = stage.upload(turn, host)
        rows_at = moved.pop("_idx")
        for k, rows in moved.items():
            dev[k].index_copy_(0, rows_at, rows)

    def _flush_dirty(self) -> None:
        if not self._dirty:
            return
        idx = sorted(self._dirty)
        self._dirty.clear()
        # Bucket the scatter width: pad by repeating the last index (an
        # identical row, so the order of duplicate writes is harmless).
        width = _bucket(len(idx), minimum=8)
        sli.note_transfer("h2d", width * sum(col[:1].nbytes for col in self.h.values()))
        self._scatter_rows(self.dev, idx + [idx[-1]] * (width - len(idx)))

    @property
    def n_launch(self) -> int:
        """Rows of the slot axis a tick launches over: the highest
        occupied slot + 1, rounded up to LAUNCH_ROWS, at most N_cap."""
        top = max(self.node_index.values(), default=-1) + 1
        rows = -(-max(top, 1) // LAUNCH_ROWS) * LAUNCH_ROWS
        return min(self.N_cap, rows)

    def _launch_view(self) -> Tensors:
        """Prefix views of the device rows a tick launches over: the
        kernel's in-place carry update lands in self.dev."""
        n = self.n_launch
        return {k: v[:n] for k, v in self.dev.items()}

    # -- public API ---------------------------------------------------

    def add_pending(self, pod: Pod) -> None:
        self._pending.append(self._lower_pod(pod))

    def upsert_node(self, node: Node) -> None:
        j = self._admit_node(node)
        self._recompute_node_row(j)
        self._dirty.add(j)

    def remove_node(self, name: str) -> None:
        j = self.node_index.pop(name, None)
        if j is None:
            return
        self.node_names[j] = None
        self._node_specs[j] = None
        for lp in self._assigned[j]:
            self._pod_node.pop(lp.key, None)
        self._assigned[j] = []
        self._recompute_node_row(j)  # zeroes the row; sched stays False
        self._dirty.add(j)

    def add_assigned(self, pod: Pod) -> bool:
        """An already-bound pod appeared from outside this session
        (bound by another scheduler, a static pod, resync replay):
        charge its occupancy to its node's row by the full greedy-fit
        recompute, since a foreign pod may overcommit. Idempotent per
        pod key."""
        if not pod.spec.node_name:
            return False
        lp = self._lower_pod(pod)
        if lp.key in self._pod_node:
            return False
        j = self.node_index.get(pod.spec.node_name)
        if j is None:
            return False
        self._assigned[j].append(lp)
        self._pod_node[lp.key] = j
        self._recompute_node_row(j)
        self._dirty.add(j)
        return True

    def has_assigned(self, key: str) -> bool:
        return key in self._pod_node

    def delete_assigned(self, key: str) -> bool:
        """A running pod vanished: free its occupancy (one node row)."""
        j = self._pod_node.pop(key, None)
        if j is None:
            return False
        self._assigned[j] = [lp for lp in self._assigned[j] if lp.key != key]
        self._recompute_node_row(j)
        self._dirty.add(j)
        return True

    def _dispatch(self, pods: Tensors, carry: Tensors):
        """Run one tick's solve for the session mode over `carry`
        (updated in place): (device choices, (waves, iterations,
        residual)), the telemetry None where the mode has none. The scan
        returns without waiting for the card."""
        if self.mode == "wave":
            choice, _, waves = solve_waves_with_state(pods, carry, DEFAULT_WEIGHTS)
            return choice, (waves, None, None)
        if self.mode == "sinkhorn":
            choice, _, waves, iters, res = solve_sinkhorn_with_state(pods, carry, DEFAULT_WEIGHTS)
            return choice, (waves, iters, res)
        choice, _ = solve_with_state(pods, carry, DEFAULT_WEIGHTS)
        return choice, (None, None, None)

    def solve_async(self) -> PendingSolve:
        """Pipelined tick: flush the dirty rows, stage the pending pods,
        launch the scan, queue the choices' copy to pinned host memory
        and record an event behind it, and return without waiting. At
        most one tick is in flight: a second call resolves the first."""
        self._finish_inflight()
        pending, self._pending = self._pending, []
        if not pending:
            self._flush_dirty()
            return PendingSolve(self, [], None, None)
        t0 = time.monotonic()
        # "upload" is the dirty-row scatter and this tick's pod staging,
        # "solve" the launch, "readback" the wait for the choices (so it
        # holds the device time). "lower" (`_lower_pod`) is the caller's,
        # at add_pending, as in the JAX session.
        with timing(self.timer):
            with phase("upload", dirty=len(self._dirty), pods=len(pending)):
                self._flush_dirty()
                pods = self._pod_arrays(pending)
            with phase("solve", mode=self.mode, incremental=True):
                choice, tele = self._dispatch(pods, self._launch_view())
                host, event = choice, None
                if self.device.type == "cuda":
                    host = torch.empty(choice.shape, dtype=choice.dtype, pin_memory=True)
                    host.copy_(choice, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(self.device))
        handle = PendingSolve(self, pending, host, event, tele, time.monotonic() - t0)
        self._inflight = handle
        return handle

    def _finish_inflight(self) -> None:
        if self._inflight is not None:
            self._inflight.result()

    def _finish_solve(self, handle: PendingSolve) -> None:
        """Blocking half of a tick: wait for the choices' copy, then
        mirror the device commits into the host rows. Called once, from
        PendingSolve.result()."""
        if self._inflight is handle:
            self._inflight = None
        t0 = time.monotonic()
        pending = handle.pending
        out: List[Tuple[str, Optional[str]]] = []
        with timing(self.timer):
            with phase("readback"):
                if handle.event is not None:
                    handle.event.synchronize()
                sli.note_transfer("d2h", sli.nbytes_of({"a": handle.assignment}))
                picks = handle.assignment[: len(pending)].tolist()
                # The telemetry scalars are read after the choices' copy.
                waves, iters, res = handle.tele
                self.last_stats = {}
                if waves is not None:
                    self.last_stats["waves"] = int(waves)
                if iters is not None:
                    self.last_stats["sinkhorn_iters"] = int(iters)
                    self.last_stats["sinkhorn_residual"] = float(res)
                    flightrecorder.observe_solve_telemetry(
                        "sinkhorn", int(iters), residual=float(res), waves=int(waves))
                elif waves is not None:
                    flightrecorder.observe_solve_telemetry("wave", int(waves))
            with phase("commit"):
                for lp, j in zip(pending, picks):
                    if j < 0 or j >= self.N_cap or self.node_names[j] is None:
                        out.append((lp.key, None))
                        continue
                    self._assigned[j].append(lp)
                    self._pod_node[lp.key] = j
                    self._apply_commit_host(j, lp)
                    out.append((lp.key, self.node_names[j]))
        handle.resolved_mono = time.monotonic()
        handle.block_s = handle.resolved_mono - t0
        handle._result = out
        handle._done = True

    def solve(self) -> List[Tuple[str, Optional[str]]]:
        """Schedule the pending backlog against the device-resident
        cluster state; commits land in the device carry. Returns
        [(pod_key, node_name | None)] and clears the backlog."""
        return self.solve_async().result()

    def prewarm(
        self, max_pod_bucket: int = 0, max_scatter_width: int = 512
    ) -> int:
        """Build and load the scan kernel, then run every launch a live
        tick can make (the scan at each pow2 pod bucket up to
        max_pod_bucket, the dirty-row scatter at each pow2 width) on
        throwaway clones of the device state, so the first real tick
        pays no build and no first-use allocation. `self.dev` and
        `self.h` are left as they were. Returns the number of warm
        launches, the JAX session's count for the same arguments."""
        warmed = 0
        bucket = max(_bucket(1), self.pod_bucket)
        top = max(bucket, _bucket(max_pod_bucket)) if max_pod_bucket else 0
        while bucket <= top:
            pods = self._stage_arrays([], bucket, reuse=False)
            carry = {k: v.clone() for k, v in self._launch_view().items()}
            self._dispatch(pods, carry)
            warmed += 1
            bucket *= 2
        width = 8
        idx_max = max(
            (j for j, n in enumerate(self.node_names) if n is not None),
            default=0,
        )
        while width <= min(max_scatter_width, self.N_cap):
            carry = {k: v.clone() for k, v in self.dev.items()}
            self._scatter_rows(carry, [idx_max] * width)
            warmed += 1
            width *= 2
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return warmed

    def solve_gang(
        self, gangs: Sequence[SessionGang]
    ) -> Tuple[List[Tuple[str, Optional[str]]], List[str]]:
        """solve() with group-level all-or-nothing acceptance. A rejected
        group's tentative placements are already in the device carry, so
        each rejection round releases every placement of this tick
        through delete_assigned (the host rows are recomputed and the
        next solve's dirty flush writes them back) and re-solves the
        surviving backlog in arrival order: the fixed-point loop of
        scheduler.gang.gang_solve. The group counts run through the
        masked segment sum on the session's device. Returns the tick's
        results and the rejected groups' keys."""
        tick = list(self._pending)
        if not gangs:
            return self.solve(), []
        gangs = list(gangs)
        gi_of_key: Dict[str, int] = {}
        for gi, g in enumerate(gangs):
            for k in g.pod_keys:
                gi_of_key[k] = gi
        results: Dict[str, Optional[str]] = {}
        rejected: set = set()
        while True:
            for key, dest in self.solve():
                results[key] = dest
            placed = np.fromiter(
                (results.get(lp.key) is not None for lp in tick),
                bool, count=len(tick),
            )
            gids = np.fromiter(
                (gi_of_key.get(lp.key, -1) for lp in tick),
                np.int32, count=len(tick),
            )
            counts = gang_member_counts_device(
                placed, gids, len(gangs), device=self.device
            )
            newly = [
                gi
                for gi, g in enumerate(gangs)
                if gi not in rejected
                and int(counts[gi]) + g.bound < g.min_member
            ]
            if not newly:
                break
            rejected.update(newly)
            for lp in tick:
                if results.get(lp.key) is not None:
                    self.delete_assigned(lp.key)
                results[lp.key] = None
            self._pending = [
                lp for lp in tick
                if gi_of_key.get(lp.key, -1) not in rejected
            ]
        return (
            [(lp.key, results.get(lp.key)) for lp in tick],
            [gangs[gi].key for gi in sorted(rejected)],
        )

    def _pod_arrays(self, pending: List[_LoweredPod]) -> Tensors:
        PP = max(_bucket(len(pending)), self.pod_bucket)
        return self._stage_arrays(pending, PP)

    def _stage_arrays(
        self, pending: List[_LoweredPod], PP: int, reuse: bool = True
    ) -> Tensors:
        """One tick's pod columns on the device, padded to PP rows.
        With `reuse`, they are written into the next pinned staging set
        and copied up without blocking the host; without it (prewarm),
        into throwaway host tensors."""
        widths = {"LW": self.LW, "PW": self.PW, "VW": self.VW, "SVC_K": SVC_K}
        if reuse:
            turn = self._pod_staging.take()
        host: Tensors = {}
        for key, fill, dtype, width in self._STAGE:
            shape = (PP,) if width is None else (PP, widths[width])
            if reuse:
                host[key] = self._pod_staging.buffer(turn, key, shape, dtype)
            else:
                host[key] = torch.empty(shape, dtype=dtype)
            host[key].fill_(fill)
        arr = {k: _host_view(t, k) for k, t in host.items()}
        for i, lp in enumerate(pending):
            arr["cpu"][i] = lp.cpu
            arr["mem"][i] = lp.mem_mib
            arr["zero_req"][i] = lp.zero_req
            arr["sel"][i] = bitset(lp.sel_ids, self.LW)
            arr["port"][i] = bitset(lp.port_ids, self.PW)
            arr["vol_any"][i] = bitset(lp.vol_any_ids, self.VW)
            arr["vol_rw"][i] = bitset(lp.vol_rw_ids, self.VW)
            if lp.pinned_name:
                arr["pinned"][i] = self.node_index.get(
                    lp.pinned_name, -1 if lp.pin_soft else -2
                )
            else:
                arr["pinned"][i] = -1
            arr["svc"][i] = lp.svc
            arr["svc_ids"][i, : len(lp.svc_topk)] = lp.svc_topk
        sli.note_transfer("h2d", sli.nbytes_of(arr))
        if reuse:
            return self._pod_staging.upload(turn, host)
        return {k: t.to(self.device) for k, t in host.items()}
