"""The capacity plane's host half: the probe set, the occupancy columns
and the monitor.

The counterpart of `kubernetes_tpu/utils/capacity.py`:

- `probe_set`: the configured slice shapes plus the p50, p90 and max of
  the recent backlog shapes (requests ceiled so the columns stay
  integral), as (name, cpu milli, mem MiB, minMember) tuples;
- `probe_arrays`: a probe set as the four probe arrays the capacity
  report and the defrag plan take;
- `session_columns`: the eight occupancy columns of a `SolverSession`'s
  host mirror (`session.h`);
- `cluster_columns`: the same columns from object lists, for a caller
  that keeps no session. Terminal-phase and Terminating pods do not
  charge their node;
- `CapacityMonitor` (`DEFAULT`): the process's sampler, which the
  scheduler daemons call every resolved tick (`scheduler/daemon.py
  _sample_capacity`). A sample runs `ops.capacity.capacity_report` on
  the device, feeds the series and keeps the snapshot that the JAX
  package serves as `/debug/capacity`, with a trend ring of the score;
- `sample`: one report of a set of columns observed into the series,
  without the monitor (node utilisation on every call).

Series, under the JAX names: `cluster_fragmentation_score`,
`slice_alloc_success_rate`, `cluster_headroom_pods{shape}`,
`node_utilization_ratio{resource}` (a monitor observes it at most once
every `UTIL_REFRESH_S`: 3 x the live nodes of observations),
`scheduler_backlog_pressure` (queued pods x the oldest one's age, s)
and `capacity_zero_headroom_ticks_total` (samples taken with a backlog
while some live probe had no headroom), which the autoscaler reads in
the same process.

Departures from the JAX monitor: its `sample` catches every error and
returns None; the port's raises (the daemon counts it as a tick error).
Nothing pads the node or the probe axis (PyTorch reuses no executable
across shapes; padding changes no output), and `warm` runs one report
on the device to warm its context and allocator, where JAX compiles.
The columns are NumPy arrays, so either package's capacity report and
planner take them.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch import DeviceLike, native, resolve_device
from kubernetes_tpu_torch.models.columnar import (
    MIB,
    mem_to_mib_ceil,
    node_is_ready,
    pod_resource_limits,
)
from kubernetes_tpu_torch.models.objects import (
    RESOURCE_CPU,
    RESOURCE_MEMORY,
    RESOURCE_PODS,
    pod_is_terminating,
)
from kubernetes_tpu_torch.ops.capacity import capacity_report
from kubernetes_tpu_torch.utils import metrics
from kubernetes_tpu_torch.utils.debug import cold_report
from kubernetes_tpu_torch.utils.profiler import RATIO_BUCKETS

Probe = Tuple[str, float, float, int]

FRAG_SCORE = metrics.DEFAULT.histogram(
    "cluster_fragmentation_score",
    "Capacity-weighted stranded fraction of aggregate free capacity "
    "across the probe-shape set (0 = perfectly packable, 1 = every "
    "free byte stranded)",
    buckets=RATIO_BUCKETS,
)
NODE_UTIL = metrics.DEFAULT.histogram(
    "node_utilization_ratio",
    "Per-live-node charged/capacity ratio, one observation per node "
    "per refresh",
    labels=("resource",),
    buckets=RATIO_BUCKETS,
)
HEADROOM = metrics.DEFAULT.gauge(
    "cluster_headroom_pods",
    "Pods of each probe shape that still fit cluster-wide (greedy "
    "per-node integral fit, mask-reduced over live nodes)",
    labels=("shape",),
)
SLICE_ALLOC = metrics.DEFAULT.histogram(
    "slice_alloc_success_rate",
    "Per-sample fraction of live probe shapes whose all-or-nothing "
    "gang bound (headroom >= minMember) is satisfiable right now",
    buckets=RATIO_BUCKETS,
)
BACKLOG_PRESSURE = metrics.DEFAULT.gauge(
    "scheduler_backlog_pressure",
    "Pending-backlog pressure watermark: FIFO depth x oldest unbound "
    "pod age in seconds (0 on an idle cluster)",
)
ZERO_HEADROOM = metrics.DEFAULT.counter(
    "capacity_zero_headroom_ticks_total",
    "Capacity samples taken while the backlog was non-empty and some "
    "live probe shape had zero cluster-wide headroom",
)

#: Default slice probes (cpu milli, mem MiB, minMember): a single small
#: pod, a mid gang, and an 8-member accelerator slice shape.
DEFAULT_SLICE_SHAPES: Tuple[Probe, ...] = (
    ("slice-1x250m", 250.0, 256.0, 1),
    ("slice-4x500m", 500.0, 512.0, 4),
    ("slice-8x2000m", 2000.0, 2048.0, 8),
)

#: Seconds between observations of every live node's utilisation.
UTIL_REFRESH_S = 1.0

#: Length of the monitor's ring of fragmentation scores.
TREND_LEN = 120

#: Stranded nodes listed in the snapshot.
TOP_K_STRANDED = 8

#: Backlog shapes remembered for the quantile probes.
SHAPE_WINDOW = 512

COLUMN_KEYS = ("cpu_cap", "mem_cap", "pods_cap", "cpu_fit", "mem_fit", "pods_used", "over", "sched")


def probe_set(slice_shapes: Sequence[Probe] = DEFAULT_SLICE_SHAPES,
              recent_shapes: Sequence[Tuple[float, float]] = ()) -> List[Probe]:
    """The slice shapes, then the backlog quantile probes (p50, p90,
    max over `recent_shapes`, (cpu milli, mem MiB) pairs) when there are
    any."""
    probes = [(str(n), float(c), float(m), int(k)) for n, c, m, k in slice_shapes]
    if len(recent_shapes):
        arr = np.asarray(recent_shapes, dtype=np.float64)
        for tag, q in (("p50", 50.0), ("p90", 90.0), ("max", 100.0)):
            cpu = float(np.ceil(np.percentile(arr[:, 0], q)))
            mem = float(np.ceil(np.percentile(arr[:, 1], q)))
            probes.append((f"backlog-{tag}", cpu, mem, 1))
    return probes


def probe_arrays(probes: Sequence[Probe]):
    """(probe_cpu f32[Q], probe_mem f32[Q], probe_min i32[Q], probe_live
    bool[Q]); an empty set is one dead probe (Q >= 1)."""
    q = max(len(probes), 1)
    probe_cpu = np.zeros(q, np.float32)
    probe_mem = np.zeros(q, np.float32)
    probe_min = np.ones(q, np.int32)
    probe_live = np.zeros(q, bool)
    for i, (_name, cpu, mem, minm) in enumerate(probes):
        probe_cpu[i] = cpu
        probe_mem[i] = mem
        probe_min[i] = max(int(minm), 1)
        probe_live[i] = True
    return probe_cpu, probe_mem, probe_min, probe_live


def session_columns(session) -> Tuple[Dict[str, np.ndarray], List[Optional[str]]]:
    """The occupancy columns of a SolverSession's host mirror (`h`, kept
    in step with the device rows), and its slot names (None = free)."""
    h = session.h
    return {k: h[k] for k in COLUMN_KEYS}, list(session.node_names)


def cluster_columns(nodes, assigned) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """The occupancy columns of object lists: capacities, readiness and
    the greedy-fit charge of the live bound pods in list order (a pod
    that does not fit marks its node overcommitted)."""
    names = [n.metadata.name for n in nodes]
    index = {name: j for j, name in enumerate(names)}
    n = len(nodes)
    cpu_cap = np.zeros(n, np.float32)
    mem_cap = np.zeros(n, np.float32)
    pods_cap = np.zeros(n, np.float32)
    sched = np.zeros(n, bool)
    for j, node in enumerate(nodes):
        cap = node.status.capacity or {}
        if RESOURCE_CPU in cap:
            cpu_cap[j] = cap[RESOURCE_CPU].milli_value()
        if RESOURCE_MEMORY in cap:
            mem_cap[j] = cap[RESOURCE_MEMORY].value() // MIB
        if RESOURCE_PODS in cap:
            pods_cap[j] = cap[RESOURCE_PODS].value()
        sched[j] = node_is_ready(node)

    occupants = [
        p for p in assigned
        if p.spec.node_name
        and p.status.phase not in ("Succeeded", "Failed")
        and not pod_is_terminating(p)
    ]
    a = len(occupants)
    a_idx = np.full(a, -1, np.int32)
    a_cpu = np.zeros(a, np.float32)
    a_mem = np.zeros(a, np.float32)
    for i, p in enumerate(occupants):
        j = index.get(p.spec.node_name)
        a_idx[i] = -1 if j is None else j
        cpu, mem = pod_resource_limits(p)
        a_cpu[i] = cpu
        a_mem[i] = mem_to_mib_ceil(mem)
    cpu_fit = np.zeros(n, np.float32)
    mem_fit = np.zeros(n, np.float32)
    over = np.zeros(n, bool)
    cpu_used = np.zeros(n, np.float32)
    mem_used = np.zeros(n, np.float32)
    pods_used = np.zeros(n, np.float32)
    native.greedy_fit(a_idx, a_cpu, a_mem, cpu_cap, mem_cap, cpu_fit, mem_fit, over,
                      cpu_used, mem_used, pods_used)
    cols = {
        "cpu_cap": cpu_cap,
        "mem_cap": mem_cap,
        "pods_cap": pods_cap,
        "cpu_fit": cpu_fit,
        "mem_fit": mem_fit,
        "pods_used": pods_used,
        "over": over,
        "sched": sched,
    }
    return cols, names


def _report(cols: Dict[str, np.ndarray], probes: Sequence[Probe], device: DeviceLike):
    """`capacity_report` of `cols` under `probes` on `device`, read back
    as NumPy (fit_int stays on the device: nothing here reads it)."""
    report = capacity_report(*(cols[k] for k in COLUMN_KEYS), *probe_arrays(probes),
                             device=device)
    return [r.cpu().numpy() for i, r in enumerate(report) if i != 3]


def _observe_util(live_idx, util_cpu, util_mem, util_pods) -> None:
    for resource, ratios in (("cpu", util_cpu), ("mem", util_mem), ("pods", util_pods)):
        for v in ratios[live_idx].tolist():
            NODE_UTIL.observe(v, resource=resource)


def _live(cols) -> np.ndarray:
    return np.asarray(cols["sched"], bool) & ~np.asarray(cols["over"], bool)


def sample(cols: Dict[str, np.ndarray], probes: Sequence[Probe], device: DeviceLike = None):
    """`ops.capacity.capacity_report` of `cols` under `probes` on
    `device` (default: the CUDA card; raises without one), observed into
    the series as the monitor's sample feeds them: headroom per probe,
    the score, the share of allocatable probes, and every live node's
    utilisation by resource. Returns the report's tuple."""
    report = capacity_report(*(cols[k] for k in COLUMN_KEYS), *probe_arrays(probes),
                             device=device)
    util_cpu, util_mem, util_pods, _fit, headroom, _frag, slice_ok, _stranded, score = (
        r.cpu().numpy() for r in report[:9])
    n_ok = 0
    for i, (name, _cpu, _mem, _minm) in enumerate(probes):
        n_ok += bool(slice_ok[i])
        HEADROOM.set(float(headroom[i]), shape=name)
    FRAG_SCORE.observe(float(score))
    SLICE_ALLOC.observe(n_ok / len(probes) if probes else 0.0)
    _observe_util(np.flatnonzero(_live(cols)), util_cpu, util_mem, util_pods)
    return report


def _util_summary(vals) -> dict:
    if not len(vals):
        return {"mean": 0.0, "p50": 0.0, "p99": 0.0}
    return {
        "mean": round(float(vals.mean()), 6),
        "p50": round(float(np.percentile(vals, 50)), 6),
        "p99": round(float(np.percentile(vals, 99)), 6),
    }


class CapacityMonitor:
    """The process's capacity sampler: the probe set, the report on the
    device, the series and the snapshot. Thread-safe; `sample` raises
    what the report raises."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._slice_shapes: Tuple[Probe, ...] = DEFAULT_SLICE_SHAPES
        self._recent_shapes: deque = deque(maxlen=SHAPE_WINDOW)
        self._trend: deque = deque(maxlen=TREND_LEN)
        self.samples = 0
        self._last_util_mono = 0.0
        self._last: Optional[dict] = None

    def configure(self, slice_shapes: Sequence[Probe]) -> None:
        """Replace the configured slice probes: (name, cpu milli, mem
        MiB, minMember) tuples."""
        with self._lock:
            self._slice_shapes = tuple((str(n), float(c), float(m), int(k))
                                       for n, c, m, k in slice_shapes)

    def reset(self) -> None:
        with self._lock:
            self._slice_shapes = DEFAULT_SLICE_SHAPES
            self._recent_shapes.clear()
            self._trend.clear()
            self.samples = 0
            self._last_util_mono = 0.0
            self._last = None

    def warm(self, n_nodes: int = 0, device: DeviceLike = None) -> None:
        """One report of `n_nodes` empty nodes on `device` (default: the
        card), so a daemon's first sample does not pay the device's
        context and allocator; the daemons call it on a thread of its
        own at start."""
        n = max(int(n_nodes), 1)
        zeros = {k: np.zeros(n, np.float32) for k in COLUMN_KEYS}
        zeros["over"] = np.zeros(n, bool)
        zeros["sched"] = np.zeros(n, bool)
        _report(zeros, self.probe_set(), resolve_device(device))

    def note_backlog_shapes(self, shapes: Sequence[Tuple[float, float]]) -> None:
        """Record pending pods' shapes (cpu milli, mem MiB): the
        backlog quantile probes are drawn from this window."""
        with self._lock:
            self._recent_shapes.extend((float(c), float(m)) for c, m in shapes)

    def probe_set(self) -> List[Probe]:
        """The configured slice shapes and the backlog quantiles."""
        with self._lock:
            slices, recent = self._slice_shapes, list(self._recent_shapes)
        return probe_set(slices, recent)

    def sample(self, cols: Dict[str, np.ndarray], node_names: Sequence[Optional[str]],
               backlog_depth: int = 0, oldest_age_s: float = 0.0,
               device: DeviceLike = None) -> dict:
        """One sample of the occupancy columns (`COLUMN_KEYS`; a free
        slot has sched False) on `device` (default: the card): the
        series, the trend ring and the snapshot body, returned."""
        backlog_depth, oldest_age_s = int(backlog_depth), float(oldest_age_s)
        probes = self.probe_set()
        q = len(probes)
        (util_cpu, util_mem, util_pods, headroom, frag, slice_ok, stranded, frag_score,
         stranded_cpu, stranded_mem) = _report(cols, probes, resolve_device(device))

        now = time.monotonic()
        live = _live(cols)
        live_idx = np.flatnonzero(live)
        score = float(frag_score)
        pressure = float(backlog_depth) * max(oldest_age_s, 0.0)

        table = []
        n_ok = 0
        zero_headroom = False
        for i, (name, cpu, mem, minm) in enumerate(probes):
            h = int(headroom[i])
            ok = bool(slice_ok[i])
            n_ok += ok
            zero_headroom = zero_headroom or h == 0
            HEADROOM.set(float(h), shape=name)
            table.append({
                "shape": name,
                "cpu_milli": float(cpu),
                "mem_mib": float(mem),
                "min_member": int(minm),
                "headroom_pods": h,
                "fragmentation": round(float(frag[i]), 6),
                "allocatable": ok,
            })
        alloc_rate = (n_ok / q) if q else 0.0

        # Stranded top-k by leftover cpu.
        free_cpu = np.maximum(np.asarray(cols["cpu_cap"], np.float32)
                              - np.asarray(cols["cpu_fit"], np.float32), 0.0) * live
        free_mem = np.maximum(np.asarray(cols["mem_cap"], np.float32)
                              - np.asarray(cols["mem_fit"], np.float32), 0.0) * live
        stranded_idx = np.flatnonzero(stranded)
        order = stranded_idx[np.argsort(-free_cpu[stranded_idx])]

        def name_of(j):
            return node_names[j] if j < len(node_names) and node_names[j] is not None else None

        top = []
        for j in order[:TOP_K_STRANDED]:
            name = name_of(j)
            top.append({
                "node": str(name) if name is not None else f"node[{j}]",
                "free_cpu_milli": float(free_cpu[j]),
                "free_mem_mib": float(free_mem[j]),
            })

        FRAG_SCORE.observe(score)
        SLICE_ALLOC.observe(alloc_rate)
        BACKLOG_PRESSURE.set(pressure)
        if backlog_depth > 0 and zero_headroom:
            ZERO_HEADROOM.inc()
        with self._lock:
            refresh_util = now - self._last_util_mono >= UTIL_REFRESH_S
            if refresh_util:
                self._last_util_mono = now
        if refresh_util:
            _observe_util(live_idx, util_cpu, util_mem, util_pods)

        node_util = {}
        for j, c, m, p in zip(live_idx.tolist(), util_cpu[live_idx].tolist(),
                              util_mem[live_idx].tolist(), util_pods[live_idx].tolist()):
            name = name_of(j)
            if name is not None:
                node_util[str(name)] = [round(c, 4), round(m, 4), round(p, 4)]

        body = {
            "kind": "CapacityReport",
            "sampled": True,
            "fragmentation_score": round(score, 6),
            "slice_alloc_success_rate": round(alloc_rate, 6),
            "stranded_cpu_fraction": round(float(stranded_cpu), 6),
            "stranded_mem_fraction": round(float(stranded_mem), 6),
            "stranded_nodes": top,
            "stranded_node_count": int(len(stranded_idx)),
            "live_nodes": int(len(live_idx)),
            "probes": table,
            "utilization": {
                "cpu": _util_summary(util_cpu[live_idx]),
                "mem": _util_summary(util_mem[live_idx]),
                "pods": _util_summary(util_pods[live_idx]),
            },
            "node_utilization": node_util,
            "backlog": {
                "depth": backlog_depth,
                "oldest_age_s": round(max(oldest_age_s, 0.0), 3),
                "pressure": round(pressure, 3),
            },
        }
        with self._lock:
            self.samples += 1
            self._trend.append(round(score, 6))
            body["samples"] = self.samples
            body["trend"] = list(self._trend)
            self._last = body
        return body

    def snapshot(self) -> dict:
        """The latest sample's body; `sampled: false` before the first."""
        with self._lock:
            if self._last is None:
                return cold_report("capacity")
            return dict(self._last)


DEFAULT = CapacityMonitor()
