"""The capacity plane's host half: the probe set and the occupancy
columns.

The counterpart of the column builders, the probe assembly and the
report's metric series of `kubernetes_tpu/utils/capacity.py` (its
`CapacityMonitor`'s snapshot and trend ring wait for the daemon):

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
- `sample`: the capacity report of a set of columns, observed into
  the JAX series (`cluster_fragmentation_score`,
  `slice_alloc_success_rate`, `cluster_headroom_pods{shape}`,
  `node_utilization_ratio{resource}`) as the monitor's sample feeds
  them. The backlog series (`scheduler_backlog_pressure`,
  `capacity_zero_headroom_ticks_total`) need the scheduler's FIFO and
  wait for the daemon.

The columns are NumPy arrays, so either package's capacity report and
planner take them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch import DeviceLike, native
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
#: Default slice probes (cpu milli, mem MiB, minMember): a single small
#: pod, a mid gang, and an 8-member accelerator slice shape.
DEFAULT_SLICE_SHAPES: Tuple[Probe, ...] = (
    ("slice-1x250m", 250.0, 256.0, 1),
    ("slice-4x500m", 500.0, 512.0, 4),
    ("slice-8x2000m", 2000.0, 2048.0, 8),
)

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



def sample(cols: Dict[str, np.ndarray], probes: Sequence[Probe], device: DeviceLike = None):
    """`ops.capacity.capacity_report` of `cols` under `probes` on
    `device` (default: the CUDA card; raises without one), observed into
    the series as the JAX monitor's sample feeds them: headroom per
    probe, the score, the share of allocatable probes, and every live
    node's utilisation by resource. Returns the report's tuple."""
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
    live = np.flatnonzero(np.asarray(cols["sched"]) & ~np.asarray(cols["over"]))
    for resource, ratios in (("cpu", util_cpu), ("mem", util_mem), ("pods", util_pods)):
        for v in ratios[live]:
            NODE_UTIL.observe(float(v), resource=resource)
    return report
