"""Pipelined backlog solve: host lowering and upload overlap the scan.

The counterpart of `kubernetes_tpu/ops/pipeline.py`. The pending
backlog is lowered and staged in chunks, and the node carry is chained
from one chunk's solve to the next. Kernel launches return at once, so
while the card scans chunk k the host lowers and stages chunk k+1 (its
copies start from pinned memory and do not block the host), and each
chunk's choices are copied back into pinned host memory behind the next
chunk's work. The one wait is the final readback.

In scan mode decisions equal the monolithic solve's bit for bit:
chunking changes when pod rows reach the device, never the order they
are scanned or the carry they see. Modes "wave" and "sinkhorn" run the
windowed solvers (`ops/wave.py`, `ops/sinkhorn.py`) chunk by chunk on
the same carry; each wave reads one flag back (whether pods remain),
so there the host waits on the card inside "solve".

`gang_member_counts_device` is the device half of gang acceptance
(`scheduler/gang.py`), and `explain_matrix` / `explain_backlog` the
explain readback, as in the JAX package's pipeline module.

Each takes `mesh=` as the JAX package's do: the node columns are
staged once, sharded over the mesh (`matrices.ShardedNodes`), the pod
chunks go to the mesh's first device, and the solvers run sharded.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from kubernetes_tpu_torch import DeviceLike, resolve_device
from kubernetes_tpu_torch.models.columnar import SnapshotBuilder, build_snapshot, pod_key
from kubernetes_tpu_torch.models.objects import Node, Pod, Service
from kubernetes_tpu_torch.ops.matrices import (
    EXPLAIN_PREDICATES,
    decode_predicate_bits,
    device_nodes,
    device_pods,
    device_snapshot,
    gang_member_counts,
    pow2_bucket,
    shardings_for,
)
from kubernetes_tpu_torch.ops.sinkhorn import solve_sinkhorn_with_state
from kubernetes_tpu_torch.ops.solver import DEFAULT_WEIGHTS, explain_rows, solve_with_state
from kubernetes_tpu_torch.ops.wave import solve_waves_with_state
from kubernetes_tpu_torch.utils import flightrecorder, sanitizer, sli
from kubernetes_tpu_torch.utils.tracing import PhaseTimer, phase, timing

# The JAX package's chunk: 50k pods in four chunks, each padded to a
# 13,312-pod bucket.
DEFAULT_CHUNK = 12544


def _to_host_async(t: torch.Tensor) -> torch.Tensor:
    """Start a device->host copy into pinned memory without waiting (the
    counterpart of jax.Array.copy_to_host_async). The result is valid
    once the stream has reached the copy."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def gang_member_counts_device(
    placed, group_ids, num_groups: int, device: DeviceLike = None
) -> np.ndarray:
    """The gang-acceptance reduction on `device` (default: the CUDA
    card; raises without one): the host placed-mask and group-id
    columns go to the device, `matrices.gang_member_counts` runs there,
    and the counts come back as int32[num_groups]. Both axes pad to the
    JAX package's power-of-two buckets (minimum 8), with placed=False
    and id -1, which the reduction masks out."""
    G = int(num_groups)
    if G <= 0:
        return np.zeros(0, np.int32)
    device = resolve_device(device)
    placed = np.asarray(placed, bool)
    gids = np.asarray(group_ids, np.int32)
    P = placed.shape[0]
    PP = pow2_bucket(max(P, 1), minimum=8)
    if PP != P:
        placed = np.pad(placed, (0, PP - P))
        gids = np.pad(gids, (0, PP - P), constant_values=-1)
    counts = gang_member_counts(
        torch.from_numpy(placed).to(device),
        torch.from_numpy(gids).to(device),
        pow2_bucket(G, minimum=8),
    )
    return counts.cpu().numpy()[:G]


def solve_backlog_pipelined(
    pending: Sequence[Pod],
    nodes: Sequence[Node],
    assigned: Sequence[Pod] = (),
    services: Sequence[Service] = (),
    chunk: int = DEFAULT_CHUNK,
    weights=DEFAULT_WEIGHTS,
    mode: str = "scan",
    device: DeviceLike = None,
    timer: Optional[PhaseTimer] = None,
    mesh=None,
) -> List[Optional[str]]:
    """Schedule the backlog; returns node names (None = unschedulable).
    Runs on `device` (default: the CUDA card; raises without one), or
    over `mesh` (`matrices.host_mesh`; then `device` is not read).
    `timer` collects the lower/upload/solve/readback wall seconds and,
    for the windowed modes, `stats`: the waves of all chunks, and for
    Sinkhorn the total price iterations and the last chunk's residual.

    mode="scan" is bit-identical to scheduler.batch.schedule_backlog;
    "wave" and "sinkhorn" are the JAX package's windowed solvers (the
    wave bit-identical to it, Sinkhorn within its rounding), with every
    capacity, port and volume invariant of the scan."""
    sanitizer.check_blocking("kernel-dispatch", "solve_backlog_pipelined")
    tele = []
    if mode == "scan":
        step = lambda dpods, carry: solve_with_state(dpods, carry, weights)  # noqa: E731
    elif mode == "wave":
        def step(dpods, carry):
            a, c, w = solve_waves_with_state(dpods, carry, weights)
            tele.append((w, None, None))
            return a, c
    elif mode == "sinkhorn":
        def step(dpods, carry):
            a, c, w, it, res = solve_sinkhorn_with_state(dpods, carry, weights)
            tele.append((w, it, res))
            return a, c
    else:
        raise ValueError(f"unknown pipeline mode {mode!r}")
    _, device = shardings_for(mesh, device)
    # Phases wrap whole host segments, never per-pod work: a few clock
    # reads a chunk. Launches return at once, so a chunk's "solve"
    # measures its launches and the device time drains into "readback".
    with timing(timer):
        with phase("lower", pods=len(pending)):
            builder = SnapshotBuilder(pending, nodes, assigned, services)
        with phase("upload"):
            carry = device_nodes(builder.node_columns(), device, mesh=mesh)
        P = len(builder.pending)
        outs = []
        for ci, start in enumerate(range(0, max(P, 1), chunk)):
            with phase("lower", chunk=ci):
                cols = builder.pod_columns(start, min(start + chunk, P))
            # Full chunks share one padded shape; the tail pads to its own
            # bucket.
            with phase("upload", chunk=ci):
                dpods = device_pods(cols, device)
            with phase("solve", chunk=ci):
                assignment, carry = step(dpods, carry)
                outs.append((_to_host_async(assignment), cols.count))

        with phase("readback"):
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
            names = [n.metadata.name for n in builder.nodes]
            n_nodes = len(names)
            result: List[Optional[str]] = []
            for host, count in outs:
                for j in host[:count].tolist():
                    result.append(names[j] if 0 <= j < n_nodes else None)
            sli.note_transfer("d2h", sum(sli.nbytes_of({"a": host}) for host, _ in outs))
            if tele:
                waves = sum(int(w) for w, _, _ in tele)
                if timer is not None:
                    timer.stats["waves"] = waves
                if mode == "sinkhorn":
                    iters = sum(int(it) for _, it, _ in tele)
                    residual = float(tele[-1][2])
                    flightrecorder.observe_solve_telemetry("sinkhorn", iters, residual=residual,
                                                            waves=waves)
                    if timer is not None:
                        timer.stats["sinkhorn_iters"] = iters
                        timer.stats["sinkhorn_residual"] = residual
                else:
                    flightrecorder.observe_solve_telemetry("wave", waves)
            return result


# -- explain readback ---------------------------------------------------


def explain_matrix(
    pending: Sequence[Pod],
    nodes: Sequence[Node],
    assigned: Sequence[Pod] = (),
    services: Sequence[Service] = (),
    device: DeviceLike = None,
    mesh=None,
):
    """Raw explain readback for a backlog against one FIXED cluster state
    (`assigned` pods charge occupancy; `pending` pods commit nothing, so
    every row sees the same state), on `device` (default: the CUDA card;
    raises without one). Returns (node_names, bits u32[P, N], components
    dict of i32[P, N]): bit i of bits[p, n] set means
    matrices.EXPLAIN_PREDICATES[i] rejected node n for pod p; bits == 0
    is feasibility under the default pipeline. One batched evaluation
    and one readback, never on the solve path. Over `mesh` each shard
    evaluates its nodes and the columns are stitched on its first
    device."""
    snap = build_snapshot(pending, nodes, assigned_pods=assigned, services=services)
    dsnap = device_snapshot(snap, device, mesh=mesh)
    bits, lr, bra, spread = explain_rows(dsnap.pods, dsnap.nodes)
    P, N = dsnap.n_pods, dsnap.n_nodes
    host = lambda t: t[:P, :N].cpu().numpy()
    return (
        snap.nodes.names,
        host(bits).view(np.uint32),
        {"leastRequested": host(lr), "balanced": host(bra), "spreading": host(spread)},
    )


def explain_backlog(
    pending: Sequence[Pod],
    nodes: Sequence[Node],
    assigned: Sequence[Pod] = (),
    services: Sequence[Service] = (),
    device: DeviceLike = None,
    top_k: int = 3,
    max_failed: int = 16,
    mesh=None,
) -> List[dict]:
    """Bounded per-pod explain verdicts, the flight recorder's shape, as
    the JAX package's `explain_backlog` builds them. For each pending pod
    (aligned with the input): the top_k feasible nodes ranked by total
    default-priority score (lowest index wins ties, the solver's
    tie-break) with the score decomposition, up to max_failed
    individually listed infeasible nodes, and aggregate failed-predicate
    counts over all nodes."""
    pending = list(pending)
    if not pending:
        return []
    names, bits, comps = explain_matrix(pending, nodes, assigned, services, device=device,
                                        mesh=mesh)
    total = comps["leastRequested"] + comps["balanced"] + comps["spreading"]
    out: List[dict] = []
    n_nodes = len(names)
    for i, pod in enumerate(pending):
        row = bits[i]
        feasible = np.flatnonzero(row == 0)
        entry_nodes: List[dict] = []
        # Score descending, node index ascending within a score (a stable
        # sort of -score keeps index order: the scan's tie-break).
        for j in feasible[np.argsort(-total[i][feasible], kind="stable")][:top_k].tolist():
            entry_nodes.append({
                "node": names[j],
                "ok": True,
                "score": int(total[i, j]),
                "components": {k: int(v[i, j]) for k, v in comps.items()},
            })
        reason_counts: Dict[str, int] = {}
        for b, name in enumerate(EXPLAIN_PREDICATES):
            c = int(((row >> np.uint32(b)) & 1).sum())
            if c:
                reason_counts[name] = c
        for j in np.flatnonzero(row != 0)[:max_failed].tolist():
            entry_nodes.append({
                "node": names[j],
                "ok": False,
                "reasons": decode_predicate_bits(int(row[j])),
            })
        out.append({
            "pod": pod_key(pod),
            "feasibleNodes": int(len(feasible)),
            "totalNodes": n_nodes,
            "nodes": entry_nodes,
            "reasonCounts": reason_counts,
        })
    return out
