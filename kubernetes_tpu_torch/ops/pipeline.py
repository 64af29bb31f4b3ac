"""Pipelined backlog solve: host lowering and upload overlap the scan.

The counterpart of `kubernetes_tpu/ops/pipeline.py` in scan mode. The
pending backlog is lowered and staged in chunks, and the node carry is
chained from one chunk's solve to the next. Kernel launches return at
once, so while the card scans chunk k the host lowers and stages chunk
k+1 (its copies start from pinned memory and do not block the host),
and each chunk's choices are copied back into pinned host memory behind
the next chunk's work. The one wait is the final readback.

Decisions equal the monolithic solve's bit for bit: chunking changes
when pod rows reach the device, never the order they are scanned or the
carry they see.

`gang_member_counts_device` is the device half of gang acceptance
(`scheduler/gang.py`), as in the JAX package's pipeline module.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from kubernetes_tpu_torch import DeviceLike, resolve_device
from kubernetes_tpu_torch.models.columnar import SnapshotBuilder
from kubernetes_tpu_torch.models.objects import Node, Pod, Service
from kubernetes_tpu_torch.ops.matrices import (
    device_nodes,
    device_pods,
    gang_member_counts,
    pow2_bucket,
)
from kubernetes_tpu_torch.ops.solver import DEFAULT_WEIGHTS, solve_with_state
from kubernetes_tpu_torch.utils.tracing import PhaseTimer, phase

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
) -> List[Optional[str]]:
    """Schedule the backlog; returns node names (None = unschedulable),
    bit-identical to scheduler.batch.schedule_backlog. Runs on `device`
    (default: the CUDA card; raises without one). `timer` collects the
    lower/upload/solve/readback wall seconds."""
    if mode in ("wave", "sinkhorn"):
        raise NotImplementedError(
            f"pipeline mode {mode!r} is not ported yet: ROADMAP queue 1, 'wave/sinkhorn'"
        )
    if mode != "scan":
        raise ValueError(f"unknown pipeline mode {mode!r}")
    device = resolve_device(device)
    with phase(timer, "lower"):
        builder = SnapshotBuilder(pending, nodes, assigned, services)
    with phase(timer, "upload"):
        carry = device_nodes(builder.node_columns(), device)
    P = len(builder.pending)
    outs = []
    for start in range(0, max(P, 1), chunk):
        with phase(timer, "lower"):
            cols = builder.pod_columns(start, min(start + chunk, P))
        # Full chunks share one padded shape; the tail pads to its own
        # bucket.
        with phase(timer, "upload"):
            dpods = device_pods(cols, device)
        with phase(timer, "solve"):
            assignment, carry = solve_with_state(dpods, carry, weights)
            outs.append((_to_host_async(assignment), cols.count))

    with phase(timer, "readback"):
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        names = [n.metadata.name for n in builder.nodes]
        n_nodes = len(names)
        result: List[Optional[str]] = []
        for host, count in outs:
            for j in host[:count].tolist():
                result.append(names[j] if 0 <= j < n_nodes else None)
        return result
