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
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from kubernetes_tpu_torch import DeviceLike, resolve_device
from kubernetes_tpu_torch.models.columnar import SnapshotBuilder
from kubernetes_tpu_torch.models.objects import Node, Pod, Service
from kubernetes_tpu_torch.ops.matrices import device_nodes, device_pods
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
