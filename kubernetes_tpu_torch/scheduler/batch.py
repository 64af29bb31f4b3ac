"""Full-relower batch scheduling on the card.

The counterpart of `kubernetes_tpu/scheduler/batch.py`'s
`schedule_backlog_tpu`: lower the whole backlog, stage it, run the
sequential-parity solve, map indices back to node names.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from kubernetes_tpu_torch import DeviceLike, resolve_device
from kubernetes_tpu_torch.models.columnar import build_snapshot
from kubernetes_tpu_torch.models.objects import Node, Pod, Service
from kubernetes_tpu_torch.ops.matrices import device_snapshot
from kubernetes_tpu_torch.ops.solver import solve_assignments
from kubernetes_tpu_torch.utils.tracing import PhaseTimer, phase


def schedule_backlog(
    pending: Sequence[Pod],
    nodes: Sequence[Node],
    assigned: Sequence[Pod] = (),
    services: Sequence[Service] = (),
    device: DeviceLike = None,
    timer: Optional[PhaseTimer] = None,
) -> List[Optional[str]]:
    """Node name per pending pod (None = unschedulable), with the
    reference's sequential decision semantics. Runs on `device`
    (default: the CUDA card; raises without one)."""
    device = resolve_device(device)
    with phase(timer, "lower"):
        snap = build_snapshot(pending, nodes, assigned_pods=assigned, services=services)
    with phase(timer, "upload"):
        dsnap = device_snapshot(snap, device)
    with phase(timer, "solve"):
        # solve_assignments copies the result to the host, so this phase
        # includes the device time.
        assignment = solve_assignments(dsnap)
    with phase(timer, "readback"):
        names = snap.nodes.names
        return [names[i] if i >= 0 else None for i in assignment]
