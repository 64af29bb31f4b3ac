"""Full-relower batch scheduling on the card.

The counterpart of `kubernetes_tpu/scheduler/batch.py`'s
`schedule_backlog_tpu`, `schedule_backlog_wave`,
`schedule_backlog_sinkhorn` and `schedule_backlog_gang_tpu`: lower the
whole backlog, stage it, run the sequential-parity solve (or a windowed
one), map indices back to node names; with gangs, wrap that in the
all-or-nothing acceptance loop.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence

from kubernetes_tpu_torch import DeviceLike, resolve_device
from kubernetes_tpu_torch.models.algspec import AlgorithmSpec
from kubernetes_tpu_torch.models.columnar import build_snapshot
from kubernetes_tpu_torch.models.objects import Node, Pod, Service
from kubernetes_tpu_torch.ops.matrices import device_snapshot
from kubernetes_tpu_torch.ops.pipeline import gang_member_counts_device
from kubernetes_tpu_torch.ops.sinkhorn import sinkhorn_assignments
from kubernetes_tpu_torch.ops.solver import solve_assignments
from kubernetes_tpu_torch.ops.wave import wave_assignments
from kubernetes_tpu_torch.scheduler.gang import gang_solve
from kubernetes_tpu_torch.utils.tracing import PhaseTimer, phase


def schedule_backlog(
    pending: Sequence[Pod],
    nodes: Sequence[Node],
    assigned: Sequence[Pod] = (),
    services: Sequence[Service] = (),
    device: DeviceLike = None,
    timer: Optional[PhaseTimer] = None,
    spec: Optional[AlgorithmSpec] = None,
) -> List[Optional[str]]:
    """Node name per pending pod (None = unschedulable), with the
    reference's sequential decision semantics. Runs on `device`
    (default: the CUDA card; raises without one). A non-default `spec`
    lowers the configured predicate/priority set (UnloweredPolicyError
    when it cannot) and solves it on the policy scan kernel."""
    device = resolve_device(device)
    with phase(timer, "lower"):
        snap = build_snapshot(
            pending, nodes, assigned_pods=assigned, services=services, spec=spec
        )
    with phase(timer, "upload"):
        dsnap = device_snapshot(snap, device)
    with phase(timer, "solve"):
        # solve_assignments copies the result to the host, so this phase
        # includes the device time.
        assignment = solve_assignments(dsnap)
    with phase(timer, "readback"):
        names = snap.nodes.names
        return [names[i] if i >= 0 else None for i in assignment]


def _schedule_windowed(solve, pending, nodes, assigned, services, device, timer):
    device = resolve_device(device)
    with phase(timer, "lower"):
        snap = build_snapshot(pending, nodes, assigned_pods=assigned, services=services)
    with phase(timer, "upload"):
        dsnap = device_snapshot(snap, device)
    # The solver opens "solve" itself and reads the result back in it.
    assignment, waves = solve(dsnap, timer)
    if timer is not None:
        timer.stats["waves"] = waves
    with phase(timer, "readback"):
        names = snap.nodes.names
        return [names[i] if i >= 0 else None for i in assignment]


def schedule_backlog_wave(
    pending: Sequence[Pod],
    nodes: Sequence[Node],
    assigned: Sequence[Pod] = (),
    services: Sequence[Service] = (),
    device: DeviceLike = None,
    timer: Optional[PhaseTimer] = None,
) -> List[Optional[str]]:
    """Schedule via the wave-commit solver (`ops/wave.py`), default
    policy: many pods committed per device step, at the cost of exact
    decision-order parity (placements stay valid). Runs on `device`
    (default: the CUDA card; raises without one)."""
    return _schedule_windowed(wave_assignments, pending, nodes, assigned, services, device, timer)


def schedule_backlog_sinkhorn(
    pending: Sequence[Pod],
    nodes: Sequence[Node],
    assigned: Sequence[Pod] = (),
    services: Sequence[Service] = (),
    device: DeviceLike = None,
    timer: Optional[PhaseTimer] = None,
) -> List[Optional[str]]:
    """Schedule via the Sinkhorn-matched wave solver
    (`ops/sinkhorn.py`): capacity-capped congestion prices before each
    wave's choice, fewer waves than the plain wave solver on big
    backlogs; placements stay valid."""
    return _schedule_windowed(sinkhorn_assignments, pending, nodes, assigned, services, device,
                              timer)


def schedule_backlog_gang(
    pending: Sequence[Pod],
    nodes: Sequence[Node],
    assigned: Sequence[Pod] = (),
    services: Sequence[Service] = (),
    groups=(),
    device: DeviceLike = None,
    timer: Optional[PhaseTimer] = None,
    spec: Optional[AlgorithmSpec] = None,
):
    """Gang-accepting backlog solve on `device` (default: the CUDA card;
    raises without one): `schedule_backlog` each round, under `spec`,
    the group counts by the masked segment sum on the device. Returns
    (destinations, accepted_groups, rejected_groups); see
    `scheduler.gang.gang_solve`."""
    device = resolve_device(device)

    def solver(p, n, a, s):
        return schedule_backlog(p, n, a, s, device=device, timer=timer, spec=spec)

    return gang_solve(
        solver, pending, nodes, assigned, services, groups,
        counts_fn=partial(gang_member_counts_device, device=device),
        timer=timer,
    )
