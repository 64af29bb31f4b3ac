"""Full-relower batch scheduling on the card.

The counterpart of `kubernetes_tpu/scheduler/batch.py`'s
`schedule_backlog_tpu`, `schedule_backlog_wave`,
`schedule_backlog_sinkhorn` and `schedule_backlog_gang_tpu`: lower the
whole backlog, stage it, run the sequential-parity solve (or a windowed
one), map indices back to node names; with gangs, wrap that in the
all-or-nothing acceptance loop. `preempt_backlog` is the counterpart of
`preempt_backlog_tpu` (victim selection on the card), and
`preempt_backlog_scalar` the port's own copy of the reference's scalar
rule, the yardstick it is held to. `schedule_backlog_scalar` is the
JAX module's scalar backlog loop over the port's copy of the plugins:
the full re-lower daemon runs it for a policy that has no device
lowering, never as a fallback from the card. `resolve_batch_mode`
resolves `auto` by the mesh the solve runs on, and `env_mesh` is the
JAX package's `KT_MESH_DEVICES` escape hatch. Each backlog entry point
takes `mesh=` (`ops.matrices.host_mesh`), as the JAX ones do.
"""

from __future__ import annotations

import copy
import logging
import os
from functools import partial
from typing import List, Optional, Sequence

from kubernetes_tpu_torch import DeviceLike, resolve_device
from kubernetes_tpu_torch.models.algspec import AlgorithmSpec
from kubernetes_tpu_torch.models.columnar import (
    build_snapshot,
    mem_to_mib_ceil,
    node_is_ready,
    pod_resource_limits,
)
from kubernetes_tpu_torch.models.objects import (
    Node,
    Pod,
    Service,
    pod_can_preempt,
    pod_full_key,
    pod_is_terminating,
    pod_priority,
)
from kubernetes_tpu_torch.ops.matrices import device_snapshot, host_mesh, shardings_for
from kubernetes_tpu_torch.ops.pipeline import gang_member_counts_device
from kubernetes_tpu_torch.ops.preemption import (
    PreemptionDecision,
    build_preemption_problem,
    solve_preemption,
)
from kubernetes_tpu_torch.ops.sinkhorn import sinkhorn_assignments
from kubernetes_tpu_torch.ops.solver import solve_assignments
from kubernetes_tpu_torch.ops.wave import wave_assignments
from kubernetes_tpu_torch.scheduler.gang import gang_solve
from kubernetes_tpu_torch.scheduler.generic import FitError, GenericScheduler, NoNodesError
from kubernetes_tpu_torch.scheduler.plugins import (
    PluginFactoryArgs,
    build_from_spec,
    default_predicates,
    default_priorities,
)
from kubernetes_tpu_torch.scheduler.types import (
    StaticNodeLister,
    StaticPodLister,
    StaticServiceLister,
)
from kubernetes_tpu_torch.utils import sanitizer
from kubernetes_tpu_torch.utils.tracing import PhaseTimer, phase, timing

_AUTO_NO_MESH_WARNED = False
_ENV_MESH_WARNED = False

#: The batch modes a daemon runs; `auto` resolves to one of them.
BATCH_MODES = ("scan", "wave", "sinkhorn")


def _warn_env_once(msg: str) -> None:
    global _ENV_MESH_WARNED
    if not _ENV_MESH_WARNED:
        _ENV_MESH_WARNED = True
        logging.getLogger(__name__).warning(msg)


def env_mesh():
    """The KT_MESH_DEVICES=N escape hatch, parsed as the JAX package
    parses it: a mesh over the first N visible CUDA devices
    (`ops.matrices.host_mesh`), or None when the variable is unset, not
    an integer, below 2, or names more devices than are visible. Every
    failure but unset and =1 (an explicit "no mesh") warns, and the
    first warning is the only one, as in JAX."""
    raw = os.environ.get("KT_MESH_DEVICES")
    if raw is None:
        return None
    try:
        n = int(raw)
    except ValueError:
        _warn_env_once(
            f"KT_MESH_DEVICES={raw!r} is not an integer — ignoring the "
            "escape hatch (unsharded solve)"
        )
        return None
    if n < 2:
        if n != 1:
            _warn_env_once(
                f"KT_MESH_DEVICES={n} < 2 cannot form a mesh — ignoring "
                "the escape hatch (unsharded solve)"
            )
        return None
    mesh = host_mesh(n)
    if mesh is None:
        _warn_env_once(
            f"KT_MESH_DEVICES={n} requested but fewer CUDA devices are "
            "visible — ignoring the escape hatch (unsharded solve)"
        )
    return mesh


def resolve_batch_mode(mode: str, mesh=None) -> str:
    """`--batch-mode auto` by the mesh the solve will run on, as the JAX
    package resolves it: no mesh, the scan (exact, and the fastest
    backlog mode on one card); a mesh, the wave, whose few windowed
    commits a backlog cost far fewer cross-shard rounds than the scan's
    one a pod. With no mesh given, auto consults `env_mesh()`. The
    daemons build no mesh of their own, as JAX's do not, so there auto
    is the scan unless KT_MESH_DEVICES names one; that case warns once.
    Any other mode is returned as it is, for the caller to check."""
    if mode != "auto":
        return mode
    if mesh is None:
        mesh = env_mesh()
    if mesh is None:
        global _AUTO_NO_MESH_WARNED
        if not _AUTO_NO_MESH_WARNED:
            _AUTO_NO_MESH_WARNED = True
            logging.getLogger(__name__).warning(
                "--batch-mode auto resolved to 'scan': no device mesh is threaded "
                "through this scheduler and KT_MESH_DEVICES is unset, so auto selects "
                "scan; the wave path engages only when a solve runs over a mesh (or "
                "the KT_MESH_DEVICES=N escape hatch builds one)")
        return "scan"
    return "wave"


def schedule_backlog_scalar(
    pending: Sequence[Pod],
    nodes: Sequence[Node],
    assigned: Sequence[Pod] = (),
    services: Sequence[Service] = (),
    spec: Optional[AlgorithmSpec] = None,
) -> List[Optional[str]]:
    """Schedule the backlog one pod at a time through the scalar
    plugins, each placement committed before the next (the reference's
    scheduleOne and AssumePod), on the Ready nodes only. Returns node
    names (None: unschedulable). `spec` selects the configured plugin
    set (default: the default provider's). Phase `solve_scalar`."""
    with phase("solve_scalar", pods=len(pending)):
        committed: List[Pod] = list(assigned)
        pod_lister = StaticPodLister(committed)  # shared, grown as pods commit
        args = PluginFactoryArgs(
            pod_lister=pod_lister,
            service_lister=StaticServiceLister(list(services)),
            node_lister=StaticNodeLister(list(nodes)),
        )
        if spec is not None:
            predicates, priorities = build_from_spec(spec, args)
        else:
            predicates, priorities = default_predicates(args), default_priorities(args)
        scheduler = GenericScheduler(predicates, priorities, pod_lister)
        ready_nodes = StaticNodeLister([n for n in nodes if node_is_ready(n)])
        out: List[Optional[str]] = []
        for pod in pending:
            try:
                dest = scheduler.schedule(pod, ready_nodes)
            except (FitError, NoNodesError):
                out.append(None)
                continue
            out.append(dest)
            placed = copy.deepcopy(pod)
            placed.spec.node_name = dest
            pod_lister.pods.append(placed)
        return out


def schedule_backlog(
    pending: Sequence[Pod],
    nodes: Sequence[Node],
    assigned: Sequence[Pod] = (),
    services: Sequence[Service] = (),
    device: DeviceLike = None,
    timer: Optional[PhaseTimer] = None,
    spec: Optional[AlgorithmSpec] = None,
    mesh=None,
) -> List[Optional[str]]:
    """Node name per pending pod (None = unschedulable), with the
    reference's sequential decision semantics. Runs on `device`
    (default: the CUDA card; raises without one), or sharded over
    `mesh` (then `device` is not read; the default spec only). A
    non-default `spec` lowers the configured predicate/priority set
    (UnloweredPolicyError when it cannot) and solves it on the policy
    scan kernel."""
    # A kernel dispatch blocks on device work and, the first time, on a
    # kernel build: ktsan treats it like any other blocking call, never
    # under a sanitized lock.
    sanitizer.check_blocking("kernel-dispatch", "schedule_backlog")
    _, device = shardings_for(mesh, device)
    with timing(timer):
        with phase("lower", pods=len(pending)):
            snap = build_snapshot(
                pending, nodes, assigned_pods=assigned, services=services, spec=spec
            )
        with phase("upload"):
            dsnap = device_snapshot(snap, device, mesh=mesh)
        with phase("solve", mode="scan"):
            # solve_assignments copies the result to the host, so this
            # phase includes the device time.
            assignment = solve_assignments(dsnap)
        with phase("readback"):
            names = snap.nodes.names
            return [names[i] if i >= 0 else None for i in assignment]


def _schedule_windowed(solve, pending, nodes, assigned, services, device, timer, mesh):
    _, device = shardings_for(mesh, device)
    with timing(timer):
        with phase("lower", pods=len(pending)):
            snap = build_snapshot(pending, nodes, assigned_pods=assigned, services=services)
        with phase("upload"):
            dsnap = device_snapshot(snap, device, mesh=mesh)
        # The solver opens "solve" itself and reads the result back in it.
        assignment, waves = solve(dsnap)
        if timer is not None:
            timer.stats["waves"] = waves
        with phase("readback"):
            names = snap.nodes.names
            return [names[i] if i >= 0 else None for i in assignment]


def schedule_backlog_wave(
    pending: Sequence[Pod],
    nodes: Sequence[Node],
    assigned: Sequence[Pod] = (),
    services: Sequence[Service] = (),
    device: DeviceLike = None,
    timer: Optional[PhaseTimer] = None,
    mesh=None,
) -> List[Optional[str]]:
    """Schedule via the wave-commit solver (`ops/wave.py`), default
    policy: many pods committed per device step, at the cost of exact
    decision-order parity (placements stay valid). Runs on `device`
    (default: the CUDA card; raises without one), or over `mesh`."""
    sanitizer.check_blocking("kernel-dispatch", "schedule_backlog_wave")
    return _schedule_windowed(wave_assignments, pending, nodes, assigned, services, device, timer,
                              mesh)


def schedule_backlog_sinkhorn(
    pending: Sequence[Pod],
    nodes: Sequence[Node],
    assigned: Sequence[Pod] = (),
    services: Sequence[Service] = (),
    device: DeviceLike = None,
    timer: Optional[PhaseTimer] = None,
    mesh=None,
) -> List[Optional[str]]:
    """Schedule via the Sinkhorn-matched wave solver
    (`ops/sinkhorn.py`): capacity-capped congestion prices before each
    wave's choice, fewer waves than the plain wave solver on big
    backlogs; placements stay valid. Runs on `device`, or over
    `mesh`."""
    sanitizer.check_blocking("kernel-dispatch", "schedule_backlog_sinkhorn")
    return _schedule_windowed(sinkhorn_assignments, pending, nodes, assigned, services, device,
                              timer, mesh)


def schedule_backlog_gang(
    pending: Sequence[Pod],
    nodes: Sequence[Node],
    assigned: Sequence[Pod] = (),
    services: Sequence[Service] = (),
    groups=(),
    device: DeviceLike = None,
    timer: Optional[PhaseTimer] = None,
    spec: Optional[AlgorithmSpec] = None,
    mesh=None,
):
    """Gang-accepting backlog solve on `device` (default: the CUDA card;
    raises without one), or over `mesh`: `schedule_backlog` each round,
    under `spec`, the group counts by the masked segment sum on the
    device (the mesh's first). Returns (destinations, accepted_groups,
    rejected_groups); see `scheduler.gang.gang_solve`."""
    _, device = shardings_for(mesh, device)

    def solver(p, n, a, s):
        return schedule_backlog(p, n, a, s, device=device, timer=timer, spec=spec, mesh=mesh)

    return gang_solve(
        solver, pending, nodes, assigned, services, groups,
        counts_fn=partial(gang_member_counts_device, device=device),
        timer=timer,
    )


def preempt_backlog(
    preemptors: Sequence[Pod],
    nodes: Sequence[Node],
    assigned: Sequence[Pod] = (),
    device: DeviceLike = None,
    timer: Optional[PhaseTimer] = None,
) -> List[Optional[PreemptionDecision]]:
    """Victim selection on `device` (default: the CUDA card; raises
    without one): decisions aligned with `preemptors`, the same as
    `preempt_backlog_scalar`'s. Phases: `build` (the host lowering) and
    `solve` (the launches and the one readback)."""
    device = resolve_device(device)
    with timing(timer):
        with phase("build"):
            problem = build_preemption_problem(nodes, assigned)
        with phase("solve"):
            return solve_preemption(problem, preemptors, device=device)


def preempt_backlog_scalar(
    preemptors: Sequence[Pod],
    nodes: Sequence[Node],
    assigned: Sequence[Pod] = (),
) -> List[Optional[PreemptionDecision]]:
    """Scalar victim selection, the preemption yardstick: the canonical
    rule of `ops/preemption.py` written independently in Python floats.
    Per node, victims are the shortest (priority asc, arrival asc) prefix
    of strictly dominated live pods whose freed cpu, memory and slots
    fit the preemptor; nodes rank by (max victim priority, count, node
    index); preemptors run highest priority first, each grant charging
    the node state the next one sees. O(N x V) a preemptor."""
    INF = float("inf")
    nodes = list(nodes)
    index = {n.metadata.name: j for j, n in enumerate(nodes)}
    free = []  # per node [cpu, mem, pods]
    for node in nodes:
        cap = node.status.capacity or {}
        cpu = cap.get("cpu").milli_value() if cap.get("cpu") else 0
        mem = cap.get("memory").value() // (1024**2) if cap.get("memory") else 0
        pods = cap.get("pods").value() if cap.get("pods") else 0
        free.append([cpu or INF, mem or INF, pods or INF])
    victims = []  # [prio, arrival_idx, node_j, cpu, mem, key, alive]
    for i, pod in enumerate(assigned):
        j = index.get(pod.spec.node_name, -1)
        if j < 0:
            continue
        cpu, mem = pod_resource_limits(pod)
        cpu, mem = float(cpu), float(mem_to_mib_ceil(mem))
        free[j][0] -= cpu
        free[j][1] -= mem
        free[j][2] -= 1
        if pod.status.phase in ("Succeeded", "Failed") or pod_is_terminating(pod):
            continue
        victims.append([pod_priority(pod), i, j, cpu, mem, pod_full_key(pod), True])
    out: List[Optional[PreemptionDecision]] = [None] * len(preemptors)
    for i in sorted(range(len(preemptors)), key=lambda t: (-pod_priority(preemptors[t]), t)):
        pod = preemptors[i]
        prio = pod_priority(pod)
        if prio <= 0 or not pod_can_preempt(pod):
            continue
        cpu, mem = pod_resource_limits(pod)
        cpu, mem = float(cpu), float(mem_to_mib_ceil(mem))
        sel = pod.spec.node_selector or {}
        best = None
        for j, node in enumerate(nodes):
            if not node_is_ready(node) or node.spec.unschedulable:
                continue
            labels = node.metadata.labels or {}
            if any(labels.get(k) != v for k, v in sel.items()):
                continue
            f_cpu, f_mem, f_pods = free[j]
            if f_cpu >= cpu and f_mem >= mem and f_pods >= 1:
                continue  # fits without eviction: not a preemption case
            prefix = []
            for v in sorted(
                (v for v in victims if v[6] and v[2] == j and v[0] < prio),
                key=lambda v: (v[0], v[1]),
            ):
                prefix.append(v)
                f_cpu += v[3]
                f_mem += v[4]
                f_pods += 1
                if f_cpu >= cpu and f_mem >= mem and f_pods >= 1:
                    score = (prefix[-1][0], len(prefix), j)
                    if best is None or score < best[0]:
                        best = (score, j, list(prefix))
                    break
        if best is None:
            continue
        _, j, prefix = best
        for v in prefix:
            v[6] = False
            free[j][0] += v[3]
            free[j][1] += v[4]
            free[j][2] += 1
        free[j][0] -= cpu
        free[j][1] -= mem
        free[j][2] -= 1
        out[i] = PreemptionDecision(
            key=pod_full_key(pod),
            node=nodes[j].metadata.name,
            victims=tuple(v[5] for v in prefix),
        )
    return out
