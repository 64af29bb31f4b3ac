"""The assignment solver on tensors.

The counterpart of `kubernetes_tpu/ops/solver.py`. It keeps the
reference's sequential greedy semantics: pod k's placement changes pod
k+1's feasibility and scores. Each step evaluates the default
predicate/priority pipeline for ONE pod against ALL nodes as tensor
ops:

  predicates (masks):           reference
    resources + pod count       PodFitsResources  predicates.go:139-156
    nodeSelector subset         MatchNodeSelector predicates.go:184-190
    hostPort conflicts          PodFitsPorts      predicates.go:337-349
    exclusive volumes           NoDiskConflict    predicates.go:85-95
    pinned host                 HostName          predicates.go:192-197
  priorities (scores, exact integer math):
    LeastRequested              priorities.go:31-95 (int32 division)
    BalancedResourceAllocation  priorities.go:146-205 (f32 fractions)
    ServiceSpreading            spreading.go:38-87

Score ties go to the lowest node index.

`_scan_solve` is that loop written plainly in PyTorch, one pod per
iteration; it is the plain version of the CUDA scan kernel
(`ops/scan_kernel.py`), which runs the same steps in one launch.
`solve_with_state` sends CUDA tensors to the kernel and CPU tensors to
the plain loop. Only the default LoweredSpec is ported: a policy spec
raises NotImplementedError (ROADMAP queue 1, "policy specs").
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.models.algspec import DEFAULT_LOWERED, LoweredSpec
from kubernetes_tpu_torch.ops import scan_kernel
from kubernetes_tpu_torch.ops.matrices import CARRY_KEYS, DeviceSnapshot

Tensors = Dict[str, torch.Tensor]

# Weighted-sum weights for the default provider (defaults.go:51-60):
# LeastRequested=1, BalancedResourceAllocation=1, ServiceSpreading=1.
DEFAULT_WEIGHTS = (1, 1, 1)


def _require_default(lspec: LoweredSpec) -> None:
    if lspec != DEFAULT_LOWERED:
        raise NotImplementedError(
            "policy specs (non-default LoweredSpec) are not ported yet: "
            "ROADMAP queue 1, 'policy specs (_solve_xla)'"
        )


def _floordiv(a: torch.Tensor, b) -> torch.Tensor:
    """Integer floor division, as JAX's `//`."""
    return torch.div(a, b, rounding_mode="floor")


def _pred_resources(pod: Tensors, nodes: Tensors) -> torch.Tensor:
    """PodFitsResources (predicates.go:139-156) as bool[N]."""
    cpu_cap, mem_cap = nodes["cpu_cap"], nodes["mem_cap"]
    fits_cpu = (cpu_cap == 0) | (nodes["cpu_fit"] + pod["cpu"] <= cpu_cap)
    fits_mem = (mem_cap == 0) | (nodes["mem_fit"] + pod["mem"] <= mem_cap)
    fits_count = nodes["pods_used"] + 1 <= nodes["pods_cap"]
    nonzero_ok = (~nodes["over"]) & fits_cpu & fits_mem & fits_count
    # Zero-request pods only check pod-count headroom (predicates.go:146).
    zero_ok = nodes["pods_used"] < nodes["pods_cap"]
    return torch.where(pod["zero_req"], zero_ok, nonzero_ok)


def _pred_selector(pod: Tensors, nodes: Tensors) -> torch.Tensor:
    """MatchNodeSelector: selector bits must be a subset of labels."""
    sel = pod["sel"][None, :]
    return ((sel & nodes["labels"]) == sel).all(dim=1)


def _pred_ports(pod: Tensors, nodes: Tensors) -> torch.Tensor:
    """PodFitsPorts."""
    return ~((pod["port"][None, :] & nodes["uport"]) != 0).any(dim=1)


def _pred_disk(pod: Tensors, nodes: Tensors) -> torch.Tensor:
    """NoDiskConflict: conflict when either side holds it read-write."""
    clash = (pod["vol_rw"][None, :] & nodes["uvol_any"]) | (
        pod["vol_any"][None, :] & nodes["uvol_rw"]
    )
    return ~(clash != 0).any(dim=1)


def _pred_hostname(pod: Tensors, idx: torch.Tensor) -> torch.Tensor:
    """HostName."""
    return (pod["pinned"] == -1) | (idx == pod["pinned"])


def _feasible(pod: Tensors, nodes: Tensors, idx: torch.Tensor) -> torch.Tensor:
    """The default predicates as one bool[N] mask."""
    ok = nodes["sched"]
    ok = ok & _pred_resources(pod, nodes)
    ok = ok & _pred_selector(pod, nodes)
    ok = ok & _pred_ports(pod, nodes)
    ok = ok & _pred_disk(pod, nodes)
    return ok & _pred_hostname(pod, idx)


def _component_scores(
    pod: Tensors, nodes: Tensors
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three default priority columns (LeastRequested,
    BalancedResourceAllocation, ServiceSpreading) as int32[N] each.

    Resource columns are integer-valued f32 below 2^24, so the casts to
    int32 are exact and the Go integer division is reproduced exactly."""
    cpu_cap = nodes["cpu_cap"].to(torch.int32)
    mem_cap = nodes["mem_cap"].to(torch.int32)
    cpu_req = (nodes["cpu_used"] + pod["cpu"]).to(torch.int32)
    mem_req = (nodes["mem_used"] + pod["mem"]).to(torch.int32)

    def calc_score(req, cap):
        # priorities.go:31-40: 0 if cap == 0 or req > cap.
        raw = torch.where(cap > 0, _floordiv((cap - req) * 10, cap.clamp(min=1)), 0)
        return torch.where((cap == 0) | (req > cap), 0, raw)

    lr = _floordiv(calc_score(cpu_req, cpu_cap) + calc_score(mem_req, mem_cap), 2)

    # BalancedResourceAllocation (priorities.go:146-205) in f32, with the
    # JAX package's +1e-5 boundary epsilon: every operation is its own
    # correctly rounded f32 step, as there.
    cfrac = torch.where(cpu_cap == 0, 1.0, cpu_req / cpu_cap.clamp(min=1))
    mfrac = torch.where(mem_cap == 0, 1.0, mem_req / mem_cap.clamp(min=1))
    bra = torch.where(
        (cfrac >= 1) | (mfrac >= 1),
        0,
        (10 - (cfrac - mfrac).abs() * 10 + 1e-5).to(torch.int32),
    )

    # ServiceSpreading (spreading.go:38-87) in exact integer math:
    # 10 * (maxc - count) // maxc over the pod's first service.
    svc = pod["svc"]
    column = svc.clamp(min=0).reshape(1).to(torch.int64)
    counts = nodes["svc_counts"].index_select(1, column)[:, 0].to(torch.int32)
    maxc = counts.max()
    spread_raw = _floordiv(10 * (maxc - counts), maxc.clamp(min=1))
    spread = torch.where((svc < 0) | (maxc == 0), 10, spread_raw)
    return lr, bra, spread


def _scores(pod: Tensors, nodes: Tensors, weights) -> torch.Tensor:
    """Weighted default priorities as one int32[N] score vector."""
    w_lr, w_bra, w_spread = weights
    lr, bra, spread = _component_scores(pod, nodes)
    total = torch.zeros_like(lr)
    if w_lr:
        total = total + lr * w_lr
    if w_bra:
        total = total + bra * w_bra
    if w_spread:
        total = total + spread * w_spread
    return total


def _commit(nodes: Tensors, pod: Tensors, choice: torch.Tensor, idx: torch.Tensor) -> None:
    """Apply one placement to the occupancy carry, in place (the batch
    analog of Modeler.AssumePod, modeler.go:113)."""
    assigned = choice >= 0
    onehot = (idx == choice) & assigned
    fonehot = onehot.to(torch.float32)
    nodes["cpu_fit"] += fonehot * pod["cpu"]
    nodes["mem_fit"] += fonehot * pod["mem"]
    nodes["cpu_used"] += fonehot * pod["cpu"]
    nodes["mem_used"] += fonehot * pod["mem"]
    nodes["pods_used"] += fonehot
    mask = onehot[:, None]
    nodes["uport"] |= torch.where(mask, pod["port"][None, :], 0)
    nodes["uvol_any"] |= torch.where(mask, pod["vol_any"][None, :], 0)
    nodes["uvol_rw"] |= torch.where(mask, pod["vol_rw"][None, :], 0)
    # As an existing pod the placement counts toward EVERY service whose
    # selector matches it: a K-element scatter-add into row `choice`,
    # once per occurrence of an id.
    ids = pod["svc_ids"]
    valid = ((ids >= 0) & assigned).to(torch.float32)
    rows = choice.clamp(min=0).to(torch.int64).expand(ids.shape[0])
    nodes["svc_counts"].index_put_(
        (rows, ids.clamp(min=0).to(torch.int64)), valid, accumulate=True
    )


def _scan_solve(pods: Tensors, nodes: Tensors, weights) -> torch.Tensor:
    """The sequential scan, one pod per iteration: i32[P] node indices
    (-1 = unschedulable). `nodes` is updated in place. No step reads a
    value back to the host, so on a card the loop only enqueues work."""
    N = nodes["cpu_cap"].shape[0]
    P = pods["cpu"].shape[0]
    idx = torch.arange(N, dtype=torch.int32, device=nodes["cpu_cap"].device)
    choices = torch.empty(P, dtype=torch.int32, device=idx.device)
    for i in range(P):
        pod = {k: v[i] for k, v in pods.items()}
        feas = _feasible(pod, nodes, idx)
        masked = torch.where(feas, _scores(pod, nodes, weights), -1)
        # argmax returns the first maximal index: the lowest-index
        # tie-break. Infeasible nodes carry -1, so "any feasible" is
        # "max >= 0".
        best = torch.argmax(masked).to(torch.int32)
        choice = torch.where(masked.max() >= 0, best, -1)
        _commit(nodes, pod, choice, idx)
        choices[i] = choice
    return choices


def solve_with_state(
    pods: Tensors,
    nodes: Tensors,
    weights: Tuple[int, int, int] = DEFAULT_WEIGHTS,
    lspec: LoweredSpec = DEFAULT_LOWERED,
) -> Tuple[torch.Tensor, Tensors]:
    """Sequential-parity assignment plus the post-commit occupancy carry.

    Where the JAX package donates `nodes`, this updates the carry
    tensors of `nodes` in place and returns that same dict: the caller's
    tensors hold the new state afterwards. CUDA tensors run the CUDA
    scan kernel, CPU tensors the plain per-pod loop; both make the same
    decisions bit for bit."""
    _require_default(lspec)
    return scan_kernel.scan_with_state(pods, nodes, weights)


def solve(
    pods: Tensors,
    nodes: Tensors,
    weights: Tuple[int, int, int] = DEFAULT_WEIGHTS,
    lspec: LoweredSpec = DEFAULT_LOWERED,
) -> torch.Tensor:
    """i32[P] node indices (-1 = unschedulable); `nodes` is left as it
    was (the solve runs on a copy of the carry)."""
    scratch = dict(nodes)
    for k in CARRY_KEYS:
        scratch[k] = nodes[k].clone()
    choice, _ = solve_with_state(pods, scratch, weights, lspec)
    return choice


def solve_assignments(
    dsnap: DeviceSnapshot, weights: Optional[Tuple[int, int, int]] = None
) -> np.ndarray:
    """Run the solver and strip padding: i32[n_pods] of real node
    indices (-1 unschedulable)."""
    if weights is None:
        weights = dsnap.weights
    out = solve(dsnap.pods, dsnap.nodes, weights, dsnap.lowered).cpu().numpy()
    out = out[: dsnap.n_pods]
    # Padding nodes are never schedulable; clamp so no phantom index
    # can leak.
    return np.where(out >= dsnap.n_nodes, -1, out)
