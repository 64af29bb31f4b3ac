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

A policy spec (`models/algspec.LoweredSpec`) gates each base predicate
and adds the configurable vocabulary:

    node_label        CheckNodeLabelPresence     predicates.go:226-240
    service_affinity  CheckServiceAffinity       predicates.go:268-335
    static_prio       CalculateNodeLabelPriority priorities.go:113-138
    aa_weights        ServiceAntiAffinity        spreading.go:105-169

Score ties go to the lowest node index.

`_scan_solve` is that loop written plainly in PyTorch, one pod per
iteration. It is the plain version of both CUDA kernels, which run the
same steps in one launch: the scan kernel (`ops/scan_kernel.py`) for
the default spec, the policy scan kernel (`ops/policy_scan.py`) for
every other one. `solve_with_state` sends CUDA tensors to the kernel and
CPU tensors to the plain loop.

The predicate and score helpers broadcast: a pod's scalar columns
shaped () give one row over the N nodes, shaped (P, 1) (its bitsets
(P, W)) a (P, N) matrix. `explain_rows` reads the same helpers over a
batch of pods, so a decision and its explanation never drift.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.models.algspec import DEFAULT_LOWERED, LoweredSpec
from kubernetes_tpu_torch.ops import policy_scan, scan_kernel, shard_scan
from kubernetes_tpu_torch.ops.matrices import (
    CARRY_KEYS, POLICY_CARRY_KEYS, DeviceSnapshot, ShardedNodes)
from kubernetes_tpu_torch.utils import sli

Tensors = Dict[str, torch.Tensor]

# Weighted-sum weights for the default provider (defaults.go:51-60):
# LeastRequested=1, BalancedResourceAllocation=1, ServiceSpreading=1.
DEFAULT_WEIGHTS = (1, 1, 1)


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
    sel = pod["sel"].unsqueeze(-2)
    return ((sel & nodes["labels"]) == sel).all(dim=-1)


def _pred_ports(pod: Tensors, nodes: Tensors) -> torch.Tensor:
    """PodFitsPorts."""
    return ~((pod["port"].unsqueeze(-2) & nodes["uport"]) != 0).any(dim=-1)


def _pred_disk(pod: Tensors, nodes: Tensors) -> torch.Tensor:
    """NoDiskConflict: conflict when either side holds it read-write."""
    clash = (pod["vol_rw"].unsqueeze(-2) & nodes["uvol_any"]) | (
        pod["vol_any"].unsqueeze(-2) & nodes["uvol_rw"]
    )
    return ~(clash != 0).any(dim=-1)


def _pred_hostname(pod: Tensors, idx: torch.Tensor) -> torch.Tensor:
    """HostName."""
    return (pod["pinned"] == -1) | (idx == pod["pinned"])


def _service_slot(svc: torch.Tensor, per_service: torch.Tensor) -> torch.Tensor:
    """The pod's entry of a per-service carry (anchor, svc_total): its
    first service's, or the scratch slot (the last) when it has none."""
    scratch = per_service.shape[0] - 1
    return per_service[torch.where(svc >= 0, svc, scratch).to(torch.int64)]


def _feasible(
    pod: Tensors, nodes: Tensors, idx: torch.Tensor, ls: LoweredSpec = DEFAULT_LOWERED
) -> torch.Tensor:
    """The configured predicates as one bool[N] mask, each term gated by
    the LoweredSpec."""
    ok = nodes["sched"]
    if ls.resources:
        ok = ok & _pred_resources(pod, nodes)
    if ls.selector:
        ok = ok & _pred_selector(pod, nodes)
    if ls.ports:
        ok = ok & _pred_ports(pod, nodes)
    if ls.disk:
        ok = ok & _pred_disk(pod, nodes)
    if ls.hostname:
        ok = ok & _pred_hostname(pod, idx)
    if ls.node_label:
        # CheckNodeLabelPresence: a static node mask.
        ok = ok & nodes["policy_ok"]
    if ls.service_affinity:
        # CheckServiceAffinity: per affinity label k the pod needs
        # "l_k = v", v its own pinned nodeSelector value, else the value
        # on the node of its service's first peer (the anchor); nothing
        # when neither exists. A peer on an unknown node (anchor -2) is
        # the reference's GetNodeInfo error: the pod fits nowhere.
        pin = pod["aff_pin"]
        svc = pod["svc"]
        anchor = _service_slot(svc, nodes["anchor"])
        peers = _service_slot(svc, nodes["svc_total"]) > 0
        consults = (pin < 0).any() & (svc >= 0) & peers
        anchor_err = consults & (anchor == -2)
        anchor_ok = consults & (anchor >= 0)
        # JAX clamps a gather index into range.
        row = anchor.clamp(0, nodes["aff_vid"].shape[0] - 1).to(torch.int64)
        a_vid = torch.where(anchor_ok, nodes["aff_vid"][row], -1)
        need = torch.where(pin >= 0, pin, a_vid)
        ok = ok & ((need[None, :] < 0) | (nodes["aff_vid"] == need[None, :])).all(dim=1)
        ok = ok & ~anchor_err
    return ok


def _service_counts(svc: torch.Tensor, nodes: Tensors) -> torch.Tensor:
    """Each node's count of the pod's first service (column max(svc, 0)
    even without one) as int32: (N,) for one pod, (P, N) for a batch
    whose `svc` is (P, 1)."""
    col = svc.clamp(min=0).to(torch.int64)
    if col.dim():
        col = col[..., 0]
    # index_select, not indexing by the tensor: a 0-dim index tensor is
    # read back to the host, which waits for the device every pod.
    rows = nodes["svc_counts"].index_select(1, col.reshape(-1)).T.to(torch.int32)
    return rows.reshape(col.shape + rows.shape[1:])


def max_service_count(svc: torch.Tensor, nodes: Tensors) -> torch.Tensor:
    """ServiceSpreading's divisor: the max over these nodes of each
    node's count of the pod's first service, int32 () for one pod,
    (P, 1) for a batch. On a mesh each shard's is one candidate, and the
    solvers reduce them across shards before any score is taken."""
    return _service_counts(svc, nodes).max(dim=-1, keepdim=True).values


def _component_scores(
    pod: Tensors, nodes: Tensors, maxc: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three default priority columns (LeastRequested,
    BalancedResourceAllocation, ServiceSpreading) as int32[N] each.
    `maxc` is ServiceSpreading's max count over the whole node axis
    (default: over `nodes`, which is the whole axis unless sharded).

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
    counts = _service_counts(svc, nodes)
    if maxc is None:
        maxc = counts.max(dim=-1, keepdim=True).values
    spread_raw = _floordiv(10 * (maxc - counts), maxc.clamp(min=1))
    spread = torch.where((svc < 0) | (maxc == 0), 10, spread_raw)
    return lr, bra, spread


def _scores(
    pod: Tensors,
    nodes: Tensors,
    weights,
    ls: LoweredSpec = DEFAULT_LOWERED,
    feas: Optional[torch.Tensor] = None,
    maxc: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Weighted configured priorities as one int32[N] score vector
    (`maxc` as `_component_scores` takes it).

    `feas` is the pod's feasibility mask: the reference prioritizes over
    the filtered node list (generic_scheduler.go:80-86), which matters
    only for ServiceAntiAffinity, whose per-zone peer counts skip nodes
    filtered out (spreading.go:133-147)."""
    w_lr, w_bra, w_spread = weights
    total = torch.zeros(nodes["cpu_cap"].shape[0], dtype=torch.int32, device=nodes["cpu_cap"].device)
    if w_lr or w_bra or w_spread:
        lr, bra, spread = _component_scores(pod, nodes, maxc)
    if w_lr:
        total = total + lr * w_lr
    if w_bra:
        total = total + bra * w_bra
    if w_spread:
        total = total + spread * w_spread
    if ls.static_prio:
        # CalculateNodeLabelPriority: pod-independent, the weights folded
        # into the column when it was lowered.
        total = total + nodes["static_prio"]
    if ls.aa_weights:
        # ServiceAntiAffinity: spread the pod's first service over the
        # values ("zones") of one node label. The peer count ignores
        # node presence (svc_total); a zone's count sums its feasible
        # nodes' counts.
        svc = pod["svc"]
        counts = _service_counts(svc, nodes)
        num = torch.where(svc >= 0, _service_slot(svc, nodes["svc_total"]), 0.0).to(torch.int32)
        for i, (w, nz) in enumerate(zip(ls.aa_weights, ls.aa_zones)):
            zone = nodes["aa_zone"][:, i]
            in_zone = zone >= 0
            if feas is not None:
                in_zone = in_zone & feas
            # JAX's scatter drops a zone past the vocabulary; its gather
            # clamps one.
            z = zone.clamp(min=0).to(torch.int64)
            add = torch.where(in_zone & (z < nz), counts, 0)
            zc = torch.zeros(nz, dtype=torch.int32, device=zone.device)
            zc.index_add_(0, z.clamp(max=nz - 1), add)
            count_z = zc[z.clamp(max=nz - 1)]
            score = torch.where(num > 0, _floordiv(10 * (num - count_z), num.clamp(min=1)), 10)
            score = torch.where(zone < 0, 0, score)
            total = total + score * w
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
    if "anchor" in nodes:
        _commit_services(nodes, ids, choice)


def _commit_services(nodes: Tensors, ids: torch.Tensor, choice: torch.Tensor) -> None:
    """The ServiceAffinity/AntiAffinity carry: the placed pod becomes a
    peer of each service it matches (svc_total += 1 once per id) and the
    anchor of each that had none (anchor -1 -> choice). Invalid ids, and
    every id of an unplaced pod, go to the scratch slot (the last),
    which no pod reads."""
    scratch = nodes["anchor"].shape[0] - 1
    slot = torch.where((ids >= 0) & (choice >= 0), ids, scratch).to(torch.int64)
    cur = nodes["anchor"][slot]
    nodes["svc_total"].index_put_((slot,), torch.ones_like(slot, dtype=torch.float32), accumulate=True)
    # A repeated id writes the same value twice: cur was read before.
    nodes["anchor"][slot] = torch.where(cur == -1, choice, cur)


def _scan_solve(pods: Tensors, nodes: Tensors, weights, ls: LoweredSpec = DEFAULT_LOWERED) -> torch.Tensor:
    """The sequential scan, one pod per iteration: i32[P] node indices
    (-1 = unschedulable). `nodes` is updated in place. Past the one read
    of which pods can be placed at all, no step reads a value back to
    the host, so on a card the loop only enqueues work."""
    N = nodes["cpu_cap"].shape[0]
    P = pods["cpu"].shape[0]
    idx = torch.arange(N, dtype=torch.int32, device=nodes["cpu_cap"].device)
    choices = torch.full((P,), -1, dtype=torch.int32, device=idx.device)
    none = torch.tensor(-1, dtype=torch.int32, device=idx.device)
    # Under HostName a pod pinned to -2 (padding, or a pin to an unknown
    # node) fits no node, so its choice stays -1 without a step. Its
    # commit changes only the scratch slot of the service carry, where
    # there is one. Without HostName the pin means nothing.
    placeable = ((pods["pinned"] != -2) | (not ls.hostname)).tolist()
    for i in range(P):
        if not placeable[i]:
            if "anchor" in nodes:
                _commit_services(nodes, pods["svc_ids"][i], none)
            continue
        pod = {k: v[i] for k, v in pods.items()}
        feas = _feasible(pod, nodes, idx, ls)
        masked = torch.where(feas, _scores(pod, nodes, weights, ls, feas), -1)
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
    tensors hold the new state afterwards. CUDA tensors run a CUDA
    kernel (the scan kernel for the default spec, the policy scan
    kernel for any other), CPU tensors the plain per-pod loop; both
    make the same decisions bit for bit. A `ShardedNodes` takes the
    sharded scan (`ops/shard_scan.py`, default spec only), with the
    same decisions and carry."""
    if isinstance(nodes, ShardedNodes):
        return shard_scan.sharded_scan_with_state(pods, nodes, weights, lspec)
    if lspec == DEFAULT_LOWERED:
        return scan_kernel.scan_with_state(pods, nodes, weights)
    return policy_scan.policy_scan_with_state(pods, nodes, weights, lspec)


def solve(
    pods: Tensors,
    nodes: Tensors,
    weights: Tuple[int, int, int] = DEFAULT_WEIGHTS,
    lspec: LoweredSpec = DEFAULT_LOWERED,
) -> torch.Tensor:
    """i32[P] node indices (-1 = unschedulable); `nodes` is left as it
    was (the solve runs on a copy of the carry)."""
    if isinstance(nodes, ShardedNodes):
        return solve_with_state(pods, nodes.with_carry_cloned(), weights, lspec)[0]
    scratch = dict(nodes)
    for k in CARRY_KEYS + POLICY_CARRY_KEYS:
        if k in nodes:
            scratch[k] = nodes[k].clone()
    choice, _ = solve_with_state(pods, scratch, weights, lspec)
    return choice


def _explain_row(pod: Tensors, nodes: Tensors, idx: torch.Tensor,
                 maxc: Optional[torch.Tensor] = None):
    """Pods' per-node verdicts against a FIXED occupancy state: packed
    predicate-failure bits (bit i set = matrices.EXPLAIN_PREDICATES[i]
    rejected the node) and the default priority components, from the
    same helpers the solver decides with."""
    preds = (
        nodes["sched"],
        _pred_resources(pod, nodes),
        _pred_selector(pod, nodes),
        _pred_ports(pod, nodes),
        _pred_disk(pod, nodes),
        _pred_hostname(pod, idx),
    )
    bits = torch.zeros(torch.broadcast_shapes(*(p.shape for p in preds)), dtype=torch.int32,
                       device=idx.device)
    for i, ok in enumerate(preds):
        bits = bits | ((~ok).to(torch.int32) << i)
    lr, bra, spread = _component_scores(pod, nodes, maxc)
    return bits, lr, bra, spread


def explain_rows(pods: Tensors, nodes: Tensors):
    """The explain readback: default-pipeline verdicts for a batch of
    pods, all at once as (P, N) tensors: (bits, lr, bra, spread), int32
    each (the bits are the JAX package's u32 words, `state_to_numpy`
    views them back). The occupancy state `nodes` is fixed (no
    commits); padding is the caller's to strip
    (`ops.pipeline.explain_matrix`). On a `ShardedNodes` each shard
    evaluates its columns with global node indices and the max counts
    reduced over every shard, and the columns come back whole on the
    mesh's first device."""
    # Scalar columns as (P, 1) against the node axis; bitsets stay (P, W).
    batch = {k: v[:, None] if v.dim() == 1 else v for k, v in pods.items()}
    if not isinstance(nodes, ShardedNodes):
        idx = torch.arange(nodes["cpu_cap"].shape[0], dtype=torch.int32,
                           device=nodes["cpu_cap"].device)
        return _explain_row(batch, nodes, idx)
    first = nodes.mesh.first
    batches = {dev: {k: v.to(dev) for k, v in batch.items()} for dev in set(nodes.mesh.devices)}
    maxc = sharded_max_service_count(batches, nodes)
    parts = []
    for dev, (lo, hi), shard in zip(nodes.mesh.devices, nodes.ranges, nodes.shards):
        idx = torch.arange(lo, hi, dtype=torch.int32, device=dev)
        parts.append(_explain_row(batches[dev], shard, idx, maxc.to(dev)))
    return tuple(torch.cat([p[i].to(first) for p in parts], dim=1) for i in range(4))


def sharded_max_service_count(pods_by_device, nodes: ShardedNodes) -> torch.Tensor:
    """`max_service_count` over every shard of a mesh, on the mesh's
    first device: each shard's max, gathered there and reduced.
    `pods_by_device` maps each device of the mesh to the pods there."""
    first = nodes.mesh.first
    part = [max_service_count(pods_by_device[dev]["svc"], shard).to(first)
            for dev, shard in zip(nodes.mesh.devices, nodes.shards)]
    return torch.stack(part).max(dim=0).values


def solve_assignments(
    dsnap: DeviceSnapshot, weights: Optional[Tuple[int, int, int]] = None
) -> np.ndarray:
    """Run the solver and strip padding: i32[n_pods] of real node
    indices (-1 unschedulable)."""
    if weights is None:
        weights = dsnap.weights
    out = solve(dsnap.pods, dsnap.nodes, weights, dsnap.lowered).cpu().numpy()
    sli.note_transfer("d2h", out.nbytes)
    out = out[: dsnap.n_pods]
    # Padding nodes are never schedulable; clamp so no phantom index
    # can leak.
    return np.where(out >= dsnap.n_nodes, -1, out)
