"""Wave-commit solver: many pods per device step.

The counterpart of `kubernetes_tpu/ops/wave.py`. The sequential-parity
scan (`ops/solver.py`) decides one pod at a time; this solver trades
exact decision-order parity for batches of pods:

  each wave:
    1. feasibility and scores for a WINDOW of undecided pods against the
       current cluster state, one batched W x N evaluation by the same
       predicate and priority helpers the scan decides with;
    2. every pod picks its argmax node, ties broken by a pod x node hash
       (the reference randomizes ties too, generic_scheduler.go:90-102);
    3. pods that picked the same node are packed in FIFO order: a
       segmented prefix sum over the (node, pod)-sorted window accepts
       the prefix that fits (CPU, memory, pod count), at most
       `per_node_limit` a node, and at most one pod carrying hostPort or
       volume bits a node;
    4. accepted pods commit in bulk (scatter-adds into the carry); pods
       infeasible on every node are final (-1), since occupancy only
       grows; conflict losers retry in the next wave.

Every wave finalizes at least one pod, so the loop ends. The loop runs
on the host, one wave a pass; its one read from the device a wave is
whether any pod is still undecided. Within a wave nothing waits for the
device: the window is compacted by a cumulative sum (not
`torch.nonzero`), and the scatters JAX writes with mode="drop" go into
buffers one row longer, whose extra row is never read.

Placements equal the JAX package's bit for bit: scores are int32, the
tie hash is integer arithmetic, and every f32 sum adds integer values
below 2^24, so no order of the adds changes a bit. Decisions differ
from the scan's by design (the scan stays the parity path); placements
stay valid.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.ops.matrices import CARRY_KEYS, DeviceSnapshot
from kubernetes_tpu_torch.ops.solver import DEFAULT_WEIGHTS, _feasible, _scores
from kubernetes_tpu_torch.utils import flightrecorder
from kubernetes_tpu_torch.utils.tracing import phase

Tensors = Dict[str, torch.Tensor]

UNDECIDED = -2  # assignment sentinel: not yet finalized
FMAX = 3.4e38  # the f32 "no limit" of the packer (JAX's jnp.float32(3.4e38))


def strip_assignments(dsnap: DeviceSnapshot, out: torch.Tensor) -> np.ndarray:
    """Slice off padding pods and fold padded-node indices to -1: the
    convention of every windowed solver's wrapper."""
    a = out.cpu().numpy()[: dsnap.n_pods]
    return np.where(a >= dsnap.n_nodes, -1, a)


def wave_assignments(dsnap: DeviceSnapshot, **kw):
    """Run the wave solver on a staged snapshot and strip padding:
    (i32[n_pods] with -1 = unschedulable, wave count). The strip reads
    the result back, so the "solve" phase holds the device time; its
    span carries the wave count."""
    with phase("solve", solver="wave") as sp:
        out, waves = solve_waves(dsnap.pods, dsnap.nodes, **kw)
        stripped = strip_assignments(dsnap, out)
        waves = int(waves)
        sp.note(waves=waves)
    flightrecorder.observe_solve_telemetry("wave", waves)
    return stripped, waves


def _window_rows(pods: Tensors, idx: torch.Tensor) -> Tensors:
    """The window's pod rows (idx may hold P, the padding fill)."""
    safe = idx.clamp(max=pods["cpu"].shape[0] - 1).to(torch.int64)
    return {k: v[safe] for k, v in pods.items()}


def _first_undecided(undecided: torch.Tensor, W: int) -> torch.Tensor:
    """int32[W]: the indices of the first W undecided pods in order,
    filled with P (JAX's nonzero(size=W, fill_value=P)), by a cumulative
    sum and a scatter into W + 1 slots whose last one is dropped."""
    P = undecided.shape[0]
    pos = torch.cumsum(undecided, 0) - 1
    slot = torch.where(undecided & (pos < W), pos, W)
    buf = torch.full((W + 1,), P, dtype=torch.int64, device=undecided.device)
    buf.scatter_(0, slot, torch.arange(P, device=undecided.device))
    return buf[:W].to(torch.int32)


def _batched_eval(wpods: Tensors, nodes: Tensors, weights) -> Tuple[torch.Tensor, torch.Tensor]:
    """(feasible bool[W, N], score int32[W, N]) under the default spec:
    the scan's predicate and priority helpers with the pods' scalar
    columns as (W, 1) against the node axis."""
    N = nodes["cpu_cap"].shape[0]
    idx = torch.arange(N, dtype=torch.int32, device=nodes["cpu_cap"].device)
    batch = {k: v[:, None] if v.dim() == 1 else v for k, v in wpods.items()}
    return _feasible(batch, nodes, idx), _scores(batch, nodes, weights)


def _has_bits(wpods: Tensors) -> torch.Tensor:
    """bool[W]: the pod carries hostPort or volume bits."""
    return (
        (wpods["port"] != 0).any(dim=1)
        | (wpods["vol_any"] != 0).any(dim=1)
        | (wpods["vol_rw"] != 0).any(dim=1)
    )


def _pack_window(
    choice: torch.Tensor,  # int32[W] chosen node (-1 = none)
    wcpu: torch.Tensor,
    wmem: torch.Tensor,
    wzero: torch.Tensor,  # bool[W] zero-request pod (count-only fit)
    has_bits: torch.Tensor,  # bool[W] pod carries port/volume bits
    nodes: Tensors,
    N: int,
    W: int,
    per_node_limit: int = 1,
) -> torch.Tensor:
    """bool[W]: which window pods commit this wave (capacity-aware FIFO
    packing per node)."""
    device = choice.device
    pos = torch.arange(W, dtype=torch.int64, device=device)
    contending = choice >= 0
    # Sort by (node, window position); pods that chose nothing group
    # last under the sentinel node N. The keys are unique.
    key = torch.where(contending, choice.to(torch.int64), N) * W + pos
    perm = torch.argsort(key)
    s_choice = choice[perm]
    s_cpu = wcpu[perm]
    s_mem = wmem[perm]
    s_zero = wzero[perm]
    s_bits = has_bits[perm].to(torch.float32)
    s_contending = contending[perm]

    start = torch.ones(W, dtype=torch.bool, device=device)
    start[1:] = s_choice[1:] != s_choice[:-1]

    def seg_prefix_before(x):
        """Per element, the sum of the earlier elements of its segment."""
        cs = torch.cumsum(x, 0)
        seg_base = torch.where(start, cs - x, -FMAX)
        base = torch.cummax(seg_base, 0).values  # cs never falls (x >= 0)
        return cs - x - base

    cpu_before = seg_prefix_before(s_cpu)
    mem_before = seg_prefix_before(s_mem)
    rank = seg_prefix_before(torch.ones(W, dtype=torch.float32, device=device))
    bits_before = seg_prefix_before(s_bits)

    node = s_choice.clamp(min=0).to(torch.int64)
    cap_cpu = nodes["cpu_cap"][node]
    cap_mem = nodes["mem_cap"][node]
    rem_cpu = torch.where(cap_cpu > 0, cap_cpu - nodes["cpu_fit"][node], FMAX)
    rem_mem = torch.where(cap_mem > 0, cap_mem - nodes["mem_fit"][node], FMAX)
    rem_count = nodes["pods_cap"][node] - nodes["pods_used"][node]

    # Zero-request pods fit by pod count alone (predicates.go:146).
    resources_ok = s_zero | (
        (cpu_before + s_cpu <= rem_cpu) & (mem_before + s_mem <= rem_mem)
    )
    ok = (
        s_contending
        & resources_ok
        & (rank + 1 <= rem_count)
        # At most per_node_limit acceptances a node a wave, so a wave
        # stays close to one round of the sequential cascade.
        & (rank < per_node_limit)
        # Port/volume carriers: only a node's first carrier commits this
        # wave, so no conflict can arise within a wave.
        & ((s_bits == 0) | (bits_before == 0))
    )
    accepted = torch.zeros(W, dtype=torch.bool, device=device)
    accepted[perm] = ok
    return accepted


def _commit_wave(nodes: Tensors, wpods: Tensors, choice: torch.Tensor, accepted: torch.Tensor) -> None:
    """Bulk commit of every accepted (pod -> node) pair into the carry
    tensors of `nodes`, in place."""
    N = nodes["cpu_cap"].shape[0]
    j = torch.where(accepted, choice, 0).to(torch.int64)
    f = accepted.to(torch.float32)
    nodes["cpu_fit"].index_add_(0, j, f * wpods["cpu"])
    nodes["mem_fit"].index_add_(0, j, f * wpods["mem"])
    nodes["cpu_used"].index_add_(0, j, f * wpods["cpu"])
    nodes["mem_used"].index_add_(0, j, f * wpods["mem"])
    nodes["pods_used"].index_add_(0, j, f)
    # Bit rows: at most one accepted carrier a node a wave (the packer's
    # guarantee), so a gather, OR and scatter over its row is exact.
    # Non-carriers write row N of a buffer one row longer, which is
    # dropped: sharing a real row would let their no-op writes clobber
    # a carrier's update to it.
    carrier = accepted & _has_bits(wpods)
    crow = torch.where(carrier, choice, N).to(torch.int64)
    grow = crow.clamp(max=N - 1)
    for field, pkey in (("uport", "port"), ("uvol_any", "vol_any"), ("uvol_rw", "vol_rw")):
        rows = nodes[field]
        gathered = rows[grow] | torch.where(carrier[:, None], wpods[pkey], 0)
        buf = torch.cat([rows, rows[:1]])
        buf[crow] = gathered
        rows.copy_(buf[:N])
    # Service membership counts (repeated ids accumulate), as one
    # index_add_ over the flat (N * S) counts: atomic adds of 0 and 1,
    # exact in any order, where an accumulating index_put_ sorts its
    # indices first.
    ids = wpods["svc_ids"]
    valid = (ids >= 0) & accepted[:, None]
    counts = nodes["svc_counts"]
    flat = j[:, None] * counts.shape[1] + ids.clamp(min=0).to(torch.int64)
    counts.view(-1).index_add_(0, flat.reshape(-1), valid.to(torch.float32).reshape(-1))


def _tie_hash(idx: torch.Tensor, N: int) -> torch.Tensor:
    """int32[W, N] in [0, 2^16): JAX's u32 pod x node hash
    ((idx * 2654435761) ^ (node * 40503)) & 0xFFFF. Only the low 16 bits
    survive, and the low bits of a product or XOR depend only on the
    operands' low bits, so each factor is reduced first, in int64."""
    a = (idx.to(torch.int64) * 2654435761) & 0xFFFF
    b = (torch.arange(N, dtype=torch.int64, device=idx.device) * 40503) & 0xFFFF
    return (a[:, None] ^ b[None, :]).to(torch.int32)


def _argmax_choose(masked, idx, valid, carry, N):
    """Plain wave choice: each pod's argmax with the hashed tie-break in
    the low 16 bits (masked << 16 | hash, written as a product: scores
    are small, so it is exact). torch.argmax takes the first maximal
    index, as jnp.argmax. The zero telemetry fits the choose contract
    (Sinkhorn's priced choice reports real ones)."""
    combined = masked * 65536 + _tie_hash(idx, N)
    choice = torch.argmax(combined, dim=1).to(torch.int32)
    zero_i = torch.zeros((), dtype=torch.int32, device=masked.device)
    zero_f = torch.zeros((), dtype=torch.float32, device=masked.device)
    return choice, zero_i, zero_f


def run_windowed(
    pods: Tensors,
    nodes: Tensors,
    weights: Tuple[int, int, int],
    window: int,
    per_node_limit: int,
    choose,
) -> Tuple[torch.Tensor, int, torch.Tensor, torch.Tensor]:
    """The shared windowed-commit loop. Commits into the carry tensors
    of `nodes` in place and returns (assignment int32[P] with -1 =
    unschedulable, wave count, total choose iterations, the last wave's
    residual); the last two are device scalars. `choose(masked, idx,
    valid, carry, N) -> (int32[W], int32, f32)` picks each window pod's
    candidate node and reports its telemetry; windowing, packing, the
    bulk commit and finalization are common to the wave family."""
    P = pods["cpu"].shape[0]
    N = nodes["cpu_cap"].shape[0]
    W = min(window, P)
    device = pods["cpu"].device
    # One slot more than pods: the window's padding fill (P) writes it.
    assignment = torch.full((P + 1,), UNDECIDED, dtype=torch.int32, device=device)
    # Padding pods (pinned -2) can never place: final now.
    assignment[:P] = torch.where(pods["pinned"] == -2, -1, assignment[:P])
    titers = torch.zeros((), dtype=torch.int32, device=device)
    residual = torch.zeros((), dtype=torch.float32, device=device)
    waves = 0
    while waves < P:
        undecided = assignment[:P] == UNDECIDED
        if not bool(undecided.any()):  # the wave loop's one read from the device
            break
        idx = _first_undecided(undecided, W)
        valid = idx < P
        wpods = _window_rows(pods, idx)
        feas, score = _batched_eval(wpods, nodes, weights)
        masked = torch.where(feas, score, -1)
        del feas, score
        best, c_iters, c_residual = choose(masked, idx, valid, nodes, N)
        feasible = masked.gather(1, best[:, None].to(torch.int64))[:, 0] >= 0
        del masked
        choice = torch.where(valid & feasible, best, -1)
        accepted = _pack_window(
            choice, wpods["cpu"], wpods["mem"], wpods["zero_req"], _has_bits(wpods),
            nodes, N, W, per_node_limit,
        )
        _commit_wave(nodes, wpods, choice, accepted)
        # Accepted pods get their node; pods with no feasible node are
        # final (occupancy only grows); conflict losers stay undecided.
        newly_unschedulable = valid & ~feasible
        value = torch.where(
            accepted, choice, torch.where(newly_unschedulable, -1, UNDECIDED).to(torch.int32)
        )
        assignment[idx.to(torch.int64)] = value
        titers = titers + c_iters
        residual = c_residual
        waves += 1
    # Never leak the sentinel (the wave cap P cannot be reached: every
    # wave finalizes its first undecided pod).
    out = assignment[:P]
    return torch.where(out == UNDECIDED, -1, out), waves, titers, residual


def _scratch_carry(nodes: Tensors) -> Tensors:
    """`nodes` with its carry tensors cloned, for a solve that leaves the
    caller's state as it was."""
    scratch = dict(nodes)
    for k in CARRY_KEYS:
        scratch[k] = nodes[k].clone()
    return scratch


def solve_waves(
    pods: Tensors,
    nodes: Tensors,
    weights: Tuple[int, int, int] = DEFAULT_WEIGHTS,
    window: int = 4096,
    per_node_limit: int = 1,
) -> Tuple[torch.Tensor, int]:
    """(assignment int32[P] with -1 = unschedulable, wave count); `nodes`
    is left as it was."""
    assignment, waves, _, _ = run_windowed(
        pods, _scratch_carry(nodes), weights, window, per_node_limit, _argmax_choose
    )
    return assignment, waves


def solve_waves_with_state(
    pods: Tensors,
    nodes: Tensors,
    weights: Tuple[int, int, int] = DEFAULT_WEIGHTS,
    window: int = 4096,
    per_node_limit: int = 1,
) -> Tuple[torch.Tensor, Tensors, int]:
    """Like solve_waves, and the post-commit carry: where the JAX package
    donates `nodes`, this updates its carry tensors in place and returns
    the same dict (the incremental session's contract, as
    `solver.solve_with_state`)."""
    assignment, waves, _, _ = run_windowed(
        pods, nodes, weights, window, per_node_limit, _argmax_choose
    )
    return assignment, nodes, waves
