"""Sinkhorn-matched wave solver: entropic assignment with congestion
prices.

The counterpart of `kubernetes_tpu/ops/sinkhorn.py`. The plain wave
solver (`ops/wave.py`) lets every pod pick its argmax node on its own,
so popular nodes draw many winners that the packer rejects. Here each
wave first runs a few log-domain Sinkhorn iterations over the masked
score matrix, T = diag(u) . exp(S / eps) . diag(v), with row marginals
1 (each pod places once) and column scalings capped at each node's
remaining pod-count capacity: a column that would receive more mass
than it holds gets its price lowered (g_j < 0), an under-subscribed one
is never boosted. Pods then take the argmax of the priced scores
S_ij + g_j, with g clamped to [-price_cap, 0], which bounds how far a
price may move a pod off its greedy best. Feasibility stays exact: the
prices only reorder feasible choices, and the packer and bulk commit
are the wave solver's (`wave.run_windowed`).

The price loop is JAX's `while (i < iters) & (res > tol)` with `res`
starting at infinity. Here it is a fixed loop of `iters` passes with a
device-side flag that stops `g`, the count and the residual where JAX's
loop stops, so the iteration count is JAX's exactly and no pass waits
for the device. `torch.logsumexp` and `jax.nn.logsumexp` may round
differently in the last place, so the prices agree with the JAX
package's within a tolerance, not bit for bit, and a near tie of the
priced argmax may go the other way; placements stay valid.

On a mesh (`ops/wave.py` says how the window is sharded) each shard
keeps the prices of its nodes. A row's log-sum-exp over the node axis
combines the shards' own (a log-sum-exp over the shards, on the mesh's
first device), the residual's max over columns reduces across shards,
and each column's mass stays local. Those sums run in another order
than the unsharded row's, so a price may move in its last bits: the
sharded solve is held to the same bound against the JAX package.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import torch

from kubernetes_tpu_torch.ops.matrices import DeviceSnapshot, ShardedNodes
from kubernetes_tpu_torch.ops.solver import DEFAULT_WEIGHTS
from kubernetes_tpu_torch.ops.wave import (
    Tensors, _scratch_carry, _tie_hash, run_windowed, shard_argmax, strip_assignments)
from kubernetes_tpu_torch.utils import flightrecorder
from kubernetes_tpu_torch.utils.tracing import phase

_NEG = -1e30


def _congestion_prices(
    masked: torch.Tensor,  # f32[W, N]: weighted score, -1 where infeasible
    valid: torch.Tensor,  # bool[W]: a real (non-padding) undecided pod
    capacity: torch.Tensor,  # f32[N]: remaining pod-count capacity
    eps: float,
    iters: int,
    tol: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Capped Sinkhorn with its telemetry: (g f32[N], iterations run
    int32, residual f32). The residual is the worst column's log-domain
    mass excess over its capacity entering the last executed update (0:
    demand already fits); `tol` stops the updates once it is at or below
    it (0.0: the fixed-iteration prices)."""
    logits = torch.where(masked >= 0, masked / eps, _NEG)
    # Pods with no feasible node ship no mass (they finalize -1 anyway).
    ships = valid & (masked >= 0).any(dim=1)
    log_a = torch.where(ships, 0.0, _NEG)
    log_b = torch.where(capacity > 0, torch.log(capacity.clamp(min=1e-9)), _NEG)
    g = torch.zeros_like(capacity)
    i = torch.zeros((), dtype=torch.int32, device=masked.device)
    res = torch.full((), float("inf"), dtype=torch.float32, device=masked.device)
    for _ in range(iters):
        running = res > tol
        # g lives in the score domain, so inside the softmax it scales by
        # 1 / eps like the scores.
        row = logits + g[None, :] / eps
        row_lse = torch.logsumexp(row, dim=1, keepdim=True)
        log_t = log_a[:, None] + row - row_lse.clamp(min=_NEG)
        del row, row_lse
        col_mass = torch.logsumexp(log_t, dim=0)
        del log_t
        excess = torch.where(capacity > 0, (col_mass - log_b).clamp(min=0.0), 0.0)
        # Overloaded columns get cheaper; empty ones are never boosted.
        g = torch.where(running, g + (log_b - col_mass).clamp(max=0.0) * eps, g)
        i = i + running.to(torch.int32)
        res = torch.where(running, excess.max(), res)
    # A window that never iterated (iters == 0) reports residual 0.
    return g, i, torch.where(torch.isinf(res), 0.0, res)


def _congestion_prices_sharded(
    masked: List[torch.Tensor],  # f32[W, n_s] a shard
    valid: torch.Tensor,  # bool[W] on the mesh's first device
    capacity: List[torch.Tensor],  # f32[n_s] a shard
    nodes: ShardedNodes,
    eps: float,
    iters: int,
    tol: float = 0.0,
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """`_congestion_prices` over a mesh: (g f32[n_s] a shard, iterations
    run, residual), the last two on the first device. A row's
    log-sum-exp is the log-sum-exp of the shards' own; the residual's
    max reduces across shards; column masses stay on their shard."""
    first = nodes.mesh.first
    devices = nodes.mesh.devices
    logits = [torch.where(m >= 0, m / eps, _NEG) for m in masked]
    any_feasible = torch.stack([(m >= 0).any(dim=1).to(first) for m in masked]).any(dim=0)
    ships = valid & any_feasible
    log_a = [torch.where(ships, 0.0, _NEG).to(dev) for dev in devices]
    log_b = [torch.where(c > 0, torch.log(c.clamp(min=1e-9)), _NEG) for c in capacity]
    g = [torch.zeros_like(c) for c in capacity]
    i = torch.zeros((), dtype=torch.int32, device=first)
    res = torch.full((), float("inf"), dtype=torch.float32, device=first)
    for _ in range(iters):
        running = res > tol
        rows = [lg + gs[None, :] / eps for lg, gs in zip(logits, g)]
        lse = torch.logsumexp(
            torch.stack([torch.logsumexp(r, dim=1).to(first) for r in rows]), dim=0)
        excess = []
        for s, dev in enumerate(devices):
            log_t = log_a[s][:, None] + rows[s] - lse.to(dev).clamp(min=_NEG)[:, None]
            col_mass = torch.logsumexp(log_t, dim=0)
            excess.append(torch.where(capacity[s] > 0, (col_mass - log_b[s]).clamp(min=0.0),
                                      0.0).max().to(first))
            g[s] = torch.where(running.to(dev), g[s] + (log_b[s] - col_mass).clamp(max=0.0) * eps,
                               g[s])
        del rows
        i = i + running.to(torch.int32)
        res = torch.where(running, torch.stack(excess).max(), res)
    return g, i, torch.where(torch.isinf(res), 0.0, res)


def _priced_choose(masked, idx, valid, carry, N, *, eps, iters, price_cap, tol=0.0):
    """Sinkhorn-priced choice: the argmax of S_ij + g_j with a small
    deterministic jitter (the wave's tie hash times 1e-6) as tie-break.
    Returns (choice, iterations run, residual). On a mesh `masked` is
    the shards' list and `carry` the `ShardedNodes`."""
    if isinstance(carry, ShardedNodes):
        remaining = [(sh["pods_cap"] - sh["pods_used"]).clamp(min=0.0) for sh in carry.shards]
        fmasked = [m.to(torch.float32) for m in masked]
        g, iters_run, residual = _congestion_prices_sharded(
            fmasked, valid, remaining, carry, eps, iters, tol)
        priced = [
            torch.where(m >= 0, fm + gs.clamp(min=-float(price_cap))[None, :], float("-inf"))
            + _tie_hash(idx.to(m.device), m.shape[1], lo).to(torch.float32) * 1e-6
            for m, fm, gs, (lo, _) in zip(masked, fmasked, g, carry.ranges)
        ]
        return shard_argmax(priced, carry), iters_run, residual
    remaining = (carry["pods_cap"] - carry["pods_used"]).clamp(min=0.0)
    fmasked = masked.to(torch.float32)
    g, iters_run, residual = _congestion_prices(fmasked, valid, remaining, eps, iters, tol)
    g = g.clamp(min=-float(price_cap))
    priced = torch.where(masked >= 0, fmasked + g[None, :], float("-inf"))
    jitter = _tie_hash(idx, N).to(torch.float32) * 1e-6
    choice = torch.argmax(priced + jitter, dim=1).to(torch.int32)
    return choice, iters_run, residual


def _choose(eps, iters, price_cap, tol):
    return functools.partial(_priced_choose, eps=eps, iters=iters, price_cap=price_cap, tol=tol)


def sinkhorn_assignments(dsnap: DeviceSnapshot, **kw):
    """Run the Sinkhorn wave solver on a staged snapshot and strip
    padding: (i32[n_pods] with -1 = unschedulable, wave count). The
    convergence telemetry (total price iterations and the last residual)
    goes to `scheduler_solve_iterations` / `scheduler_sinkhorn_residual`
    and onto the solve span."""
    with phase("solve", solver="sinkhorn") as sp:
        out, waves, titers, residual = solve_sinkhorn_stats(dsnap.pods, dsnap.nodes, **kw)
        stripped = strip_assignments(dsnap, out)
        waves = int(waves)
        titers = int(titers)
        residual = float(residual)
        sp.note(waves=waves, sinkhorn_iters=titers, sinkhorn_residual=round(residual, 4))
    flightrecorder.observe_solve_telemetry("sinkhorn", titers, residual=residual, waves=waves)
    return stripped, waves


def solve_sinkhorn_stats(
    pods: Tensors,
    nodes: Tensors,
    weights: Tuple[int, int, int] = DEFAULT_WEIGHTS,
    window: int = 4096,
    per_node_limit: int = 2,
    eps: float = 2.0,
    iters: int = 8,
    price_cap: float = 4.0,
    tol: float = 0.0,
) -> Tuple[torch.Tensor, int, torch.Tensor, torch.Tensor]:
    """(assignment int32[P] with -1 = unschedulable, wave count, total
    price iterations, the last wave's residual); `nodes` is left as it
    was. The packer's per-node limit is looser than the plain wave's:
    the prices already meter demand to capacity."""
    assignment, waves, titers, residual = run_windowed(
        pods, _scratch_carry(nodes), weights, window, per_node_limit,
        _choose(eps, iters, price_cap, tol),
    )
    return assignment, waves, titers, residual


def solve_sinkhorn(pods: Tensors, nodes: Tensors, **kw) -> Tuple[torch.Tensor, int]:
    """(assignment, wave count): solve_sinkhorn_stats without the
    telemetry."""
    assignment, waves, _, _ = solve_sinkhorn_stats(pods, nodes, **kw)
    return assignment, waves


def solve_sinkhorn_with_state(
    pods: Tensors,
    nodes: Tensors,
    weights: Tuple[int, int, int] = DEFAULT_WEIGHTS,
    window: int = 4096,
    per_node_limit: int = 2,
    eps: float = 2.0,
    iters: int = 8,
    price_cap: float = 4.0,
    tol: float = 0.0,
) -> Tuple[torch.Tensor, Tensors, int, torch.Tensor, torch.Tensor]:
    """Like solve_sinkhorn_stats, committing into the carry tensors of
    `nodes` in place: (assignment, nodes, waves, total iterations, final
    residual)."""
    assignment, waves, titers, residual = run_windowed(
        pods, nodes, weights, window, per_node_limit, _choose(eps, iters, price_cap, tol)
    )
    return assignment, nodes, waves, titers, residual
