"""Sequential NumPy oracle: the reference's scheduleOne semantics replayed
pod at a time in exact host arithmetic (int64 / float64).

The port's own copy of what it needs from `kubernetes_tpu/ops/oracle.py`
(the port imports nothing of the JAX package): the sequential replay,
the quality score of an approximate solver's assignment against it
(`assignment_quality`: regret against the greedy best at each step of a
pod-order replay), and the validity replay of the wave family
(`validate_assignment_numpy`). `chip_smoke.py` holds the card's wave
and Sinkhorn placements to these; `tests/test_torch_wave.py` holds this
copy to the JAX package's.

Arithmetic: LeastRequested in int64 `//` (Go's int64 truncation,
priorities.go:31-40); BalancedResourceAllocation and ServiceSpreading
in float64, then truncated as the scalar path does (priorities.go:
146-205, spreading.go:38-87). It does not reproduce the device's f32
epsilon: the gap there is what a parity number measures.
"""

from __future__ import annotations

import numpy as np

from kubernetes_tpu_torch.models.columnar import Snapshot


def solve_sequential_numpy(snap: Snapshot) -> np.ndarray:
    """i32[P] node indices (-1 = unschedulable), in pod order."""
    out, _ = _replay(snap, forced=None)
    return out


def assignment_quality(snap: Snapshot, assignment: np.ndarray) -> dict:
    """Score an approximate solver's assignment against the greedy
    oracle. Replays the backlog in pod order committing
    each pod to its ASSIGNED node, and at each step measures the score
    gap to the oracle's best feasible node at that state:

      regret_i = max feasible score - score(assigned node)

    Returns mean/p99 regret (0 = every placement was greedy-optimal in
    order), the fraction of placements that were exactly greedy-best,
    and the fraction feasible under pod-order replay (wave commits in
    a different order, so a valid wave placement can transiently look
    infeasible here; regret is measured over the feasible ones)."""
    _, stats = _replay(snap, forced=np.asarray(assignment, dtype=np.int32))
    return stats


def _replay(snap: Snapshot, forced):
    p, n = snap.pods, snap.nodes
    P, N = p.count, n.count
    out = np.full(P, -1, dtype=np.int32)
    regrets = []
    greedy_hits = 0
    placed = 0
    infeasible_in_order = 0
    if P == 0 or N == 0:
        return out, {
            "mean_regret": 0.0,
            "p99_regret": 0.0,
            "greedy_match": 1.0,
            "feasible_in_order": 1.0,
            "placed": 0,
        }

    cpu_cap = n.cpu_cap.astype(np.int64)
    mem_cap = n.mem_cap.astype(np.int64)
    pods_cap = n.pods_cap.astype(np.int64)
    cpu_fit = n.cpu_fit_used.astype(np.int64).copy()
    mem_fit = n.mem_fit_used.astype(np.int64).copy()
    over = n.overcommitted.copy()
    cpu_used = n.cpu_used.astype(np.int64).copy()
    mem_used = n.mem_used.astype(np.int64).copy()
    pods_used = n.pods_used.astype(np.int64).copy()
    labels = n.label_bits
    uport = n.used_port_bits.copy()
    uvol_any = n.used_vol_any_bits.copy()
    uvol_rw = n.used_vol_rw_bits.copy()
    svc_counts = n.service_counts.astype(np.int64).copy()
    sched = n.schedulable
    idx = np.arange(N, dtype=np.int64)

    pod_cpu = p.cpu_milli.astype(np.int64)
    pod_mem = p.mem_mib.astype(np.int64)
    sel_rows = p.sel_bits[p.selector_id]
    # Same top-K membership truncation the device path commits with.
    svc_ids = p.svc_topk

    for i in range(P):
        # -- predicates (solver.py _feasible formulas) --
        fits_cpu = (cpu_cap == 0) | (cpu_fit + pod_cpu[i] <= cpu_cap)
        fits_mem = (mem_cap == 0) | (mem_fit + pod_mem[i] <= mem_cap)
        fits_count = pods_used + 1 <= pods_cap
        if p.zero_req[i]:
            res_ok = pods_used < pods_cap
        else:
            res_ok = (~over) & fits_cpu & fits_mem & fits_count
        sel = sel_rows[i]
        sel_ok = ((sel[None, :] & labels) == sel[None, :]).all(axis=1)
        port_ok = ~(p.port_bits[i][None, :] & uport).any(axis=1)
        vol_bad = (
            (p.vol_rw_bits[i][None, :] & uvol_any)
            | (p.vol_any_bits[i][None, :] & uvol_rw)
        ).any(axis=1)
        pin = int(p.pinned_node[i])
        host_ok = True if pin == -1 else (idx == pin)
        feas = res_ok & sel_ok & port_ok & ~vol_bad & host_ok & sched

        # -- priorities (exact host arithmetic) --
        creq = cpu_used + pod_cpu[i]
        mreq = mem_used + pod_mem[i]
        lr_c = np.where(
            (cpu_cap == 0) | (creq > cpu_cap),
            0,
            ((cpu_cap - creq) * 10) // np.maximum(cpu_cap, 1),
        )
        lr_m = np.where(
            (mem_cap == 0) | (mreq > mem_cap),
            0,
            ((mem_cap - mreq) * 10) // np.maximum(mem_cap, 1),
        )
        lr = (lr_c + lr_m) // 2
        cfrac = np.where(cpu_cap == 0, 1.0, creq / np.maximum(cpu_cap, 1))
        mfrac = np.where(mem_cap == 0, 1.0, mreq / np.maximum(mem_cap, 1))
        bra = np.where(
            (cfrac >= 1) | (mfrac >= 1),
            0,
            (10.0 - np.abs(cfrac - mfrac) * 10.0).astype(np.int64),
        )
        svc = int(p.service_id[i])
        if svc < 0:
            spread = np.full(N, 10, dtype=np.int64)
        else:
            counts = svc_counts[:, svc]
            maxc = int(counts.max())
            if maxc == 0:
                spread = np.full(N, 10, dtype=np.int64)
            else:
                spread = (10.0 * ((maxc - counts) / maxc)).astype(np.int64)
        score = lr + bra + spread

        masked = np.where(feas, score, -1)
        best = int(np.argmax(masked))  # first max = lowest node index
        if forced is None:
            if masked[best] < 0:
                continue
            out[i] = best
        else:
            chosen = int(forced[i])
            if chosen < 0:
                continue  # the approximate solver left it unplaced
            placed += 1
            if masked[best] >= 0 and feas[chosen]:
                regrets.append(int(masked[best]) - int(score[chosen]))
                if int(score[chosen]) == int(masked[best]):
                    greedy_hits += 1
            else:
                infeasible_in_order += 1
            out[i] = best = chosen

        # -- commit (AssumePod analog) --
        cpu_fit[best] += pod_cpu[i]
        mem_fit[best] += pod_mem[i]
        cpu_used[best] += pod_cpu[i]
        mem_used[best] += pod_mem[i]
        pods_used[best] += 1
        uport[best] |= p.port_bits[i]
        uvol_any[best] |= p.vol_any_bits[i]
        uvol_rw[best] |= p.vol_rw_bits[i]
        ids = svc_ids[i]
        ids = ids[ids >= 0]
        if len(ids):
            svc_counts[best, ids] += 1

    stats = None
    if forced is not None:
        r = np.asarray(regrets, dtype=np.float64)
        stats = {
            "mean_regret": float(r.mean()) if len(r) else 0.0,
            "p99_regret": float(np.percentile(r, 99)) if len(r) else 0.0,
            "greedy_match": greedy_hits / max(placed, 1),
            "feasible_in_order": 1.0 - infeasible_in_order / max(placed, 1),
            "placed": placed,
        }
    return out, stats


def validate_assignment_numpy(snap: Snapshot, assignment) -> None:
    """Replay every placement against the snapshot's own predicate
    semantics in NumPy; raises AssertionError on any capacity /
    selector / port / volume / pin violation.

    The wave family (ops.wave, ops.sinkhorn) trades decision-order
    parity for batching, so its invariant is placement validity, not
    destination equality."""
    n = snap.nodes
    cpu_fit = n.cpu_fit_used.copy()
    mem_fit = n.mem_fit_used.copy()
    pods_used = n.pods_used.copy()
    uport = n.used_port_bits.copy()
    uvol_any = n.used_vol_any_bits.copy()
    uvol_rw = n.used_vol_rw_bits.copy()
    p = snap.pods
    sel_rows = p.sel_bits[p.selector_id]
    for i, j in enumerate(assignment):
        if j < 0:
            continue
        assert n.schedulable[j], f"pod {i} on unschedulable node {j}"
        assert not n.overcommitted[j], f"pod {i} on overcommitted node {j}"
        if p.zero_req[i]:
            assert pods_used[j] < n.pods_cap[j], f"pod {i}: count overflow"
        else:
            if n.cpu_cap[j] > 0:
                assert cpu_fit[j] + p.cpu_milli[i] <= n.cpu_cap[j], (
                    f"pod {i}: cpu overflow on node {j}"
                )
            if n.mem_cap[j] > 0:
                assert mem_fit[j] + p.mem_mib[i] <= n.mem_cap[j], (
                    f"pod {i}: mem overflow on node {j}"
                )
            assert pods_used[j] + 1 <= n.pods_cap[j], f"pod {i}: count"
        sel = sel_rows[i]
        assert ((sel & n.label_bits[j]) == sel).all(), f"pod {i}: selector"
        assert not (p.port_bits[i] & uport[j]).any(), f"pod {i}: port clash"
        assert not (
            (p.vol_rw_bits[i] & uvol_any[j]) | (p.vol_any_bits[i] & uvol_rw[j])
        ).any(), f"pod {i}: volume clash"
        pin = p.pinned_node[i]
        assert pin in (-1, j), f"pod {i}: pinned to {pin}, placed on {j}"
        cpu_fit[j] += p.cpu_milli[i]
        mem_fit[j] += p.mem_mib[i]
        pods_used[j] += 1
        uport[j] |= p.port_bits[i]
        uvol_any[j] |= p.vol_any_bits[i]
        uvol_rw[j] |= p.vol_rw_bits[i]
