"""Sequential NumPy oracle: the reference's scheduleOne semantics replayed
pod at a time in exact host arithmetic (int64 / float64).

The port's own copy of what it needs from `kubernetes_tpu/ops/oracle.py`
(the port imports nothing of the JAX package): the sequential replay,
the quality score of an approximate solver's assignment against it
(`assignment_quality`: regret against the greedy best at each step of a
pod-order replay), the validity replay of the wave family
(`validate_assignment_numpy`), and the exact twins of the capacity
report and the defrag plan (`capacity_report_numpy`,
`plan_moves_numpy`). `chip_smoke.py` holds the card's wave and Sinkhorn
placements, capacity reports and plans to these; the tests hold this
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


def capacity_report_numpy(
    cpu_cap,
    mem_cap,
    pods_cap,
    cpu_fit,
    mem_fit,
    pods_used,
    over,
    sched,
    probe_cpu,
    probe_mem,
    probe_min,
    probe_live,
):
    """Exact NumPy twin of `ops/capacity.py capacity_report`: the same
    f32 elementwise arithmetic and int32-quantised sums, so it equals
    the tensor version bit for bit (no tolerance)."""
    from kubernetes_tpu_torch.ops.capacity import BIG_FIT, FIT_CAP, FRAC_Q

    f32 = np.float32
    cpu_cap = np.asarray(cpu_cap, f32)
    mem_cap = np.asarray(mem_cap, f32)
    pods_cap = np.asarray(pods_cap, f32)
    cpu_fit = np.asarray(cpu_fit, f32)
    mem_fit = np.asarray(mem_fit, f32)
    pods_used = np.asarray(pods_used, f32)
    over = np.asarray(over, bool)
    sched = np.asarray(sched, bool)
    probe_cpu = np.asarray(probe_cpu, f32)
    probe_mem = np.asarray(probe_mem, f32)
    probe_min = np.asarray(probe_min, np.int32)
    probe_live = np.asarray(probe_live, bool)

    f0, f1, big = f32(0.0), f32(1.0), f32(BIG_FIT)
    live = sched & ~over
    livef = live.astype(f32)

    free_cpu = np.maximum(cpu_cap - cpu_fit, f0) * livef
    free_mem = np.maximum(mem_cap - mem_fit, f0) * livef
    free_pods = np.maximum(pods_cap - pods_used, f0) * livef

    def util(used_part, cap):
        return np.where(
            (cap > f0) & live,
            np.clip(used_part / np.maximum(cap, f1), f0, f1),
            f0,
        ).astype(f32)

    util_cpu = util(cpu_fit, cpu_cap)
    util_mem = util(mem_fit, mem_cap)
    util_pods = util(pods_used, pods_cap)

    pc = probe_cpu[:, None]
    pm = probe_mem[:, None]
    per_cpu = np.where(pc > f0, free_cpu[None, :] / np.maximum(pc, f1), big)
    per_mem = np.where(pm > f0, free_mem[None, :] / np.maximum(pm, f1), big)
    fit_frac = np.minimum(np.minimum(per_cpu, per_mem), free_pods[None, :])
    fit_frac = np.clip(fit_frac, f0, f32(FIT_CAP)).astype(f32)
    fit_int = np.floor(fit_frac).astype(np.int32)
    frac_milli = np.floor(fit_frac * f32(FRAC_Q)).astype(np.int32)

    plive = probe_live.astype(np.int32)
    usable = (fit_int.sum(axis=1, dtype=np.int32) * plive).astype(np.int32)
    potential = (
        frac_milli.sum(axis=1, dtype=np.int32) * plive
    ).astype(np.int32)
    headroom = usable
    frag = np.where(
        potential > 0,
        f1
        - (usable.astype(f32) * f32(FRAC_Q))
        / np.maximum(potential, 1).astype(f32),
        f0,
    ).astype(f32)
    frag = (np.clip(frag, f0, f1) * probe_live.astype(f32)).astype(f32)
    slice_ok = probe_live & (
        headroom >= np.maximum(probe_min, np.int32(1))
    )

    total_usable = np.int32(usable.sum(dtype=np.int32))
    total_potential = np.int32(potential.sum(dtype=np.int32))
    if total_potential > 0:
        frag_score = f32(
            f1 - (f32(total_usable) * f32(FRAC_Q)) / f32(total_potential)
        )
    else:
        frag_score = f0
    frag_score = f32(np.clip(frag_score, f0, f1))

    hosts_any = ((fit_int > 0) & probe_live[:, None]).any(axis=0)
    any_live_probe = bool(probe_live.any())
    stranded = (
        live
        & ((free_cpu > f0) | (free_mem > f0))
        & ~hosts_any
        & any_live_probe
    )

    def stranded_frac(free):
        free_i = free.astype(np.int32)
        tot = np.int32(free_i.sum(dtype=np.int32))
        strand = np.int32(
            (free_i * stranded.astype(np.int32)).sum(dtype=np.int32)
        )
        return f32(f32(strand) / f32(tot)) if tot > 0 else f0

    stranded_cpu = stranded_frac(free_cpu)
    stranded_mem = stranded_frac(free_mem)

    return (
        util_cpu,
        util_mem,
        util_pods,
        fit_int,
        headroom,
        frag,
        slice_ok,
        stranded,
        np.float32(frag_score),
        np.float32(stranded_cpu),
        np.float32(stranded_mem),
    )


def plan_moves_numpy(
    cpu_cap,
    mem_cap,
    pods_cap,
    cpu_fit,
    mem_fit,
    pods_used,
    over,
    sched,
    pod_cpu,
    pod_mem,
    pod_node,
    pod_live,
    pod_force,
    probe_cpu,
    probe_mem,
    probe_min,
    probe_live,
    move_budget,
):
    """Exact NumPy twin of `ops/rebalance.py plan_moves`: the plan as
    a Python loop over the rows, with the same f32 elementwise
    arithmetic, int32-quantised fits and first-minimum argmin, so it
    equals K2 and the plain version bit for bit (no tolerance)."""
    from kubernetes_tpu_torch.ops.capacity import BIG_FIT, FIT_CAP, FRAC_Q
    from kubernetes_tpu_torch.ops.rebalance import NO_FIT_KEY

    f32 = np.float32
    cpu_cap = np.asarray(cpu_cap, f32)
    mem_cap = np.asarray(mem_cap, f32)
    pods_cap = np.asarray(pods_cap, f32)
    cf = np.asarray(cpu_fit, f32).copy()
    mf = np.asarray(mem_fit, f32).copy()
    pu = np.asarray(pods_used, f32).copy()
    over = np.asarray(over, bool)
    sched = np.asarray(sched, bool)
    pod_cpu = np.asarray(pod_cpu, f32)
    pod_mem = np.asarray(pod_mem, f32)
    pod_node = np.asarray(pod_node, np.int32)
    pod_live = np.asarray(pod_live, bool)
    pod_force = np.asarray(pod_force, bool)
    probe_cpu = np.asarray(probe_cpu, f32)
    probe_mem = np.asarray(probe_mem, f32)
    probe_live = np.asarray(probe_live, bool)
    budget = np.int32(np.asarray(move_budget))

    f0, f1, big = f32(0.0), f32(1.0), f32(BIG_FIT)
    live = sched & ~over
    livef = live.astype(f32)
    n = cpu_cap.shape[0]
    d = pod_cpu.shape[0]
    plive_i = probe_live.astype(np.int32)

    def free_vectors(cf, mf, pu):
        return (
            np.maximum(cpu_cap - cf, f0) * livef,
            np.maximum(mem_cap - mf, f0) * livef,
            np.maximum(pods_cap - pu, f0) * livef,
        )

    def frag_score(cf, mf, pu):
        free_cpu, free_mem, free_pods = free_vectors(cf, mf, pu)
        pc = probe_cpu[:, None]
        pm = probe_mem[:, None]
        per_cpu = np.where(pc > f0, free_cpu[None, :] / np.maximum(pc, f1), big)
        per_mem = np.where(pm > f0, free_mem[None, :] / np.maximum(pm, f1), big)
        fit_frac = np.minimum(np.minimum(per_cpu, per_mem), free_pods[None, :])
        fit_frac = np.clip(fit_frac, f0, f32(FIT_CAP)).astype(f32)
        fit_int = np.floor(fit_frac).astype(np.int32)
        frac_q = np.floor(fit_frac * f32(FRAC_Q)).astype(np.int32)
        usable = np.int32(
            (fit_int.sum(axis=1, dtype=np.int32) * plive_i).sum(dtype=np.int32)
        )
        potential = np.int32(
            (frac_q.sum(axis=1, dtype=np.int32) * plive_i).sum(dtype=np.int32)
        )
        if potential > 0:
            score = f32(f1 - (f32(usable) * f32(FRAC_Q)) / f32(potential))
        else:
            score = f0
        return f32(np.clip(score, f0, f1))

    def node_usable(fc, fm, fp):
        pcu = np.where(probe_cpu > f0, f32(fc) / np.maximum(probe_cpu, f1), big)
        pme = np.where(probe_mem > f0, f32(fm) / np.maximum(probe_mem, f1), big)
        ff = np.clip(np.minimum(np.minimum(pcu, pme), f32(fp)), f0, f32(FIT_CAP))
        return np.int32(
            (np.floor(ff).astype(np.int32) * plive_i).sum(dtype=np.int32)
        )

    score_before = frag_score(cf, mf, pu)

    dest = np.full(d, -1, np.int32)
    moved = np.zeros(d, bool)
    gain_out = np.zeros(d, np.int32)
    moves = np.int32(0)
    arange_n = np.arange(n, dtype=np.int32)
    for i in range(d):
        cpu, mem = pod_cpu[i], pod_mem[i]
        src = pod_node[i]
        free_cpu, free_mem, free_pods = free_vectors(cf, mf, pu)

        src_c = int(np.clip(src, 0, n - 1))
        src_valid = bool(0 <= src < n)
        is_src = (arange_n == np.int32(src_c)) & src_valid

        feasible = (
            live
            & (free_cpu >= cpu)
            & (free_mem >= mem)
            & (free_pods >= f1)
            & ~is_src
        )

        kc = np.where(cpu > f0, (free_cpu - cpu) / np.maximum(cpu, f1), big)
        km = np.where(mem > f0, (free_mem - mem) / np.maximum(mem, f1), big)
        key_frac = np.clip(np.minimum(kc, km), f0, f32(FIT_CAP)).astype(f32)
        key = np.floor(key_frac * f32(FRAC_Q)).astype(np.int32)
        key = np.where(feasible, key, np.int32(NO_FIT_KEY))
        dst = int(np.argmin(key))
        any_feasible = bool(feasible.any())

        src_live = src_valid and bool(live[src_c])
        if src_live:
            u_src_before = node_usable(
                free_cpu[src_c], free_mem[src_c], free_pods[src_c]
            )
            u_src_after = node_usable(
                max(f32(cpu_cap[src_c] - (cf[src_c] - cpu)), f0),
                max(f32(mem_cap[src_c] - (mf[src_c] - mem)), f0),
                max(f32(pods_cap[src_c] - (pu[src_c] - f1)), f0),
            )
        else:
            u_src_before = np.int32(0)
            u_src_after = np.int32(0)
        u_dst_before = node_usable(free_cpu[dst], free_mem[dst], free_pods[dst])
        u_dst_after = node_usable(
            max(f32(cpu_cap[dst] - (cf[dst] + cpu)), f0),
            max(f32(mem_cap[dst] - (mf[dst] + mem)), f0),
            max(f32(pods_cap[dst] - (pu[dst] + f1)), f0),
        )
        gain = np.int32(
            (u_src_after + u_dst_after) - (u_src_before + u_dst_before)
        )

        commit = bool(
            pod_live[i]
            and any_feasible
            and moves < budget
            and (gain > 0 or bool(pod_force[i]))
        )
        if commit:
            cf[dst] = f32(cf[dst] + cpu)
            mf[dst] = f32(mf[dst] + mem)
            pu[dst] = f32(pu[dst] + f1)
            if src_valid:
                cf[src_c] = f32(cf[src_c] - cpu)
                mf[src_c] = f32(mf[src_c] - mem)
                pu[src_c] = f32(pu[src_c] - f1)
            moves = np.int32(moves + 1)
            dest[i] = dst
            moved[i] = True
            gain_out[i] = gain

    score_after = frag_score(cf, mf, pu)
    return (
        dest,
        moved,
        gain_out,
        np.int32(moves),
        np.float32(score_before),
        np.float32(score_after),
    )
