#!/usr/bin/env python3
"""Build the PyTorch/CUDA port and drive it on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It imports only `kubernetes_tpu_torch`
and needs one card; without CUDA, or without the package beside it, it
exits non-zero and prints no result. Phases, one JSON line each:

  1. device   the card, its power limit, torch and CUDA versions;
  2. build    nvcc of every kernel under kubernetes_tpu_torch/csrc/,
              all sources at once;
  3. parity   each kernel held against its plain PyTorch version on the
              card, exactly (torch.equal on the decisions and all nine
              carry fields): seeded small clusters, non-default weights,
              repeated service ids, multi-word bitsets, the scan
              cluster's edges (an unpadded node axis of 5,121, fewer
              nodes than CTAs, crowded services, unplaceable pods between
              placed ones), then the 50k x 5k backlog chunk by chunk (all
              of it when the plain loop fits its budget, else the first
              pipeline chunk; the line says which);
  4. repeat   the scan kernel five times on the first 50k x 5k chunk:
              every run's decisions and carry equal the checked ones (a
              race between the cluster's CTAs shows up as a difference);
  5. main     solve_backlog_pipelined on synthetic_objects(50000, 5000,
              seed=2+r): a warm-up and three timed runs, with the phase
              times, pods placed and kernel launches of each; then
              schedule_backlog once. Every run's names must equal the
              plain version's where phase 3 checked them;
  6. kernels  per kernel: launches on the main path, its time by CUDA
              events at the main path's shape, the plain version's time
              on the same inputs, and the bound for that work; for the
              scan kernel also sweeps over the node count, the cluster
              size and the threads per CTA (each configuration's result
              equal to the checked one), a run with no service ids (no
              count commits), a node axis near the shared-memory limit,
              timed once, and a `launch` line per configuration (cluster size,
              shared memory, cudaOccupancyMaxActiveClusters, registers
              and spills from ptxas).

Then the card's name and power limit, and last the result line
{"ok": true, "device": {...}}. Any failure ends the run with a non-zero
exit before the result line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

N_PODS, N_NODES = 50000, 5000
MAIN_REPEATS = 3
PLAIN_BUDGET_S = 60.0  # the plain loop over the whole backlog, else one chunk
KERNEL_REPEATS = 5

# The card's published rates (NVIDIA H100 SXM data sheet): HBM bytes/s and
# f32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(phase: str, message: str) -> None:
    emit(phase, ok=False, error=message)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 2
    try:
        from kubernetes_tpu_torch.ops import build  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 3

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kind = torch.cuda.get_device_name(0)

    # -- 1. device ---------------------------------------------------------
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit(
        "device", ok=True, kind=kind, count=torch.cuda.device_count(),
        nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0],
    )

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    records = build.build_all()
    emit(
        "build", ok=True, seconds=time.perf_counter() - t0,
        kernels=[
            {"name": r["name"], "seconds": r["seconds"], "built": r["built"],
             "ptxas": [l for l in str(r["log"]).splitlines() if "ptxas" in l][-4:]}
            for r in records
        ],
    )

    # -- 3. parity ---------------------------------------------------------
    parity = check_parity(torch, device)
    emit("parity", ok=True, **parity["summary"])

    # -- 4. repeat ----------------------------------------------------------
    emit("repeat", ok=True, **check_repeat(torch, parity["chunk_state"], parity["chunk_result"]))

    # -- 5. main path ------------------------------------------------------
    main_result = run_main_path(torch, device, parity["reference"])
    emit("main", ok=True, **main_result)

    # -- 6. kernels --------------------------------------------------------
    ptxas = "\n".join(str(r["log"]) for r in records if r["name"] == "scan_kernel")
    timing = time_kernel(torch, device, parity["chunk_state"], parity["chunk_result"], ptxas)
    kernels = [
        {
            "name": "scan_kernel",
            "route": "cuda",
            "source": "kubernetes_tpu_torch/csrc/scan_kernel.cu",
            "replaces": "kubernetes_tpu/ops/pallas_scan.py:126",
            "launches": main_result["launches_last_run"],
            "max_abs_err": parity["summary"]["max_abs_err"],
            "ms": timing["ms"],
            "plain_ms": parity["plain_ms"],
            "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            # No single PyTorch call computes the sequential solve.
            "library_ms": None,
        }
    ]
    emit("kernel_timing", ok=True, card=smi, **timing)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


# ---------------------------------------------------------------------------
# Phase 3: kernel vs plain
# ---------------------------------------------------------------------------


def _copy(d):
    return {k: v.clone() for k, v in d.items()}


def _max_abs_err(torch, a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max().item())


def _compare(torch, tag, got_choice, got_nodes, ref_choice, ref_nodes) -> float:
    """The largest absolute difference over the decisions and the nine
    carry fields (bitset words compared as int32, exactly). The
    tolerance is exact equality: any difference fails the phase."""
    from kubernetes_tpu_torch.ops.matrices import CARRY_KEYS

    err = _max_abs_err(torch, got_choice, ref_choice)
    if not torch.equal(got_choice, ref_choice):
        bad = int((got_choice != ref_choice).sum().item())
        first = int((got_choice != ref_choice).nonzero()[0].item())
        fail("parity", f"{tag}: {bad} decisions differ, first at pod {first}")
    for k in CARRY_KEYS:
        field_err = _max_abs_err(torch, got_nodes[k], ref_nodes[k])
        if not torch.equal(got_nodes[k], ref_nodes[k]):
            fail("parity", f"{tag}: carry field {k} differs (max abs err {field_err})")
        err = max(err, field_err)
    return err


def _kernel_vs_plain(torch, tag, pods, nodes, weights):
    from kubernetes_tpu_torch.ops import scan_kernel

    kn, pn = _copy(nodes), _copy(nodes)
    got, kn = scan_kernel.scan_with_state(pods, kn, weights)
    ref, pn = scan_kernel.plain_scan_with_state(pods, pn, weights)
    torch.cuda.synchronize()
    return _compare(torch, tag, got, kn, ref, pn)


def _multiword_cluster():
    from kubernetes_tpu_torch.models.objects import (
        Container, ContainerPort, Node, NodeCondition, NodeStatus, ObjectMeta,
        Pod, PodSpec, ResourceRequirements,
    )
    from kubernetes_tpu_torch.models.quantity import Quantity, parse_quantity

    nodes = [
        Node(
            metadata=ObjectMeta(name=f"n{j}"),
            status=NodeStatus(
                capacity={"cpu": Quantity.from_milli(4000),
                          "memory": parse_quantity("4096Mi"),
                          "pods": Quantity.from_int(200)},
                conditions=[NodeCondition(type="Ready", status="True")],
            ),
        )
        for j in range(4)
    ]

    def pod(name, port):
        return Pod(
            metadata=ObjectMeta(name=name, namespace="default"),
            spec=PodSpec(containers=[Container(
                name="c", ports=[ContainerPort(container_port=80, host_port=port)],
                resources=ResourceRequirements(limits={
                    "cpu": Quantity.from_milli(10), "memory": parse_quantity("8Mi")}),
            )]),
        )

    # 70 distinct host ports need 3 u32 words (bucketed to 4); the second
    # round reuses the first ports and must avoid their nodes.
    pods = [pod(f"p{i}", 7000 + i) for i in range(70)]
    pods += [pod(f"q{i}", 7000 + i) for i in range(8)]
    return pods, nodes


def check_parity(torch, device):
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.columnar import SnapshotBuilder, build_snapshot
    from kubernetes_tpu_torch.ops import scan_kernel
    from kubernetes_tpu_torch.ops.matrices import device_nodes, device_pods, device_snapshot
    from kubernetes_tpu_torch.ops.pipeline import DEFAULT_CHUNK

    cases = 0
    max_err = 0.0
    for seed in range(12):
        pending, nodes, assigned, services = workload.small_cluster(seed)
        d = device_snapshot(build_snapshot(pending, nodes, assigned, services), device)
        for weights in ((1, 1, 1), (2, 0, 3), (0, 5, 1)):
            max_err = max(max_err, _kernel_vs_plain(
                torch, f"small seed {seed} weights {weights}", d.pods, d.nodes, weights))
            cases += 1
    for seed in range(3):
        # A service id listed twice in a pod's row commits twice.
        pending, nodes, assigned, services = workload.small_cluster(seed)
        d = device_snapshot(build_snapshot(pending, nodes, assigned, services), device)
        ids = d.pods["svc_ids"]
        ids[:, 1] = torch.where(ids[:, 0] >= 0, ids[:, 0], ids[:, 1])
        max_err = max(max_err, _kernel_vs_plain(
            torch, f"repeated service ids, seed {seed}", d.pods, d.nodes, (1, 1, 1)))
        cases += 1
    pods, nodes = _multiword_cluster()
    d = device_snapshot(build_snapshot(pods, nodes), device)
    max_err = max(max_err, _kernel_vs_plain(torch, "multi-word bitsets", d.pods, d.nodes, (1, 1, 1)))
    cases += 1

    # The scan cluster's edges, on node axes left unpadded (pad_to=1): a
    # last CTA with a short slice (5,121 nodes over 16 CTAs of 324),
    # CTAs with no node (7 nodes), crowded services whose max count the
    # commits keep raising (6 nodes), and unplaceable pods (pinned to -2
    # or past the node axis) between placed ones. Nodes of nine kinds
    # give equal best scores in several CTAs.
    edges = (
        ("5,121 nodes", 2048, 5121, 7),
        ("7 nodes, fewer than the CTAs", 300, 7, 8),
        ("crowded services on 6 nodes", 400, 6, 9),
        ("unplaceable pods between placed ones", 600, 200, 10),
    )
    for tag, n_pods, n_nodes, seed in edges:
        pending, nodes, services = workload.synthetic_objects(n_pods, n_nodes, seed=seed)
        d = device_snapshot(build_snapshot(pending, nodes, services=services), device, 1)
        if tag.startswith("unplaceable"):
            d.pods["pinned"][1::3] = -2
            d.pods["pinned"][2::7] = n_nodes + 3
        max_err = max(max_err, _kernel_vs_plain(torch, tag, d.pods, d.nodes, (1, 1, 1)))
        cases += 1

    # The main path's state: the 50k x 5k backlog of the first main run,
    # lowered and staged exactly as solve_backlog_pipelined does.
    pending, nodes, services = workload.synthetic_objects(N_PODS, N_NODES, seed=2)
    builder = SnapshotBuilder(pending, nodes, (), services)
    carry_k = device_nodes(builder.node_columns(), device)
    carry_p = _copy(carry_k)
    starts = list(range(0, N_PODS, DEFAULT_CHUNK))
    reference = []  # plain decisions of the checked pods, in order
    chunk_state = None
    plain_s = 0.0
    plain_ms = None
    chunks_checked = 0
    for ci, start in enumerate(starts):
        cols = builder.pod_columns(start, min(start + DEFAULT_CHUNK, N_PODS))
        dpods = device_pods(cols, device)
        if ci == 0:
            chunk_state = (dpods, _copy(carry_k))
        got, carry_k = scan_kernel.scan_with_state(dpods, carry_k)
        if ci == 0:
            chunk_result = (got.clone(), _copy(carry_k))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        ref, carry_p = scan_kernel.plain_scan_with_state(dpods, carry_p, (1, 1, 1))
        ev1.record()
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        if ci == 0:
            plain_ms = ev0.elapsed_time(ev1)
        max_err = max(max_err, _compare(torch, f"50k x 5k chunk {ci}", got, carry_k, ref, carry_p))
        reference.extend(ref[: cols.count].tolist())
        chunks_checked += 1
        remaining = len(starts) - ci - 1
        if remaining and plain_s / (ci + 1) * remaining > PLAIN_BUDGET_S:
            break
    checked = len(reference)
    scope = "full" if checked == N_PODS else "first_chunk"
    names = [n.metadata.name for n in nodes]
    return {
        "summary": {
            "cases": cases,
            "backlog_scope": scope,
            "backlog_pods_checked": checked,
            "backlog_chunks_checked": chunks_checked,
            "plain_seconds": plain_s,
            "max_abs_err": max_err,
            "tolerance": "exact (torch.equal)",
        },
        "reference": [names[j] if j >= 0 else None for j in reference],
        "chunk_state": chunk_state,
        "chunk_result": chunk_result,
        "plain_ms": plain_ms,
    }


# ---------------------------------------------------------------------------
# Phase 4: repeated runs
# ---------------------------------------------------------------------------


def check_repeat(torch, chunk_state, chunk_result, runs=5):
    """The scan kernel `runs` times on the first 50k x 5k chunk, each run
    from the same carry: decisions and carry must equal the checked
    result every time. The CPU emulation's barriers are sequentially
    consistent, so a missing fence or a stale cache line between the
    cluster's CTAs can only show here."""
    from kubernetes_tpu_torch.ops import scan_kernel

    pods, carry0 = chunk_state
    ref, ref_nodes = chunk_result
    for i in range(runs):
        nodes = _copy(carry0)
        got, nodes = scan_kernel.scan_with_state(pods, nodes)
        torch.cuda.synchronize()
        _compare(torch, f"repeat {i} of the first chunk", got, nodes, ref, ref_nodes)
    return {"runs": runs, "pods": int(pods["cpu"].shape[0]), "identical": True}


# ---------------------------------------------------------------------------
# Phase 5: the main path
# ---------------------------------------------------------------------------


def run_main_path(torch, device, reference):
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.ops import scan_kernel
    from kubernetes_tpu_torch.ops.pipeline import solve_backlog_pipelined
    from kubernetes_tpu_torch.scheduler.batch import schedule_backlog
    from kubernetes_tpu_torch.utils.tracing import PhaseTimer

    runs = []
    first_names = None
    for r in range(MAIN_REPEATS + 1):
        pending, nodes, services = workload.synthetic_objects(N_PODS, N_NODES, seed=2 + r)
        timer = PhaseTimer()
        torch.cuda.synchronize()
        scan_kernel.scan_with_state.launches = 0
        t0 = time.perf_counter()
        names = solve_backlog_pipelined(pending, nodes, services=services, device=device, timer=timer)
        wall = time.perf_counter() - t0
        launches = scan_kernel.scan_with_state.launches
        if launches == 0:
            fail("main", "solve_backlog_pipelined launched no scan kernel")
        node_names = {n.metadata.name for n in nodes}
        if len(names) != N_PODS or any(n is not None and n not in node_names for n in names):
            fail("main", "result has the wrong length or unknown node names")
        placed = sum(n is not None for n in names)
        if placed == 0:
            fail("main", "no pod placed")
        if r == 0:
            first_names = names
            if names[: len(reference)] != reference:
                bad = sum(a != b for a, b in zip(names, reference))
                fail("main", f"{bad} names differ from the plain version's")
        runs.append({
            "run": "warmup" if r == 0 else f"timed{r}",
            "seed": 2 + r, "wall_s": wall, "placed": placed,
            "pods_per_s": N_PODS / wall, "launches": launches,
            "phases_s": timer.seconds,
        })

    pending, nodes, services = workload.synthetic_objects(N_PODS, N_NODES, seed=2)
    timer = PhaseTimer()
    scan_kernel.scan_with_state.launches = 0
    t0 = time.perf_counter()
    names = schedule_backlog(pending, nodes, services=services, device=device, timer=timer)
    wall = time.perf_counter() - t0
    batch_launches = scan_kernel.scan_with_state.launches
    if batch_launches == 0:
        fail("main", "schedule_backlog launched no scan kernel")
    if names != first_names:
        fail("main", "schedule_backlog disagrees with solve_backlog_pipelined")

    timed = [x["wall_s"] for x in runs[1:]]
    return {
        "backlog": f"{N_PODS} pods x {N_NODES} nodes, {N_PODS // 100} services",
        "runs": runs,
        "wall_s_median": statistics.median(timed),
        "pods_per_s_median": N_PODS / statistics.median(timed),
        "launches_last_run": runs[-1]["launches"],
        "checked_against_plain": len(reference),
        "schedule_backlog": {"wall_s": wall, "launches": batch_launches,
                             "phases_s": timer.seconds, "equal_to_pipelined": True},
    }


# ---------------------------------------------------------------------------
# Phase 6: kernel time and bound at the main path's shape
# ---------------------------------------------------------------------------


def _time_ms(torch, pods, carry, plan=None, reps=3, warm=True):
    """Median CUDA-event milliseconds of `reps` launches (after one
    warm-up launch when `warm`), each from a fresh copy of `carry`.
    Returns (median, all times, the last launch's (choice, nodes))."""
    from kubernetes_tpu_torch.ops import scan_kernel

    times, out = [], None
    for _ in range(reps + (1 if warm else 0)):
        nodes = _copy(carry)
        torch.cuda.synchronize()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = scan_kernel._launch(pods, nodes, (1, 1, 1), plan)
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
    if warm:
        times = times[1:]  # the first call warms the caches
    return statistics.median(times), times, out


def _ptxas_figures(log: str):
    """The most registers any instance of the scan kernel uses, and the
    spill bytes (stores + loads) of all of them."""
    import re

    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    return (
        max(int(x) for x in regs) if regs else None,
        sum(int(x) + int(y) for x, y in spills) if spills else None,
    )


def time_kernel(torch, device, chunk_state, chunk_result, ptxas):
    from kubernetes_tpu_torch.ops import scan_kernel

    pods, carry0 = chunk_state
    ref, ref_nodes = chunk_result
    P, N = pods["cpu"].shape[0], carry0["cpu_cap"].shape[0]
    SW, PW = pods["sel"].shape[1], pods["port"].shape[1]
    VW, K = pods["vol_any"].shape[1], pods["svc_ids"].shape[1]
    S = carry0["svc_counts"].shape[1]
    ms, times, _ = _time_ms(torch, pods, carry0, None, KERNEL_REPEATS)
    plan = scan_kernel.plan_for(pods, carry0)
    regs, spills = _ptxas_figures(ptxas)

    def launch_line(cfg, n_nodes, t):
        line = {
            "cluster": cfg.cluster, "threads": cfg.threads, "nodes": n_nodes,
            "nodes_per_cta": cfg.nodes_per_cta, "smem_bytes": cfg.smem_bytes,
            "max_active_clusters": scan_kernel.occupancy(cfg, n_nodes, SW, PW, VW, K),
            "registers": regs, "spill_bytes": spills, "default": cfg == plan,
            "ms": t, "per_pod_us": t * 1e3 / P,
        }
        emit("launch", ok=True, **line)
        return line

    # The same pods against the first n nodes only: how the time per pod
    # splits into a fixed part (barriers, reductions, commit) and a part
    # that grows with the nodes each thread walks.
    per_pod_us = {}
    for n in (1024, 2048, 4096):
        part = {k: v[:n].clone() for k, v in carry0.items()}
        t, _, _ = _time_ms(torch, pods, part, None, 2)
        per_pod_us[n] = t * 1e3 / P
    per_pod_us[N] = ms * 1e3 / P

    # Cluster size and threads per CTA on the whole chunk. Each
    # configuration's decisions and carry must equal the checked ones.
    sweep = [launch_line(plan, N, ms)]
    for C, T in ((8, 320), (8, 640), (16, 160), (16, 640)):
        cfg = scan_kernel.plan_for(pods, carry0, C, T)
        t, _, (got, nodes) = _time_ms(torch, pods, carry0, cfg, 2)
        _compare(torch, f"cluster of {C} x {T} threads", got, nodes, ref, ref_nodes)
        sweep.append(launch_line(cfg, N, t))


    # No service ids: no commit changes a count (other decisions, the
    # same shape of work), so the difference is what the counts cost.
    count_steps = int(((ref >= 0) & (pods["svc_ids"] >= 0).any(dim=1)).sum().item())
    no_ids = dict(pods, svc_ids=torch.full_like(pods["svc_ids"], -1))
    ms_no_ids, _, _ = _time_ms(torch, no_ids, carry0, None, 2)

    # A node axis near the shared-memory limit, timed once: the chunk's
    # nodes repeated up to max_nodes.
    n_max = scan_kernel.max_nodes(SW, PW, VW, K)
    big = {k: torch.cat([v] * -(-n_max // N))[:n_max].contiguous() for k, v in carry0.items()}
    ms_big, _, _ = _time_ms(torch, pods, big, None, 1, warm=False)
    near_limit = launch_line(scan_kernel.plan_for(pods, big), n_max, ms_big)

    # Bytes: every input read once, every output written once. Pods:
    # cpu, mem, pinned, svc (4 B), zero_req (1 B), bitset words and
    # service ids (4 B each); node constants; the carry in and out;
    # the choices.
    pod_bytes = P * (4 * 4 + 1 + 4 * (SW + PW + 2 * VW + K))
    const_bytes = N * (3 * 4 + 2 + 4 * SW)
    carry_bytes = N * (5 * 4 + 4 * (PW + 2 * VW) + 4 * S)
    nbytes = pod_bytes + const_bytes + 2 * carry_bytes + 4 * P
    # Operations per (pod, node) pair, counted from the plain version's
    # arithmetic: resources and pod-count predicates 13, hostname 2,
    # selector 2 per word, ports 2 per word, disk 4 per word; casts 4;
    # LeastRequested 12; BalancedResourceAllocation 14; spreading 4;
    # weighted sum 5; key and max 3. All 32-bit, taken at the f32 rate.
    # Pods that no node can take (the padding) need no pair at all.
    ops_per_pair = 13 + 2 + 4 + 12 + 14 + 4 + 5 + 3 + 2 * SW + 2 * PW + 4 * VW
    pin = pods["pinned"]
    placeable = int(((pin == -1) | ((pin >= 0) & (pin < N))).sum().item())
    nops = placeable * N * ops_per_pair
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / F32_OPS_PER_S * 1e3
    return {
        "shape": {"P": P, "N": N, "S": S, "SW": SW, "PW": PW, "VW": VW, "K": K},
        "plan": {"cluster": plan.cluster, "threads": plan.threads,
                 "nodes_per_cta": plan.nodes_per_cta, "smem_bytes": plan.smem_bytes},
        "ms": ms,
        "per_pod_us_by_nodes": per_pod_us,
        "fixed_part_us": per_pod_us[1024],
        "ms_all": times,
        "sweep": [{k: x[k] for k in ("cluster", "threads", "ms", "per_pod_us")} for x in sweep],
        "placeable_pods": placeable,
        "count_commit_steps": count_steps,
        "ms_no_service_ids": ms_no_ids,
        "near_limit": {k: near_limit[k] for k in ("nodes", "cluster", "threads", "smem_bytes", "ms", "per_pod_us")},
        "bytes": nbytes,
        "ops": nops,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "timed": "the wrapper's launch on the first pipeline chunk, layout conversion included",
    }


if __name__ == "__main__":
    sys.exit(main())
