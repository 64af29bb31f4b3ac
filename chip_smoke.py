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
  4b. parity_in_place
              the scan kernel with its slices in device memory, held
              exactly to the plain version: small clusters forced in
              place on 1, 4 and 16 CTAs, the first 1,024 pods of that
              chunk forced in place (twice), 1,024 pods on 50,000 nodes
              (past the 40,384 a cluster holds resident; the default
              plan) and the runtime-width instance (4-word bitsets) on
              30,000 nodes (past the session's 27,840);
  5. main     solve_backlog_pipelined on synthetic_objects(50000, 5000,
              seed=2+r): a warm-up and three timed runs, with the phase
              times, pods placed and kernel launches of each; then
              schedule_backlog once. Every run's names must equal the
              plain version's where phase 3 checked them;
  5b. churn   BASELINE config 5 on the incremental SolverSession: the
              5,000 nodes and 500 services of that backlog, its pods as
              the first main run placed them as the assigned pods,
              node_capacity 6,250, prewarm to the 1,024-pod bucket, then
              2 warm-up and 10 timed ticks of 1,000 creates and 1,000
              random deletes (workload.churn_replay). Per tick the wall,
              the phases, the kernel's ms by CUDA events; after every
              tick the device rows equal the host mirror wherever no
              delta is pending; on timed ticks 1, 5 and 10 the kernel's
              choices and carry equal the plain version's on clones of
              that tick's inputs. The same operations are replayed on a
              fresh session with solve_async (a tick in flight while the
              next tick's deltas land) and must give the same results.
              Last, solve_gang on one more tick with groups, against the
              same tick on the replayed session with the plain version
              in place of the kernel; and the kernel timed at the
              session's shape;
  5c. gang    schedule_backlog_gang on seeded small clusters with groups
              on the card against device="cpu" (destinations, accepted
              and rejected keys), then on the 50k x 5k backlog in groups
              of 50, some of which cannot reach minMember: all or
              nothing, with at least two rounds;
  5d. policy_parity
              the policy scan kernel held against its plain version on
              the card, exactly (decisions, the nine carry fields, anchor
              and svc_total), each case at the default plan, on clusters
              of 1 and 4 CTAs, and on 16 CTAs with the slices read in
              place: every policy of workload.POLICY_SHAPES on seeded
              small clusters (BASELINE configs 2 and 3, label presence
              and absence, label preference, service affinity with an
              anchor on an unknown node, one and two anti-affinity
              instances, the full vocabulary), and the cluster's edges
              (ties across CTAs with unplaceable pods between placed
              ones, zones with nodes in every CTA, anchors in other CTAs,
              fewer nodes than CTAs, an instance of weight 0, crowded
              services), and past the eight anti-affinity instances and
              eight affinity labels the kernel keeps in its arguments
              and registers (9 and 12 instances, 9 labels, both at once,
              and 9 instances on 5,000 nodes);
  5e. policy  schedule_backlog(spec=FULL_VOCABULARY_POLICY) on
              policy_objects(50000, 5000, seed=2): a warm-up and three
              timed runs (wall, phases, launches; the three runs' names
              identical; one policy kernel launch each, on a cluster of
              more than one CTA), the kernel's ms by CUDA events on the
              whole backlog, the launch plan and its occupancy, and the
              first 4,096 pods held to the plain version on the card,
              decisions and carry;
  5f. explain explain_backlog for 1,024 pods of that backlog against its
              5,000 nodes on the card, equal to the same call with
              device="cpu";
  5h. wave    the wave solver (plain PyTorch, no hand kernel): on the
              card against the CPU, exactly (assignment, carry, waves),
              on seeded small clusters at windows 32 and 4,096 and on an
              8,192 x 1,024 backlog; solve_backlog_pipelined(mode="wave")
              on the 50k x 5k backlog, a warm-up and three timed runs
              (wall, phases, waves, pods placed, validity by the port's
              oracle), the warm-up's regret against the greedy replay
              within TestWaveQuality's bounds; then three churn ticks of
              the session in wave mode, the device rows equal to the host
              mirror after each;
  5i. sinkhorn the same for Sinkhorn, card against CPU within its
              rounding (decisions agreeing on 99% of the pods; the
              congestion prices of the same inputs within 1e-4 and the
              iterations run equal), with iterations and the residual,
              and TestSinkhornQuality's bounds;
  5g. sidecar python -m kubernetes_tpu_torch.ops.sidecar as a subprocess
              on the card, sent the default 50k backlog and the policy
              backlog by the port's SidecarSolver: the answers equal the
              in-process schedule_backlog's; round-trip seconds and frame
              bytes; the default backlog in modes wave and sinkhorn, each
              answer equal to the same solve in this process; a ping
              after a garbage frame still answers;
  5j. preemption
              victim selection (plain PyTorch) on
              workload.preemption_objects(5000, 50000, 1000): a priority
              burst on a fleet filled to 85-100% of a resource; seed 2 a
              warm-up and three timed runs (wall, build and solve, ms a
              preemptor, grants, victims), seed 3 once, each seed's card
              decisions equal to its CPU run's, one seed-2 solve under
              torch.profiler (the card's busy share); the card equal to
              the port's scalar rule on 16 small seeded problems and on
              200 nodes x 2,000 bound pods x 32 preemptors (the scalar is
              O(N x V) a preemptor, so not at full size);
  5k. capacity
              capacity_report (plain PyTorch) on the occupancy columns of
              the main path's placement (cluster_columns) and of the
              churn session after its replay (session_columns), probes
              DEFAULT_SLICE_SHAPES and the 50k backlog's p50, p90, max:
              card, CPU and the port's NumPy twin equal on every output,
              dtypes included; median ms; one call under torch.profiler
              (its kernels and the card's busy share);
  5l. rebalance_parity
              the defrag plan kernel (K2) held to its plain version on
              the card, exactly, on clusters of 1, 2, 4, 8 and 16 CTAs
              (every size its plan chooses), at the default K and at
              K = 1, resident and in place: 16 seeded worklists (N 1-300,
              Q 1-12, sources out of range, dead and forced rows, budgets
              0 to D + 3), the consolidation case, no rows, ties across
              every warp at 300 and 5,000 nodes, and 70 probes (the
              gain's lanes loop);
  5m. rebalance
              utils.rebalance.build_plan on five worklists: the main
              path's placement, all 50,000 pods movable, at budget 32
              (the descheduler's), at budget D, with 50 forced
              (cordoned) nodes and with every node forced (every row
              commits: the dense case), all at budget D but the first;
              and a full fleet (preemption_objects(5000, 50000, 0,
              seed=2), 48,998 movable pods) at budget D. Per case the
              wall and its phases (stage, plan, group), K2's ms by CUDA
              events and its us a row, its commits, windows, rows
              screened and the screen/resolve split of its cycles (the
              kernel's stats), and every output of K2 equal to the
              port's NumPy twin on the whole worklist, the plan equal to
              the plan of the twin's rows; K2 held to its plain version
              on the card on the first 2,048 rows of budget D (the plain
              loop is a launch sequence a row); K2 on budget D, 50
              forced nodes and the full fleet on clusters of 4, 8 and 16
              CTAs, K from 1 to 32 and windows of up to 2,048 rows, each
              equal to the default plan's outputs;
  6. kernels  per kernel: launches on the main path, its time by CUDA
              events at the main path's shape, the plain version's time
              on the same inputs, and the bound for that work; for the
              scan kernel also sweeps over the node count, the cluster
              size and the threads per CTA (each configuration's result
              equal to the checked one), a run with no service ids (no
              count commits), a node axis near the shared-memory limit,
              timed once, and a `launch` line per configuration (cluster size,
              shared memory, cudaOccupancyMaxActiveClusters, registers
              and spills from ptxas); for the policy scan kernel its µs a
              pod at 1,024, 5,120 and 20,480 nodes, with no anti-affinity,
              one instance and the full vocabulary, on clusters of 1, 4,
              8 and 16 CTAs (each equal to the default plan's result),
              and a split of its step: the scan kernel and the policy
              kernel on the same pods under specs that add the service
              carry, service affinity and anti-affinity one at a time;
              for the defrag plan kernel (K2) its time, the plain
              version's and the bound on the same first 2,048 rows of
              budget D, beside its time and bound on each of phase 5m's
              worklists, and its launches counted over each of the
              phases 5j-5m.

Every phase line carries the script's seconds so far (`elapsed_s`).
Then the card's name and power limit, and last the result line
{"ok": true, "device": {...}}. Any failure ends the run with a non-zero
exit before the result line.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

N_PODS, N_NODES = 50000, 5000
MAIN_REPEATS = 3
PLAIN_BUDGET_S = 60.0  # the plain loop over the whole backlog, else one chunk
KERNEL_REPEATS = 5
CHURN_RATE, CHURN_WARMUP, CHURN_TICKS = 1000, 2, 10
CHURN_CHECKED = (1, 5, 10)  # timed ticks whose kernel runs are held to the plain version
GANG_SIZE = 50
POLICY_REPEATS = 3
POLICY_CHECKED = 4096  # pods of the 50k policy backlog held to the plain version
EXPLAIN_PODS = 1024
SIDECAR_WAIT_S = 120

# The card's published rates (NVIDIA H100 SXM data sheet): HBM bytes/s and
# f32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the script's seconds so far."""
    print(json.dumps({"phase": phase, **fields, "elapsed_s": time.perf_counter() - _T0}), flush=True)


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
    parity_in_place = check_parity_in_place(torch, device, parity["chunk_state"])
    emit("parity_in_place", ok=True, **parity_in_place)

    # -- 5. main path ------------------------------------------------------
    main_result = run_main_path(torch, device, parity["reference"])
    placed_names = main_result.pop("first_names")
    emit("main", ok=True, **main_result)

    # -- 5b. churn on the incremental session ------------------------------
    churn = run_churn(torch, device, placed_names)
    churn_session = churn.pop("session")
    emit("churn", ok=True, card=smi, **churn)

    # -- 5c. gangs -----------------------------------------------------------
    gang = run_gang(torch, device)
    emit("gang", ok=True, **gang)

    # -- 5d-5g. policy specs, explain, the sidecar ---------------------------
    policy_parity = check_policy_parity(torch, device)
    emit("policy_parity", ok=True, **policy_parity)
    policy = run_policy(torch, device)
    policy_names = policy.pop("names")
    policy_timing = policy.pop("timing")
    policy_sweep_state = policy.pop("sweep_state")
    emit("policy", ok=True, card=smi, **policy)
    emit("explain", ok=True, card=smi, **run_explain(torch, device))
    # -- 5h-5i. the windowed solvers -------------------------------------------
    scan_placed = sum(n is not None for n in placed_names)
    for mode in ("wave", "sinkhorn"):
        emit(mode, ok=True, card=smi, **run_windowed(torch, device, mode, placed_names, scan_placed))
    sidecar_line = run_sidecar(torch, device, placed_names, policy_names)
    emit("sidecar", ok=True, card=smi, **sidecar_line)

    # -- 5j-5m. preemption, the capacity report, the defrag plan ----------------
    from kubernetes_tpu_torch.ops import rebalance

    # K2 is not on these two paths: their counts are read to show it.
    k2_launches = {}
    rebalance.plan_moves.launches = 0
    emit("preemption", ok=True, card=smi, **run_preemption(torch, device))
    k2_launches["preemption"] = rebalance.plan_moves.launches
    rebalance.plan_moves.launches = 0
    emit("capacity", ok=True, card=smi, **run_capacity(torch, device, placed_names, churn_session))
    k2_launches["capacity"] = rebalance.plan_moves.launches
    del churn_session
    rebalance_parity = check_rebalance_parity(torch, device)
    emit("rebalance_parity", ok=True, **rebalance_parity)
    rebalance_line = run_rebalance(torch, device, placed_names)
    emit("rebalance", ok=True, card=smi, **rebalance_line)

    # -- 6. kernels --------------------------------------------------------
    ptxas = "\n".join(str(r["log"]) for r in records if r["name"] == "scan_kernel")
    timing = time_kernel(torch, device, parity["chunk_state"], parity["chunk_result"], ptxas)
    policy_sweep = time_policy_kernel(torch, policy_sweep_state)
    kernels = [
        {
            "name": "scan_kernel",
            "route": "cuda",
            "source": "kubernetes_tpu_torch/csrc/scan_kernel.cu",
            "replaces": "kubernetes_tpu/ops/pallas_scan.py:126",
            "launches": main_result["launches_last_run"],
            "launches_by_path": {
                "main": main_result["launches_last_run"],
                "churn": churn["launches"],
                "churn_pipelined": churn["pipelined"]["launches"],
                "gang_50k": gang["backlog"]["launches"],
                "sidecar_default": sidecar_line["default"]["kernel_launches"]["scan_kernel"],
                "parity_in_place": parity_in_place["launches"],
            },
            "max_abs_err": max(parity["summary"]["max_abs_err"], parity_in_place["max_abs_err"]),
            "ms": timing["ms"],
            "plain_ms": parity["plain_ms"],
            "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            # No single PyTorch call computes the sequential solve.
            "library_ms": None,
            "session_shape": churn["kernel_at_session_shape"],
        },
        {
            "name": "policy_scan_kernel",
            "route": "cuda",
            "source": "kubernetes_tpu_torch/csrc/policy_scan_kernel.cu",
            # An XLA function of the JAX package, not a Pallas kernel.
            "replaces": "kubernetes_tpu/ops/solver.py:304 (_scan_solve under _solve_xla, "
                        "policy LoweredSpec; XLA, not a Pallas kernel)",
            "launches": policy["launches_last_run"],
            "launches_by_path": {
                "policy": policy["launches_last_run"],
                "sidecar_policy": sidecar_line["policy"]["kernel_launches"]["policy_scan_kernel"],
                "policy_past_8": policy_parity["past_8"]["launches"],
            },
            "max_abs_err": max(policy_parity["max_abs_err"], policy_timing["max_abs_err"]),
            "ms": policy_timing["ms"],
            "plain_ms": policy_timing["plain_ms"],
            "bound_ms": policy_timing["bound_ms"],
            "bound_by": policy_timing["bound_by"],
            # No single PyTorch call computes the sequential solve.
            "library_ms": None,
            "timed": policy_timing["timed"],
            "backlog_ms": policy["kernel_ms"],
            "cluster": policy["plan"]["cluster"],
        },
        {
            "name": "rebalance_kernel",
            "route": "cuda",
            "source": "kubernetes_tpu_torch/csrc/rebalance_kernel.cu",
            "replaces": "kubernetes_tpu/ops/rebalance.py:58 (plan_moves; XLA, not a Pallas kernel)",
            "launches": sum(rebalance_line["launches"].values()),
            "launches_by_path": {**{f"rebalance_{k}": v for k, v in rebalance_line["launches"].items()},
                                 **k2_launches, "rebalance_parity": rebalance_parity["launches"]},
            "max_abs_err": max(rebalance_parity["max_abs_err"], rebalance_line["k2"]["max_abs_err"]),
            # ms, plain_ms and bound_ms: the same first rows of case budget_d.
            "ms": rebalance_line["k2"]["ms"],
            "plain_ms": rebalance_line["k2"]["plain_ms"],
            "bound_ms": rebalance_line["k2"]["bound_ms"],
            "bound_by": rebalance_line["k2"]["bound_by"],
            # No single PyTorch call computes the sequential plan.
            "library_ms": None,
            "rows": rebalance_line["k2"]["rows"],
            "worklist_ms": rebalance_line["k2"]["worklist_ms"],
            "worklist_bound_ms": rebalance_line["k2"]["worklist"]["bound_ms"],
            "us_per_row": rebalance_line["k2"]["us_per_row"],
            "worklists": rebalance_line["k2"]["worklists"],
            "plan": rebalance_line["k2"]["plan"],
        },
    ]
    emit("kernel_timing", ok=True, card=smi, **timing, policy_sweep=policy_sweep)
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


def _compare(torch, tag, got_choice, got_nodes, ref_choice, ref_nodes, phase="parity") -> float:
    """The largest absolute difference over the decisions and the nine
    carry fields, and the service carry where there is one (bitset words
    compared as int32, exactly). The tolerance is exact equality: any
    difference fails the phase."""
    from kubernetes_tpu_torch.ops.matrices import CARRY_KEYS, POLICY_CARRY_KEYS

    err = _max_abs_err(torch, got_choice, ref_choice)
    if not torch.equal(got_choice, ref_choice):
        bad = int((got_choice != ref_choice).sum().item())
        first = int((got_choice != ref_choice).nonzero()[0].item())
        fail(phase, f"{tag}: {bad} decisions differ, first at pod {first}")
    for k in CARRY_KEYS + tuple(k for k in POLICY_CARRY_KEYS if k in ref_nodes):
        field_err = _max_abs_err(torch, got_nodes[k], ref_nodes[k])
        if not torch.equal(got_nodes[k], ref_nodes[k]):
            fail(phase, f"{tag}: carry field {k} differs (max abs err {field_err})")
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
# Phase 4b: the scan kernel in place
# ---------------------------------------------------------------------------

IN_PLACE_PODS = 1024  # the prefix of each backlog held to the plain version in place
IN_PLACE_NODES = 50000  # a node axis past the 40,384 a cluster holds resident
SESSION_IN_PLACE_NODES = 30000  # past the 27,840 at the session's 4-word widths


def _widen(torch, pods, nodes, words):
    """The bitset columns zero-padded to `words` words: the widths of the
    session, which take the kernel's runtime-width instance."""
    def pad(t):
        return torch.cat([t, t.new_zeros(t.shape[0], words - t.shape[1])], 1).contiguous()

    return ({k: pad(v) if k in ("sel", "port", "vol_any", "vol_rw") else v for k, v in pods.items()},
            {k: pad(v) if k in ("labels", "uport", "uvol_any", "uvol_rw") else v
             for k, v in nodes.items()})


def check_parity_in_place(torch, device, chunk_state):
    """The scan kernel with its slices in device memory, held exactly to
    the plain version: small clusters forced in place on 1, 4 and 16
    CTAs; the main backlog's first 1,024 pods on its 5,120 nodes forced
    in place, twice; 1,024 pods on 50,000 nodes, where the default plan
    is in place; and the runtime-width instance (4-word bitsets) on
    30,000 nodes, past the session's resident limit."""
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.columnar import build_snapshot
    from kubernetes_tpu_torch.ops import scan_kernel
    from kubernetes_tpu_torch.ops.matrices import device_snapshot

    scan_kernel.scan_with_state.launches = 0
    cases, max_err, plans = 0, 0.0, []

    def held(tag, pods, nodes, plan, timed=False):
        nonlocal cases, max_err
        if plan.resident:
            fail("parity_in_place", f"{tag}: the plan is resident")
        kn, pn = _copy(nodes), _copy(nodes)
        got, kn = scan_kernel._launch(pods, kn, (1, 1, 1), plan)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        ref, pn = scan_kernel.plain_scan_with_state(pods, pn, (1, 1, 1))
        ev1.record()
        torch.cuda.synchronize()
        max_err = max(max_err, _compare(torch, tag, got, kn, ref, pn, phase="parity_in_place"))
        cases += 1
        if not timed:
            return
        # The kernel in place and, where the slices fit, resident, on
        # the same inputs (CUDA events, median of 3 after a warm-up).
        ms, _, _ = _time_ms(torch, pods, nodes, plan)
        bound = kernel_bound(torch, pods, nodes)
        line = {"case": tag, "nodes": int(nodes["cpu_cap"].shape[0]), "cluster": plan.cluster,
                "threads": plan.threads, "smem_bytes": plan.smem_bytes,
                "placed": int((ref >= 0).sum().item()), "ms": ms,
                "per_pod_us": ms * 1e3 / max(bound["placeable_pods"], 1),
                "plain_ms": ev0.elapsed_time(ev1), **bound}
        resident = scan_kernel.plan_for(pods, nodes, plan.cluster, plan.threads)
        if resident.resident:
            line["resident_ms"] = _time_ms(torch, pods, nodes, resident)[0]
        plans.append(line)

    for seed in range(4):
        pending, nodes, assigned, services = workload.small_cluster(seed)
        d = device_snapshot(build_snapshot(pending, nodes, assigned, services), device)
        for C in (1, 4, 16):
            held(f"small seed {seed}, {C} CTAs", d.pods, d.nodes,
                 scan_kernel.plan_for(d.pods, d.nodes, C, None, False))
    pods0, carry0 = chunk_state
    pods = {k: v[:IN_PLACE_PODS].contiguous() for k, v in pods0.items()}
    plan = scan_kernel.plan_for(pods, carry0, resident=False)
    for r in range(2):
        held(f"first {IN_PLACE_PODS} pods of the 50k backlog, 5,120 nodes, run {r}", pods, carry0,
             plan, timed=r == 1)
    pending, nodes, services = workload.synthetic_objects(IN_PLACE_PODS, IN_PLACE_NODES, seed=4)
    d = device_snapshot(build_snapshot(pending, nodes, services=services), device)
    held(f"{IN_PLACE_PODS} pods on {IN_PLACE_NODES} nodes, default plan", d.pods, d.nodes,
         scan_kernel.plan_for(d.pods, d.nodes), timed=True)
    cut = {k: v[:SESSION_IN_PLACE_NODES].contiguous() for k, v in d.nodes.items()}
    wp, wn = _widen(torch, d.pods, cut, 4)
    held(f"{IN_PLACE_PODS} pods on {SESSION_IN_PLACE_NODES} nodes, 4-word bitsets, default plan",
         wp, wn, scan_kernel.plan_for(wp, wn), timed=True)
    launches = scan_kernel.scan_with_state.launches
    return {"cases": cases, "launches": launches,
            "resident_limit_nodes": {"main_widths": scan_kernel.max_nodes(2, 2, 2, 8),
                                     "session_widths": scan_kernel.max_nodes(4, 4, 4, 8)},
            "timed": plans, "max_abs_err": max_err,
            "tolerance": "exact (torch.equal)"}


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
        "first_names": first_names,
    }


# ---------------------------------------------------------------------------
# Phase 5b: churn on the incremental session (BASELINE config 5)
# ---------------------------------------------------------------------------


def _churn_cluster(placed_names):
    """The 50k x 5k backlog's nodes and services, and its pods as the
    first main run placed them, bound and Running (unplaced ones left
    out)."""
    from kubernetes_tpu_torch import workload

    pods, nodes, services = workload.synthetic_objects(N_PODS, N_NODES, seed=2)
    assigned = []
    for pod, name in zip(pods, placed_names):
        if name is not None:
            pod.spec.node_name = name
            pod.status.phase = "Running"
            assigned.append(pod)
    return nodes, services, assigned


def _new_session(torch, device, nodes, services, assigned):
    """A session as the incremental daemon builds one (node capacity
    1.25 x the nodes), prewarmed to the tick's pod bucket."""
    from kubernetes_tpu_torch.ops import SolverSession

    t0 = time.perf_counter()
    session = SolverSession(
        nodes, services, assigned, node_capacity=int(len(nodes) * 1.25), device=device
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warmed = session.prewarm(max_pod_bucket=1024)
    return session, build_s, time.perf_counter() - t0, warmed


def _mirror_check(torch, session, what):
    """Device rows equal the host mirror, exactly, on every row with no
    pending delta (all fifteen columns, the nine carry fields among
    them)."""
    import numpy as np

    from kubernetes_tpu_torch.ops.matrices import state_to_numpy

    dev = state_to_numpy(session.dev)
    clean = np.ones(session.N_cap, bool)
    clean[sorted(session._dirty)] = False
    for key, col in session.h.items():
        if not np.array_equal(dev[key][clean], col[clean]):
            bad = int((dev[key][clean] != col[clean]).reshape(int(clean.sum()), -1).any(1).sum())
            fail("churn", f"{what}: device column {key} differs from the host mirror on {bad} rows")
    return int(clean.sum())


class _Recorder:
    """Wraps a session's launch: CUDA events around each tick's kernel,
    and for the chosen ticks clones of the pods and the pre-launch carry
    plus the kernel's choices and post-launch carry."""

    def __init__(self, torch, session, capture):
        self.torch, self.capture = torch, set(capture)
        self.events, self.captured = [], {}
        self._launch = session._dispatch
        session._dispatch = self

    def __call__(self, pods, carry):
        torch = self.torch
        k = len(self.events)
        before = None
        if k in self.capture:
            before = ({n: v.clone() for n, v in pods.items()}, {n: v.clone() for n, v in carry.items()})
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = self._launch(pods, carry)
        ev1.record()
        self.events.append((ev0, ev1))
        if before is not None:
            self.captured[k] = (before, out[0].clone(), {n: v.clone() for n, v in carry.items()})
        return out

    def kernel_ms(self):
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


class _GcPauses:
    """Python's garbage-collector passes while in the block, by
    generation, with their wall seconds (a pause shows up in whichever
    tick phase it falls into)."""

    def __init__(self):
        self.pauses, self._t0 = [], 0.0

    def _on_gc(self, stage, info):
        if stage == "start":
            self._t0 = time.perf_counter()
        else:
            self.pauses.append((info["generation"], time.perf_counter() - self._t0))

    def __enter__(self):
        import gc

        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._on_gc)

    def summary(self):
        return {
            "passes": len(self.pauses),
            "gen2_passes": sum(g == 2 for g, _ in self.pauses),
            "total_s": sum(t for _, t in self.pauses),
            "max_s": max((t for _, t in self.pauses), default=0.0),
        }


def _held_to_plain(torch, captured, tag):
    """The kernel's choices and carry of one tick against the plain
    version on clones of that tick's inputs; returns the plain ms."""
    from kubernetes_tpu_torch.ops import scan_kernel

    (pods, carry), choice, after = captured
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    ref, ref_nodes = scan_kernel.plain_scan_with_state(pods, carry, (1, 1, 1))
    ev1.record()
    torch.cuda.synchronize()
    _compare(torch, tag, choice, after, ref, ref_nodes, phase="churn")
    return ev0.elapsed_time(ev1)


def _percentile(xs, q):
    import numpy as np

    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def _session_gang_tick(session, first_index, n_services):
    """One more tick of churn pods with groups: as many gangs of
    GANG_SIZE as the tick holds (20 of 50), the second of which has a
    member pinned to a node that does not exist, so its minMember of
    GANG_SIZE cannot be reached."""
    import random

    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.ops import SessionGang

    pods = workload.churn_pods(random.Random(99), first_index, CHURN_RATE, n_services)
    gangs = []
    for g in range(CHURN_RATE // GANG_SIZE):
        members = pods[g * GANG_SIZE:(g + 1) * GANG_SIZE]
        if g == 1:
            members[-1].spec.node_name = "no-such-node"
        gangs.append(SessionGang(
            key=f"default/tick-gang{g}", min_member=GANG_SIZE, bound=0,
            pod_keys=frozenset(f"default/{p.metadata.name}" for p in members),
        ))
    for pod in pods:
        session.add_pending(pod)
    return gangs


def _check_session_gangs(results, gangs, rejected):
    """All or nothing: a rejected gang has no pod placed, an accepted
    one at least its minMember less those already bound."""
    dest = dict(results)
    for g in gangs:
        placed = sum(dest[k] is not None for k in g.pod_keys)
        if g.key in rejected and placed:
            fail("churn", f"rejected group {g.key} kept {placed} placements")
        if g.key not in rejected and placed + g.bound < g.min_member:
            fail("churn", f"accepted group {g.key} has {placed} + {g.bound} < {g.min_member}")


def run_churn(torch, device, placed_names):
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.ops import scan_kernel

    nodes, services, assigned = _churn_cluster(placed_names)
    live = [f"default/{p.metadata.name}" for p in assigned]
    ticks = CHURN_WARMUP + CHURN_TICKS
    replay = dict(live=live, ticks=ticks, rate=CHURN_RATE, seed=7,
                  n_services=len(services), first_index=N_PODS)

    # The synchronous run, timed.
    session, build_s, prewarm_s, warmed = _new_session(torch, device, nodes, services, assigned)
    checked_rows = []
    rec = _Recorder(torch, session, [CHURN_WARMUP - 1 + t for t in CHURN_CHECKED])
    gc_pauses = _GcPauses()
    scan_kernel.scan_with_state.launches = 0
    with gc_pauses:
        records = workload.churn_replay(
            session, **replay,
            on_result=lambda k, _r: checked_rows.append(_mirror_check(torch, session, f"tick {k}")),
        )
    launches = scan_kernel.scan_with_state.launches
    if launches != ticks:
        fail("churn", f"{ticks} ticks launched the scan kernel {launches} times")
    kernel_ms = rec.kernel_ms()
    plain_ms = {}
    for t in CHURN_CHECKED:
        k = CHURN_WARMUP - 1 + t
        plain_ms[t] = _held_to_plain(torch, rec.captured[k], f"churn tick {t}")
    timed = records[CHURN_WARMUP:]
    walls = [r.wall_s for r in timed]
    scheduled = sum(d is not None for r in timed for _k, d in r.results)
    if scheduled == 0:
        fail("churn", "no pod placed in the timed ticks")
    phases = sorted({p for r in timed for p in r.phases_s})

    # The kernel at the session's shape: the last tick's inputs.
    (pods, carry), _choice, _after = rec.captured[ticks - 1]
    ms_shape, ms_all, _ = _time_ms(torch, pods, carry, None, KERNEL_REPEATS)
    plan = scan_kernel.plan_for(pods, carry)
    bound = kernel_bound(torch, pods, carry)

    # The same operations with a tick in flight while the next tick's
    # creates and deletes land.
    session_p, build_p, _, _ = _new_session(torch, device, nodes, services, assigned)
    scan_kernel.scan_with_state.launches = 0
    records_p = workload.churn_replay(
        session_p, **replay, pipelined=True,
        on_result=lambda k, _r: _mirror_check(torch, session_p, f"pipelined tick {k}"),
    )
    launches_p = scan_kernel.scan_with_state.launches
    if launches_p != ticks:
        fail("churn", f"{ticks} pipelined ticks launched the scan kernel {launches_p} times")
    walls_p = [r.wall_s for r in records_p[CHURN_WARMUP:]]
    for k, (a, b) in enumerate(zip(records, records_p)):
        if a.results != b.results:
            bad = sum(x != y for x, y in zip(a.results, b.results))
            fail("churn", f"pipelined tick {k}: {bad} results differ from the synchronous run's")
    for key, col in session.h.items():
        if not (col == session_p.h[key]).all():
            fail("churn", f"host mirror column {key} differs between the two runs")

    # solve_gang on one more tick: the kernel session against the
    # replayed session with the plain version in place of the kernel.
    first = N_PODS + ticks * CHURN_RATE
    gangs = _session_gang_tick(session, first, len(services))
    gangs_p = _session_gang_tick(session_p, first, len(services))
    session_p._dispatch = lambda pods, carry: (
        scan_kernel.plain_scan_with_state(pods, carry, (1, 1, 1))[0], (None, None, None))
    t0 = time.perf_counter()
    results, rejected = session.solve_gang(gangs)
    gang_wall = time.perf_counter() - t0
    results_p, rejected_p = session_p.solve_gang(gangs_p)
    if (results, rejected) != (results_p, rejected_p):
        fail("churn", "solve_gang with the kernel differs from solve_gang with the plain version")
    if rejected != ["default/tick-gang1"]:
        fail("churn", f"solve_gang rejected {rejected}, expected only default/tick-gang1")
    _check_session_gangs(results, gangs, set(rejected))
    session.solve()  # flush the released rows
    _mirror_check(torch, session, "after solve_gang")

    total = sum(walls)
    return {
        "session": session,
        "cell": f"{N_NODES} nodes, {len(services)} services, {len(assigned)} assigned pods, "
                f"{CHURN_RATE} creates + {CHURN_RATE} deletes a tick",
        "nodes": N_NODES, "services": len(services), "assigned": len(assigned),
        "N_cap": session.N_cap, "n_launch": session.n_launch,
        "session_build_s": build_s, "prewarm_s": prewarm_s, "prewarm_launches": warmed,
        "ticks_timed": len(timed), "ticks_per_s": len(timed) / total,
        "scheduled_pods_per_s": scheduled / total, "scheduled": scheduled,
        "tick_p50_s": _percentile(walls, 50), "tick_p99_s": _percentile(walls, 99),
        "phase_median_s": {p: statistics.median(r.phases_s.get(p, 0.0) for r in timed) for p in phases},
        "kernel_ms_median": statistics.median(kernel_ms[CHURN_WARMUP:]),
        "gc_during_replay": gc_pauses.summary(),
        "launches": launches,
        "ticks": [
            {"tick": i - CHURN_WARMUP + 1 if i >= CHURN_WARMUP else f"warmup{i}",
             "wall_s": r.wall_s, "phases_s": r.phases_s, "kernel_ms": kernel_ms[i],
             "created": CHURN_RATE, "deleted": r.deleted,
             "placed": sum(d is not None for _k, d in r.results)}
            for i, r in enumerate(records)
        ],
        "checks": {
            "mirror_rows_checked_per_tick": checked_rows,
            "held_to_plain_ticks": list(CHURN_CHECKED), "plain_ms": plain_ms,
            "tolerance": "exact (torch.equal, numpy array_equal)",
        },
        "pipelined": {"session_build_s": build_p, "ticks_per_s": len(walls_p) / sum(walls_p),
                      "scheduled_pods_per_s": scheduled / sum(walls_p),
                      "tick_p50_s": _percentile(walls_p, 50), "tick_p99_s": _percentile(walls_p, 99),
                      "launches": launches_p, "equal_to_synchronous": True},
        "solve_gang": {"gangs": len(gangs), "rejected": rejected, "wall_s": gang_wall,
                       "equal_to_plain": True},
        "kernel_at_session_shape": {
            "shape": {"P": int(pods["cpu"].shape[0]), "N": int(carry["cpu_cap"].shape[0]),
                      "S": int(carry["svc_counts"].shape[1]), "SW": int(pods["sel"].shape[1]),
                      "PW": int(pods["port"].shape[1]), "VW": int(pods["vol_any"].shape[1]),
                      "K": int(pods["svc_ids"].shape[1])},
            "plan": {"cluster": plan.cluster, "threads": plan.threads,
                     "nodes_per_cta": plan.nodes_per_cta, "smem_bytes": plan.smem_bytes},
            "ms": ms_shape, "ms_all": ms_all, "plain_ms": plain_ms[CHURN_CHECKED[-1]],
            "per_pod_us": ms_shape * 1e3 / max(bound["placeable_pods"], 1),
            **bound,
            "timed": "the wrapper's launch on the last timed tick's pods and carry",
        },
    }


# ---------------------------------------------------------------------------
# Phase 5c: gang acceptance
# ---------------------------------------------------------------------------


def _grouped_small_cluster(seed):
    """A small_cluster backlog with a third of its pods in groups, some
    of whose minMembers cannot be reached."""
    import random

    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.objects import POD_GROUP_LABEL
    from kubernetes_tpu_torch.scheduler.gang import partition_backlog

    pending, nodes, assigned, services = workload.small_cluster(seed)
    rng = random.Random(seed)
    names = [f"g{i}" for i in range(rng.randint(1, 5))]
    for pod in pending:
        if rng.random() < 0.35:
            pod.metadata.labels[POD_GROUP_LABEL] = rng.choice(names)
    for pod in assigned:
        if rng.random() < 0.3:
            pod.metadata.labels[POD_GROUP_LABEL] = rng.choice(names)
    need = {name: rng.choice([1, 3, 8, 30, None]) for name in names}
    groups = partition_backlog(pending, assigned, lambda ns, n: need[n])
    return pending, nodes, assigned, services, groups


def run_gang(torch, device):
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.objects import POD_GROUP_LABEL
    from kubernetes_tpu_torch.ops import scan_kernel
    from kubernetes_tpu_torch.scheduler.batch import schedule_backlog_gang
    from kubernetes_tpu_torch.scheduler.gang import partition_backlog
    from kubernetes_tpu_torch.utils.tracing import PhaseTimer

    keys = lambda gs: [g.key for g in gs]
    small = []
    for seed in range(8):
        pending, nodes, assigned, services, groups = _grouped_small_cluster(seed)
        scan_kernel.scan_with_state.launches = 0
        got = schedule_backlog_gang(pending, nodes, assigned, services, groups, device=device)
        rounds = scan_kernel.scan_with_state.launches
        ref = schedule_backlog_gang(pending, nodes, assigned, services, groups, device="cpu")
        if got[0] != ref[0] or keys(got[1]) != keys(ref[1]) or keys(got[2]) != keys(ref[2]):
            fail("gang", f"small cluster {seed}: the card and the CPU disagree")
        small.append({"seed": seed, "pods": len(pending), "groups": len(groups),
                      "rejected": len(got[2]), "rounds": rounds})
    if not any(c["rejected"] and c["rounds"] > 1 for c in small):
        fail("gang", "no small case rejected a group and re-solved")

    # The 50k x 5k backlog in groups of 50; in every 100th group one
    # member is pinned to a node that does not exist, so it cannot
    # reach its minMember of 50.
    pending, nodes, services = workload.synthetic_objects(N_PODS, N_NODES, seed=2)
    for i, pod in enumerate(pending):
        g = i // GANG_SIZE
        pod.metadata.labels[POD_GROUP_LABEL] = f"gang{g}"
        if g % 100 == 0 and i % GANG_SIZE == 0:
            pod.spec.node_name = "no-such-node"
    groups = partition_backlog(pending, min_member_of=lambda ns, n: GANG_SIZE)
    timer = PhaseTimer()
    scan_kernel.scan_with_state.launches = 0
    t0 = time.perf_counter()
    dests, accepted, rejected = schedule_backlog_gang(
        pending, nodes, services=services, groups=groups, device=device, timer=timer
    )
    wall = time.perf_counter() - t0
    rounds = scan_kernel.scan_with_state.launches
    if rounds < 2:
        fail("gang", f"the 50k x 5k gang solve took {rounds} round(s), expected at least 2")
    for g in accepted:
        placed = sum(dests[i] is not None for i in g.indices)
        if placed + g.bound < g.min_member:
            fail("gang", f"accepted {g.key} has {placed} placed, under minMember {g.min_member}")
    for g in rejected:
        if any(dests[i] is not None for i in g.indices):
            fail("gang", f"rejected {g.key} kept placements")
    if not accepted or not rejected:
        fail("gang", f"expected accepted and rejected groups, got {len(accepted)} / {len(rejected)}")
    return {
        "small": small,
        "backlog": {
            "pods": N_PODS, "nodes": N_NODES, "groups": len(groups), "group_size": GANG_SIZE,
            "accepted": len(accepted), "rejected": len(rejected),
            "placed": sum(d is not None for d in dests), "rounds": rounds,
            "launches": rounds, "wall_s": wall, "phases_s": timer.seconds,
            "all_or_nothing": True,
        },
    }


# ---------------------------------------------------------------------------
# Phase 5d-5g: policy specs, explain, the sidecar
# ---------------------------------------------------------------------------


# The launch plans every policy_parity case runs at: the default plan,
# clusters of 1 and 4 CTAs, and 1 and 16 CTAs in place (slices, count
# rows and zone sums in device memory).
POLICY_PARITY_PLANS = (
    ("default", {}), ("cluster 1", {"cluster": 1}), ("cluster 4", {"cluster": 4}),
    ("cluster 1 in place", {"cluster": 1, "resident": False}),
    ("cluster 16 in place", {"cluster": 16, "resident": False}),
)


def _policy_kernel_vs_plain(torch, tag, pods, nodes, weights, lspec, phase="policy_parity",
                            plans=POLICY_PARITY_PLANS):
    """The policy kernel at each of `plans` against one run of the plain
    version on the same inputs; returns the largest error and the
    cluster sizes run."""
    from kubernetes_tpu_torch.ops import policy_scan

    pn = _copy(nodes)
    ref, pn = policy_scan.plain_policy_scan_with_state(pods, pn, weights, lspec)
    err, sizes = 0.0, []
    for name, kw in plans:
        plan = policy_scan.plan_for(pods, nodes, lspec, None, kw.get("cluster"), kw.get("resident"))
        kn = _copy(nodes)
        if name == "default":
            got, kn = policy_scan.policy_scan_with_state(pods, kn, weights, lspec)
        else:
            got, kn = policy_scan._launch(pods, kn, weights, lspec, plan)
        torch.cuda.synchronize()
        err = max(err, _compare(torch, f"{tag}, {name} ({plan.cluster} CTAs)", got, kn, ref, pn,
                                phase=phase))
        sizes.append(plan.cluster)
    return err, sizes


def _policy_edge_cases(torch, device):
    """The cluster's edges under policies, as (tag, pods, nodes, weights,
    lspec): ties between nodes of different CTAs and pods that fit
    nowhere between placed ones; zones with nodes in every CTA; anchors
    in other CTAs' slices; fewer nodes than CTAs; two anti-affinity
    instances, one of weight 0; crowded services whose every step
    exchanges the zone sums; 4-word port bitsets, which take the
    kernel's runtime-width instance; a zone label with a value per
    node."""
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.algspec import spec_from_policy
    from kubernetes_tpu_torch.models.columnar import build_snapshot
    from kubernetes_tpu_torch.ops.matrices import device_snapshot

    def objects(policy, n_pods, n_nodes, seed, host_ports=0, host_label=False):
        pending, nodes, assigned, services = workload.policy_objects(
            n_pods, n_nodes, seed=seed, host_ports=host_ports)
        for j, node in enumerate(nodes if host_label else ()):
            node.metadata.labels["host"] = f"h{j}"
        d = device_snapshot(build_snapshot(pending, nodes, assigned, services,
                                           spec=spec_from_policy(policy)), device, 1)
        return d.pods, d.nodes, d.weights, d.lowered

    full = workload.FULL_VOCABULARY_POLICY
    pods, nodes, weights, lspec = objects(full, 600, 45, 11)
    pods["pinned"][1::9] = -2
    pods["pinned"][2::13] = 45 + 3
    pods["pinned"][3::9] = -2
    yield "ties and unplaceable pods", pods, nodes, weights, lspec
    rack = {"predicates": workload.POLICY_SHAPES["anti_affinity_one"]["predicates"],
            "priorities": [{"name": "LeastRequestedPriority", "weight": 1},
                           {"name": "spread-rack", "weight": 2,
                            "argument": {"serviceAntiAffinity": {"label": "rack"}}}]}
    yield ("zones with nodes in every CTA", *objects(rack, 400, 40, 3))
    yield ("anchors in other CTAs", *objects(workload.POLICY_SHAPES["service_affinity"], 600, 40, 5))
    for n in (1, 3, 13):
        yield (f"{n} nodes, fewer than the CTAs", *objects(full, 200, n, 6))
    pods, nodes, weights, lspec = objects(workload.POLICY_SHAPES["anti_affinity_one"], 300, 40, 2)
    nz = lspec.aa_zones[0]
    lspec = lspec._replace(aa_weights=(0, lspec.aa_weights[0]), aa_zones=(nz, nz))
    nodes = dict(nodes, aa_zone=nodes["aa_zone"].repeat(1, 2).contiguous())
    yield "two instances, one of weight 0", pods, nodes, weights, lspec
    pending, nodes, services = workload.synthetic_objects(400, 6, seed=9)
    for j, node in enumerate(nodes):
        node.metadata.labels["rack"] = f"r{j % 3}"
    d = device_snapshot(build_snapshot(pending, nodes, services=services,
                                       spec=spec_from_policy(full)), device, 1)
    yield "crowded services on 6 nodes", d.pods, d.nodes, d.weights, d.lowered
    pods, nodes, weights, lspec = objects(full, 400, 40, 7, host_ports=70)
    widths = tuple(pods[k].shape[1] for k in ("sel", "port", "vol_any", "svc_ids"))
    if widths == (2, 2, 2, 8):
        fail("policy_parity", "the 70-port case lowered to the unrolled widths")
    yield "4-word port bitsets (runtime widths)", pods, nodes, weights, lspec
    host = {"predicates": workload.POLICY_SHAPES["anti_affinity_one"]["predicates"],
            "priorities": [{"name": "LeastRequestedPriority", "weight": 1},
                           {"name": "spread-host", "weight": 3,
                            "argument": {"serviceAntiAffinity": {"label": "host"}}}]}
    yield ("a zone per node", *objects(host, 600, 200, 4, host_label=True))


def check_policy_parity(torch, device):
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.algspec import spec_from_policy
    from kubernetes_tpu_torch.models.columnar import build_snapshot
    from kubernetes_tpu_torch.ops import policy_scan
    from kubernetes_tpu_torch.ops.matrices import device_snapshot

    cases, runs, max_err, shapes, sizes = 0, 0, 0.0, {}, set()
    for shape, policy in workload.POLICY_SHAPES.items():
        spec = spec_from_policy(policy)
        for seed in range(4):
            pending, nodes, assigned, services = workload.policy_cluster(seed)
            d = device_snapshot(build_snapshot(pending, nodes, assigned, services, spec=spec), device)
            err, ran = _policy_kernel_vs_plain(
                torch, f"{shape} seed {seed}", d.pods, d.nodes, d.weights, d.lowered)
            max_err, cases, runs = max(max_err, err), cases + 1, runs + len(ran)
            sizes.update(ran)
        shapes[shape] = str(d.lowered)
    for tag, pods, nodes, weights, lspec in _policy_edge_cases(torch, device):
        err, ran = _policy_kernel_vs_plain(torch, tag, pods, nodes, weights, lspec)
        max_err, cases, runs = max(max_err, err), cases + 1, runs + len(ran)
        sizes.update(ran)
    # Past the eight instances and eight labels the kernel keeps in its
    # arguments and registers: 9 and 12 anti-affinity instances and 9
    # affinity labels on 40 nodes at every plan, and 9 instances on the
    # policy backlog's 5,000 nodes at the default plan.
    before = policy_scan.policy_scan_with_state.launches
    past_8 = []
    for n_aa, n_aff, n_pods, n_nodes, plans in ((9, 1, 400, 40, POLICY_PARITY_PLANS),
                                                (12, 1, 400, 40, POLICY_PARITY_PLANS),
                                                (1, 9, 400, 40, POLICY_PARITY_PLANS),
                                                (12, 9, 400, 40, POLICY_PARITY_PLANS),
                                                (9, 1, 1024, 5000, POLICY_PARITY_PLANS[:1])):
        pending, nodes, assigned, services = workload.wide_objects(n_pods, n_nodes, seed=3)
        spec = spec_from_policy(workload.wide_policy(n_aa, n_aff))
        d = device_snapshot(build_snapshot(pending, nodes, assigned, services, spec=spec), device, 1)
        tag = f"{n_aa} anti-affinity instances, {n_aff} affinity labels, {n_nodes} nodes"
        err, ran = _policy_kernel_vs_plain(torch, tag, d.pods, d.nodes, d.weights, d.lowered,
                                           plans=plans)
        max_err, cases, runs = max(max_err, err), cases + 1, runs + len(ran)
        sizes.update(ran)
        past_8.append(tag)
    past_8_launches = policy_scan.policy_scan_with_state.launches - before
    # The last case timed at its default plan, beside the same pods under
    # the full vocabulary's one instance.
    ms, _, _ = _policy_time_ms(torch, d.pods, d.nodes, d.weights, d.lowered, 3)
    plan = policy_scan.plan_for(d.pods, d.nodes, d.lowered)
    bound = policy_kernel_bound(torch, d.pods, d.nodes, d.lowered)
    one = d.lowered._replace(aa_weights=d.lowered.aa_weights[:1], aa_zones=d.lowered.aa_zones[:1])
    one_nodes = dict(d.nodes, aa_zone=d.nodes["aa_zone"][:, :1].contiguous())
    ms_one, _, _ = _policy_time_ms(torch, d.pods, one_nodes, d.weights, one, 3)
    past_8_timing = {"case": tag, "ms": ms, "per_pod_us": ms * 1e3 / max(bound["placeable_pods"], 1),
                     "cluster": plan.cluster, "resident": plan.resident,
                     "one_instance_ms": ms_one, **bound}
    return {"cases": cases, "kernel_runs": runs, "cluster_sizes": sorted(sizes),
            "past_8": {"cases": past_8, "launches": past_8_launches, "timed": past_8_timing},
            "plans": [name for name, _ in POLICY_PARITY_PLANS], "shapes": shapes,
            "max_abs_err": max_err,
            "tolerance": "exact (torch.equal; anchor and svc_total included)"}


def policy_kernel_bound(torch, pods, carry, lspec):
    """The least time the card could take for one policy scan launch on
    these inputs: the larger of the bytes it must move over the HBM rate
    and the operations it must do over the f32 rate."""
    P, N = pods["cpu"].shape[0], carry["cpu_cap"].shape[0]
    SW, PW = pods["sel"].shape[1], pods["port"].shape[1]
    VW, K = pods["vol_any"].shape[1], pods["svc_ids"].shape[1]
    S = carry["svc_counts"].shape[1]
    KA = pods["aff_pin"].shape[1] if lspec.service_affinity else 0
    I = len(lspec.aa_weights)
    SA = carry["anchor"].shape[0] if "anchor" in carry else 0
    # Bytes: every input read once, every output written once. Pods:
    # cpu, mem, pinned, svc (4 B), zero_req (1 B), bitset words, service
    # ids and affinity pins (4 B each); node constants with the policy
    # columns (policy_ok 1 B, static_prio, aff_vid, aa_zone 4 B each);
    # the carry in and out (the service carry included); the choices.
    pod_bytes = P * (4 * 4 + 1 + 4 * (SW + PW + 2 * VW + K + KA))
    const_bytes = N * (3 * 4 + 2 + 4 * SW + 1 + 4 + 4 * KA + 4 * I)
    carry_bytes = N * (5 * 4 + 4 * (PW + 2 * VW) + 4 * S) + 8 * SA
    nbytes = pod_bytes + const_bytes + 2 * carry_bytes + 4 * P
    # Operations per (pod, node) pair, counted from the plain version's
    # arithmetic: the scan kernel's count (kernel_bound), plus the label
    # mask 1, static priority 1, 3 per affinity label, and per
    # anti-affinity instance 10 (zone test and sum, the zone's count,
    # the score's division and select, the weighted add). Only pods some
    # node could take need pairs.
    ops_per_pair = 13 + 2 + 4 + 12 + 14 + 4 + 5 + 3 + 2 * SW + 2 * PW + 4 * VW
    ops_per_pair += 2 + 3 * KA + 10 * I
    pin = pods["pinned"]
    placeable = int(((pin == -1) | ((pin >= 0) & (pin < N))).sum().item()) if lspec.hostname else P
    nops = placeable * N * ops_per_pair
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / F32_OPS_PER_S * 1e3
    return {
        "bytes": nbytes, "ops": nops, "placeable_pods": placeable,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def _policy_time_ms(torch, pods, carry, weights, lspec, reps, plan=None):
    """Median CUDA-event ms of `reps` policy kernel launches after a
    warm-up, each from a fresh copy of `carry`; and the last result."""
    from kubernetes_tpu_torch.ops import policy_scan

    times, out = [], None
    for _ in range(reps + 1):
        nodes = _copy(carry)
        torch.cuda.synchronize()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = policy_scan._launch(pods, nodes, weights, lspec, plan)
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
    return statistics.median(times[1:]), times[1:], out


def run_policy(torch, device):
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.algspec import spec_from_policy
    from kubernetes_tpu_torch.models.columnar import build_snapshot
    from kubernetes_tpu_torch.ops import policy_scan, scan_kernel
    from kubernetes_tpu_torch.ops.matrices import device_snapshot
    from kubernetes_tpu_torch.scheduler.batch import schedule_backlog
    from kubernetes_tpu_torch.utils.tracing import PhaseTimer

    spec = spec_from_policy(workload.FULL_VOCABULARY_POLICY)
    t0 = time.perf_counter()
    pending, nodes, assigned, services = workload.policy_objects(N_PODS, N_NODES, seed=2)
    objects_s = time.perf_counter() - t0
    runs, names = [], None
    for r in range(POLICY_REPEATS + 1):
        timer = PhaseTimer()
        torch.cuda.synchronize()
        policy_scan.policy_scan_with_state.launches = 0
        scan_kernel.scan_with_state.launches = 0
        t0 = time.perf_counter()
        got = schedule_backlog(pending, nodes, assigned, services, device=device, timer=timer,
                               spec=spec)
        wall = time.perf_counter() - t0
        launches = policy_scan.policy_scan_with_state.launches
        if launches != 1 or scan_kernel.scan_with_state.launches:
            fail("policy", f"the policy backlog made {launches} policy kernel launches and "
                           f"{scan_kernel.scan_with_state.launches} scan kernel launches, expected 1 and 0")
        node_names = {n.metadata.name for n in nodes}
        if len(got) != N_PODS or any(n is not None and n not in node_names for n in got):
            fail("policy", "result has the wrong length or unknown node names")
        if names is None:
            names = got
        elif got != names:
            fail("policy", f"run {r}: {sum(a != b for a, b in zip(got, names))} decisions differ "
                           "from the first run's")
        runs.append({"run": "warmup" if r == 0 else f"timed{r}", "wall_s": wall,
                     "placed": sum(n is not None for n in got), "launches": launches,
                     "phases_s": timer.seconds})
    placed = runs[-1]["placed"]
    if placed == 0:
        fail("policy", "no pod placed")

    # The kernel alone on the whole backlog, and the first POLICY_CHECKED
    # pods against the plain version, decisions and carry.
    d = device_snapshot(build_snapshot(pending, nodes, assigned, services, spec=spec), device)
    ms_all_pods, _, (choice, _) = _policy_time_ms(torch, d.pods, d.nodes, d.weights, d.lowered, 1)
    index = {n.metadata.name: j for j, n in enumerate(nodes)}
    if [index[n] if n is not None else -1 for n in names] != choice[:N_PODS].tolist():
        fail("policy", "schedule_backlog disagrees with the kernel launched on its snapshot")
    head = {k: v[:POLICY_CHECKED].contiguous() for k, v in d.pods.items()}
    ms, ms_runs, (got, got_nodes) = _policy_time_ms(torch, head, d.nodes, d.weights, d.lowered, 3)
    ref_nodes = _copy(d.nodes)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    ref, ref_nodes = policy_scan.plain_policy_scan_with_state(head, ref_nodes, d.weights, d.lowered)
    ev1.record()
    torch.cuda.synchronize()
    plain_ms = ev0.elapsed_time(ev1)
    err = _compare(torch, f"first {POLICY_CHECKED} pods of the policy backlog", got, got_nodes,
                   ref, ref_nodes, phase="policy")
    if got.tolist() != choice[:POLICY_CHECKED].tolist():
        fail("policy", "the kernel on the first pods disagrees with its run on the whole backlog")
    bound = policy_kernel_bound(torch, head, d.nodes, d.lowered)
    full_bound = policy_kernel_bound(torch, d.pods, d.nodes, d.lowered)
    plan = policy_scan.plan_for(d.pods, d.nodes, d.lowered)
    if plan.cluster < 2:
        fail("policy", f"the policy backlog's plan is a cluster of {plan.cluster} CTA")
    timed = [x["wall_s"] for x in runs[1:]]
    return {
        "backlog": f"{N_PODS} pods x {N_NODES} nodes, {len(services)} services, "
                   f"{len(assigned)} bound peers, FULL_VOCABULARY_POLICY",
        "lowered": str(d.lowered), "weights": list(d.weights),
        "objects_s": objects_s,
        "runs": runs,
        "wall_s_median": statistics.median(timed),
        "pods_per_s_median": N_PODS / statistics.median(timed),
        "placed": placed,
        "launches_last_run": runs[-1]["launches"],
        "identical_runs": len(runs),
        "kernel_ms": ms_all_pods,
        "kernel_per_pod_us": ms_all_pods * 1e3 / max(full_bound["placeable_pods"], 1),
        "kernel_bound_ms": full_bound["bound_ms"],
        "plan": {"cluster": plan.cluster, "nodes_per_cta": plan.nodes_per_cta,
                 "threads": plan.threads, "smem_bytes": plan.smem_bytes,
                 "resident": plan.resident, "zone_bins": plan.zone_bins,
                 "row_words": plan.row_words,
                 "max_active_clusters": policy_scan.occupancy(plan, d.pods, d.nodes, d.lowered)},
        "shape": {"P": int(d.pods["cpu"].shape[0]), "N": int(d.nodes["cpu_cap"].shape[0]),
                  "S": int(d.nodes["svc_counts"].shape[1]), "SA": int(d.nodes["anchor"].shape[0])},
        "checked_against_plain": POLICY_CHECKED,
        "names": names,
        "sweep_state": (head, d.nodes, d.weights, d.lowered),
        "timing": {
            "ms": ms, "ms_all": ms_runs, "plain_ms": plain_ms, "max_abs_err": err,
            "per_pod_us": ms * 1e3 / max(bound["placeable_pods"], 1), **bound,
            "timed": f"the wrapper's launch on the first {POLICY_CHECKED} pods of the policy "
                     "backlog and its staged carry, layout conversion included",
        },
    }


POLICY_SWEEP_NODES = (1024, 5120, 20480)
POLICY_SWEEP_CLUSTERS = (1, 4, 8, 16)
#: Pods of each sweep row held to the plain version.
SWEEP_CHECKED = 256


def _node_axis(nodes, n):
    """The node columns cut or repeated to n nodes (the service carry,
    indexed by service, unchanged)."""
    from kubernetes_tpu_torch.ops.matrices import POLICY_CARRY_KEYS

    N = nodes["cpu_cap"].shape[0]
    return {k: v if k in POLICY_CARRY_KEYS else v.repeat((-(-n // N),) + (1,) * (v.dim() - 1))[:n].contiguous()
            for k, v in nodes.items()}


def time_policy_kernel(torch, state):
    """K1P's µs a pod on the policy backlog's first pods, against the
    first 1,024, the 5,120 and those repeated to 20,480 nodes, for a spec
    with no anti-affinity (one cluster barrier a step), with one
    instance and nothing else of the policy, and the full vocabulary (a
    second barrier on every step with peers), on clusters of 1, 4, 8
    and 16 CTAs. Every configuration's decisions and carry must equal
    the default plan's on the same inputs, and the default plan must
    equal the plain version on the first SWEEP_CHECKED pods."""
    from kubernetes_tpu_torch.models.algspec import LoweredSpec
    from kubernetes_tpu_torch.ops import policy_scan
    from kubernetes_tpu_torch.ops.matrices import CARRY_KEYS, POLICY_CARRY_KEYS

    pods, nodes0, weights, full = state
    P = pods["cpu"].shape[0]
    specs = {
        "no_anti_affinity": full._replace(aa_weights=(), aa_zones=()),
        "one_instance": LoweredSpec(aa_weights=full.aa_weights, aa_zones=full.aa_zones),
        "full_vocabulary": full,
    }
    out, plans = {}, {}
    for tag, lspec in specs.items():
        out[tag] = {}
        for n in POLICY_SWEEP_NODES:
            nodes = _node_axis(nodes0, n)
            base = policy_scan.plan_for(pods, nodes, lspec)
            head = {k: v[:SWEEP_CHECKED].contiguous() for k, v in pods.items()}
            _policy_kernel_vs_plain(torch, f"sweep {tag} at {n} nodes, first {SWEEP_CHECKED} pods",
                                    head, nodes, weights, lspec, "kernel_timing",
                                    (("default", {}),))
            _, _, (ref, ref_nodes) = _policy_time_ms(torch, pods, nodes, weights, lspec, 1, base)
            row = {}
            for C in POLICY_SWEEP_CLUSTERS:
                plan = policy_scan.plan_for(pods, nodes, lspec, None, C)
                ms, _, (got, got_nodes) = _policy_time_ms(torch, pods, nodes, weights, lspec, 2, plan)
                for k in ("choice",) + CARRY_KEYS + POLICY_CARRY_KEYS:
                    a, b = (got, ref) if k == "choice" else (got_nodes.get(k), ref_nodes.get(k))
                    if a is not None and not torch.equal(a, b):
                        fail("kernel_timing", f"K1P {tag} at {n} nodes: {C} CTAs differ from "
                                              f"{base.cluster} in {k}")
                row[C] = ms * 1e3 / P
                plans[f"{tag}/{n}/{C}"] = {"resident": plan.resident, "threads": plan.threads,
                                          "smem_bytes": plan.smem_bytes}
            out[tag][n] = row
    return {"pods": P, "per_pod_us": out, "plans": plans,
            "checked_against_plain": f"the default plan of each row on its first {SWEEP_CHECKED} pods",
            "split_per_pod_us": _policy_step_split(torch, pods, nodes0, weights, full),
            "timed": "the wrapper's launch on the policy backlog's first pods, layout "
                     "conversion included; the carry cut or repeated to the node count"}


def _policy_step_split(torch, pods, nodes, weights, full):
    """Where a K1P step's time goes, at the default plan on the same pods
    and nodes: the scan kernel (K1) on the default spec, then K1P on the
    base predicates without and with the service carry, with service
    affinity (anchors read, and all pods pinned so that none is), with
    anti-affinity and no carry (no peers: one barrier a step) and with
    the carry (the zone exchange and a second barrier), and the full
    vocabulary. Not held to the plain version: the specs differ from the
    checked ones, and each kernel is checked elsewhere."""
    from kubernetes_tpu_torch.models.algspec import LoweredSpec
    from kubernetes_tpu_torch.ops import policy_scan
    from kubernetes_tpu_torch.ops.matrices import POLICY_CARRY_KEYS

    P = pods["cpu"].shape[0]
    bare = {k: v for k, v in nodes.items() if k not in POLICY_CARRY_KEYS}
    pinned = dict(pods, aff_pin=torch.zeros_like(pods["aff_pin"]))
    aa = LoweredSpec(aa_weights=full.aa_weights, aa_zones=full.aa_zones)
    variants = {
        "base": (pods, bare, LoweredSpec()),
        "base_with_service_carry": (pods, nodes, LoweredSpec()),
        "service_affinity": (pods, nodes, LoweredSpec(service_affinity=True)),
        "service_affinity_all_pinned": (pinned, nodes, LoweredSpec(service_affinity=True)),
        "anti_affinity_without_peers": (pods, bare, aa),
        "anti_affinity": (pods, nodes, aa),
        "full_vocabulary": (pods, nodes, full),
    }
    ms, _, _ = _time_ms(torch, pods, bare, None, 3)
    split = {"scan_kernel_default_spec": ms * 1e3 / P}
    for tag, (p, n, lspec) in variants.items():
        ms, _, _ = _policy_time_ms(torch, p, n, weights, lspec, 3)
        split[tag] = ms * 1e3 / P
    return split


def run_explain(torch, device):
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.ops.pipeline import explain_backlog

    pending, nodes, assigned, services = workload.policy_objects(N_PODS, N_NODES, seed=2)
    pods = pending[:EXPLAIN_PODS]
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = explain_backlog(pods, nodes, assigned, services, device=device)
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    ref = explain_backlog(pods, nodes, assigned, services, device="cpu")
    cpu_s = time.perf_counter() - t0
    if got != ref:
        bad = sum(a != b for a, b in zip(got, ref))
        fail("explain", f"{bad} of {len(ref)} explain entries differ between the card and the CPU")
    return {
        "pods": len(pods), "nodes": len(nodes),
        "ms_median": statistics.median(times[1:]) * 1e3, "ms_all": [t * 1e3 for t in times],
        "cpu_ms": cpu_s * 1e3,
        "feasible_nodes_median": statistics.median(e["feasibleNodes"] for e in got),
        "equal_to_cpu": True,
        "timed": "explain_backlog wall (lowering, staging, the batched readback, the per-pod "
                 "dicts); first call a warm-up",
    }


def _stop_process(proc):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


def run_sidecar(torch, device, default_names, policy_names):
    """The port's sidecar as a subprocess on the card, driven by the
    port's own client with the default and the policy 50k backlogs, and
    the default one in modes wave and sinkhorn."""
    import socket

    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.algspec import spec_from_policy
    from kubernetes_tpu_torch.models.columnar import build_snapshot
    from kubernetes_tpu_torch.ops import sidecar
    from kubernetes_tpu_torch.scheduler.batch import schedule_backlog_sinkhorn, schedule_backlog_wave

    proc, sock_path = None, None
    t0 = time.perf_counter()
    try:
        proc, sock_path = sidecar.spawn_sidecar(wait=SIDECAR_WAIT_S)
        start_s = time.perf_counter() - t0
        client = sidecar.SidecarSolver(sock_path, timeout=SIDECAR_WAIT_S)
        spec = spec_from_policy(workload.FULL_VOCABULARY_POLICY)
        pending, nodes, services = workload.synthetic_objects(N_PODS, N_NODES, seed=2)
        ppending, pnodes, passigned, pservices = workload.policy_objects(N_PODS, N_NODES, seed=2)
        cases = {
            "default": ((pending, nodes, (), services), None, default_names),
            "policy": ((ppending, pnodes, passigned, pservices), spec, policy_names),
        }
        out = {"start_s": start_s}
        # The server's first request loads the kernels and warms its card.
        client.solve(*cases["default"][0])
        for tag, (objs, spec_, expected) in cases.items():
            snap = build_snapshot(*objs, spec=spec_)
            header, arrays = sidecar._encode({"op": "solve", "mode": "scan",
                                              **sidecar._snapshot_payload(snap)})
            walls = []
            # The server counts each solve's launches from 0 and returns
            # them with the reply.
            want = {"scan_kernel": int(spec_ is None), "policy_scan_kernel": int(spec_ is not None)}
            for _ in range(2):
                t0 = time.perf_counter()
                got = client.solve(*objs, spec=spec_)
                walls.append(time.perf_counter() - t0)
                if got != expected:
                    bad = sum(a != b for a, b in zip(got, expected))
                    fail("sidecar", f"{tag}: {bad} decisions differ from in-process schedule_backlog")
                if client.last_kernel_launches != want:
                    fail("sidecar", f"{tag}: the server's solve launched "
                                    f"{client.last_kernel_launches}, expected {want}")
            out[tag] = {"round_trip_s": walls, "round_trip_s_min": min(walls),
                        "request_frame_bytes": 18 + len(header) + sum(a.nbytes for a in arrays),
                        "kernel_launches": client.last_kernel_launches,
                        "equal_to_in_process": True}
        # The JAX daemon's --batch-mode wave|sinkhorn requests: each reply
        # equals the same solve in this process, on the same card.
        none = {"scan_kernel": 0, "policy_scan_kernel": 0}
        for mode, local in (("wave", schedule_backlog_wave), ("sinkhorn", schedule_backlog_sinkhorn)):
            objs = cases["default"][0]
            t0 = time.perf_counter()
            got = client.solve(*objs, mode=mode)
            wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = local(*objs, device=device)
            local_s = time.perf_counter() - t0
            if got != want:
                bad = sum(a != b for a, b in zip(got, want))
                fail("sidecar", f"{mode}: {bad} decisions differ from the in-process solve")
            if client.last_kernel_launches != none:
                fail("sidecar", f"{mode}: the server launched {client.last_kernel_launches}")
            out[mode] = {"round_trip_s": wall, "in_process_s": local_s,
                         "placed": sum(n is not None for n in got), "equal_to_in_process": True}
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(10)
        s.connect(sock_path)
        s.sendall(b"GARBAGE" * 100)
        s.close()
        if not client.ping():
            fail("sidecar", "the server did not answer a ping after a garbage frame")
        out["alive_after_garbage"] = True
        out["timed"] = ("SidecarSolver.solve wall: client-side lowering, the frame both ways, the "
                        "server's staging, solve and readback")
        return out
    except sidecar.SidecarError as e:
        fail("sidecar", f"sidecar failure: {e}")
    finally:
        if proc is not None:
            _stop_process(proc)
            shutil.rmtree(os.path.dirname(sock_path), ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 5h-5i: the windowed solvers, wave and Sinkhorn
# ---------------------------------------------------------------------------

WINDOWED_CHECK = (8192, 1024, 7)  # pods, nodes, seed of the backlog held card against CPU
WINDOWED_TICKS = 3  # churn ticks of the session in each windowed mode
PRICE_ATOL = 1e-4  # Sinkhorn's prices and residual, card against CPU, as in the CPU tests
AGREEMENT = 0.99  # Sinkhorn's share of pods on the CPU run's node
# tests/test_quality_regression.py: TestWaveQuality and TestSinkhornQuality.
QUALITY = {"wave": {"mean_regret": 1.5, "p99_regret": 5, "greedy_match": 0.30},
           "sinkhorn": {"mean_regret": 1.5, "p99_regret": 10, "greedy_match": 0.25}}


def _windowed_with_state(mode, pods, nodes, window=4096):
    """(assignment, waves, iterations, residual) of one windowed solve,
    committing into `nodes`; the last two None for the wave."""
    from kubernetes_tpu_torch.ops import sinkhorn, wave

    if mode == "wave":
        a, _, w = wave.solve_waves_with_state(pods, nodes, window=window)
        return a, w, None, None
    a, _, w, it, res = sinkhorn.solve_sinkhorn_with_state(pods, nodes, window=window)
    return a, w, int(it), float(res)


def _assignment_of(snap, names):
    """Node names back to the snapshot's node indices (-1 unplaced)."""
    import numpy as np

    index = {n: j for j, n in enumerate(snap.nodes.names)}
    return np.array([index[n] if n is not None else -1 for n in names], np.int32)


def _valid(phase, snap, assignment, tag):
    from kubernetes_tpu_torch.ops import oracle

    try:
        oracle.validate_assignment_numpy(snap, assignment)
    except AssertionError as e:
        fail(phase, f"{tag}: invalid placement: {e}")


def _card_vs_cpu(torch, device, mode, tag, snap, window, validate=True):
    """One windowed solve of `snap` on the card and on the CPU. The wave
    must be equal (assignment, nine carry fields, waves); Sinkhorn must
    agree on AGREEMENT of the pods and, where every decision agrees, on
    its waves, iterations and residual. With `validate`, the card's
    placements must pass the oracle's validity replay."""
    import numpy as np

    from kubernetes_tpu_torch.ops.matrices import CARRY_KEYS, device_snapshot, state_to_numpy
    from kubernetes_tpu_torch.ops.wave import strip_assignments

    # Staging on the CPU shares the snapshot's arrays: the solves commit
    # into copies, so the snapshot stays the one the oracle replays.
    dc, dh = device_snapshot(snap, device), device_snapshot(snap, "cpu")
    card_nodes, cpu_nodes = _copy(dc.nodes), _copy(dh.nodes)
    t0 = time.perf_counter()
    card = _windowed_with_state(mode, dc.pods, card_nodes, window)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = _windowed_with_state(mode, dh.pods, cpu_nodes, window)
    cpu_s = time.perf_counter() - t0
    a_card, a_cpu = card[0].cpu().numpy(), cpu[0].numpy()
    agree = float((a_card == a_cpu).mean())
    if mode == "wave":
        if agree < 1.0 or card[1] != cpu[1]:
            fail(mode, f"{tag}: the card's wave differs from the CPU's "
                       f"({agree:.4f} of the pods agree, waves {card[1]} and {cpu[1]})")
        got, want = state_to_numpy(card_nodes), state_to_numpy(cpu_nodes)
        for k in CARRY_KEYS:
            if not np.array_equal(got[k], want[k]):
                fail(mode, f"{tag}: carry field {k} differs between the card and the CPU")
    else:
        if agree < AGREEMENT:
            fail(mode, f"{tag}: only {agree:.4f} of the pods agree between the card and the CPU")
        if agree == 1.0 and (card[1:3] != cpu[1:3] or abs(card[3] - cpu[3]) > PRICE_ATOL):
            fail(mode, f"{tag}: equal decisions but telemetry {card[1:]} against {cpu[1:]}")
    if validate:
        _valid(mode, snap, strip_assignments(dc, card[0]), tag)
    return {"case": tag, "window": window, "agreement": agree,
            "waves": card[1], "iterations": card[2], "residual": card[3],
            "cpu": {"waves": cpu[1], "iterations": cpu[2], "residual": cpu[3]},
            "card_s": card_s, "cpu_s": cpu_s}


def _congested_matrix(seed, W=64, N=12):
    """A masked score matrix where many pods want a few nodes of small
    pod-count capacity (the CPU tests' case)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    masked = rng.integers(0, 31, size=(W, N)).astype(np.float32)
    masked[:, :3] += 10
    masked[rng.random((W, N)) < 0.3] = -1
    masked[:4] = -1
    return masked, rng.random(W) < 0.9, rng.choice([0, 1, 2, 5], size=N).astype(np.float32)


def _prices_card_vs_cpu(torch, device, snap):
    """Sinkhorn's congestion prices on the same inputs on the card and
    the CPU: the congested matrices of the CPU tests, and the first
    window of `snap` against its nodes. Iterations run must be equal, the
    prices and residual within PRICE_ATOL."""
    from kubernetes_tpu_torch.ops import sinkhorn, wave
    from kubernetes_tpu_torch.ops.matrices import device_snapshot

    cases = []
    for seed in range(4):
        masked, valid, capacity = _congested_matrix(seed)
        for iters, tol in ((8, 0.0), (20, 0.0), (20, 1.0)):
            cases.append((f"congested seed {seed}, {iters} iterations, tol {tol}",
                          torch.from_numpy(masked), torch.from_numpy(valid),
                          torch.from_numpy(capacity), iters, tol))
    d = device_snapshot(snap, "cpu")
    W = min(4096, d.pods["cpu"].shape[0])
    idx = torch.arange(W, dtype=torch.int32)
    feas, score = wave._batched_eval(wave._window_rows(d.pods, idx), d.nodes, (1, 1, 1))
    masked = torch.where(feas, score, -1).to(torch.float32)
    capacity = (d.nodes["pods_cap"] - d.nodes["pods_used"]).clamp(min=0.0)
    cases.append(("the first window of the checked backlog", masked, idx < d.pods["cpu"].shape[0],
                  capacity, 8, 0.0))
    worst, out = 0.0, []
    for tag, masked, valid, capacity, iters, tol in cases:
        gh, ih, rh = sinkhorn._congestion_prices(masked, valid, capacity, 2.0, iters, tol)
        gc, ic, rc = sinkhorn._congestion_prices(masked.to(device), valid.to(device),
                                                 capacity.to(device), 2.0, iters, tol)
        err = float((gc.cpu() - gh).abs().max())
        rerr = abs(float(rc) - float(rh))
        if int(ic) != int(ih) or err > PRICE_ATOL or rerr > PRICE_ATOL:
            fail("sinkhorn", f"prices, {tag}: iterations {int(ic)} and {int(ih)}, price error "
                             f"{err}, residual error {rerr} (tolerance {PRICE_ATOL})")
        worst = max(worst, err, rerr)
        out.append({"case": tag, "iterations": int(ic), "residual": float(rc)})
    return {"cases": out, "max_abs_err": worst, "tolerance": PRICE_ATOL}


def _profile_windowed(torch, device, mode):
    """The first pipeline chunk of the 50k x 5k backlog (12,544 pods on
    its fresh node carry) solved once under torch.profiler: the host
    wall, the device time the trace holds (the sum of each operation's
    own device time), their ratio as the device's busy share, and the
    operations that hold most of the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.columnar import SnapshotBuilder
    from kubernetes_tpu_torch.ops.matrices import device_nodes, device_pods
    from kubernetes_tpu_torch.ops.pipeline import DEFAULT_CHUNK

    pending, nodes, services = workload.synthetic_objects(N_PODS, N_NODES, seed=2)
    builder = SnapshotBuilder(pending, nodes, (), services)
    carry = device_nodes(builder.node_columns(), device)
    pods = device_pods(builder.pod_columns(0, DEFAULT_CHUNK), device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, waves, _, _ = _windowed_with_state(mode, pods, carry)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    # The kernels' own rows: an operator's row repeats its kernels' time.
    rows = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=device_us, reverse=True)
    device_ms = sum(device_us(e) for e in rows) / 1e3
    return {
        "chunk_pods": DEFAULT_CHUNK, "waves": waves, "wall_ms": wall * 1e3,
        "wall_ms_per_wave": wall * 1e3 / max(waves, 1), "device_ms": device_ms,
        "device_busy_share": device_ms / (wall * 1e3),
        "kernel_launches": sum(e.count for e in rows),
        "top_kernels": [{"kernel": e.key[:120], "device_ms": device_us(e) / 1e3, "calls": e.count}
                        for e in rows[:10]],
        "timed": "host clock around one chunk's solve ending in a synchronise, under the profiler",
    }


def run_windowed(torch, device, mode, placed_names, scan_placed):
    """The windowed mode end to end: card against CPU, then the 50k x 5k
    pipeline, then the session's churn ticks."""
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.columnar import build_snapshot
    from kubernetes_tpu_torch.ops import SolverSession, oracle, policy_scan, scan_kernel
    from kubernetes_tpu_torch.ops.pipeline import solve_backlog_pipelined
    from kubernetes_tpu_torch.utils.tracing import PhaseTimer

    out = {"card_vs_cpu": []}
    # The small clusters have assigned pods past their nodes' capacity:
    # the oracle's validity replay refuses a zero-request pod on such an
    # overcommitted node, which the reference's predicates (and the scan)
    # allow, so these are held card against CPU only; validity is checked
    # on the synthetic backlogs below, which have no overcommitted node.
    for seed in range(8):
        pending, nodes, assigned, services = workload.small_cluster(seed)
        snap = build_snapshot(pending, nodes, assigned, services)
        for window in (32, 4096):
            out["card_vs_cpu"].append(_card_vs_cpu(torch, device, mode, f"small seed {seed}", snap,
                                                   window, validate=False))
    n_pods, n_nodes, seed = WINDOWED_CHECK
    pending, nodes, services = workload.synthetic_objects(n_pods, n_nodes, seed=seed)
    snap = build_snapshot(pending, nodes, services=services)
    out["card_vs_cpu"].append(_card_vs_cpu(torch, device, mode, f"{n_pods} x {n_nodes}", snap, 4096))
    if mode == "sinkhorn":
        out["prices"] = _prices_card_vs_cpu(torch, device, snap)

    runs = []
    for r in range(MAIN_REPEATS + 1):
        pending, nodes, services = workload.synthetic_objects(N_PODS, N_NODES, seed=2 + r)
        timer = PhaseTimer()
        torch.cuda.synchronize()
        scan_kernel.scan_with_state.launches = policy_scan.policy_scan_with_state.launches = 0
        t0 = time.perf_counter()
        names = solve_backlog_pipelined(pending, nodes, services=services, mode=mode, device=device,
                                        timer=timer)
        wall = time.perf_counter() - t0
        hand = scan_kernel.scan_with_state.launches + policy_scan.policy_scan_with_state.launches
        if hand:
            fail(mode, f"the {mode} pipeline launched {hand} scan kernels")
        snap = build_snapshot(pending, nodes, services=services)
        assignment = _assignment_of(snap, names)
        _valid(mode, snap, assignment, f"50k run {r}")
        placed = int((assignment >= 0).sum())
        run = {"run": "warmup" if r == 0 else f"timed{r}", "seed": 2 + r, "wall_s": wall,
               "placed": placed, "pods_per_s": N_PODS / wall, "phases_s": timer.seconds,
               **timer.stats}
        if r == 0:
            # Every pod the scan placed, as the quality gate's "placed".
            if placed < scan_placed:
                fail(mode, f"placed {placed} pods of the backlog the scan placed {scan_placed} of")
            t0 = time.perf_counter()
            q = oracle.assignment_quality(snap, assignment)
            q["seconds"] = time.perf_counter() - t0
            bounds = QUALITY[mode]
            if (q["feasible_in_order"] < 0.99 or q["mean_regret"] > bounds["mean_regret"]
                    or q["p99_regret"] > bounds["p99_regret"]
                    or q["greedy_match"] < bounds["greedy_match"]):
                fail(mode, f"quality outside {bounds}: {q}")
            out["quality"] = {**q, "bounds": bounds, "scan_placed": scan_placed}
        runs.append(run)
    timed = [x["wall_s"] for x in runs[1:]]
    out.update(runs=runs, wall_s_median=statistics.median(timed),
               pods_per_s_median=N_PODS / statistics.median(timed), validity="100% (ops/oracle.py)")
    out["profile"] = _profile_windowed(torch, device, mode)

    nodes, services, assigned = _churn_cluster(placed_names)
    t0 = time.perf_counter()
    session = SolverSession(nodes, services, assigned, node_capacity=int(len(nodes) * 1.25),
                            mode=mode, device=device)
    build_s = time.perf_counter() - t0
    stats, rows = [], []

    def on_result(k, _results):
        stats.append(dict(session.last_stats))
        rows.append(_mirror_check(torch, session, f"{mode} session tick {k}"))

    records = workload.churn_replay(
        session, live=[f"default/{p.metadata.name}" for p in assigned], ticks=WINDOWED_TICKS,
        rate=CHURN_RATE, seed=7, n_services=len(services), first_index=N_PODS, on_result=on_result)
    out["session"] = {
        "session_build_s": build_s, "n_launch": session.n_launch,
        "ticks": [{"tick": k, "wall_s": rec.wall_s, "phases_s": rec.phases_s,
                   "placed": sum(d is not None for _k, d in rec.results), **stats[k],
                   "mirror_rows_checked": rows[k]} for k, rec in enumerate(records)],
    }
    if not all(t["placed"] for t in out["session"]["ticks"]):
        fail(mode, "a session tick placed no pod")
    return out


# ---------------------------------------------------------------------------
# Phases 5j-5m: preemption, the capacity report, the defrag plan (K2)
# ---------------------------------------------------------------------------

PREEMPT_NODES, PREEMPT_BOUND, PREEMPT_PREEMPTORS = 5000, 50000, 1000
PREEMPT_REPEATS = 3
PREEMPT_SMALL = 16  # seeded small problems held to the scalar rule
PREEMPT_MEDIUM = (200, 2000, 32)  # nodes, bound pods, preemptors held to the scalar rule
CAPACITY_REPEATS = 5
REBALANCE_FORCED_NODES = 50
REBALANCE_CLUSTERS = (1, 2, 4, 8, 16)  # every cluster size K2's plan can choose
# (cluster, K, largest window; None: the plan's one row a warp)
REBALANCE_SWEEP = ((16, 1, None), (16, 4, None), (16, 16, None), (16, 32, None), (8, 8, None),
                   (4, 8, None), (16, 8, 2048))
REBALANCE_PLAIN_ROWS = 2048  # rows of case 2 held to the plain version on the card
REBALANCE_REPEATS = 3
# 32-bit operations a node of an evaluated row, from K2's arithmetic:
# liveness 3, free vectors 6, feasibility 5, best-fit key 9, the
# running minimum 2.
REBALANCE_OPS_PER_NODE = 25


def _decisions(ds):
    return [(d.key, d.node, d.victims) if d else None for d in ds]


def _profile_call(torch, fn):
    """fn() once under torch.profiler: its host wall (ending in a
    synchronise), the device time the trace holds (each kernel's own
    time, summed), the busy share and the kernel launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(device_us(e) for e in rows) / 1e3
    return out, {"wall_ms": wall * 1e3, "device_ms": device_ms,
                 "device_busy_share": device_ms / (wall * 1e3),
                 "kernel_launches": sum(e.count for e in rows)}


def run_preemption(torch, device):
    """Victim selection (plain PyTorch, no hand kernel) on a priority
    burst over a full fleet, held to its CPU run at full size and to the
    scalar rule on small and medium problems."""
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.scheduler.batch import preempt_backlog, preempt_backlog_scalar
    from kubernetes_tpu_torch.utils.tracing import PhaseTimer

    # The scalar rule: 16 small seeded problems and one medium one.
    small_grants = 0
    for s in range(PREEMPT_SMALL):
        objs = workload.random_preemption_problem(s)
        card = _decisions(preempt_backlog(*objs, device=device))
        if card != _decisions(preempt_backlog_scalar(*objs)):
            fail("preemption", f"small problem {s}: the card differs from the scalar rule")
        if card != _decisions(preempt_backlog(*objs, device="cpu")):
            fail("preemption", f"small problem {s}: the card differs from the CPU")
        small_grants += sum(d is not None for d in card)
    objs = workload.preemption_objects(*PREEMPT_MEDIUM, seed=5)
    card = _decisions(preempt_backlog(*objs, device=device))
    t0 = time.perf_counter()
    scalar = _decisions(preempt_backlog_scalar(*objs))
    scalar_s = time.perf_counter() - t0
    if card != scalar:
        bad = sum(a != b for a, b in zip(card, scalar))
        fail("preemption", f"medium problem: {bad} decisions differ from the scalar rule")
    medium_grants = sum(d is not None for d in card)
    if medium_grants == 0:
        fail("preemption", "the medium problem granted nothing")

    # Full size: a warm-up and three timed runs on seed 2, one run on
    # seed 3; each seed's card decisions equal its CPU run's.
    out, objects_of = {}, {}
    for seed in (2, 3):
        t0 = time.perf_counter()
        objs = objects_of[seed] = workload.preemption_objects(
            PREEMPT_NODES, PREEMPT_BOUND, PREEMPT_PREEMPTORS, seed)
        make_s = time.perf_counter() - t0
        runs = []
        for r in range(PREEMPT_REPEATS + 1 if seed == 2 else 1):
            timer = PhaseTimer()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = _decisions(preempt_backlog(*objs, device=device, timer=timer))
            runs.append({"wall_s": time.perf_counter() - t0, "phases_s": dict(timer.seconds)})
        t0 = time.perf_counter()
        cpu = _decisions(preempt_backlog(*objs, device="cpu"))
        cpu_s = time.perf_counter() - t0
        if card != cpu:
            bad = sum(a != b for a, b in zip(card, cpu))
            fail("preemption", f"seed {seed}: {bad} decisions differ between the card and the CPU")
        grants = [d for d in card if d]
        if not grants:
            fail("preemption", f"seed {seed}: nothing granted")
        timed = runs[1:] if len(runs) > 1 else runs
        wall = statistics.median(r["wall_s"] for r in timed)
        out[f"seed{seed}"] = {
            "objects_s": make_s, "runs": runs, "wall_s_median": wall,
            "ms_per_preemptor": wall * 1e3 / PREEMPT_PREEMPTORS,
            "build_s_median": statistics.median(r["phases_s"]["build"] for r in timed),
            "solve_s_median": statistics.median(r["phases_s"]["solve"] for r in timed),
            "grants": len(grants), "victims": sum(len(d[2]) for d in grants),
            "nodes_used": len({d[1] for d in grants}),
            "cpu_run_s": cpu_s, "equal_to_cpu": True,
        }
    # One seed-2 solve under the profiler: the card's share of the solve.
    from kubernetes_tpu_torch.ops.preemption import build_preemption_problem, solve_preemption

    preemptors, nodes, assigned = objects_of[2]
    problem = build_preemption_problem(nodes, assigned)
    _, profiled = _profile_call(torch, lambda: solve_preemption(problem, preemptors, device=device))
    return {
        "cell": f"{PREEMPT_NODES} nodes, {PREEMPT_BOUND} bound pods at 85-100% of a resource, "
                f"{PREEMPT_PREEMPTORS} preemptors",
        **out,
        "solve_profiled": profiled,
        "scalar_checks": {"small_problems": PREEMPT_SMALL, "small_grants": small_grants,
                          "medium": list(PREEMPT_MEDIUM), "medium_grants": medium_grants,
                          "medium_scalar_s": scalar_s, "equal": True},
        "tolerance": "exact: node and victims in eviction order",
    }


def _capacity_equal(phase, tag, got, want):
    import numpy as np

    for i, (g, w) in enumerate(zip(got, want)):
        g = g.cpu().numpy() if hasattr(g, "cpu") else np.asarray(g)
        w = w.cpu().numpy() if hasattr(w, "cpu") else np.asarray(w)
        if g.shape != w.shape or g.dtype != w.dtype or not np.array_equal(g, w):
            fail(phase, f"{tag}: output {i} differs ({g.dtype} {g.shape} against {w.dtype} {w.shape})")


def run_capacity(torch, device, placed_names, session):
    """The capacity report (plain PyTorch) on the main path's placement
    and on the churn session's columns: card, CPU and the NumPy twin
    equal on every output; its median time."""
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.ops.capacity import capacity_report, stage, _NODE_DTYPES, _PROBE_DTYPES
    from kubernetes_tpu_torch.ops.oracle import capacity_report_numpy
    from kubernetes_tpu_torch.utils.capacity import (
        COLUMN_KEYS, cluster_columns, probe_arrays, session_columns)

    nodes, _services, assigned = _churn_cluster(placed_names)
    pending, _, _ = workload.synthetic_objects(N_PODS, N_NODES, seed=2)
    probes = workload.backlog_probes(pending)
    probe = probe_arrays(probes)
    out = {"probes": [list(p) for p in probes]}
    for tag, (cols, _names) in (("cluster", cluster_columns(nodes, assigned)),
                                ("session", session_columns(session))):
        args = tuple(cols[k] for k in COLUMN_KEYS) + tuple(probe)
        want = capacity_report_numpy(*args)
        card = capacity_report(*args, device=device)
        _capacity_equal("capacity", f"{tag} card against the twin", card, want)
        _capacity_equal("capacity", f"{tag} CPU against the twin",
                        capacity_report(*args, device="cpu"), want)
        walls, events = [], []
        staged = stage(args[:8], _NODE_DTYPES, device) + stage(args[8:], _PROBE_DTYPES, device)
        for _ in range(CAPACITY_REPEATS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            capacity_report(*args, device=device)[-1].item()
            walls.append((time.perf_counter() - t0) * 1e3)
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            capacity_report(*staged, device=device)
            ev1.record()
            torch.cuda.synchronize()
            events.append(ev0.elapsed_time(ev1))
        _, profiled = _profile_call(torch, lambda: capacity_report(*staged, device=device))
        out[tag] = {
            "nodes": int(args[0].shape[0]), "probes": int(args[8].shape[0]),
            "wall_ms_median": statistics.median(walls[1:]),
            "device_tensors_ms_median": statistics.median(events[1:]),
            "profiled": profiled,
            "frag_score": float(want[8]), "stranded_nodes": int(want[7].sum()),
            "headroom": [int(x) for x in want[4]], "equal": True,
        }
    out["timed"] = ("wall: host clock around capacity_report from the NumPy columns, staging and "
                    "one read included; device_tensors: CUDA events around it on staged tensors")
    return out


def _k2_vs_plain(torch, device, tag, args, plans=(None,)):
    """K2 at each of `plans` (None: the default plan) against its plain
    version on the card, on the same staged tensors: every output bit
    for bit. Returns the max abs error (0) and the plain outputs."""
    from kubernetes_tpu_torch.ops import rebalance
    from kubernetes_tpu_torch.ops.capacity import stage

    tensors = stage(args[:-1], rebalance._DTYPES, device)
    ref = rebalance.plan_moves_plain(*tensors, args[-1])
    err = 0.0
    for plan in plans:
        got = rebalance._launch(tensors, int(args[-1]), plan)
        torch.cuda.synchronize()
        for i, (g, r) in enumerate(zip(got, ref)):
            if g.dtype != r.dtype or g.shape != r.shape or not torch.equal(g, r):
                fail("rebalance_parity", f"{tag}, {plan}: output {i} differs from the plain version")
            if g.numel():
                err = max(err, float((g.double() - r.double()).abs().max()))
    return err, ref


def check_rebalance_parity(torch, device):
    """K2 held to its plain version on the card: every case at every
    cluster size the plan can choose (1, 2, 4, 8 and 16 CTAs), at the
    default K and at K = 1, resident and in place."""
    import numpy as np

    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.ops import rebalance

    cases = [(f"seed {s}", workload.random_rebalance_args(s)) for s in range(16)]
    cases.append(("consolidation", workload.consolidation_args()))
    empty = list(workload.random_rebalance_args(2))
    for k in range(8, 13):
        empty[k] = empty[k][:0]
    cases.append(("no rows", tuple(empty)))
    cases.append(("ties across warps, 5,000 nodes", workload.tied_rebalance_args(5000, 256, 256)))
    cases.append(("ties, 300 nodes", workload.tied_rebalance_args(300, 64, 64)))
    cases.append(("70 probes", workload.with_random_probes(workload.random_rebalance_args(4), 70)))
    err, checked, moves = 0.0, 0, 0
    rebalance.plan_moves.launches = 0
    for tag, args in cases:
        N, D, Q = (int(np.asarray(args[i]).shape[0]) for i in (0, 8, 13))
        plans = [rebalance.launch_plan(N, D, Q, cluster=c, k=k, resident=resident)
                 for c in REBALANCE_CLUSTERS for k in (None, 1) for resident in (True, False)]
        e, ref = _k2_vs_plain(torch, device, tag, args, plans)
        err = max(err, e)
        checked += len(plans)
        moves += int(ref[3])
    if moves == 0:
        fail("rebalance_parity", "no case committed a move")
    return {"cases": len(cases), "kernel_runs": checked, "launches": rebalance.plan_moves.launches,
            "clusters": list(REBALANCE_CLUSTERS), "k": [rebalance.DEFAULT_K, 1],
            "moves": moves, "max_abs_err": err,
            "tolerance": "exact (torch.equal on dest, moved, gain, n_moves and both scores)"}


def k2_bound(args, evaluated_rows):
    """The least time the card could take for one K2 launch on these
    inputs: each input read and each output written once over the HBM
    rate, against the 32-bit operations of the evaluated rows over every
    node (and the two scores' probe fits) over the f32 rate."""
    N, D, Q = len(args[0]), len(args[8]), len(args[13])
    nbytes = N * (6 * 4 + 2) + D * (3 * 4 + 2) + Q * (3 * 4 + 1) + D * (2 * 4 + 1) + 4 + 8
    nops = evaluated_rows * N * REBALANCE_OPS_PER_NODE + 2 * N * Q * 12
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": nops, "evaluated_rows": evaluated_rows,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _evaluated_rows(pod_live, moved, n_moves, budget):
    """Rows K2 evaluates: the live rows up to the one that spends the
    budget (all live rows when it is never spent)."""
    import numpy as np

    if budget <= 0:
        return 0
    if int(n_moves) >= budget:
        last = int(np.nonzero(moved)[0][budget - 1])
        return int(pod_live[: last + 1].sum())
    return int(pod_live.sum())


def _k2_ms(torch, tensors, budget, reps=REBALANCE_REPEATS, plan=None):
    """Median CUDA-event milliseconds of `reps` K2 launches after a
    warm-up, all the times, and the last launch's stats (read here, off
    the timed launches)."""
    from kubernetes_tpu_torch.ops import rebalance

    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        rebalance._launch(tensors, budget, plan)
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
    return statistics.median(times[1:]), times[1:], _k2_stats(rebalance.plan_moves.last_stats)


def _k2_stats(stats):
    """K2's stats tensor as a dict, with the screen's and the resolve's
    shares of CTA 0's cycles."""
    from kubernetes_tpu_torch.ops import rebalance

    out = dict(zip(rebalance.STATS, (int(v) for v in stats.cpu().tolist())))
    total = max(out["total_cycles"], 1)
    out["screen_share"] = out["screen_cycles"] / total
    out["resolve_share"] = out["resolve_cycles"] / total
    return out


def _rebalance_cases(placed_names):
    """The defrag plan's five worklists, as (tag, columns, node names,
    pods, probes, budget, forced nodes): the main path's placement, all
    50,000 pods movable, at budget 32 (the descheduler's), at budget D,
    with 50 forced (cordoned) nodes, and with every node forced (every
    row commits: the dense case); and a full fleet
    (preemption_objects(5000, 50000, 0, seed=2)) at budget D. The probes
    are the 50k backlog's."""
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.utils.capacity import cluster_columns
    from kubernetes_tpu_torch.utils.rebalance import DEFAULT_MOVE_BUDGET, movable_pods

    nodes, _services, assigned = _churn_cluster(placed_names)
    cols, names = cluster_columns(nodes, assigned)
    pending, _, _ = workload.synthetic_objects(N_PODS, N_NODES, seed=2)
    probes = workload.backlog_probes(pending)
    D = len(assigned)
    forced = names[:: len(names) // REBALANCE_FORCED_NODES][:REBALANCE_FORCED_NODES]
    _, fleet_nodes, bound = workload.preemption_objects(N_NODES, N_PODS, 0, seed=2)
    fleet_cols, fleet_names = cluster_columns(fleet_nodes, bound)
    main = (cols, names, assigned, probes)
    return (("default_budget", *main, DEFAULT_MOVE_BUDGET, ()), ("budget_d", *main, D, ()),
            ("forced", *main, D, tuple(forced)), ("forced_all", *main, D, tuple(names)),
            ("full_fleet", fleet_cols, fleet_names, bound, probes, len(movable_pods(bound)), ()))


def run_rebalance(torch, device, placed_names):
    """build_plan on five worklists (the main path's placement at budget
    32, at budget D, with 50 and with every node forced; a full fleet),
    each held in full to the NumPy twin; K2 timed by CUDA events with its
    commits, windows, rows screened and screen/resolve split, and held to
    its plain version on the first rows of budget D; K2 swept over the
    cluster size, K and the largest window."""
    import numpy as np

    from kubernetes_tpu_torch.ops import rebalance
    from kubernetes_tpu_torch.ops.capacity import stage
    from kubernetes_tpu_torch.ops.oracle import plan_moves_numpy
    from kubernetes_tpu_torch.utils.capacity import COLUMN_KEYS, probe_arrays
    from kubernetes_tpu_torch.utils.rebalance import build_plan, group_plan, stage_rows
    from kubernetes_tpu_torch.utils.tracing import PhaseTimer

    cases = _rebalance_cases(placed_names)
    out = {"cell": f"{N_NODES} nodes, {N_PODS} movable pods (main path's placement) or "
                   f"{len(cases[-1][3])} (full fleet), {len(cases[0][4])} probes",
           "probes": [list(p) for p in cases[0][4]]}
    launches, staged = {}, {}
    for tag, cols, names, pods, probes, budget, forced_nodes in cases:
        timer = PhaseTimer()
        rebalance.plan_moves.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = build_plan(cols, names, pods, probes, budget, forced_nodes, device=device,
                          timer=timer)
        wall = time.perf_counter() - t0
        launches[tag] = rebalance.plan_moves.launches
        if launches[tag] != 1:
            fail("rebalance", f"{tag}: build_plan launched K2 {launches[tag]} times, not once")

        rows, *row_arrays = stage_rows(cols, names, pods, forced_nodes)
        args = tuple(cols[k] for k in COLUMN_KEYS) + tuple(row_arrays) + tuple(
            probe_arrays(probes)) + (np.int32(budget),)
        tensors = stage(args[:-1], rebalance._DTYPES, device)
        k2 = [t.cpu().numpy() for t in rebalance._launch(tensors, budget)]
        t0 = time.perf_counter()
        twin = plan_moves_numpy(*args)
        twin_s = time.perf_counter() - t0
        for i, (g, w) in enumerate(zip(k2, twin)):
            w = np.asarray(w)
            if g.shape != w.shape or g.dtype != w.dtype or not np.array_equal(g, w):
                fail("rebalance", f"{tag}: K2's output {i} differs from the NumPy twin")
        if plan != group_plan(rows, names, row_arrays[4], *twin[:3], budget, twin[4], twin[5]):
            fail("rebalance", f"{tag}: the plan differs from the plan of the twin's rows")
        ms, ms_all, stats = _k2_ms(torch, tensors, budget)
        evaluated = _evaluated_rows(row_arrays[3], k2[1], k2[3], budget)
        out[tag] = {
            "budget": budget, "forced_nodes": len(forced_nodes), "rows": len(rows),
            "wall_s": wall, "phases_s": dict(timer.seconds), "k2_ms": ms, "k2_ms_all": ms_all,
            "evaluated_rows": evaluated, "us_per_row": ms * 1e3 / max(evaluated, 1),
            "n_moves": int(k2[3]), "planned_moves": len(plan["moves"]) if plan else 0,
            "stats": stats, "bound": k2_bound(args, evaluated),
            "score_before": float(twin[4]), "score_after": float(twin[5]),
            "twin_s": twin_s, "equal_to_twin": True,
        }
        staged[tag] = (args, tensors)
    if (out["forced"]["n_moves"] == 0 or out["forced_all"]["n_moves"] == 0
            or any(out[c[0]]["n_moves"] > c[5] for c in cases)):
        fail("rebalance", "a forced drain moved nothing, or a case moved past its budget")
    full_args, full_tensors = staged["budget_d"]

    # K2 against its plain version on the card, the first rows of case 2:
    # both timed, and bounded, on those rows.
    prefix = tuple(a[:REBALANCE_PLAIN_ROWS] if 8 <= k < 13 else a for k, a in enumerate(full_args))
    err, ref = _k2_vs_plain(torch, device, f"first {REBALANCE_PLAIN_ROWS} rows of budget D", prefix)
    pt = stage(prefix[:-1], rebalance._DTYPES, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rebalance.plan_moves_plain(*pt, prefix[-1])[-1].item()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ms_prefix, _, _ = _k2_ms(torch, pt, int(prefix[-1]))
    bound = k2_bound(prefix, _evaluated_rows(prefix[11], ref[1].cpu().numpy(), ref[3], int(prefix[-1])))
    lp = rebalance.launch_plan(len(full_args[0]), len(full_args[8]), len(full_args[13]))

    # Where a row's time goes: budget D's rows against the first n nodes
    # (sources past n read as none); and the cluster size, K and the
    # largest window swept on budget D, 50 forced nodes and the full
    # fleet, each run's outputs equal to the default plan's.
    rows_d = out["budget_d"]["evaluated_rows"]
    by_nodes = {}
    for n in (256, 1024, 2048):
        cut = tuple(a[:n] if k < 8 else a for k, a in enumerate(full_args))
        t, _, _ = _k2_ms(torch, stage(cut[:-1], rebalance._DTYPES, device), int(cut[-1]), 1)
        by_nodes[n] = t * 1e3 / rows_d
    by_nodes[len(full_args[0])] = out["budget_d"]["us_per_row"]
    sweep = []
    for tag in ("budget_d", "forced", "full_fleet"):
        args, tensors = staged[tag]
        want = [t.cpu() for t in rebalance._launch(tensors, int(args[-1]))]
        for cluster, k, max_rows in REBALANCE_SWEEP:
            cfg = rebalance.launch_plan(len(args[0]), len(args[8]), len(args[13]), cluster=cluster,
                                        k=k, max_rows=max_rows)
            got = [t.cpu() for t in rebalance._launch(tensors, int(args[-1]), cfg)]
            if any(not torch.equal(g, w) for g, w in zip(got, want)):
                fail("rebalance", f"{tag}: K2 on {cluster} CTAs at K = {k}, windows to "
                                  f"{cfg.max_rows} differs")
            ms, _, stats = _k2_ms(torch, tensors, int(args[-1]), 1, cfg)
            sweep.append({"worklist": tag, "cluster": cluster, "k": k, "max_rows": cfg.max_rows,
                          "ms": ms, "us_per_row": ms * 1e3 / out[tag]["evaluated_rows"],
                          "stats": stats})
    out["k2"] = {
        "plan": {"cluster": lp.cluster, "threads": lp.threads, "k": lp.k,
                 "first_rows": lp.first_rows, "max_rows": lp.max_rows, "resident": lp.resident,
                 "smem_bytes": lp.smem_bytes, "scratch_bytes": lp.scratch_bytes},
        "rows": REBALANCE_PLAIN_ROWS, "ms": ms_prefix, "plain_ms": plain_ms, "max_abs_err": err,
        **bound,
        "worklist_ms": out["budget_d"]["k2_ms"], "us_per_row": out["budget_d"]["us_per_row"],
        "worklist": out["budget_d"]["bound"],
        "worklists": {c[0]: {"ms": out[c[0]]["k2_ms"], "us_per_row": out[c[0]]["us_per_row"],
                             "bound_ms": out[c[0]]["bound"]["bound_ms"],
                             "commits": out[c[0]]["n_moves"],
                             "windows": out[c[0]]["stats"]["windows"],
                             "rows_screened": out[c[0]]["stats"]["rows_screened"],
                             "screen_share": out[c[0]]["stats"]["screen_share"],
                             "resolve_share": out[c[0]]["stats"]["resolve_share"]}
                      for c in cases},
        "us_per_row_by_nodes": by_nodes, "sweep": sweep,
        "timed": "ms: CUDA events around the wrapper's launch on the first `rows` rows of case "
                 "budget_d; plain_ms: host clock around the plain loop on the same rows, ending in "
                 "a read; worklist_ms and worklists: CUDA events around the launch on each whole "
                 "worklist; shares: of CTA 0's clock64 cycles (kernel stats)",
    }
    out["launches"] = launches
    return out


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


def kernel_bound(torch, pods, carry):
    """The least time the card could take for one scan launch on these
    inputs: the larger of the bytes it must move over the HBM rate and
    the operations it must do over the f32 rate."""
    P, N = pods["cpu"].shape[0], carry["cpu_cap"].shape[0]
    SW, PW = pods["sel"].shape[1], pods["port"].shape[1]
    VW, K = pods["vol_any"].shape[1], pods["svc_ids"].shape[1]
    S = carry["svc_counts"].shape[1]
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
        "bytes": nbytes, "ops": nops, "placeable_pods": placeable,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


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

    bound = kernel_bound(torch, pods, carry0)
    return {
        "shape": {"P": P, "N": N, "S": S, "SW": SW, "PW": PW, "VW": VW, "K": K},
        "plan": {"cluster": plan.cluster, "threads": plan.threads,
                 "nodes_per_cta": plan.nodes_per_cta, "smem_bytes": plan.smem_bytes},
        "ms": ms,
        "per_pod_us_by_nodes": per_pod_us,
        "fixed_part_us": per_pod_us[1024],
        "ms_all": times,
        "sweep": [{k: x[k] for k in ("cluster", "threads", "ms", "per_pod_us")} for x in sweep],
        "placeable_pods": bound["placeable_pods"],
        "count_commit_steps": count_steps,
        "ms_no_service_ids": ms_no_ids,
        "near_limit": {k: near_limit[k] for k in ("nodes", "cluster", "threads", "smem_bytes", "ms", "per_pod_us")},
        "bytes": bound["bytes"],
        "ops": bound["ops"],
        "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"],
        "timed": "the wrapper's launch on the first pipeline chunk, layout conversion included",
    }


if __name__ == "__main__":
    sys.exit(main())
