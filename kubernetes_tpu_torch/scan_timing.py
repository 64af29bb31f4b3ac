#!/usr/bin/env python3
"""Time a checkout's scan kernel (K1) or defrag plan kernel (K2).

    python3 kubernetes_tpu_torch/scan_timing.py [--root DIR] [--reps N]
        [--kernel scan|scan_widths|rebalance]

Imports `kubernetes_tpu_torch` from DIR (default: the checkout that
holds this file), builds the kernel and prints one JSON line per input: the median
CUDA-event milliseconds of N launches after a warm-up, a checksum of the
outputs (equal checksums: equal decisions), and the card's name and
power limit.

  scan       K1 on the first pipeline chunk of the 50k x 5k backlog
             (`synthetic_objects(50000, 5000, seed=2)`: 13,312 pods
             padded, 5,120 nodes), each launch from a fresh copy of the
             node carry;
  scan_widths
             K1 on 1,024 pods of `synthetic_objects(1024, 5120, seed=3)`
             on its 5,120 nodes, one line a width: the main path's
             2-word bitsets, the session's 4-word bitsets (the runtime-
             width instance, resident), and 196 label words (a hostname
             label on each of 5,000 nodes: 224-word rows, in place);
             every eighth pod selects one bit of the added words;
  rebalance  K2 on five worklists, one line each: the main path's
             placement (the 50k x 5k backlog, seed 2, as
             solve_backlog_pipelined places it; 50,000 movable pods) at
             budget 32, at budget D, with 50 forced nodes and with every
             node forced (every row forced), and a full fleet
             (`preemption_objects(5000, 50000, 0, seed=2)`: 5,000 nodes,
             48,998 movable pods) at budget D; the 50k backlog's probes.

It uses only entry points every version of the port that has the kernel
has, so two checkouts are compared on one card by running it in turns in
one command (A, B, B, A). It needs a CUDA card and exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def _events_ms(torch, launch, reps):
    """CUDA-event milliseconds of `reps` + 1 calls of `launch` (the first
    a warm-up, dropped) and the last call's result."""
    times, out = [], None
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = launch()
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
    return times[1:], out


def _time_scan(torch, device, reps):
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.columnar import SnapshotBuilder
    from kubernetes_tpu_torch.ops import scan_kernel
    from kubernetes_tpu_torch.ops.matrices import device_nodes, device_pods
    from kubernetes_tpu_torch.ops.pipeline import DEFAULT_CHUNK

    pending, nodes, services = workload.synthetic_objects(50000, 5000, seed=2)
    builder = SnapshotBuilder(pending, nodes, (), services)
    carry = device_nodes(builder.node_columns(), device)
    pods = device_pods(builder.pod_columns(0, DEFAULT_CHUNK), device)

    def launch():
        state = {k: v.clone() for k, v in carry.items()}
        return scan_kernel.scan_with_state(pods, state)[0]

    times, choice = _events_ms(torch, launch, reps)
    checksum = int((choice.to(torch.int64) * torch.arange(1, choice.numel() + 1, device=device)).sum())
    return scan_kernel, {"pods": int(pods["cpu"].shape[0]), "nodes": int(carry["cpu_cap"].shape[0]),
                         "times": times, "choice_checksum": checksum}


def _time_scan_widths(torch, device, reps):
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.columnar import build_snapshot
    from kubernetes_tpu_torch.ops import scan_kernel
    from kubernetes_tpu_torch.ops.matrices import device_snapshot

    pending, nodes, services = workload.synthetic_objects(1024, 5120, seed=3)
    d = device_snapshot(build_snapshot(pending, nodes, services=services), device, 1)

    def widen(words, label_words=0):
        def pad(t):
            return torch.cat([t, t.new_zeros(t.shape[0], words - t.shape[1])], 1).contiguous()

        pods = {k: pad(v) if k in ("sel", "port", "vol_any", "vol_rw") else v
                for k, v in d.pods.items()}
        carry = {k: pad(v) if k in ("labels", "uport", "uvol_any", "uvol_rw") else v
                 for k, v in d.nodes.items()}
        if label_words:
            n, p, extra = carry["labels"].shape[0], pods["sel"].shape[0], label_words - words
            gen = torch.Generator(device=device).manual_seed(7)
            carry["labels"] = torch.cat([carry["labels"], torch.randint(
                -2**31, 2**31 - 1, (n, extra), dtype=torch.int32, device=device, generator=gen)],
                1).contiguous()
            sel = torch.zeros((p, extra), dtype=torch.int32, device=device)
            rows = torch.arange(0, p, 8, device=device)
            sel[rows, (rows * 37) % extra] = 1
            pods["sel"] = torch.cat([pods["sel"], sel], 1).contiguous()
        return pods, carry

    out = []
    for tag, (pods, carry) in (("main_2_words", (d.pods, d.nodes)), ("session_4_words", widen(4)),
                               ("labels_196_words", widen(4, 196))):
        def launch():
            state = {k: v.clone() for k, v in carry.items()}
            return scan_kernel.scan_with_state(pods, state)[0]

        times, choice = _events_ms(torch, launch, reps)
        checksum = int((choice.to(torch.int64)
                        * torch.arange(1, choice.numel() + 1, device=device)).sum())
        plan = scan_kernel.plan_for(pods, carry)
        out.append({"widths": tag, "pods": int(pods["cpu"].shape[0]),
                    "nodes": int(carry["cpu_cap"].shape[0]), "row_words": plan.row_words,
                    "resident": plan.resident, "times": times, "choice_checksum": checksum})
    return scan_kernel, out


def _rebalance_worklists(torch, device):
    """The defrag plan's worklists, as (name, plan_moves arguments) with
    NumPy columns: the main path's placement (the 50k x 5k backlog,
    seed 2, as solve_backlog_pipelined places it, all pods movable) at
    budget 32, at budget D, with 50 forced (cordoned) nodes and with
    every node forced; and a full fleet (preemption_objects(5000, 50000,
    0, seed=2)) at budget D. The probes are the 50k backlog's."""
    import numpy as np

    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.ops.pipeline import solve_backlog_pipelined
    from kubernetes_tpu_torch.utils.capacity import COLUMN_KEYS, cluster_columns, probe_arrays
    from kubernetes_tpu_torch.utils.rebalance import stage_rows

    pending, nodes, services = workload.synthetic_objects(50000, 5000, seed=2)
    probe = tuple(probe_arrays(workload.backlog_probes(pending)))
    names = solve_backlog_pipelined(pending, nodes, services=services, device=device)
    assigned = []
    for pod, name in zip(pending, names):
        if name is not None:
            pod.spec.node_name = name
            pod.status.phase = "Running"
            assigned.append(pod)
    cols, node_names = cluster_columns(nodes, assigned)
    forced50 = node_names[:: len(node_names) // 50][:50]
    out = []
    for tag, budget, forced in (("main_budget_32", 32, ()), ("main_budget_d", None, ()),
                                ("main_forced_50", None, forced50),
                                ("main_forced_all", None, node_names)):
        _, *rows = stage_rows(cols, node_names, assigned, forced)
        d = len(rows[0])
        out.append((tag, tuple(cols[k] for k in COLUMN_KEYS) + tuple(rows) + probe
                    + (np.int32(d if budget is None else budget),)))
    _, fleet_nodes, bound = workload.preemption_objects(5000, 50000, 0, seed=2)
    cols, node_names = cluster_columns(fleet_nodes, bound)
    _, *rows = stage_rows(cols, node_names, bound, ())
    out.append(("full_fleet", tuple(cols[k] for k in COLUMN_KEYS) + tuple(rows) + probe
                + (np.int32(len(rows[0])),)))
    return out


def _time_rebalance(torch, device, reps):
    import numpy as np

    from kubernetes_tpu_torch.ops import rebalance
    from kubernetes_tpu_torch.ops.capacity import stage

    results = []
    for tag, args in _rebalance_worklists(torch, device):
        tensors = stage(args[:-1], rebalance._DTYPES, device)
        budget = int(args[-1])
        times, out = _events_ms(torch, lambda: rebalance.plan_moves(*tensors, budget, device=device),
                                reps)
        dest, moved, gain, n_moves, before, after = (t.cpu().numpy() for t in out)
        checksum = int((dest.astype(np.int64) * np.arange(1, len(dest) + 1)).sum()
                       + gain.astype(np.int64).sum())
        live = int(np.asarray(args[11]).sum())
        results.append({"worklist": tag, "rows": len(dest), "live_rows": live,
                        "nodes": int(len(args[0])), "probes": int(len(args[13])), "budget": budget,
                        "times": times, "us_per_row": statistics.median(times) * 1e3 / max(live, 1),
                        "n_moves": int(n_moves), "moved": int(moved.sum()),
                        "scores": [float(before), float(after)], "plan_checksum": checksum})
    return rebalance, results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--kernel", choices=("scan", "scan_widths", "rebalance"), default="scan")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("scan_timing: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    timed = {"scan": _time_scan, "scan_widths": _time_scan_widths,
             "rebalance": _time_rebalance}[args.kernel]
    module, result = timed(torch, device, args.reps)
    if not os.path.abspath(module.__file__).startswith(root + os.sep):
        print(f"scan_timing: imported {module.__file__}, not from {root}", file=sys.stderr)
        return 3
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    for one in result if isinstance(result, list) else [result]:
        times = one.pop("times")
        print(json.dumps({
            "root": root, "kernel": args.kernel, "card": smi, **one,
            "ms_median": statistics.median(times), "ms": times,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
