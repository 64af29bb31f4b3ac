#!/usr/bin/env python3
"""Time a checkout's scan kernel (K1) or defrag plan kernel (K2).

    python3 kubernetes_tpu_torch/scan_timing.py [--root DIR] [--reps N] [--kernel scan|rebalance]

Imports `kubernetes_tpu_torch` from DIR (default: the checkout that
holds this file), builds the kernel and prints one JSON line: the median
CUDA-event milliseconds of N launches after a warm-up, a checksum of the
outputs (equal checksums: equal decisions), and the card's name and
power limit.

  scan       K1 on the first pipeline chunk of the 50k x 5k backlog
             (`synthetic_objects(50000, 5000, seed=2)`: 13,312 pods
             padded, 5,120 nodes), each launch from a fresh copy of the
             node carry;
  rebalance  K2 on a full fleet (`preemption_objects(5000, 50000, 0,
             seed=2)`: 5,000 nodes, 50,000 bound pods, all movable) with
             the 50k backlog's probes, at budget D (every live row
             evaluated).

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


def _time_rebalance(torch, device, reps):
    import numpy as np

    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.ops import rebalance
    from kubernetes_tpu_torch.ops.capacity import stage
    from kubernetes_tpu_torch.utils.capacity import COLUMN_KEYS, cluster_columns, probe_arrays
    from kubernetes_tpu_torch.utils.rebalance import stage_rows

    _, nodes, bound = workload.preemption_objects(5000, 50000, 0, seed=2)
    cols, names = cluster_columns(nodes, bound)
    _, *row_arrays = stage_rows(cols, names, bound, ())
    pending, _, _ = workload.synthetic_objects(50000, 5000, seed=2)
    probe = probe_arrays(workload.backlog_probes(pending))
    args = tuple(cols[k] for k in COLUMN_KEYS) + tuple(row_arrays) + tuple(probe)
    tensors = stage(args, rebalance._DTYPES, device)
    budget = len(row_arrays[0])
    times, out = _events_ms(torch, lambda: rebalance.plan_moves(*tensors, budget, device=device), reps)
    dest, moved, gain, n_moves, before, after = (t.cpu().numpy() for t in out)
    checksum = int((dest.astype(np.int64) * np.arange(1, len(dest) + 1)).sum()
                   + gain.astype(np.int64).sum())
    return rebalance, {"rows": budget, "nodes": len(names), "probes": int(len(probe[0])),
                       "times": times, "n_moves": int(n_moves), "moved": int(moved.sum()),
                       "scores": [float(before), float(after)], "plan_checksum": checksum}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--kernel", choices=("scan", "rebalance"), default="scan")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("scan_timing: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    timed = _time_scan if args.kernel == "scan" else _time_rebalance
    module, result = timed(torch, device, args.reps)
    if not os.path.abspath(module.__file__).startswith(root + os.sep):
        print(f"scan_timing: imported {module.__file__}, not from {root}", file=sys.stderr)
        return 3
    times = result.pop("times")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "root": root, "kernel": args.kernel, "card": smi, **result,
        "ms_median": statistics.median(times), "ms": times,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
