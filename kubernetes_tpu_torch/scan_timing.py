#!/usr/bin/env python3
"""Time a checkout's scan kernel (K1) on the main path's first chunk.

    python3 kubernetes_tpu_torch/scan_timing.py [--root DIR] [--reps N]

Imports `kubernetes_tpu_torch` from DIR (default: the checkout that
holds this file), builds its scan kernel, stages the first pipeline
chunk of the 50k x 5k backlog (`synthetic_objects(50000, 5000, seed=2)`:
13,312 pods padded, 5,120 nodes) and prints one JSON line: the median
CUDA-event milliseconds of N launches after a warm-up, each from a
fresh copy of the node carry, the choices' checksum (equal checksums:
equal decisions), and the card's name and power limit. It uses only
entry points every version of the port has, so two checkouts are
compared on one card by running it in turns in one command (A, B, B,
A). It needs a CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("scan_timing: no CUDA card", file=sys.stderr)
        return 2
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models.columnar import SnapshotBuilder
    from kubernetes_tpu_torch.ops import scan_kernel
    from kubernetes_tpu_torch.ops.matrices import device_nodes, device_pods
    from kubernetes_tpu_torch.ops.pipeline import DEFAULT_CHUNK

    if not os.path.abspath(scan_kernel.__file__).startswith(root + os.sep):
        print(f"scan_timing: imported {scan_kernel.__file__}, not from {root}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    pending, nodes, services = workload.synthetic_objects(50000, 5000, seed=2)
    builder = SnapshotBuilder(pending, nodes, (), services)
    carry = device_nodes(builder.node_columns(), device)
    pods = device_pods(builder.pod_columns(0, DEFAULT_CHUNK), device)
    times, checksum = [], None
    for _ in range(args.reps + 1):
        state = {k: v.clone() for k, v in carry.items()}
        torch.cuda.synchronize()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        choice, _ = scan_kernel.scan_with_state(pods, state)
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
        checksum = int((choice.to(torch.int64) * torch.arange(1, choice.numel() + 1, device=device)).sum())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "root": root, "card": smi, "pods": int(pods["cpu"].shape[0]),
        "nodes": int(carry["cpu_cap"].shape[0]), "ms_median": statistics.median(times[1:]),
        "ms": times[1:], "choice_checksum": checksum,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
