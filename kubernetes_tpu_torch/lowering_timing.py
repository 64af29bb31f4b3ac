#!/usr/bin/env python3
"""Time the host half of the daemon's lowering on the CPU.

    python3 kubernetes_tpu_torch/lowering_timing.py [--pods N] [--nodes N]
        [--reps N] [--model MODULE ...]

For each object model MODULE (default: `kubernetes_tpu_torch.models.objects`)
it decodes the wire form of `synthetic_objects(N pods, N nodes, seed=2)`
into that model's `Pod`, `Node` and `Service` (`models/serde.from_wire`,
what the daemon's informers do with each object the apiserver sends) and
lowers the result into a columnar snapshot (`build_snapshot`). The models
are timed in turns, N rounds, and one JSON line per model gives every
round's decode and lowering seconds on `time.perf_counter` and their
medians. It needs no card: this is host work.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _round(model, wire_pods, wire_nodes, wire_services):
    from kubernetes_tpu_torch.models import serde
    from kubernetes_tpu_torch.models.columnar import build_snapshot

    gc.collect()
    t0 = time.perf_counter()
    pods = [serde.from_wire(model.Pod, w) for w in wire_pods]
    nodes = [serde.from_wire(model.Node, w) for w in wire_nodes]
    services = [serde.from_wire(model.Service, w) for w in wire_services]
    t1 = time.perf_counter()
    snap = build_snapshot(pods, nodes, services=services)
    t2 = time.perf_counter()
    return t1 - t0, t2 - t1, float(snap.pods.cpu_milli.sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--pods", type=int, default=50000)
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--model", action="append", default=None)
    args = ap.parse_args(argv)
    from kubernetes_tpu_torch import workload
    from kubernetes_tpu_torch.models import serde

    models = {name: importlib.import_module(name)
              for name in args.model or ["kubernetes_tpu_torch.models.objects"]}
    pods, nodes, services = workload.synthetic_objects(args.pods, args.nodes, seed=2)
    wire = ([serde.to_wire(p) for p in pods], [serde.to_wire(n) for n in nodes],
            [serde.to_wire(s) for s in services])
    rounds = {name: [] for name in models}
    for _ in range(args.reps):
        for name, model in models.items():
            rounds[name].append(_round(model, *wire))
    for name, rs in rounds.items():
        print(json.dumps({"model": name, "pods": args.pods, "nodes": args.nodes,
                          "decode_s": [r[0] for r in rs], "lower_s": [r[1] for r in rs],
                          "decode_s_median": statistics.median(r[0] for r in rs),
                          "lower_s_median": statistics.median(r[1] for r in rs),
                          "cpu_sum": rs[-1][2]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
