"""The port's scheduler daemon as a process.

    python -m kubernetes_tpu_torch.cmd.scheduler --server URL [--batch] \\
        [--batch-full-relower | --batch-incremental] \\
        [--batch-mode scan|wave|sinkhorn|auto] [--algorithm-provider NAME] \\
        [--policy-config-file FILE] [--solver-sidecar SOCKET] \\
        [--prewarm-buckets N] [--healthz-port PORT] [--device cuda|cpu]

The counterpart of `kubernetes_tpu/cmd/daemons.py`'s `start_scheduler`
and `scheduler_main`, with its flags and routing: an HTTP client of the
apiserver at URL, informer-fed caches, and one of the daemons of
`scheduler.daemon`, solving on the CUDA card (`--device cpu` runs the
plain PyTorch path on the CPU; without a card and without it, the
command raises):

- the default policy with no sidecar boots the incremental daemon
  (`IncrementalBatchScheduler`);
- a policy file (JSON), a sidecar socket or `--batch-full-relower`
  boots the full re-lower `BatchScheduler`: a policy that lowers runs
  on the policy scan kernel, one that does not on the scalar path, and
  a sidecar solves in its own process (this one then needs no card);
- `--batch-incremental` with a policy or a sidecar exits with the JAX
  package's message.

Without any batch flag the JAX package boots its per-pod scalar
`Scheduler`; the port has no such daemon yet and boots the incremental
daemon. `--batch-mode auto` is the scan on one card.

`--healthz-port` (default 10251, the JAX scheduler's; negative
disables) serves `/healthz` (200 while the daemon's loop runs),
`/metrics` and the scheduler's `/debug/*` views
(`cmd/daemons.HealthServer`): decisions, solves and traces of the
flight recorder, slo, capacity, rebalance, kernels, device-profile,
stacks and profile. A port that is taken prints a warning and the
daemon runs on. It runs until SIGTERM or SIGINT, or exits 1 when the
daemon stops after a failed tick.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
from typing import List, Optional

from kubernetes_tpu_torch import default_device


def scheduler_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kubernetes_tpu_torch.cmd.scheduler")
    p.add_argument("--server", "-s", default="http://127.0.0.1:8080", help="apiserver base URL")
    p.add_argument("--algorithm-provider", default="DefaultProvider")
    p.add_argument("--policy-config-file", default="",
                   help="JSON scheduler policy (plugin/pkg/scheduler/api); boots the full "
                        "re-lower daemon")
    p.add_argument("--batch", action="store_true",
                   help="batch mode on the card: with the default policy and no sidecar the "
                        "incremental session daemon, else the full re-lower daemon (the "
                        "port's only daemons, so this is also what runs without the flag)")
    p.add_argument("--batch-full-relower", action="store_true",
                   help="with --batch: re-lower the whole cluster every tick instead of "
                        "keeping the session on the card")
    p.add_argument("--batch-incremental", action="store_true",
                   help="keep cluster state on the card across ticks; default policy only")
    p.add_argument("--batch-mode", default="scan", choices=["scan", "wave", "sinkhorn", "auto"],
                   help="the tick solver: scan (sequential parity, the default), wave, "
                        "sinkhorn, or auto (the scan on one card)")
    p.add_argument("--solver-sidecar", default="",
                   help="unix socket of a solver sidecar (python -m "
                        "kubernetes_tpu_torch.ops.sidecar <socket>); boots the full re-lower "
                        "daemon, which then never touches a card itself")
    p.add_argument("--prewarm-buckets", type=int, default=128,
                   help="run the incremental session's launches at every pod bucket up to "
                        "this size when it is built; 0 disables")
    p.add_argument("--healthz-port", type=int, default=10251,
                   help="own /healthz, /metrics and /debug/* port (the JAX scheduler's "
                        "10251); negative disables")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the daemon solves (default: the CUDA card)")
    return p


def route(args) -> str:
    """"incremental" or "full" for parsed `args`; exits on a combination
    the JAX command refuses."""
    custom = args.policy_config_file or args.solver_sidecar
    if args.batch_incremental:
        if custom:
            raise SystemExit(
                "--batch-incremental supports the default policy only "
                "(drop --policy-config-file/--solver-sidecar, "
                "or drop --batch-incremental)"
            )
        return "incremental"
    return "full" if args.batch_full_relower or custom else "incremental"


def start_scheduler(args, client=None):
    """The started daemon for parsed `args` (the device is checked
    before the apiserver is contacted)."""
    which = route(args)
    policy = None
    if args.policy_config_file:
        with open(args.policy_config_file) as f:
            policy = json.load(f)
    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.scheduler.daemon import (
        BatchScheduler,
        IncrementalBatchScheduler,
        SchedulerConfig,
        lowers,
    )
    from kubernetes_tpu_torch.scheduler.plugins import spec_for_policy

    # The scalar and sidecar routes solve elsewhere than on this card.
    card = not args.solver_sidecar and (policy is None or lowers(spec_for_policy(policy)))
    device = None
    if card:
        device = "cpu" if args.device == "cpu" else default_device()
    client = client or Client(HTTPTransport(args.server))
    config = SchedulerConfig(client, provider_name=args.algorithm_provider, policy=policy,
                             raw_scheduled_cache=which == "incremental").start()
    config.wait_for_sync()
    if which == "incremental":
        return IncrementalBatchScheduler(config, mode=args.batch_mode,
                                         prewarm_buckets=args.prewarm_buckets,
                                         device=device).start()
    return BatchScheduler(config, mode=args.batch_mode,
                          sidecar_path=args.solver_sidecar or None, device=device).start()


def main(argv: Optional[List[str]] = None) -> int:
    from kubernetes_tpu_torch.cmd.daemons import _loop_alive_check, _start_health

    args = scheduler_parser().parse_args(argv)
    daemon = start_scheduler(args)
    health = _start_health(args, [_loop_alive_check(daemon)])
    print(f"scheduler running against {args.server} ({type(daemon).__name__})", flush=True)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    try:
        while not stop.wait(1.0):
            if not daemon._thread.is_alive():
                print("scheduler stopped after a failed tick", file=sys.stderr)
                return 1
    finally:
        daemon.stop()
        if health is not None:
            health.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
