"""The port's scheduler daemon as a process.

    python -m kubernetes_tpu_torch.cmd.scheduler --server URL [--batch] \\
        [--batch-full-relower | --batch-incremental] \\
        [--batch-mode scan|wave|sinkhorn|auto] [--algorithm-provider NAME] \\
        [--policy-config-file FILE] [--solver-sidecar SOCKET] \\
        [--prewarm-buckets N] [--healthz-port PORT] [--device cuda|cpu] \\
        [--leader-elect [--leader-elect-identity ID]]

The counterpart of `kubernetes_tpu/cmd/daemons.py`'s `start_scheduler`
and `scheduler_main`, with its flags and routing: an HTTP client of the
apiserver at URL, informer-fed caches, and one of the daemons of
`scheduler.daemon`:

- `--batch`, `--batch-mode` other than scan, or a sidecar, with the
  default policy, no sidecar and no `--batch-full-relower`, boots the
  incremental daemon (`IncrementalBatchScheduler`), as does
  `--batch-incremental`;
- with a batch flag, a policy file (JSON), a sidecar socket or
  `--batch-full-relower` boots the full re-lower `BatchScheduler`: a
  policy that lowers runs on the policy scan kernel, one that does not
  on the scalar path, and a sidecar solves in its own process;
- `--batch-incremental` with a policy or a sidecar exits with the JAX
  package's message;
- without a batch flag (`--policy-config-file` and
  `--batch-full-relower` alone are none), the per-pod `Scheduler`: the
  scalar plugins on the host, one bind a pod.

The batch daemons solve on the CUDA card (`--device cpu` runs the plain
PyTorch path on the CPU; without a card and without it, the command
raises before it contacts the apiserver). The per-pod daemon, the
scalar-policy route and the sidecar route touch no card and need no
`--device`. `--batch-mode auto` is the scan on one card.

`--leader-elect` runs the daemon only while this process holds the
`kube-scheduler` lock (`utils/leaderelect.HAHotStandby`, the JAX
command's wrapper; `--leader-elect-identity`, default host-pid): a
standby process is up and idle, and builds its daemon cold (LIST,
session, prewarm) when the lock falls to it. The warm standby
(`scheduler/standby.HAScheduler`) is a library class, as in JAX.

`--healthz-port` (default 10251, the JAX scheduler's; negative
disables) serves `/healthz` (200 while the daemon's loop runs, and
always under `--leader-elect`, whose wrapper has no loop of its own),
`/metrics` and the scheduler's `/debug/*` views
(`cmd/daemons.HealthServer`): decisions, solves and traces of the
flight recorder, slo, capacity, rebalance, kernels, device-profile,
stacks and profile. A port that is taken prints a warning and the
daemon runs on. It runs until SIGTERM or SIGINT, or exits 1 when a
batch daemon stops after a failed tick; under `--leader-elect` it
watches the wrapper's current daemon and exits 1 the same way, so its
lease lapses and a rival takes over (a departure: the JAX command waits
on with a dead daemon and a live lease).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import sys
import threading
from typing import List, Optional

from kubernetes_tpu_torch import default_device


def scheduler_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kubernetes_tpu_torch.cmd.scheduler")
    p.add_argument("--server", "-s", default="http://127.0.0.1:8080", help="apiserver base URL")
    p.add_argument("--algorithm-provider", default="DefaultProvider")
    p.add_argument("--policy-config-file", default="",
                   help="JSON scheduler policy (plugin/pkg/scheduler/api); with a batch flag "
                        "the full re-lower daemon runs it, alone the per-pod scheduler")
    p.add_argument("--batch", action="store_true",
                   help="batch mode on the card: with the default policy and no sidecar the "
                        "incremental session daemon, else the full re-lower daemon; without "
                        "it, the per-pod scheduler")
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
                   help="where a batch daemon solves (default: the CUDA card)")
    p.add_argument("--leader-elect", action="store_true",
                   help="run hot-standby: only the holder of the kube-scheduler lock is active "
                        "(contrib/pod-master analog)")
    p.add_argument("--leader-elect-identity", default="")
    return p


def route(args) -> str:
    """"incremental", "full" or "scalar" (the per-pod daemon) for parsed
    `args`, as the JAX command routes them; exits on a combination it
    refuses."""
    custom = args.policy_config_file or args.solver_sidecar
    wants_batch = args.batch or args.batch_mode != "scan" or args.solver_sidecar
    if args.batch_incremental or (wants_batch and not args.batch_full_relower and not custom):
        if custom:
            raise SystemExit(
                "--batch-incremental supports the default policy only "
                "(drop --policy-config-file/--solver-sidecar, "
                "or drop --batch-incremental)"
            )
        return "incremental"
    return "full" if wants_batch else "scalar"


def start_scheduler(args, client=None):
    """The started daemon for parsed `args`, or under `--leader-elect`
    the started `HAHotStandby` that builds it while leading (the device
    is checked before the apiserver is contacted)."""
    which = route(args)
    policy = None
    if args.policy_config_file:
        with open(args.policy_config_file) as f:
            policy = json.load(f)
    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.scheduler.daemon import (
        BatchScheduler,
        IncrementalBatchScheduler,
        Scheduler,
        SchedulerConfig,
        lowers,
    )
    from kubernetes_tpu_torch.scheduler.plugins import spec_for_policy

    # The per-pod, scalar-policy and sidecar routes solve elsewhere than
    # on this card.
    card = (which != "scalar" and not args.solver_sidecar
            and (policy is None or lowers(spec_for_policy(policy))))
    device = None
    if card:
        device = "cpu" if args.device == "cpu" else default_device()
    client = client or Client(HTTPTransport(args.server))

    def factory():
        config = SchedulerConfig(client, provider_name=args.algorithm_provider, policy=policy,
                                 raw_scheduled_cache=which == "incremental").start()
        config.wait_for_sync()
        if which == "incremental":
            return IncrementalBatchScheduler(config, mode=args.batch_mode,
                                             prewarm_buckets=args.prewarm_buckets,
                                             device=device).start()
        if which == "full":
            return BatchScheduler(config, mode=args.batch_mode,
                                  sidecar_path=args.solver_sidecar or None,
                                  device=device).start()
        return Scheduler(config).start()

    return _maybe_ha(args, client, "kube-scheduler", factory)


def _maybe_ha(args, client, lock_name: str, factory):
    """The factory's daemon, or with `--leader-elect` a started
    `HAHotStandby` around the factory."""
    if not args.leader_elect:
        return factory()
    from kubernetes_tpu_torch.utils.leaderelect import HAHotStandby

    identity = args.leader_elect_identity or f"{socket.gethostname()}-{os.getpid()}"
    return HAHotStandby(client, lock_name, identity, factory).start()


def _loop_died(daemon) -> bool:
    """Whether the daemon's loop has ended on its own: under
    `--leader-elect`, the wrapper's current daemon's (one the wrapper
    stopped on losing the lock is no longer current)."""
    current = getattr(daemon, "elector", None) and daemon.daemon
    d = current if current is not None else daemon
    t = getattr(d, "_thread", None)
    if t is None or t.is_alive():
        return False
    return d is daemon or daemon.daemon is d


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
            if _loop_died(daemon):
                print("scheduler stopped after a failed tick", file=sys.stderr)
                return 1
    finally:
        daemon.stop()
        if health is not None:
            health.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
