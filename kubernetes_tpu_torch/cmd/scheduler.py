"""The port's scheduler daemon as a process.

    python -m kubernetes_tpu_torch.cmd.scheduler --server URL \\
        [--batch-mode scan|wave|sinkhorn] [--prewarm-buckets N] [--device cuda|cpu]

The counterpart of `kubernetes_tpu/cmd/daemons.py`'s `start_scheduler`
and `scheduler_main` for the incremental daemon: an HTTP client of the
apiserver at URL, informer-fed caches, and
`scheduler.daemon.IncrementalBatchScheduler` solving on the CUDA card
(`--device cpu` runs the plain PyTorch path on the CPU; without a card
and without it, the command raises). It always boots the incremental
daemon, which runs the default policy only: `--policy-config-file` and
`--solver-sidecar` exit with the JAX package's message for
`--batch-incremental`. It runs until SIGTERM or SIGINT.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
from typing import List, Optional

from kubernetes_tpu_torch import default_device


def scheduler_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kubernetes_tpu_torch.cmd.scheduler")
    p.add_argument("--server", "-s", default="http://127.0.0.1:8080", help="apiserver base URL")
    p.add_argument("--batch-mode", default="scan", choices=["scan", "wave", "sinkhorn"],
                   help="the tick solver: scan (sequential parity, the default), wave or "
                        "sinkhorn")
    p.add_argument("--prewarm-buckets", type=int, default=128,
                   help="run the session's launches at every pod bucket up to this size "
                        "when it is built; 0 disables")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the session lives (default: the CUDA card)")
    p.add_argument("--policy-config-file", default="", help="not supported by this daemon")
    p.add_argument("--solver-sidecar", default="", help="not supported by this daemon")
    return p


def start_scheduler(args, client=None):
    """The started daemon for parsed `args` (the device is checked
    before the apiserver is contacted)."""
    if args.policy_config_file or args.solver_sidecar:
        raise SystemExit(
            "--batch-incremental supports the default policy only "
            "(drop --policy-config-file/--solver-sidecar, "
            "or drop --batch-incremental)"
        )
    device = "cpu" if args.device == "cpu" else default_device()
    from kubernetes_tpu_torch.client.rest import Client, HTTPTransport
    from kubernetes_tpu_torch.scheduler.daemon import IncrementalBatchScheduler, SchedulerConfig

    client = client or Client(HTTPTransport(args.server))
    config = SchedulerConfig(client).start()
    config.wait_for_sync()
    return IncrementalBatchScheduler(config, mode=args.batch_mode,
                                     prewarm_buckets=args.prewarm_buckets,
                                     device=device).start()


def main(argv: Optional[List[str]] = None) -> int:
    args = scheduler_parser().parse_args(argv)
    daemon = start_scheduler(args)
    print(f"scheduler running against {args.server}", flush=True)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
