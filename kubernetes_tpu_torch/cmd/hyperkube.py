"""hyperkube: the port's daemons in one binary, dispatched on argv[1].

The port's copy of `kubernetes_tpu/cmd/hyperkube.py` (reference:
cmd/hyperkube/main.go:34-38). Routes: `apiserver`
(`cmd/daemons.apiserver_main`), `controller-manager`
(`cmd/daemons.controller_manager_main`), `kubelet`
(`cmd/daemons.kubelet_main`), `proxy` (`cmd/daemons.proxy_main`),
`scheduler` (`cmd/scheduler.main`), `local-up-cluster`
(`cmd/localup.main`) and `ktctl` (`cli/ktctl.main`, the CLI).
Nothing falls through to the JAX package.

Usage:
    python -m kubernetes_tpu_torch.cmd.hyperkube <server> [flags...]
"""

from __future__ import annotations

import sys
from typing import List, Optional


def _apiserver(argv: List[str]) -> int:
    from kubernetes_tpu_torch.cmd import daemons

    return daemons.apiserver_main(argv)


def _controller_manager(argv: List[str]) -> int:
    from kubernetes_tpu_torch.cmd import daemons

    return daemons.controller_manager_main(argv)


def _kubelet(argv: List[str]) -> int:
    from kubernetes_tpu_torch.cmd import daemons

    return daemons.kubelet_main(argv)


def _proxy(argv: List[str]) -> int:
    from kubernetes_tpu_torch.cmd import daemons

    return daemons.proxy_main(argv)


def _local_up_cluster(argv: List[str]) -> int:
    from kubernetes_tpu_torch.cmd import localup

    return localup.main(argv)


def _scheduler(argv: List[str]) -> int:
    from kubernetes_tpu_torch.cmd import scheduler

    return scheduler.main(argv)


def _ktctl(argv: List[str]) -> int:
    from kubernetes_tpu_torch.cli.ktctl import main as ktctl_main

    return ktctl_main(argv)


SERVERS = {"apiserver": _apiserver, "controller-manager": _controller_manager,
           "kubelet": _kubelet, "ktctl": _ktctl, "local-up-cluster": _local_up_cluster,
           "proxy": _proxy, "scheduler": _scheduler}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(f"usage: hyperkube <server> [flags]\nservers: {', '.join(sorted(SERVERS))}")
        return 0 if argv else 1
    name, rest = argv[0], argv[1:]
    fn = SERVERS.get(name)
    if fn is None:
        print(f"error: unknown server {name!r}", file=sys.stderr)
        return 1
    return fn(rest)


if __name__ == "__main__":
    sys.exit(main())
