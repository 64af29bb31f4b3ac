"""hyperkube: the port's daemons in one binary, dispatched on argv[1].

The port's copy of `kubernetes_tpu/cmd/hyperkube.py` (reference:
cmd/hyperkube/main.go:34-38). Routes: `apiserver`
(`cmd/daemons.apiserver_main`), `controller-manager`
(`cmd/daemons.controller_manager_main`) and `scheduler`
(`cmd/scheduler.main`). A server of the JAX command that the port does
not have yet (kubelet, proxy, ktctl, local-up-cluster) exits with code
2 and names itself as not yet ported; nothing falls through to the JAX
package.

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


def _scheduler(argv: List[str]) -> int:
    from kubernetes_tpu_torch.cmd import scheduler

    return scheduler.main(argv)


SERVERS = {"apiserver": _apiserver, "controller-manager": _controller_manager,
           "scheduler": _scheduler}

#: The JAX command's other servers, which the port has not ported yet.
NOT_PORTED = ("kubelet", "proxy", "ktctl", "local-up-cluster")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(f"usage: hyperkube <server> [flags]\nservers: {', '.join(sorted(SERVERS))}")
        return 0 if argv else 1
    name, rest = argv[0], argv[1:]
    if name in NOT_PORTED:
        print(f"error: server {name!r} is not yet ported to kubernetes_tpu_torch",
              file=sys.stderr)
        return 2
    fn = SERVERS.get(name)
    if fn is None:
        print(f"error: unknown server {name!r}", file=sys.stderr)
        return 1
    return fn(rest)


if __name__ == "__main__":
    sys.exit(main())
