"""kubectl-style CLI (`ktctl`), the port's copy of `kubernetes_tpu/cli/`.

Reference: pkg/kubectl/ — command tree (get, create, delete, describe,
scale, label, expose, config), resource builder over files/stdin,
printers. Entry point: kubernetes_tpu_torch.cli.main, also
`python -m kubernetes_tpu_torch.cli` and
`python -m kubernetes_tpu_torch.cmd.hyperkube ktctl`.
"""

from kubernetes_tpu_torch.cli.ktctl import main

__all__ = ["main"]
