"""kubernetes_tpu_torch: the batched scheduler in PyTorch and CUDA.

The PyTorch port of `kubernetes_tpu`'s device path, for one NVIDIA
Hopper card. It mirrors the JAX package's module paths
(`kubernetes_tpu_torch/ops/solver.py` is the counterpart of
`kubernetes_tpu/ops/solver.py`) and keeps its own copy of the host
modules it needs: it imports torch and numpy, never JAX and nothing of
`kubernetes_tpu`.

Entry points take a `device` argument. With none they run on `cuda`
and raise when there is no card; they never carry on on the CPU unless
the caller asks for it with `device="cpu"`.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Union

if TYPE_CHECKING:
    import torch

#: The JAX package's version, which the apiserver's /version and swagger
#: document report.
__version__ = "0.1.0"

# torch is imported where a device is resolved, not with the package:
# the apiserver's process is host code and never loads it.
DeviceLike = Union[str, "torch.device", None]


def default_device() -> "torch.device":
    """The port's device: the current CUDA card. Raises when CUDA is
    unavailable (the port never falls back to the CPU on its own)."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "kubernetes_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' explicitly to run the plain "
            "PyTorch path on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: DeviceLike = None) -> "torch.device":
    """`device` as a torch.device; None means default_device()."""
    import torch

    if device is None:
        return default_device()
    return torch.device(device)


__all__ = ["default_device", "resolve_device", "DeviceLike", "__version__"]
