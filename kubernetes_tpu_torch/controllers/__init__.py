"""Controllers that drive the device: the descheduler (defrag moves over
K2) and the autoscaler (elastic node pools over the capacity columns)."""

from kubernetes_tpu_torch.controllers.autoscaler import Autoscaler
from kubernetes_tpu_torch.controllers.descheduler import Descheduler

__all__ = ["Autoscaler", "Descheduler"]
