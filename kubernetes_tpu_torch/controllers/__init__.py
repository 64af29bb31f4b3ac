"""Reconciliation controllers.

The port's copy of `kubernetes_tpu/controllers/` without the cloud
controllers (reference: pkg/controller/ (replication), pkg/service/
(endpoints), pkg/cloudprovider/nodecontroller/ (node lifecycle),
aggregated by cmd/kube-controller-manager): `ControllerManager` and the
controllers it runs are host code and load neither torch nor numpy
until a controller that drives the card is asked for. The descheduler
(defrag moves over K2) and the autoscaler (elastic node pools over the
capacity columns) are imported on first use, so the controller-manager's
process never imports torch unless it runs them.
"""

from kubernetes_tpu_torch.controllers.endpoints import EndpointsController
from kubernetes_tpu_torch.controllers.manager import ControllerManager
from kubernetes_tpu_torch.controllers.nodelifecycle import NodeLifecycleController
from kubernetes_tpu_torch.controllers.replication import ReplicationManager

__all__ = [
    "ReplicationManager",
    "EndpointsController",
    "NodeLifecycleController",
    "ControllerManager",
    "Autoscaler",
    "Descheduler",
]


def __getattr__(name):
    if name == "Autoscaler":
        from kubernetes_tpu_torch.controllers.autoscaler import Autoscaler

        return Autoscaler
    if name == "Descheduler":
        from kubernetes_tpu_torch.controllers.descheduler import Descheduler

        return Descheduler
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
