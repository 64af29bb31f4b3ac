"""Cluster addons (reference: cluster/addons/ — DNS, logging,
monitoring).

The port's copy of `kubernetes_tpu/addons/`: host code, no torch, no
numpy."""

from kubernetes_tpu_torch.addons.dns import ClusterDNS
from kubernetes_tpu_torch.addons.logging import ClusterLogAggregator
from kubernetes_tpu_torch.addons.monitoring import ClusterMonitor

__all__ = ["ClusterDNS", "ClusterLogAggregator", "ClusterMonitor"]
