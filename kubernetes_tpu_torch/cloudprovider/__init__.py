"""Cloud provider layer.

Reference: pkg/cloudprovider/cloud.go — Interface{Instances,
TCPLoadBalancer, Zones, Routes, Clusters} with per-cloud
implementations and a plugin registry (pkg/cloudprovider/plugins.go).

The port's copy of `kubernetes_tpu/cloudprovider/`: the "cloud" is the
accelerator machine itself. The GPU provider (gpu.py, the counterpart
of JAX's tpu.py) inventories the host's CUDA cards through torch
instead of querying a VM API: instances are hosts, zones are hosts
within the cluster, routes a ring between hosts. The fake provider
mirrors pkg/cloudprovider/fake/fake.go. Registered: `fake` and `gpu`
(not `tpu`). Importing this package loads neither torch nor numpy.
"""

from kubernetes_tpu_torch.cloudprovider.interface import (
    CloudProvider,
    Instance,
    LoadBalancerStub,
    Route,
    Zone,
    get_provider,
    register_provider,
)
from kubernetes_tpu_torch.cloudprovider.fake import FakeCloudProvider
from kubernetes_tpu_torch.cloudprovider.gpu import GPUCloudProvider

__all__ = [
    "CloudProvider",
    "FakeCloudProvider",
    "GPUCloudProvider",
    "Instance",
    "LoadBalancerStub",
    "Route",
    "Zone",
    "get_provider",
    "register_provider",
]
