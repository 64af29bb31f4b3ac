"""CloudNodeController: sync Node objects with the cloud's instances.

Reference: pkg/cloudprovider/nodecontroller/nodecontroller.go:99-180 —
with --sync_nodes the controller registers a Node per cloud instance
and deletes Nodes whose instance disappeared; zone/instance-type
surface as node labels. Here the instance list is the machine's card
inventory (cloudprovider/gpu.py), so adding or removing hosts shows up
as nodes joining/leaving the cluster.

The port's copy of `kubernetes_tpu/controllers/cloudnodes.py`. Nodes
are read in wire form (`Client.list_wire`) and decoded into the whole
model (`models/apiobjects.py`), and a registered node is built in it,
so its labels, capacity and conditions reach the apiserver whole.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from kubernetes_tpu_torch.client.rest import APIError
from kubernetes_tpu_torch.cloudprovider.interface import CloudProvider
from kubernetes_tpu_torch.models import serde
from kubernetes_tpu_torch.models.apiobjects import Node, NodeCondition
from kubernetes_tpu_torch.models.quantity import parse_quantity
from kubernetes_tpu_torch.utils import metrics

LABEL_INSTANCE_TYPE = "node.kubernetes-tpu.io/instance-type"
LABEL_ZONE = "failure-domain.kubernetes-tpu.io/zone"
LABEL_REGION = "failure-domain.kubernetes-tpu.io/region"
LABEL_MANAGED = "node.kubernetes-tpu.io/managed-by"

_LOG = logging.getLogger("kubernetes_tpu_torch.controllers.cloudnodes")

_SYNCS = metrics.DEFAULT.counter(
    "cloud_node_syncs_total", "cloud node sync actions", ("action",)
)


class CloudNodeController:
    def __init__(
        self,
        client,
        provider: CloudProvider,
        sync_period: float = 5.0,
        default_cpu: str = "4",
        default_memory: str = "8Gi",
        max_pods: int = 110,
    ):
        self.client = client
        self.provider = provider
        self.sync_period = sync_period
        self.default_cpu = default_cpu
        self.default_memory = default_memory
        self.max_pods = max_pods
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "CloudNodeController":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=3)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.sync_once()
            except Exception:
                _LOG.exception("cloud-node sync pass failed")
                _SYNCS.inc(action="error")
            self._stop.wait(self.sync_period)

    def sync_once(self) -> int:
        """Register missing nodes, delete departed ones. Returns the
        number of changes made."""
        instances = self.provider.instances()
        if instances is None:
            return 0
        changed = 0
        want = {}
        for inst in instances:
            want[inst.name] = inst
        wires, _ = self.client.list_wire("nodes")
        have_names = set()
        for node in (serde.from_wire(Node, w) for w in wires):
            have_names.add(node.metadata.name)
            if node.metadata.name not in want:
                # Only reap nodes THIS controller registered; manually
                # registered nodes (self-registering kubelets) are not
                # the cloud's to delete.
                if node.metadata.labels.get(LABEL_MANAGED) == "cloud":
                    try:
                        self.client.delete("nodes", node.metadata.name)
                        changed += 1
                        _SYNCS.inc(action="delete")
                    except APIError:
                        pass
        for name, inst in want.items():
            if name in have_names:
                continue
            if self._register(inst):
                changed += 1
                _SYNCS.inc(action="register")
        return changed

    def _register(self, inst) -> bool:
        node = Node()
        node.metadata.name = inst.name
        labels = dict(inst.labels_dict())
        labels[LABEL_MANAGED] = "cloud"
        if inst.instance_type:
            labels[LABEL_INSTANCE_TYPE] = inst.instance_type
        zone = self.provider.zone_of(inst.name)
        if zone is not None:
            labels[LABEL_ZONE] = zone.failure_domain.replace("/", "_")
            labels[LABEL_REGION] = zone.region
        node.metadata.labels = labels
        node.status.capacity = {
            "cpu": parse_quantity(self.default_cpu),
            "memory": parse_quantity(self.default_memory),
            "pods": parse_quantity(str(self.max_pods)),
        }
        # Registered without a heartbeat: Ready=Unknown until a kubelet
        # on that host reports in (nodecontroller.go registers with
        # status unknown similarly).
        node.status.conditions = [
            NodeCondition(type="Ready", status="Unknown", reason="CloudRegistered")
        ]
        try:
            self.client.create("nodes", serde.to_wire(node))
            return True
        except APIError as e:
            if e.code != 409:  # 409: a kubelet self-registered first — fine
                _SYNCS.inc(action="error")
            return False
