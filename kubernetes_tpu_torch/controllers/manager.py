"""ControllerManager: launches all control loops against one client.

Reference: cmd/kube-controller-manager/app/controllermanager.go:201-263.

The port's copy of `kubernetes_tpu/controllers/manager.py`: the same
arguments, and the same controllers in the same order (replication,
endpoints, node lifecycle, namespace, resource quota, service accounts
with the token controller when given a token manager, gangs sharing the
replication manager's pods informer, the descheduler and the autoscaler
behind `enable_descheduler` and `autoscaler_pool`, the claim binder and
the recycler). The cloud controllers (cloud nodes, service load
balancers, routes) are not ported yet: a `cloud_provider` raises
`CloudControllersNotPorted` rather than run without them.
"""

from __future__ import annotations

from typing import List, Optional

from kubernetes_tpu_torch.controllers.endpoints import EndpointsController
from kubernetes_tpu_torch.controllers.gangs import GangController
from kubernetes_tpu_torch.controllers.namespace import NamespaceManager
from kubernetes_tpu_torch.controllers.nodelifecycle import NodeLifecycleController
from kubernetes_tpu_torch.controllers.replication import ReplicationManager
from kubernetes_tpu_torch.controllers.resourcequota import ResourceQuotaManager
from kubernetes_tpu_torch.controllers.serviceaccounts import (
    ServiceAccountsController,
    TokenController,
)
from kubernetes_tpu_torch.controllers.pvrecycler import PersistentVolumeRecycler
from kubernetes_tpu_torch.controllers.volumeclaimbinder import (
    PersistentVolumeClaimBinder,
)


class CloudControllersNotPorted(NotImplementedError):
    """A cloud provider was given: the cloud controllers it would run
    are not in the port yet."""


class ControllerManager:
    def __init__(
        self,
        client,
        enable_replication: bool = True,
        enable_endpoints: bool = True,
        enable_node_lifecycle: bool = True,
        enable_namespace: bool = True,
        enable_resource_quota: bool = True,
        enable_service_accounts: bool = True,
        enable_pv_binder: bool = True,
        enable_gangs: bool = True,
        # Rebalancing plane: the descheduler actively EVICTS
        # bound pods, so it is strictly opt-in; the autoscaler only
        # runs when handed a pool provider to resize.
        enable_descheduler: bool = False,
        descheduler_frag_threshold: float = 0.5,
        autoscaler_pool=None,
        # Reference defaults (see nodelifecycle.py): grace 40s,
        # eviction 5min there — 120s here keeps recovery drills sane.
        node_grace_period: float = 40.0,
        node_eviction_timeout: float = 120.0,
        sa_token_manager=None,
        cloud_provider=None,
    ):
        self.controllers: List = []
        self.running = False  # live health signal (componentstatuses)
        if cloud_provider is not None:
            raise CloudControllersNotPorted(
                "the cloud controllers (cloudnodes, servicelb, routes) are not yet "
                "ported to kubernetes_tpu_torch; run without a cloud provider"
            )
        if enable_replication:
            self.replication = ReplicationManager(client)
            self.controllers.append(self.replication)
        if enable_endpoints:
            self.endpoints = EndpointsController(client)
            self.controllers.append(self.endpoints)
        if enable_node_lifecycle:
            self.node_lifecycle = NodeLifecycleController(
                client,
                grace_period=node_grace_period,
                eviction_timeout=node_eviction_timeout,
            )
            self.controllers.append(self.node_lifecycle)
        if enable_namespace:
            self.namespace = NamespaceManager(client)
            self.controllers.append(self.namespace)
        if enable_resource_quota:
            self.resource_quota = ResourceQuotaManager(client)
            self.controllers.append(self.resource_quota)
        if enable_service_accounts:
            self.service_accounts = ServiceAccountsController(client)
            self.controllers.append(self.service_accounts)
            if sa_token_manager is not None:
                self.tokens = TokenController(client, sa_token_manager)
                self.controllers.append(self.tokens)
        if enable_gangs:
            # PodGroup lifecycle: status reconcile + pending-gang aging
            # (events, Unschedulable marking) for the gang scheduler.
            # Shares the replication manager's typed pods informer when
            # present: one all-pods watch + decode per process, not two.
            self.gangs = GangController(
                client,
                pods_informer=getattr(
                    getattr(self, "replication", None), "pods", None
                ),
            )
            self.controllers.append(self.gangs)
        if enable_descheduler or autoscaler_pool is not None:
            from kubernetes_tpu_torch.controllers.descheduler import Descheduler

            self.descheduler = Descheduler(
                client, frag_threshold=descheduler_frag_threshold
            )
            if enable_descheduler:
                self.controllers.append(self.descheduler)
            if autoscaler_pool is not None:
                from kubernetes_tpu_torch.controllers.autoscaler import Autoscaler

                self.autoscaler = Autoscaler(
                    client, autoscaler_pool, descheduler=self.descheduler
                )
                self.controllers.append(self.autoscaler)
        if enable_pv_binder:
            self.pv_binder = PersistentVolumeClaimBinder(client)
            self.controllers.append(self.pv_binder)
            # The binder's other half: Released+Recycle -> scrub ->
            # Available (persistent_volume_recycler.go rides alongside
            # the claim binder in the reference controller-manager).
            self.pv_recycler = PersistentVolumeRecycler(client)
            self.controllers.append(self.pv_recycler)

    def start(self) -> "ControllerManager":
        for c in self.controllers:
            c.start()
        self.running = True
        return self

    def stop(self) -> None:
        self.running = False
        for c in self.controllers:
            c.stop()
