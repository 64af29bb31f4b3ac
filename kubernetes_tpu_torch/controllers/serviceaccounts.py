"""ServiceAccount + token controllers.

Reference: pkg/serviceaccount/serviceaccounts_controller.go (ensure a
'default' ServiceAccount exists in every active namespace) and
tokens_controller.go (mint a signed API token Secret for every
ServiceAccount and reference it from sa.secrets).

Token format: HMAC-SHA256 JWT from
kubernetes_tpu_torch.server.auth.ServiceAccountTokenManager (the reference
signs RS256; see auth.py module docstring for the deviation note).

The port's copy of `kubernetes_tpu/controllers/serviceaccounts.py`,
minting with the port's `server/auth.py` token manager.
"""

from __future__ import annotations

import base64
import logging
import threading
from typing import Optional

from kubernetes_tpu_torch.models.apiobjects import ObjectReference
from kubernetes_tpu_torch.client.rest import APIError
from kubernetes_tpu_torch.server.auth import ServiceAccountTokenManager
from kubernetes_tpu_torch.utils import metrics

DEFAULT_SERVICE_ACCOUNT = "default"
SECRET_TYPE_SA_TOKEN = "kubernetes.io/service-account-token"

_LOG = logging.getLogger("kubernetes_tpu_torch.controllers.serviceaccounts")

_SYNCS = metrics.DEFAULT.counter(
    "serviceaccount_controller_syncs_total", "SA sync passes", ("result",)
)


class ServiceAccountsController:
    """Ensure every Active namespace has a 'default' ServiceAccount."""

    def __init__(self, client, sync_period: float = 5.0):
        self.client = client
        self.sync_period = sync_period
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ServiceAccountsController":
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
                _LOG.exception("serviceaccount sync pass failed")
                _SYNCS.inc(result="error")
            self._stop.wait(self.sync_period)

    def sync_once(self) -> int:
        created = 0
        namespaces, _ = self.client.list("namespaces")
        for ns in namespaces:
            if ns.status.phase != "Active":
                continue
            name = ns.metadata.name
            try:
                self.client.get(
                    "serviceaccounts", DEFAULT_SERVICE_ACCOUNT, namespace=name
                )
            except APIError:
                try:
                    self.client.create(
                        "serviceaccounts",
                        {
                            "kind": "ServiceAccount",
                            "metadata": {
                                "name": DEFAULT_SERVICE_ACCOUNT,
                                "namespace": name,
                            },
                        },
                        namespace=name,
                    )
                    created += 1
                    _SYNCS.inc(result="created")
                except APIError:
                    pass  # racing creator / terminating namespace
        return created


class TokenController:
    """Mint an API token Secret for ServiceAccounts that lack one."""

    def __init__(
        self,
        client,
        token_manager: ServiceAccountTokenManager,
        sync_period: float = 5.0,
    ):
        self.client = client
        self.tokens = token_manager
        self.sync_period = sync_period
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "TokenController":
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
                _LOG.exception("serviceaccount token sync pass failed")
                _SYNCS.inc(result="error")
            self._stop.wait(self.sync_period)

    def sync_once(self) -> int:
        minted = 0
        accounts, _ = self.client.list("serviceaccounts")
        for sa in accounts:
            if any(
                ref.name.startswith(f"{sa.metadata.name}-token")
                for ref in sa.secrets
            ):
                continue
            if self._mint(sa):
                minted += 1
        return minted

    def _mint(self, sa) -> bool:
        ns = sa.metadata.namespace
        secret_name = f"{sa.metadata.name}-token"
        token = self.tokens.mint(
            ns, sa.metadata.name, uid=sa.metadata.uid, secret_name=secret_name
        )
        secret = {
            "kind": "Secret",
            "metadata": {
                "name": secret_name,
                "namespace": ns,
                "annotations": {
                    "kubernetes.io/service-account.name": sa.metadata.name,
                    "kubernetes.io/service-account.uid": sa.metadata.uid,
                },
            },
            "type": SECRET_TYPE_SA_TOKEN,
            "data": {"token": base64.b64encode(token.encode()).decode()},
        }
        try:
            self.client.create("secrets", secret, namespace=ns)
        except APIError as e:
            if e.code != 409:  # already minted by a racing sync
                return False
        sa.secrets.append(
            ObjectReference(kind="Secret", namespace=ns, name=secret_name)
        )
        try:
            self.client.update("serviceaccounts", sa, namespace=ns)
            _SYNCS.inc(result="minted")
            return True
        except APIError:
            return False
