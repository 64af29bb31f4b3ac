"""API server: REST + watch over the versioned store.

Reference: pkg/apiserver/ + pkg/master/ + pkg/registry/. The core
(`APIServer`) is transport-independent; `httpserver` exposes it over
HTTP with chunked watch streams. Components in the same process can
use the core directly (the reference's cmd/integration runs everything
in one process the same way).

The port's copy of `kubernetes_tpu/server/`: host code only, nothing
on its path touches the card (see `server/httpserver.py` for what
differs from the JAX apiserver).
"""

from kubernetes_tpu_torch.server.api import APIError, APIServer
from kubernetes_tpu_torch.server.registry import RESOURCES, ResourceInfo

__all__ = ["APIServer", "APIError", "RESOURCES", "ResourceInfo"]
