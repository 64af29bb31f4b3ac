"""kubeconfig file loading.

Reference: pkg/client/clientcmd/ — clusters/users/contexts files with a
current-context pointer, merged with command-line overrides. This loads
the same schema (YAML or JSON) and resolves the pieces ktctl needs:
server URL and auth credentials.

A copy of `kubernetes_tpu/client/kubeconfig.py`; files written by
either package load in the other (both save JSON). One departure: a
file that is not JSON is read with PyYAML, imported only then, and
without PyYAML installed that is a `KubeconfigError` saying so (JAX's
raises the ImportError).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, Optional

DEFAULT_PATHS = (
    os.path.expanduser("~/.ktconfig"),
    os.path.expanduser("~/.kube/config"),
)


class KubeconfigError(Exception):
    pass


@dataclass
class ClientConfig:
    """Resolved connection settings for one context."""

    server: str = "http://127.0.0.1:8080"
    username: str = ""
    password: str = ""
    token: str = ""
    context: str = ""
    namespace: str = ""

    def auth_headers(self) -> Dict[str, str]:
        if self.token:
            return {"Authorization": f"Bearer {self.token}"}
        if self.username:
            import base64

            cred = base64.b64encode(
                f"{self.username}:{self.password}".encode()
            ).decode()
            return {"Authorization": f"Basic {cred}"}
        return {}


def _parse(text: str) -> dict:
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        try:
            import yaml
        except ImportError:
            raise KubeconfigError(
                "kubeconfig is not JSON and PyYAML, which reads YAML, is not installed"
            )
        try:
            data = yaml.safe_load(text)
        except yaml.YAMLError as e:
            raise KubeconfigError(f"malformed kubeconfig: {e}")
    if not isinstance(data, dict):
        raise KubeconfigError("kubeconfig is not a mapping")
    return data


def _by_name(entries, name: str) -> Optional[dict]:
    for e in entries or []:
        if e.get("name") == name:
            return e
    return None


def config_path(path: Optional[str] = None) -> str:
    """The file `ktctl config` subcommands read and write: explicit
    path, $KTCONFIG/$KUBECONFIG, an existing default, else the first
    default location (created on first write) — mirroring clientcmd's
    ModifyConfig destination rules."""
    if path:
        return path
    for var in ("KTCONFIG", "KUBECONFIG"):
        if os.environ.get(var):
            return os.environ[var]
    for p in DEFAULT_PATHS:
        if os.path.exists(p):
            return p
    return DEFAULT_PATHS[0]


def load_raw(path: str) -> dict:
    """The kubeconfig file as a plain dict (empty skeleton when the
    file doesn't exist yet)."""
    if not os.path.exists(path):
        return {
            "apiVersion": "v1",
            "kind": "Config",
            "clusters": [],
            "users": [],
            "contexts": [],
            "current-context": "",
        }
    with open(path) as f:
        data = _parse(f.read())
    for section in ("clusters", "users", "contexts"):
        data.setdefault(section, [])
    return data


def save_raw(path: str, data: dict) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")


def set_entry(data: dict, section: str, name: str, body_key: str, body: dict) -> None:
    """Create-or-merge a named clusters/users/contexts entry (clientcmd
    set-cluster/set-credentials/set-context semantics: existing keys
    not mentioned are kept)."""
    entry = _by_name(data.get(section), name)
    if entry is None:
        entry = {"name": name, body_key: {}}
        data.setdefault(section, []).append(entry)
    entry.setdefault(body_key, {}).update(body)


def load_kubeconfig(
    path: Optional[str] = None, context: Optional[str] = None
) -> ClientConfig:
    """Load and resolve a kubeconfig. Search order mirrors the
    reference loader: explicit path, $KTCONFIG / $KUBECONFIG, then the
    default home locations; a missing file yields defaults (local
    cluster), a malformed one raises."""
    if path:
        # An EXPLICIT path must exist — falling back to the operator's
        # personal config would silently point writes elsewhere.
        if not os.path.exists(path):
            raise KubeconfigError(f"kubeconfig {path!r} not found")
        chosen = path
    else:
        candidates = [
            os.environ[var]
            for var in ("KTCONFIG", "KUBECONFIG")
            if os.environ.get(var)
        ]
        candidates.extend(DEFAULT_PATHS)
        chosen = next((c for c in candidates if os.path.exists(c)), None)
        if chosen is None:
            return ClientConfig()
    with open(chosen) as f:
        data = _parse(f.read())

    ctx_name = context or data.get("current-context", "")
    ctx = _by_name(data.get("contexts"), ctx_name)
    if ctx is None and ctx_name:
        # A NAMED context that doesn't exist is an error (clientcmd
        # validation) — silently defaulting to localhost would point
        # writes at the wrong cluster.
        raise KubeconfigError(f"context {ctx_name!r} not found in {chosen}")
    ctx = ctx or {}
    ctx_body = ctx.get("context", {})
    cluster = _by_name(data.get("clusters"), ctx_body.get("cluster", "")) or {}
    user = _by_name(data.get("users"), ctx_body.get("user", "")) or {}
    cluster_body = cluster.get("cluster", {})
    user_body = user.get("user", {})
    return ClientConfig(
        server=cluster_body.get("server", "http://127.0.0.1:8080"),
        username=user_body.get("username", ""),
        password=user_body.get("password", ""),
        token=user_body.get("token", ""),
        context=ctx_name,
        namespace=ctx_body.get("namespace", ""),
    )
