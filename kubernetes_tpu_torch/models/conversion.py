"""Multi-version API: wire-level conversion between v1 and v1beta3.

Reference: pkg/api/latest/latest.go:32-78 (version negotiation;
OldestVersion = v1beta3) and pkg/api/v1beta3/conversion.go — the
semantic (non-mechanical) differences between the two wire forms:

- PodSpec:      v1beta3 "host"      <-> v1 "nodeName"
                (conversion.go convert_v1beta3_PodSpec_To_api_PodSpec:
                 out.NodeName = in.Host)
- ServiceSpec:  v1beta3 "portalIP"  <-> v1 "clusterIP"
                v1beta3 "createExternalLoadBalancer" <-> v1 type ==
                "LoadBalancer" (conversion.go:358-447)
                v1beta3 "publicIPs" <-> v1 "externalIPs"
- Container:    v1beta3 carries legacy top-level "capabilities" /
                "privileged" compat fields that duplicate
                securityContext (conversion.go:226-256): decoding folds
                them into securityContext (securityContext wins on
                conflict); encoding to v1beta3 emits only
                securityContext, like the reference (conversion.go:
                267-350 writes no legacy fields).
- Status:       v1beta3 details "id" <-> v1 details "name"
                (conversion.go:669-707)

TPU-first design note: the reference generates 226 struct-to-struct
conversion functions per version (pkg/api/v1/conversion_generated.go).
Our internal model IS the v1 wire shape (models/serde.py), so
conversion happens once, at the HTTP boundary, as dict rewriting —
no generated code, no parallel type hierarchy. Everything the
converters don't name passes through untouched (mechanical fields are
identical between the two versions).

A copy of `kubernetes_tpu/models/conversion.py`.
"""

from __future__ import annotations

import copy
from typing import Dict

VERSIONS = ("v1", "v1beta3")
PREFERRED = "v1"
OLDEST = "v1beta3"


def _convert_pod_spec_to_v1(spec: dict) -> None:
    if "host" in spec:
        spec.setdefault("nodeName", spec.pop("host"))
    for c in spec.get("containers") or []:
        if not isinstance(c, dict):
            continue
        caps = c.pop("capabilities", None)
        priv = c.pop("privileged", None)
        if caps is not None or priv:
            sc = c.setdefault("securityContext", {})
            if caps is not None:
                sc.setdefault("capabilities", caps)
            if priv:
                sc.setdefault("privileged", priv)


def _convert_pod_spec_to_v1beta3(spec: dict) -> None:
    if "nodeName" in spec:
        spec.setdefault("host", spec.pop("nodeName"))


def _convert_service_spec_to_v1(spec: dict) -> None:
    if "portalIP" in spec:
        spec.setdefault("clusterIP", spec.pop("portalIP"))
    if "publicIPs" in spec:
        spec.setdefault("externalIPs", spec.pop("publicIPs"))
    if "type" not in spec:
        # The bool selects LoadBalancer only when type is ABSENT —
        # when both are present, type wins and the bool is ignored,
        # exactly like the reference (conversion.go:381-388:
        # `typeIn := in.Type; if typeIn == "" { ...bool... }`). Yes,
        # that means a v1beta3 client flipping only the bool on an
        # object that carries type is ignored; reference parity over
        # intuition here.
        if spec.pop("createExternalLoadBalancer", False):
            spec["type"] = "LoadBalancer"
    else:
        spec.pop("createExternalLoadBalancer", None)


def _convert_service_spec_to_v1beta3(spec: dict) -> None:
    if "clusterIP" in spec:
        spec.setdefault("portalIP", spec.pop("clusterIP"))
    if "externalIPs" in spec:
        spec.setdefault("publicIPs", spec.pop("externalIPs"))
    if spec.get("type") == "LoadBalancer":
        spec["createExternalLoadBalancer"] = True


def _walk(wire: dict, to_v1: bool, version: str) -> None:
    """Apply kind-specific conversions in place (recursing into lists
    and pod templates)."""
    kind = wire.get("kind", "")
    if kind.endswith("List"):
        for item in wire.get("items", []):
            if isinstance(item, dict):
                _walk(item, to_v1, version)
                # Items self-describe their version; converted fields
                # must carry the matching apiVersion.
                if "apiVersion" in item:
                    item["apiVersion"] = "v1" if to_v1 else version
        return
    if kind == "Pod":
        spec = wire.get("spec")
        if isinstance(spec, dict):
            (_convert_pod_spec_to_v1 if to_v1 else _convert_pod_spec_to_v1beta3)(spec)
    elif kind == "Service":
        spec = wire.get("spec")
        if isinstance(spec, dict):
            (
                _convert_service_spec_to_v1
                if to_v1
                else _convert_service_spec_to_v1beta3
            )(spec)
    elif kind == "Status":
        details = wire.get("details")
        if isinstance(details, dict):
            if to_v1 and "id" in details:
                details.setdefault("name", details.pop("id"))
            elif not to_v1 and "name" in details:
                details.setdefault("id", details.pop("name"))
    elif kind in ("ReplicationController", "PodTemplate"):
        spec = wire.get("spec", {})
        template = (
            spec.get("template") if kind == "ReplicationController" else wire.get("template")
        )
        if isinstance(template, dict) and isinstance(template.get("spec"), dict):
            (
                _convert_pod_spec_to_v1
                if to_v1
                else _convert_pod_spec_to_v1beta3
            )(template["spec"])
    # Bindings arrive as {"target": {...}} in both versions — no-op.


def to_internal(wire: dict, version: str) -> dict:
    """Decode any supported wire version into the internal (v1) form."""
    if version == "v1" or not isinstance(wire, dict):
        return wire
    if version not in VERSIONS:
        raise ValueError(f"unknown API version {version!r}")
    out = copy.deepcopy(wire)
    _walk(out, to_v1=True, version=version)
    if out.get("apiVersion") == version:
        out["apiVersion"] = "v1"
    return out


def from_internal(wire: dict, version: str) -> dict:
    """Encode the internal (v1) form into the requested wire version."""
    if version == "v1" or not isinstance(wire, dict):
        return wire
    if version not in VERSIONS:
        raise ValueError(f"unknown API version {version!r}")
    out = copy.deepcopy(wire)
    _walk(out, to_v1=False, version=version)
    if out.get("apiVersion") == "v1":
        out["apiVersion"] = version
    return out
