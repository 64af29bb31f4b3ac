"""Dataclass <-> wire (camelCase JSON) codec.

A copy of `kubernetes_tpu/models/serde.py` over the port's objects (the
role of the reference's runtime.Codec, pkg/runtime/scheme.go): every
API object encodes to the camelCase JSON wire form and decodes back
into the port's dataclasses, recursively, driven by type hints.
Unknown wire fields are ignored, so richer manifests still load;
zero-valued fields are
omitted on encode like Go's `omitempty`. Encode and decode plans are
built once per class.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, Type, get_args, get_origin, get_type_hints

from kubernetes_tpu_torch.models.quantity import Quantity, parse_quantity

_SPECIAL_CAMEL = {
    # Wire names that simple snake->camel conversion would get wrong.
    "api_version": "apiVersion",
    "cluster_ip": "clusterIP",
    "pod_ip": "podIP",
    "host_ip": "hostIP",
    "external_ips": "externalIPs",
    "node_port": "nodePort",
    "target_port": "targetPort",
    "host_port": "hostPort",
    "container_port": "containerPort",
    "image_pull_policy": "imagePullPolicy",
    "tcp_socket": "tcpSocket",
    "http_get": "httpGet",
    "uid": "uid",
}


def snake_to_camel(name: str) -> str:
    if name in _SPECIAL_CAMEL:
        return _SPECIAL_CAMEL[name]
    parts = name.split("_")
    return parts[0] + "".join(p.capitalize() for p in parts[1:])


def _is_zero(v: Any) -> bool:
    if v is None:
        return True
    if isinstance(v, (list, dict, str)) and not v:
        return True
    if isinstance(v, bool):
        return v is False
    if isinstance(v, int):
        return v == 0
    if isinstance(v, Quantity):
        return v.is_zero()
    return False


_encode_plan_cache: Dict[type, tuple] = {}


def _encode_plan(cls: type) -> tuple:
    """(attribute, wire key, always encode) per field, built once."""
    plan = _encode_plan_cache.get(cls)
    if plan is None:
        plan = tuple(
            (
                f.name,
                f.metadata.get("wire", snake_to_camel(f.name)),
                bool(f.metadata.get("always")),
            )
            for f in dataclasses.fields(cls)
        )
        _encode_plan_cache[cls] = plan
    return plan


def to_wire(obj: Any, *, omit_empty: bool = True) -> Any:
    """Recursively encode a dataclass (or container) to wire-form JSON."""
    if obj is None:
        return None
    if isinstance(obj, Quantity):
        return str(obj)
    if dataclasses.is_dataclass(obj):
        out: Dict[str, Any] = {}
        for name, wire_key, always in _encode_plan(type(obj)):
            v = getattr(obj, name)
            if omit_empty and not always and _is_zero(v):
                continue
            out[wire_key] = to_wire(v, omit_empty=omit_empty)
        return out
    if isinstance(obj, dict):
        return {k: to_wire(v, omit_empty=omit_empty) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_wire(v, omit_empty=omit_empty) for v in obj]
    return obj


_decode_plan_cache: Dict[type, Dict[str, tuple]] = {}

_SCALAR_HINTS = (str, int, float, bool)


def _copy_raw(v: Any) -> Any:
    """Deep-copy an untyped wire leaf: watch events may share one object
    between consumers, so a decoded object never aliases it."""
    if isinstance(v, dict):
        return {k: _copy_raw(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_copy_raw(x) for x in v]
    return v


def _decoder_for(hint: Any):
    """A decoder for one type hint (None: scalar, pass through).
    Callers handle a None value before calling it."""
    origin = get_origin(hint)
    if origin is typing.Union:  # Optional[T]
        args = [a for a in get_args(hint) if a is not type(None)]
        if len(args) == 1:
            return _decoder_for(args[0])
        return _copy_raw
    if hint is Quantity:
        return parse_quantity
    if dataclasses.is_dataclass(hint):
        return lambda v, _c=hint: from_wire(_c, v)
    if origin in (list, typing.List):
        (elem,) = get_args(hint) or (Any,)
        ed = _decoder_for(elem)
        if ed is None:
            return list
        return lambda v, _d=ed: [None if x is None else _d(x) for x in v]
    if origin in (dict, typing.Dict):
        args = get_args(hint)
        vd = _decoder_for(args[1] if len(args) == 2 else Any)
        if vd is None:
            return dict
        return lambda v, _d=vd: {k: None if x is None else _d(x) for k, x in v.items()}
    if hint in _SCALAR_HINTS:
        return None
    return _copy_raw


def _decode_plan(cls: type) -> Dict[str, tuple]:
    """wire key -> (attribute, decoder) per field, built once."""
    plan = _decode_plan_cache.get(cls)
    if plan is None:
        hints = get_type_hints(cls)
        plan = {
            f.metadata.get("wire", snake_to_camel(f.name)): (f.name, _decoder_for(hints[f.name]))
            for f in dataclasses.fields(cls)
        }
        _decode_plan_cache[cls] = plan
    return plan


def from_wire(cls: Type, data: Dict[str, Any] | None):
    """Decode wire-form JSON into dataclass `cls`, ignoring unknown keys."""
    if data is None:
        return None
    if not isinstance(data, dict):
        raise ValueError(f"cannot decode {cls.__name__} from {type(data).__name__}")
    plan = _decode_plan(cls)
    kwargs: Dict[str, Any] = {}
    for wire_key, v in data.items():
        ent = plan.get(wire_key)
        if ent is None:
            continue
        name, dec = ent
        kwargs[name] = v if v is None or dec is None else dec(v)
    return cls(**kwargs)
