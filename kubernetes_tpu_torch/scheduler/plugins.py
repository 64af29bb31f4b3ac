"""Predicate/priority plugin registry, algorithm providers, policy files.

Reference: plugin/pkg/scheduler/factory/plugins.go (registries),
plugin/pkg/scheduler/algorithmprovider/defaults/defaults.go (default
provider), plugin/pkg/scheduler/api/types.go (policy file schema).

Factories receive PluginFactoryArgs so predicates can capture listers,
mirroring the reference's PluginFactoryArgs{PodLister, ServiceLister,
NodeLister, NodeInfo}.

The port's copy of `kubernetes_tpu/scheduler/plugins.py`, line for
line: the scalar path of the full re-lower daemon (a policy that does
not lower to the card) and the yardstick the card's decisions are held
to. Pure Python; no torch.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from kubernetes_tpu_torch.models.algspec import (
    AlgorithmSpec,
    spec_from_keys,
    spec_from_policy,
)
from kubernetes_tpu_torch.scheduler import predicates as preds
from kubernetes_tpu_torch.scheduler import priorities as prios
from kubernetes_tpu_torch.scheduler.types import PriorityConfig


@dataclass
class PluginFactoryArgs:
    pod_lister: object
    service_lister: object
    node_lister: object


FitPredicateFactory = Callable[[PluginFactoryArgs], Callable]
PriorityFunctionFactory = Callable[[PluginFactoryArgs], Callable]


_lock = threading.Lock()
_fit_predicates: Dict[str, FitPredicateFactory] = {}
_priority_functions: Dict[str, PriorityFunctionFactory] = {}
_algorithm_providers: Dict[str, "AlgorithmProvider"] = {}


@dataclass
class AlgorithmProvider:
    predicate_keys: List[str]
    priority_keys: Dict[str, int]  # name -> weight


def register_fit_predicate(name: str, factory: FitPredicateFactory) -> str:
    with _lock:
        _fit_predicates[name] = factory
    return name


def register_priority_function(name: str, factory: PriorityFunctionFactory) -> str:
    with _lock:
        _priority_functions[name] = factory
    return name


def register_algorithm_provider(
    name: str, predicate_keys: Sequence[str], priority_keys: Dict[str, int]
) -> str:
    with _lock:
        _algorithm_providers[name] = AlgorithmProvider(
            list(predicate_keys), dict(priority_keys)
        )
    return name


def get_algorithm_provider(name: str) -> AlgorithmProvider:
    with _lock:
        if name not in _algorithm_providers:
            raise KeyError(f"algorithm provider {name!r} not registered")
        return _algorithm_providers[name]


def get_fit_predicates(keys: Sequence[str], args: PluginFactoryArgs) -> Dict[str, Callable]:
    with _lock:
        missing = [k for k in keys if k not in _fit_predicates]
        if missing:
            raise KeyError(f"fit predicates not registered: {missing}")
        return {k: _fit_predicates[k](args) for k in keys}


def get_priority_configs(
    keys: Dict[str, int], args: PluginFactoryArgs
) -> List[PriorityConfig]:
    with _lock:
        missing = [k for k in keys if k not in _priority_functions]
        if missing:
            raise KeyError(f"priority functions not registered: {missing}")
        return [
            PriorityConfig(function=_priority_functions[k](args), weight=w)
            for k, w in keys.items()
            if w != 0
        ]


# ---------------------------------------------------------------------------
# Built-in registrations (reference: defaults.go:29-79 init()).
# ---------------------------------------------------------------------------

register_fit_predicate("PodFitsPorts", lambda args: preds.pod_fits_ports)
register_fit_predicate(
    "PodFitsResources", lambda args: preds.ResourceFit(args.node_lister)
)
register_fit_predicate("NoDiskConflict", lambda args: preds.no_disk_conflict)
register_fit_predicate(
    "MatchNodeSelector", lambda args: preds.NodeSelectorMatches(args.node_lister)
)
register_fit_predicate("HostName", lambda args: preds.pod_fits_host)

register_priority_function(
    "LeastRequestedPriority", lambda args: prios.least_requested_priority
)
register_priority_function(
    "BalancedResourceAllocation", lambda args: prios.balanced_resource_allocation
)
register_priority_function(
    "ServiceSpreadingPriority",
    lambda args: prios.ServiceSpread(args.service_lister),
)
register_priority_function("EqualPriority", lambda args: prios.equal_priority)

DEFAULT_PROVIDER = "DefaultProvider"

register_algorithm_provider(
    DEFAULT_PROVIDER,
    # defaults.go:38-48
    ["PodFitsPorts", "PodFitsResources", "NoDiskConflict", "MatchNodeSelector", "HostName"],
    # defaults.go:51-60
    {
        "LeastRequestedPriority": 1,
        "BalancedResourceAllocation": 1,
        "ServiceSpreadingPriority": 1,
    },
)


def default_predicates(args: PluginFactoryArgs) -> Dict[str, Callable]:
    provider = get_algorithm_provider(DEFAULT_PROVIDER)
    return get_fit_predicates(provider.predicate_keys, args)


def default_priorities(args: PluginFactoryArgs) -> List[PriorityConfig]:
    provider = get_algorithm_provider(DEFAULT_PROVIDER)
    return get_priority_configs(provider.priority_keys, args)


# ---------------------------------------------------------------------------
# Policy file support (reference: plugin/pkg/scheduler/api/types.go:25-104).
# ---------------------------------------------------------------------------


def build_from_policy(policy: dict, args: PluginFactoryArgs):
    """Construct (predicates, priorities) from a policy document:

    {"kind": "Policy", "predicates": [{"name": ..., "argument": {...}}],
     "priorities": [{"name": ..., "weight": N, "argument": {...}}]}

    Custom arguments mirror the reference: serviceAffinity{labels},
    labelsPresence{labels, presence}, serviceAntiAffinity{label},
    labelPreference{label, presence}.
    """
    predicates: Dict[str, Callable] = {}
    for p in policy.get("predicates", []):
        name = p["name"]
        arg = p.get("argument") or {}
        if "serviceAffinity" in arg:
            predicates[name] = preds.ServiceAffinity(
                args.pod_lister,
                args.service_lister,
                args.node_lister,
                arg["serviceAffinity"].get("labels", []),
            )
        elif "labelsPresence" in arg:
            predicates[name] = preds.NodeLabelChecker(
                args.node_lister,
                arg["labelsPresence"].get("labels", []),
                arg["labelsPresence"].get("presence", True),
            )
        else:
            predicates.update(get_fit_predicates([name], args))
    priorities: List[PriorityConfig] = []
    for p in policy.get("priorities", []):
        name = p["name"]
        weight = p.get("weight", 1)
        arg = p.get("argument") or {}
        if "serviceAntiAffinity" in arg:
            fn = prios.ServiceAntiAffinity(
                args.service_lister, arg["serviceAntiAffinity"].get("label", "")
            )
            priorities.append(PriorityConfig(function=fn, weight=weight))
        elif "labelPreference" in arg:
            fn = prios.NodeLabelPrioritizer(
                arg["labelPreference"].get("label", ""),
                arg["labelPreference"].get("presence", True),
            )
            priorities.append(PriorityConfig(function=fn, weight=weight))
        else:
            priorities.extend(get_priority_configs({name: weight}, args))
    return predicates, priorities


# ---------------------------------------------------------------------------
# AlgorithmSpec bridge: the spec is the shared source of truth between
# this scalar construction and the TPU lowering (models.algspec) —
# the batch daemon consults it to pick device vs scalar execution.
# ---------------------------------------------------------------------------


def spec_for_provider(name: str) -> AlgorithmSpec:
    provider = get_algorithm_provider(name)
    return spec_from_keys(provider.predicate_keys, provider.priority_keys)


def spec_for_policy(policy: dict) -> AlgorithmSpec:
    return spec_from_policy(policy)


def build_from_spec(spec: AlgorithmSpec, args: PluginFactoryArgs):
    """Construct the scalar (predicates, priorities) from a spec.
    Argumented kinds build their classes directly; plain kinds resolve
    through the registry, so user-registered custom plugins still run
    on the scalar path even though they can't lower to the device."""
    predicates: Dict[str, Callable] = {}
    for i, p in enumerate(spec.predicates):
        if p.kind == "ServiceAffinity":
            predicates[f"ServiceAffinity#{i}"] = preds.ServiceAffinity(
                args.pod_lister,
                args.service_lister,
                args.node_lister,
                list(p.labels),
            )
        elif p.kind == "NodeLabelPresence":
            predicates[f"NodeLabelPresence#{i}"] = preds.NodeLabelChecker(
                args.node_lister, list(p.labels), p.presence
            )
        else:
            predicates.update(get_fit_predicates([p.kind], args))
    priorities: List[PriorityConfig] = []
    for p in spec.priorities:
        if p.weight == 0:
            continue
        if p.kind == "ServiceAntiAffinity":
            priorities.append(
                PriorityConfig(
                    function=prios.ServiceAntiAffinity(
                        args.service_lister, p.label
                    ),
                    weight=p.weight,
                )
            )
        elif p.kind == "LabelPreference":
            priorities.append(
                PriorityConfig(
                    function=prios.NodeLabelPrioritizer(p.label, p.presence),
                    weight=p.weight,
                )
            )
        else:
            priorities.extend(get_priority_configs({p.kind: p.weight}, args))
    return predicates, priorities
