"""Algorithm specs: a structured description of the configured
predicate/priority set, as the columnar lowering reads it.

A copy of `kubernetes_tpu/models/algspec.py` without the policy-file
and key-set parsers (the port builds specs directly). The port's solver
runs the default spec only; a lowered non-default spec raises there.

The reference builds its scheduler from either an algorithm provider's
key sets (plugin/pkg/scheduler/algorithmprovider/defaults/defaults.go)
or a policy file naming predicates/priorities with arguments
(plugin/pkg/scheduler/api/types.go:25-104, factory/plugins.go:138-153).
Both converge here on an AlgorithmSpec, which says whether the
configured set can be lowered to the device pipeline and, when it can,
exactly which columns and score terms the solver needs.

Lowerable vocabulary (all reference kinds):
  predicates: PodFitsPorts, PodFitsResources, NoDiskConflict,
    MatchNodeSelector, HostName (defaults.go:38-48);
    NodeLabelPresence (predicates.go:226-240),
    ServiceAffinity (predicates.go:268-335).
  priorities: LeastRequestedPriority, BalancedResourceAllocation,
    ServiceSpreadingPriority, EqualPriority (defaults.go:51-60);
    LabelPreference (priorities.go:113-138),
    ServiceAntiAffinity (spreading.go:105-169).
Anything else (user-registered custom plugins) raises
UnloweredPolicyError.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

BASE_PREDICATES = (
    "PodFitsPorts",
    "PodFitsResources",
    "NoDiskConflict",
    "MatchNodeSelector",
    "HostName",
)
BASE_PRIORITIES = (
    "LeastRequestedPriority",
    "BalancedResourceAllocation",
    "ServiceSpreadingPriority",
    "EqualPriority",
)


class UnloweredPolicyError(Exception):
    """The configured plugin set has no columnar encoding."""


@dataclass(frozen=True)
class PredicateSpec:
    kind: str  # semantic kind, not the policy's display name
    labels: Tuple[str, ...] = ()
    presence: bool = True


@dataclass(frozen=True)
class PrioritySpec:
    kind: str
    weight: int = 1
    label: str = ""
    presence: bool = True


@dataclass(frozen=True)
class AlgorithmSpec:
    predicates: Tuple[PredicateSpec, ...]
    priorities: Tuple[PrioritySpec, ...]

    def is_default(self) -> bool:
        """Exactly the DefaultProvider set (order-insensitive:
        predicates AND together, priorities sum). Any argumented
        priority (ServiceAntiAffinity/LabelPreference) is non-default
        even alongside the stock three — _weight_map skips them, so
        check for them explicitly or they'd be silently dropped."""
        if any(
            p.kind in ("ServiceAntiAffinity", "LabelPreference") and p.weight
            for p in self.priorities
        ):
            return False
        return (
            {(p.kind, p.labels, p.presence) for p in self.predicates}
            == {(k, (), True) for k in BASE_PREDICATES}
            and _weight_map(self.priorities)
            == {
                "LeastRequestedPriority": 1,
                "BalancedResourceAllocation": 1,
                "ServiceSpreadingPriority": 1,
            }
        )

    @property
    def affinity_labels(self) -> Tuple[str, ...]:
        """Concatenated ServiceAffinity labels across all instances.
        Per-label decomposition is exact: each label's requirement
        (pinned nodeSelector value, else the anchor peer node's value)
        is independent, and predicates AND together."""
        out = []
        for p in self.predicates:
            if p.kind == "ServiceAffinity":
                out.extend(p.labels)
        return tuple(out)


def _weight_map(priorities: Tuple[PrioritySpec, ...]) -> Dict[str, int]:
    """kind -> summed weight, dropping zero-weight and EqualPriority
    (a constant shift never changes an argmax; the reference registers
    it but excludes it from the default provider, defaults.go:64-66)."""
    out: Dict[str, int] = {}
    for p in priorities:
        if p.kind == "EqualPriority" or p.weight == 0:
            continue
        if p.kind in ("LabelPreference", "ServiceAntiAffinity"):
            continue  # argumented kinds are not mergeable by kind
        out[p.kind] = out.get(p.kind, 0) + p.weight
    return out


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------


class LoweredSpec(NamedTuple):
    """Static (hashable) solver configuration. Shapes of the
    per-spec columns ride on the arrays themselves except the
    anti-affinity zone-count lengths (aa_zones), which size a scatter
    target and must be static."""

    resources: bool = True
    ports: bool = True
    disk: bool = True
    selector: bool = True
    hostname: bool = True
    node_label: bool = False  # nodes["policy_ok"] static mask present
    service_affinity: bool = False  # aff columns + anchor/svc_total carry
    static_prio: bool = False  # nodes["static_prio"] column present
    aa_weights: Tuple[int, ...] = ()  # one ServiceAntiAffinity per entry
    aa_zones: Tuple[int, ...] = ()  # zone-vocab size per instance


DEFAULT_LOWERED = LoweredSpec()


def lower_spec(spec: AlgorithmSpec) -> Tuple[LoweredSpec, Tuple[int, int, int]]:
    """Validate + lower a spec to (LoweredSpec, priority weights).

    aa_zones is left empty here — zone vocabularies are snapshot-scoped
    (observed node label values), so SnapshotBuilder fills them in.
    Raises UnloweredPolicyError for kinds with no columnar encoding.
    """
    base = set(BASE_PREDICATES)
    ls = dict(
        resources=False, ports=False, disk=False, selector=False, hostname=False
    )
    flag_for = {
        "PodFitsPorts": "ports",
        "PodFitsResources": "resources",
        "NoDiskConflict": "disk",
        "MatchNodeSelector": "selector",
        "HostName": "hostname",
    }
    node_label = False
    service_affinity = False
    for p in spec.predicates:
        if p.kind in base:
            ls[flag_for[p.kind]] = True
        elif p.kind == "NodeLabelPresence":
            node_label = True
        elif p.kind == "ServiceAffinity":
            # Label-less ServiceAffinity is a no-op in the scalar path
            # (empty affinity selector matches everything); don't make
            # the solver expect columns that won't be built.
            if p.labels:
                service_affinity = True
        else:
            raise UnloweredPolicyError(f"predicate kind {p.kind!r}")
    weights = _weight_map(spec.priorities)
    static_prio = False
    aa_weights = []
    for p in spec.priorities:
        if p.kind in BASE_PRIORITIES or p.weight == 0:
            continue
        if p.kind == "LabelPreference":
            static_prio = True
        elif p.kind == "ServiceAntiAffinity":
            aa_weights.append(p.weight)
        else:
            raise UnloweredPolicyError(f"priority kind {p.kind!r}")
    lowered = LoweredSpec(
        resources=ls["resources"],
        ports=ls["ports"],
        disk=ls["disk"],
        selector=ls["selector"],
        hostname=ls["hostname"],
        node_label=node_label,
        service_affinity=service_affinity,
        static_prio=static_prio,
        aa_weights=tuple(aa_weights),
        aa_zones=(),
    )
    return lowered, (
        weights.get("LeastRequestedPriority", 0),
        weights.get("BalancedResourceAllocation", 0),
        weights.get("ServiceSpreadingPriority", 0),
    )
