"""Label and field selectors.

Behavioral parity with the reference's pkg/labels/ (Selector, Parse,
SelectorFromSet — used in the scheduler hot path at
plugin/pkg/scheduler/algorithm/predicates/predicates.go:176-177) and
pkg/fields/ (used e.g. for the unassigned-pod watch,
plugin/pkg/scheduler/factory/factory.go:226).

Grammar: comma-separated requirements, each one of
    key = value | key == value | key != value
    key in (v1, v2) | key notin (v1, v2)
    key            (exists)

The port's copy of `kubernetes_tpu/models/labels.py`, line for line
(the port imports nothing of the JAX package): the scalar predicates
and priorities read it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Sequence

EQUALS = "="
DOUBLE_EQUALS = "=="
NOT_EQUALS = "!="
IN = "in"
NOT_IN = "notin"
EXISTS = "exists"


@dataclass(frozen=True)
class Requirement:
    key: str
    operator: str
    values: FrozenSet[str] = field(default_factory=frozenset)

    def matches(self, labels: Dict[str, str]) -> bool:
        if self.operator in (EQUALS, DOUBLE_EQUALS, IN):
            return self.key in labels and labels[self.key] in self.values
        if self.operator == NOT_EQUALS:
            return self.key not in labels or labels[self.key] not in self.values
        if self.operator == NOT_IN:
            # Reference semantics: notin requires the key to exist with a
            # value outside the set? pkg/labels Requirement.Matches for
            # NotIn returns true when the key is absent.
            return self.key not in labels or labels[self.key] not in self.values
        if self.operator == EXISTS:
            return self.key in labels
        raise ValueError(f"unknown operator {self.operator!r}")

    def __str__(self) -> str:
        if self.operator == EXISTS:
            return self.key
        if self.operator in (EQUALS, DOUBLE_EQUALS, NOT_EQUALS):
            return f"{self.key}{self.operator}{next(iter(self.values))}"
        return f"{self.key} {self.operator} ({','.join(sorted(self.values))})"


class Selector:
    """A parsed label selector: conjunction of requirements."""

    def __init__(self, requirements: Sequence[Requirement] = ()):
        self.requirements: List[Requirement] = list(requirements)

    def matches(self, labels: Dict[str, str] | None) -> bool:
        labels = labels or {}
        return all(r.matches(labels) for r in self.requirements)

    def empty(self) -> bool:
        return not self.requirements

    def __str__(self) -> str:
        return ",".join(str(r) for r in self.requirements)

    def __eq__(self, other) -> bool:
        return isinstance(other, Selector) and set(map(str, self.requirements)) == set(
            map(str, other.requirements)
        )


def everything() -> Selector:
    return Selector()


def selector_from_set(labels: Dict[str, str] | None) -> Selector:
    """Exact-match selector from a map (reference: labels.SelectorFromSet)."""
    labels = labels or {}
    return Selector(
        [Requirement(k, EQUALS, frozenset([v])) for k, v in sorted(labels.items())]
    )


_SET_RE = re.compile(
    r"^\s*(?P<key>[A-Za-z0-9._/-]+)\s+(?P<op>in|notin)\s+\(\s*(?P<vals>[^)]*)\)\s*$"
)
_EQ_RE = re.compile(
    r"^\s*(?P<key>[A-Za-z0-9._/-]+)\s*(?P<op>==|=|!=)\s*(?P<val>[A-Za-z0-9._-]*)\s*$"
)
_EXISTS_RE = re.compile(r"^\s*(?P<key>[A-Za-z0-9._/-]+)\s*$")


def _split_top(s: str) -> List[str]:
    """Split on commas not inside parentheses."""
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def parse(s: str | None) -> Selector:
    """Parse a selector string (reference: pkg/labels/selector.go Parse)."""
    if not s or not s.strip():
        return everything()
    reqs: List[Requirement] = []
    for part in _split_top(s):
        if not part.strip():
            continue
        m = _SET_RE.match(part)
        if m:
            vals = frozenset(v.strip() for v in m.group("vals").split(",") if v.strip())
            reqs.append(Requirement(m.group("key"), m.group("op"), vals))
            continue
        m = _EQ_RE.match(part)
        if m:
            op = m.group("op")
            op = NOT_EQUALS if op == "!=" else EQUALS
            reqs.append(Requirement(m.group("key"), op, frozenset([m.group("val")])))
            continue
        m = _EXISTS_RE.match(part)
        if m:
            reqs.append(Requirement(m.group("key"), EXISTS))
            continue
        raise ValueError(f"invalid selector segment: {part!r}")
    return Selector(reqs)


# ---------------------------------------------------------------------------
# Field selectors (reference: pkg/fields/) — only =, ==, != over flat fields.
# ---------------------------------------------------------------------------


class FieldSelector:
    def __init__(self, requirements: Sequence[tuple] = ()):
        # each requirement: (key, op, value) with op in {"=", "!="}
        self.requirements = list(requirements)

    def matches(self, fields: Dict[str, str]) -> bool:
        for key, op, value in self.requirements:
            have = fields.get(key, "")
            if op == EQUALS and have != value:
                return False
            if op == NOT_EQUALS and have == value:
                return False
        return True

    def empty(self) -> bool:
        return not self.requirements

    def __str__(self) -> str:
        return ",".join(
            f"{k}{'!=' if op == NOT_EQUALS else '='}{v}" for k, op, v in self.requirements
        )


def parse_fields(s: str | None) -> FieldSelector:
    if not s or not s.strip():
        return FieldSelector()
    reqs = []
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        if "!=" in part:
            k, v = part.split("!=", 1)
            reqs.append((k.strip(), NOT_EQUALS, v.strip()))
        elif "==" in part:
            k, v = part.split("==", 1)
            reqs.append((k.strip(), EQUALS, v.strip()))
        elif "=" in part:
            k, v = part.split("=", 1)
            reqs.append((k.strip(), EQUALS, v.strip()))
        else:
            raise ValueError(f"invalid field selector segment: {part!r}")
    return FieldSelector(reqs)
