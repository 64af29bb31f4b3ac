"""Resource quantities.

Behavioral parity with the reference's pkg/api/resource/quantity.go:
quantities are decimal numbers with an optional SI or binary suffix
("100m" CPU = 0.1 cores, "64Mi" memory = 64*2^20 bytes). The scheduler
consumes them as integers: CPU via milli-value, memory via value
(reference: plugin/pkg/scheduler/algorithm/predicates/predicates.go:110-111).

Internally a Quantity is an exact integer count of milli-units, which
represents every suffix the reference supports without floating point.
"""

from __future__ import annotations

import re
from functools import total_ordering

_BINARY = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}
_DECIMAL = {
    "n": -3,  # handled specially (sub-milli rounds up, like the reference's scale)
    "u": -2,
    "m": -1,
    "": 0,
    "k": 1,
    "M": 2,
    "G": 3,
    "T": 4,
    "P": 5,
    "E": 6,
}

_QTY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>\d+(?:\.\d+)?|\.\d+)(?P<suffix>[numkMGTPE]|[KMGTPE]i|)$"
)


@total_ordering
class Quantity:
    """An exact resource amount, stored as integer milli-units."""

    __slots__ = ("milli", "_suffix_hint")

    def __init__(self, milli: int = 0, suffix_hint: str = ""):
        self.milli = int(milli)
        self._suffix_hint = suffix_hint

    # -- constructors -------------------------------------------------
    @classmethod
    def from_string(cls, s: str) -> "Quantity":
        return parse_quantity(s)

    @classmethod
    def from_int(cls, v: int) -> "Quantity":
        return cls(int(v) * 1000)

    @classmethod
    def from_milli(cls, v: int) -> "Quantity":
        return cls(int(v), suffix_hint="m")

    # -- accessors (reference: Cpu().MilliValue(), Memory().Value()) --
    def milli_value(self) -> int:
        return self.milli

    def value(self) -> int:
        """Whole-unit value, rounding up like the reference's Value()."""
        return -((-self.milli) // 1000)

    def is_zero(self) -> bool:
        return self.milli == 0

    # -- arithmetic ---------------------------------------------------
    def __add__(self, other: "Quantity") -> "Quantity":
        return Quantity(self.milli + other.milli, self._suffix_hint)

    def __sub__(self, other: "Quantity") -> "Quantity":
        return Quantity(self.milli - other.milli, self._suffix_hint)

    def __eq__(self, other) -> bool:
        return isinstance(other, Quantity) and self.milli == other.milli

    def __lt__(self, other: "Quantity") -> bool:
        return self.milli < other.milli

    def __hash__(self) -> int:
        return hash(self.milli)

    # -- formatting ---------------------------------------------------
    def __str__(self) -> str:
        m = self.milli
        if m == 0:
            return "0"
        # Preserve binary suffix hint when it divides evenly.
        hint = self._suffix_hint
        if hint in _BINARY and m % (1000 * _BINARY[hint]) == 0:
            return f"{m // (1000 * _BINARY[hint])}{hint}"
        if m % 1000 == 0:
            v = m // 1000
            # Compact large decimal values using the largest clean suffix.
            for suf in ("E", "P", "T", "G", "M", "k"):
                scale = 1000 ** _DECIMAL[suf]
                if v % scale == 0 and abs(v) >= scale and scale > 1:
                    return f"{v // scale}{suf}"
            return str(v)
        return f"{m}m"

    def __repr__(self) -> str:
        return f"Quantity({self!s})"

    def to_wire(self) -> str:
        return str(self)


def parse_quantity(s) -> Quantity:
    """Parse a quantity string ("250m", "2", "64Mi", "1.5Gi", "100M")."""
    if isinstance(s, Quantity):
        return s
    if isinstance(s, int):
        return Quantity.from_int(s)
    if isinstance(s, float):
        return Quantity(round(s * 1000))
    s = s.strip()
    m = _QTY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity: {s!r}")
    sign = -1 if m.group("sign") == "-" else 1
    num = m.group("num")
    suffix = m.group("suffix")

    if "." in num:
        int_part, frac_part = num.split(".")
        int_part = int_part or "0"
    else:
        int_part, frac_part = num, ""

    if suffix in _BINARY:
        base = _BINARY[suffix]
        milli = int(int_part) * base * 1000
        if frac_part:
            frac = int(frac_part) * base * 1000
            denom = 10 ** len(frac_part)
            # Round up fractional remainders (reference rounds up on scale).
            milli += -((-frac) // denom)
    else:
        power = _DECIMAL[suffix]
        # Express as milli-units: value * 10^(3*power) * 1000.
        exp = 3 * power + 3
        digits = int_part + frac_part
        point = len(int_part)  # digits before the decimal point
        # value = digits * 10^(point - len(digits)); milli = value * 10^exp
        shift = exp + point - len(digits)
        n = int(digits) if digits else 0
        if shift >= 0:
            milli = n * (10**shift)
        else:
            d = 10 ** (-shift)
            milli = -((-n) // d)  # round away from zero magnitude upward
    return Quantity(sign * milli, suffix_hint=suffix)
