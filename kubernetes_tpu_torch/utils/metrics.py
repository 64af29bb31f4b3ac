"""Prometheus-compatible metrics.

The port's own copy of `kubernetes_tpu/utils/metrics.py`: counters,
gauges, summaries and histograms with label sets, `bucket_quantile`,
and a `Registry` (`DEFAULT`, the process-wide one) rendered in the
Prometheus text exposition format. The names, buckets and text are the
JAX module's, so a scrape of either package reads the same series.
Series and registry locks come from the sanitizer's factory under JAX's
names (`metrics.series`, `metrics.registry`; `utils/sanitizer.py`).
"""

from __future__ import annotations

import math
import random
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.utils import sanitizer

#: Module-level RNG so reservoir sampling is seedable in tests
#: (metrics._RNG.seed(...)) and the hot observe() path never re-imports.
_RNG = random.Random()


def _escape_label_value(v: str) -> str:
    """Per the Prometheus text exposition format, label values escape
    backslash, double-quote, and newline — a pod name carrying '"'
    must not corrupt the /metrics output."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


class _Metric:
    def __init__(self, name: str, help_: str, label_names: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._lock = sanitizer.lock("metrics.series")

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        return tuple(labels.get(k, "") for k in self.label_names)

    def _header(self, type_: str) -> List[str]:
        help_ = self.help.replace("\\", "\\\\").replace("\n", "\\n")
        return [f"# HELP {self.name} {help_}", f"# TYPE {self.name} {type_}"]

    def reset(self) -> None:
        """Drop every series (fresh measurement window — SLO gates and
        benches open their own windows on the process-global registry)."""
        with self._lock:
            getattr(self, "_stats", getattr(self, "_values", {})).clear()

    def label_values(self) -> List[Tuple[str, ...]]:
        """Label-value tuples of the live series, ordered like
        label_names."""
        with self._lock:
            return list(
                getattr(self, "_stats", getattr(self, "_values", {}))
            )

    @staticmethod
    def _fmt_labels(names, values) -> str:
        if not names:
            return ""
        inner = ",".join(
            f'{k}="{_escape_label_value(v)}"' for k, v in zip(names, values)
        )
        return "{" + inner + "}"


class Counter(_Metric):
    def __init__(self, name, help_, label_names=()):
        super().__init__(name, help_, label_names)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._lock:
            k = self._key(labels)
            self._values[k] = self._values.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def snapshot(self) -> Dict[Tuple[str, ...], float]:
        """Point-in-time copy of every series (the retention sampler's
        read — utils/timeseries.py; one lock hold for the family)."""
        with self._lock:
            return dict(self._values)

    def render(self) -> List[str]:
        out = self._header("counter")
        with self._lock:
            for k, v in sorted(self._values.items()):
                out.append(f"{self.name}{self._fmt_labels(self.label_names, k)} {v}")
        return out


class Gauge(_Metric):
    def __init__(self, name, help_, label_names=()):
        super().__init__(name, help_, label_names)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = value

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def snapshot(self) -> Dict[Tuple[str, ...], float]:
        """Point-in-time copy of every series (utils/timeseries.py)."""
        with self._lock:
            return dict(self._values)

    def render(self) -> List[str]:
        out = self._header("gauge")
        with self._lock:
            for k, v in sorted(self._values.items()):
                out.append(f"{self.name}{self._fmt_labels(self.label_names, k)} {v}")
        return out


class Summary(_Metric):
    """Windowless summary: running count/sum + streaming quantile estimate
    over a bounded reservoir (good enough for SLO checks; the reference
    uses client_golang summaries with decay)."""

    RESERVOIR = 1024

    def __init__(self, name, help_, label_names=(), quantiles=(0.5, 0.9, 0.99)):
        super().__init__(name, help_, label_names)
        self.quantiles = quantiles
        self._stats: Dict[Tuple[str, ...], Dict] = {}

    def observe(self, value: float, **labels) -> None:
        with self._lock:
            k = self._key(labels)
            s = self._stats.setdefault(k, {"count": 0, "sum": 0.0, "res": []})
            s["count"] += 1
            s["sum"] += value
            res = s["res"]
            if len(res) < self.RESERVOIR:
                res.append(value)
            else:
                # Reservoir sampling keeps the estimate unbiased.
                i = _RNG.randrange(s["count"])
                if i < self.RESERVOIR:
                    res[i] = value

    def quantile(self, q: float, **labels) -> float:
        with self._lock:
            s = self._stats.get(self._key(labels))
            if not s or not s["res"]:
                return math.nan
            xs = sorted(s["res"])
            idx = min(len(xs) - 1, max(0, int(math.ceil(q * len(xs))) - 1))
            return xs[idx]

    def render(self) -> List[str]:
        out = self._header("summary")
        with self._lock:
            for k, s in sorted(self._stats.items()):
                xs = sorted(s["res"])
                for q in self.quantiles:
                    if xs:
                        idx = min(len(xs) - 1, max(0, int(math.ceil(q * len(xs))) - 1))
                        val = xs[idx]
                    else:
                        val = math.nan
                    names = self.label_names + ("quantile",)
                    values = k + (str(q),)
                    out.append(f"{self.name}{self._fmt_labels(names, values)} {val}")
                out.append(
                    f"{self.name}_sum{self._fmt_labels(self.label_names, k)} {s['sum']}"
                )
                out.append(
                    f"{self.name}_count{self._fmt_labels(self.label_names, k)} {s['count']}"
                )
        return out


#: client_golang's DefBuckets (5ms..10s), extended both ways for the
#: latency SLOs: 0.075 fills the sub-100ms band the micro-tick
#: pod-to-bind objective reads (0.01/0.025/0.05/0.075/0.1 give p99
#: resolution under the 0.1s target), and the 30/60/120 tail keeps a
#: saturated series honest — before it, any latency beyond 10s
#: rendered as a CLAMPED p99 of exactly 10.0, indistinguishable
#: from a measurement.
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0,
)


def _fmt_float(v: float) -> str:
    """Bucket-bound formatting like client_golang: '0.005', '1', '10'."""
    return f"{v:g}"


def bucket_quantile(bounds, counts, total, q: float) -> float:
    """histogram_quantile over raw (non-cumulative) per-bucket counts:
    linear within the bucket holding rank q*total; observations beyond
    the highest finite bound report that bound. Shared by the live
    Histogram and the retention plane's windowed bucket DELTAS
    (utils/timeseries.quantile_over_time) so a windowed p99 and a
    lifetime p99 can never disagree about what interpolation means."""
    if total <= 0:
        return math.nan
    rank = q * total
    cum = 0.0
    lo = 0.0
    for ub, c in zip(bounds, counts):
        if c and cum + c >= rank:
            return lo + (ub - lo) * max(0.0, min(1.0, (rank - cum) / c))
        cum += c
        lo = ub
    return bounds[-1]


class Histogram(_Metric):
    """Cumulative-bucket histogram (the Prometheus exposition model's
    native latency type): per label set, one count per `le` bucket plus
    running sum/count. Unlike Summary, bucket counts aggregate across
    scrapes and instances, which is why the SLO-feeding latency series
    use this type. Internal state lives in `_stats` keyed like
    Summary's, so histogram and summary series are interchangeable to
    readers such as high_latency_requests / reset_request_latency."""

    def __init__(self, name, help_, label_names=(), buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))
        self._stats: Dict[Tuple[str, ...], Dict] = {}

    def observe(self, value: float, **labels) -> None:
        with self._lock:
            k = self._key(labels)
            s = self._stats.get(k)
            if s is None:
                s = self._stats[k] = {
                    "count": 0,
                    "sum": 0.0,
                    "buckets": [0] * len(self.buckets),
                }
            s["count"] += 1
            s["sum"] += value
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    s["buckets"][i] += 1
                    break
            # value > highest bound: only the implicit +Inf bucket
            # (== count) observes it.

    def count(self, **labels) -> int:
        with self._lock:
            s = self._stats.get(self._key(labels))
            return s["count"] if s else 0

    def quantile(self, q: float, **labels) -> float:
        """Bucket-interpolated quantile (histogram_quantile semantics):
        linear within the bucket holding rank q*count; observations
        beyond the highest finite bound report that bound."""
        with self._lock:
            s = self._stats.get(self._key(labels))
            if not s or s["count"] == 0:
                return math.nan
            counts = list(s["buckets"])
            total = s["count"]
        return bucket_quantile(self.buckets, counts, total, q)

    def snapshot(self) -> Dict[Tuple[str, ...], Tuple[int, float, Tuple[int, ...]]]:
        """Point-in-time (count, sum, raw per-bucket counts) per series
        — what the retention sampler rings so windowed quantiles can be
        interpolated from bucket deltas (utils/timeseries.py)."""
        with self._lock:
            return {
                k: (s["count"], s["sum"], tuple(s["buckets"]))
                for k, s in self._stats.items()
            }

    def render(self) -> List[str]:
        out = self._header("histogram")
        bnames = self.label_names + ("le",)
        with self._lock:
            for k, s in sorted(self._stats.items()):
                cum = 0
                for ub, c in zip(self.buckets, s["buckets"]):
                    cum += c
                    out.append(
                        f"{self.name}_bucket"
                        f"{self._fmt_labels(bnames, k + (_fmt_float(ub),))}"
                        f" {cum}"
                    )
                # The +Inf bucket is total count by construction.
                out.append(
                    f"{self.name}_bucket"
                    f"{self._fmt_labels(bnames, k + ('+Inf',))} {s['count']}"
                )
                out.append(
                    f"{self.name}_sum{self._fmt_labels(self.label_names, k)}"
                    f" {s['sum']}"
                )
                out.append(
                    f"{self.name}_count{self._fmt_labels(self.label_names, k)}"
                    f" {s['count']}"
                )
        return out


class Registry:
    def __init__(self):
        self._lock = sanitizer.lock("metrics.registry")
        self._metrics: Dict[str, _Metric] = {}

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            return self._metrics.setdefault(metric.name, metric)

    def get(self, name: str) -> Optional[_Metric]:
        """The registered metric by name, or None (the SLO engine's
        series lookup — utils/slo.py)."""
        with self._lock:
            return self._metrics.get(name)

    def all(self) -> List[_Metric]:
        """Every registered metric (the retention sampler's sweep —
        utils/timeseries.py)."""
        with self._lock:
            return list(self._metrics.values())

    def counter(self, name, help_="", labels=()) -> Counter:
        return self.register(Counter(name, help_, labels))  # type: ignore

    def gauge(self, name, help_="", labels=()) -> Gauge:
        return self.register(Gauge(name, help_, labels))  # type: ignore

    def summary(self, name, help_="", labels=()) -> Summary:
        return self.register(Summary(name, help_, labels))  # type: ignore

    def histogram(
        self, name, help_="", labels=(), buckets=DEFAULT_BUCKETS
    ) -> Histogram:
        return self.register(
            Histogram(name, help_, labels, buckets)
        )  # type: ignore

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


DEFAULT = Registry()
