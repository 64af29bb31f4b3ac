"""In-memory time-series retention for the metrics registry.

The registry's series are cumulative-since-reset; every consumer so
far (SLO engine, bench gates, ktctl) read them point-in-time, so one
early latency burn pinned a histogram's p99 forever and nothing ever
*resolved*. This module is the retention half of the health plane
(Monarch's shape — Adams et al., VLDB 2020 — at cluster scale: keep
the recent raw points in memory, answer windowed queries from deltas):

- A background :class:`Sampler` snapshots every Counter/Gauge/Histogram
  on the registry into bounded per-series rings at a configurable
  cadence (``KT_TS_INTERVAL_S``; zero-cost when never started — the
  default state for unit tests and thin control-plane processes).
- Windowed queries are computed from **deltas** between ring samples,
  never from the cumulative values themselves: :func:`Retention.rate`
  / ``increase`` (counter-reset tolerant: negative steps are a restart,
  not negative traffic), ``delta``/``max_over_time``/``avg_over_time``
  (gauges), and ``quantile_over_time`` — histogram +le bucket deltas
  interpolated by the same :func:`metrics.bucket_quantile` the live
  histogram uses, so a windowed p99 and a lifetime p99 can never
  disagree about interpolation.

Consumers: utils/slo.py (windowed objective verdicts with lifetime
fallback), utils/alerts.py (multi-window burn rates), GET
/debug/timeseries, and the soak harness's alert oracle.

Summaries are deliberately NOT retained: a sampled reservoir is not
delta-composable (two snapshots of the same reservoir share elements),
and every SLO-feeding latency series is a Histogram precisely so
windows CAN be taken (utils/metrics.py docstring).

A copy of `kubernetes_tpu/utils/timeseries.py` over the port's metrics
registry, with the sampler's chaos seam (`timeseries.sample.skip`) and
the sanitizer's `timeseries.retention` and `timeseries.sampler` locks
where JAX's are. Departure: `Sampler.start` starts its thread after
releasing its lock (a thread's start waits for it to run, a blocking
wait the sanitizer reports under a lock).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.utils import faults, metrics, sanitizer

#: Sampler cadence / per-series ring bound (env-tunable; soak and the
#: check.sh smoke shrink the cadence to make minutes-long windows run
#: on CI clocks). 5s x 720 samples retains one hour per series.
DEFAULT_INTERVAL_S = float(os.environ.get("KT_TS_INTERVAL_S", "5.0"))
DEFAULT_RETAIN_SAMPLES = int(os.environ.get("KT_TS_RETAIN", "720"))

SAMPLES = metrics.DEFAULT.counter(
    "timeseries_samples_total",
    "Retention sampler sweeps taken (utils/timeseries.py)",
)
RETAINED = metrics.DEFAULT.gauge(
    "timeseries_retained_series",
    "Live series held in retention rings",
)
SAMPLE_SECONDS = metrics.DEFAULT.histogram(
    "timeseries_sample_seconds",
    "Wall time per retention sweep (the health plane's overhead "
    "figure; bench pins sampler+alerts under 5% of the churn drill)",
)


class Retention:
    """Bounded per-series rings of registry snapshots + the windowed
    query surface. Writes come from one sampler thread; reads from any
    (SLO engine, alert engine, debug handlers)."""

    def __init__(self, retain_samples: int = DEFAULT_RETAIN_SAMPLES):
        self.retain_samples = int(retain_samples)
        self._lock = sanitizer.lock("timeseries.retention")
        # metric name -> label tuple -> ring of (t_mono, payload).
        # Payload: float for counter/gauge; (count, sum, buckets) for
        # histograms.
        self._rings: Dict[str, Dict[Tuple[str, ...], deque]] = {}
        # metric name -> {"type", "label_names", "buckets"}.
        self._meta: Dict[str, dict] = {}
        self._samples = 0

    # -- ingest --------------------------------------------------------

    def sample_now(self, registry=None, now: Optional[float] = None) -> int:
        """One sweep: snapshot every retainable metric into its rings.
        Returns the number of series touched. The registry locks are
        held per-family during snapshot and never nested under the
        retention lock (snapshots are collected first, appended after)."""
        registry = metrics.DEFAULT if registry is None else registry
        now = time.monotonic() if now is None else now
        if faults.enabled() and faults.fire(faults.TIMESERIES_SAMPLE_SKIP):
            return 0
        collected = []
        for m in registry.all():
            snap = getattr(m, "snapshot", None)
            if snap is None:
                continue  # summaries: reservoirs are not delta-composable
            if isinstance(m, metrics.Histogram):
                mtype = "histogram"
            elif isinstance(m, metrics.Counter):
                mtype = "counter"
            elif isinstance(m, metrics.Gauge):
                mtype = "gauge"
            else:
                continue
            collected.append((m, mtype, snap()))
        touched = 0
        with self._lock:
            for m, mtype, series in collected:
                # meta is fixed at first sight; bucket ladders are set
                # at registration so no refresh is needed.
                self._meta.setdefault(
                    m.name,
                    {
                        "type": mtype,
                        "label_names": m.label_names,
                        "buckets": tuple(getattr(m, "buckets", ())),
                    },
                )
                rings = self._rings.setdefault(m.name, {})
                for key, payload in series.items():
                    ring = rings.get(key)
                    if ring is None:
                        ring = rings[key] = deque(maxlen=self.retain_samples)
                    ring.append((now, payload))
                    touched += 1
            self._samples += 1
            total = sum(
                1 for rs in self._rings.values() for r in rs.values() if r
            )
        SAMPLES.inc()
        RETAINED.set(float(total))
        return touched

    # -- introspection -------------------------------------------------

    @property
    def sampled(self) -> bool:
        with self._lock:
            return self._samples > 0

    @property
    def samples(self) -> int:
        with self._lock:
            return self._samples

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._rings)

    def label_sets(self, series: str) -> List[Dict[str, str]]:
        """Label-value dicts of the retained series (the windowed SLO
        engine's analog of Metric.label_values())."""
        with self._lock:
            meta = self._meta.get(series)
            rings = self._rings.get(series)
            if meta is None or rings is None:
                return []
            names = meta["label_names"]
            return [dict(zip(names, key)) for key in rings]

    def reset(self) -> None:
        """Drop every ring (tests and bench open fresh windows)."""
        with self._lock:
            self._rings.clear()
            self._meta.clear()
            self._samples = 0

    # -- windowed queries ----------------------------------------------

    def _window(
        self, series: str, labels: Dict[str, str], window_s: float,
        now: Optional[float],
    ) -> List[Tuple[float, object]]:
        now = time.monotonic() if now is None else now
        with self._lock:
            meta = self._meta.get(series)
            rings = self._rings.get(series)
            if meta is None or rings is None:
                return []
            key = tuple(
                (labels or {}).get(k, "") for k in meta["label_names"]
            )
            ring = rings.get(key)
            if not ring:
                return []
            lo = now - window_s
            return [s for s in ring if s[0] >= lo]

    def increase(
        self, series: str, window_s: float,
        labels: Optional[Dict[str, str]] = None, now: Optional[float] = None,
    ) -> Optional[float]:
        """Windowed counter increase: sum of positive per-step deltas
        (a negative step is a process restart — the counter restarted
        from zero, it did not count backwards). None until the window
        holds two samples."""
        win = self._window(series, labels or {}, window_s, now)
        if len(win) < 2:
            return None
        # A query aimed at the wrong kind (increase of a histogram,
        # quantile of a counter) answers None, never raises: rings are
        # homogeneous, so the first sample's shape decides.
        if not isinstance(win[0][1], (int, float)):
            return None
        total = 0.0
        for (_, prev), (_, cur) in zip(win, win[1:]):
            step = float(cur) - float(prev)
            if step > 0:
                total += step
        return total

    def rate(
        self, series: str, window_s: float,
        labels: Optional[Dict[str, str]] = None, now: Optional[float] = None,
    ) -> Optional[float]:
        """Windowed per-second rate over the OBSERVED span (first to
        last sample), not the nominal window — a sparse ring must not
        dilute a burst into a lower rate."""
        win = self._window(series, labels or {}, window_s, now)
        if len(win) < 2:
            return None
        elapsed = win[-1][0] - win[0][0]
        if elapsed <= 0:
            return None
        inc = self.increase(series, window_s, labels, now)
        return None if inc is None else inc / elapsed

    def delta(
        self, series: str, window_s: float,
        labels: Optional[Dict[str, str]] = None, now: Optional[float] = None,
    ) -> Optional[float]:
        """Gauge delta across the window (last - first; signed)."""
        win = self._window(series, labels or {}, window_s, now)
        if len(win) < 2 or not isinstance(win[0][1], (int, float)):
            return None
        return float(win[-1][1]) - float(win[0][1])

    def max_over_time(
        self, series: str, window_s: float,
        labels: Optional[Dict[str, str]] = None, now: Optional[float] = None,
    ) -> Optional[float]:
        win = self._window(series, labels or {}, window_s, now)
        if not win or not isinstance(win[0][1], (int, float)):
            return None
        return max(float(v) for _, v in win)

    def avg_over_time(
        self, series: str, window_s: float,
        labels: Optional[Dict[str, str]] = None, now: Optional[float] = None,
    ) -> Optional[float]:
        win = self._window(series, labels or {}, window_s, now)
        if not win or not isinstance(win[0][1], (int, float)):
            return None
        return sum(float(v) for _, v in win) / len(win)

    def hist_window(
        self, series: str, window_s: float,
        labels: Optional[Dict[str, str]] = None, now: Optional[float] = None,
    ) -> Optional[Tuple[int, float, Tuple[int, ...]]]:
        """Histogram deltas across the window: (count, sum, per-bucket
        raw counts). Counter-reset tolerant: when the process restarted
        mid-window (count went backwards), the last snapshot alone IS
        the since-restart window. None until two samples exist."""
        win = self._window(series, labels or {}, window_s, now)
        if len(win) < 2 or not isinstance(win[0][1], tuple):
            return None
        (c0, s0, b0) = win[0][1]
        (c1, s1, b1) = win[-1][1]
        if c1 < c0 or len(b0) != len(b1):
            return (c1, s1, tuple(b1))
        return (
            c1 - c0,
            s1 - s0,
            tuple(max(0, b - a) for a, b in zip(b0, b1)),
        )

    def quantile_over_time(
        self, series: str, q: float, window_s: float,
        labels: Optional[Dict[str, str]] = None, now: Optional[float] = None,
    ) -> Optional[float]:
        """Interpolated quantile of the observations that landed INSIDE
        the window (bucket deltas -> metrics.bucket_quantile). None when
        the window lacks two samples or saw zero new observations —
        the caller decides whether that means no_data or lifetime
        fallback (utils/slo.py chooses fallback)."""
        hw = self.hist_window(series, window_s, labels, now)
        if hw is None:
            return None
        count, _total_sum, bucket_deltas = hw
        if count <= 0:
            return None
        with self._lock:
            meta = self._meta.get(series)
            bounds = meta["buckets"] if meta else ()
        if not bounds:
            return None
        q_v = metrics.bucket_quantile(bounds, bucket_deltas, count, q)
        return None if q_v != q_v else q_v  # NaN-safe

    # -- debug surface -------------------------------------------------

    def snapshot(
        self, series: str = "", window_s: float = 300.0,
    ) -> dict:
        """The /debug/timeseries payload: the series inventory, or —
        with ?series= — per-label-set windowed figures."""
        out = {
            "kind": "TimeseriesReport",
            "sampled": self.sampled,
            "samples": self.samples,
            "retainSamples": self.retain_samples,
            "series": self.series_names(),
        }
        if not series:
            return out
        with self._lock:
            meta = self._meta.get(series)
        if meta is None:
            out["query"] = {"series": series, "found": False}
            return out
        rows = []
        for labels in self.label_sets(series):
            row: dict = {"labels": labels}
            win = self._window(series, labels, window_s, None)
            row["samplesInWindow"] = len(win)
            if meta["type"] == "histogram":
                hw = self.hist_window(series, window_s, labels)
                if hw is not None:
                    row["increase"] = hw[0]
                for q in (0.5, 0.99):
                    v = self.quantile_over_time(series, q, window_s, labels)
                    if v is not None:
                        row[f"p{int(q * 100)}"] = round(v, 6)
            elif meta["type"] == "counter":
                inc = self.increase(series, window_s, labels)
                if inc is not None:
                    row["increase"] = round(inc, 6)
                r = self.rate(series, window_s, labels)
                if r is not None:
                    row["rate"] = round(r, 6)
            else:
                for fn, label in (
                    (self.delta, "delta"),
                    (self.max_over_time, "max"),
                    (self.avg_over_time, "avg"),
                ):
                    v = fn(series, window_s, labels)
                    if v is not None:
                        row[label] = round(v, 6)
            rows.append(row)
        out["query"] = {
            "series": series,
            "found": True,
            "type": meta["type"],
            "windowS": window_s,
            "labelSets": rows,
        }
        return out


class Sampler:
    """Background cadence thread over one Retention store. Hooks run
    after every sweep on the sampler thread (the alert engine rides
    here so rule evaluation shares the retention clock)."""

    def __init__(self, retention: Retention):
        self.retention = retention
        self.interval_s = DEFAULT_INTERVAL_S
        self._hooks: List[Callable[[], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = sanitizer.lock("timeseries.sampler")

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def add_hook(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if fn not in self._hooks:
                self._hooks.append(fn)

    def sweep(self) -> None:
        """One sweep + hooks (also the synchronous entry point for
        tests and CLI paths that want deterministic sampling)."""
        t0 = time.monotonic()
        self.retention.sample_now()
        with self._lock:
            hooks = list(self._hooks)
        for fn in hooks:
            try:
                fn()
            except Exception:
                pass  # a broken hook must not kill the cadence
        SAMPLE_SECONDS.observe(time.monotonic() - t0)

    def start(self, interval_s: Optional[float] = None) -> "Sampler":
        """Idempotent: the first caller sets the cadence; later callers
        get the running sampler (one per process, like capacity's
        monitor)."""
        with self._lock:
            if interval_s is not None:
                self.interval_s = float(interval_s)
            t = self._thread
            if t is not None and (t.ident is None or t.is_alive()):
                return self  # running, or about to be started
            self._stop.clear()
            t = self._thread = threading.Thread(
                target=self._run, daemon=True, name="kt-timeseries-sampler"
            )
        # Started outside the lock: Thread.start waits for the thread
        # to run, a wait the sanitizer reports under a lock (JAX's
        # sampler starts it under its lock).
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t = self._thread
            self._thread = None
        # Join OUTSIDE the lock: the sampler thread's sweep takes it
        # for the hook list, so joining under it would deadlock until
        # the timeout.
        if t is not None:
            t.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sweep()
            except Exception:
                pass  # the health plane must never take a daemon down


#: Process-global retention + sampler (the shape every plane uses:
#: capacity.DEFAULT, rebalance.DEFAULT, ...). Nothing runs until
#: ensure_started() — unit tests and thin apiservers pay nothing.
DEFAULT = Retention()
SAMPLER = Sampler(DEFAULT)


def ensure_started(interval_s: Optional[float] = None) -> Sampler:
    """Start the process-global sampler if not already running
    (daemons, local-up, soak, bench). KT_TIMESERIES=0 disables."""
    if os.environ.get("KT_TIMESERIES", "1") == "0":
        return SAMPLER
    return SAMPLER.start(interval_s=interval_s)
