"""Device telemetry: transfer bytes, kernel builds and device memory.

The device-telemetry half of `kubernetes_tpu/utils/sli.py`, under its
series names:

- **transfer bytes** (`solver_device_transfer_bytes_total{direction}`):
  host-to-device and device-to-host bytes of the solve paths, noted
  from the staged buffer sizes by `note_transfer` (fed by
  `ops/matrices.py`'s staging, the pipeline's readback and the
  incremental session), as the JAX package counts them;
- **the build pair**, the counterpart of the JAX package's XLA
  compile-cache sentinel: `solver_xla_compile_cache_entries` holds the
  kernel libraries this process has loaded (`ops/build.py`), and
  `solver_xla_compiles_total` counts the builds (nvcc, g++; the kernel
  ledger's compiles) seen between samples;
- **device memory** (`device_memory_bytes{kind}`): `in_use` and `peak`
  from `torch.cuda.memory_stats` (`allocated_bytes.all.current`,
  `.peak`), `limit` from `torch.cuda.mem_get_info` (the card's total);
- **informer staleness** (`scheduler_informer_staleness_seconds
  {resource}`): seconds since each of the scheduler daemon's watch-fed
  caches last processed a delta or re-list, set by the daemon every
  tick.

- **lifecycle SLIs** (`LifecycleSLICollector`, `DEFAULT`): one
  subscriber on the kvstore's event dispatcher (`KVStore.subscribe`,
  the feed the apiserver's watch cache rides) turns pod events into
  the `pod_startup_latency_seconds{milestone}` histogram (created,
  decision from the flight recorder's decision sink, bound, running),
  as the JAX module does; the port's `APIServer` attaches it;
- **watch fan-out lag** (`observe_watch_lag`,
  `watch_fanout_lag_versions{resource}`): store versions a watch
  delivery trails the watch cache's applied watermark by.

`observe_device_telemetry()` samples the build pair and device memory;
it never raises, and on a process without a card it sets no memory
gauge. It is the one function here that touches torch; the apiserver's
process never calls it.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

from kubernetes_tpu_torch.utils import flightrecorder, metrics, sanitizer

#: Store key prefix of the pod resource (registry.ResourceInfo.prefix
#: shape): the collector filters the firehose on it first thing.
POD_PREFIX = "/registry/pods/"
_PREFIX_LEN = len(POD_PREFIX)

#: Pod lifecycle milestone watermarks, measured from the watch-visible
#: ADDED event (density.go's pod-startup measurement, always on).
STARTUP_LATENCY = metrics.DEFAULT.histogram(
    "pod_startup_latency_seconds",
    "Pod lifecycle milestone latency from watch-visible creation "
    "(milestone: decision | bound | running)",
    ("milestone",),
)

#: Store versions a watch connection's delivered burst trails the
#: watch cache's applied watermark by (0 = the consumer is current).
#: Buckets are powers of two: version counts, not seconds.
WATCH_LAG = metrics.DEFAULT.histogram(
    "watch_fanout_lag_versions",
    "Store versions a watch delivery trails the applied watermark by",
    ("resource",),
    buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 1024, 4096, 16384, 65536),
)

#: Host<->device transfer volume of the solve pipelines, from the
#: staged buffer sizes (direction: h2d | d2h).
TRANSFER_BYTES = metrics.DEFAULT.counter(
    "solver_device_transfer_bytes_total",
    "Host<->device bytes staged by the solve pipelines",
    ("direction",),
)

#: The JAX package's compile-cache pair, here over kernel libraries: the
#: libraries loaded in this process, and the builds seen between samples
#: (steady growth under steady load would mean rebuilds on the tick).
XLA_CACHE_ENTRIES = metrics.DEFAULT.gauge(
    "solver_xla_compile_cache_entries",
    "Kernel libraries (nvcc, g++) loaded by this process",
)
XLA_COMPILES = metrics.DEFAULT.counter(
    "solver_xla_compiles_total",
    "Kernel library builds observed between telemetry samples",
)

#: Live device memory (kind: in_use | peak | limit).
INFORMER_STALENESS = metrics.DEFAULT.gauge(
    "scheduler_informer_staleness_seconds",
    "Seconds since the scheduler informer last processed a delta",
    ("resource",),
)

DEVICE_MEMORY = metrics.DEFAULT.gauge(
    "device_memory_bytes",
    "Accelerator memory reported by the backend, by kind",
    ("kind",),
)


def nbytes_of(cols) -> int:
    """Total bytes of the arrays or tensors in a dict or dataclass of
    columns (the staged host buffers)."""
    if isinstance(cols, dict):
        vals = cols.values()
    else:
        vals = vars(cols).values() if hasattr(cols, "__dict__") else ()
    total = 0
    for v in vals:
        n = getattr(v, "nbytes", None)
        if n is None and hasattr(v, "element_size"):
            n = v.element_size() * v.numel()
        total += n or 0
    return total


def note_transfer(direction: str, nbytes: int) -> None:
    if nbytes > 0:
        TRANSFER_BYTES.inc(float(nbytes), direction=direction)


def observe_watch_lag(resource: str, lag_versions: int) -> None:
    WATCH_LAG.observe(float(max(0, lag_versions)), resource=resource)


_SEEN = {"builds": 0}
# The counterpart of JAX's `sli.xla` lock (its XLA compile-cache count),
# named for what it guards here: the kernel builds already reported.
_SEEN_LOCK = sanitizer.lock("sli.device")


def observe_device_telemetry() -> None:
    """One telemetry sample: the build pair, and device memory when a
    card is there. Never raises."""
    from kubernetes_tpu_torch.ops import build, ledger

    XLA_CACHE_ENTRIES.set(build.loaded_libraries())
    builds = sum(r["compiles"] for r in ledger.DEFAULT.rows())
    with _SEEN_LOCK:
        grown = builds - _SEEN["builds"]
        # A reset ledger (tests) restarts the count from its new floor.
        _SEEN["builds"] = builds
    if grown > 0:
        XLA_COMPILES.inc(grown)
    try:
        import torch

        if not torch.cuda.is_available():
            return
        stats = torch.cuda.memory_stats()
        _free, total = torch.cuda.mem_get_info()
    except (RuntimeError, AssertionError):
        return
    for key, kind in (("allocated_bytes.all.current", "in_use"),
                      ("allocated_bytes.all.peak", "peak")):
        if key in stats:
            DEVICE_MEMORY.set(float(stats[key]), kind=kind)
    DEVICE_MEMORY.set(float(total), kind="limit")


class LifecycleSLICollector:
    """Watch-fed pod-lifecycle milestone collector (informer-style:
    state is kept current by events alone — it never lists or polls).

    Feed it by attaching to a store (``attach``: the kvstore dispatcher
    invokes ``_on_store_event`` for every event, in version order, on
    its own thread) and by the flight-recorder decision sink registered
    at module import (``note_decision``). Thread-safe; observations
    happen outside the track lock."""

    #: Bound on concurrently tracked (created-but-not-Running) pods;
    #: the oldest track is evicted at the cap, so a flood of pods that
    #: never progress cannot grow the collector without bound.
    MAX_TRACKED = 65536

    def __init__(self):
        self._lock = sanitizer.lock("sli.collector")
        # pod key ("ns/name") -> [created_mono, decided, bound, running]
        self._tracks: Dict[str, List] = {}
        self.enabled = True

    # -- wiring --------------------------------------------------------

    def attach(self, store) -> None:
        """Subscribe to a kvstore's event dispatcher (the same feed the
        apiserver watch cache rides). Idempotent per store: KVStore
        subscribers are append-only, so attach once per store."""
        store.subscribe(self._on_store_event)

    # -- event feed (dispatcher thread) --------------------------------

    def _on_store_event(self, version, etype, key, obj, prev) -> None:
        # Hot path: runs on the store dispatcher thread for EVERY pod
        # event — locals bound, untracked pods bail before any parsing,
        # the lock is taken only when state actually changes (dict
        # reads are GIL-atomic; the dispatcher is the sole writer of
        # store-event transitions).
        if not self.enabled or not key.startswith(POD_PREFIX):
            return
        pod_key = key[_PREFIX_LEN:]
        tracks = self._tracks
        if etype == "DELETED":
            if pod_key in tracks:
                with self._lock:
                    tracks.pop(pod_key, None)
            return
        if not isinstance(obj, dict):
            return
        spec = obj.get("spec")
        if etype == "ADDED":
            if spec and spec.get("nodeName"):
                return  # born bound (static pod / replay): no startup story
            now = time.monotonic()
            with self._lock:
                if (
                    len(tracks) >= self.MAX_TRACKED
                    and pod_key not in tracks
                ):
                    tracks.pop(next(iter(tracks)))
                tracks[pod_key] = [now, False, False, False]
            return
        # MODIFIED: bound / running transitions (tracked pods only).
        if pod_key not in tracks:
            return
        bound = bool(spec and spec.get("nodeName"))
        status = obj.get("status")
        running = bool(status) and status.get("phase") == "Running"
        if not (bound or running):
            return
        now = time.monotonic()
        observe_bound = observe_running = False
        with self._lock:
            t = tracks.get(pod_key)
            if t is None:
                return
            created = t[0]
            if bound and not t[2]:
                t[2] = observe_bound = True
            if running and not t[3]:
                t[3] = observe_running = True
            if t[3]:
                del tracks[pod_key]  # lifecycle complete: drain
        if observe_bound:
            STARTUP_LATENCY.observe(now - created, milestone="bound")
        if observe_running:
            STARTUP_LATENCY.observe(now - created, milestone="running")

    # -- decision join (flight-recorder sink, scheduler thread) --------

    def note_decision(self, pod_key: str, outcome: str = "") -> None:
        """The flight recorder logged a Decision for this pod: stamp
        the decision milestone (first one wins — retries re-decide but
        the SLI is time-to-first-decision)."""
        now = time.monotonic()
        with self._lock:
            t = self._tracks.get(pod_key)
            if t is None or t[1]:
                return
            t[1] = True
            created = t[0]
        STARTUP_LATENCY.observe(now - created, milestone="decision")

    # -- introspection -------------------------------------------------

    def tracked_count(self) -> int:
        with self._lock:
            return len(self._tracks)

    #: Bound on the oldest-unbound scan below — tracks are insertion-
    #: ordered so the oldest unbound pod sits near the front; a cap
    #: keeps the per-tick capacity sample O(1) even at MAX_TRACKED.
    _AGE_SCAN_LIMIT = 1024

    def oldest_unbound_age_s(self) -> float:
        """Age (seconds) of the oldest tracked pod that has not reached
        the bound milestone — the backlog-pressure age watermark
        (utils/capacity.py multiplies it by the FIFO depth). 0.0 when
        nothing is waiting."""
        now = time.monotonic()
        with self._lock:
            for i, t in enumerate(self._tracks.values()):
                if i >= self._AGE_SCAN_LIMIT:
                    break
                if not t[2]:  # not yet bound
                    return max(now - t[0], 0.0)
        return 0.0

    def reset(self) -> None:
        with self._lock:
            self._tracks.clear()


DEFAULT = LifecycleSLICollector()

# Every Decision the flight recorder logs stamps the pod's "decision"
# milestone (registered once at import; flightrecorder never imports
# sli, so there is no cycle).
flightrecorder.add_decision_sink(DEFAULT.note_decision)
