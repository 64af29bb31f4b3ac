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

`observe_device_telemetry()` samples the build pair and device memory;
it never raises, and on a process without a card it sets no memory
gauge. The lifecycle SLIs and watch lag of the JAX module need the
apiserver's store; they are not here.
"""

from __future__ import annotations

import threading

from kubernetes_tpu_torch.utils import metrics

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


_SEEN = {"builds": 0}
_SEEN_LOCK = threading.Lock()


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
