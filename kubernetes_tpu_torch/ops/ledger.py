"""The kernel ledger: each hand kernel's calls, builds and cost.

The counterpart of `kubernetes_tpu/ops/ledger.py` (`CompileLedger`,
`traced_jit`). The port has no jit: its kernels are built once per
source by `ops/build.py` and launched by hand-written wrappers, so the
ledger is fed at those two places:

- **calls**: each launch wrapper notes one call per launch, under impl
  "cuda" (`scan_kernel.scan_with_state`, `policy_scan.
  policy_scan_with_state`, `rebalance.plan_moves`: the same places
  that add to their `.launches` counters), and one call per run of the
  plain version under the same kernel name with impl "plain", so a CPU
  run counts the calls a JAX run counts through `traced_jit`;
- **compiles** and **compile_seconds**: each nvcc build (impl "cuda")
  and g++ build (impl "host") of `ops/build.py`, also summed into the
  `solver_compile_seconds_total{kernel}` counter;
- **per shape signature**, a cost row: the 32-bit operations (`flops`,
  the JAX field's name) and the bytes (`bytes_accessed`) that one
  launch at that shape needs, by the count PERF.md §6's bounds use,
  taken from the launch's shapes (every pod row and every worklist row
  counted: the ceiling of what the data can ask). This is the
  counterpart of XLA's `cost_analysis`, worked out from the launch
  plan instead of harvested from a compile, so it is there at once.

A call costs one lock, one dict lookup and two increments; the cost row
is worked out the first time a signature is seen. `DEFAULT` is the
process-wide ledger, as in the JAX package.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.utils import metrics

#: Wall seconds spent building kernel libraries, by kernel (the JAX
#: package's series, there fed by XLA compiles).
COMPILE_SECONDS = metrics.DEFAULT.counter(
    "solver_compile_seconds_total",
    "Wall seconds spent building the port's kernel libraries (nvcc, g++), by kernel",
    ("kernel",),
)


def _cost_fields(cost: Dict[str, float]) -> Dict[str, float]:
    """A cost row's figures under the JAX ledger's names, with the
    derived arithmetic intensity."""
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes_accessed", 0.0))
    out = {"flops": flops, "bytes_accessed": nbytes, "cost_status": "ok"}
    if nbytes > 0:
        out["arithmetic_intensity"] = round(flops / nbytes, 4)
    return out


class KernelLedger:
    """Thread-safe rows keyed by (kernel, impl). One instance per
    process (`DEFAULT`); the launch wrappers and `ops/build.py` share it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._rows: Dict[Tuple[str, str], dict] = {}

    def _row(self, kernel: str, impl: str) -> dict:
        row = self._rows.get((kernel, impl))
        if row is None:
            row = self._rows[(kernel, impl)] = {
                "calls": 0, "compiles": 0, "compile_seconds": 0.0, "shapes": {},
            }
        return row

    def note_call(
        self,
        kernel: str,
        impl: str = "cuda",
        signature: Optional[str] = None,
        cost: Optional[Callable[[], Dict[str, float]]] = None,
    ) -> None:
        """One launch (impl "cuda") or one run of the plain version
        ("plain"). `signature` keys the shape row; `cost()` gives its
        {flops, bytes_accessed} and is called only for a new signature."""
        with self._lock:
            row = self._row(kernel, impl)
            row["calls"] += 1
            if signature is None:
                return
            shape = row["shapes"].get(signature)
            fresh = shape is None
            if fresh:
                shape = row["shapes"][signature] = {"signature": signature, "calls": 0}
            shape["calls"] += 1
        if fresh and cost is not None:
            fields = _cost_fields(cost())
            with self._lock:
                shape.update(fields)

    def record_build(self, kernel: str, impl: str, seconds: float) -> None:
        """One library build of `kernel` (impl "cuda": nvcc, "host": g++)."""
        COMPILE_SECONDS.inc(seconds, kernel=kernel)
        with self._lock:
            row = self._row(kernel, impl)
            row["compiles"] += 1
            row["compile_seconds"] += seconds

    # -- reads ---------------------------------------------------------

    def calls(self, kernel: str, impl: str = "cuda") -> int:
        with self._lock:
            row = self._rows.get((kernel, impl))
            return row["calls"] if row else 0

    def rows(self) -> List[dict]:
        """One row per (kernel, impl), shape rows sorted by signature;
        copies the caller may change."""
        with self._lock:
            return [
                {
                    "kernel": kernel,
                    "impl": impl,
                    "calls": row["calls"],
                    "compiles": row["compiles"],
                    "compile_seconds": round(row["compile_seconds"], 6),
                    "shapes": [dict(row["shapes"][sig]) for sig in sorted(row["shapes"])],
                }
                for (kernel, impl), row in sorted(self._rows.items())
            ]

    def summary(self, rows: Optional[List[dict]] = None) -> dict:
        rows = self.rows() if rows is None else rows

        def best(metric: str) -> List[dict]:
            ranked = sorted(
                (
                    (max((s.get(metric, 0.0) for s in r["shapes"]), default=0.0),
                     r["kernel"], r["impl"])
                    for r in rows
                ),
                reverse=True,
            )
            return [{"kernel": k, "impl": i, metric: v} for v, k, i in ranked[:3] if v > 0]

        return {
            "kernels": len({r["kernel"] for r in rows}),
            "rows": len(rows),
            "compiles": sum(r["compiles"] for r in rows),
            "calls_total": sum(r["calls"] for r in rows),
            "compile_seconds_total": round(sum(r["compile_seconds"] for r in rows), 6),
            "top_flops": best("flops"),
            "top_bytes": best("bytes_accessed"),
        }

    def to_dict(self) -> dict:
        """The `/debug/kernels` body: the rows and their summary, from
        one read of the rows."""
        rows = self.rows()
        return {"kernels": rows, "summary": self.summary(rows)}

    def reset(self) -> None:
        with self._lock:
            self._rows.clear()


DEFAULT = KernelLedger()
