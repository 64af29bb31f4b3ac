"""Solve convergence telemetry.

The counterpart of `observe_solve_telemetry` of
`kubernetes_tpu/utils/flightrecorder.py`, with its two series: the
iterations a solve ran (`scheduler_solve_iterations{mode}`: waves for
the wave solver, total price iterations for Sinkhorn) and Sinkhorn's
last residual (`scheduler_sinkhorn_residual`). The pipeline, the batch
wrappers and the incremental session feed it, so the series do not
depend on which path ran. The decision ring and its debug views need
the daemon and are not here.
"""

from __future__ import annotations

from typing import Optional

from kubernetes_tpu_torch.utils import metrics

#: Final Sinkhorn column-mass residual (log domain) of the latest solve.
SINKHORN_RESIDUAL = metrics.DEFAULT.gauge(
    "scheduler_sinkhorn_residual",
    "Final Sinkhorn column-mass residual (log domain) of the latest solve",
)

#: Device solve iterations per solve, by mode. Buckets are powers of two:
#: iteration counts, not seconds.
SOLVE_ITERATIONS = metrics.DEFAULT.histogram(
    "scheduler_solve_iterations",
    "Device solve iterations per solve (waves / Sinkhorn price updates)",
    ("mode",),
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096),
)


def observe_solve_telemetry(mode: str, iterations: int, residual: Optional[float] = None) -> None:
    """One solve's convergence telemetry: the iteration histogram, and
    the residual gauge for the Sinkhorn family. (The JAX function also
    parks the figures for the daemon's solve record, which the port does
    not have yet.)"""
    SOLVE_ITERATIONS.observe(float(iterations), mode=mode)
    if residual is not None:
        SINKHORN_RESIDUAL.set(float(residual))
