"""Device operations: staging, the solver and its kernels, the windowed
solvers (wave, Sinkhorn), the pipeline and the explain readback, the
incremental session, the solver sidecar, and the NumPy oracle."""

from kubernetes_tpu_torch.ops.incremental import (  # noqa: F401
    RebuildRequired,
    SessionGang,
    SolverSession,
)

__all__ = ["RebuildRequired", "SessionGang", "SolverSession"]
