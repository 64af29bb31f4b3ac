"""Device operations: staging, the solver and its kernels, the windowed
solvers (wave, Sinkhorn), the pipeline and the explain readback, the
incremental session, the solver sidecar, preemption (`preemption`), the
capacity report (`capacity`), the defrag plan and its kernel K2
(`rebalance`), the kernel ledger (`ledger`), the builds (`build`), and
the NumPy oracle."""

from kubernetes_tpu_torch.ops.capacity import capacity_report  # noqa: F401
from kubernetes_tpu_torch.ops.incremental import (  # noqa: F401
    RebuildRequired,
    SessionGang,
    SolverSession,
)
from kubernetes_tpu_torch.ops.preemption import (  # noqa: F401
    PreemptionDecision,
    build_preemption_problem,
    solve_preemption,
)
from kubernetes_tpu_torch.ops.rebalance import plan_moves  # noqa: F401

__all__ = [
    "PreemptionDecision",
    "RebuildRequired",
    "SessionGang",
    "SolverSession",
    "build_preemption_problem",
    "capacity_report",
    "plan_moves",
    "solve_preemption",
]
