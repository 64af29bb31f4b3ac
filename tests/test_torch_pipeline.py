"""The port's entry points give the JAX package's node names.

`solve_backlog_pipelined` (chunked, the carry chained across chunks) and
`schedule_backlog` (one full relower) run on the CPU with the plain scan
and must name the same node for every pod as the JAX package does."""

import pytest

from __graft_entry__ import _synthetic_objects
from kubernetes_tpu.ops.pipeline import solve_backlog_pipelined as jpipelined
from kubernetes_tpu.scheduler.batch import schedule_backlog_tpu
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.ops.pipeline import solve_backlog_pipelined
from kubernetes_tpu_torch.scheduler.batch import schedule_backlog
from kubernetes_tpu_torch.utils.tracing import PhaseTimer


@pytest.fixture(scope="module")
def backlog_600x40():
    jpods, jnodes, jservices = _synthetic_objects(600, 40)
    return {
        "port": workload.synthetic_objects(600, 40),
        "jax_names": schedule_backlog_tpu(jpods, jnodes, services=jservices),
        "jax_pipelined": jpipelined(jpods, jnodes, services=jservices, chunk=128),
    }


def test_jax_paths_agree(backlog_600x40):
    assert backlog_600x40["jax_pipelined"] == backlog_600x40["jax_names"]


def test_pipelined_matches_jax(backlog_600x40):
    pods, nodes, services = backlog_600x40["port"]
    timer = PhaseTimer()
    names = solve_backlog_pipelined(
        pods, nodes, services=services, device="cpu", chunk=128, timer=timer
    )
    assert names == backlog_600x40["jax_pipelined"]
    assert sum(n is not None for n in names) > 0
    assert set(timer.seconds) == {"lower", "upload", "solve", "readback"}


def test_schedule_backlog_matches_jax(backlog_600x40):
    pods, nodes, services = backlog_600x40["port"]
    names = schedule_backlog(pods, nodes, services=services, device="cpu")
    assert names == backlog_600x40["jax_names"]


@pytest.mark.parametrize("seed", range(3))
def test_pipelined_with_assigned_pods_matches_jax(seed):
    """Occupancy from bound pods, volumes and pins, over chunks of 64."""
    pending, nodes, assigned, services = workload.small_cluster(seed)
    got = solve_backlog_pipelined(
        pending, nodes, assigned, services, device="cpu", chunk=64
    )
    ref = jpipelined(pending, nodes, assigned, services, chunk=64)
    assert got == ref
    assert got == schedule_backlog(pending, nodes, assigned, services, device="cpu")


def test_unported_modes_raise():
    pods, nodes, services = workload.synthetic_objects(4, 2)
    for mode in ("wave", "sinkhorn"):
        with pytest.raises(NotImplementedError, match="wave/sinkhorn"):
            solve_backlog_pipelined(pods, nodes, services=services, device="cpu", mode=mode)
    with pytest.raises(ValueError):
        solve_backlog_pipelined(pods, nodes, services=services, device="cpu", mode="nope")


def test_empty_backlog():
    _, nodes, services = workload.synthetic_objects(4, 2)
    assert solve_backlog_pipelined([], nodes, services=services, device="cpu") == []
    assert schedule_backlog([], nodes, services=services, device="cpu") == []
