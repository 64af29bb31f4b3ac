"""The port's Sinkhorn solver against the JAX package's, on the CPU.

`torch.logsumexp` and `jax.nn.logsumexp` may round differently in the
last place, so Sinkhorn is held to tolerances instead of bit equality:

- the congestion prices of one masked matrix agree within 1e-4 absolute
  (the residual within 1e-4 too), and the iterations run are equal, with
  tol 0 (every update until the residual is 0) and tol > 0 (early stop);
- decisions agree with JAX's on at least 99% of the pods of the parity
  fuzz clusters and of the 2,000 x 200 backlog, and wave counts within
  one;
- every placement is valid by the JAX package's oracle, and the port's
  output meets `tests/test_quality_regression.py`'s
  `TestSinkhornQuality` bounds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from __graft_entry__ import _synthetic_objects
from kubernetes_tpu.models.columnar import build_snapshot as jbuild_snapshot
from kubernetes_tpu.ops import device_snapshot as jdevice_snapshot
from kubernetes_tpu.ops import oracle as joracle
from kubernetes_tpu.ops import sinkhorn as jsinkhorn
from kubernetes_tpu.ops.pipeline import solve_backlog_pipelined as jpipelined
from kubernetes_tpu.scheduler.batch import schedule_backlog_sinkhorn as jschedule_sinkhorn
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.models.columnar import build_snapshot
from kubernetes_tpu_torch.ops import oracle, sinkhorn
from kubernetes_tpu_torch.ops.matrices import device_snapshot, state_from_numpy
from kubernetes_tpu_torch.ops.pipeline import solve_backlog_pipelined
from kubernetes_tpu_torch.scheduler.batch import schedule_backlog_sinkhorn
from kubernetes_tpu_torch.utils.tracing import PhaseTimer
from tests.test_solver_parity import random_cluster

PRICE_ATOL = 1e-4  # prices and residual, absolute
AGREEMENT = 0.99  # share of pods with the JAX package's node
WAVE_MARGIN = 1  # wave counts within this many of JAX's


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    several worker processes at once, and W x N tensor operations on
    every core from each of them would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _congested(seed, W=64, N=12):
    """A masked score matrix where many pods want a few nodes of small
    pod-count capacity, so the prices must work for several updates."""
    rng = np.random.default_rng(seed)
    masked = rng.integers(0, 31, size=(W, N)).astype(np.float32)
    masked[:, :3] += 10  # three popular nodes
    masked[rng.random((W, N)) < 0.3] = -1
    masked[:4] = -1  # pods with no feasible node ship no mass
    valid = rng.random(W) < 0.9
    capacity = rng.choice([0, 1, 2, 5], size=N).astype(np.float32)
    return masked, valid, capacity


@pytest.mark.parametrize("tol", [0.0, 1.0, 2.0])
@pytest.mark.parametrize("iters", [0, 1, 8, 20])
@pytest.mark.parametrize("seed", range(4))
def test_congestion_prices_within_tolerance(seed, iters, tol):
    masked, valid, capacity = _congested(seed)
    rg, ri, rr = jsinkhorn._congestion_prices(
        jnp.asarray(masked), jnp.asarray(valid), jnp.asarray(capacity), 2.0, iters, tol)
    g, i, r = sinkhorn._congestion_prices(
        torch.from_numpy(masked), torch.from_numpy(valid), torch.from_numpy(capacity),
        2.0, iters, tol)
    assert int(i) == int(ri), "iterations run differ"
    assert g.dtype == torch.float32 and np.allclose(g.numpy(), np.asarray(rg), rtol=0, atol=PRICE_ATOL)
    assert abs(float(r) - float(rr)) <= PRICE_ATOL
    if iters:
        assert int(i) >= 1


def test_congested_prices_do_iterate():
    """The cases above exercise the loop: at tol 0 some run every
    update with a positive residual, and a looser tol stops earlier."""
    runs = {}
    for tol in (0.0, 1.0):
        masked, valid, capacity = _congested(1)
        _, i, r = sinkhorn._congestion_prices(
            torch.from_numpy(masked), torch.from_numpy(valid), torch.from_numpy(capacity),
            2.0, 20, tol)
        runs[tol] = (int(i), float(r))
    assert runs[0.0][0] > runs[1.0][0] >= 1
    assert runs[0.0][1] > 0.0


def _staged(pending, nodes, assigned=(), services=()):
    d = jdevice_snapshot(jbuild_snapshot(pending, nodes, assigned, services))
    return ({k: np.asarray(v) for k, v in d.pods.items()},
            {k: np.asarray(v) for k, v in d.nodes.items()})


def _both(pods, nodes, **kw):
    ra, rc, rw, ri, rr = jsinkhorn.solve_sinkhorn_with_state(
        {k: jnp.asarray(v) for k, v in pods.items()},
        {k: jnp.asarray(v) for k, v in nodes.items()}, **kw)
    tp, tn = state_from_numpy(pods, nodes, device="cpu")
    ga, gn, gw, gi, gr = sinkhorn.solve_sinkhorn_with_state(tp, tn, **kw)
    return (np.asarray(ra), int(rw), int(ri), float(rr)), (ga.numpy(), gw, int(gi), float(gr))


@pytest.mark.parametrize("window", [8, 32, 4096])
@pytest.mark.parametrize("seed", range(8))
def test_decisions_agree_with_jax(seed, window):
    pending, nodes, assigned, services = random_cluster(seed)
    (ra, rw, ri, rr), (ga, gw, gi, gr) = _both(*_staged(pending, nodes, assigned, services),
                                               window=window)
    assert float((ra == ga).mean()) >= AGREEMENT
    assert abs(gw - rw) <= WAVE_MARGIN
    if (ra == ga).all():
        assert (gi, gw) == (ri, rw) and abs(gr - rr) <= PRICE_ATOL
    joracle.validate_assignment_numpy(jbuild_snapshot(pending, nodes, assigned, services),
                                      ga[: len(pending)])


@pytest.fixture(scope="module")
def backlog_2000x200():
    jpods, jnodes, jservices = _synthetic_objects(2000, 200, seed=5)
    return {"port": workload.synthetic_objects(2000, 200, seed=5),
            "jax": (jpods, jnodes, jservices)}


def test_backlog_agrees_with_jax(backlog_2000x200):
    """The 2,000 x 200 backlog in one window and in windows of 256: the
    iteration totals are equal wherever every decision is."""
    jpods, jnodes, jservices = backlog_2000x200["jax"]
    pods, nodes = _staged(jpods, jnodes, services=jservices)
    for window in (4096, 256):
        (ra, rw, ri, rr), (ga, gw, gi, gr) = _both(pods, nodes, window=window)
        assert float((ra == ga).mean()) >= AGREEMENT
        assert abs(gw - rw) <= WAVE_MARGIN
        if (ra == ga).all():
            assert gi == ri and abs(gr - rr) <= PRICE_ATOL
        # solve_sinkhorn: the same solve on a copy of the carry.
        tp, tn = state_from_numpy(pods, nodes, device="cpu")
        sa, sw = sinkhorn.solve_sinkhorn(tp, tn, window=window)
        assert np.array_equal(sa.numpy(), ga) and sw == gw
        assert np.array_equal(tn["pods_used"].numpy(), nodes["pods_used"])


def test_pipelined_and_batch_agree_with_jax(backlog_2000x200):
    """Chunks of 512 on the chained carry, and schedule_backlog_sinkhorn:
    node names agree with the JAX package's, the timer carries waves,
    iterations and the residual."""
    pods, nodes, services = backlog_2000x200["port"]
    jpods, jnodes, jservices = backlog_2000x200["jax"]
    timer = PhaseTimer()
    got = solve_backlog_pipelined(pods, nodes, services=services, chunk=512, mode="sinkhorn",
                                  device="cpu", timer=timer)
    ref = jpipelined(jpods, jnodes, services=jservices, chunk=512, mode="sinkhorn")
    assert np.mean([a == b for a, b in zip(got, ref)]) >= AGREEMENT
    assert sum(n is not None for n in got) == 2000
    assert timer.stats["waves"] >= 4 and timer.stats["sinkhorn_iters"] >= timer.stats["waves"]
    assert timer.stats["sinkhorn_residual"] >= 0.0
    got = schedule_backlog_sinkhorn(pods, nodes, services=services, device="cpu")
    ref = jschedule_sinkhorn(jpods, jnodes, services=jservices)
    assert np.mean([a == b for a, b in zip(got, ref)]) >= AGREEMENT


def test_sinkhorn_quality_bounds(backlog_2000x200):
    """tests/test_quality_regression.py::TestSinkhornQuality on the
    port's Sinkhorn: every pod placed and valid, mean regret at most 1.5,
    p99 at most 10, greedy matches at least 25%."""
    pods, nodes, services = backlog_2000x200["port"]
    snap = build_snapshot(pods, nodes, services=services)
    a, _ = sinkhorn.sinkhorn_assignments(device_snapshot(snap, "cpu"))
    oracle.validate_assignment_numpy(snap, a)
    q = oracle.assignment_quality(snap, a)
    assert q["placed"] == 2000, "sinkhorn left pods unplaced"
    assert q["feasible_in_order"] >= 0.99
    assert q["mean_regret"] <= 1.5, q
    assert q["p99_regret"] <= 10, q
    assert q["greedy_match"] >= 0.25, q


def test_fewer_waves_than_plain_wave(backlog_2000x200):
    """Congestion pricing settles the backlog in fewer waves than the
    plain wave solver, as in the JAX package (tests/test_sinkhorn.py)."""
    from kubernetes_tpu_torch.ops.wave import wave_assignments

    pods, nodes, services = backlog_2000x200["port"]
    d = device_snapshot(build_snapshot(pods, nodes, services=services), "cpu")
    _, sw = sinkhorn.sinkhorn_assignments(d)
    _, ww = wave_assignments(d)
    assert sw < ww
