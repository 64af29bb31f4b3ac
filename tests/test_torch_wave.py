"""The port's wave solver equals the JAX package's, bit for bit.

On the CPU, from the same staged state (the JAX package's staging, read
into torch tensors by `state_from_numpy`):

- the building blocks: the tie hash, the capacity-aware packer and the
  bulk commit, on seeded random inputs;
- `solve_waves` and `solve_waves_with_state` on the parity fuzz clusters
  (`tests/test_solver_parity.py::random_cluster`, seeds 0-7) at windows
  of 32 and 4,096: assignment, the nine carry fields and the wave count;
- the chunked pipeline against the JAX `solve_backlog_pipelined(mode=
  "wave")` on the 2,000 x 200 backlog, and `schedule_backlog_wave`;
- validity by the JAX package's oracle, and the port's own copy of the
  oracle (`ops/oracle.py`) equal to it;
- `TestWaveQuality`'s regret bounds (`tests/test_quality_regression.py`)
  on the port's output.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from __graft_entry__ import _synthetic_objects
from kubernetes_tpu.models.columnar import build_snapshot as jbuild_snapshot
from kubernetes_tpu.ops import device_snapshot as jdevice_snapshot
from kubernetes_tpu.ops import oracle as joracle
from kubernetes_tpu.ops import wave as jwave
from kubernetes_tpu.ops.pipeline import solve_backlog_pipelined as jpipelined
from kubernetes_tpu.scheduler.batch import schedule_backlog_wave as jschedule_wave
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.models.columnar import build_snapshot
from kubernetes_tpu_torch.ops import oracle, wave
from kubernetes_tpu_torch.ops.matrices import CARRY_KEYS, device_snapshot, state_from_numpy, state_to_numpy
from kubernetes_tpu_torch.ops.pipeline import solve_backlog_pipelined
from kubernetes_tpu_torch.scheduler.batch import schedule_backlog_wave
from kubernetes_tpu_torch.utils.tracing import PhaseTimer
from tests.test_solver_parity import random_cluster


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    several worker processes at once, and W x N tensor operations on
    every core from each of them would contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _staged(pending, nodes, assigned=(), services=()):
    """The JAX package's staging as numpy dicts (pods, nodes)."""
    d = jdevice_snapshot(jbuild_snapshot(pending, nodes, assigned, services))
    return ({k: np.asarray(v) for k, v in d.pods.items()},
            {k: np.asarray(v) for k, v in d.nodes.items()})


def _jax(arrs):
    return {k: jnp.asarray(v) for k, v in arrs.items()}


def _assert_carry_equal(got_nodes, ref_nodes):
    got = state_to_numpy(got_nodes)
    for k in CARRY_KEYS:
        ref = np.asarray(ref_nodes[k])
        assert got[k].dtype == ref.dtype and np.array_equal(got[k], ref), f"carry field {k} differs"


# -- the building blocks ------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_tie_hash_equals_jax(seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << 30, size=33).astype(np.int32)
    idx[:3] = (0, 1, (1 << 31) - 1)
    N = int(rng.integers(1, 5000))
    ref = np.asarray(jwave._tie_hash(jnp.asarray(idx), N)).astype(np.int64)
    got = wave._tie_hash(torch.from_numpy(idx), N).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, ref)


def _random_window(rng, W, N, carriers=True):
    """A window's choices, requests and carrier flags, and a node state
    with room for some of them: choices crowd a few nodes."""
    choice = rng.integers(-1, min(N, 6), size=W).astype(np.int32)
    cpu = rng.choice([0, 100, 250, 500, 1000], size=W).astype(np.float32)
    mem = rng.choice([0, 64, 256, 1024], size=W).astype(np.float32)
    zero = (cpu == 0) & (mem == 0)
    bits = rng.random(W) < (0.3 if carriers else 0.0)
    nodes = {
        "cpu_cap": rng.choice([0, 1000, 2000, 4000], size=N).astype(np.float32),
        "mem_cap": rng.choice([0, 1024, 4096], size=N).astype(np.float32),
        "pods_cap": rng.choice([1, 3, 10, 40], size=N).astype(np.float32),
    }
    nodes["cpu_fit"] = (nodes["cpu_cap"] * rng.random(N) * 0.8).round().astype(np.float32)
    nodes["mem_fit"] = (nodes["mem_cap"] * rng.random(N) * 0.8).round().astype(np.float32)
    nodes["pods_used"] = np.minimum(rng.integers(0, 3, size=N), nodes["pods_cap"]).astype(np.float32)
    return choice, cpu, mem, zero, bits, nodes


@pytest.mark.parametrize("limit", [1, 2, 64])
@pytest.mark.parametrize("seed", range(6))
def test_pack_window_equals_jax(seed, limit):
    rng = np.random.default_rng(seed)
    W, N = 64, 9
    choice, cpu, mem, zero, bits, nodes = _random_window(rng, W, N)
    ref = np.asarray(jwave._pack_window(
        jnp.asarray(choice), jnp.asarray(cpu), jnp.asarray(mem), jnp.asarray(zero),
        jnp.asarray(bits), _jax(nodes), N, W, limit))
    got = wave._pack_window(
        torch.from_numpy(choice), torch.from_numpy(cpu), torch.from_numpy(mem),
        torch.from_numpy(zero), torch.from_numpy(bits),
        {k: torch.from_numpy(v) for k, v in nodes.items()}, N, W, limit).numpy()
    assert np.array_equal(got, ref)
    assert 0 < got.sum() < W


@pytest.mark.parametrize("seed", range(6))
def test_commit_wave_equals_jax(seed):
    """The bulk commit of a packed window: resources, pod counts, the
    carriers' bit rows (one a node) and repeated service ids."""
    rng = np.random.default_rng(seed)
    W, N, S = 64, 9, 5
    choice, cpu, mem, zero, bits, cap = _random_window(rng, W, N)
    accepted = np.array(jwave._pack_window(
        jnp.asarray(choice), jnp.asarray(cpu), jnp.asarray(mem), jnp.asarray(zero),
        jnp.asarray(bits), _jax(cap), N, W, 2))
    words = lambda n: (rng.integers(0, 1 << 31, size=(n, 2)) * (rng.random((n, 1)) < 0.3)  # noqa: E731
                       ).astype(np.uint32)
    port, vol_any = words(W), words(W)
    port[~bits] = 0
    vol_any[~bits] = 0
    vol_rw = vol_any & np.uint32(0x0F0F0F0F)
    ids = rng.integers(-1, S, size=(W, 8)).astype(np.int32)
    ids[:, 1] = ids[:, 0]  # a repeated id commits twice
    wpods = {"cpu": cpu, "mem": mem, "port": port, "vol_any": vol_any, "vol_rw": vol_rw,
             "svc_ids": ids}
    nodes = dict(cap, cpu_used=cap["cpu_fit"] + 100, mem_used=cap["mem_fit"] + 64,
                 uport=words(N), uvol_any=words(N), uvol_rw=words(N),
                 svc_counts=rng.integers(0, 4, size=(N, S)).astype(np.float32))
    ref = jwave._commit_wave(_jax(nodes), _jax(wpods), jnp.asarray(choice), jnp.asarray(accepted), W)
    tpods, tnodes = state_from_numpy(wpods, nodes, device="cpu")
    wave._commit_wave(tnodes, tpods, torch.from_numpy(choice), torch.from_numpy(accepted))
    _assert_carry_equal(tnodes, ref)
    assert accepted.sum() > 0


# -- the solver -----------------------------------------------------------


@pytest.mark.parametrize("window", [32, 4096])
@pytest.mark.parametrize("seed", range(8))
def test_solve_waves_with_state_equals_jax(seed, window):
    pods, nodes = _staged(*random_cluster(seed))
    ra, rc, rw = jwave.solve_waves_with_state(_jax(pods), _jax(nodes), (1, 1, 1), window, 1)
    tp, tn = state_from_numpy(pods, nodes, device="cpu")
    ga, gn, gw = wave.solve_waves_with_state(tp, tn, (1, 1, 1), window, 1)
    assert gn is tn and ga.dtype == torch.int32
    assert np.array_equal(ga.numpy(), np.asarray(ra)), "assignments differ"
    assert gw == int(rw)
    _assert_carry_equal(gn, rc)
    # solve_waves: the same assignment and waves, the caller's state kept.
    tp, tn = state_from_numpy(pods, nodes, device="cpu")
    before = state_to_numpy(tn)
    sa, sw = wave.solve_waves(tp, tn, (1, 1, 1), window, 1)
    ja, jw = jwave.solve_waves(_jax(pods), _jax(nodes), (1, 1, 1), window, 1)
    assert np.array_equal(sa.numpy(), np.asarray(ja)) and sw == int(jw)
    assert all(np.array_equal(v, before[k]) for k, v in state_to_numpy(tn).items())


@pytest.mark.parametrize("weights,limit", [((2, 0, 3), 1), ((1, 1, 1), 3)])
def test_solve_waves_other_weights_and_limits(weights, limit):
    pending, nodes, services = _synthetic_objects(300, 30, seed=3)
    pods, state = _staged(pending, nodes, services=services)
    ra, rc, rw = jwave.solve_waves_with_state(_jax(pods), _jax(state), weights, 64, limit)
    tp, tn = state_from_numpy(pods, state, device="cpu")
    ga, gn, gw = wave.solve_waves_with_state(tp, tn, weights, 64, limit)
    assert np.array_equal(ga.numpy(), np.asarray(ra)) and gw == int(rw)
    _assert_carry_equal(gn, rc)


@pytest.fixture(scope="module")
def backlog_2000x200():
    jpods, jnodes, jservices = _synthetic_objects(2000, 200, seed=5)
    return {
        "port": workload.synthetic_objects(2000, 200, seed=5),
        "jax": (jpods, jnodes, jservices),
        "jax_pipelined": jpipelined(jpods, jnodes, services=jservices, chunk=512, mode="wave"),
    }


def test_pipelined_waves_equal_jax(backlog_2000x200):
    """Four chunks of 512 on the chained carry: every node name equals
    the JAX pipeline's, and the timer carries the waves."""
    pods, nodes, services = backlog_2000x200["port"]
    timer = PhaseTimer()
    got = solve_backlog_pipelined(pods, nodes, services=services, chunk=512, mode="wave",
                                  device="cpu", timer=timer)
    assert got == backlog_2000x200["jax_pipelined"]
    assert sum(n is not None for n in got) == 2000
    assert timer.stats["waves"] >= 4 and set(timer.seconds) == {"lower", "upload", "solve", "readback"}


def test_schedule_backlog_wave_equals_jax(backlog_2000x200):
    pods, nodes, services = backlog_2000x200["port"]
    jpods, jnodes, jservices = backlog_2000x200["jax"]
    got = schedule_backlog_wave(pods, nodes, services=services, device="cpu")
    assert got == jschedule_wave(jpods, jnodes, services=jservices)


@pytest.mark.parametrize("seed", range(8))
def test_placements_valid_by_both_oracles(seed):
    """The port's placements pass the JAX package's validity replay, and
    the port's copy of the oracle agrees with it: the same verdict and
    the same quality numbers."""
    pending, nodes, assigned, services = random_cluster(seed)
    snap = build_snapshot(pending, nodes, assigned, services)
    jsnap = jbuild_snapshot(pending, nodes, assigned, services)
    d = device_snapshot(snap, "cpu")
    got, _ = wave.wave_assignments(d, window=32)
    joracle.validate_assignment_numpy(jsnap, got)
    oracle.validate_assignment_numpy(snap, got)
    assert oracle.assignment_quality(snap, got) == joracle.assignment_quality(jsnap, got)
    assert np.array_equal(oracle.solve_sequential_numpy(snap), joracle.solve_sequential_numpy(jsnap))
    # A placement past a node's capacity fails both replays.
    full = np.zeros(len(pending), np.int32)
    for check, s in ((joracle.validate_assignment_numpy, jsnap), (oracle.validate_assignment_numpy, snap)):
        if len(pending) > 20:
            with pytest.raises(AssertionError):
                check(s, full)


def test_wave_quality_bounds(backlog_2000x200):
    """tests/test_quality_regression.py::TestWaveQuality on the port's
    wave: every pod placed, at most 1.5 mean and 5 p99 regret against
    the greedy replay, at least 30% greedy matches."""
    pods, nodes, services = backlog_2000x200["port"]
    snap = build_snapshot(pods, nodes, services=services)
    a, _ = wave.wave_assignments(device_snapshot(snap, "cpu"))
    q = oracle.assignment_quality(snap, a)
    assert q["placed"] == 2000, "wave left pods unplaced"
    assert q["feasible_in_order"] >= 0.99
    assert q["mean_regret"] <= 1.5, q
    assert q["p99_regret"] <= 5, q
    assert q["greedy_match"] >= 0.30, q
