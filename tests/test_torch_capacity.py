"""The port's capacity report equals the JAX package's, bit for bit.

`capacity_report(device="cpu")` against the JAX function (XLA on the
CPU), the JAX package's NumPy twin and the port's twin, on every output
with its shape and dtype (`np.array_equal`, no tolerance: the sums are
int32 and the float work elementwise IEEE f32). The column builders
(`cluster_columns`, `session_columns`) and the probe set equal the JAX
package's."""

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops.capacity import capacity_report as jcapacity_report
from kubernetes_tpu.ops.oracle import capacity_report_numpy as jtwin
from kubernetes_tpu.ops import SolverSession as JSolverSession
from kubernetes_tpu.utils import capacity as jcapmod
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.ops import SolverSession
from kubernetes_tpu_torch.ops import capacity
from kubernetes_tpu_torch.ops.capacity import capacity_report
from kubernetes_tpu_torch.ops.oracle import capacity_report_numpy
from kubernetes_tpu_torch.scheduler.batch import schedule_backlog
from kubernetes_tpu_torch.utils import capacity as capmod
from tests.test_solver_parity import random_capacity_args as jrandom_capacity_args


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_outputs_equal(got, want, what=""):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _numpy(g), _numpy(w)
        assert g.shape == w.shape, f"{what} output {i}: {g.shape} != {w.shape}"
        assert g.dtype == w.dtype, f"{what} output {i}: {g.dtype} != {w.dtype}"
        assert np.array_equal(g, w), f"{what} output {i} differs"


def _all_four(args):
    want = jcapacity_report(*args)
    assert_outputs_equal(capacity_report(*args, device="cpu"), want, "port")
    assert_outputs_equal(capacity_report_numpy(*args), want, "port twin")
    assert_outputs_equal(jtwin(*args), want, "jax twin")
    return want


def test_constants_equal_the_jax_packages():
    from kubernetes_tpu.ops import capacity as jcap

    assert (capacity.FRAC_Q, capacity.FIT_CAP, capacity.BIG_FIT) == (
        jcap.FRAC_Q, jcap.FIT_CAP, jcap.BIG_FIT)
    assert capmod.DEFAULT_SLICE_SHAPES == jcapmod.DEFAULT_SLICE_SHAPES


@pytest.mark.parametrize("seed", range(4))
def test_the_generator_is_the_jax_tests(seed):
    for a, b in zip(workload.random_capacity_args(seed), jrandom_capacity_args(seed)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("seed", range(10))
def test_random_columns_bit_exact(seed):
    _all_four(workload.random_capacity_args(seed))


def test_tensor_inputs_and_gang_probes():
    """Tensors in, the gang bound: headroom below minMember reads not
    allocatable though single pods still fit."""
    ones = np.ones(2, np.float32)
    zeros = np.zeros(2, np.float32)
    args = (ones * 1000.0, ones * 1024.0, ones * 40.0, zeros, zeros, zeros,
            np.zeros(2, bool), np.ones(2, bool),
            np.asarray([600.0, 600.0], np.float32), np.asarray([64.0, 64.0], np.float32),
            np.asarray([2, 3], np.int32), np.ones(2, bool))
    want = _all_four(args)
    got = capacity_report(*(torch.from_numpy(a) for a in args), device="cpu")
    assert_outputs_equal(got, want)
    assert list(got[4]) == [2, 2] and list(got[6]) == [True, False]


def _placed_cluster(seed):
    pending, nodes, assigned, services = workload.small_cluster(seed)
    for p, d in zip(pending, schedule_backlog(pending, nodes, assigned, services, device="cpu")):
        if d is not None:
            p.spec.node_name = d
    return nodes, list(assigned) + list(pending)


def _probe_args(probes):
    return tuple(capmod.probe_arrays(probes))


@pytest.mark.parametrize("seed", range(6))
def test_cluster_columns_equal_jax_and_report_bit_exact(seed):
    nodes, pods = _placed_cluster(seed)
    if seed % 2:
        pods[0].metadata.deletion_timestamp = "2026-01-01T00:00:00Z"
        pods[-1].status.phase = "Succeeded"
    cols, names = capmod.cluster_columns(nodes, pods)
    jcols, jnames = jcapmod.cluster_columns(nodes, pods)
    assert names == jnames and set(cols) == set(jcols)
    for k in cols:
        assert cols[k].dtype == jcols[k].dtype and np.array_equal(cols[k], jcols[k]), k
    probes = workload.backlog_probes(pods)
    _all_four(tuple(cols[k] for k in capmod.COLUMN_KEYS) + _probe_args(probes))


def test_session_columns_equal_jax():
    pods, nodes, services = workload.synthetic_objects(200, 24, seed=3)
    assigned = pods[:120]
    for i, p in enumerate(assigned):
        p.spec.node_name = f"n{i % 24}"
    t = SolverSession(nodes, services=services, assigned=assigned, device="cpu")
    j = JSolverSession(nodes, services=services, assigned=assigned)
    for p in pods[120:]:
        t.add_pending(p)
        j.add_pending(p)
    assert t.solve() == j.solve()
    cols, names = capmod.session_columns(t)
    jcols, jnames = jcapmod.session_columns(j)
    assert names == jnames
    for k in jcols:
        assert cols[k].dtype == jcols[k].dtype and np.array_equal(cols[k], jcols[k]), k
    _all_four(tuple(cols[k] for k in capmod.COLUMN_KEYS) + _probe_args(workload.backlog_probes(pods)))


def test_probe_set_equals_the_monitors():
    shapes = [(100.0, 64.0), (250.0, 128.0), (1000.0, 512.0), (333.3, 77.7)]
    monitor = jcapmod.CapacityMonitor()
    assert capmod.probe_set() == monitor.probe_set()
    monitor.note_backlog_shapes(shapes)
    assert capmod.probe_set(capmod.DEFAULT_SLICE_SHAPES, shapes) == monitor.probe_set()
    cpu, mem, minm, live = capmod.probe_arrays([])
    assert cpu.shape == (1,) and not live.any()


# -- CapacityMonitor against the JAX monitor ----------------------------------


def _series():
    """The counted backlog series and the sample counts of both
    packages (compared by their deltas: another file in the process may
    have moved them)."""
    return ((capmod.ZERO_HEADROOM.value(), capmod.FRAG_SCORE.count(),
             capmod.SLICE_ALLOC.count()),
            (jcapmod.ZERO_HEADROOM.value(), jcapmod.FRAG_SCORE.count(),
             jcapmod.SLICE_ALLOC.count()))


def test_monitor_constants_equal_the_jax_packages():
    assert (capmod.UTIL_REFRESH_S, capmod.TREND_LEN, capmod.TOP_K_STRANDED,
            capmod.SHAPE_WINDOW) == (jcapmod.UTIL_REFRESH_S, jcapmod.TREND_LEN,
                                     jcapmod.TOP_K_STRANDED, jcapmod.SHAPE_WINDOW)
    assert capmod.CapacityMonitor().snapshot() == jcapmod.CapacityMonitor().snapshot()


@pytest.mark.parametrize("seed", range(4))
def test_monitor_samples_equal_the_jax_monitors(seed):
    """A sequence of samples over one cluster's columns as its pods are
    placed, with backlog shapes noted between them: every snapshot and
    the backlog series equal the JAX monitor's: the pressure gauge by
    its value after each sample, the counters by their deltas."""
    nodes, pods = _placed_cluster(seed)
    rng = np.random.default_rng(seed)
    port, jax = capmod.CapacityMonitor(), jcapmod.CapacityMonitor()
    if seed % 2:
        shapes = [("big", 3000.0, 4096.0, 2), ("tiny", 10.0, 8.0, 1)]
        port.configure(shapes)
        jax.configure(shapes)
    t0, j0 = _series()
    for step in range(6):
        placed = pods[: len(pods) * (step + 1) // 6]
        cols, names = capmod.cluster_columns(nodes, placed)
        if step % 2:
            shapes = [(float(rng.integers(50, 4000)), float(rng.integers(16, 4096)))
                      for _ in range(int(rng.integers(1, 40)))]
            port.note_backlog_shapes(shapes)
            jax.note_backlog_shapes(shapes)
        depth, age = int(rng.integers(0, 3)) * 10, float(rng.random() * 5)
        body = port.sample(cols, names, backlog_depth=depth, oldest_age_s=age, device="cpu")
        assert body == jax.sample(cols, names, backlog_depth=depth, oldest_age_s=age)
        assert port.snapshot() == jax.snapshot() and port.probe_set() == jax.probe_set()
        assert capmod.BACKLOG_PRESSURE.value() == jcapmod.BACKLOG_PRESSURE.value()
        t1, j1 = _series()
        assert [a - b for a, b in zip(t1, t0)] == [a - b for a, b in zip(j1, j0)]
        t0, j0 = t1, j1
    assert body["samples"] == 6 and len(body["trend"]) == 6


def test_monitor_on_session_columns_with_free_slots():
    """Session columns (free slots have no name) and a stranded table."""
    pods, nodes, services = workload.synthetic_objects(200, 24, seed=3)
    for i, p in enumerate(pods[:150]):
        p.spec.node_name = f"n{i % 24}"
    t = SolverSession(nodes, services=services, assigned=pods[:150], device="cpu")
    j = JSolverSession(nodes, services=services, assigned=pods[:150])
    cols, names = capmod.session_columns(t)
    jcols, jnames = jcapmod.session_columns(j)
    assert None in names
    # Shapes no node hosts: every live node with free capacity is stranded.
    shapes = [("huge", 64000.0, 1024.0, 3), ("wide", 100.0, 10.0**6, 1)]
    port, jax = capmod.CapacityMonitor(), jcapmod.CapacityMonitor()
    port.configure(shapes)
    jax.configure(shapes)
    body = port.sample(cols, names, backlog_depth=5, oldest_age_s=2.5, device="cpu")
    assert body == jax.sample(jcols, jnames, backlog_depth=5, oldest_age_s=2.5)
    assert len(body["stranded_nodes"]) == capmod.TOP_K_STRANDED and body["node_utilization"]


def test_monitor_reset_warm_and_errors():
    port = capmod.CapacityMonitor()
    port.note_backlog_shapes([(100.0, 64.0)])
    port.configure([("one", 100.0, 64.0, 1)])
    port.warm(64, device="cpu")  # one report; no sample kept
    assert port.snapshot()["sampled"] is False
    port.reset()
    assert port.probe_set() == jcapmod.CapacityMonitor().probe_set()
    # The JAX monitor returns None on a broken input; the port raises.
    assert jcapmod.CapacityMonitor().sample({}, []) is None
    with pytest.raises(KeyError):
        port.sample({}, [], device="cpu")


def test_monitor_observes_node_utilisation_at_most_once_a_refresh(monkeypatch):
    nodes, pods = _placed_cluster(1)
    cols, names = capmod.cluster_columns(nodes, pods)
    live = int((cols["sched"] & ~cols["over"]).sum())
    port = capmod.CapacityMonitor()
    before = capmod.NODE_UTIL.count(resource="cpu")
    clock = [100.0]
    monkeypatch.setattr(capmod.time, "monotonic", lambda: clock[0])
    for dt in (0.0, 0.5, 0.6, 0.1):
        clock[0] += dt
        port.sample(cols, names, device="cpu")
    # Observed at 100.0 and 101.1 only.
    assert capmod.NODE_UTIL.count(resource="cpu") - before == 2 * live
