"""The port's defrag plan equals the JAX package's, bit for bit.

`plan_moves(device="cpu")` (the plain per-row loop K2 is held to on the
card) against the JAX function (the XLA scan on the CPU), the JAX
package's NumPy twin and the port's twin, on every output with its
shape and dtype (`np.array_equal`, no tolerance). `build_plan` and
`fragment_score` equal the JAX package's on its own fixtures, except
that errors propagate where JAX returns None. `launch_plan`, K2's
launch plan (cluster, K, windows, residency), is checked here against
its rules; the emulation tests hold it to the kernel's layout."""

import numpy as np
import pytest
import torch

from kubernetes_tpu.models import serde
from kubernetes_tpu.models.objects import Pod as JPod
from kubernetes_tpu.ops.oracle import plan_moves_numpy as jtwin
from kubernetes_tpu.ops.rebalance import plan_moves as jplan_moves
from kubernetes_tpu.utils import rebalance as jrebmod
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.models.objects import POD_GROUP_LABEL, REBALANCE_DEST_ANNOTATION
from kubernetes_tpu_torch.ops import rebalance
from kubernetes_tpu_torch.ops.oracle import plan_moves_numpy
from kubernetes_tpu_torch.ops.rebalance import plan_moves, plan_moves_plain
from kubernetes_tpu_torch.utils import rebalance as rebmod
from tests.test_rebalance import _cols, _pod_wire
from tests.test_torch_capacity import assert_outputs_equal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _all_four(args):
    want = jplan_moves(*args)
    assert_outputs_equal(plan_moves(*args, device="cpu"), want, "port")
    assert_outputs_equal(plan_moves_numpy(*args), want, "port twin")
    assert_outputs_equal(jtwin(*args), want, "jax twin")
    return want


def test_constants_equal_the_jax_packages():
    from kubernetes_tpu.ops import rebalance as jreb

    assert rebalance.NO_FIT_KEY == jreb.NO_FIT_KEY
    assert (rebmod.POD_BUCKET_MIN, rebmod.DEFAULT_MOVE_BUDGET) == (
        jrebmod.POD_BUCKET_MIN, jrebmod.DEFAULT_MOVE_BUDGET)


@pytest.mark.parametrize("seed", range(16))
def test_random_worklists_bit_exact(seed):
    _all_four(workload.random_rebalance_args(seed))


def test_consolidation_moves_and_scores():
    dest, moved, gain, n_moves, before, after = _all_four(workload.consolidation_args())
    assert int(n_moves) >= 1 and float(after) < float(before)
    assert all(int(g) > 0 for g, m in zip(gain, moved) if m)


def test_budget_zero_and_no_rows():
    args = list(workload.random_rebalance_args(3))
    args[-1] = np.int32(0)
    out = _all_four(tuple(args))
    assert int(out[3]) == 0 and float(out[4]) == float(out[5])
    for k in range(8, 13):
        args[k] = args[k][:0]
    args[-1] = np.int32(5)
    _all_four(tuple(args))


def test_tensor_inputs_and_a_tensor_budget():
    args = workload.random_rebalance_args(5)
    tensors = tuple(torch.from_numpy(np.asarray(a)) for a in args)
    assert_outputs_equal(plan_moves(*tensors, device="cpu"), jplan_moves(*args))


def test_plain_version_is_what_the_cpu_runs(monkeypatch):
    def no_launch(*a, **k):
        raise AssertionError("the CUDA launch path was taken for CPU tensors")

    monkeypatch.setattr(rebalance, "_launch", no_launch)
    before = plan_moves.launches
    plan_moves(*workload.consolidation_args(), device="cpu")
    assert plan_moves.launches == before


# -- launch_plan -------------------------------------------------------------


@pytest.mark.parametrize("rule", ["main_path", "cluster_by_work", "residency", "windows",
                                  "any_shape", "forced", "refused"])
def test_launch_plan_rules(rule):
    """K2's plan: the cluster from the work, K, the first and largest
    windows, the residency cutover, and the shared memory and scratch
    formulas (the emulation tests hold those to the kernel's own)."""
    R = rebalance
    if rule == "main_path":
        plan = R.launch_plan(5000, 50000, 6)
        assert (plan.cluster, plan.threads, plan.k, plan.first_rows, plan.resident) == (
            16, 1024, R.DEFAULT_K, R.FIRST_ROWS, True)
        # The largest window: one row a warp of the cluster.
        assert plan.max_rows == 16 * 32
        assert plan.smem_bytes == R.smem_bytes(5000, plan.max_rows, True) <= R.SMEM_LIMIT
        assert plan.scratch_bytes == R.scratch_bytes(5000, plan.k, plan.max_rows, 16 * 32, True)
    elif rule == "cluster_by_work":
        # One CTA for each 2^21 node-row evaluations, a power of two up to 16.
        assert R.launch_plan(300, 79, 12).cluster == 1
        assert R.launch_plan(5000, 256, 6).cluster == 1
        assert R.launch_plan(5000, 1000, 6).cluster == 4
        assert R.launch_plan(5000, 3000, 6).cluster == 8
        assert R.launch_plan(5000, 50000, 6).cluster == 16
        assert R.launch_plan(1, 0, 1).cluster == 1
    elif rule == "residency":
        cap = R.max_nodes()
        assert R.launch_plan(cap, 50000, 6).resident
        assert R.smem_bytes(cap + 1, R.MIN_ROWS, True) > R.SMEM_LIMIT
        lp = R.launch_plan(cap + 1, 50000, 6)
        assert not lp.resident and lp.smem_bytes == R.FIXED_BYTES + R.RECORD_BYTES * lp.max_rows
        # A short worklist keeps the carry resident past the cutover.
        assert R.launch_plan(cap + 1, 10, 6).resident
    elif rule == "windows":
        assert (R.launch_plan(100, 10, 3).first_rows, R.launch_plan(100, 10, 3).max_rows) == (10, 10)
        assert (R.launch_plan(100, 100, 3).first_rows, R.launch_plan(100, 100, 3).max_rows) == (32, 32)
        assert R.launch_plan(100, 9000, 3, cluster=4, threads=256).max_rows == 32
        assert R.launch_plan(100, 10, 3, first_rows=64).first_rows == 10
        assert (R.launch_plan(100, 0, 3).first_rows, R.launch_plan(100, 0, 3).max_rows) == (1, 1)
        lp = R.launch_plan(100, 9000, 3, first_rows=2, max_rows=64)
        assert (lp.first_rows, lp.max_rows) == (2, 64)
        assert lp.smem_bytes == R.smem_bytes(100, 64, True)
    elif rule == "any_shape":
        # Any node and probe count plans: past shared memory the carry
        # stays in device memory, and the probes never take shared memory.
        assert R.launch_plan(10, 6, 40000) == R.launch_plan(10, 6, 1)
        assert R.launch_plan(50000, 50000, 6).smem_bytes <= R.SMEM_LIMIT
        assert R.launch_plan(2_000_000, 50000, 6).smem_bytes <= R.SMEM_LIMIT
    elif rule == "forced":
        lp = R.launch_plan(300, 79, 12, cluster=4, threads=64, k=1, first_rows=2, resident=False)
        assert (lp.cluster, lp.threads, lp.k, lp.first_rows, lp.resident) == (4, 64, 1, 2, False)
        assert lp.scratch_bytes == R.scratch_bytes(300, 1, lp.max_rows, 8, False)
    else:
        cap = R.max_nodes()
        with pytest.raises(ValueError, match="shared memory"):
            R.launch_plan(R.max_nodes(1) + 1, 50000, 6, resident=True)
        with pytest.raises(ValueError, match="threads"):
            R.launch_plan(100, 10, 6, threads=48)
        with pytest.raises(ValueError, match="cluster"):
            R.launch_plan(100, 10, 6, cluster=17)
        with pytest.raises(ValueError, match="K = 33"):
            R.launch_plan(100, 10, 6, k=33)
        with pytest.raises(ValueError, match="first window"):
            R.launch_plan(100, 10, 6, first_rows=0)
        with pytest.raises(ValueError, match="N >= 1"):
            R.launch_plan(0, 10, 6)
        assert cap < R.max_nodes(1)


# -- build_plan and fragment_score against the JAX package's fixtures -----

PROBES = [("probe-500m", 500.0, 256.0, 1)]


def _pods(spread, cpu="200m", labels=None):
    out = []
    k = 0
    for node, count in spread.items():
        for _ in range(count):
            p = serde.from_wire(JPod, _pod_wire(f"p{k}", cpu=cpu, labels=labels))
            p.spec.node_name = node
            p.status.phase = "Running"
            out.append(p)
            k += 1
    return out


def _both(cols, names, pods, probes=PROBES, **kw):
    got = rebmod.build_plan(cols, names, pods, probes, device="cpu", **kw)
    want = jrebmod.build_plan(cols, names, pods, probes, **kw)
    assert got == want
    return got


def test_consolidation_plan():
    names = [f"n{j}" for j in range(6)]
    plan = _both(_cols(6, cpu_fit=600.0, pods_used=3.0), names, _pods({n: 3 for n in names}))
    assert plan["moves"] and plan["score_after"] < plan["score_before"]


@pytest.mark.parametrize("budget", [0, 1, 2, 5])
def test_move_budget_clamps(budget):
    names = [f"n{j}" for j in range(6)]
    plan = _both(_cols(6, cpu_fit=600.0, pods_used=3.0), names, _pods({n: 3 for n in names}),
                 move_budget=budget)
    assert plan is None if budget == 0 else len(plan["moves"]) <= budget


def test_gang_atomicity():
    names = [f"n{j}" for j in range(4)]
    pods = _pods({n: 3 for n in names}, labels={POD_GROUP_LABEL: "slice-a"})
    pods += _pods({"n0": 1, "n2": 2}, cpu="300m", labels={POD_GROUP_LABEL: "slice-b"})
    for i, p in enumerate(pods[12:]):
        p.metadata.name = f"q{i}"
    _both(_cols(4, cpu_fit=600.0, pods_used=3.0), names, pods)


def test_movable_filter():
    from kubernetes_tpu_torch.models.objects import ObjectMeta, Pod, PodSpec, PodStatus

    bound = Pod(metadata=ObjectMeta(name="b"), spec=PodSpec(node_name="a"),
                status=PodStatus(phase="Running"))
    pending = Pod(metadata=ObjectMeta(name="pend"))
    done = Pod(metadata=ObjectMeta(name="d"), spec=PodSpec(node_name="a"),
               status=PodStatus(phase="Succeeded"))
    term = Pod(metadata=ObjectMeta(name="t", deletion_timestamp="2026-01-01T00:00:00Z"),
               spec=PodSpec(node_name="a"))
    mid = Pod(metadata=ObjectMeta(name="m", annotations={REBALANCE_DEST_ANNOTATION: "b"}),
              spec=PodSpec(node_name="a"))
    pods = [bound, pending, done, term, mid]
    assert rebmod.movable_pods(pods) == jrebmod.movable_pods(pods) == [bound]


@pytest.mark.parametrize("budget", [1, 10])
def test_forced_drain(budget):
    """A cordoned node's pods move whatever their gain (within the
    plan's budget, which forced rows do not lift)."""
    names = [f"n{j}" for j in range(5)]
    cols = _cols(5, cpu_fit=400.0, pods_used=2.0)
    pods = _pods({n: 2 for n in names})
    plan = _both(cols, names, pods, move_budget=budget, forced_nodes=["n4"])
    forced = [m for m in plan["moves"] if m["forced"]]
    assert {m["from"] for m in forced} == {"n4"}
    assert len(forced) == min(budget, 2) and any(m["gain"] <= 0 for m in forced)


def test_session_slots_and_unknown_nodes():
    """Free slots (None names) and pods on nodes the columns do not know."""
    names = ["n0", None, "n2", "n3"]
    cols = _cols(4, cpu_fit=600.0, pods_used=3.0)
    cols["sched"][1] = False
    pods = _pods({"n0": 3, "n2": 3, "n3": 3, "gone": 2})
    _both(cols, names, pods)


def test_empty_paths_and_errors_propagate():
    assert rebmod.build_plan(_cols(2), ["a", "b"], [], PROBES, device="cpu") is None
    pods = _pods({"a": 1})
    assert rebmod.build_plan(_cols(2), ["a", "b"], pods, PROBES, move_budget=0, device="cpu") is None
    # The JAX package returns None on a broken input; the port raises.
    assert jrebmod.build_plan({}, [], pods, PROBES) is None
    with pytest.raises(KeyError):
        rebmod.build_plan({}, [], pods, PROBES, device="cpu")
    with pytest.raises(KeyError):
        rebmod.fragment_score({}, PROBES, device="cpu")


@pytest.mark.parametrize("seed", range(4))
def test_fragment_score_equals_jax(seed):
    args = workload.random_capacity_args(seed)
    cols = dict(zip(("cpu_cap", "mem_cap", "pods_cap", "cpu_fit", "mem_fit", "pods_used", "over",
                     "sched"), args[:8]))
    probes = [(f"q{i}", float(c), float(m), int(k)) for i, (c, m, k) in
              enumerate(zip(args[8], args[9], args[10]))]
    assert rebmod.fragment_score(cols, probes, device="cpu") == jrebmod.fragment_score(cols, probes)


def test_plain_version_direct():
    """The plain version on staged tensors equals the JAX function."""
    from kubernetes_tpu_torch.ops.capacity import stage

    args = workload.random_rebalance_args(7)
    tensors = stage(args[:-1], rebalance._DTYPES, torch.device("cpu"))
    assert_outputs_equal(plan_moves_plain(*tensors, args[-1]), jplan_moves(*args))


# -- RebalanceMonitor against the JAX monitor ---------------------------------


def test_monitor_constants_equal_the_jax_packages():
    assert (rebmod.EFFICIENCY_SATURATION, rebmod.TREND_LEN) == (
        jrebmod.EFFICIENCY_SATURATION, jrebmod.TREND_LEN)
    assert rebmod.RebalanceMonitor().snapshot() == jrebmod.RebalanceMonitor().snapshot()


def _monitor_series():
    outcomes = ("evicted", "rebound", "recovered", "failed", "stranded")
    return ([rebmod.MOVES.value(outcome=o) for o in outcomes]
            + [rebmod.STRANDED.value(), rebmod.IMPROVEMENT.count(),
               rebmod.MOVES_PER_IMPROVEMENT.count()],
            [jrebmod.MOVES.value(outcome=o) for o in outcomes]
            + [jrebmod.STRANDED.value(), jrebmod.IMPROVEMENT.count(),
               jrebmod.MOVES_PER_IMPROVEMENT.count()])


@pytest.mark.parametrize("seed", range(3))
def test_monitor_sequences_equal_the_jax_monitors(seed):
    """A random sequence of plans, moves and cycles (improving, flat,
    with and without moves): snapshots, cycle summaries and the series
    equal the JAX monitor's; `planned` enters the table only."""
    rng = np.random.default_rng(seed)
    names = [f"n{j}" for j in range(6)]
    plan = _both(_cols(6, cpu_fit=600.0, pods_used=3.0), names, _pods({n: 3 for n in names}))
    port, jax = rebmod.RebalanceMonitor(), jrebmod.RebalanceMonitor()
    t0, j0 = _monitor_series()
    planned = rebmod.MOVES.value(outcome="planned")
    for step in range(30):
        kind = int(rng.integers(3))
        if kind == 0:
            outcome = str(rng.choice(["planned", "evicted", "rebound", "recovered", "failed",
                                      "stranded"]))
            count = int(rng.integers(0, 4))
            port.record_move(outcome, count)
            jax.record_move(outcome, count)
        elif kind == 1:
            port.record_plan(plan)
            jax.record_plan(plan)
        else:
            before = float(rng.random())
            after = before - float(rng.random()) * 0.3 if rng.random() < 0.7 else before + 0.1
            moves = int(rng.integers(0, 5))
            trigger = str(rng.choice(["periodic", "forced", "drain"]))
            assert port.record_cycle(before, after, moves, trigger) == jax.record_cycle(
                before, after, moves, trigger)
        assert port.snapshot() == jax.snapshot()
    t1, j1 = _monitor_series()
    assert [a - b for a, b in zip(t1, t0)] == [a - b for a, b in zip(j1, j0)]
    assert rebmod.MOVES.value(outcome="planned") == planned
