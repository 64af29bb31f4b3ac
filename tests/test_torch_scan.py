"""The port's sequential scan equals the JAX package's, bit for bit.

The same lowered state goes to the JAX package (the XLA scan, the Pallas
kernel in interpret mode, the NumPy oracle) and, through
`state_from_numpy`, to the port's scan on the CPU, which is the plain
version of the CUDA kernel. Decisions and all nine carry fields must be
exactly equal, dtypes included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.models.algspec import DEFAULT_LOWERED as JDEFAULT_LOWERED
from kubernetes_tpu.models.columnar import build_snapshot as jbuild_snapshot
from kubernetes_tpu.ops import device_snapshot as jdevice_snapshot
from kubernetes_tpu.ops.oracle import solve_sequential_numpy
from kubernetes_tpu.ops.pallas_scan import solve_with_state_pallas
from kubernetes_tpu.ops.solver import _solve_with_state_xla
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.models.algspec import DEFAULT_LOWERED, LoweredSpec
from kubernetes_tpu_torch.models.columnar import build_snapshot
from kubernetes_tpu_torch.ops import scan_kernel
from kubernetes_tpu_torch.ops.matrices import (
    CARRY_KEYS,
    device_snapshot,
    state_from_numpy,
    state_to_numpy,
)
from kubernetes_tpu_torch.ops.solver import (
    solve,
    solve_assignments,
    solve_with_state,
)
from tests.test_solver_parity import mk_node, mk_pod, random_cluster


def _jax_state(pending, nodes, assigned=(), services=()):
    snap = jbuild_snapshot(pending, nodes, assigned_pods=assigned, services=services)
    d = jdevice_snapshot(snap)
    pods = {k: np.asarray(v) for k, v in d.pods.items()}
    state = {k: np.asarray(v) for k, v in d.nodes.items()}
    return snap, pods, state


def _xla(pods, nodes, weights=(1, 1, 1)):
    choice, final = _solve_with_state_xla(
        {k: jnp.asarray(v) for k, v in pods.items()},
        {k: jnp.asarray(v) for k, v in nodes.items()},
        tuple(weights),
        JDEFAULT_LOWERED,
    )
    return np.asarray(choice), {k: np.asarray(v) for k, v in final.items()}


def _port(pods, nodes, weights=(1, 1, 1)):
    tp, tn = state_from_numpy(pods, nodes, device="cpu")
    choice, final = solve_with_state(tp, tn, tuple(weights))
    return choice.numpy(), state_to_numpy(final)


def _assert_same(got, ref, what):
    (gc, gs), (rc, rs) = got, ref
    assert gc.dtype == rc.dtype and np.array_equal(gc, rc), (
        f"{what}: {int((gc != rc).sum())}/{len(rc)} decisions differ"
    )
    for k in CARRY_KEYS:
        assert gs[k].dtype == rs[k].dtype, f"{what}: {k} dtype {gs[k].dtype} != {rs[k].dtype}"
        assert gs[k].shape == rs[k].shape, f"{what}: {k} shape"
        assert np.array_equal(gs[k], rs[k]), f"{what}: carry field {k} differs"


@pytest.mark.parametrize("seed", range(16))
def test_random_cluster_matches_xla_pallas_and_oracle(seed):
    pending, nodes, assigned, services = random_cluster(seed)
    snap, pods, state = _jax_state(pending, nodes, assigned, services)
    got = _port(pods, state)
    _assert_same(got, _xla(pods, state), f"seed {seed} vs XLA scan")
    pc, ps = solve_with_state_pallas(
        {k: jnp.asarray(v) for k, v in pods.items()},
        {k: jnp.asarray(v) for k, v in state.items()},
        (1, 1, 1),
        interpret=True,
    )
    _assert_same(
        got,
        (np.asarray(pc), {k: np.asarray(v) for k, v in ps.items()}),
        f"seed {seed} vs Pallas (interpret)",
    )
    oracle = solve_sequential_numpy(snap)
    assert np.array_equal(got[0][: snap.pods.count], oracle), f"seed {seed} vs oracle"


@pytest.mark.parametrize("seed", range(6))
def test_small_cluster_matches_xla(seed):
    """Volumes (GCE read-only and read-write, EBS), pinned pods, pods in
    several services, zero-request pods, cordoned and not-ready nodes."""
    pending, nodes, assigned, services = workload.small_cluster(seed)
    _, pods, state = _jax_state(pending, nodes, assigned, services)
    _assert_same(_port(pods, state), _xla(pods, state), f"small cluster {seed}")


def _repeat_service_ids(svc_ids):
    """Repeat each pod's first service id in its second slot: a repeated
    id commits once per occurrence."""
    out = svc_ids.copy()
    out[:, 1] = np.where(out[:, 0] >= 0, out[:, 0], out[:, 1])
    return out


@pytest.mark.parametrize("seed", range(3))
def test_repeated_service_ids_match_xla(seed):
    pending, nodes, assigned, services = workload.small_cluster(seed)
    _, pods, state = _jax_state(pending, nodes, assigned, services)
    pods["svc_ids"] = _repeat_service_ids(pods["svc_ids"])
    _assert_same(_port(pods, state), _xla(pods, state), f"repeated ids {seed}")


@pytest.mark.parametrize("weights", [(2, 0, 3), (0, 5, 1), (1, 1, 0), (7, 3, 11)])
def test_non_default_weights_match_xla(weights):
    pending, nodes, assigned, services = workload.small_cluster(3)
    _, pods, state = _jax_state(pending, nodes, assigned, services)
    _assert_same(
        _port(pods, state, weights), _xla(pods, state, weights), f"weights {weights}"
    )


def test_multiword_bitsets_match_xla():
    """70 distinct host ports need 3 u32 words (bucketed to 4): the
    per-word loops must agree across the word boundary."""
    nodes = [mk_node(f"n{j}", pods=200) for j in range(4)]
    pods = [mk_pod(f"p{i}", cpu=10, mem_mib=8, host_port=7000 + i) for i in range(70)]
    pods += [mk_pod(f"q{i}", cpu=10, mem_mib=8, host_port=7000 + i) for i in range(8)]
    _, jpods, state = _jax_state(pods, nodes)
    assert jpods["port"].shape[1] == 4
    _assert_same(_port(jpods, state), _xla(jpods, state), "multi-word bitsets")


@pytest.mark.parametrize("n_services", [1, 3, 5, 12])
def test_unpadded_odd_service_axis_matches_xla(n_services):
    """A carry whose service axis is NOT padded to 128 (an incremental
    session carries S unpadded) solves the same in both packages."""
    from kubernetes_tpu.models.objects import ObjectMeta, Service, ServiceSpec

    services = [
        Service(
            metadata=ObjectMeta(name=f"s{i}", namespace="default"),
            spec=ServiceSpec(selector={"app": f"a{i}"}),
        )
        for i in range(n_services)
    ]
    nodes = [mk_node(f"n{j}") for j in range(5)]
    pending = [
        mk_pod(f"p{i}", cpu=100, mem_mib=64, labels={"app": f"a{i % n_services}"})
        for i in range(20)
    ]
    _, pods, state = _jax_state(pending, nodes, services=services)
    state["svc_counts"] = np.ascontiguousarray(state["svc_counts"][:, :n_services])
    got = _port(pods, state)
    assert got[1]["svc_counts"].shape == (state["cpu_cap"].shape[0], n_services)
    _assert_same(got, _xla(pods, state), f"S={n_services}")


def test_chunked_equals_monolithic():
    """Two solves chained through the carry == one solve (the contract
    solve_backlog_pipelined relies on)."""
    pending, nodes, assigned, services = workload.small_cluster(5)
    d = device_snapshot(
        build_snapshot(pending, nodes, assigned_pods=assigned, services=services),
        device="cpu",
    )
    whole = solve(d.pods, d.nodes)
    P = d.n_pods
    cut = P // 2

    def part(lo, hi):
        return {k: v[lo:hi].contiguous() for k, v in d.pods.items()}

    state = {k: v.clone() for k, v in d.nodes.items()}
    a1, state = solve_with_state(part(0, cut), state)
    a2, state = solve_with_state(part(cut, P), state)
    assert torch.equal(whole[:P], torch.cat([a1, a2]))


def test_solve_leaves_carry_and_solve_with_state_updates_it():
    pending, nodes, assigned, services = workload.small_cluster(2)
    d = device_snapshot(
        build_snapshot(pending, nodes, assigned_pods=assigned, services=services),
        device="cpu",
    )
    before = {k: v.clone() for k, v in d.nodes.items()}
    choice = solve(d.pods, d.nodes)
    assert all(torch.equal(before[k], d.nodes[k]) for k in before)
    out = solve_assignments(d)
    assert out.shape == (d.n_pods,) and np.array_equal(out, choice[: d.n_pods].numpy())
    state = {k: v.clone() for k, v in d.nodes.items()}
    _, returned = solve_with_state(d.pods, state)
    assert returned is state
    assert torch.equal(state["pods_used"].sum(), before["pods_used"].sum() + (choice >= 0).sum())


def test_policy_spec_raises_not_implemented():
    pending, nodes, assigned, services = workload.small_cluster(0)
    d = device_snapshot(build_snapshot(pending, nodes, assigned, services), device="cpu")
    with pytest.raises(NotImplementedError, match="policy specs"):
        solve_with_state(d.pods, d.nodes, (1, 1, 1), LoweredSpec(static_prio=True))
    assert DEFAULT_LOWERED == LoweredSpec()


def test_plain_version_is_the_wrapper_on_cpu():
    pending, nodes, assigned, services = workload.small_cluster(1)
    d = device_snapshot(build_snapshot(pending, nodes, assigned, services), device="cpu")
    a = {k: v.clone() for k, v in d.nodes.items()}
    b = {k: v.clone() for k, v in d.nodes.items()}
    got, a = scan_kernel.scan_with_state(d.pods, a)
    ref, b = scan_kernel.plain_scan_with_state(d.pods, b, (1, 1, 1))
    assert torch.equal(got, ref)
    assert all(torch.equal(a[k], b[k]) for k in CARRY_KEYS)


def test_jax_runs_on_cpu_here():
    assert jax.devices()[0].platform == "cpu"
