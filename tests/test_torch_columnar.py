"""The port's host lowering and staging equal the JAX package's.

`kubernetes_tpu_torch.models.columnar` is a copy of the JAX package's
lowering without its ctypes helper; `ops.matrices` stages the result as
tensors. Both must produce the JAX package's arrays exactly: the same
values, dtypes, vocabularies and padding."""

import dataclasses

import numpy as np
import pytest

from __graft_entry__ import _synthetic_objects
from kubernetes_tpu.models import algspec as jalgspec
from kubernetes_tpu.models.columnar import SnapshotBuilder as JSnapshotBuilder
from kubernetes_tpu.models.columnar import build_snapshot as jbuild_snapshot
from kubernetes_tpu.ops import device_snapshot as jdevice_snapshot
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.models import algspec
from kubernetes_tpu_torch.models.columnar import SnapshotBuilder, build_snapshot, pack_bitsets
from kubernetes_tpu_torch.ops.matrices import (
    _pod_axis_bucket,
    device_snapshot,
    pow2_bucket,
    state_from_numpy,
    state_to_numpy,
)
from tests.test_solver_parity import random_cluster


def _assert_columns_equal(got, ref, what):
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f"{what}.{f.name}: {a.dtype} != {b.dtype}"
            assert a.shape == b.shape, f"{what}.{f.name}: {a.shape} != {b.shape}"
            assert np.array_equal(a, b), f"{what}.{f.name} differs"
        else:
            assert a == b, f"{what}.{f.name}: {a!r} != {b!r}"


def _assert_snapshots_equal(got, ref):
    _assert_columns_equal(got.pods, ref.pods, "pods")
    _assert_columns_equal(got.nodes, ref.nodes, "nodes")
    for vocab in ("label_vocab", "port_vocab", "vol_vocab"):
        assert getattr(got, vocab).index == getattr(ref, vocab).index, vocab
    assert got.service_names == ref.service_names
    assert got.weights == ref.weights
    assert (got.lowered is None) == (ref.lowered is None)
    if ref.lowered is not None:
        assert tuple(got.lowered) == tuple(ref.lowered)
    for seed in ("anchor_init", "svc_total_init"):
        a, b = getattr(got, seed), getattr(ref, seed)
        assert (a is None) == (b is None), seed
        if b is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), seed


@pytest.mark.parametrize("n_pods,n_nodes,seed", [(300, 20, 0), (650, 37, 5), (1, 1, 9)])
def test_synthetic_workload_lowers_identically(n_pods, n_nodes, seed):
    """The port's generator draws the JAX generator's objects, and the
    port's lowering of them is the JAX lowering, array by array."""
    pods, nodes, services = workload.synthetic_objects(n_pods, n_nodes, seed)
    jpods, jnodes, jservices = _synthetic_objects(n_pods, n_nodes, seed)
    got = build_snapshot(pods, nodes, services=services)
    ref = jbuild_snapshot(jpods, jnodes, services=jservices)
    _assert_snapshots_equal(got, ref)


@pytest.mark.parametrize("seed", range(8))
def test_random_cluster_objects_lower_identically(seed):
    """The port lowers the JAX package's own objects (read by attribute)."""
    pods, nodes, assigned, services = random_cluster(seed)
    got = build_snapshot(pods, nodes, assigned_pods=assigned, services=services)
    ref = jbuild_snapshot(pods, nodes, assigned_pods=assigned, services=services)
    _assert_snapshots_equal(got, ref)


@pytest.mark.parametrize("seed", range(6))
def test_small_cluster_lowers_identically(seed):
    """Volumes, pinned pods, multi-service pods and cordoned nodes: the
    JAX lowering of the port's fuzz objects equals the port's."""
    pending, nodes, assigned, services = workload.small_cluster(seed)
    got = build_snapshot(pending, nodes, assigned_pods=assigned, services=services)
    ref = jbuild_snapshot(pending, nodes, assigned_pods=assigned, services=services)
    _assert_snapshots_equal(got, ref)


def _policy_spec(mod):
    return mod.AlgorithmSpec(
        predicates=tuple(mod.PredicateSpec(k) for k in mod.BASE_PREDICATES)
        + (
            mod.PredicateSpec("NodeLabelPresence", labels=("zone",), presence=True),
            mod.PredicateSpec("ServiceAffinity", labels=("zone",)),
        ),
        priorities=(
            mod.PrioritySpec("LeastRequestedPriority", 2),
            mod.PrioritySpec("LabelPreference", 3, label="zone", presence=True),
            mod.PrioritySpec("ServiceAntiAffinity", 1, label="zone"),
        ),
    )


@pytest.mark.parametrize("seed", range(3))
def test_policy_columns_lower_identically(seed):
    """The copied policy lowering (lower_spec, the policy node columns and
    the service-affinity seeds) equals the JAX package's."""
    pods, nodes, assigned, services = random_cluster(seed)
    got = SnapshotBuilder(
        pods, nodes, assigned, services, spec=_policy_spec(algspec)
    ).snapshot()
    ref = JSnapshotBuilder(
        pods, nodes, assigned, services, spec=_policy_spec(jalgspec)
    ).snapshot()
    _assert_snapshots_equal(got, ref)


def test_lower_spec_matches():
    assert tuple(algspec.DEFAULT_LOWERED) == tuple(jalgspec.DEFAULT_LOWERED)
    got = algspec.lower_spec(_policy_spec(algspec))
    ref = jalgspec.lower_spec(_policy_spec(jalgspec))
    assert tuple(got[0]) == tuple(ref[0]) and got[1] == ref[1]
    bad = algspec.AlgorithmSpec((algspec.PredicateSpec("Custom"),), ())
    with pytest.raises(algspec.UnloweredPolicyError):
        algspec.lower_spec(bad)


@pytest.mark.parametrize("seed", range(4))
def test_staging_matches_jax(seed):
    """device_snapshot on the CPU holds the JAX DeviceSnapshot's arrays:
    the same keys, padding, fills and (at the boundary) dtypes."""
    pending, nodes, assigned, services = workload.small_cluster(seed)
    snap = build_snapshot(pending, nodes, assigned_pods=assigned, services=services)
    jsnap = jbuild_snapshot(pending, nodes, assigned_pods=assigned, services=services)
    d = device_snapshot(snap, device="cpu")
    jd = jdevice_snapshot(jsnap)
    assert (d.n_pods, d.n_nodes) == (jd.n_pods, jd.n_nodes)
    for got, ref in ((d.pods, jd.pods), (d.nodes, jd.nodes)):
        got = state_to_numpy(got)
        assert set(got) == set(ref)
        for k, v in ref.items():
            v = np.asarray(v)
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_state_round_trip_views_bitsets_as_int32():
    pods, nodes, assigned, services = random_cluster(1)
    jd = jdevice_snapshot(
        jbuild_snapshot(pods, nodes, assigned_pods=assigned, services=services)
    )
    jp = {k: np.asarray(v) for k, v in jd.pods.items()}
    jn = {k: np.asarray(v) for k, v in jd.nodes.items()}
    tp, tn = state_from_numpy(jp, jn, device="cpu")
    import torch

    assert tn["uport"].dtype == torch.int32 and tp["sel"].dtype == torch.int32
    assert tn["svc_counts"].dtype == torch.float32
    for got, ref in ((state_to_numpy(tp), jp), (state_to_numpy(tn), jn)):
        for k, v in ref.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_buckets_match_jax():
    from kubernetes_tpu.ops.matrices import _pod_axis_bucket as jbucket
    from kubernetes_tpu.ops.matrices import pow2_bucket as jpow2

    for n in (0, 1, 127, 128, 129, 5000, 8192, 8193, 12368, 12544, 50000):
        assert _pod_axis_bucket(n, 128) == jbucket(n, 128)
        assert pow2_bucket(n) == jpow2(n)


def test_pack_bitsets_matches_jax_helper():
    from kubernetes_tpu import native

    lists = [[], [0, 31, 32], [63], [5, 5], [], [40, 1]]
    assert np.array_equal(pack_bitsets(lists, 2), native.pack_bitsets(lists, 2))
    with pytest.raises(IndexError):
        pack_bitsets([[64]], 2)
