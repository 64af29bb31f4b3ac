"""The port's explain readback equals the JAX package's, bit for bit.

`explain_rows` on the same staged state (JAX's DeviceSnapshot dicts,
moved over with `state_from_numpy`) must give JAX's `explain_rows` bits,
LeastRequested, BalancedResourceAllocation and ServiceSpreading, and the
NumPy twin `oracle.explain_bits_numpy`; `explain_matrix` and
`explain_backlog` on the same objects must give JAX's arrays and dicts,
tie order included. All on the CPU (`device="cpu"`)."""

import jax.numpy as jnp
import numpy as np
import pytest

from kubernetes_tpu.models.columnar import build_snapshot as jbuild_snapshot
from kubernetes_tpu.ops import device_snapshot as jdevice_snapshot
from kubernetes_tpu.ops import matrices as jmatrices
from kubernetes_tpu.ops import pipeline as jpipeline
from kubernetes_tpu.ops.oracle import explain_bits_numpy
from kubernetes_tpu.ops.solver import explain_rows as jexplain_rows
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.ops import matrices, pipeline
from kubernetes_tpu_torch.ops.matrices import state_from_numpy
from kubernetes_tpu_torch.ops.solver import explain_rows
from tests.test_solver_parity import mk_node, mk_pod, random_cluster


def _cluster(kind, seed):
    if kind == "random":
        return random_cluster(seed)
    return workload.small_cluster(seed)


def _jax_staged(pending, nodes, assigned, services):
    snap = jbuild_snapshot(pending, nodes, assigned_pods=assigned, services=services)
    d = jdevice_snapshot(snap)
    pods = {k: np.asarray(v) for k, v in d.pods.items()}
    state = {k: np.asarray(v) for k, v in d.nodes.items()}
    return snap, pods, state


@pytest.mark.parametrize("kind,seed", [("random", s) for s in range(6)] + [("small", s) for s in range(6)])
def test_explain_rows_matches_jax_and_oracle(kind, seed):
    pending, nodes, assigned, services = _cluster(kind, seed)
    snap, pods, state = _jax_staged(pending, nodes, assigned, services)
    jbits, jlr, jbra, jspread = (
        np.asarray(x)
        for x in jexplain_rows(
            {k: jnp.asarray(v) for k, v in pods.items()},
            {k: jnp.asarray(v) for k, v in state.items()},
        )
    )
    tp, tn = state_from_numpy(pods, state, device="cpu")
    bits, lr, bra, spread = (t.numpy() for t in explain_rows(tp, tn))
    assert bits.view(np.uint32).dtype == jbits.dtype
    assert np.array_equal(bits.view(np.uint32), jbits), f"{int((bits.view(np.uint32) != jbits).sum())} bits differ"
    for name, got, ref in (("lr", lr, jlr), ("bra", bra, jbra), ("spread", spread, jspread)):
        assert got.dtype == ref.dtype and np.array_equal(got, ref), f"{name} differs"
    P, N = snap.pods.count, snap.nodes.count
    obits, olr, obra, ospread = explain_bits_numpy(snap)
    assert np.array_equal(bits.view(np.uint32)[:P, :N], obits)
    assert np.array_equal(lr[:P, :N], olr) and np.array_equal(bra[:P, :N], obra)
    assert np.array_equal(spread[:P, :N], ospread)


@pytest.mark.parametrize("seed", range(4))
def test_explain_matrix_matches_jax(seed):
    pending, nodes, assigned, services = workload.small_cluster(seed)
    names, bits, comps = pipeline.explain_matrix(pending, nodes, assigned, services, device="cpu")
    jnames, jbits, jcomps = jpipeline.explain_matrix(pending, nodes, assigned, services)
    assert names == jnames
    assert bits.dtype == np.uint32 and np.array_equal(bits, np.asarray(jbits))
    assert sorted(comps) == sorted(jcomps)
    for k in comps:
        assert np.array_equal(comps[k], np.asarray(jcomps[k])), k


@pytest.mark.parametrize("seed", range(6))
def test_explain_backlog_dicts_match_jax(seed):
    pending, nodes, assigned, services = workload.small_cluster(seed)
    got = pipeline.explain_backlog(pending, nodes, assigned, services, device="cpu")
    ref = jpipeline.explain_backlog(pending, nodes, assigned, services)
    assert got == ref


def test_explain_backlog_ties_and_bounds_match_jax():
    """Equal scores on identical nodes (lowest index first), top_k and
    max_failed cut the lists at the same places, and a pod that fits
    nowhere lists its reasons."""
    nodes = [mk_node(f"n{j}", cpu=2000, mem_mib=2048, labels={"zone": "a" if j % 2 else "b"})
             for j in range(9)]
    pending = [mk_pod(f"p{i}", cpu=100, mem_mib=64) for i in range(3)]
    pending.append(mk_pod("big", cpu=5000, mem_mib=64))
    pending.append(mk_pod("sel", cpu=100, mem_mib=64, selector={"zone": "a"}))
    for top_k, max_failed in ((3, 16), (1, 2), (9, 0)):
        got = pipeline.explain_backlog(pending, nodes, device="cpu", top_k=top_k,
                                       max_failed=max_failed)
        ref = jpipeline.explain_backlog(pending, nodes, top_k=top_k, max_failed=max_failed)
        assert got == ref
    assert got[3]["feasibleNodes"] == 0 and got[3]["reasonCounts"] == {"PodFitsResources": 9}


def test_explain_backlog_empty():
    assert pipeline.explain_backlog([], [mk_node("n0")], device="cpu") == []


def test_predicate_names_and_decoding_match_jax():
    assert matrices.EXPLAIN_PREDICATES == jmatrices.EXPLAIN_PREDICATES
    for bits in range(1 << len(matrices.EXPLAIN_PREDICATES)):
        assert matrices.decode_predicate_bits(bits) == jmatrices.decode_predicate_bits(bits)
