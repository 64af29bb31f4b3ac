"""The port's gang acceptance equals the JAX package's.

`gang_member_counts` (the masked segment sum), its device wrapper,
`partition_backlog`, `gang_solve` and `schedule_backlog_gang` run on
the CPU (the scan through its plain loop) and must give exactly what
the JAX package gives (`schedule_backlog_gang_tpu`, the XLA scan) on
the same objects: destinations, accepted and rejected group keys."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.models.objects import POD_GROUP_LABEL as JPOD_GROUP_LABEL
from kubernetes_tpu.ops.matrices import gang_member_counts as jgang_member_counts
from kubernetes_tpu.ops.pipeline import (
    gang_member_counts_device as jgang_member_counts_device,
)
from kubernetes_tpu.scheduler.batch import (
    schedule_backlog_gang_scalar,
    schedule_backlog_gang_tpu,
)
from kubernetes_tpu.scheduler.gang import partition_backlog as jpartition_backlog
from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.models.objects import POD_GROUP_LABEL
from kubernetes_tpu_torch.ops.matrices import gang_member_counts
from kubernetes_tpu_torch.ops.pipeline import gang_member_counts_device
from kubernetes_tpu_torch.scheduler.batch import schedule_backlog, schedule_backlog_gang
from kubernetes_tpu_torch.scheduler.gang import (
    GangGroup,
    gang_solve,
    member_counts_host,
    partition_backlog,
    pod_is_live,
)
from kubernetes_tpu_torch.utils.tracing import PhaseTimer
from tests.test_solver_parity import mk_node, mk_pod
from tests.torch_ktsan import torch_ktsan_guard  # noqa: F401 (runs the file sanitized)


def _keys(groups):
    return [g.key for g in groups]


def _same_groups(got, ref):
    assert [(g.key, g.name, g.namespace, g.min_member, g.indices, g.bound) for g in got] == [
        (g.key, g.name, g.namespace, g.min_member, g.indices, g.bound) for g in ref
    ]


def _random_masks(seed):
    rng = np.random.RandomState(seed)
    n, g = rng.randint(1, 300), rng.randint(1, 40)
    placed = rng.rand(n) < 0.6
    gids = rng.randint(-1, g, size=n).astype(np.int32)
    return placed, gids, g


def test_pod_group_label_is_the_jax_packages():
    assert POD_GROUP_LABEL == JPOD_GROUP_LABEL


@pytest.mark.parametrize("seed", range(6))
def test_gang_member_counts_matches_jax_and_host(seed):
    """Random masks with -1 ids, at the exact and at a padded group
    count (ids past the last group add to it, as JAX's clipped
    segment_sum does)."""
    placed, gids, g = _random_masks(seed)
    for num_groups in (g, max(1, g // 2)):
        got = gang_member_counts(torch.from_numpy(placed), torch.from_numpy(gids), num_groups)
        ref = np.asarray(jgang_member_counts(jnp.asarray(placed), jnp.asarray(gids), num_groups=num_groups))
        assert got.dtype == torch.int32 and got.numpy().dtype == ref.dtype
        assert np.array_equal(got.numpy(), ref)
    host = member_counts_host(placed, gids, g)
    assert np.array_equal(host, gang_member_counts(torch.from_numpy(placed), torch.from_numpy(gids), g).numpy())


@pytest.mark.parametrize("seed", range(4))
def test_gang_member_counts_device_matches_jax(seed):
    placed, gids, g = _random_masks(100 + seed)
    got = gang_member_counts_device(placed, gids, g, device="cpu")
    ref = jgang_member_counts_device(placed, gids, g)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert np.array_equal(got, member_counts_host(placed, gids, g))


def test_gang_member_counts_device_edges():
    assert gang_member_counts_device([], [], 0, device="cpu").shape == (0,)
    got = gang_member_counts_device([True], [0], 1, device="cpu")
    assert got.tolist() == [1] and got.tolist() == jgang_member_counts_device([True], [0], 1).tolist()


def _grouped_cluster(seed):
    """A small_cluster backlog with some pods in groups of several
    namespaces, some bound members (live and terminal) among the
    assigned pods, and minMembers that some groups cannot reach."""
    pending, nodes, assigned, services = workload.small_cluster(seed)
    rng = random.Random(seed)
    names = [f"g{i}" for i in range(rng.randint(1, 5))]
    for pod in pending:
        if rng.random() < 0.4:
            pod.metadata.labels[POD_GROUP_LABEL] = rng.choice(names)
            if rng.random() < 0.2:
                pod.metadata.namespace = "other"
    for pod in assigned:
        if rng.random() < 0.3:
            pod.metadata.labels[POD_GROUP_LABEL] = rng.choice(names)
            pod.status.phase = rng.choice(["Running", "Running", "Failed"])
            if rng.random() < 0.1:
                pod.metadata.deletion_timestamp = "2026-01-01T00:00:00Z"
    need = {name: rng.choice([0, 1, 3, 8, 30, None]) for name in names}
    return pending, nodes, assigned, services, (lambda ns, n: need[n])


@pytest.mark.parametrize("seed", range(4))
def test_partition_backlog_matches_jax(seed):
    pending, nodes, assigned, services, mm = _grouped_cluster(seed)
    _same_groups(
        partition_backlog(pending, assigned, mm), jpartition_backlog(pending, assigned, mm)
    )


@pytest.mark.parametrize("seed", range(5))
def test_schedule_backlog_gang_matches_jax(seed):
    pending, nodes, assigned, services, mm = _grouped_cluster(seed)
    groups = partition_backlog(pending, assigned, mm)
    timer = PhaseTimer()
    got = schedule_backlog_gang(
        pending, nodes, assigned, services, groups=groups, device="cpu", timer=timer
    )
    ref = schedule_backlog_gang_tpu(
        pending, nodes, assigned, services, groups=jpartition_backlog(pending, assigned, mm)
    )
    assert got[0] == ref[0]
    assert _keys(got[1]) == _keys(ref[1]) and _keys(got[2]) == _keys(ref[2])
    if groups:
        assert "gang_accept" in timer.seconds
    # All or nothing: a rejected group has no pod placed.
    for g in got[2]:
        assert all(got[0][i] is None for i in g.indices)


def test_seeded_clusters_reject_and_resolve():
    """At least one of the seeded clusters above rejects a group and
    re-solves (more than one round), so the cases exercise the loop."""
    rounds = []
    for seed in range(5):
        pending, nodes, assigned, services, mm = _grouped_cluster(seed)
        calls = []

        def solver(p, n, a, s):
            calls.append(len(p))
            return schedule_backlog(p, n, a, s, device="cpu")

        _, _, rejected = gang_solve(
            solver, pending, nodes, assigned, services, partition_backlog(pending, assigned, mm)
        )
        rounds.append((len(calls), len(rejected)))
    assert any(r > 1 and rej > 0 for r, rej in rounds), rounds


class TestGangSolve:
    """tests/test_gang.py::TestGangSolve, on the port, against JAX."""

    def test_rejected_group_releases_capacity_into_the_solve(self):
        pods = []
        for i in range(2):  # gang of 2 x 600m: only one fits -> reject
            p = mk_pod(f"b{i}", cpu=600)
            p.metadata.labels[POD_GROUP_LABEL] = "gb"
            pods.append(p)
        pods.append(mk_pod("single", cpu=800))  # fits only post-release
        nodes = [mk_node("n0", cpu=1000)]
        groups = partition_backlog(pods, min_member_of=lambda ns, n: 2)
        dests, accepted, rejected = schedule_backlog_gang(pods, nodes, groups=groups, device="cpu")
        assert _keys(rejected) == ["default/gb"]
        assert dests == [None, None, "n0"]
        ref = schedule_backlog_gang_tpu(
            pods, nodes, groups=jpartition_backlog(pods, min_member_of=lambda ns, n: 2)
        )
        assert dests == ref[0] and _keys(rejected) == _keys(ref[2])

    def test_already_bound_members_count_toward_min_member(self):
        bound = mk_pod("b0", cpu=100)
        bound.metadata.labels[POD_GROUP_LABEL] = "ga"
        bound.spec.node_name = "n0"
        p = mk_pod("p0", cpu=100)
        p.metadata.labels[POD_GROUP_LABEL] = "ga"
        groups = partition_backlog([p], assigned=[bound], min_member_of=lambda ns, n: 2)
        assert groups[0].bound == 1
        dests, accepted, rejected = schedule_backlog_gang(
            [p], [mk_node("n0")], assigned=[bound], groups=groups, device="cpu"
        )
        assert not rejected and dests == ["n0"]

    def test_terminal_bound_members_do_not_credit_the_floor(self):
        dead = mk_pod("dead", cpu=100)
        dead.metadata.labels[POD_GROUP_LABEL] = "ga"
        dead.spec.node_name = "n0"
        dead.status.phase = "Failed"
        assert not pod_is_live(dead)
        p = mk_pod("replacement", cpu=100)
        p.metadata.labels[POD_GROUP_LABEL] = "ga"
        (g,) = partition_backlog([p], assigned=[dead], min_member_of=lambda ns, n: 2)
        assert g.bound == 0

    def test_unknown_group_degrades_to_per_pod(self):
        p = mk_pod("p0")
        p.metadata.labels[POD_GROUP_LABEL] = "ghost"
        (g,) = partition_backlog([p], min_member_of=lambda ns, n: None)
        assert g.min_member == 0

    def test_host_and_device_reducers_agree(self):
        rng = np.random.RandomState(7)
        for _ in range(5):
            n, g = rng.randint(1, 64), rng.randint(1, 9)
            placed = rng.rand(n) < 0.6
            gids = rng.randint(-1, g, size=n).astype(np.int32)
            host = member_counts_host(placed, gids, g)
            dev = gang_member_counts_device(placed, gids, g, device="cpu")
            assert (host == dev).all(), (host, dev)

    def test_scalar_and_port_paths_accept_same_group_set(self):
        pods = []
        for grp in ("ga", "gb"):
            for i in range(2):
                p = mk_pod(f"{grp}{i}", cpu=900)
                p.metadata.labels[POD_GROUP_LABEL] = grp
                pods.append(p)
        nodes = [mk_node(f"n{j}", cpu=1000) for j in range(2)]
        groups = partition_backlog(pods, min_member_of=lambda ns, n: 2)
        jgroups = jpartition_backlog(pods, min_member_of=lambda ns, n: 2)
        dp, acc_p, rej_p = schedule_backlog_gang(pods, nodes, groups=groups, device="cpu")
        ds, acc_s, rej_s = schedule_backlog_gang_scalar(pods, nodes, groups=jgroups)
        assert _keys(acc_p) == _keys(acc_s) == ["default/ga"]
        assert _keys(rej_p) == _keys(rej_s) == ["default/gb"]
        assert dp == ds and dp[2] is None and dp[3] is None

    def test_no_groups_is_one_plain_solve(self):
        pods = [mk_pod(f"p{i}", cpu=300) for i in range(4)]
        nodes = [mk_node("n0", cpu=1000)]
        calls = []

        def solver(p, n, a, s):
            calls.append(len(p))
            return ["n0"] * len(p)

        assert gang_solve(solver, pods, nodes) == (["n0"] * 4, [], [])
        assert calls == [4]
        g = GangGroup(key="default/x", name="x", namespace="default", min_member=5, indices=[0, 1])
        dests, acc, rej = gang_solve(solver, pods, nodes, groups=[g])
        assert dests == [None, None, "n0", "n0"] and _keys(rej) == ["default/x"]
