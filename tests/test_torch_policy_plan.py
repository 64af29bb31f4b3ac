"""The policy scan kernel's launch plan: pure Python, checked on the CPU.

`ops/policy_scan.launch_plan` takes the largest cluster, up to 16 CTAs,
whose per-CTA shared memory holds the node slice, the pod tiles, the
count rows, the replicated service carry and the anti-affinity zone
sums and partials, by the kernel's own layout (`make_layout` in
`csrc/policy_scan_kernel.cu`; held equal below through the emulation
build). Where they do not fit, the same kernel keeps all of them in
device memory ("in place"). These tests pin the main path's plan, that
a large zone vocabulary no longer costs cluster size, that every shape
the earlier one-CTA kernel took still plans, and that what the kernel
cannot take raises before any launch.
"""

import pytest

from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.models.algspec import LoweredSpec, spec_from_policy
from kubernetes_tpu_torch.models.columnar import build_snapshot
from kubernetes_tpu_torch.ops import build, policy_scan
from kubernetes_tpu_torch.ops.matrices import device_snapshot
from kubernetes_tpu_torch.ops.policy_scan import LaunchPlan, launch_plan, max_nodes, smem_bytes

# The policy backlog's widths: 2-word bitsets, 8 service ids, one
# affinity label, 512 services and the scratch slot.
MAIN = dict(SW=2, PW=2, VW=2, K=8, KA=1)
SA = 513


@pytest.fixture(scope="module")
def full_vocabulary():
    """FULL_VOCABULARY_POLICY lowered on 5,000 nodes (padded to 5,120)."""
    pending, nodes, assigned, services = workload.policy_objects(400, 5000, seed=2)
    spec = spec_from_policy(workload.FULL_VOCABULARY_POLICY)
    return device_snapshot(build_snapshot(pending, nodes, assigned, services, spec=spec), "cpu")


def test_full_vocabulary_plan_at_5120_nodes(full_vocabulary):
    """The main path's plan: 16 CTAs of 320 nodes, resident, one thread
    per node, the rack instance's 16 zone bins."""
    d = full_vocabulary
    lspec = d.lowered
    assert (lspec.aa_weights, lspec.aa_zones, lspec.static_prio) == ((2,), (16,), True)
    plan = policy_scan.plan_for(d.pods, d.nodes, lspec)
    S1 = d.nodes["anchor"].shape[0]
    assert plan == LaunchPlan(
        cluster=16, nodes_per_cta=320, threads=320,
        smem_bytes=smem_bytes(5120, 2, 2, 2, 8, 1, 1, 1, S1, 16, 16, True),
        count_stride=5120, row_words=24, zone_bins=16, resident=True,
    )
    # 320 nodes x (8 f32 + 8 words + 3 policy columns + 4 count rows +
    # the score before the zones) x 4 B and 4 flag bytes, 2 tiles x 64 pods
    # x 24 words x 4 B, a key and a count per warp, 2 x 16 slots, the
    # service carry, 16 zone sums and 16 partials.
    assert plan.smem_bytes == (320 * (24 * 4 + 4) + 12288 + 384 + 512
                               + 2 * 4 * -(-S1 // 4) * 4 + 2 * 16 * 4)
    assert launch_plan(5120, **MAIN, lspec=lspec, SA=SA).cluster == 16
    assert max_nodes(**MAIN, lspec=lspec, SA=SA) == 34368


def test_large_zone_vocabulary_lowers_the_cluster():
    """A hostname-like anti-affinity label (5,000 values, bucketed to
    5,008 bins) at 5,120 nodes costs no cluster size: a CTA holds one
    array of sums and one of partials whatever C, so the plan keeps 16
    CTAs, resident. Five such labels outgrow shared memory and run in
    place on 16 CTAs. What lowers the cluster now is a service carry too
    large to replicate: one CTA keeps it in device memory."""
    lspec = LoweredSpec(static_prio=True, service_affinity=True, node_label=True,
                        aa_weights=(2,), aa_zones=(5008,))
    plan = launch_plan(5120, **MAIN, lspec=lspec, SA=SA)
    assert (plan.cluster, plan.resident, plan.zone_bins) == (16, True, 5008)
    for C in (2, 16):
        assert smem_bytes(5120, 2, 2, 2, 8, 1, 1, 1, SA, 5008, C, True) - \
            smem_bytes(5120, 2, 2, 2, 8, 1, 1, 1, SA, 0, C, True) == 2 * 4 * 5008
    five = lspec._replace(aa_weights=(1,) * 5, aa_zones=(5120,) * 5)
    in_place = launch_plan(5120, **MAIN, lspec=five, SA=SA)
    assert (in_place.cluster, in_place.resident) == (16, False)
    huge = launch_plan(5120, **MAIN, lspec=lspec, SA=40001)
    assert (huge.cluster, huge.resident) == (1, False)
    # A key and a count per warp, the slots, two tiles of 4 pod rows.
    assert huge.smem_bytes == smem_bytes(5120, 2, 2, 2, 8, 1, 1, 1, 40001, 5008, 1, False) == \
        384 + 512 + 2 * 4 * 4 * 24


def _one_cta_smem(N, n_aa, zone_bins):
    """The shared memory the earlier one-CTA kernel asked for: a key per
    warp, the zone bins and, with anti-affinity, a score and a flag per
    node. It planned every spec whose bytes fit."""
    r16 = lambda x: -(-x // 16) * 16  # noqa: E731
    return 32 * 8 + r16(4 * zone_bins) + (r16(4 * N) + r16(N) if n_aa else 0)


def _one_cta_edge(n_aa, hostname_like):
    """The largest node axis the one-CTA kernel took with n_aa
    instances, each of 16 bins or of a value per node."""
    def zones(n):
        return n_aa * (max(16, -(-n // 16) * 16) if hostname_like else 16)

    lo, hi = 1, 1 << 22
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if _one_cta_smem(mid, n_aa, zones(mid)) <= policy_scan.SMEM_LIMIT else (lo, mid)
    return lo


@pytest.mark.parametrize("n_aa", [0, 1, 2, 5, 8])
def test_every_shape_the_one_cta_kernel_took_still_plans(n_aa):
    """Every node axis, zone vocabulary, affinity width, service count
    and bitset width that fit the one-CTA kernel's shared memory still
    plans, up to its edge: one hostname-like instance at 20,480 nodes
    and at its last node, two of them at 17,000, and any node axis
    without anti-affinity."""
    checked = 0
    for hostname_like in (False, True):
        edge = _one_cta_edge(n_aa, hostname_like) if n_aa else 4_000_000
        for N in sorted({1, 100, 5120, 6000, 17_000, 20_480, 25_000, edge, edge + 1}):
            bins = max(16, -(-N // 16) * 16) if hostname_like else 16
            lspec = LoweredSpec(static_prio=True, service_affinity=True, node_label=True,
                                aa_weights=(1,) * n_aa, aa_zones=(bins,) * n_aa)
            if _one_cta_smem(N, n_aa, n_aa * bins) > policy_scan.SMEM_LIMIT:
                assert N == edge + 1 or N > edge
                continue
            for KA in (0, 1, 8):
                for slots in (0, 513, 100_001):
                    for widths in ((2, 2, 2, 8), (4, 8, 4, 16)):
                        plan = launch_plan(N, *widths, KA, lspec, SA=slots)
                        assert plan.smem_bytes <= policy_scan.SMEM_LIMIT
                        assert plan.count_stride >= N
                        checked += 1
    assert checked >= 5 * 18
    if n_aa == 1:
        one = LoweredSpec(aa_weights=(1,), aa_zones=(20480,))
        assert _one_cta_smem(20480, 1, 20480) <= policy_scan.SMEM_LIMIT
        plan = launch_plan(20480, **MAIN, lspec=one, SA=SA)
        assert (plan.cluster, plan.resident) == (16, False)


def test_slices_read_in_place_past_the_resident_limit():
    """Past what 16 CTAs hold resident, the same kernel reads the slices
    in place, at the same cluster size; a given residency is kept."""
    lspec = LoweredSpec(aa_weights=(1,), aa_zones=(16,))
    limit = max_nodes(2, 2, 2, 8, 0, lspec)
    assert launch_plan(limit, 2, 2, 2, 8, 0, lspec).resident
    plan = launch_plan(limit + 1, 2, 2, 2, 8, 0, lspec)
    assert (plan.cluster, plan.resident) == (16, False)
    assert not launch_plan(100, 2, 2, 2, 8, 0, lspec, resident=False).resident
    with pytest.raises(ValueError, match="shared memory"):
        launch_plan(limit + 1, 2, 2, 2, 8, 0, lspec, resident=True)


def test_past_the_limits_raises_before_any_launch(monkeypatch, full_vocabulary):
    def no_build(*args, **kwargs):
        raise AssertionError("a kernel was built or loaded for a plan that cannot run")

    monkeypatch.setattr(build, "load", no_build)
    lspec = full_vocabulary.lowered
    cases = [
        (dict(lspec=lspec._replace(aa_weights=(1,) * 6, aa_zones=(5120,) * 6), resident=True),
         "shared memory"),
        (dict(lspec=lspec, SA=40001, cluster=2), "shared memory"),
        # Nine instances and nine affinity labels plan (below); what
        # remains is shared memory: nine hostname-like instances held
        # resident, or pod rows of 8,000 affinity pins, whose two tiles
        # of 4 rows outgrow it even in place.
        (dict(lspec=lspec._replace(aa_weights=(1,) * 9, aa_zones=(5120,) * 9), resident=True),
         "shared memory"),
        (dict(lspec=lspec, KA=8000), "shared memory"),
        (dict(lspec=lspec, cluster=17), "cluster size"),
        (dict(lspec=lspec, cluster=0), "cluster size"),
        (dict(lspec=lspec, threads=1056), "threads"),
        (dict(lspec=lspec._replace(aa_zones=(0,))), "zone vocabulary"),
    ]
    for kw, match in cases:
        args = dict(MAIN, SA=SA)
        args.update(kw)
        with pytest.raises(ValueError, match=match):
            launch_plan(5120, **args)
    for n_aa, KA in ((9, 1), (12, 1), (1, 9)):
        nine = lspec._replace(aa_weights=(1,) * n_aa, aa_zones=(16,) * n_aa)
        plan = launch_plan(5120, **dict(MAIN, KA=KA, SA=SA), lspec=nine)
        assert (plan.cluster, plan.resident, plan.zone_bins) == (16, True, 16 * n_aa)
    # The wrapper plans before it builds: the same refusal on tensors.
    d = full_vocabulary
    pods = dict(d.pods, aff_pin=d.pods["aff_pin"].repeat(1, 8000).contiguous())
    nodes = dict(d.nodes, aff_vid=d.nodes["aff_vid"].repeat(1, 8000).contiguous())
    with pytest.raises(ValueError, match="shared memory"):
        policy_scan._call(None, pods, nodes, d.weights, lspec, None)


def test_a_plan_made_for_other_shapes_is_rejected(full_vocabulary):
    d = full_vocabulary
    stale = policy_scan.plan_for(d.pods, d.nodes, d.lowered, 64, 4)
    fewer = {k: v[:4000].contiguous() for k, v in d.nodes.items() if k not in ("anchor", "svc_total")}
    fewer.update(anchor=d.nodes["anchor"], svc_total=d.nodes["svc_total"])
    with pytest.raises(ValueError, match="other shapes"):
        policy_scan._call(None, d.pods, fewer, d.weights, d.lowered, None, stale)
    in_place = policy_scan.plan_for(d.pods, d.nodes, d.lowered, 64, 4, resident=False)
    resident = policy_scan.plan_for(d.pods, d.nodes, d.lowered, 64, 4)
    assert in_place != resident and in_place.smem_bytes < resident.smem_bytes


@pytest.fixture(scope="module")
def emulated_policy(tmp_path_factory):
    from test_torch_kernel_emulation import _compile_emulated

    handle = _compile_emulated(tmp_path_factory, "policy_scan_kernel")
    policy_scan._bind(handle)
    return handle


@pytest.mark.parametrize("cluster", [1, 4, 10, 16])
@pytest.mark.parametrize("resident", [True, False])
def test_plan_smem_equals_the_kernel_layout(emulated_policy, full_vocabulary, cluster, resident):
    """`smem_bytes` of the plans above equals the kernel's own
    `ktt_policy_smem_bytes`, built from the same source."""
    d = full_vocabulary
    for lspec in (d.lowered, d.lowered._replace(aa_zones=(5008,)), LoweredSpec()):
        widths = policy_scan._layout_widths(2, 2, 2, 8, 1, lspec, SA)
        want = smem_bytes(5120, *widths, cluster, resident)
        assert emulated_policy.ktt_policy_smem_bytes(5120, *widths, cluster, int(resident)) == want
        if want <= policy_scan.SMEM_LIMIT:
            plan = launch_plan(5120, **MAIN, lspec=lspec, SA=SA, cluster=cluster, resident=resident)
            assert plan.smem_bytes == want
