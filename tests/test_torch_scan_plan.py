"""The scan kernel's launch plan: pure Python, checked on the CPU.

`ops/scan_kernel.launch_plan` cuts the node axis over one cluster of
CTAs and sizes each CTA's shared memory by the kernel's own layout
(`make_layout` in `csrc/scan_kernel.cu`; the emulation test holds the
two equal). These tests pin the figures `PERF.md` reports, that the
slices cover the nodes exactly once, that a node axis past what the
cluster's shared memory holds runs in place (the slices in device
memory) while the resident plan below it is unchanged, and that a plan
the card cannot run raises before anything is launched.
"""

import pytest
import torch

from kubernetes_tpu_torch.ops import scan_kernel
from kubernetes_tpu_torch.ops.scan_kernel import LaunchPlan, launch_plan, max_nodes, smem_bytes

# The main path's widths: 2-word label, port and volume bitsets, 8
# service ids per pod.
MAIN = dict(SW=2, PW=2, VW=2, K=8)


def test_main_path_plan_is_the_one_perf_md_reports():
    plan = launch_plan(5120, **MAIN)
    assert plan == LaunchPlan(
        cluster=16, nodes_per_cta=320, threads=320, smem_bytes=51712,
        count_stride=5120, row_words=24,
    )
    assert max_nodes(**MAIN) == 40384


@pytest.mark.parametrize(
    "N,widths,cluster,expected",
    [
        # 320 nodes x (8 f32 + 8 words + 4 count rows) x 4 B + 2 flags,
        # 2 tiles x 128 pods x 24 words x 4 B, a key and a count per warp
        # (32 x 12 B), slots of 2 x 16 CTAs x 16 B.
        (5120, (2, 2, 2, 8), 16, 320 * 82 + 24576 + 384 + 512),
        (5120, (2, 2, 2, 8), 8, 640 * 82 + 24576 + 384 + 512),
        # One-word bitsets: 12 nodes of (8 + 4 + 4) x 4 B and flags
        # rounded up to 32 B, rows of 5 + 4 + 8 = 17 -> 20 words.
        (40, (1, 1, 1, 8), 4, 12 * 64 + 32 + 2 * 4 * 128 * 20 + 384 + 512),
        # No nodes: the fixed regions only.
        (0, (2, 2, 2, 8), 2, 24576 + 384 + 512),
    ],
)
def test_shared_memory_bytes_for_given_widths(N, widths, cluster, expected):
    SW, PW, VW, K = widths
    assert smem_bytes(N, SW, PW, VW, K, cluster) == expected
    assert launch_plan(N, SW, PW, VW, K, cluster).smem_bytes == expected


@pytest.mark.parametrize("N", [0, 1, 3, 7, 16, 37, 128, 5120, 5121, 40384])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_slices_cover_every_node_exactly_once(N, cluster):
    plan = launch_plan(N, cluster=cluster, **MAIN)
    # Resident up to what the cluster's shared memory holds, in place past it.
    assert plan.resident == (N <= max_nodes(cluster=cluster, **MAIN))
    if not plan.resident:
        with pytest.raises(ValueError, match="shared memory"):
            launch_plan(N, cluster=cluster, resident=True, **MAIN)
    owned = []
    for r in range(plan.cluster):
        owned += range(r * plan.nodes_per_cta, min((r + 1) * plan.nodes_per_cta, N))
    assert owned == list(range(N))
    assert plan.nodes_per_cta % 4 == 0 and plan.count_stride % 4 == 0
    assert plan.count_stride == plan.cluster * plan.nodes_per_cta >= N
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    # One thread per node of a slice, up to 1,024.
    assert plan.threads >= min(plan.nodes_per_cta, 1024)


def test_node_axis_past_the_limit_raises_before_any_launch():
    """Past the resident limit the default plan reads the slices in
    place; a plan made to hold them resident raises, naming the limit."""
    limit = max_nodes(**MAIN)
    assert launch_plan(limit, **MAIN).resident
    assert not launch_plan(limit + 1, **MAIN).resident
    with pytest.raises(ValueError, match=rf"N={limit + 1} nodes.*at most {limit} nodes"):
        launch_plan(limit + 1, resident=True, **MAIN)
    # A smaller cluster holds fewer nodes.
    assert max_nodes(cluster=8, **MAIN) < limit


class _NoLaunch:
    def ktt_scan_launch(self, *args):
        raise AssertionError("the launcher was called for a plan past the limit")


def _tensors(N, S, P=4, words=1):
    """Pod and node tensors of the kernel's dtypes, bitsets of `words`
    words."""
    pods = {
        "cpu": torch.zeros(P), "mem": torch.zeros(P),
        "zero_req": torch.zeros(P, dtype=torch.bool),
        "pinned": torch.full((P,), -1, dtype=torch.int32),
        "svc": torch.full((P,), -1, dtype=torch.int32),
        "svc_ids": torch.full((P, 8), -1, dtype=torch.int32),
    }
    for k in ("sel", "port", "vol_any", "vol_rw"):
        pods[k] = torch.zeros((P, words), dtype=torch.int32)
    nodes = {k: torch.zeros(N) for k in
             ("cpu_cap", "mem_cap", "pods_cap", "cpu_fit", "mem_fit", "cpu_used", "mem_used",
              "pods_used")}
    nodes.update({k: torch.zeros(N, dtype=torch.bool) for k in ("over", "sched")})
    nodes.update({k: torch.zeros((N, words), dtype=torch.int32)
                  for k in ("labels", "uport", "uvol_any", "uvol_rw")})
    nodes["svc_counts"] = torch.zeros((N, S))
    return pods, nodes


def test_wrapper_raises_past_the_limit_without_calling_the_launcher():
    """A plan held resident past the limit, or one forced to stage pod
    rows in tiles too large for them even in place, is refused before
    the launcher is called."""
    N = max_nodes(1, 1, 1, 8) + 1
    pods, nodes = _tensors(N=N, S=16)
    held = LaunchPlan(cluster=16, nodes_per_cta=-(-N // 64) * 4, threads=1024,
                      smem_bytes=smem_bytes(N, 1, 1, 1, 8, 16), count_stride=-(-N // 64) * 64,
                      row_words=20, resident=True)
    with pytest.raises(ValueError, match="shared memory"):
        scan_kernel._call(_NoLaunch(), pods, nodes, (1, 1, 1), None, held)
    pods, nodes = _tensors(N=64, S=4, words=240)
    forced = LaunchPlan(cluster=16, nodes_per_cta=4, threads=32, smem_bytes=0, count_stride=64,
                        row_words=976, resident=False, tile=128)
    with pytest.raises(ValueError, match="two tiles of 128 pods outgrow it"):
        scan_kernel._call(_NoLaunch(), pods, nodes, (1, 1, 1), None, forced)


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(cluster=17), "cluster size"),
        (dict(cluster=0), "cluster size"),
        (dict(threads=48), "threads"),
        (dict(threads=2048), "threads"),
    ],
)
def test_plans_the_card_cannot_run_raise(kwargs, match):
    with pytest.raises(ValueError, match=match):
        launch_plan(5120, **MAIN, **kwargs)


def test_more_than_32_service_ids_raise():
    with pytest.raises(ValueError, match="service ids"):
        launch_plan(5120, 2, 2, 2, 33)


def test_a_plan_made_for_other_shapes_is_refused():
    pods, nodes = _tensors(N=64, S=4)
    stale = launch_plan(5120, 1, 1, 1, 8, cluster=4, threads=64)
    with pytest.raises(ValueError, match="other shapes"):
        scan_kernel._call(_NoLaunch(), pods, nodes, (1, 1, 1), None, stale)


@pytest.mark.parametrize("N,widths,limit", [(40385, (2, 2, 2, 8), 40384), (50000, (2, 2, 2, 8), 40384),
                                            (27841, (4, 4, 4, 8), 27840),
                                            (65536, (4, 4, 4, 8), 27840)])
def test_in_place_past_the_resident_limit(N, widths, limit):
    """Past 40,384 nodes at the main path's widths, and 27,840 at the
    session's 4-word widths, the plan keeps 16 CTAs and reads the slices
    in place: shared memory holds the two pod tiles, a key and a count
    per warp and the slots, whatever N."""
    assert max_nodes(*widths) == limit
    plan = launch_plan(N, *widths)
    npc = (-(-N // 16) + 3) // 4 * 4
    row_words = -(-(5 + sum(widths[:3]) + widths[2] + widths[3]) // 4) * 4
    assert plan == LaunchPlan(
        cluster=16, nodes_per_cta=npc, threads=min(1024, -(-npc // 32) * 32),
        smem_bytes=2 * 4 * 128 * row_words + 384 + 512, count_stride=16 * npc,
        row_words=row_words, resident=False,
    )
    assert plan.smem_bytes == smem_bytes(N, *widths, 16, False) == smem_bytes(7, *widths, 16, False)


@pytest.mark.parametrize("N", [1, 5120, 13312, 27840, 40384])
def test_resident_plan_unchanged_below_the_limit(N):
    """Below the limit the default plan is the resident one, by the
    same layout as before there was an in-place plan."""
    plan = launch_plan(N, **MAIN)
    assert plan.resident and plan == launch_plan(N, resident=True, **MAIN)
    npc = (-(-N // 16) + 3) // 4 * 4
    assert plan.smem_bytes == 4 * npc * 20 + -(-2 * npc // 16) * 16 + 24576 + 384 + 512


def _words_for_row(row_words):
    """(SW, PW, VW, K) whose packed row is `row_words` words: label
    words beside the session's 4-word port and volume bitsets."""
    return row_words - 5 - 4 - 8 - 8, 4, 4, 8


@pytest.mark.parametrize("row_words,tile", [
    (24, 128), (196, 128), (224, 128), (228, 64), (340, 64), (452, 64), (456, 32),
    (904, 32), (908, 16), (1200, 16), (1808, 16), (1812, 8), (3616, 8), (3620, 0), (9000, 0),
])
def test_each_row_width_takes_the_largest_tile_that_fits(row_words, tile):
    """Two tiles of 128 pods hold rows of up to 224 words; past that
    the tile halves down to 8 pods, and past 3,616 words the rows are
    read in place. No width raises."""
    widths = _words_for_row(row_words)
    assert scan_kernel.row_tile(*widths) == tile
    for N in (1, 36, 8000, 50000):
        plan = launch_plan(N, *widths)
        assert plan.row_words == row_words and plan.tile == tile
        assert plan.smem_bytes == smem_bytes(N, *widths, 16, plan.resident, tile) <= 232448
        assert plan.tile_shift == (tile.bit_length() - 1 if tile else 0)


def test_hostname_cluster_plans_in_place_with_a_64_pod_tile():
    """8,000 nodes whose hostname labels make 340-word rows: the slices
    do not fit beside two 64-pod tiles, so they run in place, the tile
    64 pods. A few dozen such nodes stay resident beside the same tile."""
    widths = _words_for_row(340)
    plan = launch_plan(8000, *widths)
    assert (plan.resident, plan.tile, plan.cluster, plan.nodes_per_cta) == (False, 64, 16, 500)
    small = launch_plan(36, *widths)
    assert small.resident and small.tile == 64


@pytest.mark.parametrize("tile", [0, 8, 16, 32, 64, 128])
def test_a_forced_tile_plans_or_names_the_limit(tile):
    widths = _words_for_row(340)
    if 2 * 4 * tile * 340 + 896 > 232448:
        with pytest.raises(ValueError, match=f"two tiles of {tile} pods"):
            launch_plan(8000, *widths, tile=tile)
    else:
        assert launch_plan(8000, *widths, tile=tile).tile == tile
    with pytest.raises(ValueError, match="tile of 4 pods"):
        launch_plan(64, **MAIN, tile=4)
