"""The sequential-parity scan as one CUDA kernel launch on a cluster.

Replaces `kubernetes_tpu/ops/pallas_scan.py::_kernel`, the JAX
package's Pallas kernel: the whole default-spec sequential solve (for
each pod in order, every predicate and priority against all N nodes,
first-max selection, commit into the occupancy carry) in one launch.
The kernel is `csrc/scan_kernel.cu`; this module plans and binds it.

What bounds it: P dependent steps, each an N-wide evaluation followed
by an N-wide max whose winner changes the state the next step reads.
It is neither bytes nor FLOPs: a 13,312 x 5,120 chunk moves about
23 MB and does about 5 G simple 32-bit operations, under a tenth of a
millisecond at the card's rates. A step's latency is the cost, so the
kernel spreads each step over one thread-block cluster of C CTAs on
neighbouring SMs. CTA r keeps its slice of the node axis (ceil(N / C)
nodes, rounded up to 4) in shared memory for the whole launch, node
constants and carry both; the count rows pods read and tiles of pod
rows arrive ahead of use by cp.async. Each CTA reduces its slice to one
64-bit key and stores it, with its max count of the next pod's service
and that count at its best node, into every CTA's shared memory through
distributed shared memory; after one cluster barrier every CTA picks
the same winner and the same max count for the next pod.

The launch plan (`launch_plan`) is pure Python: the cluster size, the
nodes per CTA, the threads per CTA, the residency and the dynamic
shared memory, by the same layout the kernel's `make_layout` uses. A
node axis whose slices fit the shared memory of a 16-CTA cluster runs
resident: at the main path's widths (2-word bitsets, 8 service ids) up
to 40,384 nodes (`max_nodes`), at the session's 4-word widths 27,840;
the Pallas kernel's limit was 8,192. Past that the same kernel runs
"in place": the slices and the carry stay in device memory, read and
written by their owning threads, and the counts are read through L2;
the winner still crosses the cluster through distributed shared memory.
Pod rows are staged into shared memory a tile at a time: 128 pods
where two such tiles fit (rows of up to 224 words, which the main
path's and the session's widths always are), else the largest power of
two down to 8 pods whose two buffers fit; the slice stays resident
where it fits beside that tile. So rows of 224 words or fewer plan as
they always did. Rows too wide
for two tiles of 8 (over about 3,600 words) are read in place from
device memory. So no pod-row width makes the plan raise: only a plan
forced to hold what does not fit, a cluster or thread count the card
cannot launch, or more than 32 service ids, raise ValueError before any
launch. Nothing falls back to another kernel or to the plain version.

The wrapper checks device, dtype, shape and contiguity, packs the pod
columns into one (P, row_words) int32 matrix, converts the service
counts between the JAX layout (N, S) f32 and the kernel's (S, NS) int32
(the row a pod reads is then contiguous and 16-byte aligned per CTA),
launches on the current stream and raises if the launch failed. It
never synchronises. CPU tensors go to the plain version, the per-pod
loop of `ops/solver.py`; no CUDA tensor ever does.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from kubernetes_tpu_torch.ops import ledger

Tensors = Dict[str, torch.Tensor]

#: Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT = 232448
#: The largest cluster (16 needs the non-portable cluster attribute).
MAX_CLUSTER = 16
MAX_THREADS = 1024
#: Pods staged into shared memory per tile, the most (the kernel's
#: kTileShift).
TILE = 128
#: The tiles a plan may pick, largest first (0 reads the rows in place).
#: A tile is issued 4 pods ahead into the buffer its predecessor's
#: predecessor used, so a tile under 4 pods would overwrite rows still
#: read; the plan keeps 8 as the floor.
TILES = (128, 64, 32, 16, 8)
#: Count rows held in shared memory: the pod's and the next three (kRows).
COUNT_ROWS = 4
#: Words of a packed pod row ahead of the bitsets: cpu, mem, zero_req,
#: pinned, svc (the kernel's kRowBits).
_ROW_SCALARS = 5

_POD_SPEC = (
    # key, dtype, trailing width key (None for a vector)
    ("cpu", torch.float32, None),
    ("mem", torch.float32, None),
    ("zero_req", torch.bool, None),
    ("pinned", torch.int32, None),
    ("svc", torch.int32, None),
    ("sel", torch.int32, "SW"),
    ("port", torch.int32, "PW"),
    ("vol_any", torch.int32, "VW"),
    ("vol_rw", torch.int32, "VW"),
    ("svc_ids", torch.int32, "K"),
)
_NODE_SPEC = (
    ("cpu_cap", torch.float32, None),
    ("mem_cap", torch.float32, None),
    ("pods_cap", torch.float32, None),
    ("over", torch.bool, None),
    ("sched", torch.bool, None),
    ("labels", torch.int32, "SW"),
    ("cpu_fit", torch.float32, None),
    ("mem_fit", torch.float32, None),
    ("cpu_used", torch.float32, None),
    ("mem_used", torch.float32, None),
    ("pods_used", torch.float32, None),
    ("uport", torch.int32, "PW"),
    ("uvol_any", torch.int32, "VW"),
    ("uvol_rw", torch.int32, "VW"),
    ("svc_counts", torch.float32, "S"),
)
# Pointers the launcher takes: the packed pod rows, every node column
# except the (N, S) f32 service counts, whose (S, NS) int32 copy goes
# in instead, then the choice output.
_N_PTRS = 1 + len(_NODE_SPEC) - 1 + 2


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _row_words(SW: int, PW: int, VW: int, K: int) -> int:
    return _round_up(_ROW_SCALARS + SW + PW + 2 * VW + K, 4)


def smem_bytes(
    N: int, SW: int, PW: int, VW: int, K: int, cluster: int, resident: bool = True,
    tile: int = TILE,
) -> int:
    """Dynamic shared memory of one CTA: the kernel's `make_layout`.
    `resident` keeps the slice's columns and its count rows in shared
    memory; in place they stay in device memory. `tile` pods of rows are
    staged twice over (0: the rows are read in place)."""
    kept = _round_up(-(-N // cluster), 4) if resident else 0
    return (
        4 * kept * (8 + SW + PW + 2 * VW + COUNT_ROWS)  # f32 columns, bitset words, count rows
        + 2 * 4 * tile * _row_words(SW, PW, VW, K)  # pod tiles
        + 32 * (8 + 4)  # a key and a max count per warp
        + 2 * MAX_CLUSTER * 16  # slots: [parity][CTA]
        + _round_up(2 * kept, 16)  # over, sched
    )


@dataclass(frozen=True)
class LaunchPlan:
    """How one launch is cut: one cluster of `cluster` CTAs of `threads`
    threads, CTA r owning nodes [r * nodes_per_cta, (r + 1) *
    nodes_per_cta), its slice held in shared memory (`resident`) or read
    in place from device memory; the service counts have `count_stride`
    columns and a packed pod row `row_words` words, staged `tile` pods
    at a time (0: read in place from device memory)."""

    cluster: int
    nodes_per_cta: int
    threads: int
    smem_bytes: int
    count_stride: int
    row_words: int
    resident: bool = True
    tile: int = TILE

    @property
    def tile_shift(self) -> int:
        """The launcher's tile argument: log2 of `tile`, 0 in place."""
        return self.tile.bit_length() - 1 if self.tile else 0


def row_tile(SW: int, PW: int, VW: int, K: int) -> int:
    """The largest tile whose two buffers the rows alone fit in shared
    memory beside the fixed regions (0: none, the rows stay in place)."""
    for t in TILES:
        if smem_bytes(0, SW, PW, VW, K, 1, False, t) <= SMEM_LIMIT:
            return t
    return 0


def max_nodes(SW: int, PW: int, VW: int, K: int, cluster: int = MAX_CLUSTER) -> int:
    """The largest node axis whose slices fit a cluster's shared memory
    (resident) beside the rows' own tile (`row_tile`); in place any
    node axis plans."""
    tile = row_tile(SW, PW, VW, K)
    if smem_bytes(0, SW, PW, VW, K, cluster, True, tile) > SMEM_LIMIT:
        return 0
    lo, hi = 0, 1
    while smem_bytes(hi, SW, PW, VW, K, cluster, True, tile) <= SMEM_LIMIT:
        lo, hi = hi, hi * 2
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if smem_bytes(mid, SW, PW, VW, K, cluster, True, tile) <= SMEM_LIMIT:
            lo = mid
        else:
            hi = mid
    return lo


def launch_plan(
    N: int, SW: int, PW: int, VW: int, K: int,
    cluster: Optional[int] = None, threads: Optional[int] = None,
    resident: Optional[bool] = None, tile: Optional[int] = None,
) -> LaunchPlan:
    """The launch for a node axis of N at these widths. By default the
    largest cluster, 16 CTAs, the largest tile whose two buffers fit
    beside the fixed regions (`row_tile`; 0: rows in place), resident
    where the slices fit its shared memory beside that tile and in place
    where not, and one thread per node of a slice (a multiple of 32, at
    most 1024); `cluster`, `threads`, `resident` and `tile`
    override them for a test or a sweep. Raises ValueError for a plan
    the card cannot run, before any launch; never for a row width."""
    C = MAX_CLUSTER if cluster is None else int(cluster)
    if not 1 <= C <= MAX_CLUSTER:
        raise ValueError(f"scan kernel: cluster size {C} is outside [1, {MAX_CLUSTER}]")
    if K > 32:
        raise ValueError(f"scan kernel: {K} service ids per pod; the kernel takes at most 32")
    npc = _round_up(-(-N // C), 4)
    T = min(MAX_THREADS, max(32, _round_up(npc, 32))) if threads is None else int(threads)
    if T % 32 or not 32 <= T <= MAX_THREADS:
        raise ValueError(f"scan kernel: {T} threads per CTA; need a multiple of 32 up to 1024")
    if tile is not None and tile not in TILES + (0,):
        raise ValueError(f"scan kernel: a tile of {tile} pods; the kernel stages one of {TILES} "
                         "or reads the rows in place (0)")
    if tile is None:
        tile = row_tile(SW, PW, VW, K)
    if resident is None:
        resident = smem_bytes(N, SW, PW, VW, K, C, True, tile) <= SMEM_LIMIT
    smem = smem_bytes(N, SW, PW, VW, K, C, resident, tile)
    if smem > SMEM_LIMIT:
        where = (f"at these widths a cluster of {C} holds at most "
                 f"{max_nodes(SW, PW, VW, K, C)} nodes resident" if resident
                 else f"two tiles of {tile} pods outgrow it")
        raise ValueError(
            f"scan kernel: N={N} nodes need {smem} bytes of shared memory per CTA in a "
            f"cluster of {C}, over the limit of {SMEM_LIMIT}; {where}"
        )
    return LaunchPlan(
        cluster=C, nodes_per_cta=npc, threads=T, smem_bytes=smem,
        count_stride=npc * C, row_words=_row_words(SW, PW, VW, K),
        resident=bool(resident), tile=int(tile),
    )


def _bind(lib: ctypes.CDLL) -> None:
    lib.ktt_scan_launch.argtypes = (
        [ctypes.c_void_p] * _N_PTRS + [ctypes.c_int] * 14 + [ctypes.c_void_p]
    )
    lib.ktt_scan_launch.restype = ctypes.c_int
    lib.ktt_scan_smem_bytes.argtypes = [ctypes.c_int] * 8
    lib.ktt_scan_smem_bytes.restype = ctypes.c_int
    lib.ktt_scan_occupancy.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)]
    lib.ktt_scan_occupancy.restype = ctypes.c_int
    lib.ktt_error_string.argtypes = [ctypes.c_int]
    lib.ktt_error_string.restype = ctypes.c_char_p


def _check(d: Tensors, spec, rows: int, dims: Dict[str, int], device, what: str) -> None:
    for key, dtype, width in spec:
        t = d[key]
        shape = (rows,) if width is None else (rows, dims[width])
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"scan kernel: {what}[{key!r}] is {t.dtype} {tuple(t.shape)} on "
                f"{t.device}, expected {dtype} {shape} on {device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"scan kernel: {what}[{key!r}] is not contiguous")


def _dims(pods: Tensors, nodes: Tensors) -> Dict[str, int]:
    return {
        "SW": pods["sel"].shape[1],
        "PW": pods["port"].shape[1],
        "VW": pods["vol_any"].shape[1],
        "K": pods["svc_ids"].shape[1],
        "S": nodes["svc_counts"].shape[1],
    }


def cost(P: int, N: int, S: int, SW: int, PW: int, VW: int, K: int,
         placeable: Optional[int] = None) -> Dict[str, int]:
    """What one launch must do, the count PERF.md's bound uses:
    `bytes_accessed` reads every input once and writes every output once
    (pods: cpu, mem, pinned, svc 4 B, zero_req 1 B, bitset words and
    service ids 4 B each; the node constants; the carry in and out; the
    choices), and `flops` counts the 32-bit operations of each (pod,
    node) pair from the plain version's arithmetic (resources and pod
    count 13, hostname 2, selector 2 a word, ports 2 a word, disk 4 a
    word, casts 4, LeastRequested 12, BalancedResourceAllocation 14,
    spreading 4, weighted sum 5, key and max 3) over the `placeable`
    pods (default: all P rows, the most the data can ask)."""
    placeable = P if placeable is None else placeable
    pod_bytes = P * (4 * 4 + 1 + 4 * (SW + PW + 2 * VW + K))
    const_bytes = N * (3 * 4 + 2 + 4 * SW)
    carry_bytes = N * (5 * 4 + 4 * (PW + 2 * VW) + 4 * S)
    ops_per_pair = 13 + 2 + 4 + 12 + 14 + 4 + 5 + 3 + 2 * SW + 2 * PW + 4 * VW
    return {"flops": placeable * N * ops_per_pair,
            "bytes_accessed": pod_bytes + const_bytes + 2 * carry_bytes + 4 * P}


def _note(impl: str, pods: Tensors, nodes: Tensors) -> None:
    """One call into the kernel ledger, keyed by the launch's shapes."""
    d = _dims(pods, nodes)
    d["P"], d["N"] = pods["cpu"].shape[0], nodes["cpu_cap"].shape[0]
    sig = "P={P},N={N},S={S},SW={SW},PW={PW},VW={VW},K={K}".format(**d)
    ledger.DEFAULT.note_call("scan_kernel", impl, sig, lambda: cost(**d))


def plan_for(pods: Tensors, nodes: Tensors, cluster=None, threads=None, resident=None,
             tile=None) -> LaunchPlan:
    """`launch_plan` at the shapes of these tensors."""
    d = _dims(pods, nodes)
    return launch_plan(
        nodes["cpu_cap"].shape[0], d["SW"], d["PW"], d["VW"], d["K"], cluster, threads, resident,
        tile,
    )


def _pod_rows(pods: Tensors, row_words: int) -> torch.Tensor:
    """The pod columns as one (P, row_words) int32 matrix, the f32
    columns by their bits, zero-padded to whole 16-byte chunks."""
    P = pods["cpu"].shape[0]
    cols = [
        pods["cpu"].view(torch.int32)[:, None],
        pods["mem"].view(torch.int32)[:, None],
        pods["zero_req"].to(torch.int32)[:, None],
        pods["pinned"][:, None],
        pods["svc"][:, None],
        pods["sel"], pods["port"], pods["vol_any"], pods["vol_rw"], pods["svc_ids"],
    ]
    used = sum(c.shape[1] for c in cols)
    cols.append(torch.zeros((P, row_words - used), dtype=torch.int32, device=pods["cpu"].device))
    return torch.cat(cols, dim=1)


def _call(
    lib: ctypes.CDLL, pods: Tensors, nodes: Tensors, weights, stream,
    plan: Optional[LaunchPlan] = None,
) -> torch.Tensor:
    """Check the tensors, plan the launch (unless given a plan), pack the
    pod rows, convert the service counts to the kernel's layout, call
    the launcher, and convert them back. Returns the choices."""
    device = pods["cpu"].device
    P = pods["cpu"].shape[0]
    N = nodes["cpu_cap"].shape[0]
    dims = _dims(pods, nodes)
    _check(pods, _POD_SPEC, P, dims, device, "pods")
    _check(nodes, _NODE_SPEC, N, dims, device, "nodes")
    S = dims["S"]
    if S < 1:
        raise ValueError("scan kernel: the service axis must have at least one column")
    if plan is None:
        plan = plan_for(pods, nodes)
    elif plan != plan_for(pods, nodes, plan.cluster, plan.threads, plan.resident, plan.tile):
        raise ValueError(f"scan kernel: {plan} was made for other shapes")
    w_lr, w_bra, w_spread = (int(w) for w in weights)
    rows = _pod_rows(pods, plan.row_words)
    counts = torch.zeros((S, plan.count_stride), dtype=torch.int32, device=device)
    counts[:, :N].copy_(nodes["svc_counts"].t())
    choice = torch.empty(P, dtype=torch.int32, device=device)
    ptrs = [rows.data_ptr()]
    ptrs += [nodes[k].data_ptr() for k, _, _ in _NODE_SPEC if k != "svc_counts"]
    ptrs += [counts.data_ptr(), choice.data_ptr()]
    rc = lib.ktt_scan_launch(
        *ptrs, P, N, S, dims["SW"], dims["PW"], dims["VW"], dims["K"],
        w_lr, w_bra, w_spread, plan.cluster, plan.threads, int(plan.resident), plan.tile_shift,
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"scan kernel launch failed: {lib.ktt_error_string(rc).decode()}")
    nodes["svc_counts"].copy_(counts[:, :N].t())
    return choice


def occupancy(plan: LaunchPlan, N: int, SW: int, PW: int, VW: int, K: int) -> int:
    """cudaOccupancyMaxActiveClusters for this plan on the current card."""
    from kubernetes_tpu_torch.ops import build

    lib = build.load("scan_kernel", _bind)
    active = ctypes.c_int(0)
    rc = lib.ktt_scan_occupancy(N, SW, PW, VW, K, plan.cluster, int(plan.resident),
                                plan.tile_shift, plan.threads, ctypes.byref(active))
    if rc != 0:
        raise RuntimeError(f"scan kernel occupancy query failed: {lib.ktt_error_string(rc).decode()}")
    return active.value


def _launch(pods: Tensors, nodes: Tensors, weights, plan=None) -> Tuple[torch.Tensor, Tensors]:
    from kubernetes_tpu_torch.ops import build

    lib = build.load("scan_kernel", _bind)
    device = pods["cpu"].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        choice = _call(lib, pods, nodes, weights, stream, plan)
    scan_with_state.launches += 1
    _note("cuda", pods, nodes)
    return choice, nodes


def plain_scan_with_state(pods: Tensors, nodes: Tensors, weights) -> Tuple[torch.Tensor, Tensors]:
    """The kernel's plain PyTorch version: `ops/solver.py`'s per-pod
    loop, on any device. Updates `nodes` in place like the kernel."""
    from kubernetes_tpu_torch.ops.solver import _scan_solve

    return _scan_solve(pods, nodes, weights), nodes


def scan_with_state(pods: Tensors, nodes: Tensors, weights=(1, 1, 1)) -> Tuple[torch.Tensor, Tensors]:
    """Default-spec sequential solve: (choice i32[P], nodes), with the
    carry tensors of `nodes` updated in place. CUDA tensors launch the
    kernel (or raise); CPU tensors run the plain version."""
    device = pods["cpu"].device
    if device.type == "cuda":
        return _launch(pods, nodes, weights)
    if device.type == "cpu":
        _note("plain", pods, nodes)
        return plain_scan_with_state(pods, nodes, weights)
    raise ValueError(f"scan kernel: unsupported device {device}")


#: Kernel launches made by this wrapper (a plain counter callers may reset).
scan_with_state.launches = 0
