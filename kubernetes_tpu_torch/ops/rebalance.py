"""The defrag plan ("K2"): the descheduler's migration plan as one CUDA
kernel launch.

The counterpart of `kubernetes_tpu/ops/rebalance.py:58 plan_moves`, an
XLA `lax.scan` over the movable pods (not a Pallas kernel). Given the
eight occupancy columns, a worklist of movable pods (sorted largest
first by the host half, `utils/rebalance.py`) and the capacity plane's
probe shapes, it re-places each pod best-fit against the occupancy carry
as earlier moves left it: among live nodes with room for the pod's cpu,
memory and one pod slot, other than its own, the one with the least
leftover in the pod's own units; the move commits while the budget
lasts and if it raises the summed integral probe fits at the two nodes
(the gain), or if the row is forced (a cordoned node draining). The
scores are the capacity plane's fragmentation score before and after.

Each row reads the carry the rows before it left, but only a committed
row changes it, and only at two nodes; commits are sparse beside rows.
So the kernel, `csrc/rebalance_kernel.cu`, works in windows of R rows on
one thread-block cluster: it screens every row of a window in parallel
against the carry frozen at the window's start, keeping each row's K
best (key, node) pairs and the gain of a move to the first; then one
warp resolves the rows in order, keeping the set S of nodes committed
since the window began and recomputing only their keys. The first
untouched pair of a row's list is its best untouched node, exactly,
while one exists or the list holds every feasible node; when all K pairs
are touched and the row had K or more feasible nodes, the window ends
there and the next one is screened from that row. The source's note has
the argument in full. Without the per-row chain the screen is spread
over every warp of up to 16 SMs, where the one-block design it replaced
ran each row on one SM; what stays in order is a chain a commit long.

This module plans, checks and binds it. `launch_plan` is pure Python,
by the kernel's layout: the cluster size (one CTA for each 2^21
node-row evaluations, a power of two up to 16), 1,024 threads a CTA,
K = 8, a first window of 256 rows and a largest of one row a warp of
the cluster (512 on 16 CTAs: a screen then gives every warp one row,
and the set of nodes touched since a window began, whose keys the
resolve works out again for every row, lives no longer than that), and
"resident" (the carry and the node capacities, 24 B a node, in every
CTA's shared memory) where they fit beside 256 row records, which is up
to 9,057 nodes; past that the carry lives in a device scratch. Tests
may force any of them. It takes any D >= 0,
N >= 1 and Q >= 1. A src outside [0, N) is no source, as in JAX, where
N is the caller's node count: nothing pads the node axis. The wrapper
allocates the scratch (the window's lists) and an eight-int64 stats
tensor the kernel fills (`STATS`: windows, rows screened, windows ended
early, resolve steps, rows whose gain the resolve worked out, and
clock64 cycles of CTA 0 in the screen, the resolve and the whole
launch); the last launch's stats stay on `plan_moves.last_stats`,
unread: reading them is a measurement's job.

`plan_moves` takes NumPy arrays or tensors in the JAX function's order
and dtypes. CUDA tensors launch K2 or raise (a failed build or launch
raises; nothing falls back); CPU tensors run `plan_moves_plain`, the JAX
step verbatim as a per-row torch loop. Outputs keep the JAX dtypes:
``(dest i32[D], moved bool[D], gain i32[D], n_moves i32[],
score_before f32[], score_after f32[])``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from kubernetes_tpu_torch import DeviceLike, resolve_device
from kubernetes_tpu_torch.ops.capacity import (
    BIG_FIT,
    FIT_CAP,
    FRAC_Q,
    free_vectors,
    isum,
    node_fits,
    score_ratio,
    stage,
)

#: Best-fit key of an infeasible destination: above any real quantised
#: leftover (FIT_CAP * FRAC_Q = 2^17).
NO_FIT_KEY = 2**30

#: Dynamic shared memory one CTA may use on Hopper (227 KB).
SMEM_LIMIT = 232448
MAX_THREADS = 1024
MAX_CLUSTER = 16
#: A row's list is held one entry a lane of a warp.
MAX_K = 32
DEFAULT_K = 8
FIRST_ROWS = 256
#: Node-row evaluations a CTA of the default plan is given.
EVALS_PER_CTA = 2**21
#: Nodes of S, committed since a window began, a window may collect.
MAX_TOUCHED = 128
#: Forced commits whose gain the kernel works out after the serial chain.
DEFER_CAP = 64
#: The kernel's fixed shared memory: the control and stats (72 B,
#: padded to 80), the score slices [2][16][2], the per-warp score sums
#: [32][2], S's table (an id and three capacities a node) and the
#: deferred gains (48 B each; its kFixedBytes).
FIXED_BYTES = 80 + 2 * MAX_CLUSTER * 2 * 4 + 32 * 2 * 4 + 4 * MAX_TOUCHED * 4 + DEFER_CAP * 48
#: Bytes of a row's record in CTA 0's shared memory (the kernel's Rec).
RECORD_BYTES = 32
#: A window the plan leaves room for before it keeps the carry resident.
MIN_ROWS = 256
#: int64 stats the kernel writes: windows, rows screened, windows ended
#: early, resolve steps, rows whose gain the resolve worked out, and CTA
#: 0's clock64 cycles in the screen, the resolve and the whole launch.
STATS = ("windows", "rows_screened", "early_ends", "resolve_steps", "resolve_gains",
         "screen_cycles", "resolve_cycles", "total_cycles")

_DTYPES = (
    (torch.float32,) * 6 + (torch.bool,) * 2  # node columns
    + (torch.float32, torch.float32, torch.int32, torch.bool, torch.bool)  # rows
    + (torch.float32, torch.float32, torch.int32, torch.bool)  # probes
)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def smem_bytes(N: int, max_rows: int, resident: bool) -> int:
    """Dynamic shared memory of a launch: the kernel's `smem_bytes`: the
    fixed part, a record a row of the largest window, and, resident, S's
    bitmask, the carry and the node capacities."""
    out = FIXED_BYTES + RECORD_BYTES * max_rows
    if resident:
        out += _round_up(4 * ((N + 31) // 32), 16) + 2 * _round_up(12 * N, 16)
    return out


def _rows_room(N: int, resident: bool) -> int:
    """The records shared memory holds beside the rest."""
    return (SMEM_LIMIT - smem_bytes(N, 0, resident)) // RECORD_BYTES


def scratch_bytes(N: int, k: int, max_rows: int, warps: int, resident: bool) -> int:
    """Device scratch of a launch: the kernel's `scratch_layout`: the
    window's lists, the partial lists of a row cut into chunks, and, in
    place, the carry and S's bitmask."""
    out = 8 * max_rows * k + 8 * warps * k
    if not resident:
        out += _round_up(12 * N, 16) + _round_up(4 * ((N + 31) // 32), 16)
    return out


@dataclass(frozen=True)
class LaunchPlan:
    """One cluster of `cluster` CTAs of `threads` threads; K pairs a row,
    a first window of `first_rows` rows growing to `max_rows`; the carry
    in every CTA's shared memory (`resident`) or in the device scratch."""

    cluster: int
    threads: int
    k: int
    first_rows: int
    max_rows: int
    resident: bool
    smem_bytes: int
    scratch_bytes: int


def max_nodes(rows: int = MIN_ROWS) -> int:
    """The largest node axis whose carry fits shared memory beside the
    records of a window of `rows` rows."""
    lo, hi = 1, SMEM_LIMIT // 12
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if smem_bytes(mid, rows, True) <= SMEM_LIMIT else (lo, mid - 1)
    return lo


def launch_plan(N: int, D: int, Q: int, cluster: Optional[int] = None,
                threads: Optional[int] = None, k: Optional[int] = None,
                first_rows: Optional[int] = None, resident: Optional[bool] = None,
                max_rows: Optional[int] = None) -> LaunchPlan:
    """The launch for N nodes, D rows and Q probes: one CTA for each
    EVALS_PER_CTA node-row evaluations (a power of two, 1 to 16), 1,024
    threads a CTA, K = 8, a first window of 256 rows and a largest of one
    row a warp of the cluster (both at most D and at most the records
    shared memory holds), the carry resident where it fits beside
    MIN_ROWS records. Any of them may be forced for a test. Raises
    ValueError, before any launch, only for a forced plan the card
    cannot run."""
    if N < 1 or Q < 1 or D < 0:
        raise ValueError(f"rebalance kernel: needs N >= 1, D >= 0 and Q >= 1, got N={N}, D={D}, "
                         f"Q={Q}")
    C = min(MAX_CLUSTER, _pow2_ceil(-(-N * D // EVALS_PER_CTA))) if cluster is None else int(cluster)
    if not 1 <= C <= MAX_CLUSTER:
        raise ValueError(f"rebalance kernel: a cluster of {C} CTAs; need 1 to {MAX_CLUSTER}")
    T = MAX_THREADS if threads is None else int(threads)
    if T % 32 or not 32 <= T <= MAX_THREADS:
        raise ValueError(f"rebalance kernel: {T} threads; need a multiple of 32 up to 1024")
    K = DEFAULT_K if k is None else int(k)
    if not 1 <= K <= MAX_K:
        raise ValueError(f"rebalance kernel: K = {K}; need 1 to {MAX_K}")
    if resident is None:
        resident = _rows_room(N, True) >= min(MIN_ROWS, max(1, D))
    if max_rows is not None and int(max_rows) < 1:
        raise ValueError(f"rebalance kernel: a largest window of {max_rows} rows")
    # The largest window: one row a warp of the cluster, unless forced.
    max_rows = min(C * T // 32 if max_rows is None else int(max_rows), max(1, D),
                   _rows_room(N, bool(resident)))
    if max_rows < 1:
        raise ValueError(
            f"rebalance kernel: {N} nodes resident need {smem_bytes(N, 1, True)} bytes of shared "
            f"memory, over the limit of {SMEM_LIMIT}; at most {max_nodes(1)} nodes are resident"
        )
    R0 = min(FIRST_ROWS, max_rows) if first_rows is None else min(int(first_rows), max_rows)
    if R0 < 1:
        raise ValueError(f"rebalance kernel: a first window of {R0} rows")
    smem = smem_bytes(N, max_rows, bool(resident))
    return LaunchPlan(cluster=C, threads=T, k=K, first_rows=R0, max_rows=max_rows,
                      resident=bool(resident), smem_bytes=smem,
                      scratch_bytes=scratch_bytes(N, K, max_rows, C * T // 32, bool(resident)))


def _bind(lib: ctypes.CDLL) -> None:
    lib.ktt_rebalance_launch.argtypes = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.ktt_rebalance_launch.restype = ctypes.c_int
    lib.ktt_rebalance_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.ktt_rebalance_smem_bytes.restype = ctypes.c_longlong
    lib.ktt_rebalance_scratch_bytes.argtypes = [ctypes.c_int] * 5
    lib.ktt_rebalance_scratch_bytes.restype = ctypes.c_longlong
    lib.ktt_rebalance_error_string.argtypes = [ctypes.c_int]
    lib.ktt_rebalance_error_string.restype = ctypes.c_char_p


def _check(args, device: torch.device) -> None:
    N, D, Q = args[0].shape[0], args[8].shape[0], args[13].shape[0]
    for k, (t, dtype) in enumerate(zip(args, _DTYPES)):
        n = N if k < 8 else D if k < 13 else Q
        if t.device != device or t.dtype != dtype or tuple(t.shape) != (n,):
            raise ValueError(
                f"rebalance kernel: argument {k} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                f"expected {dtype} ({n},) on {device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"rebalance kernel: argument {k} is not contiguous")


def _call(lib: ctypes.CDLL, args, budget: int, stream, plan: Optional[LaunchPlan] = None):
    """Check the tensors, plan the launch (unless given a plan), allocate
    the outputs, the scratch and the stats, and call the launcher."""
    device = args[0].device
    _check(args, device)
    N, D, Q = args[0].shape[0], args[8].shape[0], args[13].shape[0]
    if plan is None:
        plan = launch_plan(N, D, Q)
    elif plan != launch_plan(N, D, Q, plan.cluster, plan.threads, plan.k, plan.first_rows,
                             plan.resident, plan.max_rows):
        raise ValueError(f"rebalance kernel: {plan} was made for other shapes")
    dest = torch.empty(D, dtype=torch.int32, device=device)
    moved = torch.empty(D, dtype=torch.bool, device=device)
    gain = torch.empty(D, dtype=torch.int32, device=device)
    n_moves = torch.empty((), dtype=torch.int32, device=device)
    scores = torch.empty(2, dtype=torch.float32, device=device)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=device)
    stats = torch.empty(len(STATS), dtype=torch.int64, device=device)
    ptrs = [t.data_ptr() for i, t in enumerate(args) if i != 15]  # probe_min: not read
    ptrs += [scratch.data_ptr(), stats.data_ptr(), dest.data_ptr(), moved.data_ptr(),
             gain.data_ptr(), n_moves.data_ptr(), scores.data_ptr()]
    rc = lib.ktt_rebalance_launch(*ptrs, D, N, Q, int(budget), plan.cluster, plan.threads, plan.k,
                                  plan.first_rows, plan.max_rows, int(plan.resident), stream)
    if rc != 0:
        raise RuntimeError(f"rebalance kernel launch failed: {lib.ktt_rebalance_error_string(rc).decode()}")
    plan_moves.last_stats = stats
    return dest, moved, gain, n_moves, scores[0], scores[1]


def _launch(args, budget: int, plan: Optional[LaunchPlan] = None):
    from kubernetes_tpu_torch.ops import build

    lib = build.load("rebalance_kernel", _bind)
    device = args[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        out = _call(lib, args, budget, stream, plan)
    plan_moves.launches += 1
    return out


def _budget(move_budget) -> int:
    if isinstance(move_budget, torch.Tensor):
        return int(move_budget.item())
    return int(move_budget)


def plan_moves_plain(cpu_cap, mem_cap, pods_cap, cpu_fit, mem_fit, pods_used, over, sched,
                     pod_cpu, pod_mem, pod_node, pod_live, pod_force,
                     probe_cpu, probe_mem, probe_min, probe_live, move_budget):
    """K2's plain PyTorch version, on the tensors' device: the JAX scan's
    step verbatim, one row at a time, with no host read."""
    dev = cpu_cap.device
    f0 = torch.tensor(0.0, dtype=torch.float32, device=dev)
    f1 = torch.tensor(1.0, dtype=torch.float32, device=dev)
    big = torch.tensor(BIG_FIT, dtype=torch.float32, device=dev)
    live = sched & ~over
    livef = live.to(torch.float32)
    n = cpu_cap.shape[0]
    d = pod_cpu.shape[0]
    plive_i = probe_live.to(torch.int32)
    arange_n = torch.arange(n, dtype=torch.int32, device=dev)
    budget = torch.tensor(_budget(move_budget), dtype=torch.int32, device=dev)

    def frag_score(cf, mf, pu):
        fit_int, frac_q = node_fits(*free_vectors(cpu_cap, mem_cap, pods_cap, cf, mf, pu, livef),
                                    probe_cpu, probe_mem)
        usable = isum(isum(fit_int, 1) * plive_i)
        potential = isum(isum(frac_q, 1) * plive_i)
        return score_ratio(usable, potential)

    def node_usable(fc, fm, fp):
        pcu = torch.where(probe_cpu > f0, fc / torch.maximum(probe_cpu, f1), big)
        pme = torch.where(probe_mem > f0, fm / torch.maximum(probe_mem, f1), big)
        ff = torch.clamp(torch.minimum(torch.minimum(pcu, pme), fp), 0.0, FIT_CAP)
        return isum(torch.floor(ff).to(torch.int32) * plive_i)

    cf, mf, pu = cpu_fit.clone(), mem_fit.clone(), pods_used.clone()
    score_before = frag_score(cf, mf, pu)
    moves = torch.zeros((), dtype=torch.int32, device=dev)
    dest = torch.full((d,), -1, dtype=torch.int32, device=dev)
    moved = torch.zeros(d, dtype=torch.bool, device=dev)
    gain_out = torch.zeros(d, dtype=torch.int32, device=dev)
    for i in range(d):
        cpu, mem, src = pod_cpu[i], pod_mem[i], pod_node[i]
        free_cpu, free_mem, free_pods = free_vectors(cpu_cap, mem_cap, pods_cap, cf, mf, pu, livef)
        src_c = torch.clamp(src, 0, n - 1)
        src_valid = (src >= 0) & (src < n)
        is_src = (arange_n == src_c) & src_valid
        feasible = live & (free_cpu >= cpu) & (free_mem >= mem) & (free_pods >= f1) & ~is_src

        kc = torch.where(cpu > f0, (free_cpu - cpu) / torch.maximum(cpu, f1), big)
        km = torch.where(mem > f0, (free_mem - mem) / torch.maximum(mem, f1), big)
        key_frac = torch.clamp(torch.minimum(kc, km), 0.0, FIT_CAP)
        key = torch.floor(key_frac * float(FRAC_Q)).to(torch.int32)
        key = torch.where(feasible, key, NO_FIT_KEY)
        dst = torch.argmin(key).to(torch.int32)  # the first minimum
        any_feasible = feasible.any()

        src_live = src_valid & live[src_c]
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        u_src_before = torch.where(
            src_live, node_usable(free_cpu[src_c], free_mem[src_c], free_pods[src_c]), zero)
        u_src_after = torch.where(
            src_live,
            node_usable(
                torch.maximum(cpu_cap[src_c] - (cf[src_c] - cpu), f0),
                torch.maximum(mem_cap[src_c] - (mf[src_c] - mem), f0),
                torch.maximum(pods_cap[src_c] - (pu[src_c] - f1), f0),
            ),
            zero,
        )
        u_dst_before = node_usable(free_cpu[dst], free_mem[dst], free_pods[dst])
        u_dst_after = node_usable(
            torch.maximum(cpu_cap[dst] - (cf[dst] + cpu), f0),
            torch.maximum(mem_cap[dst] - (mf[dst] + mem), f0),
            torch.maximum(pods_cap[dst] - (pu[dst] + f1), f0),
        )
        gain = (u_src_after + u_dst_after) - (u_src_before + u_dst_before)

        commit = pod_live[i] & any_feasible & (moves < budget) & ((gain > 0) | pod_force[i])
        cmf = commit.to(torch.float32)
        dst_hot = (arange_n == dst).to(torch.float32)
        src_hot = is_src.to(torch.float32)
        cf = cf + cmf * cpu * (dst_hot - src_hot)
        mf = mf + cmf * mem * (dst_hot - src_hot)
        pu = pu + cmf * (dst_hot - src_hot)
        moves = moves + commit.to(torch.int32)
        dest[i] = torch.where(commit, dst, -1)
        moved[i] = commit
        gain_out[i] = torch.where(commit, gain, zero)
    return dest, moved, gain_out, moves, score_before, frag_score(cf, mf, pu)


def plan_moves(cpu_cap, mem_cap, pods_cap, cpu_fit, mem_fit, pods_used, over, sched,
               pod_cpu, pod_mem, pod_node, pod_live, pod_force,
               probe_cpu, probe_mem, probe_min, probe_live, move_budget,
               device: DeviceLike = None):
    """One defrag plan on `device` (default: the CUDA card; raises without
    one): K2 on the card, the plain version on the CPU. `move_budget` is
    an int or a 0-d array (a CUDA tensor is read back once)."""
    device = resolve_device(device)
    args = stage(
        (cpu_cap, mem_cap, pods_cap, cpu_fit, mem_fit, pods_used, over, sched,
         pod_cpu, pod_mem, pod_node, pod_live, pod_force,
         probe_cpu, probe_mem, probe_min, probe_live),
        _DTYPES, device)
    if device.type == "cuda":
        return _launch(args, _budget(move_budget))
    if device.type == "cpu":
        return plan_moves_plain(*args, move_budget)
    raise ValueError(f"rebalance kernel: unsupported device {device}")


#: Kernel launches made by this wrapper (a plain counter callers may reset).
plan_moves.launches = 0
#: The last launch's stats tensor (STATS), on its device; never read here.
plan_moves.last_stats = None
