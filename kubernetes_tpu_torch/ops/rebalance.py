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

Each row waits on the last, so the kernel is `csrc/rebalance_kernel.cu`,
one block over the node axis; this module plans, checks and binds it.
`launch_plan` is pure Python, by the kernel's layout: one thread a node
up to 1,024, the carry (12 B a node) in shared memory where it fits
(19,000-odd nodes) and in a device scratch otherwise; the probes are
read through the read-only cache. It takes any D >= 0, N >= 1 and Q >= 1. A
src outside [0, N) is no source, as in JAX, where N is the caller's node
count: nothing pads the node axis.

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

#: Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT = 232448
MAX_THREADS = 1024
#: The kernel's fixed shared memory: the winner slots [2][32] (key, node,
#: cpu_fit, mem_fit, pods_used), the source's carry [2][4], the score
#: sums [32][2], the move count [2] (its kFixedBytes).
FIXED_BYTES = 5 * 2 * 32 * 4 + 2 * 4 * 4 + 32 * 2 * 4 + 16

_DTYPES = (
    (torch.float32,) * 6 + (torch.bool,) * 2  # node columns
    + (torch.float32, torch.float32, torch.int32, torch.bool, torch.bool)  # rows
    + (torch.float32, torch.float32, torch.int32, torch.bool)  # probes
)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def smem_bytes(N: int, resident: bool) -> int:
    """Dynamic shared memory of a launch: the kernel's `smem_bytes`."""
    return FIXED_BYTES + (_round_up(12 * N, 16) if resident else 0)


@dataclass(frozen=True)
class LaunchPlan:
    """One block of `threads` threads, node j on thread j mod threads;
    the carry in shared memory (`resident`) or in a device scratch."""

    threads: int
    resident: bool
    smem_bytes: int


def max_nodes() -> int:
    """The largest node axis whose carry fits shared memory."""
    return (SMEM_LIMIT - FIXED_BYTES) // 12


def launch_plan(N: int, Q: int, threads: Optional[int] = None,
                resident: Optional[bool] = None) -> LaunchPlan:
    """The launch for N nodes and Q probes: one thread a node (a multiple
    of 32, at most 1,024) and the carry resident where it fits;
    `threads` and `resident` override them for a test. Raises
    ValueError, before any launch, only for a forced plan the card cannot
    run."""
    if N < 1 or Q < 1:
        raise ValueError(f"rebalance kernel: needs N >= 1 and Q >= 1, got N={N}, Q={Q}")
    T = min(MAX_THREADS, max(32, _round_up(N, 32))) if threads is None else int(threads)
    if T % 32 or not 32 <= T <= MAX_THREADS:
        raise ValueError(f"rebalance kernel: {T} threads; need a multiple of 32 up to 1024")
    if resident is None:
        resident = smem_bytes(N, True) <= SMEM_LIMIT
    smem = smem_bytes(N, resident)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"rebalance kernel: {N} nodes resident need {smem} bytes of shared memory, over the "
            f"limit of {SMEM_LIMIT}; at most {max_nodes()} nodes are resident"
        )
    return LaunchPlan(threads=T, resident=bool(resident), smem_bytes=smem)


def _bind(lib: ctypes.CDLL) -> None:
    lib.ktt_rebalance_launch.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.ktt_rebalance_launch.restype = ctypes.c_int
    lib.ktt_rebalance_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.ktt_rebalance_smem_bytes.restype = ctypes.c_int
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
    the outputs and the scratch, and call the launcher."""
    device = args[0].device
    _check(args, device)
    N, D, Q = args[0].shape[0], args[8].shape[0], args[13].shape[0]
    if plan is None:
        plan = launch_plan(N, Q)
    elif plan != launch_plan(N, Q, plan.threads, plan.resident):
        raise ValueError(f"rebalance kernel: {plan} was made for other shapes")
    dest = torch.empty(D, dtype=torch.int32, device=device)
    moved = torch.empty(D, dtype=torch.bool, device=device)
    gain = torch.empty(D, dtype=torch.int32, device=device)
    n_moves = torch.empty((), dtype=torch.int32, device=device)
    scores = torch.empty(2, dtype=torch.float32, device=device)
    scratch = None if plan.resident else torch.empty(3 * N, dtype=torch.float32, device=device)
    ptrs = [t.data_ptr() for i, t in enumerate(args) if i != 15]  # probe_min: not read
    ptrs += [None if scratch is None else scratch.data_ptr(), dest.data_ptr(), moved.data_ptr(),
             gain.data_ptr(), n_moves.data_ptr(), scores.data_ptr()]
    rc = lib.ktt_rebalance_launch(*ptrs, D, N, Q, int(budget), plan.threads, int(plan.resident),
                                  stream)
    if rc != 0:
        raise RuntimeError(f"rebalance kernel launch failed: {lib.ktt_rebalance_error_string(rc).decode()}")
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
