"""The policy-spec sequential solve as one CUDA kernel launch ("K1P").

Replaces the XLA scan the JAX package runs for a policy LoweredSpec
(`kubernetes_tpu/ops/solver.py:304 _scan_solve` under `_solve_xla` /
`_solve_with_state_xla`; it is not a Pallas kernel, because
`pallas_eligible` refuses every non-default spec). The kernel is
`csrc/policy_scan_kernel.cu`; this module plans, checks and binds it.

What bounds it: as for the scan kernel, P dependent steps, each a chain
of latencies (an N-wide evaluation, a block-wide max, a commit), with a
second block barrier a step when the spec has ServiceAntiAffinity
instances, whose zone sums over the feasible nodes must exist before
any node is scored. It is neither bytes nor operations. The design is
one CTA of up to 1024 threads over a carry kept in device memory:
simple and right first; a cluster version is queued work (ROADMAP).

The spec travels as a runtime flag word (`FLAG_*`, the kernel's
constants) with the weights and up to `MAX_AA` anti-affinity instances,
so one compiled kernel serves every policy. `launch_plan` checks in
Python, before any launch, what the kernel cannot take and raises
ValueError: too many instances or affinity labels, or shared memory
(zone bins plus, with anti-affinity, a score and a feasibility byte per
node) past the card's limit. Nothing falls back to the plain version.

The wrapper checks device, dtype, shape and contiguity, packs the pod
columns into one (P, row_words) int32 matrix, converts the service
counts between the JAX layout (N, S) f32 and the kernel's (S, N) int32,
launches on the current stream and raises if the launch failed. It never
synchronises. CPU tensors go to the plain version, the per-pod loop of
`ops/solver.py`; no CUDA tensor ever does.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from kubernetes_tpu_torch.models.algspec import LoweredSpec
# The base columns, their checks and the packed row's scalars are the
# scan kernel's.
from kubernetes_tpu_torch.ops.scan_kernel import (
    _NODE_SPEC,
    _POD_SPEC,
    _ROW_SCALARS,
    MAX_THREADS,
    SMEM_LIMIT,
    _round_up,
)

Tensors = Dict[str, torch.Tensor]

#: ServiceAntiAffinity instances and ServiceAffinity labels the kernel takes.
MAX_AA = 8
MAX_AFF = 8

FLAG_RESOURCES = 1
FLAG_PORTS = 2
FLAG_DISK = 4
FLAG_SELECTOR = 8
FLAG_HOSTNAME = 16
FLAG_NODE_LABEL = 32
FLAG_SERVICE_AFFINITY = 64
FLAG_STATIC_PRIO = 128
FLAG_SERVICE_CARRY = 256

# Columns a spec needs beyond the base ones: (key, dtype, width, rows).
_POLICY_SPEC = {
    "aff_pin": (torch.int32, "KA", "P"),
    "policy_ok": (torch.bool, None, "N"),
    "static_prio": (torch.int32, None, "N"),
    "aff_vid": (torch.int32, "KA", "N"),
    "aa_zone": (torch.int32, "I", "N"),
    "anchor": (torch.int32, None, "SA"),
    "svc_total": (torch.float32, None, "SA"),
}


def smem_bytes(N: int, n_aa: int, zone_bins: int) -> int:
    """Dynamic shared memory of the launch: the kernel's `make_layout`."""
    return (
        32 * 8  # a key per warp
        + _round_up(4 * zone_bins, 16)
        + (_round_up(4 * N, 16) + _round_up(N, 16) if n_aa > 0 else 0)
    )


def flags_for(lspec: LoweredSpec, service_carry: bool) -> int:
    """The kernel's runtime flag word for a LoweredSpec."""
    flags = 0
    for on, bit in (
        (lspec.resources, FLAG_RESOURCES), (lspec.ports, FLAG_PORTS),
        (lspec.disk, FLAG_DISK), (lspec.selector, FLAG_SELECTOR),
        (lspec.hostname, FLAG_HOSTNAME), (lspec.node_label, FLAG_NODE_LABEL),
        (lspec.service_affinity, FLAG_SERVICE_AFFINITY),
        (lspec.static_prio, FLAG_STATIC_PRIO), (service_carry, FLAG_SERVICE_CARRY),
    ):
        if on:
            flags |= bit
    return flags


@dataclass(frozen=True)
class LaunchPlan:
    """One CTA of `threads` threads with `smem_bytes` of dynamic shared
    memory, `zone_bins` of them the anti-affinity zone sums; a packed
    pod row has `row_words` words."""

    threads: int
    smem_bytes: int
    zone_bins: int
    row_words: int


def launch_plan(
    N: int, SW: int, PW: int, VW: int, K: int, KA: int, lspec: LoweredSpec,
    threads: Optional[int] = None,
) -> LaunchPlan:
    """The launch for a node axis of N at these widths under `lspec`. By
    default one thread per node up to 1024 (a multiple of 32); `threads`
    overrides it for a test or a sweep. Raises ValueError for a launch
    the kernel cannot take, before any launch."""
    n_aa = len(lspec.aa_weights)
    if n_aa > MAX_AA:
        raise ValueError(
            f"policy scan kernel: {n_aa} ServiceAntiAffinity instances; it takes at most {MAX_AA}"
        )
    if len(lspec.aa_zones) != n_aa:
        raise ValueError(
            f"policy scan kernel: {n_aa} anti-affinity weights but {len(lspec.aa_zones)} zone sizes"
        )
    if any(int(z) < 1 for z in lspec.aa_zones):
        raise ValueError(f"policy scan kernel: zone vocabulary sizes {lspec.aa_zones} must be >= 1")
    if KA > MAX_AFF:
        raise ValueError(
            f"policy scan kernel: {KA} ServiceAffinity labels; it takes at most {MAX_AFF}"
        )
    T = min(MAX_THREADS, max(32, _round_up(N, 32))) if threads is None else int(threads)
    if T % 32 or not 32 <= T <= MAX_THREADS:
        raise ValueError(f"policy scan kernel: {T} threads; need a multiple of 32 up to 1024")
    zone_bins = sum(int(z) for z in lspec.aa_zones)
    smem = smem_bytes(N, n_aa, zone_bins)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"policy scan kernel: N={N} nodes and {zone_bins} zone bins need {smem} bytes of "
            f"shared memory, over the limit of {SMEM_LIMIT}"
        )
    return LaunchPlan(
        threads=T, smem_bytes=smem, zone_bins=zone_bins,
        row_words=_ROW_SCALARS + SW + PW + 2 * VW + K + KA,
    )


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ktt_policy_launch.argtypes = (
        [ptr] * 24 + [i32] * 14 + [i32, ctypes.POINTER(i32), ctypes.POINTER(i32), i32, ptr]
    )
    lib.ktt_policy_launch.restype = i32
    lib.ktt_policy_smem_bytes.argtypes = [i32] * 3
    lib.ktt_policy_smem_bytes.restype = i32
    lib.ktt_policy_error_string.argtypes = [i32]
    lib.ktt_policy_error_string.restype = ctypes.c_char_p


def _dims(pods: Tensors, nodes: Tensors, lspec: LoweredSpec) -> Dict[str, int]:
    return {
        "P": pods["cpu"].shape[0],
        "N": nodes["cpu_cap"].shape[0],
        "SW": pods["sel"].shape[1],
        "PW": pods["port"].shape[1],
        "VW": pods["vol_any"].shape[1],
        "K": pods["svc_ids"].shape[1],
        "S": nodes["svc_counts"].shape[1],
        "KA": pods["aff_pin"].shape[1] if lspec.service_affinity else 0,
        "I": len(lspec.aa_weights),
        "SA": nodes["anchor"].shape[0] if "anchor" in nodes else 0,
    }


def _needed(lspec: LoweredSpec, service_carry: bool):
    """The policy columns this spec reads, as (key, which dict)."""
    out = []
    if lspec.service_affinity:
        out += [("aff_pin", "pods"), ("aff_vid", "nodes")]
    if lspec.node_label:
        out.append(("policy_ok", "nodes"))
    if lspec.static_prio:
        out.append(("static_prio", "nodes"))
    if lspec.aa_weights:
        out.append(("aa_zone", "nodes"))
    if service_carry:
        out += [("anchor", "nodes"), ("svc_total", "nodes")]
    return out


def _check(pods: Tensors, nodes: Tensors, lspec: LoweredSpec, dims: Dict[str, int], device) -> None:
    def one(d, key, dtype, width, rows, what):
        if key not in d:
            raise ValueError(f"policy scan kernel: {what}[{key!r}] is missing for {lspec}")
        t = d[key]
        shape = (rows,) if width is None else (rows, dims[width])
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"policy scan kernel: {what}[{key!r}] is {t.dtype} {tuple(t.shape)} on "
                f"{t.device}, expected {dtype} {shape} on {device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"policy scan kernel: {what}[{key!r}] is not contiguous")

    for key, dtype, width in _POD_SPEC:
        one(pods, key, dtype, width, dims["P"], "pods")
    for key, dtype, width in _NODE_SPEC:
        one(nodes, key, dtype, width, dims["N"], "nodes")
    for key, which in _needed(lspec, "anchor" in nodes):
        dtype, width, rows = _POLICY_SPEC[key]
        one(pods if which == "pods" else nodes, key, dtype, width, dims[rows], which)
    if dims["S"] < 1:
        raise ValueError("policy scan kernel: the service axis must have at least one column")
    if "anchor" in nodes and dims["SA"] < 1:
        raise ValueError("policy scan kernel: the service carry needs its scratch slot")


def plan_for(pods: Tensors, nodes: Tensors, lspec: LoweredSpec, threads=None) -> LaunchPlan:
    """`launch_plan` at the shapes of these tensors."""
    d = _dims(pods, nodes, lspec)
    return launch_plan(d["N"], d["SW"], d["PW"], d["VW"], d["K"], d["KA"], lspec, threads)


def _pod_rows(pods: Tensors, lspec: LoweredSpec) -> torch.Tensor:
    """The pod columns as one (P, row_words) int32 matrix, the f32
    columns by their bits, the affinity pins last."""
    cols = [
        pods["cpu"].view(torch.int32)[:, None],
        pods["mem"].view(torch.int32)[:, None],
        pods["zero_req"].to(torch.int32)[:, None],
        pods["pinned"][:, None],
        pods["svc"][:, None],
        pods["sel"], pods["port"], pods["vol_any"], pods["vol_rw"], pods["svc_ids"],
    ]
    if lspec.service_affinity:
        cols.append(pods["aff_pin"])
    return torch.cat(cols, dim=1)


def _call(
    lib: ctypes.CDLL, pods: Tensors, nodes: Tensors, weights, lspec: LoweredSpec, stream,
    plan: Optional[LaunchPlan] = None,
) -> torch.Tensor:
    """Check the tensors, plan the launch (unless given a plan), pack the
    pod rows, convert the service counts to the kernel's layout, call
    the launcher, and convert them back. Returns the choices."""
    device = pods["cpu"].device
    dims = _dims(pods, nodes, lspec)
    _check(pods, nodes, lspec, dims, device)
    if plan is None:
        plan = plan_for(pods, nodes, lspec)
    elif plan != plan_for(pods, nodes, lspec, plan.threads):
        raise ValueError(f"policy scan kernel: {plan} was made for other shapes")
    P, N, S = dims["P"], dims["N"], dims["S"]
    service_carry = "anchor" in nodes
    w_lr, w_bra, w_spread = (int(w) for w in weights)
    rows = _pod_rows(pods, lspec)
    counts = nodes["svc_counts"].t().to(torch.int32).contiguous()
    maxc = torch.empty(S, dtype=torch.int32, device=device)
    choice = torch.empty(P, dtype=torch.int32, device=device)

    def ptr(d, key):
        return d[key].data_ptr() if key in d else None

    ptrs = [rows.data_ptr()]
    ptrs += [nodes[k].data_ptr() for k in ("cpu_cap", "mem_cap", "pods_cap", "over", "sched", "labels")]
    ptrs += [
        ptr(nodes, "policy_ok") if lspec.node_label else None,
        ptr(nodes, "static_prio") if lspec.static_prio else None,
        ptr(nodes, "aff_vid") if lspec.service_affinity else None,
        ptr(nodes, "aa_zone") if lspec.aa_weights else None,
    ]
    ptrs += [nodes[k].data_ptr() for k in (
        "cpu_fit", "mem_fit", "cpu_used", "mem_used", "pods_used", "uport", "uvol_any", "uvol_rw")]
    ptrs += [counts.data_ptr(), maxc.data_ptr(), ptr(nodes, "anchor"), ptr(nodes, "svc_total"),
             choice.data_ptr()]
    n_aa = dims["I"]
    aa_w = (ctypes.c_int * MAX_AA)(*[int(w) for w in lspec.aa_weights])
    aa_nz = (ctypes.c_int * MAX_AA)(*[int(z) for z in lspec.aa_zones])
    rc = lib.ktt_policy_launch(
        *ptrs, P, N, S, dims["SW"], dims["PW"], dims["VW"], dims["K"], dims["KA"],
        dims["SA"], plan.row_words, flags_for(lspec, service_carry), w_lr, w_bra, w_spread,
        n_aa, aa_w, aa_nz, plan.threads, stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"policy scan kernel launch failed: {lib.ktt_policy_error_string(rc).decode()}"
        )
    nodes["svc_counts"].copy_(counts.t())
    return choice


def _launch(pods: Tensors, nodes: Tensors, weights, lspec: LoweredSpec, plan=None):
    from kubernetes_tpu_torch.ops import build

    lib = build.load("policy_scan_kernel", _bind)
    device = pods["cpu"].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        choice = _call(lib, pods, nodes, weights, lspec, stream, plan)
    policy_scan_with_state.launches += 1
    return choice, nodes


def plain_policy_scan_with_state(
    pods: Tensors, nodes: Tensors, weights, lspec: LoweredSpec
) -> Tuple[torch.Tensor, Tensors]:
    """The kernel's plain PyTorch version: `ops/solver.py`'s per-pod
    loop under `lspec`, on any device. Updates `nodes` in place like the
    kernel."""
    from kubernetes_tpu_torch.ops.solver import _scan_solve

    return _scan_solve(pods, nodes, weights, lspec), nodes


def policy_scan_with_state(
    pods: Tensors, nodes: Tensors, weights, lspec: LoweredSpec
) -> Tuple[torch.Tensor, Tensors]:
    """Policy-spec sequential solve: (choice i32[P], nodes), with the
    carry tensors of `nodes` (the service carry included) updated in
    place. CUDA tensors launch the kernel (or raise); CPU tensors run
    the plain version."""
    device = pods["cpu"].device
    if device.type == "cuda":
        return _launch(pods, nodes, weights, lspec)
    if device.type == "cpu":
        return plain_policy_scan_with_state(pods, nodes, weights, lspec)
    raise ValueError(f"policy scan kernel: unsupported device {device}")


#: Kernel launches made by this wrapper (a plain counter callers may reset).
policy_scan_with_state.launches = 0
