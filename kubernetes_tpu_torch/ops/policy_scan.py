"""The policy-spec sequential solve as one CUDA kernel launch ("K1P")
on one thread-block cluster.

Replaces the XLA scan the JAX package runs for a policy LoweredSpec
(`kubernetes_tpu/ops/solver.py:304 _scan_solve` under `_solve_xla` /
`_solve_with_state_xla`; it is not a Pallas kernel, because
`pallas_eligible` refuses every non-default spec). The kernel is
`csrc/policy_scan_kernel.cu`; this module plans, checks and binds it.

What bounds it: as for the scan kernel, P dependent steps, each a chain
of latencies (an N-wide evaluation, a cluster-wide max, a commit), with
a second cluster barrier on a step whose ServiceAntiAffinity zone sums
over the feasible nodes must exist before any node is scored. It is
neither bytes nor operations. The design is the scan kernel's: one
cluster of C CTAs, each holding its slice of the node axis (constants,
policy columns, carry) in shared memory, the count rows fetched ahead by
cp.async, the winner and the next pod's max count chosen through slots
stored into every CTA by distributed shared memory; the service carry
(anchor, svc_total) replicated in every CTA; each CTA's partial zone
bins added by DSMEM atomics into the one [zone_bins] sum array of every
CTA.

The spec travels as a runtime flag word (`FLAG_*`, the kernel's
constants) with the weights and the anti-affinity instances (the first
`ARG_AA` in the launch arguments, any further ones as (weight, zones,
first bin) triples in a small device array), so one compiled kernel
serves every policy. `launch_plan` is pure
Python, by the same layout as the kernel's `make_layout`: it takes the
largest cluster, up to 16 CTAs, whose shared memory holds the slices,
the count rows and the zone sums ("resident"), else at that size the
same kernel keeping all of those in device memory ("in place"), which
needs no shared memory that grows with the nodes or the zone bins,
else a smaller cluster. A CTA's shared memory does not grow
with C, so only a service carry too large to replicate lowers C, down
to 1, where the carry stays in device memory. The kernel takes any number of
anti-affinity instances and affinity labels; what remains is shared
memory, and a plan that cannot fit it (pod rows of thousands of words)
raises ValueError before any launch. Nothing falls back to the plain
version.

The wrapper checks device, dtype, shape and contiguity, packs the pod
columns into one (P, row_words) int32 matrix padded to whole 16-byte
chunks, converts the service counts between the JAX layout (N, S) f32
and the kernel's (S, NS) int32, allocates the in-place spill (the
scores before the zones, the feasibility, two buffers of zone sums),
launches on the current stream and
raises if the launch failed. It never synchronises. CPU tensors go to
the plain version, the per-pod loop of `ops/solver.py`; no CUDA tensor
ever does.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from kubernetes_tpu_torch.models.algspec import LoweredSpec
from kubernetes_tpu_torch.ops import ledger
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

#: ServiceAntiAffinity instances whose terms travel in the launch
#: arguments (the kernel's kMaxAA); the rest go in a device array.
ARG_AA = 8

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


#: The largest cluster (above 8 the non-portable cluster attribute).
MAX_CLUSTER = 16
#: Pods staged into shared memory per tile: resident, and in place.
TILE = 64
TILE_IN_PLACE = 4
#: Count rows held in shared memory: the pod's and the next three (kRows).
COUNT_ROWS = 4


def smem_bytes(
    N: int, SW: int, PW: int, VW: int, K: int, KA: int, n_prio: int, n_aa: int, SA: int,
    zone_bins: int, cluster: int, resident: bool,
) -> int:
    """Dynamic shared memory of one CTA: the kernel's `make_layout`.
    `resident` keeps the slice's columns, its count rows and the zone
    sums in shared memory, and stages the pod rows 64 at a time;
    otherwise those stay in device memory and the pods come 4 at a
    time. Nothing here grows with the cluster size: with C > 1 the
    zone partials sit beside the sums, a single CTA adds into its sums;
    the service carry is held in every CTA, except by a single CTA in
    place, which works on the device copy."""
    npc = _round_up(-(-N // cluster), 4)
    kept = npc if resident else 0
    row_words = _round_up(_ROW_SCALARS + SW + PW + 2 * VW + K + KA, 4)
    zone = _round_up(4 * zone_bins, 16) if resident else 0
    return (
        4 * kept * (8 + SW + PW + 2 * VW + n_prio + KA + n_aa)  # f32, bitset and policy columns
        + 4 * kept * COUNT_ROWS  # count rows
        + (4 * kept if n_aa else 0)  # score before the zones
        + 2 * 4 * (TILE if resident else TILE_IN_PLACE) * row_words  # pod tiles
        + 32 * (8 + 4)  # a key and a max count per warp
        + 2 * MAX_CLUSTER * 16  # slots: [parity][CTA]
        + (2 * 4 * _round_up(SA, 4) if resident or cluster > 1 else 0)  # anchor, svc_total
        + zone * (2 if cluster > 1 else 1)  # zone sums, and the partials
        + _round_up(3 * kept + (kept if n_aa else 0), 16)  # over, sched, policy_ok, feasibility
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
    """How one launch is cut: one cluster of `cluster` CTAs of `threads`
    threads, CTA r owning nodes [r * nodes_per_cta, (r + 1) *
    nodes_per_cta), each with `smem_bytes` of dynamic shared memory and
    its slice's columns, count rows and zone sums held there
    (`resident`) or kept in device memory; the
    service counts have `count_stride` columns, a packed pod row
    `row_words` words, and `zone_bins` is the anti-affinity instances'
    zone vocabularies together."""

    cluster: int
    nodes_per_cta: int
    threads: int
    smem_bytes: int
    count_stride: int
    row_words: int
    zone_bins: int
    resident: bool


def _layout_widths(SW, PW, VW, K, KA, lspec: LoweredSpec, SA: int):
    """smem_bytes' arguments between N and the cluster size."""
    return (SW, PW, VW, K, KA, int(bool(lspec.static_prio)), len(lspec.aa_weights), SA,
            sum(int(z) for z in lspec.aa_zones))


def _check_spec(KA: int, lspec: LoweredSpec) -> None:
    n_aa = len(lspec.aa_weights)
    if len(lspec.aa_zones) != n_aa:
        raise ValueError(
            f"policy scan kernel: {n_aa} anti-affinity weights but {len(lspec.aa_zones)} zone sizes"
        )
    if any(int(z) < 1 for z in lspec.aa_zones):
        raise ValueError(f"policy scan kernel: zone vocabulary sizes {lspec.aa_zones} must be >= 1")


def launch_plan(
    N: int, SW: int, PW: int, VW: int, K: int, KA: int, lspec: LoweredSpec,
    threads: Optional[int] = None, cluster: Optional[int] = None, SA: int = 0,
    resident: Optional[bool] = None,
) -> LaunchPlan:
    """The launch for a node axis of N at these widths under `lspec`,
    with a service carry of SA slots (0: none). By default the largest
    cluster up to 16 CTAs whose shared memory fits, resident where it
    fits and in place where not, and one thread per node of a slice (a
    multiple of 32, at most 1024); `cluster`, `resident` and `threads`
    override them for a test or a sweep. In place needs no shared memory
    that grows with N or the zone bins, and a single CTA none that grows
    with the services: only pod rows of thousands of words could outgrow
    it. Raises ValueError, before any launch, for a spec the kernel
    cannot take, an override that cannot run or such a row. Any number
    of anti-affinity instances and affinity labels plans."""
    _check_spec(KA, lspec)
    widths = _layout_widths(SW, PW, VW, K, KA, lspec, SA)
    if cluster is not None and not 1 <= int(cluster) <= MAX_CLUSTER:
        raise ValueError(f"policy scan kernel: cluster size {cluster} is outside [1, {MAX_CLUSTER}]")
    sizes = range(MAX_CLUSTER, 0, -1) if cluster is None else (int(cluster),)
    kinds = (True, False) if resident is None else (bool(resident),)
    tried = []
    for C in sizes:
        for res in kinds:
            smem = smem_bytes(N, *widths, C, res)
            tried.append(smem)
            if smem > SMEM_LIMIT:
                continue
            npc = _round_up(-(-N // C), 4)
            T = min(MAX_THREADS, max(32, _round_up(npc, 32))) if threads is None else int(threads)
            if T % 32 or not 32 <= T <= MAX_THREADS:
                raise ValueError(
                    f"policy scan kernel: {T} threads per CTA; need a multiple of 32 up to {MAX_THREADS}")
            return LaunchPlan(
                cluster=C, nodes_per_cta=npc, threads=T, smem_bytes=smem,
                count_stride=npc * C,
                row_words=_round_up(_ROW_SCALARS + SW + PW + 2 * VW + K + KA, 4),
                zone_bins=widths[-1], resident=res,
            )
    raise ValueError(
        f"policy scan kernel: N={N} nodes and {widths[-1]} zone bins need at least "
        f"{min(tried)} bytes of shared memory per CTA, over the limit of {SMEM_LIMIT}"
    )


def max_nodes(
    SW: int, PW: int, VW: int, K: int, KA: int, lspec: LoweredSpec, SA: int = 0,
    cluster: int = MAX_CLUSTER,
) -> int:
    """The largest node axis a cluster of this size holds resident (-1:
    none). In place it takes any node axis."""
    widths = _layout_widths(SW, PW, VW, K, KA, lspec, SA)

    def fits(n):
        return smem_bytes(n, *widths, cluster, True) <= SMEM_LIMIT

    if not fits(0):
        return -1
    lo, hi = 0, 1
    while fits(hi):
        lo, hi = hi, hi * 2
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ktt_policy_launch.argtypes = (
        [ptr] * 24 + [i32] * 14
        + [ctypes.POINTER(i32), ctypes.POINTER(i32), ptr, i32, i32, i32, ptr]
    )
    lib.ktt_policy_launch.restype = i32
    lib.ktt_policy_smem_bytes.argtypes = [i32] * 12
    lib.ktt_policy_smem_bytes.restype = i32
    lib.ktt_policy_occupancy.argtypes = [i32] * 13 + [ctypes.POINTER(i32)]
    lib.ktt_policy_occupancy.restype = i32
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


def plan_for(
    pods: Tensors, nodes: Tensors, lspec: LoweredSpec, threads=None, cluster=None, resident=None,
) -> LaunchPlan:
    """`launch_plan` at the shapes of these tensors."""
    d = _dims(pods, nodes, lspec)
    return launch_plan(d["N"], d["SW"], d["PW"], d["VW"], d["K"], d["KA"], lspec, threads,
                       cluster, d["SA"], resident)


def _pod_rows(pods: Tensors, lspec: LoweredSpec, row_words: int) -> torch.Tensor:
    """The pod columns as one (P, row_words) int32 matrix, the f32
    columns by their bits, the affinity pins last, zero-padded to whole
    16-byte chunks."""
    P = pods["cpu"].shape[0]
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
    used = sum(c.shape[1] for c in cols)
    cols.append(torch.zeros((P, row_words - used), dtype=torch.int32, device=pods["cpu"].device))
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
    elif plan != plan_for(pods, nodes, lspec, plan.threads, plan.cluster, plan.resident):
        raise ValueError(f"policy scan kernel: {plan} was made for other shapes")
    P, N, S = dims["P"], dims["N"], dims["S"]
    service_carry = "anchor" in nodes
    w_lr, w_bra, w_spread = (int(w) for w in weights)
    rows = _pod_rows(pods, lspec, plan.row_words)
    counts = torch.zeros((S, plan.count_stride), dtype=torch.int32, device=device)
    counts[:, :N].copy_(nodes["svc_counts"].t())
    choice = torch.empty(P, dtype=torch.int32, device=device)
    # In place, the scores before the zones, the feasibility and two
    # buffers of zone sums live in device memory; the sums start at zero.
    spill = None
    if not plan.resident and lspec.aa_weights:
        spill = torch.zeros(2 * plan.count_stride + 2 * plan.zone_bins, dtype=torch.int32,
                            device=device)

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
    ptrs += [counts.data_ptr(), ptr(nodes, "anchor"), ptr(nodes, "svc_total"),
             None if spill is None else spill.data_ptr(), choice.data_ptr()]
    weights_aa = [int(w) for w in lspec.aa_weights]
    zones_aa = [int(z) for z in lspec.aa_zones]
    n_aa = len(weights_aa)
    aa_w = (ctypes.c_int * max(n_aa, 1))(*weights_aa)
    aa_nz = (ctypes.c_int * max(n_aa, 1))(*zones_aa)
    # Instances past ARG_AA: (weight, zones, first bin) in device memory.
    aa_more = None
    if n_aa > ARG_AA:
        first = [sum(zones_aa[:i]) for i in range(n_aa)]
        triples = [v for i in range(ARG_AA, n_aa) for v in (weights_aa[i], zones_aa[i], first[i])]
        aa_more = torch.tensor(triples, dtype=torch.int32)
        if device.type == "cuda":
            # From pinned memory, so the copy does not wait for the stream.
            aa_more = aa_more.pin_memory().to(device, non_blocking=True)
    rc = lib.ktt_policy_launch(
        *ptrs, P, N, S, dims["SW"], dims["PW"], dims["VW"], dims["K"], dims["KA"], dims["SA"],
        flags_for(lspec, service_carry), w_lr, w_bra, w_spread, n_aa, aa_w, aa_nz,
        None if aa_more is None else aa_more.data_ptr(),
        plan.cluster, plan.threads, int(plan.resident), stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"policy scan kernel launch failed: {lib.ktt_policy_error_string(rc).decode()}"
        )
    nodes["svc_counts"].copy_(counts[:, :N].t())
    return choice


def _load():
    from kubernetes_tpu_torch.ops import build

    return build.load("policy_scan_kernel", _bind)


def occupancy(plan: LaunchPlan, pods: Tensors, nodes: Tensors, lspec: LoweredSpec) -> int:
    """cudaOccupancyMaxActiveClusters for this plan on the current card."""
    lib = _load()
    d = _dims(pods, nodes, lspec)
    widths = _layout_widths(d["SW"], d["PW"], d["VW"], d["K"], d["KA"], lspec, d["SA"])
    active = ctypes.c_int(0)
    rc = lib.ktt_policy_occupancy(d["N"], *widths, plan.cluster, int(plan.resident),
                                  plan.threads, ctypes.byref(active))
    if rc != 0:
        raise RuntimeError(
            f"policy scan kernel occupancy query failed: {lib.ktt_policy_error_string(rc).decode()}"
        )
    return active.value


def cost(P: int, N: int, S: int, SW: int, PW: int, VW: int, K: int, KA: int, I: int, SA: int,
         placeable: Optional[int] = None) -> Dict[str, int]:
    """What one launch must do, the count PERF.md's bound uses: the scan
    kernel's bytes plus the affinity pins, the policy columns (policy_ok
    1 B, static_prio, aff_vid, aa_zone 4 B each) and the service carry
    in and out; its 32-bit operations a (pod, node) pair plus the label
    mask 1, the static priority 1, 3 an affinity label and 10 an
    anti-affinity instance (zone test and sum, the zone's count, the
    score's division and select, the weighted add), over the
    `placeable` pods (default: all P rows)."""
    placeable = P if placeable is None else placeable
    pod_bytes = P * (4 * 4 + 1 + 4 * (SW + PW + 2 * VW + K + KA))
    const_bytes = N * (3 * 4 + 2 + 4 * SW + 1 + 4 + 4 * KA + 4 * I)
    carry_bytes = N * (5 * 4 + 4 * (PW + 2 * VW) + 4 * S) + 8 * SA
    ops_per_pair = 13 + 2 + 4 + 12 + 14 + 4 + 5 + 3 + 2 * SW + 2 * PW + 4 * VW
    ops_per_pair += 2 + 3 * KA + 10 * I
    return {"flops": placeable * N * ops_per_pair,
            "bytes_accessed": pod_bytes + const_bytes + 2 * carry_bytes + 4 * P}


def _note(impl: str, pods: Tensors, nodes: Tensors, lspec: LoweredSpec) -> None:
    """One call into the kernel ledger, keyed by the launch's shapes."""
    d = _dims(pods, nodes, lspec)
    sig = "P={P},N={N},S={S},SW={SW},PW={PW},VW={VW},K={K},KA={KA},I={I},SA={SA}".format(**d)
    ledger.DEFAULT.note_call("policy_scan_kernel", impl, sig, lambda: cost(**d))


def _launch(pods: Tensors, nodes: Tensors, weights, lspec: LoweredSpec, plan=None):
    lib = _load()
    device = pods["cpu"].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        choice = _call(lib, pods, nodes, weights, lspec, stream, plan)
    policy_scan_with_state.launches += 1
    _note("cuda", pods, nodes, lspec)
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
        _note("plain", pods, nodes, lspec)
        return plain_policy_scan_with_state(pods, nodes, weights, lspec)
    raise ValueError(f"policy scan kernel: unsupported device {device}")


#: Kernel launches made by this wrapper (a plain counter callers may reset).
policy_scan_with_state.launches = 0
