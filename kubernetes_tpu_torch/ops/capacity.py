"""The capacity report: cluster headroom, stranded capacity and slice
allocatability as one dense pass.

The counterpart of `kubernetes_tpu/ops/capacity.py`, in plain PyTorch:
it is one elementwise pass over a probe x node block and a few sums,
with no chain of steps, so it needs no hand kernel. Inputs are the eight
occupancy columns (`cpu_cap, mem_cap, pods_cap, cpu_fit, mem_fit,
pods_used` f32, `over, sched` bool; what either package's
`cluster_columns` or a session's `h` holds) and the probe shapes
(`probe_cpu, probe_mem` f32, `probe_min` i32, `probe_live` bool), as
NumPy arrays or tensors, in the JAX function's order. For each probe:

- `fit_int[q, n]`: probes of shape q node n still hosts (integral, per
  resource, min with its free pod slots, clipped to FIT_CAP);
- `headroom[q]`: their sum over live nodes; for identical members it is
  the largest gang of that shape placeable now, so `slice_ok` is
  `headroom >= minMember`;
- `frag[q]`: the share of the free capacity, in probe units quantised
  to 1/FRAC_Q, that no single node can host;
- `frag_score`: the capacity-weighted aggregate over live probes, and
  `stranded[n]` the live nodes with free cpu or memory that host no
  probe of any live shape.

Exactness: every sum across nodes or probes is int32 (fits clipped to
FIT_CAP, fractions quantised to 1/FRAC_Q), so the order of a reduction
cannot change a bit, and the float work is elementwise IEEE f32. The
outputs equal the JAX function's and its NumPy twin's bit for bit, with
the JAX dtypes: `torch.sum` promotes int32 to int64, so each sum is cast
back (int32 wraps, as XLA's does). The pods column reads 0 as no slot
here (preemption reads it as unlimited, the solver as no limit).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from kubernetes_tpu_torch import DeviceLike, resolve_device

#: Fractional fits are quantised to 1/FRAC_Q probe units (int32).
FRAC_Q = 16

#: Per-node fit clip: keeps the quantised cross-node sums inside int32.
FIT_CAP = 2.0**13

#: Stand-in for an unconstrained per-resource fit (a zero-request
#: probe) before the min with the pods allowance and FIT_CAP.
BIG_FIT = 2.0**20

NODE_COLUMNS = ("cpu_cap", "mem_cap", "pods_cap", "cpu_fit", "mem_fit", "pods_used", "over", "sched")
_NODE_DTYPES = (torch.float32,) * 6 + (torch.bool,) * 2
_PROBE_DTYPES = (torch.float32, torch.float32, torch.int32, torch.bool)


def as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A NumPy array, a tensor or a scalar as a contiguous tensor of
    `dtype` on `device` (a copy only where needed)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.ascontiguousarray(np.asarray(x)), device=device).to(dtype).contiguous()


def stage(args, dtypes, device: torch.device):
    return tuple(as_tensor(a, d, device) for a, d in zip(args, dtypes))


def isum(x: torch.Tensor, dim=None) -> torch.Tensor:
    """An int32 sum that wraps like XLA's (torch sums int32 in int64)."""
    s = x.sum(dtype=torch.int64) if dim is None else x.sum(dim=dim, dtype=torch.int64)
    return s.to(torch.int32)


def node_fits(free_cpu, free_mem, free_pods, probe_cpu, probe_mem) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-probe integral and quantised fits (i32[..., Q, N]) of free
    vectors: the JAX function's fit arithmetic, operation by operation."""
    f0 = torch.tensor(0.0, dtype=torch.float32, device=free_cpu.device)
    f1 = torch.tensor(1.0, dtype=torch.float32, device=free_cpu.device)
    big = torch.tensor(BIG_FIT, dtype=torch.float32, device=free_cpu.device)
    pc = probe_cpu[:, None]
    pm = probe_mem[:, None]
    per_cpu = torch.where(pc > f0, free_cpu[..., None, :] / torch.maximum(pc, f1), big)
    per_mem = torch.where(pm > f0, free_mem[..., None, :] / torch.maximum(pm, f1), big)
    fit_frac = torch.minimum(torch.minimum(per_cpu, per_mem), free_pods[..., None, :])
    fit_frac = torch.clamp(fit_frac, 0.0, FIT_CAP)
    fit_int = torch.floor(fit_frac).to(torch.int32)
    frac_q = torch.floor(fit_frac * torch.tensor(FRAC_Q, dtype=torch.float32)).to(torch.int32)
    return fit_int, frac_q


def free_vectors(cpu_cap, mem_cap, pods_cap, cf, mf, pu, livef):
    """Free cpu, memory and slots of an occupancy state, 0 on dead nodes."""
    f0 = torch.tensor(0.0, dtype=torch.float32, device=cpu_cap.device)
    return (
        torch.maximum(cpu_cap - cf, f0) * livef,
        torch.maximum(mem_cap - mf, f0) * livef,
        torch.maximum(pods_cap - pu, f0) * livef,
    )


def score_ratio(usable: torch.Tensor, potential: torch.Tensor) -> torch.Tensor:
    """1 - usable * FRAC_Q / potential in f32, clipped to [0, 1]; 0
    where potential is not positive."""
    q = torch.tensor(float(FRAC_Q), dtype=torch.float32, device=usable.device)
    ratio = 1.0 - (usable.to(torch.float32) * q) / potential.to(torch.float32)
    out = torch.where(potential > 0, ratio, torch.zeros_like(ratio))
    return torch.clamp(out, 0.0, 1.0)


def capacity_report(cpu_cap, mem_cap, pods_cap, cpu_fit, mem_fit, pods_used, over, sched,
                    probe_cpu, probe_mem, probe_min, probe_live, device: DeviceLike = None):
    """The capacity plane's one dense pass on `device` (default: the
    CUDA card; raises without one). Returns the JAX function's tuple:

    ``(util_cpu f32[N], util_mem f32[N], util_pods f32[N],
    fit_int i32[Q,N], headroom i32[Q], frag f32[Q], slice_ok bool[Q],
    stranded bool[N], frag_score f32[], stranded_cpu f32[],
    stranded_mem f32[])``
    """
    device = resolve_device(device)
    cpu_cap, mem_cap, pods_cap, cpu_fit, mem_fit, pods_used, over, sched = stage(
        (cpu_cap, mem_cap, pods_cap, cpu_fit, mem_fit, pods_used, over, sched),
        _NODE_DTYPES, device)
    probe_cpu, probe_mem, probe_min, probe_live = stage(
        (probe_cpu, probe_mem, probe_min, probe_live), _PROBE_DTYPES, device)

    live = sched & ~over
    livef = live.to(torch.float32)
    free_cpu, free_mem, free_pods = free_vectors(
        cpu_cap, mem_cap, pods_cap, cpu_fit, mem_fit, pods_used, livef)

    def util(used_part, cap):
        ratio = torch.clamp(used_part / torch.clamp(cap, min=1.0), 0.0, 1.0)
        return torch.where((cap > 0.0) & live, ratio, torch.zeros_like(ratio))

    util_cpu = util(cpu_fit, cpu_cap)
    util_mem = util(mem_fit, mem_cap)
    util_pods = util(pods_used, pods_cap)

    fit_int, frac_q = node_fits(free_cpu, free_mem, free_pods, probe_cpu, probe_mem)
    plive = probe_live.to(torch.int32)
    usable = isum(fit_int, 1) * plive
    potential = isum(frac_q, 1) * plive
    headroom = usable
    frag = score_ratio(usable, potential) * probe_live.to(torch.float32)
    slice_ok = probe_live & (headroom >= torch.clamp(probe_min, min=1))

    frag_score = score_ratio(isum(usable), isum(potential))

    hosts_any = ((fit_int > 0) & probe_live[:, None]).any(dim=0)
    stranded = live & ((free_cpu > 0.0) | (free_mem > 0.0)) & ~hosts_any & probe_live.any()

    def stranded_frac(free):
        free_i = free.to(torch.int32)
        tot = isum(free_i)
        strand = isum(free_i * stranded.to(torch.int32))
        ratio = strand.to(torch.float32) / tot.to(torch.float32)
        return torch.where(tot > 0, ratio, torch.zeros_like(ratio))

    return (
        util_cpu, util_mem, util_pods, fit_int, headroom, frag, slice_ok, stranded,
        frag_score, stranded_frac(free_cpu), stranded_frac(free_mem),
    )
