"""Host snapshot -> device tensors.

The counterpart of `kubernetes_tpu/ops/matrices.py` on one torch device:
the columnar Snapshot (`models/columnar.py`) becomes dicts of tensors
with the JAX package's keys, padding buckets and fills. Pod-axis
padding rows are pinned to -2 (they never fit); padding nodes are
unschedulable.

Bitset words (`sel`, `port`, `vol_any`, `vol_rw`, `labels`, `uport`,
`uvol_any`, `uvol_rw`) are u32 on the host and in the JAX package.
torch's uint32 lacks most operators, so on the device they are int32
tensors holding the same bits (`np.ndarray.view(np.int32)`);
`state_to_numpy` views them back as u32.

There is no counterpart of `host_mesh` / `shardings_for`: the port runs
on one card, and node-axis sharding over several is later work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch import DeviceLike, resolve_device
from kubernetes_tpu_torch.models.algspec import DEFAULT_LOWERED, LoweredSpec
from kubernetes_tpu_torch.models.columnar import Snapshot

#: Keys whose columns are u32 bitset words on the host.
BITSET_KEYS = frozenset(
    ("sel", "port", "vol_any", "vol_rw", "labels", "uport", "uvol_any", "uvol_rw")
)

#: The occupancy carry a solve updates, in the order the tests compare it.
CARRY_KEYS = (
    "cpu_fit", "mem_fit", "cpu_used", "mem_used", "pods_used",
    "uport", "uvol_any", "uvol_rw", "svc_counts",
)


def _pad(arr: np.ndarray, n: int, fill=0) -> np.ndarray:
    """Pad axis 0 to length n."""
    if arr.shape[0] == n:
        return arr
    pad_width = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, constant_values=fill)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if x > 0 else m


def pow2_bucket(n: int, minimum: int = 128) -> int:
    """Next power-of-two bucket >= n (>= minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _pod_axis_bucket(n: int, minimum: int) -> int:
    """Pod-axis padding target: power-of-two buckets up to 8192, then
    multiples of 1024 (the JAX package's buckets, kept so both packages
    scan the same padded pod axis)."""
    if n <= 8192:
        return pow2_bucket(n, minimum)
    return _round_up(n, 1024)


def _pad_cols(arr: np.ndarray, m: int) -> np.ndarray:
    """Pad axis 1 up to a multiple of m."""
    cols = arr.shape[1]
    target = _round_up(cols, m)
    if cols == target:
        return arr
    return np.pad(arr, [(0, 0), (0, target - cols)])


def _as_tensor(key: str, arr: np.ndarray) -> torch.Tensor:
    """Host column -> CPU tensor, bitset words viewed as int32."""
    arr = np.ascontiguousarray(arr)
    if key in BITSET_KEYS:
        arr = arr.astype(np.uint32, copy=False).view(np.int32)
    return torch.from_numpy(arr)


def _put(arrs: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """Host columns -> device tensors. On a card each copy starts from
    pinned memory without blocking the host, so staging the next chunk
    overlaps the kernel still running on the stream. All-zero leaves (a
    fresh backlog's svc_counts is N x S f32, about 10 MB at 5k x 500)
    are made on the device instead of copied."""
    out = {}
    for key, arr in arrs.items():
        if arr.size > 4096 and not arr.any():
            t = _as_tensor(key, arr[:0])
            out[key] = torch.zeros(arr.shape, dtype=t.dtype, device=device)
            continue
        t = _as_tensor(key, arr)
        if device.type == "cuda":
            out[key] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[key] = t.to(device)
    return out


@dataclass
class DeviceSnapshot:
    """Device-resident scheduling problem. `pods`/`nodes` are dicts of
    tensors; padded entries are masked off (pods: pinned == -2 never
    fits anywhere; nodes: sched == False)."""

    pods: Dict[str, torch.Tensor]
    nodes: Dict[str, torch.Tensor]
    n_pods: int  # real (unpadded) counts
    n_nodes: int
    lowered: LoweredSpec = DEFAULT_LOWERED
    weights: Tuple[int, int, int] = (1, 1, 1)

    @property
    def pod_count_padded(self) -> int:
        return int(self.pods["cpu"].shape[0])


# Minor dims are bucketed like the JAX package: bitset widths to pairs of
# u32 words, the service axis to 128.
WORD_BUCKET, SVC_BUCKET = 2, 128


def device_pods(p, device: DeviceLike = None, pad_to: int = 128) -> Dict[str, torch.Tensor]:
    """PodColumns -> device dict (axis 0 padded to the pod bucket)."""
    P = p.count
    PP = _pod_axis_bucket(P, pad_to)
    sel_rows = (
        p.sel_bits[p.selector_id]
        if P
        else np.zeros((0, p.sel_bits.shape[1]), np.uint32)
    )
    pods = {
        "cpu": _pad(p.cpu_milli, PP),
        "mem": _pad(p.mem_mib, PP),
        "zero_req": _pad(p.zero_req, PP, fill=False),
        "sel": _pad(_pad_cols(sel_rows, WORD_BUCKET), PP),
        "port": _pad(_pad_cols(p.port_bits, WORD_BUCKET), PP),
        "vol_any": _pad(_pad_cols(p.vol_any_bits, WORD_BUCKET), PP),
        "vol_rw": _pad(_pad_cols(p.vol_rw_bits, WORD_BUCKET), PP),
        # Padding pods are pinned to -2 (an impossible node) so they
        # always come back unassigned.
        "pinned": _pad(p.pinned_node, PP, fill=-2),
        "svc": _pad(p.service_id, PP, fill=-1),
        "svc_ids": _pad(p.svc_topk, PP, fill=-1),
    }
    if p.aff_pin is not None:
        pods["aff_pin"] = _pad(p.aff_pin, PP, fill=-1)
    return _put(pods, resolve_device(device))


def device_nodes(n, device: DeviceLike = None, pad_to: int = 128) -> Dict[str, torch.Tensor]:
    """NodeColumns -> device dict (axis 0 padded to a pad_to multiple)."""
    NP = _round_up(n.count, pad_to)
    nodes = {
        "cpu_cap": _pad(n.cpu_cap, NP),
        "mem_cap": _pad(n.mem_cap, NP),
        "pods_cap": _pad(n.pods_cap, NP),
        "cpu_fit": _pad(n.cpu_fit_used, NP),
        "mem_fit": _pad(n.mem_fit_used, NP),
        "over": _pad(n.overcommitted, NP, fill=False),
        "cpu_used": _pad(n.cpu_used, NP),
        "mem_used": _pad(n.mem_used, NP),
        "pods_used": _pad(n.pods_used, NP),
        "labels": _pad(_pad_cols(n.label_bits, WORD_BUCKET), NP),
        "uport": _pad(_pad_cols(n.used_port_bits, WORD_BUCKET), NP),
        "uvol_any": _pad(_pad_cols(n.used_vol_any_bits, WORD_BUCKET), NP),
        "uvol_rw": _pad(_pad_cols(n.used_vol_rw_bits, WORD_BUCKET), NP),
        "svc_counts": _pad(_pad_cols(n.service_counts, SVC_BUCKET), NP),
        # Padding nodes are unschedulable -> never chosen.
        "sched": _pad(n.schedulable, NP, fill=False),
    }
    if n.policy_ok is not None:
        nodes["policy_ok"] = _pad(n.policy_ok, NP, fill=False)
    if n.static_prio is not None:
        nodes["static_prio"] = _pad(n.static_prio, NP)
    if n.aff_vid is not None:
        nodes["aff_vid"] = _pad(n.aff_vid, NP, fill=-1)
    if n.aa_zone is not None:
        nodes["aa_zone"] = _pad(n.aa_zone, NP, fill=-1)
    return _put(nodes, resolve_device(device))


def device_snapshot(
    snap: Snapshot, device: DeviceLike = None, pad_to: int = 128
) -> DeviceSnapshot:
    device = resolve_device(device)
    nodes = device_nodes(snap.nodes, device, pad_to=pad_to)
    if snap.anchor_init is not None:
        # ServiceAffinity/AntiAffinity carry seeds plus one scratch slot
        # (the last index), as the JAX package stages them.
        SP = _round_up(max(snap.anchor_init.shape[0], 1), SVC_BUCKET)
        anchor = np.full(SP + 1, -1, dtype=np.int32)
        anchor[: snap.anchor_init.shape[0]] = snap.anchor_init
        total = np.zeros(SP + 1, dtype=np.float32)
        total[: snap.svc_total_init.shape[0]] = snap.svc_total_init
        nodes.update(_put({"anchor": anchor, "svc_total": total}, device))
    return DeviceSnapshot(
        pods=device_pods(snap.pods, device, pad_to=pad_to),
        nodes=nodes,
        n_pods=snap.pods.count,
        n_nodes=snap.nodes.count,
        lowered=snap.lowered or DEFAULT_LOWERED,
        weights=snap.weights or (1, 1, 1),
    )


def state_from_numpy(
    pods: Dict[str, np.ndarray],
    nodes: Dict[str, np.ndarray],
    device: DeviceLike = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The JAX package's DeviceSnapshot dicts (taken with np.asarray) ->
    the port's tensors: the same keys and values, bitsets as int32 words.
    Every tensor is a fresh copy the solver may update in place."""
    device = resolve_device(device)
    to = lambda d: {k: _as_tensor(k, np.array(v)).to(device) for k, v in d.items()}
    return to(pods), to(nodes)


def state_to_numpy(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's tensors -> numpy with the JAX package's dtypes
    (bitset words back to u32)."""
    out = {}
    for k, t in tensors.items():
        a = t.detach().cpu().numpy()
        out[k] = a.view(np.uint32) if k in BITSET_KEYS else a
    return out
