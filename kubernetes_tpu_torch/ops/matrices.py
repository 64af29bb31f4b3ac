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

The node axis may be sharded over a `Mesh` (`host_mesh`), as the JAX
package shards it over a `jax.sharding.Mesh`. The mesh is
single-controller, as JAX's is: one process drives every shard, each
shard's node tensors live on its device, and the cross-shard reductions
of the solvers are small copies into the mesh's first device. A sharded
node dict is a `ShardedNodes`; the pod tensors stay whole.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch import DeviceLike, resolve_device
from kubernetes_tpu_torch.models.algspec import DEFAULT_LOWERED, LoweredSpec
from kubernetes_tpu_torch.models.columnar import Snapshot
from kubernetes_tpu_torch.utils import sli

#: Keys whose columns are u32 bitset words on the host.
BITSET_KEYS = frozenset(
    ("sel", "port", "vol_any", "vol_rw", "labels", "uport", "uvol_any", "uvol_rw")
)

#: The occupancy carry a solve updates, in the order the tests compare it.
CARRY_KEYS = (
    "cpu_fit", "mem_fit", "cpu_used", "mem_used", "pods_used",
    "uport", "uvol_any", "uvol_rw", "svc_counts",
)

#: The ServiceAffinity/AntiAffinity carry a policy solve adds (per
#: service plus a scratch slot): the first peer's node and the peer count.
POLICY_CARRY_KEYS = ("anchor", "svc_total")

#: Predicate bit positions in the explain readback's packed per-node
#: failure mask (`ops.solver.explain_rows`; bit set = the predicate
#: rejected the node), in the solver's order, under the reference's
#: FitPredicate names, plus NodeSchedulable, the ready/unschedulable
#: node filter that runs before the predicates (factory.go:166,209).
EXPLAIN_PREDICATES = (
    "NodeSchedulable",
    "PodFitsResources",
    "MatchNodeSelector",
    "PodFitsPorts",
    "NoDiskConflict",
    "HostName",
)


def decode_predicate_bits(bits: int) -> list:
    """Failed-predicate names for one node's packed verdict mask."""
    return [name for i, name in enumerate(EXPLAIN_PREDICATES) if bits & (1 << i)]


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
    are made on the device instead of copied. The bytes that do move
    are noted as the h2d transfer (`utils/sli.py`), as the JAX
    package's `_put_tree` notes them."""
    out = {}
    moved = 0
    for key, arr in arrs.items():
        if arr.size > 4096 and not arr.any():
            t = _as_tensor(key, arr[:0])
            out[key] = torch.zeros(arr.shape, dtype=t.dtype, device=device)
            continue
        moved += arr.nbytes
        t = _as_tensor(key, arr)
        if device.type == "cuda":
            out[key] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[key] = t.to(device)
    sli.note_transfer("h2d", moved)
    return out


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the node axis, driven from one process: shard s
    lives on `devices[s]`. The counterpart of the JAX package's
    `jax.sharding.Mesh` from `host_mesh`, with its `shape` and
    `axis_names`. Unlike JAX's, one device may hold several shards
    (`host_mesh(n, devices=...)`)."""

    devices: Tuple[torch.device, ...]
    axis: str = "nodes"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: self.size}

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (self.axis,)

    @property
    def first(self) -> torch.device:
        """The device that holds the pod tensors and takes the
        cross-shard reductions."""
        return self.devices[0]

    def ranges(self, n_padded: int) -> Tuple[Tuple[int, int], ...]:
        """Each shard's global node range [lo, hi) of a padded node axis:
        contiguous and equal, as JAX's sharding cuts it."""
        if n_padded % self.size:
            raise ValueError(
                f"a node axis of {n_padded} does not divide over {self.size} shards")
        per = n_padded // self.size
        return tuple((s * per, (s + 1) * per) for s in range(self.size))


class ShardedNodes:
    """A node dict cut along the node axis over a `Mesh`: `shards[s]`
    holds the global rows `ranges[s]` = [lo, hi) of every node-axis
    tensor, on `mesh.devices[s]`, under the unsharded dict's keys. The
    per-service carry (`anchor`, `svc_total`) is whole in every shard.
    The solvers take it wherever they take a node dict
    (`ops/solver.py`, `ops/wave.py`, `ops/sinkhorn.py`)."""

    def __init__(self, mesh: Mesh, shards: List[Dict[str, torch.Tensor]]):
        self.mesh = mesh
        self.shards = shards
        ranges, lo = [], 0
        for shard in shards:
            hi = lo + int(shard["cpu_cap"].shape[0])
            ranges.append((lo, hi))
            lo = hi
        self.ranges: Tuple[Tuple[int, int], ...] = tuple(ranges)

    @property
    def n_padded(self) -> int:
        return self.ranges[-1][1]

    def keys(self):
        return self.shards[0].keys()

    def items_of(self, key: str) -> List[torch.Tensor]:
        """Every shard's tensor of one key, in shard order."""
        return [shard[key] for shard in self.shards]

    def with_carry_cloned(self) -> "ShardedNodes":
        """The same shards with their carry tensors cloned, for a solve
        that leaves this state as it was."""
        carry = CARRY_KEYS + POLICY_CARRY_KEYS
        return ShardedNodes(self.mesh, [
            {k: (v.clone() if k in carry else v) for k, v in shard.items()}
            for shard in self.shards
        ])

    def stitched(self, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """The unsharded dict on `device` (default: the mesh's first):
        the shards' rows in order, the per-service carry from shard 0."""
        device = self.mesh.first if device is None else resolve_device(device)
        return {
            k: (self.shards[0][k].to(device) if k in POLICY_CARRY_KEYS
                else torch.cat([t.to(device) for t in self.items_of(k)]))
            for k in self.keys()
        }


def shard_nodes(nodes: Dict[str, torch.Tensor], mesh: Mesh) -> ShardedNodes:
    """An unsharded node dict cut over `mesh`: each shard's rows copied
    to its device (fresh tensors, so the shards never alias the input),
    the per-service carry copied whole to every shard."""
    ranges = mesh.ranges(int(nodes["cpu_cap"].shape[0]))
    return ShardedNodes(mesh, [
        {k: (v if k in POLICY_CARRY_KEYS else v[lo:hi]).to(dev, copy=True).contiguous()
         for k, v in nodes.items()}
        for dev, (lo, hi) in zip(mesh.devices, ranges)
    ])


@dataclass
class DeviceSnapshot:
    """Device-resident scheduling problem. `pods`/`nodes` are dicts of
    tensors; padded entries are masked off (pods: pinned == -2 never
    fits anywhere; nodes: sched == False). On a mesh `nodes` is a
    `ShardedNodes` and `pods` lives on the mesh's first device."""

    pods: Dict[str, torch.Tensor]
    nodes: Dict[str, torch.Tensor]
    n_pods: int  # real (unpadded) counts
    n_nodes: int
    lowered: LoweredSpec = DEFAULT_LOWERED
    weights: Tuple[int, int, int] = (1, 1, 1)
    mesh: Optional[Mesh] = None

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


def device_nodes(
    n, device: DeviceLike = None, pad_to: int = 128, mesh: Optional[Mesh] = None
):
    """NodeColumns -> device dict (axis 0 padded to a pad_to multiple).
    On a mesh the axis pads to `node_axis_multiple(mesh, pad_to)`, so
    it divides evenly over the shards (the padding nodes, unschedulable,
    sit at its end, on the last shards), and a `ShardedNodes` comes
    back, each shard's rows staged straight to its device."""
    NP = _round_up(n.count, node_axis_multiple(mesh, pad_to))
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
    if mesh is None:
        return _put(nodes, resolve_device(device))
    return ShardedNodes(mesh, [
        _put({k: v[lo:hi] for k, v in nodes.items()}, dev)
        for dev, (lo, hi) in zip(mesh.devices, mesh.ranges(NP))
    ])


def node_axis_multiple(mesh: Optional[Mesh], pad_to: int = 128) -> int:
    """Node-axis padding multiple: must divide evenly across mesh shards
    (the JAX package's rule: the larger of pad_to and the mesh size)."""
    if mesh is None:
        return pad_to
    return max(pad_to, mesh.size)


def host_mesh(
    n: int, axis: str = "nodes", devices: Optional[Sequence[DeviceLike]] = None
) -> Optional[Mesh]:
    """The mesh constructor: a 1-D mesh over the first `n` visible CUDA
    devices, or None when a mesh is not viable (n < 2, or fewer than n
    devices), as the JAX package's `host_mesh` over `jax.devices()`.

    `devices` departs from JAX: it names the shards' devices itself, and
    one device may hold several shards. The CPU tests pass
    `("cpu",) * n`; on one card `("cuda:0",) * n` runs every shard, and
    the cross-shard reductions, on that card. None again when it names
    fewer than n devices."""
    if n < 2:
        return None
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < n:
            return None
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if len(devices) < n:
        return None
    return Mesh(tuple(devices[:n]), axis)


def shardings_for(mesh: Optional[Mesh], device: DeviceLike = None):
    """(node placement, pod placement) for a mesh: the shards' devices
    and the mesh's first device; without one, `device` (default: the
    card) for both."""
    if mesh is not None:
        return mesh.devices, mesh.first
    device = resolve_device(device)
    return device, device


def device_snapshot(
    snap: Snapshot, device: DeviceLike = None, pad_to: int = 128,
    mesh: Optional[Mesh] = None,
) -> DeviceSnapshot:
    """Stage a snapshot on `device`, or over `mesh` (then `device` is
    not read): node tensors sharded, pod tensors on the mesh's first
    device, the per-service carry whole in every shard."""
    node_devices, pod_device = shardings_for(mesh, device)
    nodes = device_nodes(snap.nodes, pod_device, pad_to=pad_to, mesh=mesh)
    if snap.anchor_init is not None:
        # ServiceAffinity/AntiAffinity carry seeds plus one scratch slot
        # (the last index), as the JAX package stages them.
        SP = _round_up(max(snap.anchor_init.shape[0], 1), SVC_BUCKET)
        anchor = np.full(SP + 1, -1, dtype=np.int32)
        anchor[: snap.anchor_init.shape[0]] = snap.anchor_init
        total = np.zeros(SP + 1, dtype=np.float32)
        total[: snap.svc_total_init.shape[0]] = snap.svc_total_init
        carry = {"anchor": anchor, "svc_total": total}
        if mesh is None:
            nodes.update(_put(carry, pod_device))
        else:
            for dev, shard in zip(node_devices, nodes.shards):
                shard.update(_put(carry, dev))
    return DeviceSnapshot(
        pods=device_pods(snap.pods, pod_device, pad_to=pad_to),
        nodes=nodes,
        n_pods=snap.pods.count,
        n_nodes=snap.nodes.count,
        lowered=snap.lowered or DEFAULT_LOWERED,
        weights=snap.weights or (1, 1, 1),
        mesh=mesh,
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
    (bitset words back to u32). A `ShardedNodes` is stitched back in
    shard order."""
    if isinstance(tensors, ShardedNodes):
        tensors = tensors.stitched("cpu")
    out = {}
    for k, t in tensors.items():
        a = t.detach().cpu().numpy()
        out[k] = a.view(np.uint32) if k in BITSET_KEYS else a
    return out


def gang_member_counts(
    placed: torch.Tensor, group_ids: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """Per-group placed-member counts, int32[num_groups], as a masked
    segment sum: `placed` is bool[P], `group_ids` int32[P] with -1 for
    ungrouped and padding rows, which are masked out of the sum. Ids
    past the last group add to it, as the JAX package's clipped
    segment_sum does."""
    mask = placed & (group_ids >= 0)
    idx = group_ids.clamp(0, num_groups - 1).to(torch.int64)
    out = torch.zeros(num_groups, dtype=torch.int32, device=placed.device)
    return out.scatter_add_(0, idx, mask.to(torch.int32))
