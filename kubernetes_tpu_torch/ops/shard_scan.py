"""The node-sharded scan: the default-spec sequential solve over a mesh.

The counterpart of the JAX package's scan on a sharded snapshot
(`kubernetes_tpu/ops/solver.py:304 _scan_solve` under a mesh, which
GSPMD turns into a sharded evaluation and a small all-reduce a pod). The
node tensors are a `matrices.ShardedNodes`; the pod tensors are whole
and copied once to every device of the mesh.

Each pod takes one step on every shard, and the shards meet through one
slot each a step (`SLOT_WORDS` int64: the shard's best key, its max
count of the next pod's first service, and that count at its best
node). Step t of shard s reduces the slots of step t - 1 (the winner,
and the max count pod t's ServiceSpreading divides by), commits pod
t - 1 if s owns the winner, evaluates pod t against its nodes with
global indices and stores its slot of step t. Slots are kept by the
parity of the step, so a step reads what the previous one wrote while
its own shards write the other half. After each step the slots of the
shards on other devices are gathered into the mesh's first device and
the whole half is copied back to every other device: on one device
(every shard on one card, or the CPU tests) there is no copy at all.
Steps t = -1 (the max counts of pod 0's service) and t = P (the last
commit) close the chain: P + 2 steps a shard. Nothing is read back to
the host until the caller reads the choices.

On a card a step is one launch of the shard-step kernel, K1S
(`csrc/shard_scan_kernel.cu`, one block, the scan kernel's arithmetic).
Its plain version, `plain_shard_step`, is the same step in eager
PyTorch over the solver's own helpers; CPU tensors take it. Both give
the unsharded scan's decisions and carry bit for bit. A policy spec on
a mesh is not ported.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Callable, Dict, List, Optional, Tuple

import torch

from kubernetes_tpu_torch.models.algspec import DEFAULT_LOWERED
from kubernetes_tpu_torch.ops import ledger, scan_kernel
from kubernetes_tpu_torch.ops.matrices import ShardedNodes

Tensors = Dict[str, torch.Tensor]

#: int64 words of a shard's slot: key, max count of the next pod's
#: service, that count at the shard's best node.
SLOT_WORDS = 3
#: The most shards one step reduces (the kernel's kMaxShards).
MAX_SHARDS = 64
MAX_THREADS = 1024
INT_MIN = -(2 ** 31)
LLONG_MIN = -(2 ** 63)
_LOW32 = 0xFFFFFFFF

# Pointers the launcher takes: the packed pod rows, the shard's node
# columns but its (n, S) f32 service counts, whose (S, n) int32 copy goes
# in instead, then the slots and the choices.
_N_PTRS = 1 + len(scan_kernel._NODE_SPEC) - 1 + 3
_N_INTS = 16


def _bind(lib: ctypes.CDLL) -> None:
    lib.ktt_shard_step.argtypes = (
        [ctypes.c_void_p] * _N_PTRS + [ctypes.c_int] * _N_INTS + [ctypes.c_void_p]
    )
    lib.ktt_shard_step.restype = ctypes.c_int
    lib.ktt_shard_error_string.argtypes = [ctypes.c_int]
    lib.ktt_shard_error_string.restype = ctypes.c_char_p


def threads_for(n: int) -> int:
    """A step's block: one thread per node of the shard, a multiple of
    32, at most 1,024 (each thread then takes every T-th node)."""
    return min(MAX_THREADS, max(32, -(-n // 32) * 32))


def cost(P: int, N: int, S: int, SW: int, PW: int, VW: int, K: int, shards: int,
         placeable: Optional[int] = None) -> Dict[str, int]:
    """What a sharded solve of P pods over N nodes must do, the count
    PERF.md's bound uses: the scan kernel's `cost` (every input read
    once, every output written once, the same operations a pod and
    node), and the slots each step writes and reads once."""
    c = scan_kernel.cost(P, N, S, SW, PW, VW, K, placeable)
    c["bytes_accessed"] += 2 * 8 * SLOT_WORDS * shards * (P + 1)
    return c


def _note(impl: str, dims: Dict[str, int], n: int, shards: int) -> None:
    """One call into the kernel ledger: a step of a shard of n nodes."""
    sig = "n={},shards={},S={S},SW={SW},PW={PW},VW={VW},K={K}".format(n, shards, **dims)
    ledger.DEFAULT.note_call(
        "shard_scan_kernel", impl, sig,
        lambda: cost(1, n, dims["S"], dims["SW"], dims["PW"], dims["VW"], dims["K"], shards))


def _decode(win: torch.Tensor) -> torch.Tensor:
    """The node a winning key names, int64; -1 when its score is -1
    (no feasible node)."""
    return torch.where((win >> 32) >= 0, _LOW32 - (win & _LOW32), -1)


def plain_shard_step(
    t: int, shard: int, lo: int, pods: Tensors, nodes: Tensors, slots: torch.Tensor,
    choice: Optional[torch.Tensor], weights,
) -> None:
    """One step of one shard in eager PyTorch, the kernel's plain
    version: reduce the slots of step t - 1, commit pod t - 1 if this
    shard owns the winner (and write its choice where `choice` is
    given), then evaluate pod t against the shard's nodes `nodes` (global
    rows lo ..) and store this shard's slot of step t. Updates `nodes`,
    `slots` and `choice` in place and reads nothing back to the host
    (no tensor indexes another as a 0-dim index, which would be read
    back; constants are filled on the device)."""
    from kubernetes_tpu_torch.ops.solver import (
        _commit, _feasible, _scores, _service_counts)

    P = pods["cpu"].shape[0]
    n = nodes["cpu_cap"].shape[0]
    device = nodes["cpu_cap"].device
    m = None
    if t >= 0:
        prev = slots[(t - 1) & 1]
        win = prev[:, 0].max()
        c = _decode(win)
        mx = prev[:, 1].max()
        if t >= 1:
            q = t - 1
            pod_q = {k: v[q] for k, v in pods.items()}
            local = torch.where((c >= lo) & (c < lo + n), c - lo, -1).to(torch.int32)
            _commit(nodes, pod_q, local, torch.arange(n, dtype=torch.int32, device=device))
            if choice is not None:
                choice[q] = c.to(torch.int32)
            if t < P:
                svc = pods["svc"][t]
                row = svc.clamp(0, nodes["svc_counts"].shape[1] - 1)
                adds = ((pods["svc_ids"][q] == row) & (svc >= 0)).sum()
                owner = torch.argmax((prev[:, 0] == win).to(torch.int32))
                owner_count = prev[:, 2].gather(0, owner.view(1))[0]
                mx = torch.where((c >= 0) & (adds > 0), torch.maximum(mx, owner_count + adds), mx)
        m = mx
    if t >= P:
        return
    best = torch.full((), LLONG_MIN, dtype=torch.int64, device=device)
    if t >= 0:
        gidx = torch.arange(lo, lo + n, dtype=torch.int32, device=device)
        pod = {k: v[t] for k, v in pods.items()}
        feas = _feasible(pod, nodes, gidx)
        # Read only where the pod has a service, and then never negative.
        maxc = m.clamp(min=0).to(torch.int32)
        masked = torch.where(feas, _scores(pod, nodes, weights, DEFAULT_LOWERED, feas, maxc), -1)
        keys = masked.to(torch.int64) * (1 << 32) + (_LOW32 - gidx.to(torch.int64))
        best = keys.max()
    next_max = torch.full((), INT_MIN, dtype=torch.int64, device=device)
    best_count = torch.zeros((), dtype=torch.int64, device=device)
    if t + 1 < P:
        svc_n = pods["svc"][t + 1]
        counts = _service_counts(svc_n, nodes).to(torch.int64)
        next_max = torch.where(svc_n >= 0, counts.max(), next_max)
        if t >= 0:
            at_best = counts.gather(0, torch.argmax(keys).view(1))[0]
            best_count = torch.where(svc_n >= 0, at_best, best_count)
    slots[t & 1, shard] = torch.stack([best, next_max, best_count])


class _Chain:
    """The per-shard pieces of one sharded solve and the slots' exchange
    between devices. `steps[s](t)` runs step t of shard s."""

    def __init__(self, pods: Tensors, nodes: ShardedNodes):
        self.mesh = nodes.mesh
        self.devices = list(self.mesh.devices)
        if len(self.devices) > MAX_SHARDS:
            raise ValueError(f"sharded scan: {len(self.devices)} shards; at most {MAX_SHARDS}")
        self.first = self.devices[0]
        self.P = int(pods["cpu"].shape[0])
        self.by_device: Dict[torch.device, List[int]] = {}
        for s, dev in enumerate(self.devices):
            self.by_device.setdefault(dev, []).append(s)
        self.pods = {dev: {k: v.to(dev) for k, v in pods.items()} for dev in self.by_device}
        n = len(self.devices)
        self.slots = {}
        for dev in self.by_device:
            buf = torch.zeros((2, n, SLOT_WORDS), dtype=torch.int64, device=dev)
            buf[:, :, 0] = LLONG_MIN
            self.slots[dev] = buf
        self.choice = torch.full((self.P,), -1, dtype=torch.int32, device=self.first)

    def exchange(self, parity: int) -> None:
        """The slots of this parity whole on every device: the other
        devices' shards gathered into the first device, then that half
        copied to every other device. Nothing on one device."""
        if len(self.by_device) == 1:
            return
        head = self.slots[self.first]
        for dev, shards in self.by_device.items():
            if dev != self.first:
                for s in shards:
                    head[parity, s].copy_(self.slots[dev][parity, s], non_blocking=True)
        for dev in self.by_device:
            if dev != self.first:
                self.slots[dev][parity].copy_(head[parity], non_blocking=True)

    def run(self, steps: List[Callable[[int], None]]) -> torch.Tensor:
        for t in range(-1, self.P + 1):
            for step in steps:
                step(t)
            if t < self.P:
                self.exchange(t & 1)
        return self.choice


def plain_sharded_scan_with_state(
    pods: Tensors, nodes: ShardedNodes, weights=(1, 1, 1)
) -> Tuple[torch.Tensor, ShardedNodes]:
    """The sharded solve with `plain_shard_step` on every shard, on any
    devices: (choice i32[P] on the mesh's first device, nodes), the
    shards' carry updated in place."""
    chain = _Chain(pods, nodes)

    def step_of(s: int, lo: int, shard: Tensors):
        dev = chain.devices[s]
        choice = chain.choice if s == 0 else None
        return lambda t: plain_shard_step(
            t, s, lo, chain.pods[dev], shard, chain.slots[dev], choice, weights)

    steps = [step_of(s, lo, shard)
             for s, ((lo, _), shard) in enumerate(zip(nodes.ranges, nodes.shards))]
    return chain.run(steps), nodes


def kernel_chain(lib: ctypes.CDLL, pods: Tensors, nodes: ShardedNodes, weights,
                 on_launch: Optional[Callable[[int], None]] = None) -> torch.Tensor:
    """The sharded solve through the shard-step launcher of `lib`: check
    the tensors, pack the pod rows once a device, convert each shard's
    service counts to the kernel's (S, n) int32 rows and back, launch
    every step of every shard on its device's current stream, and
    return the choices. `on_launch(n)` runs after each launch of a
    shard of n nodes. CPU tensors run an emulated launcher (no stream)."""
    chain = _Chain(pods, nodes)
    shards = len(chain.devices)
    dims = scan_kernel._dims(pods, nodes.shards[0])
    S = dims["S"]
    if S < 1:
        raise ValueError("sharded scan: the service axis must have at least one column")
    if dims["K"] > 32:
        raise ValueError(f"sharded scan: {dims['K']} service ids per pod; at most 32")
    row_words = scan_kernel._row_words(dims["SW"], dims["PW"], dims["VW"], dims["K"])
    w_lr, w_bra, w_spread = (int(w) for w in weights)
    rows = {dev: scan_kernel._pod_rows(chain.pods[dev], row_words) for dev in chain.by_device}
    counts = []
    steps = []
    for s, ((lo, hi), shard) in enumerate(zip(nodes.ranges, nodes.shards)):
        dev = chain.devices[s]
        n = hi - lo
        scan_kernel._check(chain.pods[dev], scan_kernel._POD_SPEC, chain.P, dims, dev, "pods")
        scan_kernel._check(shard, scan_kernel._NODE_SPEC, n, dims, dev, f"shard {s}")
        ct = shard["svc_counts"].t().to(torch.int32).contiguous()
        counts.append(ct)
        ptrs = [rows[dev].data_ptr()]
        ptrs += [shard[k].data_ptr() for k, _, _ in scan_kernel._NODE_SPEC if k != "svc_counts"]
        ptrs += [ct.data_ptr(), chain.slots[dev].data_ptr(),
                 chain.choice.data_ptr() if s == 0 else None]
        ints = (chain.P, row_words, lo, n, S, dims["SW"], dims["PW"], dims["VW"], dims["K"],
                shards, s, w_lr, w_bra, w_spread, threads_for(n))
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
            context = lambda dev=dev: torch.cuda.device(dev)  # noqa: E731
        else:
            stream, context = None, contextlib.nullcontext

        def step(t, ptrs=ptrs, ints=ints, stream=stream, context=context, n=n):
            with context():
                rc = lib.ktt_shard_step(*ptrs, t, *ints, stream)
            if rc != 0:
                raise RuntimeError(
                    f"shard-step kernel launch failed: {lib.ktt_shard_error_string(rc).decode()}")
            if on_launch is not None:
                on_launch(n)

        steps.append(step)
    choice = chain.run(steps)
    for ct, shard in zip(counts, nodes.shards):
        shard["svc_counts"].copy_(ct.t())
    return choice


def _kernel_sharded_scan(pods: Tensors, nodes: ShardedNodes, weights):
    from kubernetes_tpu_torch.ops import build

    lib = build.load("shard_scan_kernel", _bind)
    dims = scan_kernel._dims(pods, nodes.shards[0])
    shards = len(nodes.shards)

    def launched(n: int) -> None:
        sharded_scan_with_state.launches += 1
        _note("cuda", dims, n, shards)

    return kernel_chain(lib, pods, nodes, weights, launched), nodes


def sharded_scan_with_state(
    pods: Tensors, nodes: ShardedNodes, weights=(1, 1, 1), lspec=DEFAULT_LOWERED
) -> Tuple[torch.Tensor, ShardedNodes]:
    """Default-spec sequential solve over a mesh: (choice i32[P] on the
    mesh's first device, nodes), each shard's carry updated in place.
    Shards on CUDA devices launch K1S a step (or raise); shards on the
    CPU run `plain_shard_step`; a mesh that mixes the two raises."""
    if lspec != DEFAULT_LOWERED:
        raise ValueError("sharded scan: a policy spec on a mesh is not ported; "
                         "solve it unsharded")
    kinds = {dev.type for dev in nodes.mesh.devices}
    if kinds == {"cuda"}:
        return _kernel_sharded_scan(pods, nodes, weights)
    if kinds == {"cpu"}:
        dims = scan_kernel._dims(pods, nodes.shards[0])
        for lo, hi in nodes.ranges:
            _note("plain", dims, hi - lo, len(nodes.shards))
        return plain_sharded_scan_with_state(pods, nodes, weights)
    raise ValueError(f"sharded scan: unsupported mesh devices {sorted(kinds)}")


#: K1S launches made by this wrapper (a plain counter callers may reset).
sharded_scan_with_state.launches = 0
