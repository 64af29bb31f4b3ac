"""The sequential-parity scan as one CUDA kernel launch.

Replaces `kubernetes_tpu/ops/pallas_scan.py::_kernel`, the JAX
package's Pallas kernel: the whole default-spec sequential solve (for
each pod in order, every predicate and priority against all N nodes,
first-max selection, commit into the occupancy carry) in one launch.
The kernel is `csrc/scan_kernel.cu`; this module binds it.

What bounds it: P dependent steps, each an N-wide evaluation followed
by an N-wide max whose winner changes the state the next step reads.
It is neither bytes nor FLOPs: a 13,312 x 5,120 chunk moves about
23 MB and does about 5 G simple 32-bit operations, under a tenth of a
millisecond at the card's rates, while the chain of P reductions cannot
run in parallel. So the kernel is ONE persistent thread block that loops
over the pods: each step costs two block barriers and one block-wide
64-bit max, with no launch, no host round trip and no global
synchronisation between pods; warp 0 commits the winner, one lane per
carry entry.
The carry (about 11 MB at 5k nodes x 512 services) stays in device
memory and L2 holds it; only the chosen node's entries are written.

The wrapper checks device, dtype, shape and contiguity, allocates the
output and scratch with torch, converts the service counts between the
JAX layout (N, S) f32 and the kernel's (S, N) int32 (the row a pod reads
is then contiguous), launches on the current stream and raises if the
launch failed. It never synchronises. CPU tensors go to the plain
version, the per-pod loop of `ops/solver.py`; no CUDA tensor ever
does.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

Tensors = Dict[str, torch.Tensor]

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
# Pointers the launcher takes: every pod and node column except the
# (N, S) f32 service counts, whose (S, N) int32 copy goes in instead,
# then the max-count scratch and the choice output.
_N_PTRS = len(_POD_SPEC) + len(_NODE_SPEC) - 1 + 3


def _bind(lib: ctypes.CDLL) -> None:
    lib.ktt_scan_launch.argtypes = (
        [ctypes.c_void_p] * _N_PTRS + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    )
    lib.ktt_scan_launch.restype = ctypes.c_int
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


def _call(lib: ctypes.CDLL, pods: Tensors, nodes: Tensors, weights, stream) -> torch.Tensor:
    """Check the tensors, allocate the output and scratch on their
    device, convert the service counts to the kernel's layout, call the
    launcher, and convert them back. Returns the choices."""
    device = pods["cpu"].device
    P = pods["cpu"].shape[0]
    N = nodes["cpu_cap"].shape[0]
    dims = {
        "SW": pods["sel"].shape[1],
        "PW": pods["port"].shape[1],
        "VW": pods["vol_any"].shape[1],
        "K": pods["svc_ids"].shape[1],
        "S": nodes["svc_counts"].shape[1],
    }
    _check(pods, _POD_SPEC, P, dims, device, "pods")
    _check(nodes, _NODE_SPEC, N, dims, device, "nodes")
    S = dims["S"]
    if S < 1:
        raise ValueError("scan kernel: the service axis must have at least one column")
    w_lr, w_bra, w_spread = (int(w) for w in weights)
    counts = torch.empty((S, N), dtype=torch.int32, device=device)
    counts.copy_(nodes["svc_counts"].t())
    maxc = torch.empty(S, dtype=torch.int32, device=device)
    choice = torch.empty(P, dtype=torch.int32, device=device)
    ptrs = [pods[k].data_ptr() for k, _, _ in _POD_SPEC]
    ptrs += [nodes[k].data_ptr() for k, _, _ in _NODE_SPEC if k != "svc_counts"]
    ptrs += [counts.data_ptr(), maxc.data_ptr(), choice.data_ptr()]
    rc = lib.ktt_scan_launch(
        *ptrs, P, N, S, dims["SW"], dims["PW"], dims["VW"], dims["K"],
        w_lr, w_bra, w_spread, stream,
    )
    if rc != 0:
        raise RuntimeError(f"scan kernel launch failed: {lib.ktt_error_string(rc).decode()}")
    nodes["svc_counts"].copy_(counts.t())
    return choice


def _launch(pods: Tensors, nodes: Tensors, weights) -> Tuple[torch.Tensor, Tensors]:
    from kubernetes_tpu_torch.ops import build

    lib = build.load("scan_kernel", _bind)
    device = pods["cpu"].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        choice = _call(lib, pods, nodes, weights, stream)
    scan_with_state.launches += 1
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
        return plain_scan_with_state(pods, nodes, weights)
    raise ValueError(f"scan kernel: unsupported device {device}")


#: Kernel launches made by this wrapper (a plain counter callers may reset).
scan_with_state.launches = 0
