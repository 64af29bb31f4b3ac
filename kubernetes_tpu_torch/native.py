"""ctypes binding of the port's host lowering helpers (`csrc/columnar.cc`).

The counterpart of `kubernetes_tpu/native/__init__.py`: `pack_bitsets`,
`or_rows_by_index` and `greedy_fit`, the per-row loops of the columnar
lowering at 50,000 pods, as C++ built with g++ by `ops/build.py` at
first use (into the git-ignored `kubernetes_tpu_torch/build/`, keyed by
a hash of the source). Unlike the JAX binding there is no quiet NumPy
fallback: a missing g++ or a failed build raises, and so does an
argument of the wrong dtype, layout or length. The NumPy versions in
`models/columnar.py` are the plain versions the tests hold these to,
bit for bit.

Every index is checked against its bounds here, before the call: the
C loops do no bounds checking.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

_i64 = ctypes.c_int64
_p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_p_u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")

#: The helper's source, csrc/<HELPER>.cc.
HELPER = "columnar"


def _bind(lib: ctypes.CDLL) -> None:
    lib.pack_bitsets.argtypes = [_i64, _i64, _p_i64, _p_i32, _p_u32]
    lib.or_rows_by_index.argtypes = [_i64, _i64, _p_i32, _p_u32, _p_u32]
    lib.greedy_fit.argtypes = [
        _i64, _p_i32, _p_f32, _p_f32, _p_f32, _p_f32,
        _p_f32, _p_f32, _p_u8, _p_f32, _p_f32, _p_f32,
    ]
    for fn in (lib.pack_bitsets, lib.or_rows_by_index, lib.greedy_fit):
        fn.restype = None


def _lib() -> ctypes.CDLL:
    from kubernetes_tpu_torch.ops import build

    return build.load_host(HELPER, _bind)


def ensure_built() -> str:
    """Build (if needed) and load the helper; returns its library path.
    Raises when g++ is missing or the build fails."""
    from kubernetes_tpu_torch.ops import build

    _lib()
    return build.host_library_path(HELPER)


def _check_out(name: str, arr: np.ndarray, dtype, shape) -> None:
    """An output array the helper writes in place: exact dtype, shape and
    C order (a converted copy would drop the writes)."""
    if arr.dtype != dtype or arr.shape != tuple(shape) or not arr.flags["C_CONTIGUOUS"]:
        raise ValueError(
            f"{name}: expected a C-contiguous {np.dtype(dtype).name} array of shape "
            f"{tuple(shape)}, got {arr.dtype} {arr.shape}"
        )


def _check_index(node_idx: np.ndarray, n: int) -> None:
    if len(node_idx) and int(node_idx.max()) >= n:
        raise IndexError(f"node index {int(node_idx.max())} >= {n}")


def pack_bitsets(id_lists: Sequence[Sequence[int]], words: int) -> np.ndarray:
    """Rows of ids -> u32[n_rows, words] bitsets."""
    n = len(id_lists)
    out = np.zeros((n, words), dtype=np.uint32)
    # Most backlogs have no hostPorts/volumes on most pods: a truthiness
    # sweep is far cheaper than building the flat index arrays.
    if n == 0 or not any(id_lists):
        return out
    counts = np.fromiter((len(ids) for ids in id_lists), dtype=np.int64, count=n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    flat = np.fromiter(
        (i for ids in id_lists for i in ids), dtype=np.int64, count=int(offsets[-1])
    )
    if int(flat.min()) < 0 or int(flat.max()) >= words * 32:
        raise IndexError(
            f"bitset id out of range for {words} words "
            f"(max {int(flat.max())}, min {int(flat.min())})"
        )
    _lib().pack_bitsets(n, words, offsets, flat.astype(np.int32), out)
    return out


def or_rows_by_index(
    node_idx: np.ndarray, pod_rows: np.ndarray, node_rows: np.ndarray
) -> None:
    """node_rows[node_idx[i]] |= pod_rows[i] in place (node_idx < 0 skipped)."""
    node_idx = np.ascontiguousarray(node_idx, dtype=np.int32)
    pod_rows = np.ascontiguousarray(pod_rows, dtype=np.uint32)
    words = node_rows.shape[1] if node_rows.ndim == 2 else -1
    _check_out("or_rows_by_index node_rows", node_rows, np.uint32, (node_rows.shape[0], words))
    if pod_rows.shape != (len(node_idx), words):
        raise ValueError(
            f"or_rows_by_index: pod_rows {pod_rows.shape} against {len(node_idx)} "
            f"indices of {words} words"
        )
    _check_index(node_idx, node_rows.shape[0])
    _lib().or_rows_by_index(len(node_idx), words, node_idx, pod_rows, node_rows)


def greedy_fit(
    node_idx: np.ndarray,
    cpu: np.ndarray,
    mem: np.ndarray,
    cpu_cap: np.ndarray,
    mem_cap: np.ndarray,
    cpu_fit: np.ndarray,
    mem_fit: np.ndarray,
    over: np.ndarray,
    cpu_used: np.ndarray,
    mem_used: np.ndarray,
    pods_used: np.ndarray,
) -> None:
    """The assigned-pod occupancy sweep, in place, in list order
    (reference MapPodsToMachines / CheckPodsExceedingCapacity)."""
    node_idx = np.ascontiguousarray(node_idx, dtype=np.int32)
    cpu = np.ascontiguousarray(cpu, dtype=np.float32)
    mem = np.ascontiguousarray(mem, dtype=np.float32)
    A, N = len(node_idx), len(cpu_cap)
    if cpu.shape != (A,) or mem.shape != (A,):
        raise ValueError(f"greedy_fit: {A} indices against cpu {cpu.shape}, mem {mem.shape}")
    for name, arr in (("cpu_cap", cpu_cap), ("mem_cap", mem_cap), ("cpu_fit", cpu_fit),
                      ("mem_fit", mem_fit), ("cpu_used", cpu_used), ("mem_used", mem_used),
                      ("pods_used", pods_used)):
        _check_out(f"greedy_fit {name}", arr, np.float32, (N,))
    _check_out("greedy_fit over", over, np.bool_, (N,))
    _check_index(node_idx, N)
    _lib().greedy_fit(
        A, node_idx, cpu, mem, cpu_cap, mem_cap, cpu_fit, mem_fit,
        over.view(np.uint8), cpu_used, mem_used, pods_used,
    )
