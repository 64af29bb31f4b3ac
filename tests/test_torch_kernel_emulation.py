"""The CUDA scan kernel's source, run on the CPU, equals its plain version.

There is no CUDA compiler here, so `csrc/scan_kernel.cu` is compiled with
the host C++ compiler against a small emulation of the CUDA features it
uses: one thread block of std::threads, `__syncthreads` as a block
barrier, warp shuffles through a per-warp barrier, atomics as
std::atomic_ref, and the `_rn` float
intrinsics as plain IEEE operations (with FMA contraction off, as nvcc's
-fmad=false). The wrapper's own argument handling (`scan_kernel._call`)
then drives the emulated launcher with CPU tensors, and the decisions and
carry must equal the plain loop's bit for bit. This checks the kernel's indexing,
selection and commit logic; the chip run checks the real build.
"""

import ctypes
import re
import shutil
import subprocess

import pytest
import torch

from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.models.columnar import build_snapshot
from kubernetes_tpu_torch.ops import build, scan_kernel
from kubernetes_tpu_torch.ops.matrices import CARRY_KEYS, device_snapshot

EMULATION_HEADER = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <climits>
#include <cmath>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
typedef void* cudaStream_t;
typedef int cudaError_t;
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
struct EmuDim { int x; };
inline thread_local EmuDim threadIdx;
inline std::barrier<>* emu_block = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warps;
inline long long emu_lanes[1024];
inline void __syncthreads() { emu_block->arrive_and_wait(); }
template <class T> T __shfl_xor_sync(unsigned, T v, int offset) {
  const int t = threadIdx.x;
  std::barrier<>& warp = *emu_warps[t / 32];
  emu_lanes[t] = (long long)v;
  warp.arrive_and_wait();
  const T r = (T)emu_lanes[t ^ offset];
  warp.arrive_and_wait();
  return r;
}
template <class T> T __ldcg(const T* p) { return std::atomic_ref<T>(*const_cast<T*>(p)).load(); }
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
inline int atomicMax(int* p, int v) {
  std::atomic_ref<int> r(*p);
  int old = r.load();
  while (old < v && !r.compare_exchange_weak(old, v)) {}
  return old;
}
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __int2float_rn(int i) { return (float)i; }
inline int __float2int_rz(float f) { return (int)f; }
template <class F, class A> void emu_launch(int threads, F kernel, const A& args) {
  std::barrier<> block(threads);
  emu_block = &block;
  emu_warps.clear();
  for (int w = 0; w < threads / 32; ++w) emu_warps.emplace_back(new std::barrier<>(32));
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([&, t] { threadIdx.x = t; kernel(args); });
  for (auto& th : pool) th.join();
}
"""


def _emulated_source(threads: int) -> str:
    with open(f"{build.CSRC}/scan_kernel.cu") as f:
        src = f.read()
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src, n_threads = re.subn(
        r"constexpr int kThreads = \d+;", f"constexpr int kThreads = {threads};", src
    )
    src, n_launch = re.subn(
        r"scan_kernel<<<1, kThreads, 0, .*?>>>\(a\);",
        "emu_launch(kThreads, scan_kernel, a);",
        src,
    )
    assert n_threads == 1 and n_launch == 1, "kernel source layout changed"
    return src


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """threads -> loaded emulation library (built once per module)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to emulate the kernel with")
    out = tmp_path_factory.mktemp("scan_emu")
    (out / "cuda_emu.h").write_text(EMULATION_HEADER)
    libs = {}
    for threads in (64, 1024):
        src = out / f"scan_emu_{threads}.cc"
        src.write_text(_emulated_source(threads))
        lib = out / f"libscan_emu_{threads}.so"
        subprocess.run(
            [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
             "-pthread", "-o", str(lib), str(src)],
            check=True, capture_output=True, text=True, timeout=300,
        )
        libs[threads] = ctypes.CDLL(str(lib))
        scan_kernel._bind(libs[threads])
    return libs


def _check_case(lib, seed, weights, repeat_ids=False):
    pending, nodes, assigned, services = workload.small_cluster(seed)
    d = device_snapshot(build_snapshot(pending, nodes, assigned, services), device="cpu")
    if repeat_ids:
        ids = d.pods["svc_ids"]
        ids[:, 1] = torch.where(ids[:, 0] >= 0, ids[:, 0], ids[:, 1])
    got_nodes = {k: v.clone() for k, v in d.nodes.items()}
    ref_nodes = {k: v.clone() for k, v in d.nodes.items()}
    # The wrapper's own argument handling, with CPU tensors and no stream.
    got = scan_kernel._call(lib, d.pods, got_nodes, weights, None)
    ref, ref_nodes = scan_kernel.plain_scan_with_state(d.pods, ref_nodes, weights)
    assert torch.equal(got, ref), f"{int((got != ref).sum())} decisions differ"
    for k in CARRY_KEYS:
        assert torch.equal(got_nodes[k], ref_nodes[k]), f"carry field {k} differs"


@pytest.mark.parametrize("weights", [(1, 1, 1), (2, 0, 3), (0, 5, 1)])
@pytest.mark.parametrize("seed", range(4))
def test_emulated_kernel_matches_plain_64_threads(emulated, seed, weights):
    """A 64-thread block: each thread owns several nodes, and the
    block-wide max crosses two warps."""
    _check_case(emulated[64], seed, weights)


@pytest.mark.parametrize("seed", range(2))
def test_emulated_kernel_repeated_service_ids(emulated, seed):
    """A service id listed twice commits twice (the lanes add atomically)."""
    _check_case(emulated[64], seed, (1, 1, 1), repeat_ids=True)


def test_emulated_kernel_matches_plain_full_block(emulated):
    """The kernel's real 1024-thread block, where most threads own no node."""
    _check_case(emulated[1024], 1, (1, 1, 1))
