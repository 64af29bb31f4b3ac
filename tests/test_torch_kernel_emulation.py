"""The CUDA kernels' sources, run on the CPU, equal their plain versions.

There is no CUDA compiler here, so `csrc/scan_kernel.cu`,
`csrc/policy_scan_kernel.cu` and `csrc/rebalance_kernel.cu` are
compiled as they stand with the host C++ compiler, against small headers that stand in for the CUDA ones: a
launch (`cudaLaunchKernelEx` with a cluster attribute) runs every
thread of every CTA of the cluster as a std::thread; `__syncthreads` is
a barrier per CTA and the cluster barrier one over the whole cluster
(barriers whose waiters yield, since the threads outnumber the cores);
each CTA has its own dynamic shared-memory arena, and `map_shared_rank`
points into another CTA's; warp votes, shuffles and reductions (max,
min, add) go through a barrier per warp, as does `__syncwarp`; atomics
are std::atomic_ref; the asynchronous copies of
`csrc/scan_async.cuh` are plain copies; the `_rn` float intrinsics are
plain IEEE operations (with FMA contraction off, as nvcc's -fmad=false).
The wrappers' own argument handling (`scan_kernel._call`,
`policy_scan._call`, `rebalance._call`) drives the emulated launchers with CPU tensors, and
the decisions and carry (for the policy kernel the service carry too)
must equal the plain loop's bit for bit.

This checks each kernel's slicing, selection across CTAs, commit and
count bookkeeping on clusters of 1, 2, 4 and 8 CTAs; for the defrag
plan kernel its windows on 1, 2 and 4 CTAs (the screen's lists and
chunk merges, the records written into CTA 0 through DSMEM, the
resolve's touched set, windows that end early and restart at K = 1
and 2, the gains left to after the chain); and for the policy
kernel the replicated service carry, the zone sums exchanged between
CTAs, and slices read in place from device memory. Its barriers are
sequentially consistent, so it cannot show a missing fence or a stale
L1 line: the repeated runs on the card in `chip_smoke.py` look for
those. An emulated launch runs at most 256 OS threads, but for the
defrag plan kernel's default plan (1,024).
"""

import ctypes
import glob
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch import workload
from kubernetes_tpu_torch.models.columnar import build_snapshot
from kubernetes_tpu_torch.models.algspec import spec_from_policy
from kubernetes_tpu_torch.ops import build, policy_scan, rebalance, scan_kernel, shard_scan
from kubernetes_tpu_torch.ops.capacity import stage
from kubernetes_tpu_torch.ops.matrices import (
    CARRY_KEYS, POLICY_CARRY_KEYS, Mesh, device_snapshot, shard_nodes)

CUDA_RUNTIME_H = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorLaunchOutOfResources = 701 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributeNonPortableClusterSizeAllowed,
};
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension };
struct cudaLaunchAttributeValue { struct { unsigned x, y, z; } clusterDim; };
struct cudaLaunchAttribute { cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};

// A barrier whose waiters yield instead of sleeping: an emulated launch
// runs many more threads than there are cores, and they meet at a
// barrier several times a step.
struct EmuBarrier {
  explicit EmuBarrier(int n) : n(n) {}
  void arrive_and_wait() {
    const unsigned gen = generation.load(std::memory_order_acquire);
    if (count.fetch_add(1, std::memory_order_acq_rel) + 1 == n) {
      count.store(0, std::memory_order_relaxed);
      generation.fetch_add(1, std::memory_order_acq_rel);
    } else {
      while (generation.load(std::memory_order_acquire) == gen) std::this_thread::yield();
    }
  }
  const int n;
  std::atomic<int> count{0};
  std::atomic<unsigned> generation{0};
};

struct EmuIdx { unsigned x, y, z; };
inline thread_local EmuIdx threadIdx, blockIdx;
inline EmuIdx blockDim;
struct alignas(16) EmuChunk { unsigned char b[16]; };
struct EmuBlock {
  std::unique_ptr<EmuBarrier> block;
  std::vector<std::unique_ptr<EmuBarrier>> warps;
  std::vector<long long> lanes;
  std::vector<EmuChunk> smem;
};
inline std::vector<EmuBlock>* emu_blocks = nullptr;
inline EmuBarrier* emu_cluster = nullptr;
inline EmuBlock& emu_block() { return (*emu_blocks)[blockIdx.x]; }

inline void __syncthreads() { emu_block().block->arrive_and_wait(); }
inline unsigned __ballot_sync(unsigned, bool v) {
  EmuBlock& b = emu_block();
  const int t = threadIdx.x;
  EmuBarrier& warp = *b.warps[t / 32];
  b.lanes[t] = v;
  warp.arrive_and_wait();
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) r |= (b.lanes[(t & ~31) + l] ? 1u : 0u) << l;
  warp.arrive_and_wait();
  return r;
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline bool __any_sync(unsigned m, bool v) { return __ballot_sync(m, v) != 0; }
template <class T> T __reduce_max_sync(unsigned, T v) {
  EmuBlock& b = emu_block();
  const int t = threadIdx.x;
  EmuBarrier& warp = *b.warps[t / 32];
  b.lanes[t] = (long long)v;
  warp.arrive_and_wait();
  T r = v;
  for (int l = t & ~31; l < (t & ~31) + 32; ++l) r = std::max(r, (T)b.lanes[l]);
  warp.arrive_and_wait();
  return r;
}
template <class T> T __reduce_min_sync(unsigned, T v) {
  EmuBlock& b = emu_block();
  const int t = threadIdx.x;
  EmuBarrier& warp = *b.warps[t / 32];
  b.lanes[t] = (long long)v;
  warp.arrive_and_wait();
  T r = v;
  for (int l = t & ~31; l < (t & ~31) + 32; ++l) r = std::min(r, (T)b.lanes[l]);
  warp.arrive_and_wait();
  return r;
}
template <class T> T __reduce_add_sync(unsigned, T v) {
  EmuBlock& b = emu_block();
  const int t = threadIdx.x;
  EmuBarrier& warp = *b.warps[t / 32];
  b.lanes[t] = (long long)v;
  warp.arrive_and_wait();
  T r = 0;
  for (int l = t & ~31; l < (t & ~31) + 32; ++l) r += (T)b.lanes[l];
  warp.arrive_and_wait();
  return r;
}
// A shuffle: every lane stores its value, then reads lane src(lane)'s.
template <class T, class F> T emu_shuffle(T v, F src) {
  static_assert(sizeof(T) <= sizeof(long long));
  EmuBlock& b = emu_block();
  const int t = threadIdx.x, base = t & ~31;
  EmuBarrier& warp = *b.warps[t / 32];
  long long bits = 0;
  std::memcpy(&bits, &v, sizeof v);
  b.lanes[t] = bits;
  warp.arrive_and_wait();
  T r;
  bits = b.lanes[base + src(t & 31)];
  std::memcpy(&r, &bits, sizeof r);
  warp.arrive_and_wait();
  return r;
}
template <class T> T __shfl_sync(unsigned, T v, int src, int width = 32) {
  return emu_shuffle(v, [&](int l) { return (l & ~(width - 1)) + (src & (width - 1)); });
}
template <class T> T __shfl_xor_sync(unsigned, T v, int mask, int width = 32) {
  return emu_shuffle(v, [&](int l) {
    const int o = l ^ mask;
    return (o & ~(width - 1)) == (l & ~(width - 1)) ? o : l;
  });
}
template <class T> T __shfl_up_sync(unsigned, T v, unsigned delta, int width = 32) {
  return emu_shuffle(v, [&](int l) { return (l & (width - 1)) >= (int)delta ? l - (int)delta : l; });
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_block().warps[threadIdx.x / 32]->arrive_and_wait();
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline long long clock64() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
      std::chrono::steady_clock::now().time_since_epoch()).count();
}
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
inline float atomicAdd(float* p, float v) { return std::atomic_ref<float>(*p).fetch_add(v); }
inline int atomicCAS(int* p, int expected, int v) {
  std::atomic_ref<int>(*p).compare_exchange_strong(expected, v);
  return expected;
}
inline int atomicMax(int* p, int v) {
  std::atomic_ref<int> r(*p);
  int cur = r.load();
  while (cur < v && !r.compare_exchange_weak(cur, v)) {
  }
  return cur;
}
template <class T> T __ldcg(const T* p) { return std::atomic_ref<T>(*const_cast<T*>(p)).load(); }
template <class T> T __ldg(const T* p) { return *p; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __frcp_rn(float a) { return 1.0f / a; }
inline float __int2float_rn(int i) { return (float)i; }
inline int __float2int_rz(float f) { return (int)f; }
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}

template <class F> cudaError_t cudaFuncSetAttribute(F*, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, F*, const cudaLaunchConfig_t*) {
  *n = 1;
  return cudaSuccess;
}
template <class... Exp, class... Act>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(Exp...),
                               Act&&... args) {
  const unsigned C = cfg->gridDim.x, T = cfg->blockDim.x;
  // One cluster spans the grid, or a plain launch of one block.
  const bool one_block = cfg->numAttrs == 0 && C == 1;
  if (!one_block && (cfg->numAttrs != 1 || cfg->attrs[0].id != cudaLaunchAttributeClusterDimension ||
                     cfg->attrs[0].val.clusterDim.x != C)) {
    return cudaErrorInvalidValue;
  }
  blockDim = {T, 1, 1};
  std::vector<EmuBlock> blocks(C);
  for (EmuBlock& b : blocks) {
    b.block.reset(new EmuBarrier(T));
    for (unsigned w = 0; w < T / 32; ++w) b.warps.emplace_back(new EmuBarrier(32));
    b.lanes.resize(T);
    b.smem.resize(cfg->dynamicSmemBytes / 16 + 1);
  }
  EmuBarrier cluster(C * T);
  emu_blocks = &blocks;
  emu_cluster = &cluster;
  std::vector<std::thread> pool;
  for (unsigned b = 0; b < C; ++b)
    for (unsigned t = 0; t < T; ++t)
      pool.emplace_back([&, b, t] {
        blockIdx = {b, 0, 0};
        threadIdx = {t, 0, 0};
        kernel(args...);
      });
  for (auto& th : pool) th.join();
  return cudaSuccess;
}
"""

COOPERATIVE_GROUPS_H = r"""
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct cluster_group {
  void sync() const { emu_cluster->arrive_and_wait(); }
  unsigned block_rank() const { return blockIdx.x; }
  template <class T> T* map_shared_rank(T* p, unsigned rank) const {
    const unsigned char* mine = emu_block().smem.data()->b;
    unsigned char* theirs = (*emu_blocks)[rank].smem.data()->b;
    return reinterpret_cast<T*>(theirs + (reinterpret_cast<const unsigned char*>(p) - mine));
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
"""

SCAN_ASYNC_CUH = r"""
#pragma once
#include <cuda_runtime.h>
inline unsigned char* dyn_smem() { return emu_block().smem.data()->b; }
inline void cp_async16(void* smem, const void* gmem) { std::memcpy(smem, gmem, 16); }
inline void cp_async_wait_all() {}
"""


def _compile_emulated(tmp_path_factory, name):
    """csrc/<name>.cu compiled against the emulation headers, loaded."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to emulate the kernel with")
    out = tmp_path_factory.mktemp(f"{name}_emu")
    (out / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (out / "cooperative_groups.h").write_text(COOPERATIVE_GROUPS_H)
    (out / "scan_async.cuh").write_text(SCAN_ASYNC_CUH)
    # The source as it stands, beside the emulated scan_async.cuh and
    # the kernels' own shared headers.
    src = out / f"{name}.cc"
    shutil.copy(f"{build.CSRC}/{name}.cu", src)
    for header in glob.glob(f"{build.CSRC}/*.cuh"):
        if os.path.basename(header) != "scan_async.cuh":
            shutil.copy(header, out)
    lib = out / f"lib{name}_emu.so"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread",
         "-I", str(out), "-o", str(lib), str(src)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The scan kernel's source compiled against the emulation headers."""
    handle = _compile_emulated(tmp_path_factory, "scan_kernel")
    scan_kernel._bind(handle)
    return handle


def _state(seed, pad_to=128, repeat_ids=False):
    pending, nodes, assigned, services = workload.small_cluster(seed)
    d = device_snapshot(build_snapshot(pending, nodes, assigned, services), "cpu", pad_to)
    if repeat_ids:
        ids = d.pods["svc_ids"]
        ids[:, 1] = torch.where(ids[:, 0] >= 0, ids[:, 0], ids[:, 1])
    return d.pods, d.nodes


def _check_case(lib, pods, nodes, weights, cluster, threads, resident=None):
    plan = scan_kernel.plan_for(pods, nodes, cluster, threads, resident)
    got_nodes = {k: v.clone() for k, v in nodes.items()}
    ref_nodes = {k: v.clone() for k, v in nodes.items()}
    # The wrapper's own argument handling, with CPU tensors and no stream.
    got = scan_kernel._call(lib, pods, got_nodes, weights, None, plan)
    ref, ref_nodes = scan_kernel.plain_scan_with_state(pods, ref_nodes, weights)
    assert torch.equal(got, ref), f"{int((got != ref).sum())} decisions differ"
    for k in CARRY_KEYS:
        assert torch.equal(got_nodes[k], ref_nodes[k]), f"carry field {k} differs"
    return plan


@pytest.mark.parametrize("weights", [(1, 1, 1), (2, 0, 3), (0, 5, 1)])
@pytest.mark.parametrize("seed", range(4))
def test_emulated_kernel_matches_plain_64_threads(emulated, seed, weights):
    """Two CTAs of 64 threads: the 128 padded nodes split 64 and 64, and
    the block-wide max crosses two warps before the cluster's."""
    pods, nodes = _state(seed)
    _check_case(emulated, pods, nodes, weights, 2, 64)


@pytest.mark.parametrize("seed", range(2))
def test_emulated_kernel_repeated_service_ids(emulated, seed):
    """A service id listed twice commits twice, and the new max count
    of its service reaches every CTA."""
    pods, nodes = _state(seed, repeat_ids=True)
    _check_case(emulated, pods, nodes, (1, 1, 1), 4, 32)


def test_emulated_kernel_matches_plain_full_block(emulated):
    """The wrapper's own thread count on a cluster of 8 CTAs, where each
    thread owns one node of a 16-node slice and half the threads none."""
    pods, nodes = _state(1)
    _check_case(emulated, pods, nodes, (1, 1, 1), 8, None)


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("seed", range(4, 8))
def test_emulated_unpadded_node_axis(emulated, seed, cluster):
    """The node axis unpadded (3 to 40 nodes): slices of ceil(N / C)
    rounded up to 4, so the last CTAs hold a short slice or none."""
    pods, nodes = _state(seed, pad_to=1)
    _check_case(emulated, pods, nodes, (1, 1, 1), cluster, 32)


def _cut_nodes(nodes, n):
    return {k: v[:n].contiguous() for k, v in nodes.items()}


@pytest.mark.parametrize("n_nodes", [1, 2, 3, 5, 13])
def test_emulated_fewer_nodes_than_cluster_slots(emulated, n_nodes):
    """N < C and N not a multiple of C on 4 CTAs: some CTAs own no node
    and still take every cluster barrier."""
    pods, nodes = _state(6, pad_to=1)
    nodes = _cut_nodes(nodes, min(n_nodes, nodes["cpu_cap"].shape[0]))
    _check_case(emulated, pods, nodes, (1, 1, 1), 4, 32)


@pytest.mark.parametrize("cluster,threads", [(2, 32), (4, 32), (4, 64)])
def test_emulated_ties_across_ctas_and_tiles(emulated, cluster, threads):
    """300 pods over 45 nodes of nine kinds: equal best scores in several
    CTAs (the lowest index must win), winners on the first and last node
    of a slice, services and host ports, and pod rows from three tiles."""
    pending, nodes, services = workload.synthetic_objects(300, 45, seed=11)
    d = device_snapshot(build_snapshot(pending, nodes, services=services), "cpu", 1)
    assert d.pods["cpu"].shape[0] > scan_kernel.TILE * 2
    _check_case(emulated, d.pods, d.nodes, (1, 1, 1), cluster, threads)


@pytest.mark.parametrize("seed", [0, 1, 2, "services"])
def test_emulated_unplaceable_pods_between_placed_ones(emulated, seed):
    """Pods pinned to -2 (the padding's fill) or past the node axis, in
    the middle of the backlog: two in a row take no cluster step, the
    slots' parity must still line up across the steps that do, and the
    count adds flushed on a step without one must still reach the next
    fetch (the "services" case: 150 pods of one service on 60 nodes)."""
    if seed == "services":
        pending, nodes, services = workload.synthetic_objects(150, 60, seed=10)
        d = device_snapshot(build_snapshot(pending, nodes, services=services), "cpu", 1)
        pods, nodes = d.pods, d.nodes
    else:
        pods, nodes = _state(seed, pad_to=1)
    pods = {k: v.clone() for k, v in pods.items()}
    N = nodes["cpu_cap"].shape[0]
    pods["pinned"][1::3] = -2
    pods["pinned"][2::7] = N + 3
    _check_case(emulated, pods, nodes, (1, 1, 1), 4, 32)


@pytest.mark.parametrize("cluster,weights", [(1, (1, 1, 1)), (4, (1, 1, 1)), (4, (2, 1, 3))])
def test_emulated_crowded_services(emulated, cluster, weights):
    """200 pods of two services on 6 nodes: commits keep raising the max
    count of the next pod's service, and the spreading scores that
    follow turn on every CTA folding in the winner's new counts."""
    pending, nodes, services = workload.synthetic_objects(200, 6, seed=9)
    d = device_snapshot(build_snapshot(pending, nodes, services=services), "cpu", 1)
    _check_case(emulated, d.pods, d.nodes, weights, cluster, 32)


def _many_ports(n_nodes, n_pods):
    """Pods with distinct host ports: 70 ports need 3 words (bucketed
    to 4), so the kernel takes its widths from the arguments."""
    from kubernetes_tpu_torch.models.objects import (
        Container, ContainerPort, Node, NodeCondition, NodeStatus, ObjectMeta, Pod, PodSpec,
        ResourceRequirements,
    )
    from kubernetes_tpu_torch.models.quantity import Quantity, parse_quantity

    nodes = [
        Node(
            metadata=ObjectMeta(name=f"n{j}"),
            status=NodeStatus(
                capacity={"cpu": Quantity.from_milli(4000), "memory": parse_quantity("4096Mi"),
                          "pods": Quantity.from_int(200)},
                conditions=[NodeCondition(type="Ready", status="True")],
            ),
        )
        for j in range(n_nodes)
    ]
    pods = [
        Pod(
            metadata=ObjectMeta(name=f"p{i}", namespace="default"),
            spec=PodSpec(containers=[Container(
                name="c", ports=[ContainerPort(container_port=80, host_port=7000 + i % 70)],
                resources=ResourceRequirements(limits={
                    "cpu": Quantity.from_milli(10), "memory": parse_quantity("8Mi")}),
            )]),
        )
        for i in range(n_pods)
    ]
    return pods, nodes


@pytest.mark.parametrize("cluster,n_nodes", [(1, 4), (4, 9)])
def test_emulated_multiword_bitsets(emulated, cluster, n_nodes):
    """Port bitsets of 4 words, reused ports avoiding their nodes."""
    pods, nodes = _many_ports(n_nodes, 90)
    d = device_snapshot(build_snapshot(pods, nodes), "cpu", 1)
    assert d.pods["port"].shape[1] == 4
    _check_case(emulated, d.pods, d.nodes, (1, 1, 1), cluster, 32)


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("case", ["ties", "crowded", "unplaceable", "multiword", "repeated_ids"])
def test_emulated_kernel_in_place(emulated, case, cluster):
    """The slices read and written in place in device memory, the counts
    read through L2 and added at the commit: ties across CTAs and tiles,
    crowded services whose max count every CTA must follow, unplaceable
    pods between placed ones, 4-word bitsets (the runtime-width
    instance) and repeated service ids."""
    if case == "ties":
        pending, nodes, services = workload.synthetic_objects(300, 45, seed=11)
        d = device_snapshot(build_snapshot(pending, nodes, services=services), "cpu", 1)
        pods, nodes = d.pods, d.nodes
    elif case == "crowded":
        pending, nodes, services = workload.synthetic_objects(200, 6, seed=9)
        d = device_snapshot(build_snapshot(pending, nodes, services=services), "cpu", 1)
        pods, nodes = d.pods, d.nodes
    elif case == "unplaceable":
        pods, nodes = _state(2, pad_to=1)
        pods = {k: v.clone() for k, v in pods.items()}
        pods["pinned"][1::3] = -2
        pods["pinned"][2::7] = nodes["cpu_cap"].shape[0] + 3
    elif case == "multiword":
        many_pods, many_nodes = _many_ports(9, 90)
        d = device_snapshot(build_snapshot(many_pods, many_nodes), "cpu", 1)
        pods, nodes = d.pods, d.nodes
        assert pods["port"].shape[1] == 4
    else:
        pods, nodes = _state(3, repeat_ids=True)
    plan = _check_case(emulated, pods, nodes, (1, 1, 1), cluster, 32, resident=False)
    assert not plan.resident


@pytest.mark.parametrize(
    "widths", [(5121, 2, 2, 2, 8, 16, 1, 128), (40, 1, 4, 1, 8, 4, 1, 128), (3, 2, 2, 2, 8, 8, 1, 128),
               (0, 2, 2, 2, 8, 2, 1, 128), (50000, 2, 2, 2, 8, 16, 0, 128),
               (40, 4, 4, 4, 8, 4, 0, 128), (8000, 315, 4, 4, 8, 16, 0, 64),
               (36, 315, 4, 4, 8, 16, 1, 64), (45, 1175, 4, 4, 8, 16, 1, 16),
               (45, 275, 4, 4, 8, 1, 0, 32), (45, 275, 4, 4, 8, 4, 1, 8),
               (45, 3700, 4, 4, 8, 16, 1, 0), (45, 3700, 4, 4, 8, 1, 0, 0)],
)
def test_emulated_layout_equals_the_plan(emulated, widths):
    """The kernel's shared-memory layout and the Python plan agree, at
    every tile (the launcher takes it as a shift, 0 for rows in place)."""
    *dims, tile = widths
    shift = tile.bit_length() - 1 if tile else 0
    assert emulated.ktt_scan_smem_bytes(*dims, shift) == scan_kernel.smem_bytes(*dims, tile)


def _ties_case():
    pending, nodes, services = workload.synthetic_objects(300, 45, seed=11)
    d = device_snapshot(build_snapshot(pending, nodes, services=services), "cpu", 1)
    return d.pods, d.nodes


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("tile", [8, 16, 32, 64, 128, 0])
def test_emulated_each_tile_with_ties_across_tiles(emulated, tile, resident):
    """The runtime-width instance at every tile the plan can pick, and
    with the rows read in place (0): 300 pods of ties across CTAs,
    services and host ports, so commits, the count rows fetched ahead
    and the flushed adds straddle tiles of 8 and 16 pods many times."""
    pods, nodes = _widen(*_ties_case(), 4, seed=tile)
    plan = scan_kernel.plan_for(pods, nodes, 4, 32, resident, tile)
    assert plan.tile == tile
    assert _check_case_plan(emulated, pods, nodes, plan).resident == resident


def _widen(pods, nodes, SW, seed, selective=True):
    """The same pods and nodes with label bitsets of SW words: the
    original words first, random bits in the others on the nodes, and
    every third pod selecting one bit of a high word (so the new words
    decide feasibility, as hostname and rack labels would)."""
    g = torch.Generator().manual_seed(seed)
    P, N = pods["sel"].shape[0], nodes["labels"].shape[0]
    old = pods["sel"].shape[1]
    if SW <= old:
        return pods, nodes
    pods, nodes = dict(pods), dict(nodes)
    sel = torch.zeros((P, SW), dtype=torch.int32)
    sel[:, :old] = pods["sel"]
    labels = torch.zeros((N, SW), dtype=torch.int32)
    labels[:, :old] = nodes["labels"]
    labels[:, old:] = torch.randint(-2**31, 2**31 - 1, (N, SW - old), generator=g,
                                    dtype=torch.int32)
    if selective:
        for i in range(0, P, 3):
            sel[i, old + (i * 7919) % (SW - old)] |= 1 << (i % 31)
    pods["sel"], nodes["labels"] = sel, labels
    return pods, nodes


def _check_case_plan(lib, pods, nodes, plan, weights=(1, 1, 1)):
    got_nodes = {k: v.clone() for k, v in nodes.items()}
    ref_nodes = {k: v.clone() for k, v in nodes.items()}
    got = scan_kernel._call(lib, pods, got_nodes, weights, None, plan)
    ref, ref_nodes = scan_kernel.plain_scan_with_state(pods, ref_nodes, weights)
    assert torch.equal(got, ref), f"{int((got != ref).sum())} decisions differ"
    assert int((ref >= 0).sum()) > 0
    for k in CARRY_KEYS:
        assert torch.equal(got_nodes[k], ref_nodes[k]), f"carry field {k} differs"
    return plan


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("cluster", [1, 16])
@pytest.mark.parametrize("row_words,tile", [(300, 64), (1200, 16), (3700, 0)])
def test_emulated_rows_past_224_words(emulated, row_words, tile, cluster, resident):
    """Pod rows past the old limit of 224 words, at the plan's own tile:
    about 300 words (64 pods), about 1,200 (16) and rows read in place
    from device memory (about 3,700), each resident and in place, on one
    CTA and on 16."""
    pods, nodes = _ties_case()
    SW = row_words - 5 - pods["port"].shape[1] - 2 * pods["vol_any"].shape[1] - 8
    pods, nodes = _widen(pods, nodes, SW, seed=row_words)
    if resident:
        # As many nodes as one CTA's shared memory holds beside the tiles.
        dims = scan_kernel._dims(pods, nodes)
        held = scan_kernel.max_nodes(dims["SW"], dims["PW"], dims["VW"], dims["K"], cluster)
        nodes = _cut_nodes(nodes, min(held, nodes["cpu_cap"].shape[0]))
    plan = scan_kernel.plan_for(pods, nodes, cluster, 32, resident)
    assert (plan.tile, plan.row_words) == (tile, row_words)
    _check_case_plan(emulated, pods, nodes, plan)


# ---------------------------------------------------------------------------
# The policy scan kernel (K1P): one cluster, as the scan kernel.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def emulated_policy(tmp_path_factory):
    """The policy scan kernel's source compiled against the emulation
    headers."""
    handle = _compile_emulated(tmp_path_factory, "policy_scan_kernel")
    policy_scan._bind(handle)
    return handle


def _policy_state(shape, seed, pad_to=128):
    pending, nodes, assigned, services = workload.policy_cluster(seed)
    spec = spec_from_policy(workload.POLICY_SHAPES[shape])
    d = device_snapshot(build_snapshot(pending, nodes, assigned, services, spec=spec), "cpu", pad_to)
    return d.pods, d.nodes, d.weights, d.lowered


def _policy_objects_state(policy, n_pods, n_nodes, seed):
    pending, nodes, assigned, services = workload.policy_objects(n_pods, n_nodes, seed=seed)
    spec = spec_from_policy(policy)
    d = device_snapshot(build_snapshot(pending, nodes, assigned, services, spec=spec), "cpu", 1)
    return {k: v.clone() for k, v in d.pods.items()}, d.nodes, d.weights, d.lowered


def _check_policy_case(lib, pods, nodes, weights, lspec, threads, cluster=None, resident=None):
    """The emulated kernel against the plain loop: decisions, the nine
    carry fields and, where the spec has one, the service carry (anchor
    and svc_total), bit for bit. Returns the plan and the plain carry."""
    plan = policy_scan.plan_for(pods, nodes, lspec, threads, cluster, resident)
    got_nodes = {k: v.clone() for k, v in nodes.items()}
    ref_nodes = {k: v.clone() for k, v in nodes.items()}
    got = policy_scan._call(lib, pods, got_nodes, weights, lspec, None, plan)
    ref, ref_nodes = policy_scan.plain_policy_scan_with_state(pods, ref_nodes, weights, lspec)
    assert torch.equal(got, ref), f"{int((got != ref).sum())} decisions differ"
    for k in CARRY_KEYS + POLICY_CARRY_KEYS:
        if k in ref_nodes:
            assert torch.equal(got_nodes[k], ref_nodes[k]), f"carry field {k} differs"
    return plan, ref_nodes


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("shape", sorted(workload.POLICY_SHAPES))
@pytest.mark.parametrize("seed", range(3))
def test_emulated_policy_kernel_64_threads(emulated_policy, shape, seed, cluster):
    """Every policy shape on seeded small clusters, CTAs of two warps
    over the 128 padded nodes: predicate subsets, weights, label
    presence and preference, service affinity with an anchor on an
    unknown node, one and two anti-affinity instances, and the full
    vocabulary."""
    pods, nodes, weights, lspec = _policy_state(shape, seed)
    plan, _ = _check_policy_case(emulated_policy, pods, nodes, weights, lspec, 64, cluster)
    assert plan.cluster == cluster and plan.resident


@pytest.mark.parametrize("shape", ["full_vocabulary", "anti_affinity_two", "service_affinity"])
def test_emulated_policy_kernel_full_block(emulated_policy, shape):
    """The wrapper's own thread count on a cluster of 8: one thread per
    node of a 16-node slice."""
    pods, nodes, weights, lspec = _policy_state(shape, 4)
    plan, _ = _check_policy_case(emulated_policy, pods, nodes, weights, lspec, None, 8)
    assert (plan.cluster, plan.nodes_per_cta, plan.threads) == (8, 16, 32)


@pytest.mark.parametrize("cluster", [1, 4])
@pytest.mark.parametrize("threads", [32, 64])
def test_emulated_policy_ties_and_unplaceable_pods(emulated_policy, threads, cluster):
    """300 pods over 45 nodes of nine kinds under the full vocabulary:
    equal best scores held by nodes of different threads and CTAs (the
    lowest index must win), and pods pinned to -2 or past the node axis,
    which fit nowhere, between placed ones (two in a row take no cluster
    step)."""
    pods, nodes, weights, lspec = _policy_objects_state(workload.FULL_VOCABULARY_POLICY, 300, 45, 11)
    pods["pinned"][1::9] = -2
    pods["pinned"][2::13] = 45 + 3
    pods["pinned"][3::9] = -2
    _check_policy_case(emulated_policy, pods, nodes, weights, lspec, threads, cluster)


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("cluster", [2, 4])
def test_emulated_policy_zone_ties_across_ctas(emulated_policy, cluster, resident):
    """Anti-affinity on `rack` (ten zones, each with nodes in every CTA)
    over 40 nodes of nine kinds: the first pod's best score is held by
    nodes of several CTAs, and the lowest index must win; the zone sums
    are exchanged between the CTAs at every step with peers."""
    policy = {"predicates": workload.POLICY_SHAPES["anti_affinity_one"]["predicates"],
              "priorities": [{"name": "LeastRequestedPriority", "weight": 1},
                             {"name": "spread-rack", "weight": 2,
                              "argument": {"serviceAntiAffinity": {"label": "rack"}}}]}
    pods, nodes, weights, lspec = _policy_objects_state(policy, 160, 40, 3)
    from kubernetes_tpu_torch.ops.solver import _feasible, _scores

    idx = torch.arange(40, dtype=torch.int32)
    pod = {k: v[0] for k, v in pods.items()}
    feas = _feasible(pod, nodes, idx, lspec)
    masked = torch.where(feas, _scores(pod, nodes, weights, lspec, feas), -1)
    npc = policy_scan.plan_for(pods, nodes, lspec, 32, cluster).nodes_per_cta
    holders = (masked == masked.max()).nonzero().flatten() // npc
    assert len(set(holders.tolist())) > 1, "the case must hold a tie across CTAs"
    plan, _ = _check_policy_case(emulated_policy, pods, nodes, weights, lspec, 32, cluster, resident)
    assert plan.resident == resident


@pytest.mark.parametrize("resident", [True, False])
def test_emulated_policy_anchor_in_another_cta(emulated_policy, resident):
    """Service affinity on `zone` and `rack` over 40 nodes in 4 CTAs of
    12: the bound peers anchor six services on nodes 0, 7 and 14, so
    anchors lie in slices other than the placed pod's, and the anchor's
    labels are read from device memory."""
    policy = workload.POLICY_SHAPES["service_affinity"]
    pods, nodes, weights, lspec = _policy_objects_state(policy, 600, 40, 5)
    plan, ref_nodes = _check_policy_case(emulated_policy, pods, nodes, weights, lspec, 32, 4, resident)
    anchors = ref_nodes["anchor"][ref_nodes["anchor"] >= 0]
    assert len(set((anchors // plan.nodes_per_cta).tolist())) > 1
    assert not torch.equal(ref_nodes["svc_total"], nodes["svc_total"])


@pytest.mark.parametrize("n_nodes", [1, 2, 3, 5, 13])
def test_emulated_policy_fewer_nodes_than_cluster_slots(emulated_policy, n_nodes):
    """N < C and N not a multiple of C on 4 CTAs under the full
    vocabulary: some CTAs own no node and still take every barrier and
    every zone exchange."""
    pods, nodes, weights, lspec = _policy_objects_state(
        workload.FULL_VOCABULARY_POLICY, 60, n_nodes, 6)
    _check_policy_case(emulated_policy, pods, nodes, weights, lspec, 32, 4)


@pytest.mark.parametrize("cluster", [1, 4])
def test_emulated_policy_two_instances_one_of_weight_zero(emulated_policy, cluster):
    """Two anti-affinity instances on `zone`, the first of weight 0:
    the zone sums of both are exchanged, and the first adds nothing."""
    pods, nodes, weights, lspec = _policy_state("anti_affinity_one", 2, pad_to=1)
    nz = lspec.aa_zones[0]
    lspec = lspec._replace(aa_weights=(0, lspec.aa_weights[0]), aa_zones=(nz, nz))
    nodes = dict(nodes, aa_zone=nodes["aa_zone"].repeat(1, 2).contiguous())
    plan, _ = _check_policy_case(emulated_policy, pods, nodes, weights, lspec, 32, cluster)
    assert plan.zone_bins == 2 * nz


@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_emulated_policy_crowded_service_carry(emulated_policy, cluster):
    """200 pods of two services on 6 nodes under the full vocabulary:
    every step has peers, so every step exchanges the zone sums (two
    cluster barriers), and the replicated anchor and svc_total must stay
    equal in every CTA. The sums have one buffer, whatever C: the plan
    counts zone_bins words for them and, with C > 1, as many for the
    partials."""
    pending, nodes, services = workload.synthetic_objects(200, 6, seed=9)
    for j, node in enumerate(nodes):
        node.metadata.labels["rack"] = f"r{j % 3}"
    spec = spec_from_policy(workload.FULL_VOCABULARY_POLICY)
    d = device_snapshot(build_snapshot(pending, nodes, services=services, spec=spec), "cpu", 1)
    plan, ref_nodes = _check_policy_case(
        emulated_policy, d.pods, d.nodes, d.weights, d.lowered, 32, cluster)
    assert float(ref_nodes["svc_total"][:-1].sum()) > 100
    widths = policy_scan._layout_widths(2, 2, 2, 8, 1, d.lowered, 0)
    one = policy_scan.smem_bytes(6, *widths[:-1], plan.zone_bins, cluster, True)
    none = policy_scan.smem_bytes(6, *widths[:-1], 0, cluster, True)
    assert one - none == policy_scan._round_up(4 * plan.zone_bins, 16) * (2 if cluster > 1 else 1)


def _crowded_rack(host_ports=0):
    """200 pods of two services on 6 nodes, racks r0-r2, under the full
    vocabulary: every step has peers and exchanges the zone sums."""
    pending, nodes, services = workload.synthetic_objects(200, 6, seed=9)
    for j, node in enumerate(nodes):
        node.metadata.labels["rack"] = f"r{j % 3}"
    spec = spec_from_policy(workload.FULL_VOCABULARY_POLICY)
    d = device_snapshot(build_snapshot(pending, nodes, services=services, spec=spec), "cpu", 1)
    return d.pods, d.nodes, d.weights, d.lowered


@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_emulated_policy_crowded_service_carry_in_place(emulated_policy, cluster):
    """The crowded case above in place: the zone sums go through the two
    device buffers, which must be cleared one zone step late and never
    while a CTA still reads them; a single CTA commits the service carry
    in device memory."""
    pods, nodes, weights, lspec = _crowded_rack()
    plan, _ = _check_policy_case(emulated_policy, pods, nodes, weights, lspec, 32, cluster, False)
    assert not plan.resident


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("cluster", [1, 4])
def test_emulated_policy_runtime_widths(emulated_policy, cluster, resident):
    """Under the full vocabulary, pods asking for 70 host ports between
    them (4-word port bitsets) over 40 nodes: the instance that takes
    its widths from the arguments, with its own strides when the slices
    stay in device memory."""
    pending, nodes, assigned, services = workload.policy_objects(160, 40, 7, host_ports=70)
    spec = spec_from_policy(workload.FULL_VOCABULARY_POLICY)
    d = device_snapshot(build_snapshot(pending, nodes, assigned, services, spec=spec), "cpu", 1)
    widths = tuple(d.pods[k].shape[1] for k in ("sel", "port", "vol_any", "svc_ids"))
    assert widths != (2, 2, 2, 8) and d.pods["port"].shape[1] == 4
    plan, ref_nodes = _check_policy_case(
        emulated_policy, d.pods, d.nodes, d.weights, d.lowered, 32, cluster, resident)
    assert plan.resident == resident
    assert int(ref_nodes["uport"][:, 2:].ne(0).sum()) > 0, "the upper port words must be used"


@pytest.mark.parametrize("resident", [True, False])
def test_emulated_policy_hostname_like_zones(emulated_policy, resident):
    """Anti-affinity on a label with a value per node (a hostname-like
    vocabulary: 40 values, 48 bins) over 40 nodes in 4 CTAs: nearly
    every bin is non-zero and held by one node of one CTA."""
    policy = {"predicates": workload.POLICY_SHAPES["anti_affinity_one"]["predicates"],
              "priorities": [{"name": "LeastRequestedPriority", "weight": 1},
                             {"name": "spread-host", "weight": 3,
                              "argument": {"serviceAntiAffinity": {"label": "host"}}}]}
    pending, nodes, assigned, services = workload.policy_objects(300, 40, 4)
    for j, node in enumerate(nodes):
        node.metadata.labels["host"] = f"h{j}"
    d = device_snapshot(build_snapshot(pending, nodes, assigned, services,
                                       spec=spec_from_policy(policy)), "cpu", 1)
    assert d.lowered.aa_zones == (48,)
    plan, _ = _check_policy_case(emulated_policy, d.pods, d.nodes, d.weights, d.lowered, 32, 4,
                                 resident)
    assert plan.resident == resident


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("n_aa,n_aff", [(9, 1), (12, 1), (1, 9), (12, 9)])
def test_emulated_policy_past_eight_instances_and_labels(emulated_policy, n_aa, n_aff, cluster,
                                                          resident):
    """Nine and twelve anti-affinity instances (the ninth on take their
    weights, zones and first bins from device memory) and nine affinity
    labels (the ninth's requirement worked out again at each node, and
    it decides where pods fit), resident and in place."""
    pending, nodes, assigned, services = workload.wide_objects(160, 40, 3)
    spec = spec_from_policy(workload.wide_policy(n_aa, n_aff))
    d = device_snapshot(build_snapshot(pending, nodes, assigned, services, spec=spec), "cpu", 1)
    assert len(d.lowered.aa_weights) == n_aa and (n_aff == 1 or d.pods["aff_pin"].shape[1] == n_aff)
    plan, _ = _check_policy_case(emulated_policy, d.pods, d.nodes, d.weights, d.lowered, 32,
                                 cluster, resident)
    assert plan.resident == resident


@pytest.mark.parametrize(
    "widths",
    [(5120, 2, 2, 2, 8, 1, 1, 1, 513, 16, 16, 1), (40, 1, 4, 1, 8, 2, 0, 2, 33, 32, 4, 1),
     (3, 2, 2, 2, 8, 0, 0, 0, 0, 0, 2, 0), (0, 2, 2, 2, 8, 0, 0, 0, 0, 0, 1, 1),
     (5120, 2, 2, 2, 8, 1, 1, 1, 513, 5008, 4, 0)],
)
def test_emulated_policy_layout_equals_the_plan(emulated_policy, widths):
    """The kernel's shared-memory layout and the Python plan agree."""
    assert emulated_policy.ktt_policy_smem_bytes(*widths) == policy_scan.smem_bytes(*widths)


# ---------------------------------------------------------------------------
# The defrag plan kernel (K2): screen in parallel, resolve in order.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def emulated_rebalance(tmp_path_factory):
    """The defrag plan kernel's source compiled against the emulation
    headers."""
    handle = _compile_emulated(tmp_path_factory, "rebalance_kernel")
    rebalance._bind(handle)
    return handle


def _check_plan(lib, args, **plan):
    """The emulated kernel, through the wrapper's own argument handling,
    against the plain loop: every output bit for bit. `plan` forces
    launch_plan's choices. Returns the plan, the plain outputs and the
    kernel's stats."""
    tensors = stage(args[:-1], rebalance._DTYPES, torch.device("cpu"))
    lp = rebalance.launch_plan(tensors[0].shape[0], tensors[8].shape[0], tensors[13].shape[0],
                               **plan)
    got = rebalance._call(lib, tensors, int(args[-1]), None, lp)
    ref = rebalance.plan_moves_plain(*tensors, args[-1])
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == r.dtype and g.shape == r.shape, f"output {i}"
        assert torch.equal(g, r), f"output {i} differs"
    stats = dict(zip(rebalance.STATS, rebalance.plan_moves.last_stats.tolist()))
    return lp, ref, stats


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("seed", range(8))
def test_emulated_rebalance_64_threads(emulated_rebalance, seed, resident):
    """Seeded worklists on two CTAs of two warps: N from 1 to 300 (several
    nodes a lane), sources out of range, dead and forced rows, budgets
    from 0 to D + 3; the carry in shared memory or in the device scratch;
    first windows of 1 to 8 rows, so that windows restart."""
    plan, _, _ = _check_plan(emulated_rebalance, workload.random_rebalance_args(seed), cluster=2,
                             threads=64, first_rows=1 + seed, resident=resident)
    assert plan.resident == resident


@pytest.mark.parametrize("seed", range(8, 12))
def test_emulated_rebalance_full_block(emulated_rebalance, seed):
    """The wrapper's own plan: one CTA of 1,024 threads for these sizes,
    K = 8, windows of at most 32 rows (one a warp; at most D)."""
    args = workload.random_rebalance_args(seed)
    plan, _, _ = _check_plan(emulated_rebalance, args)
    assert (plan.cluster, plan.threads, plan.k) == (1, 1024, rebalance.DEFAULT_K)
    assert plan.first_rows == plan.max_rows == min(32, len(args[8]))


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("threads", [32, 64, 128])
def test_emulated_rebalance_ties_across_warps(emulated_rebalance, threads, resident):
    """200 identical nodes, forced rows: every feasible node ties, and
    the winner (the lowest index) moves as the carry fills, across the
    warps of two CTAs and the warps that merge a row's chunks."""
    _, ref, _ = _check_plan(emulated_rebalance, workload.tied_rebalance_args(200, 40, 40),
                            cluster=2, threads=threads, first_rows=4, resident=resident)
    dest = ref[0].numpy()
    assert int(ref[3]) == 40 and dest[0] == 1 and len(set(dest.tolist())) > 1


@pytest.mark.parametrize("case", ["no_rows", "one_node", "budget_zero", "invalid_src",
                                  "consolidation", "many_probes", "probes_26000"])
def test_emulated_rebalance_edges(emulated_rebalance, case):
    """D = 0 (only the scores), N = 1 (no destination but the source),
    budget 0, sources of -2, -1, N and N + 5, the consolidation case,
    70 probes (three per lane in the gain), and 26,000 probes (no
    shared memory holds them; the kernel never stages them there)."""
    if case == "probes_26000":
        args = workload.with_random_probes(workload.tied_rebalance_args(10, 6, 6), 26000)
        plan, _, _ = _check_plan(emulated_rebalance, args, threads=32)
        assert plan.resident and plan.smem_bytes == rebalance.smem_bytes(10, plan.max_rows, True)
        return
    if case == "many_probes":
        args = workload.with_random_probes(workload.random_rebalance_args(4), 70)
    elif case == "no_rows":
        args = list(workload.random_rebalance_args(2))
        for k in range(8, 13):
            args[k] = args[k][:0]
        args = tuple(args)
    elif case == "one_node":
        args = workload.tied_rebalance_args(1, 5, 5, src=[0, -1, 0, 1, 0])
    elif case == "budget_zero":
        args = workload.tied_rebalance_args(50, 10, 0)
    elif case == "invalid_src":
        args = workload.tied_rebalance_args(60, 8, 8, src=[-2, -1, 60, 65, 3, 59, 60, -1])
    else:
        args = workload.consolidation_args()
    for resident in (True, False):
        _, ref, _ = _check_plan(emulated_rebalance, args, cluster=2, threads=32, first_rows=2,
                                resident=resident)
    if case == "one_node":
        assert int(ref[3]) == 2  # the rows without a valid source move to node 0
    if case == "budget_zero":
        assert int(ref[3]) == 0 and not bool(ref[1].any())


@pytest.mark.parametrize("widths", [(5000, 3411, 1), (5000, 4096, 0), (1, 1, 1), (19000, 4096, 0),
                                    (9185, 256, 1), (300, 79, 1)])
def test_emulated_rebalance_layout_equals_the_plan(emulated_rebalance, widths):
    """The kernel's shared-memory and scratch layouts and the Python plan
    agree."""
    N, rows, resident = widths
    assert emulated_rebalance.ktt_rebalance_smem_bytes(N, rows, resident) == \
        rebalance.smem_bytes(N, rows, bool(resident))
    for k, warps in ((1, 2), (8, 512), (32, 16)):
        assert emulated_rebalance.ktt_rebalance_scratch_bytes(N, k, rows, warps, resident) == \
            rebalance.scratch_bytes(N, k, rows, warps, bool(resident))


# -- the window's restart paths, at K = 1 and 2 ------------------------------


def _columns(cpu_cap, mem_cap, pods_cap, cpu_fit, mem_fit, pods_used, live=None):
    n = len(cpu_cap)
    f = lambda v: np.asarray(v, np.float32)
    live = np.ones(n, bool) if live is None else np.asarray(live, bool)
    return (f(cpu_cap), f(mem_cap), f(pods_cap), f(cpu_fit), f(mem_fit), f(pods_used),
            np.zeros(n, bool), live)


def _rows(cpu, mem, src, live=None, force=None, budget=None):
    d = len(cpu)
    return (np.asarray(cpu, np.float32), np.asarray(mem, np.float32), np.asarray(src, np.int32),
            np.ones(d, bool) if live is None else np.asarray(live, bool),
            np.ones(d, bool) if force is None else np.asarray(force, bool)), \
        np.int32(d if budget is None else budget)


_PROBES = (np.asarray([250.0, 1000.0, 0.0], np.float32), np.asarray([64.0, 512.0, 256.0], np.float32),
           np.ones(3, np.int32), np.ones(3, bool))


def _dense(seed, n=48, d=96, dead_every=0, budget=None):
    """n roomy nodes, d small forced rows: every row is feasible and
    commits (budget permitting); dead_every > 0 makes every such row
    dead."""
    rng = np.random.default_rng(seed)
    cols = _columns(np.full(n, 4000), np.full(n, 8192), np.full(n, 110),
                    rng.integers(0, 2000, n), rng.integers(0, 4096, n), rng.integers(0, 50, n))
    live = None if not dead_every else np.arange(d) % dead_every != 1
    rows, b = _rows(rng.choice([50.0, 100.0, 250.0], d), rng.choice([16.0, 64.0], d),
                    rng.integers(0, n, d), live=live, budget=budget)
    return cols + rows + _PROBES + (b,)


def _freed_source():
    """Node 0 is full; row 0 moves its pod away, and row 1's pod then fits
    node 0 exactly: a source that becomes a later row's destination, and
    a node infeasible at the window's start that a commit makes
    feasible."""
    cols = _columns(np.full(6, 1000), np.full(6, 1024), np.full(6, 40),
                    [1000, 400, 300, 200, 100, 0], [512] * 6, [10] * 6)
    rows, b = _rows([500, 500, 100, 250, 250, 100], [64] * 6, [0, 5, 4, 3, 0, 2])
    return cols + rows + _PROBES + (b,)


def _slot_freed():
    """Node 0 has no pod slot left until row 0 moves a pod off it; then
    its 200 free millicores make it the tightest fit of the later small
    rows."""
    cols = _columns(np.full(8, 4000), np.full(8, 8192), np.full(8, 10),
                    [3900, 3000, 3500, 2500, 3700, 2000, 3000, 3800], [100] * 8,
                    [10, 3, 2, 4, 1, 5, 6, 2])
    rows, b = _rows([100, 50, 50, 50, 50, 50, 50, 50], [16] * 8, [0, 1, 2, 3, 4, 5, 6, 7])
    return cols + rows + _PROBES + (b,)


def _few_feasible():
    """Only one node (or none) is feasible for most rows: node 2 is full
    and node 3 is not live, so a row on node 0 or 1 has one destination,
    fewer than K = 2."""
    cols = _columns([1000, 1000, 1000, 1000], [1024] * 4, [40] * 4, [0, 100, 1000, 0],
                    [0] * 4, [1] * 4, live=[1, 1, 1, 0])
    rows, b = _rows([100, 200, 100, 300, 50, 900, 100], [8] * 7, [0, 1, 1, 0, 2, 0, 1])
    return cols + rows + _PROBES + (b,)


_RESTART_CASES = {
    "dense_forced": lambda: _dense(0),
    "ties": lambda: workload.tied_rebalance_args(120, 48, 48),
    "freed_source": _freed_source,
    "slot_freed": _slot_freed,
    "budget_mid_window": lambda: _dense(1, budget=7),
    "dead_rows": lambda: _dense(2, dead_every=3),
    "few_feasible": _few_feasible,
    "nodes_below_threads": lambda: workload.tied_rebalance_args(5, 30, 30),
    "in_place": lambda: _dense(3),
}


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(_RESTART_CASES))
def test_emulated_rebalance_windows_restart(emulated_rebalance, case, cluster, k):
    """K = 1 or 2, a first window of 2 to 4 rows and windows of up to 64
    on 1, 2 and 4 CTAs of two warps: lists run out of untouched pairs,
    windows end early and the
    next screen starts at the row that could not be resolved; every output
    equal to the plain loop's. The cases: every row forced and feasible;
    ties on every node (the K pairs all in S at once); a source that
    becomes a later row's destination, infeasible at the window's start;
    a pod slot a commit frees; the budget spent inside a window; dead rows
    inside a window; fewer feasible nodes than K; fewer nodes than the
    cluster's threads; and the carry in place."""
    args = _RESTART_CASES[case]()
    plan, ref, stats = _check_plan(emulated_rebalance, args, cluster=cluster, threads=64, k=k,
                                   first_rows=2 + cluster % 3, max_rows=64,
                                   resident=case != "in_place")
    assert plan.resident == (case != "in_place")
    moves = int(ref[3])
    if case in ("dense_forced", "dead_rows", "in_place"):
        assert bool(ref[1][np.asarray(args[11])].all()) and moves == int(np.asarray(args[11]).sum())
    if case == "budget_mid_window":
        assert moves == 7 and stats["rows_screened"] < len(args[8])
    if case == "freed_source":
        assert int(ref[0][1]) == 0  # row 1 lands on row 0's source
    if case == "slot_freed":
        assert 0 in ref[0][1:].tolist()
    if case in ("dense_forced", "ties", "in_place"):
        assert stats["early_ends"] > 0 and stats["windows"] > 1


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("probes", [2, 70])
def test_emulated_rebalance_deferred_gains(emulated_rebalance, probes, resident):
    """Forced rows shuffling pods among three nodes: S never fills, so
    one window takes all 200 commits, and the gains of forced commits,
    worked out after the serial chain from the carry logged at each
    commit, fill their log three times over (a lane a commit for 2
    probes, the warp a commit for 70)."""
    args = workload.tied_rebalance_args(3, 200, 200)
    if probes == 70:
        args = workload.with_random_probes(args, 70)
    _, ref, stats = _check_plan(emulated_rebalance, args, cluster=2, threads=64, k=8,
                                first_rows=256, max_rows=256, resident=resident)
    assert int(ref[3]) == 200 and stats["windows"] == 1
    assert stats["resolve_gains"] > 3 * rebalance.DEFER_CAP


# ---------------------------------------------------------------------------
# K1S: the shard step of the node-sharded scan
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def emulated_shard(tmp_path_factory):
    """The shard-step kernel's source compiled against the emulation
    headers: one block a launch, a launch a step of a shard."""
    handle = _compile_emulated(tmp_path_factory, "shard_scan_kernel")
    shard_scan._bind(handle)
    return handle


def _mesh_of(shards):
    return Mesh((torch.device("cpu"),) * shards)


def _check_shard_case(lib, pods, nodes, weights, shards):
    """The emulated K1S chain over `shards` CPU shards against the
    unsharded plain scan (decisions and carry) and against the sharded
    chain of `plain_shard_step` (decisions, carry and slots' outcome)."""
    mesh = _mesh_of(shards)
    pad = (-nodes["cpu_cap"].shape[0]) % shards
    if pad:
        nodes = {k: torch.cat([v, torch.zeros((pad,) + v.shape[1:], dtype=v.dtype)])
                 for k, v in nodes.items()}
    got = shard_nodes(nodes, mesh)
    plain = shard_nodes(nodes, mesh)
    ref = {k: v.clone() for k, v in nodes.items()}
    choice = shard_scan.kernel_chain(lib, pods, got, weights)
    ref_choice, ref = scan_kernel.plain_scan_with_state(pods, ref, weights)
    plain_choice, _ = shard_scan.plain_sharded_scan_with_state(pods, plain, weights)
    assert torch.equal(choice, ref_choice), f"{int((choice != ref_choice).sum())} decisions differ"
    assert torch.equal(choice, plain_choice), "the plain shard step decides otherwise"
    stitched, plain_stitched = got.stitched("cpu"), plain.stitched("cpu")
    for k in CARRY_KEYS:
        assert torch.equal(stitched[k], ref[k]), f"carry field {k} differs"
        assert torch.equal(plain_stitched[k], ref[k]), f"plain carry field {k} differs"


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", range(4))
def test_emulated_shard_step_matches_plain(emulated_shard, seed, shards):
    """Shards of one to four over the small clusters, the node axis cut
    unevenly where it does not divide (zero rows pad it: unschedulable)."""
    pods, nodes = _state(seed, pad_to=1)
    _check_shard_case(emulated_shard, pods, nodes, (1, 1, 1), shards)


@pytest.mark.parametrize("weights", [(2, 0, 3), (0, 5, 1)])
def test_emulated_shard_step_other_weights(emulated_shard, weights):
    pods, nodes = _state(1)
    _check_shard_case(emulated_shard, pods, nodes, weights, 4)


def test_emulated_shard_step_repeated_service_ids(emulated_shard):
    """A service id listed twice commits twice, and the next pod's max
    count folds in the winner's count plus both adds."""
    pods, nodes = _state(0, repeat_ids=True)
    _check_shard_case(emulated_shard, pods, nodes, (1, 1, 1), 2)


@pytest.mark.parametrize("shards", [2, 3])
def test_emulated_shard_step_ties_and_crowded_services(emulated_shard, shards):
    """300 pods over 45 nodes of nine kinds (equal best scores on several
    shards: the lowest global index must win) and 200 pods of two
    services on 6 nodes (the max count rises with nearly every commit),
    with blocks of several warps on the wide shards."""
    for n_pods, n_nodes, seed in ((300, 45, 11), (200, 6, 9)):
        pending, nodes, services = workload.synthetic_objects(n_pods, n_nodes, seed=seed)
        d = device_snapshot(build_snapshot(pending, nodes, services=services), "cpu", 1)
        _check_shard_case(emulated_shard, d.pods, d.nodes, (1, 1, 1), shards)


def test_emulated_shard_step_unplaceable_pods_and_pins(emulated_shard):
    """Pods pinned to -2, past the node axis, or to a node of the last
    shard: the HostName pin is read against global indices."""
    pods, nodes = _state(2, pad_to=1)
    pods = {k: v.clone() for k, v in pods.items()}
    N = nodes["cpu_cap"].shape[0]
    pods["pinned"][1::3] = -2
    pods["pinned"][2::7] = N + 3
    pods["pinned"][4::9] = N - 1
    _check_shard_case(emulated_shard, pods, nodes, (1, 1, 1), 3)


def test_emulated_shard_step_multi_warp_shards(emulated_shard):
    """Two shards of 100 nodes: 128-thread blocks whose key and max count
    reduce across four warps."""
    pending, nodes, services = workload.synthetic_objects(120, 200, seed=4)
    d = device_snapshot(build_snapshot(pending, nodes, services=services), "cpu", 1)
    assert shard_scan.threads_for(100) == 128
    _check_shard_case(emulated_shard, d.pods, d.nodes, (1, 1, 1), 2)
