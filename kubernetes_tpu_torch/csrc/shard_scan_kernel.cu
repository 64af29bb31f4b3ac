// The shard step of the node-sharded scan (K1S): one pod against one
// shard's node range, in one block.
//
// Replaces no Pallas kernel. On a device mesh the JAX package runs its
// XLA scan (kubernetes_tpu/ops/solver.py:304 _scan_solve), which GSPMD
// partitions into a sharded evaluation and a small all-reduce a pod. The
// port's single-card kernel (scan_kernel.cu) holds the whole node axis in
// one cluster and cannot be cut over devices, and the same step in eager
// PyTorch costs some forty launches a pod a shard. So each shard takes
// one launch a pod, and the shards meet through a slot each:
//
//   launch t of shard s (t = -1 .. P; ops/shard_scan.py drives them):
//     1. reduce the slots of step t - 1, written by every shard and
//        gathered onto this shard's device: the winning key (the largest;
//        keys hold distinct global node indices, so exactly one shard
//        owns it), its node c, and the max count of pod t's first service;
//     2. commit pod t - 1 at node c if this shard owns c (one thread, then
//        a block barrier): the same adds and ORs as solver._commit; shard
//        0 also writes choice[t - 1];
//     3. evaluate pod t against the shard's nodes with global indices
//        lo + j (the HostName pin and the lowest-index tie-break read
//        them), reduce to the shard's key (score << 32 | ~node), and store
//        the slot of step t: that key, the shard's max count of pod
//        t + 1's service, and that count at the shard's best node.
//   Launch -1 only stores the max counts of pod 0's service; launch P
//   only commits pod P - 1.
//
// ServiceSpreading divides by the max count of the pod's service over
// every node, so that max has to be whole before any shard scores the
// pod. It travels in the slots, as it does between the CTAs of the scan
// kernel: counts only grow, and only at the winner, so the max for pod
// t + 1 is the larger of every shard's max before pod t's commit and the
// winner's count plus what pod t's ids add to it. That costs nothing
// beyond the key's own reduction. The other choice, a per-service max
// kept replicated on every device, would need the winner's new counts
// for all of pod t's ids on every device: a second exchange a pod.
//
// What bounds it: P dependent steps, as the scan kernel. A step moves
// one pod row and a shard's node columns (about 60 bytes a node at the
// main path's widths) and does about 90 32-bit operations a node, so at
// 1,280 nodes a shard the card's rates would allow well under a
// microsecond; a launch's own latency and the slots' exchange are the
// cost. The block keeps no slice in shared memory (a launch cannot carry
// it to the next), and its node columns stay in device memory, read
// once a step and small enough for L2.
//
// Parity with the plain version (ops/shard_scan.plain_shard_step) and
// with the unsharded scan is bit for bit: the arithmetic is the scan
// kernel's (scan_step.cuh). Build with -fmad=false and without fast math.
//
// Launcher: plain C, loaded with ctypes. One block on the caller's
// stream by cudaLaunchKernelEx, never synchronises, allocates nothing,
// returns the first CUDA error.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "scan_async.cuh"
#include "scan_step.cuh"

namespace {

using namespace ktt_step;

constexpr int kMaxThreads = 1024;
constexpr int kSlotWords = 3;  // key, max count of the next pod's service, that count at the best node
constexpr int kMaxShards = 64;
constexpr int kSmemBytes = 32 * (8 + 4);  // a key and a max count per warp

struct StepArgs {
  const int* pod_rows;  // (P, row_words), the scan kernel's packed rows
  // The shard's node constants: rows lo .. lo + n of the node axis.
  const float* cpu_cap;
  const float* mem_cap;
  const float* pods_cap;
  const unsigned char* over;
  const unsigned char* sched;
  const int* labels;  // (n, SW)
  // The shard's carry, updated in place.
  float* cpu_fit;
  float* mem_fit;
  float* cpu_used;
  float* mem_used;
  float* pods_used;
  int* uport;       // (n, PW)
  int* uvol_any;    // (n, VW)
  int* uvol_rw;     // (n, VW)
  int* counts;      // (S, n): the shard's service counts, one row a service
  long long* slots; // (2, shards, kSlotWords): [step parity][shard]
  int* choice;      // (P,): shard 0 writes it, every other shard gets null
  int t, P, row_words, lo, n, S, SW, PW, VW, K, shards, shard;
  int w_lr, w_bra, w_spread;
};

__global__ void __launch_bounds__(kMaxThreads, 1) shard_step_kernel(const StepArgs a) {
  const int tid = (int)threadIdx.x;
  const int T = (int)blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = T >> 5;
  const int t = a.t;
  const int ids_at = kRowBits + a.SW + a.PW + 2 * a.VW;
  long long* red = reinterpret_cast<long long*>(dyn_smem());  // one key per warp
  int* red_max = reinterpret_cast<int*>(red + 32);             // one max count per warp

  auto pod_row = [&](int p) { return a.pod_rows + (size_t)p * a.row_words; };
  // JAX clamps a dynamic index into range; the lowering never gives one
  // outside [-1, S).
  auto svc_row = [&](int svc) { return min(max(svc, 0), a.S - 1); };
  auto count_of = [&](int svc, int j) { return a.counts[(size_t)svc_row(svc) * a.n + j]; };

  // -- 1. the previous step's slots, and 2. its commit ---------------------
  int m = 0;  // the max count of pod t's service over every node
  if (t >= 0) {
    const long long* prev = a.slots + (size_t)((t - 1) & 1) * a.shards * kSlotWords;
    long long win = LLONG_MIN;
    long long mx = INT_MIN;
    int owner = 0;
    for (int s = 0; s < a.shards; ++s) {
      const long long key = prev[s * kSlotWords];
      if (key > win) {
        win = key;
        owner = s;
      }
      mx = max(mx, prev[s * kSlotWords + 1]);
    }
    const int c = (int)(win >> 32) >= 0 ? key_node(win) : -1;
    if (t >= 1) {
      const int q = t - 1;
      const int* row = pod_row(q);
      const int* ids = row + ids_at;
      if (tid == 0 && a.choice != nullptr) a.choice[q] = c;
      if (tid == 0 && c >= a.lo && c < a.lo + a.n) {
        const int j = c - a.lo;
        const float cpu = __int_as_float(row[kRowCpu]);
        const float mem = __int_as_float(row[kRowMem]);
        const int* port = row + kRowBits + a.SW;
        const int* vol_any = port + a.PW;
        const int* vol_rw = vol_any + a.VW;
        a.cpu_fit[j] = __fadd_rn(a.cpu_fit[j], cpu);
        a.mem_fit[j] = __fadd_rn(a.mem_fit[j], mem);
        a.cpu_used[j] = __fadd_rn(a.cpu_used[j], cpu);
        a.mem_used[j] = __fadd_rn(a.mem_used[j], mem);
        a.pods_used[j] = __fadd_rn(a.pods_used[j], 1.0f);
        for (int w = 0; w < a.PW; ++w) a.uport[(size_t)j * a.PW + w] |= port[w];
        for (int w = 0; w < a.VW; ++w) {
          a.uvol_any[(size_t)j * a.VW + w] |= vol_any[w];
          a.uvol_rw[(size_t)j * a.VW + w] |= vol_rw[w];
        }
        // Once per occurrence of an id; ids outside [0, S) commit nothing
        // (JAX's scatter mode="drop").
        for (int k = 0; k < a.K; ++k) {
          if (ids[k] >= 0 && ids[k] < a.S) a.counts[(size_t)ids[k] * a.n + j] += 1;
        }
      }
      // Pod t's max count: every shard's max before pod q's commit, or the
      // winner's count plus what pod q's ids add to pod t's service.
      if (t < a.P && c >= 0) {
        const int svc = pod_row(t)[kRowSvc];
        int adds = 0;
        if (svc >= 0) {
          for (int k = 0; k < a.K; ++k) adds += ids[k] == svc_row(svc);
        }
        if (adds > 0) mx = max(mx, prev[owner * kSlotWords + 2] + adds);
      }
    }
    m = (int)mx;
    __syncthreads();  // the commit reaches every thread of the block
  }

  // -- 3. pod t against the shard's nodes, and the next pod's max count ---
  const bool eval = t >= 0 && t < a.P;
  const int next_svc = t + 1 < a.P ? pod_row(t + 1)[kRowSvc] : -1;
  long long best = LLONG_MIN;
  int next_max = INT_MIN;
  if (eval || next_svc >= 0) {
    const int* row = pod_row(eval ? t : 0);
    const int pin = row[kRowPin];
    const float cpu = __int_as_float(row[kRowCpu]);
    const float mem = __int_as_float(row[kRowMem]);
    const bool zero = row[kRowZero] != 0;
    const int svc = row[kRowSvc];
    const int* sel = row + kRowBits;
    const int* port = sel + a.SW;
    const int* vol_any = port + a.PW;
    const int* vol_rw = vol_any + a.VW;
    for (int j = tid; j < a.n; j += T) {
      if (next_svc >= 0) next_max = max(next_max, count_of(next_svc, j));
      if (!eval) continue;
      const int node = a.lo + j;
      const float cap_c = a.cpu_cap[j];
      const float cap_m = a.mem_cap[j];
      bool ok = (a.sched[j] != 0) &
                resources_fit(cap_c, cap_m, a.pods_cap[j], a.pods_used[j], a.cpu_fit[j],
                              a.mem_fit[j], a.over[j] != 0, cpu, mem, zero);
      for (int w = 0; w < a.SW; ++w) ok &= (sel[w] & a.labels[(size_t)j * a.SW + w]) == sel[w];
      for (int w = 0; w < a.PW; ++w) ok &= (port[w] & a.uport[(size_t)j * a.PW + w]) == 0;
      for (int w = 0; w < a.VW; ++w) {
        ok &= ((vol_rw[w] & a.uvol_any[(size_t)j * a.VW + w]) |
               (vol_any[w] & a.uvol_rw[(size_t)j * a.VW + w])) == 0;
      }
      ok &= (pin == -1) | (pin == node);
      const int total = default_total(cap_c, cap_m, a.cpu_used[j], a.mem_used[j], cpu, mem, svc,
                                      m, [&] { return count_of(svc, j); }, a.w_lr, a.w_bra,
                                      a.w_spread);
      const long long key = make_key(ok ? total : -1, node);
      best = key > best ? key : best;
    }
  }
  best = warp_max_key(best);
  next_max = warp_max_int(next_max);
  if (lane == 0) {
    red[warp] = best;
    red_max[warp] = next_max;
  }
  __syncthreads();
  if (warp == 0 && t < a.P) {
    best = warp_max_key(lane < n_warps ? red[lane] : LLONG_MIN);
    next_max = warp_max_int(lane < n_warps ? red_max[lane] : INT_MIN);
    if (lane == 0) {
      long long* out = a.slots + ((size_t)(t & 1) * a.shards + a.shard) * kSlotWords;
      out[0] = best;
      out[1] = next_max;
      out[2] = next_svc >= 0 && best != LLONG_MIN ? count_of(next_svc, key_node(best) - a.lo) : 0;
    }
  }
}

}  // namespace

extern "C" int ktt_shard_step(
    const void* pod_rows,
    const void* cpu_cap, const void* mem_cap, const void* pods_cap,
    const void* over, const void* sched, const void* labels,
    void* cpu_fit, void* mem_fit, void* cpu_used, void* mem_used,
    void* pods_used, void* uport, void* uvol_any, void* uvol_rw,
    void* counts, void* slots, void* choice,
    int t, int P, int row_words, int lo, int n, int S, int SW, int PW, int VW, int K,
    int shards, int shard, int w_lr, int w_bra, int w_spread, int threads,
    void* stream) {
  if (n < 1 || S < 1 || shards < 1 || shards > kMaxShards || shard < 0 || shard >= shards ||
      threads < 32 || threads > kMaxThreads || threads % 32 || t < -1 || t > P) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StepArgs a;
  a.pod_rows = static_cast<const int*>(pod_rows);
  a.cpu_cap = static_cast<const float*>(cpu_cap);
  a.mem_cap = static_cast<const float*>(mem_cap);
  a.pods_cap = static_cast<const float*>(pods_cap);
  a.over = static_cast<const unsigned char*>(over);
  a.sched = static_cast<const unsigned char*>(sched);
  a.labels = static_cast<const int*>(labels);
  a.cpu_fit = static_cast<float*>(cpu_fit);
  a.mem_fit = static_cast<float*>(mem_fit);
  a.cpu_used = static_cast<float*>(cpu_used);
  a.mem_used = static_cast<float*>(mem_used);
  a.pods_used = static_cast<float*>(pods_used);
  a.uport = static_cast<int*>(uport);
  a.uvol_any = static_cast<int*>(uvol_any);
  a.uvol_rw = static_cast<int*>(uvol_rw);
  a.counts = static_cast<int*>(counts);
  a.slots = static_cast<long long*>(slots);
  a.choice = static_cast<int*>(choice);
  a.t = t;
  a.P = P;
  a.row_words = row_words;
  a.lo = lo;
  a.n = n;
  a.S = S;
  a.SW = SW;
  a.PW = PW;
  a.VW = VW;
  a.K = K;
  a.shards = shards;
  a.shard = shard;
  a.w_lr = w_lr;
  a.w_bra = w_bra;
  a.w_spread = w_spread;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, shard_step_kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ktt_shard_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
