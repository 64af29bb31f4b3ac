// K2: the defrag plan in one launch, on one thread block.
//
// Replaces kubernetes_tpu/ops/rebalance.py:58 plan_moves (an XLA
// lax.scan over the movable pods, not a Pallas kernel). Given the eight
// occupancy columns, a worklist of movable pods (largest first) and the
// capacity plane's probe shapes, it re-places each pod best-fit against
// the occupancy carry as earlier moves left it:
//   - score_before: the capacity plane's fragmentation score of the
//     initial carry;
//   - for each row in order: the feasible nodes (live, room for the
//     pod's cpu, memory and one pod slot, not its own node), the
//     best-fit key floor(clip(min(kc, km), 0, FIT_CAP) * FRAC_Q) of the
//     leftover in the pod's own units, the first minimum over the nodes,
//     and the gain: the change in summed integral probe fits at the
//     source and the destination;
//   - a row commits when it is live, some node is feasible, the move
//     budget lasts, and the gain is positive or the row is forced; the
//     carry moves the pod's requests from source to destination;
//   - score_after over the final carry, and the number of moves.
//
// What bounds it: D dependent steps, each an N-wide evaluation and an
// N-wide minimum whose winner changes what the next step reads. Bytes
// and operations are small beside that chain (about 25 32-bit
// operations a node a row), so a step's latency is the cost. The design
// (simple and right first; a cluster on K1's pattern is later work):
//   - one block of T threads; node j belongs to thread j mod T, which
//     alone reads and writes its carry (cpu_fit, mem_fit, pods_used),
//     held in shared memory (12 B a node) where it fits ("resident",
//     a template parameter) and in a device scratch otherwise. Node
//     constants and the probes come through the read-only cache;
//   - each thread keeps its best (key, node) with the first minimum; a
//     warp takes the minimum key and then the lowest node of that key by
//     two redux instructions, and one lane stores the pair with that
//     node's carry into a slot per warp. The source node's owner stores
//     the source's carry into a slot too. After ONE block barrier every
//     warp reads the slots and picks the same winner; the warps that act
//     on it (warp 0 for the outputs and the move count, the warps of the
//     destination's and the source's owners for their carry) evaluate
//     the gain over the probes (a lane a probe, then four warp sums).
//     Each node's owner commits its own carry; no thread reads another's
//     carry except through the slots, which are double-buffered by the
//     parity of the evaluated row, so one barrier a row is enough;
//   - the move count reaches every thread through a slot read after the
//     next row's barrier: once the budget is spent, every thread stops at
//     the same row. Dead rows and the rows after that commit nothing, so
//     they are not evaluated; their outputs keep -1 / 0 / 0;
//   - the scores are int32 sums (wrapping, as XLA's) over the nodes and
//     live probes, a warp sum and a pass through shared memory, and the
//     JAX ratio in f32.
//
// Parity with the plain version is bit for bit. Build with -fmad=false
// and without fast math; the f32 arithmetic below is spelled with the
// _rn intrinsics besides, and int-to-float conversions round to nearest.
//
// Launcher: plain C, loaded with ctypes. It launches one block on the
// caller's stream, never synchronises, allocates nothing, and returns
// the first CUDA error.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "scan_async.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmemLimit = 232448;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kFitCap = 8192.0f;   // ops/capacity.py FIT_CAP
constexpr float kFracQ = 16.0f;      // FRAC_Q
constexpr float kBigFit = 1048576.0f;  // BIG_FIT
constexpr unsigned kNoFitKey = 1u << 30;  // ops/rebalance.py NO_FIT_KEY

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Fixed shared memory: per-warp slots of the winner [parity][warp] (key,
// node, and that node's cf, mf, pu), the source's carry [parity][4], the
// score sums [warp][2], and the move count after a row [parity].
constexpr int kSlotKey = 0;
constexpr int kSlotNode = kSlotKey + 2 * 32 * 4;
constexpr int kSlotCf = kSlotNode + 2 * 32 * 4;
constexpr int kSlotMf = kSlotCf + 2 * 32 * 4;
constexpr int kSlotPu = kSlotMf + 2 * 32 * 4;
constexpr int kSrcSlot = kSlotPu + 2 * 32 * 4;
constexpr int kSums = kSrcSlot + 2 * 4 * 4;
constexpr int kMoves = kSums + 32 * 2 * 4;
constexpr int kFixedBytes = kMoves + 16;

// Bytes of a launch's dynamic shared memory: the fixed slots, then the
// carry (cf, mf, pu) when resident. ops/rebalance.py mirrors this to plan
// a launch.
__host__ __device__ inline int smem_bytes(int N, int resident) {
  return kFixedBytes + (resident ? round_up(12 * N, 16) : 0);
}

struct PlanArgs {
  const float* cpu_cap;
  const float* mem_cap;
  const float* pods_cap;
  const float* cpu_fit;
  const float* mem_fit;
  const float* pods_used;
  const unsigned char* over;
  const unsigned char* sched;
  const float* pod_cpu;
  const float* pod_mem;
  const int* pod_node;
  const unsigned char* pod_live;
  const unsigned char* pod_force;
  const float* probe_cpu;
  const float* probe_mem;
  const unsigned char* probe_live;
  float* scratch;  // (3, N) carry in device memory when not resident
  int* dest;               // (D,) out
  unsigned char* moved;    // (D,) out
  int* gain;               // (D,) out
  int* n_moves;            // () out
  float* scores;           // (2,) out: before, after
  int D, N, Q, budget;
};

__device__ __forceinline__ bool node_live(const PlanArgs& a, int j) {
  return __ldg(a.sched + j) != 0 && __ldg(a.over + j) == 0;
}

// max(a, 0) as jnp.maximum for the non-NaN values the columns hold.
__device__ __forceinline__ float relu(float x) { return x > 0.0f ? x : 0.0f; }

// One probe's fractional fit on a node's free vector: min over the
// resources of free / max(request, 1) (BIG_FIT for a zero request) and
// the free slots, clipped to [0, FIT_CAP].
__device__ __forceinline__ float probe_fit(float fc, float fm, float fp, float pc, float pm) {
  const float per_cpu = pc > 0.0f ? __fdiv_rn(fc, fmaxf(pc, 1.0f)) : kBigFit;
  const float per_mem = pm > 0.0f ? __fdiv_rn(fm, fmaxf(pm, 1.0f)) : kBigFit;
  const float f = fminf(fminf(per_cpu, per_mem), fp);
  return fminf(fmaxf(f, 0.0f), kFitCap);
}

__device__ __forceinline__ unsigned fit_int(float f) { return (unsigned)(int)floorf(f); }
__device__ __forceinline__ unsigned fit_q(float f) {
  return (unsigned)(int)floorf(__fmul_rn(f, kFracQ));
}

// capacity_report's aggregate score of the carry: int32 totals of the
// integral and quantised fits over the nodes and live probes, then
// 1 - usable * FRAC_Q / potential in f32, clipped to [0, 1]. Every
// thread takes part; thread 0 gets the score.
__device__ float frag_score(const PlanArgs& a, const float* cf, const float* mf, const float* pu,
                            unsigned* sums) {
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31, warp = tid >> 5;
  unsigned usable = 0, potential = 0;
  for (int j = tid; j < a.N; j += T) {
    const float livef = node_live(a, j) ? 1.0f : 0.0f;
    const float fc = __fmul_rn(relu(__fsub_rn(__ldg(a.cpu_cap + j), cf[j])), livef);
    const float fm = __fmul_rn(relu(__fsub_rn(__ldg(a.mem_cap + j), mf[j])), livef);
    const float fp = __fmul_rn(relu(__fsub_rn(__ldg(a.pods_cap + j), pu[j])), livef);
    for (int q = 0; q < a.Q; ++q) {
      if (!__ldg(a.probe_live + q)) continue;
      const float f = probe_fit(fc, fm, fp, __ldg(a.probe_cpu + q), __ldg(a.probe_mem + q));
      usable += fit_int(f);
      potential += fit_q(f);
    }
  }
  usable = __reduce_add_sync(kFull, usable);
  potential = __reduce_add_sync(kFull, potential);
  if (lane == 0) {
    sums[2 * warp] = usable;
    sums[2 * warp + 1] = potential;
  }
  __syncthreads();
  float score = 0.0f;
  if (tid == 0) {
    unsigned u = 0, p = 0;
    for (int w = 0; w < T / 32; ++w) {
      u += sums[2 * w];
      p += sums[2 * w + 1];
    }
    const int ui = (int)u, pi = (int)p;
    if (pi > 0) {
      const float r = __fsub_rn(1.0f, __fdiv_rn(__fmul_rn(__int2float_rn(ui), kFracQ),
                                                __int2float_rn(pi)));
      score = fminf(fmaxf(r, 0.0f), 1.0f);
    }
  }
  __syncthreads();  // the sums are read before anyone reuses them
  return score;
}

template <bool kResident>
__global__ void __launch_bounds__(kMaxThreads, 1) plan_kernel(const PlanArgs a) {
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nw = T >> 5;
  const int N = a.N;
  unsigned char* smem = dyn_smem();
  unsigned* slot_key = reinterpret_cast<unsigned*>(smem + kSlotKey);
  int* slot_node = reinterpret_cast<int*>(smem + kSlotNode);
  float* slot_cf = reinterpret_cast<float*>(smem + kSlotCf);
  float* slot_mf = reinterpret_cast<float*>(smem + kSlotMf);
  float* slot_pu = reinterpret_cast<float*>(smem + kSlotPu);
  float* src_slot = reinterpret_cast<float*>(smem + kSrcSlot);
  unsigned* sums = reinterpret_cast<unsigned*>(smem + kSums);
  int* moves_slot = reinterpret_cast<int*>(smem + kMoves);

  float* cf = kResident ? reinterpret_cast<float*>(smem + kFixedBytes) : a.scratch;
  float* mf = cf + N;
  float* pu = cf + 2 * N;
  for (int j = tid; j < N; j += T) {
    cf[j] = __ldg(a.cpu_fit + j);
    mf[j] = __ldg(a.mem_fit + j);
    pu[j] = __ldg(a.pods_used + j);
  }
  for (int i = tid; i < a.D; i += T) {
    a.dest[i] = -1;
    a.moved[i] = 0;
    a.gain[i] = 0;
  }
  __syncthreads();

  const float before = frag_score(a, cf, mf, pu, sums);

  // `moves`: the moves committed before this row, the same in every
  // thread (read from the slot thread 0 wrote after the last row).
  int moves = 0;
  int parity = 0;
  bool first = true;
  for (int i = 0; i < a.D && a.budget > 0; ++i) {
    if (!__ldg(a.pod_live + i)) continue;  // a dead row never commits
    const float cpu = __ldg(a.pod_cpu + i);
    const float mem = __ldg(a.pod_mem + i);
    const int src = __ldg(a.pod_node + i);
    const bool force = __ldg(a.pod_force + i) != 0;
    const bool src_valid = src >= 0 && src < N;
    float* my_src = src_slot + 4 * parity;
    if (src_valid && src % T == tid) {
      my_src[0] = cf[src];
      my_src[1] = mf[src];
      my_src[2] = pu[src];
    }

    // This thread's best (key, node): the first minimum over its nodes.
    unsigned best_key = kFull;
    int best_j = INT_MAX;
    float bcf = 0.0f, bmf = 0.0f, bpu = 0.0f;
    for (int j = tid; j < N; j += T) {
      const float c = cf[j], m = mf[j], p = pu[j];
      unsigned key = kNoFitKey;
      if (node_live(a, j) && !(src_valid && j == src)) {
        const float fc = relu(__fsub_rn(__ldg(a.cpu_cap + j), c));
        const float fm = relu(__fsub_rn(__ldg(a.mem_cap + j), m));
        const float fp = relu(__fsub_rn(__ldg(a.pods_cap + j), p));
        if (fc >= cpu && fm >= mem && fp >= 1.0f) {
          const float kc = cpu > 0.0f ? __fdiv_rn(__fsub_rn(fc, cpu), fmaxf(cpu, 1.0f)) : kBigFit;
          const float km = mem > 0.0f ? __fdiv_rn(__fsub_rn(fm, mem), fmaxf(mem, 1.0f)) : kBigFit;
          const float kf = fminf(fmaxf(fminf(kc, km), 0.0f), kFitCap);
          key = (unsigned)(int)floorf(__fmul_rn(kf, kFracQ));
        }
      }
      if (key < best_key) {
        best_key = key;
        best_j = j;
        bcf = c;
        bmf = m;
        bpu = p;
      }
    }
    const unsigned wkey = __reduce_min_sync(kFull, best_key);
    const unsigned wj = __reduce_min_sync(kFull, best_key == wkey ? (unsigned)best_j : kFull);
    const unsigned holders = __ballot_sync(kFull, best_key == wkey && (unsigned)best_j == wj);
    if (lane == __ffs(holders) - 1) {
      slot_key[32 * parity + warp] = wkey;
      slot_node[32 * parity + warp] = (int)wj;
      slot_cf[32 * parity + warp] = bcf;
      slot_mf[32 * parity + warp] = bmf;
      slot_pu[32 * parity + warp] = bpu;
    }
    __syncthreads();

    if (!first) moves = moves_slot[parity ^ 1];
    first = false;
    if (moves >= a.budget) break;  // every thread, at the same row

    // Every warp picks the same winner from the slots.
    const unsigned k = lane < nw ? slot_key[32 * parity + lane] : kFull;
    const unsigned jj = lane < nw ? (unsigned)slot_node[32 * parity + lane] : kFull;
    const unsigned gkey = __reduce_min_sync(kFull, k);
    const unsigned gj = __reduce_min_sync(kFull, k == gkey ? jj : kFull);
    const bool any_feasible = gkey < kNoFitKey;
    const int dst = (int)gj;

    // Only the warps that act on the decision take it: warp 0 (the
    // outputs and the move count), the destination's owner and the
    // source's owner (their carry).
    if (warp == 0 || warp == (dst % T) >> 5 || (src_valid && warp == (src % T) >> 5)) {
      const int hw = __ffs(__ballot_sync(kFull, lane < nw && k == gkey && jj == gj)) - 1;
      const float d_cf = slot_cf[32 * parity + hw];
      const float d_mf = slot_mf[32 * parity + hw];
      const float d_pu = slot_pu[32 * parity + hw];

      // Gain: the summed integral probe fit at the source and the
      // destination, after the move less before it. The free vectors
      // [0] source before, [1] source after, [2] destination before,
      // [3] destination after, summed in one pass over this lane's
      // stride of the live probes (the warp sums the lanes).
      float fc[4] = {}, fm[4] = {}, fp[4] = {};
      const bool src_live = src_valid && node_live(a, src);
      if (src_live) {
        const float s_cf = my_src[0], s_mf = my_src[1], s_pu = my_src[2];
        const float ccap = __ldg(a.cpu_cap + src), mcap = __ldg(a.mem_cap + src);
        const float pcap = __ldg(a.pods_cap + src);
        fc[0] = relu(__fsub_rn(ccap, s_cf));
        fm[0] = relu(__fsub_rn(mcap, s_mf));
        fp[0] = relu(__fsub_rn(pcap, s_pu));
        fc[1] = relu(__fsub_rn(ccap, __fsub_rn(s_cf, cpu)));
        fm[1] = relu(__fsub_rn(mcap, __fsub_rn(s_mf, mem)));
        fp[1] = relu(__fsub_rn(pcap, __fsub_rn(s_pu, 1.0f)));
      }
      {
        const float dlive = node_live(a, dst) ? 1.0f : 0.0f;
        const float ccap = __ldg(a.cpu_cap + dst), mcap = __ldg(a.mem_cap + dst);
        const float pcap = __ldg(a.pods_cap + dst);
        fc[2] = __fmul_rn(relu(__fsub_rn(ccap, d_cf)), dlive);
        fm[2] = __fmul_rn(relu(__fsub_rn(mcap, d_mf)), dlive);
        fp[2] = __fmul_rn(relu(__fsub_rn(pcap, d_pu)), dlive);
        fc[3] = relu(__fsub_rn(ccap, __fadd_rn(d_cf, cpu)));
        fm[3] = relu(__fsub_rn(mcap, __fadd_rn(d_mf, mem)));
        fp[3] = relu(__fsub_rn(pcap, __fadd_rn(d_pu, 1.0f)));
      }
      unsigned u[4] = {0u, 0u, 0u, 0u};
      for (int q = lane; q < a.Q; q += 32) {
        if (!__ldg(a.probe_live + q)) continue;
        const float pc = __ldg(a.probe_cpu + q), pm = __ldg(a.probe_mem + q);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (t >= 2 || src_live) u[t] += fit_int(probe_fit(fc[t], fm[t], fp[t], pc, pm));
        }
      }
      const unsigned usb = __reduce_add_sync(kFull, u[0]);
      const unsigned usa = __reduce_add_sync(kFull, u[1]);
      const unsigned udb = __reduce_add_sync(kFull, u[2]);
      const unsigned uda = __reduce_add_sync(kFull, u[3]);
      const int gain = (int)((usa + uda) - (usb + udb));
      const bool commit = any_feasible && (gain > 0 || force);

      if (commit && dst % T == tid) {
        cf[dst] = __fadd_rn(cf[dst], cpu);
        mf[dst] = __fadd_rn(mf[dst], mem);
        pu[dst] = __fadd_rn(pu[dst], 1.0f);
      }
      if (commit && src_valid && src % T == tid) {
        cf[src] = __fsub_rn(cf[src], cpu);
        mf[src] = __fsub_rn(mf[src], mem);
        pu[src] = __fsub_rn(pu[src], 1.0f);
      }
      if (tid == 0) {
        if (commit) {
          a.dest[i] = dst;
          a.moved[i] = 1;
          a.gain[i] = gain;
        }
        moves_slot[parity] = moves + (commit ? 1 : 0);
      }
    }
    parity ^= 1;
  }
  // Thread 0's count after the last row it evaluated (the slot of a row
  // it broke at holds the same count).
  if (tid == 0 && !first) moves = moves_slot[parity ^ 1];

  __syncthreads();  // every commit lands before the carry is scored
  const float after = frag_score(a, cf, mf, pu, sums);
  if (tid == 0) {
    *a.n_moves = moves;
    a.scores[0] = before;
    a.scores[1] = after;
  }
}

}  // namespace

// The dynamic shared memory of a launch.
extern "C" int ktt_rebalance_smem_bytes(int N, int resident) { return smem_bytes(N, resident); }

extern "C" int ktt_rebalance_launch(
    const void* cpu_cap, const void* mem_cap, const void* pods_cap,
    const void* cpu_fit, const void* mem_fit, const void* pods_used,
    const void* over, const void* sched,
    const void* pod_cpu, const void* pod_mem, const void* pod_node,
    const void* pod_live, const void* pod_force,
    const void* probe_cpu, const void* probe_mem, const void* probe_live,
    void* scratch, void* dest, void* moved, void* gain, void* n_moves, void* scores,
    int D, int N, int Q, int budget, int threads, int resident, void* stream) {
  if (D < 0 || N < 1 || Q < 1 || threads < 32 || threads > kMaxThreads || threads % 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PlanArgs a;
  a.cpu_cap = static_cast<const float*>(cpu_cap);
  a.mem_cap = static_cast<const float*>(mem_cap);
  a.pods_cap = static_cast<const float*>(pods_cap);
  a.cpu_fit = static_cast<const float*>(cpu_fit);
  a.mem_fit = static_cast<const float*>(mem_fit);
  a.pods_used = static_cast<const float*>(pods_used);
  a.over = static_cast<const unsigned char*>(over);
  a.sched = static_cast<const unsigned char*>(sched);
  a.pod_cpu = static_cast<const float*>(pod_cpu);
  a.pod_mem = static_cast<const float*>(pod_mem);
  a.pod_node = static_cast<const int*>(pod_node);
  a.pod_live = static_cast<const unsigned char*>(pod_live);
  a.pod_force = static_cast<const unsigned char*>(pod_force);
  a.probe_cpu = static_cast<const float*>(probe_cpu);
  a.probe_mem = static_cast<const float*>(probe_mem);
  a.probe_live = static_cast<const unsigned char*>(probe_live);
  a.scratch = static_cast<float*>(scratch);
  a.dest = static_cast<int*>(dest);
  a.moved = static_cast<unsigned char*>(moved);
  a.gain = static_cast<int*>(gain);
  a.n_moves = static_cast<int*>(n_moves);
  a.scores = static_cast<float*>(scores);
  a.D = D;
  a.N = N;
  a.Q = Q;
  a.budget = budget;
  const int bytes = smem_bytes(N, resident);
  if (bytes > kSmemLimit || (!resident && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void (*kernel)(PlanArgs) = resident ? plan_kernel<true> : plan_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ktt_rebalance_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
