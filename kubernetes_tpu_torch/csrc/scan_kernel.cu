// The sequential-parity scan: the whole default-spec solve in one launch,
// on one thread-block cluster.
//
// Replaces kubernetes_tpu/ops/pallas_scan.py::_kernel. For each pod in
// order, against all N nodes: the resources, pod-count, zero-request,
// selector, ports, disk, hostname and schedulable predicates; integer
// LeastRequested; f32 BalancedResourceAllocation with the +1e-5
// epsilon; integer ServiceSpreading. Then the first max by lowest node
// index, and a commit of the winner into the occupancy carry.
//
// What bounds it: P dependent steps, each an N-wide evaluation and an
// N-wide max whose winner changes what the next step reads. Bytes and
// operations are small beside that chain, so a step's latency is the
// cost. The design spreads each step over a cluster of C CTAs on
// neighbouring SMs and keeps the step's data on chip:
//   - CTA r owns the node slice [r * NPC, (r + 1) * NPC), NPC =
//     ceil(N / C) rounded up to 4; the last slices may be short or
//     empty. Thread t of a CTA owns the slice's nodes t, t + T, ...
//   - the slice's node constants and occupancy carry live in shared
//     memory (struct of arrays) for the whole launch: loaded once,
//     written back once. Only the owning thread of a node reads or
//     writes its carry, so a commit needs no barrier of its own;
//   - service counts stay in device memory as (S, NS) int32, and every
//     entry of a slice's columns is written only by its CTA. The count
//     row a pod reads is fetched three pods ahead into shared memory by
//     cp.async.cg (L2, never a stale L1 line). A commit's adds to device
//     memory are issued one step late, after the block barrier by which
//     every row fetched so far has landed, so the rows in shared memory
//     are known to lack them: the node's owning thread adds them there;
//   - pod rows are staged a tile at a time into shared memory by
//     cp.async, double-buffered, so a step's pod scalars are shared-memory
//     reads. The tile is 128 pods for the widths the lowering nearly
//     always gives, and a power of two down to 8 pods for wider rows (a
//     plan parameter, passed as a shift). A tile is issued 4 pods ahead
//     into the buffer that held the tile before the previous one, and
//     the pods still read at that moment (the step's pod, whose commit
//     flushes one step late, and the next three) lie in the other buffer
//     for any tile of 4 pods or more; the plan keeps 8 as the floor.
//     Rows too wide for two tiles of 8 are read in place from device
//     memory (read only, so through L1), the same code with no staging;
//   - selection: each CTA reduces its slice to one 64-bit key
//     (score << 32 | ~global index, infeasible nodes at -1; warp max by
//     two redux instructions) and stores it into a slot in every CTA's
//     shared memory through distributed shared memory. After one
//     cluster barrier every warp reads the C slots locally and computes
//     the same winner. Slots are double-buffered by the parity of the
//     step, so that one barrier a step is enough;
//   - the max count of the next pod's service, which ServiceSpreading
//     divides by, travels in the same slot: each CTA's max over its
//     slice of that pod's row, and the count at its best node. Counts
//     only grow, and only at the winner, so the new max is the larger
//     of the cluster's old max and the winner's count plus this
//     commit's adds. No second barrier;
//   - a pod that no node can take whatever the carry (the padding's
//     pinned = -2, a pin outside [0, N)) takes no cluster step when the
//     next pod needs no max count either: choice -1, no commit, the same
//     in every CTA;
//   - a step is a chain of latencies (one node's evaluation, the
//     reductions, the cluster barrier, the commit), so the widths the
//     lowering nearly always gives (2-word bitsets, 8 service ids) get
//     their own instance of the kernel, with every loop over words and
//     ids unrolled; other widths run the same code with runtime widths;
//   - a node axis whose slices do not fit the shared memory of the
//     cluster runs "in place": the same code with the slice's constants
//     and carry read and written in device memory by their owning
//     threads (the only readers, so through L1), and the counts read
//     through L2 and added at the commit instead of fetched ahead; shared
//     memory then holds only the pod tiles, the reductions and the slots.
//     The winner still crosses the cluster through DSMEM, one cluster
//     barrier a step. Residency is a template parameter, so the resident
//     instances carry no branch for it.
//
// Parity with the plain version is bit for bit. Build with -fmad=false
// and without fast math; the f32 arithmetic below is spelled with the
// _rn intrinsics besides. JAX's `//` floors where C's `/` truncates:
// floor_div is used wherever an operand may be negative.
//
// Launcher: plain C, loaded with ctypes. It launches one cluster on the
// caller's stream with cudaLaunchKernelEx, never synchronises,
// allocates nothing, and returns the first CUDA error.

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <climits>
#include <cstdint>

#include "scan_async.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 16;
constexpr int kMaxThreads = 1024;
constexpr int kTileShift = 7;  // 128 pods staged per tile, the unrolled instance's
constexpr int kRows = 4;    // count rows in shared memory: the pod's and the next three

// A pod's row in the packed (P, row_words) int32 matrix the wrapper
// builds: scalars, then the sel, port, vol_any, vol_rw words and the
// service ids, zero-padded to a multiple of 4 words.
constexpr int kRowCpu = 0;   // f32 bits
constexpr int kRowMem = 1;   // f32 bits
constexpr int kRowZero = 2;  // 0 or 1
constexpr int kRowPin = 3;
constexpr int kRowSvc = 4;
constexpr int kRowBits = 5;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// What a CTA stores into every CTA's shared memory at each cluster step.
struct Slot {
  long long key;   // the CTA's best (score << 32 | ~node), LLONG_MIN if it has no node
  int max_count;   // its max count of the next pod's service
  int best_count;  // that count at its best node
};

// Byte offsets of the regions of a CTA's dynamic shared memory, each a
// multiple of 16. ops/scan_kernel.py mirrors this to plan a launch.
struct Layout {
  int npc;        // nodes per CTA
  int ns;         // row stride of the service counts, npc * C
  int row_words;  // words of a packed pod row
  int resident;   // 1: the slice and its count rows live in shared memory
  int tile_shift; // log2 of the pods a tile stages; 0: pod rows read in place
  int f32, words, rows, tiles, red, slots, flags, bytes;
};

__host__ __device__ inline Layout make_layout(int N, int SW, int PW, int VW, int K, int C,
                                              int resident, int tile_shift) {
  Layout L;
  L.npc = round_up((N + C - 1) / C, 4);
  L.ns = L.npc * C;
  L.row_words = round_up(kRowBits + SW + PW + 2 * VW + K, 4);
  L.resident = resident;
  L.tile_shift = tile_shift;
  const int kept = resident ? L.npc : 0;  // slice columns held here
  int o = 0;
  L.f32 = o;    o += 8 * 4 * kept;                   // caps, fit, used
  L.words = o;  o += 4 * (SW + PW + 2 * VW) * kept;  // labels, uport, uvol
  L.rows = o;   o += kRows * 4 * kept;               // count rows of 4 pods
  L.tiles = o;  o += tile_shift ? 2 * 4 * (L.row_words << tile_shift) : 0;  // pod tiles, 2
  L.red = o;    o += 32 * (8 + 4);                   // a key and a count per warp
  L.slots = o;  o += 2 * kMaxCluster * 16;           // Slot[parity][CTA]
  L.flags = o;  o += round_up(2 * kept, 16);         // over, sched
  L.bytes = o;
  return L;
}

struct ScanArgs {
  const int* pod_rows;  // (P, row_words)
  // Node constants.
  const float* cpu_cap;
  const float* mem_cap;
  const float* pods_cap;
  const unsigned char* over;
  const unsigned char* sched;
  const int* labels;  // (N, SW)
  // Carry, updated in place.
  float* cpu_fit;
  float* mem_fit;
  float* cpu_used;
  float* mem_used;
  float* pods_used;
  int* uport;     // (N, PW)
  int* uvol_any;  // (N, VW)
  int* uvol_rw;   // (N, VW)
  int* counts;    // (S, NS)
  int* choice;    // (P,) out
  int P, N, S, SW, PW, VW, K, C;
  int w_lr, w_bra, w_spread;
  Layout L;
};

// int32 arithmetic that wraps like JAX's instead of being undefined.
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// JAX's `//` for a positive divisor.
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// priorities.go:31-40: ((cap - req) * 10) // cap, 0 if cap == 0 or
// req > cap (and 0 for cap < 0, where JAX's where() gives 0 too).
__device__ __forceinline__ int least_requested(int req, int cap) {
  if (cap <= 0 || req > cap) return 0;
  return floor_div(wmul(wsub(cap, req), 10), cap);
}

// req / max(cap, 1) as JAX computes an int32 true division: both
// operands converted to f32, then one IEEE divide; 1.0 when cap == 0.
__device__ __forceinline__ float fraction(int req, int cap) {
  if (cap == 0) return 1.0f;
  return __fdiv_rn(__int2float_rn(req), __int2float_rn(cap > 1 ? cap : 1));
}

// (value, node) -> a key whose signed order is value first, then the
// LOWER node index.
__device__ __forceinline__ long long make_key(int value, int node) {
  unsigned long long hi = (unsigned long long)(unsigned)value << 32;
  return (long long)(hi | (unsigned long long)(0xffffffffu - (unsigned)node));
}

// Warp-wide max of 64-bit keys: the score half, then the index half
// among the lanes that hold the best score (two redux instructions).
__device__ __forceinline__ long long warp_max_key(long long v) {
  const int hi = (int)(v >> 32);
  const int best_hi = __reduce_max_sync(0xffffffffu, hi);
  const unsigned best_lo = __reduce_max_sync(0xffffffffu, hi == best_hi ? (unsigned)v : 0u);
  return (long long)(((unsigned long long)(unsigned)best_hi << 32) | best_lo);
}

__device__ __forceinline__ int warp_max_int(int v) { return __reduce_max_sync(0xffffffffu, v); }

// Widths kSW, kPW, kVW, kK > 0 are compile-time constants (the bitset
// and service-id loops unroll); 0 takes the width from the arguments.
// kResident picks where the slice lives at compile time, so a resident
// launch's pointers are known to be shared memory and its step carries
// no branch for the in-place case. kTsh > 0 fixes the tile's shift, 0
// takes it from the layout, and -1 reads the pod rows in place: a
// staged instance's pod rows are then known to be shared memory.
template <int kSW, int kPW, int kVW, int kK, bool kResident, int kTsh>
__global__ void __launch_bounds__(kMaxThreads, 1) scan_kernel(const ScanArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L = a.L;
  const int C = a.C;
  const int r = (int)cluster.block_rank();
  const int T = (int)blockDim.x;
  const int tid = (int)threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = T >> 5;
  const int N = a.N;
  const int S = a.S;
  const int SW = kSW > 0 ? kSW : a.SW;
  const int PW = kPW > 0 ? kPW : a.PW;
  const int VW = kVW > 0 ? kVW : a.VW;
  const int K = kK > 0 ? kK : a.K;
  const int NPC = L.npc;
  const int start = r * NPC;
  const int n_real = max(0, min(NPC, N - start));  // nodes of the slice that exist
  const int ids_at = kRowBits + SW + PW + 2 * VW;   // service ids in a pod row
  constexpr bool resident = kResident;
  constexpr bool staged = kTsh >= 0;  // pod rows staged in tiles, else read in place
  const int tsh = kTsh > 0 ? kTsh : staged ? L.tile_shift : 0;
  const int tmask = (1 << tsh) - 1;

  unsigned char* sm = dyn_smem();
  // The slice's columns: word w of node j of a word column at
  // [w * ws + j * ns_*], in shared memory or (in place) device memory.
  const float *cpu_cap, *mem_cap, *pods_cap;
  float *cpu_fit, *mem_fit, *cpu_used, *mem_used, *pods_used;
  const int* labels;
  int *uport, *uvol_any, *uvol_rw;
  const unsigned char *over, *sched;
  int ws, ns_sel, ns_port, ns_vol;
  if (resident) {
    float* f = reinterpret_cast<float*>(sm + L.f32);
    cpu_cap = f;
    mem_cap = f + NPC;
    pods_cap = f + 2 * NPC;
    cpu_fit = f + 3 * NPC;
    mem_fit = f + 4 * NPC;
    cpu_used = f + 5 * NPC;
    mem_used = f + 6 * NPC;
    pods_used = f + 7 * NPC;
    int* w = reinterpret_cast<int*>(sm + L.words);
    labels = w;
    uport = w + SW * NPC;
    uvol_any = uport + PW * NPC;
    uvol_rw = uvol_any + VW * NPC;
    over = sm + L.flags;
    sched = over + NPC;
    ws = NPC;
    ns_sel = ns_port = ns_vol = 1;
  } else {
    cpu_cap = a.cpu_cap + start;
    mem_cap = a.mem_cap + start;
    pods_cap = a.pods_cap + start;
    cpu_fit = a.cpu_fit + start;
    mem_fit = a.mem_fit + start;
    cpu_used = a.cpu_used + start;
    mem_used = a.mem_used + start;
    pods_used = a.pods_used + start;
    labels = a.labels + (size_t)start * SW;
    uport = a.uport + (size_t)start * PW;
    uvol_any = a.uvol_any + (size_t)start * VW;
    uvol_rw = a.uvol_rw + (size_t)start * VW;
    over = a.over + start;
    sched = a.sched + start;
    ws = 1;
    ns_sel = SW;
    ns_port = PW;
    ns_vol = VW;
  }
  int* rowbuf = reinterpret_cast<int*>(sm + L.rows);  // [pod % kRows][NPC], resident
  int* tiles = reinterpret_cast<int*>(sm + L.tiles);  // [tile parity][tile][row_words]
  long long* red = reinterpret_cast<long long*>(sm + L.red);  // one key per warp
  int* red_max = reinterpret_cast<int*>(red + 32);             // one max count per warp
  Slot* slots = reinterpret_cast<Slot*>(sm + L.slots);         // [parity][source CTA]

  auto pod_row = [&](int p) -> const int* {
    if (!staged) return a.pod_rows + (size_t)p * L.row_words;
    return tiles + ((p >> tsh) & 1) * (L.row_words << tsh) + (p & tmask) * L.row_words;
  };
  auto count_row = [&](int p) { return rowbuf + (p % kRows) * NPC; };
  // JAX clamps a dynamic index into range; the lowering never gives one
  // outside [-1, S).
  auto svc_row = [&](int svc) { return min(max(svc, 0), S - 1); };
  // The count of pod p's service at node j of the slice (anything when
  // the pod has no service): the row fetched ahead, or, in place, the
  // counts in device memory, which only this node's owning thread adds
  // to and which a block barrier orders before another thread's read.
  auto count_of = [&](int p, int j) -> int {
    if (resident) return count_row(p)[j];
    return __ldcg(a.counts + (size_t)svc_row(pod_row(p)[kRowSvc]) * L.ns + start + j);
  };
  // How many of pod p's service ids name the service of pod q (0 when
  // q does not exist or has no service): what a commit of pod p adds to
  // the count row pod q reads.
  auto adds_to_row = [&](int p, int q) {
    if (q >= a.P) return 0;
    const int svc = pod_row(q)[kRowSvc];
    if (svc < 0) return 0;
    const int* ids = pod_row(p) + ids_at;
    int n = 0;
    for (int k = 0; k < K; ++k) n += ids[k] == svc_row(svc);
    return n;
  };
  // No node can take a pod pinned outside [0, N) (the padding's -2).
  auto unplaceable = [&](int p) {
    const int pin = pod_row(p)[kRowPin];
    return pin != -1 && (pin < 0 || pin >= N);
  };
  // The tile of pods from `first` into its buffer (staged rows only).
  auto issue_tile = [&](int first) {
    if (!staged) return;
    int* dst = tiles + ((first >> tsh) & 1) * (L.row_words << tsh);
    const int* src = a.pod_rows + (size_t)first * L.row_words;
    const int chunks = min(1 << tsh, a.P - first) * L.row_words / 4;
    for (int i = tid; i < chunks; i += T) cp_async16(dst + 4 * i, src + 4 * i);
  };
  // The slice of pod p's service row of the counts, if it has a service
  // (resident).
  auto issue_row = [&](int p) {
    if (!resident) return;
    const int svc = pod_row(p)[kRowSvc];
    if (svc < 0) return;
    int* dst = count_row(p);
    const int* src = a.counts + (size_t)svc_row(svc) * L.ns + start;
    for (int i = tid; i < NPC / 4; i += T) cp_async16(dst + 4 * i, src + 4 * i);
  };
  // Issued after step p's barrier: the count row of pod p + 3 (its pod
  // row landed at step p's block barrier) and the tile that starts at
  // pod p + 4.
  auto prefetch = [&](int p) {
    if (staged && p + 4 < a.P && ((p + 4) & tmask) == 0) issue_tile(p + 4);
    if (p + 3 < a.P) issue_row(p + 3);
  };
  // A commit's adds to the counts in device memory wait one step: they
  // are issued after the next block barrier, when the count rows fetched
  // so far have all landed without them, and before the next fetch,
  // with a barrier between (the step's cluster barrier, or a block
  // barrier on a step without one) that orders them before it. The rows
  // that landed without them (pods p + 1 to p + 3) get the adds from the
  // owning thread instead. pend_j: the node of the commit still
  // to issue (-1 none), pend_p its pod.
  int pend_j = -1, pend_p = 0;
  // Pod p's adds to the counts in device memory at node j of the slice.
  auto add_counts = [&](int p, int j) {
    const int* ids = pod_row(p) + ids_at;
    for (int k = 0; k < K; ++k) {
      // Once per occurrence of an id (a repeated id adds twice); ids
      // outside [0, S) commit nothing (JAX's scatter mode="drop").
      if (ids[k] >= 0 && ids[k] < S) atomicAdd(a.counts + (size_t)ids[k] * L.ns + start + j, 1);
    }
  };
  auto flush_commit = [&]() {
    if (pend_j < 0) return;
    count_row(pend_p + 3)[pend_j] += adds_to_row(pend_p, pend_p + 3);
    add_counts(pend_p, pend_j);
    pend_j = -1;
  };

  // -- prologue: the slice into shared memory, the first pods' rows, and
  // the max count of the first pod's service over the whole cluster -----
  if (a.P > 0) issue_tile(0);
  if (resident) {
    float* f = const_cast<float*>(cpu_cap);
    int* w = const_cast<int*>(labels);
    unsigned char* b = const_cast<unsigned char*>(over);
    for (int j = tid; j < n_real; j += T) {
      const int n = start + j;
      f[j] = a.cpu_cap[n];
      f[NPC + j] = a.mem_cap[n];
      f[2 * NPC + j] = a.pods_cap[n];
      cpu_fit[j] = a.cpu_fit[n];
      mem_fit[j] = a.mem_fit[n];
      cpu_used[j] = a.cpu_used[n];
      mem_used[j] = a.mem_used[n];
      pods_used[j] = a.pods_used[n];
      b[j] = a.over[n];
      b[NPC + j] = a.sched[n];
      for (int x = 0; x < SW; ++x) w[x * NPC + j] = a.labels[(size_t)n * SW + x];
      for (int x = 0; x < PW; ++x) uport[x * NPC + j] = a.uport[(size_t)n * PW + x];
      for (int x = 0; x < VW; ++x) {
        uvol_any[x * NPC + j] = a.uvol_any[(size_t)n * VW + x];
        uvol_rw[x * NPC + j] = a.uvol_rw[(size_t)n * VW + x];
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  for (int p = 0; p < min(a.P, 3); ++p) issue_row(p);
  cp_async_wait_all();
  __syncthreads();
  const int first_svc = a.P > 0 ? pod_row(0)[kRowSvc] : -1;
  int m = 0;  // the max count of the current pod's service, over the cluster
  if (first_svc >= 0) {
    int part = INT_MIN;
    for (int j = tid; j < n_real; j += T) part = max(part, count_of(0, j));
    part = warp_max_int(part);
    if (lane == 0) red_max[warp] = part;
    __syncthreads();
    part = warp_max_int(lane < n_warps ? red_max[lane] : INT_MIN);
    if (warp == 0 && lane < C) cluster.map_shared_rank(slots + kMaxCluster + r, lane)->max_count = part;
    cluster.sync();
    m = warp_max_int(lane < C ? slots[kMaxCluster + lane].max_count : INT_MIN);
  }

  unsigned phase = 0;  // cluster steps taken, for the slots' parity
  for (int p = 0; p < a.P; ++p) {
    const bool has_next = p + 1 < a.P;
    if (unplaceable(p) && (!has_next || unplaceable(p + 1))) {
      // No node can take this pod, and the next pod needs no max count:
      // the same in every CTA, so no cluster barrier. The first block
      // barrier makes the rows issued at the previous step visible; the
      // second orders the flushed adds before the next fetch.
      if (r == 0 && tid == 0) a.choice[p] = -1;
      cp_async_wait_all();
      __syncthreads();
      flush_commit();
      __syncthreads();
      prefetch(p);
      continue;
    }
    const int* row = pod_row(p);
    const int pin = row[kRowPin];
    const float cpu = __int_as_float(row[kRowCpu]);
    const float mem = __int_as_float(row[kRowMem]);
    const bool zero = row[kRowZero] != 0;
    const int svc = row[kRowSvc];
    const int* sel = row + kRowBits;
    const int* port = sel + SW;
    const int* vol_any = port + PW;
    const int* vol_rw = vol_any + VW;
    const int next_svc = has_next ? pod_row(p + 1)[kRowSvc] : -1;

    long long best = LLONG_MIN;
    int next_max = INT_MIN;  // the slice's max count of the next pod's service
    for (int j = tid; j < n_real; j += T) {
      const int n = start + j;
      // -- predicates (solver._feasible, default spec) -----------------
      const float cap_c = cpu_cap[j];
      const float cap_m = mem_cap[j];
      const float cap_p = pods_cap[j];
      const float used_p = pods_used[j];
      const bool fits_cpu = cap_c == 0.0f || __fadd_rn(cpu_fit[j], cpu) <= cap_c;
      const bool fits_mem = cap_m == 0.0f || __fadd_rn(mem_fit[j], mem) <= cap_m;
      const bool fits_count = __fadd_rn(used_p, 1.0f) <= cap_p;
      const bool nonzero_ok = (over[j] == 0) & fits_cpu & fits_mem & fits_count;
      const bool zero_ok = used_p < cap_p;
      bool ok = (sched[j] != 0) & (zero ? zero_ok : nonzero_ok);
      for (int w = 0; w < SW; ++w) {
        const int sw = sel[w];
        ok &= (sw & labels[w * ws + j * ns_sel]) == sw;
      }
      for (int w = 0; w < PW; ++w) ok &= (port[w] & uport[w * ws + j * ns_port]) == 0;
      for (int w = 0; w < VW; ++w) {
        ok &= ((vol_rw[w] & uvol_any[w * ws + j * ns_vol]) |
               (vol_any[w] & uvol_rw[w * ws + j * ns_vol])) == 0;
      }
      ok &= (pin == -1) | (pin == n);

      // -- priorities (solver._component_scores) -----------------------
      const int icap_c = __float2int_rz(cap_c);
      const int icap_m = __float2int_rz(cap_m);
      const int req_c = __float2int_rz(__fadd_rn(cpu_used[j], cpu));
      const int req_m = __float2int_rz(__fadd_rn(mem_used[j], mem));
      const int lr = floor_div(
          wadd(least_requested(req_c, icap_c), least_requested(req_m, icap_m)), 2);
      const float cf = fraction(req_c, icap_c);
      const float mf = fraction(req_m, icap_m);
      int bra = 0;
      if (!(cf >= 1.0f || mf >= 1.0f)) {
        const float d = __fmul_rn(fabsf(__fsub_rn(cf, mf)), 10.0f);
        bra = __float2int_rz(__fadd_rn(__fsub_rn(10.0f, d), 1e-5f));
      }
      int spread = 10;
      if (svc >= 0 && m != 0) {
        spread = floor_div(wmul(10, wsub(m, count_of(p, j))), m > 1 ? m : 1);
      }
      const int total =
          wadd(wadd(wmul(lr, a.w_lr), wmul(bra, a.w_bra)), wmul(spread, a.w_spread));

      const long long key = make_key(ok ? total : -1, n);
      best = key > best ? key : best;
      if (next_svc >= 0) next_max = max(next_max, count_of(p + 1, j));
    }

    // -- select: first max by lowest index, over the cluster -------------
    best = warp_max_key(best);
    next_max = warp_max_int(next_max);
    if (lane == 0) {
      red[warp] = best;
      red_max[warp] = next_max;
    }
    cp_async_wait_all();  // pod p + 2's count row and tile
    __syncthreads();
    flush_commit();
    best = warp_max_key(lane < n_warps ? red[lane] : LLONG_MIN);
    next_max = warp_max_int(lane < n_warps ? red_max[lane] : INT_MIN);
    if (warp == 0 && lane < C) {
      // This CTA's best, its max count of the next pod's service, and
      // that count at its best node, stored into every CTA's slot.
      Slot mine;
      mine.key = best;
      mine.max_count = next_max;
      mine.best_count = 0;
      if (next_svc >= 0 && best != LLONG_MIN) {
        mine.best_count = count_of(p + 1, (int)(0xffffffffu - (unsigned)(best & 0xffffffffLL)) - start);
      }
      *cluster.map_shared_rank(slots + (phase & 1) * kMaxCluster + r, lane) = mine;
    }
    cluster.sync();  // every CTA's slot has reached every CTA
    const Slot* step_slots = slots + (phase & 1) * kMaxCluster;
    const long long slot_key = lane < C ? step_slots[lane].key : LLONG_MIN;
    const long long win = warp_max_key(slot_key);
    const int value = (int)(unsigned)((unsigned long long)win >> 32);
    const int c = value >= 0 ? (int)(0xffffffffu - (unsigned)(win & 0xffffffffLL)) : -1;
    // The CTA whose key won owns node c (keys hold distinct nodes).
    const int owner = c >= 0 ? __ffs(__ballot_sync(0xffffffffu, slot_key == win)) - 1 : -1;
    ++phase;
    if (r == 0 && tid == 0) a.choice[p] = c;
    // The next pod's max count: the cluster's max over its row before
    // this commit, and the winner's count after it. Counts only grow, and
    // only at the winner.
    if (next_svc >= 0) {
      m = warp_max_int(lane < C ? step_slots[lane].max_count : INT_MIN);
      const int adds = c >= 0 ? adds_to_row(p, p + 1) : 0;
      if (adds > 0) m = max(m, step_slots[owner].best_count + adds);
    }

    // -- commit (solver._commit), by the thread that owns node c ---------
    if (owner == r && tid == (c - start < T ? c - start : (c - start) % T)) {
      const int j = c - start;
      cpu_fit[j] = __fadd_rn(cpu_fit[j], cpu);
      mem_fit[j] = __fadd_rn(mem_fit[j], mem);
      cpu_used[j] = __fadd_rn(cpu_used[j], cpu);
      mem_used[j] = __fadd_rn(mem_used[j], mem);
      pods_used[j] = __fadd_rn(pods_used[j], 1.0f);
      for (int w = 0; w < PW; ++w) uport[w * ws + j * ns_port] |= port[w];
      for (int w = 0; w < VW; ++w) {
        uvol_any[w * ws + j * ns_vol] |= vol_any[w];
        uvol_rw[w * ws + j * ns_vol] |= vol_rw[w];
      }
      if (resident) {
        // The rows of pods p + 1 and p + 2 have landed; p + 3's is in
        // flight and gets the adds with the flush.
        count_row(p + 1)[j] += adds_to_row(p, p + 1);
        count_row(p + 2)[j] += adds_to_row(p, p + 2);
        pend_j = j;
        pend_p = p;
      } else {
        add_counts(p, j);
      }
    }
    prefetch(p);
  }
  flush_commit();

  // -- epilogue: the slice's carry back to device memory -----------------
  if (resident) {
    for (int j = tid; j < n_real; j += T) {
      const int n = start + j;
      a.cpu_fit[n] = cpu_fit[j];
      a.mem_fit[n] = mem_fit[j];
      a.cpu_used[n] = cpu_used[j];
      a.mem_used[n] = mem_used[j];
      a.pods_used[n] = pods_used[j];
      for (int w = 0; w < PW; ++w) a.uport[(size_t)n * PW + w] = uport[w * NPC + j];
      for (int w = 0; w < VW; ++w) {
        a.uvol_any[(size_t)n * VW + w] = uvol_any[w * NPC + j];
        a.uvol_rw[(size_t)n * VW + w] = uvol_rw[w * NPC + j];
      }
    }
  }
  cluster.sync();  // no CTA leaves while another may still store into its slots
}

using Kernel = void (*)(ScanArgs);

// The lowering pads every bitset to a multiple of 2 words and keeps 8
// service ids per pod, so nearly every launch has these widths, and
// their rows always take the 128-pod tile.
Kernel kernel_for(int SW, int PW, int VW, int K, int resident, int tile_shift) {
  if (SW == 2 && PW == 2 && VW == 2 && K == 8 && tile_shift == kTileShift) {
    return resident ? scan_kernel<2, 2, 2, 8, true, kTileShift>
                    : scan_kernel<2, 2, 2, 8, false, kTileShift>;
  }
  if (tile_shift == 0) {
    return resident ? scan_kernel<0, 0, 0, 0, true, -1> : scan_kernel<0, 0, 0, 0, false, -1>;
  }
  return resident ? scan_kernel<0, 0, 0, 0, true, 0> : scan_kernel<0, 0, 0, 0, false, 0>;
}

cudaError_t configure(Kernel kernel, int C, int threads, const Layout& L, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  if (C < 1 || C > kMaxCluster || threads < 32 || threads > kMaxThreads || threads % 32) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e;
  if (C > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (e != cudaSuccess) return e;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->gridDim = dim3(C, 1, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = L.bytes;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// The dynamic shared memory one CTA of the launch needs.
extern "C" int ktt_scan_smem_bytes(int N, int SW, int PW, int VW, int K, int cluster,
                                   int resident, int tile_shift) {
  return make_layout(N, SW, PW, VW, K, cluster, resident, tile_shift).bytes;
}

// cudaOccupancyMaxActiveClusters for a launch plan, into *active.
extern "C" int ktt_scan_occupancy(int N, int SW, int PW, int VW, int K, int cluster,
                                  int resident, int tile_shift, int threads, int* active) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  const Layout L = make_layout(N, SW, PW, VW, K, cluster, resident, tile_shift);
  const Kernel kernel = kernel_for(SW, PW, VW, K, resident, tile_shift);
  cudaError_t e = configure(kernel, cluster, threads, L, &cfg, &attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(active, kernel, &cfg));
}

extern "C" int ktt_scan_launch(
    const void* pod_rows,
    const void* cpu_cap, const void* mem_cap, const void* pods_cap,
    const void* over, const void* sched, const void* labels,
    void* cpu_fit, void* mem_fit, void* cpu_used, void* mem_used,
    void* pods_used, void* uport, void* uvol_any, void* uvol_rw,
    void* counts, void* choice,
    int P, int N, int S, int SW, int PW, int VW, int K,
    int w_lr, int w_bra, int w_spread, int cluster, int threads, int resident, int tile_shift,
    void* stream) {
  ScanArgs a;
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
  a.choice = static_cast<int*>(choice);
  a.P = P;
  a.N = N;
  a.S = S;
  a.SW = SW;
  a.PW = PW;
  a.VW = VW;
  a.K = K;
  a.C = cluster;
  a.w_lr = w_lr;
  a.w_bra = w_bra;
  a.w_spread = w_spread;
  a.L = make_layout(N, SW, PW, VW, K, cluster, resident, tile_shift);
  // The plan's tiles, 8 to 128 pods (one under 4 would overwrite rows still read).
  if (K > 32 || (tile_shift != 0 && (tile_shift < 3 || tile_shift > kTileShift))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  const Kernel kernel = kernel_for(SW, PW, VW, K, resident, tile_shift);
  cudaError_t e = configure(kernel, cluster, threads, a.L, &cfg, &attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  cfg.stream = static_cast<cudaStream_t>(stream);
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (active < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ktt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
