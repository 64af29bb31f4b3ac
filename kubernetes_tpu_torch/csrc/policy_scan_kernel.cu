// The policy-spec sequential solve ("K1P") in one launch, on one
// thread-block cluster.
//
// Replaces the XLA scan the JAX package runs for a policy LoweredSpec:
// kubernetes_tpu/ops/solver.py:304 _scan_solve under _solve_xla /
// _solve_with_state_xla (not a Pallas kernel: pallas_eligible refuses
// every non-default spec). For each pod in order, against all N nodes:
//   - the base predicates, each gated by a runtime flag (resources with
//     the pod-count and zero-request rules, selector, ports, disk,
//     hostname) and the schedulable mask;
//   - CheckNodeLabelPresence: a static node mask (policy_ok);
//   - CheckServiceAffinity: per affinity label k the pod needs
//     aff_vid[n][k] == need[k], need[k] its own pin, else the value at
//     its service's anchor node, else nothing; anchor -2 (a peer on an
//     unknown node) fits nowhere;
//   - the weighted LeastRequested, BalancedResourceAllocation and
//     ServiceSpreading scores, the static label-preference column, and
//     each ServiceAntiAffinity instance: the peers of the pod's service
//     per zone, summed over the FEASIBLE nodes of the zone only;
//   - the first max by lowest node index, and a commit of the winner
//     into the occupancy carry, the service counts, the peer totals
//     (svc_total) and the anchors.
//
// What bounds it: P dependent steps, each an N-wide evaluation and an
// N-wide max whose winner changes what the next step reads. Bytes and
// operations are small beside that chain of latencies. The design is
// the scan kernel's (scan_kernel.cu), with the policy terms added:
//   - one cluster of C <= 16 CTAs; CTA r owns the node slice
//     [r * NPC, (r + 1) * NPC), NPC = ceil(N / C) rounded up to 4, and
//     thread t of a CTA the slice's nodes t, t + T, ...; only the owning
//     thread reads or writes a node's carry;
//   - the slice's constants, policy columns and carry live in shared
//     memory for the whole launch (struct of arrays, loaded once, written
//     back once). Where they do not fit at the plan's cluster size, the
//     plan keeps everything that grows with the nodes or the zone bins in
//     device memory ("in place"): the slice's columns, the count rows,
//     the scores before the zones and the zone sums. The owning threads
//     read and write them there: the same code, other pointers and
//     strides. Shared memory then holds only the reductions, the slots,
//     two tiles of 4 pod rows and, with C > 1, the service carry, so
//     every shape the plan meets in practice fits;
//   - service counts are (S, NS) int32 in device memory, each slice's
//     columns written only by its CTA. Resident, the count row a pod
//     reads is fetched three pods ahead by cp.async.cg; a commit's adds
//     reach device memory one step late, and the owning thread patches
//     the rows already in shared memory (the scan kernel's scheme). In
//     place, the owning thread adds at the commit and reads its nodes'
//     counts through L2. One row serves ServiceSpreading and
//     ServiceAntiAffinity;
//   - pod rows are staged 64 at a time (4 in place) by cp.async,
//     double-buffered;
//   - selection: each CTA stores one slot (its best 64-bit key
//     score << 32 | ~index, infeasible nodes at -1; its max count of the
//     next pod's service; that count at its best node) into every CTA
//     by distributed shared memory (DSMEM), double-buffered by the step's
//     parity, and after a cluster barrier every CTA picks the same
//     winner and the same max count for the next pod;
//   - the service carry (anchor, svc_total: S + 1 slots) is replicated
//     in every CTA's shared memory. Every CTA applies each commit in id
//     order with the same __fadd_rn, so the copies stay equal bit for
//     bit; CTA 0 writes them back. A single CTA in place works on the
//     device copy. Warp 0 updates the arrays after the step's last
//     barrier, and every thread carries the next pod's (anchor, peers)
//     in registers: read after the step's first barrier, then this
//     step's commit applied to them;
//   - ServiceAntiAffinity: the zone sums run over the feasible nodes of
//     the whole node axis, so they must exist before any node is scored.
//     Resident, each CTA adds its feasible nodes' counts into its
//     partial bins (shared-memory atomics), adds every non-zero partial
//     into the one [zone_bins] sum array of every CTA by DSMEM atomics,
//     and takes a first cluster barrier; then each thread reads the sums
//     of its nodes' zones, scores them, and the key slots follow with
//     the second cluster barrier. In place, the feasible nodes add
//     straight into a [2][zone_bins] array in device memory, read through
//     L2 after the first barrier. Either way a CTA's shared memory does
//     not grow with C. A step whose pod has no peers (the zone term is
//     then 10 for any labelled node) or no service takes one barrier.
//     The shared sum array needs no second buffer: a CTA reads step p's
//     sums between step p's two cluster barriers, clears them after its
//     last read (a block barrier) and before the second barrier, and no
//     CTA adds step p + 1's partials before it has passed that barrier.
//     The device array does: any CTA may clear only what every CTA has
//     read, so step p's sums are cleared at the next zone step, after
//     its first barrier, while that step adds into the other buffer;
//   - a pod that no node can take whatever the carry (hostname gated on
//     and a pin outside [-1, N): the padding's -2) takes no cluster step
//     when the next pod needs no max count either: choice -1, and its
//     commit only sends its ids to the scratch slot of svc_total, as
//     JAX's commit does. Without HostName the padding pods are placed;
//   - the widths the lowering nearly always gives (2-word bitsets, 8
//     service ids) get their own instances with those loops unrolled;
//     residency is a template parameter too;
//   - the spec's counts are not bounded by the kernel: the first 8
//     anti-affinity instances' weights, vocabularies and first bins
//     travel in the arguments and any further ones in a small device
//     array; each thread keeps the first 8 affinity requirements of a
//     step in registers and works out any further one again at each
//     node. Only shared memory bounds a plan.
//
// Parity with the plain version is bit for bit: -fmad=false, no fast
// math, the _rn intrinsics, floor_div where JAX's `//` floors, and int32
// arithmetic that wraps. A zone past the vocabulary is dropped by the
// sums (JAX's scatter) and clamped when read (JAX's gather).
//
// Launcher: plain C, loaded with ctypes. It launches one cluster on the
// caller's stream with cudaLaunchKernelEx, never synchronises,
// allocates nothing (the wrapper passes the in-place spill, zeroed),
// and returns the first CUDA error. The launch plan
// (cluster size, residency, threads, shared memory) is made and checked
// in Python (ops/policy_scan.py) before any launch.

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <climits>
#include <cstdint>

#include "scan_async.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 16;
constexpr int kMaxThreads = 1024;
constexpr int kMaxAA = 8;    // anti-affinity instances whose terms travel in the arguments
constexpr int kMaxAff = 8;   // affinity labels whose requirement a thread keeps in registers
constexpr int kTileShift = 6;         // 64 pods staged per tile, resident
constexpr int kTileShiftInPlace = 2;  // 4 in place, where shared memory holds nothing else
constexpr int kRows = 4;     // count rows in shared memory: the pod's and the next three

// Runtime spec flags (ops/policy_scan.py FLAG_*).
constexpr int kResources = 1;
constexpr int kPorts = 2;
constexpr int kDisk = 4;
constexpr int kSelector = 8;
constexpr int kHostname = 16;
constexpr int kNodeLabel = 32;
constexpr int kServiceAffinity = 64;
constexpr int kStaticPrio = 128;
constexpr int kServiceCarry = 256;  // anchor and svc_total are present

// A pod's row in the packed (P, row_words) int32 matrix the wrapper
// builds: scalars, then sel, port, vol_any, vol_rw words, the service
// ids and the affinity pins, zero-padded to a multiple of 4 words.
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
// multiple of 16. ops/policy_scan.py mirrors this to plan a launch.
struct Layout {
  int npc;        // nodes per CTA
  int ns;         // row stride of the service counts, npc * C
  int row_words;  // words of a packed pod row
  int tile_shift; // log2 of the pods a tile stages
  int resident;   // 1: the slice, count rows and zone sums live in shared memory
  int f32, words, pol, rows, part, tiles, red, slots, svc, zsum, zpart, flags, bytes;
};

__host__ __device__ inline Layout make_layout(int N, int SW, int PW, int VW, int K, int KA,
                                              int n_prio, int n_aa, int SA, int zone_bins,
                                              int C, int resident) {
  Layout L;
  L.npc = round_up((N + C - 1) / C, 4);
  L.ns = L.npc * C;
  L.row_words = round_up(kRowBits + SW + PW + 2 * VW + K + KA, 4);
  L.resident = resident;
  L.tile_shift = resident ? kTileShift : kTileShiftInPlace;
  const int kept = resident ? L.npc : 0;  // slice columns held here
  const int zone = resident ? round_up(4 * zone_bins, 16) : 0;
  int o = 0;
  L.f32 = o;    o += 8 * 4 * kept;                                  // caps, fit, used
  L.words = o;  o += 4 * (SW + PW + 2 * VW) * kept;                 // labels, uport, uvol
  L.pol = o;    o += 4 * (n_prio + KA + n_aa) * kept;               // static_prio, aff_vid, aa_zone
  L.rows = o;   o += kRows * 4 * kept;                              // count rows of 4 pods
  L.part = o;   o += n_aa > 0 ? 4 * kept : 0;                       // score before the zones
  L.tiles = o;  o += 2 * 4 * (L.row_words << L.tile_shift);        // pod tiles, 2
  L.red = o;    o += 32 * (8 + 4);                                  // a key and a count per warp
  L.slots = o;  o += 2 * kMaxCluster * 16;                          // Slot[parity][CTA]
  L.svc = o;    o += resident || C > 1 ? 2 * 4 * round_up(SA, 4) : 0;  // anchor, svc_total
  L.zsum = o;   o += zone;                                          // zone sums [bin]
  L.zpart = o;  o += C > 1 ? zone : 0;                              // this CTA's partials [bin]
  L.flags = o;  o += round_up(3 * kept + (n_aa > 0 ? kept : 0), 16);  // over, sched, policy_ok, feas
  L.bytes = o;
  return L;
}

struct PolicyArgs {
  const int* pod_rows;  // (P, row_words)
  // Node constants.
  const float* cpu_cap;
  const float* mem_cap;
  const float* pods_cap;
  const unsigned char* over;
  const unsigned char* sched;
  const int* labels;                // (N, SW)
  const unsigned char* policy_ok;   // (N,) or null
  const int* static_prio;           // (N,) or null
  const int* aff_vid;               // (N, KA) or null
  const int* aa_zone;               // (N, I) or null
  // Carry, updated in place.
  float* cpu_fit;
  float* mem_fit;
  float* cpu_used;
  float* mem_used;
  float* pods_used;
  int* uport;       // (N, PW)
  int* uvol_any;    // (N, VW)
  int* uvol_rw;     // (N, VW)
  int* counts;      // (S, NS)
  int* anchor;      // (SA,) or null
  float* svc_total; // (SA,) or null
  int* spill;       // in place with anti-affinity: part (NS), feas (NS bytes in NS words),
                    // zone sums (2, zone_bins), zeroed; else null
  int* choice;      // (P,) out
  int P, N, S, SW, PW, VW, K, KA, SA, C, flags;
  int w_lr, w_bra, w_spread;
  int n_aa;
  int aa_w[kMaxAA];
  int aa_nz[kMaxAA];
  int aa_off[kMaxAA];  // first bin of each instance
  const int* aa_more;  // instances kMaxAA.. as (w, nz, off) triples in device memory, or null
  int zone_bins;
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
// no branch for the in-place case.
template <int kSW, int kPW, int kVW, int kK, bool kResident>
__global__ void __launch_bounds__(kMaxThreads, 1) policy_scan_kernel(const PolicyArgs a) {
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
  const int KA = a.KA;
  const int n_aa = a.n_aa;
  const int zb = a.zone_bins;
  const int flags = a.flags;
  const bool carry_svc = (flags & kServiceCarry) != 0;
  constexpr bool resident = kResident;
  const int scratch = a.SA - 1;
  const int NPC = L.npc;
  const int start = r * NPC;
  const int n_real = max(0, min(NPC, N - start));  // nodes of the slice that exist
  const int ids_at = kRowBits + SW + PW + 2 * VW;   // service ids in a pod row
  const int pins_at = ids_at + K;                   // affinity pins
  const int n_prio = (flags & kStaticPrio) ? 1 : 0;

  unsigned char* sm = dyn_smem();
  // The slice's columns: node j, word w of a word column at [w * ws + j * ns_*].
  const float *cpu_cap, *mem_cap, *pods_cap;
  float *cpu_fit, *mem_fit, *cpu_used, *mem_used, *pods_used;
  const int* labels;
  int *uport, *uvol_any, *uvol_rw;
  const int *prio, *aff, *zone_of;
  const unsigned char *over, *sched, *pol_ok;
  int ws, ns_sel, ns_port, ns_vol, ns_aff, ns_aa;
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
    const int* q = reinterpret_cast<const int*>(sm + L.pol);
    prio = q;
    aff = q + n_prio * NPC;
    zone_of = aff + KA * NPC;
    over = sm + L.flags;
    sched = over + NPC;
    pol_ok = sched + NPC;
    ws = NPC;
    ns_sel = ns_port = ns_vol = ns_aff = ns_aa = 1;
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
    prio = a.static_prio != nullptr ? a.static_prio + start : nullptr;
    aff = a.aff_vid != nullptr ? a.aff_vid + (size_t)start * KA : nullptr;
    zone_of = a.aa_zone != nullptr ? a.aa_zone + (size_t)start * n_aa : nullptr;
    over = a.over + start;
    sched = a.sched + start;
    pol_ok = a.policy_ok != nullptr ? a.policy_ok + start : nullptr;
    ws = 1;
    ns_sel = SW;
    ns_port = PW;
    ns_vol = VW;
    ns_aff = KA;
    ns_aa = n_aa;
  }
  int* rowbuf = reinterpret_cast<int*>(sm + L.rows);  // [pod % kRows][NPC], resident
  int* tiles = reinterpret_cast<int*>(sm + L.tiles);  // [tile parity][tile][row_words]
  constexpr int tsh = kResident ? kTileShift : kTileShiftInPlace;  // L.tile_shift
  long long* red = reinterpret_cast<long long*>(sm + L.red);  // one key per warp
  int* red_max = reinterpret_cast<int*>(red + 32);             // one max count per warp
  Slot* slots = reinterpret_cast<Slot*>(sm + L.slots);         // [parity][source CTA]
  // The service carry: replicated in shared memory, or the device copy
  // for a single CTA in place (known at compile time when resident).
  const bool svc_shared = kResident || C > 1;
  int* anchor = svc_shared ? reinterpret_cast<int*>(sm + L.svc) : a.anchor;
  float* svc_total = svc_shared ? reinterpret_cast<float*>(anchor + round_up(a.SA, 4)) : a.svc_total;
  // With anti-affinity: the score before the zones and the feasibility
  // of each node of the slice, and the zone sums; in shared memory or
  // (in place) in the spill.
  int *part, *zsum, *zpart, *zdev;
  unsigned char* feas;
  if (resident) {
    part = reinterpret_cast<int*>(sm + L.part);
    feas = sm + L.flags + 3 * NPC;
    zsum = reinterpret_cast<int*>(sm + L.zsum);
    zpart = C > 1 ? reinterpret_cast<int*>(sm + L.zpart) : zsum;
    zdev = nullptr;
  } else {
    part = a.spill != nullptr ? a.spill + start : nullptr;
    feas = a.spill != nullptr ? reinterpret_cast<unsigned char*>(a.spill + L.ns) + start : nullptr;
    zdev = a.spill != nullptr ? a.spill + 2 * L.ns : nullptr;  // [zone step parity][bin]
    zsum = zpart = nullptr;
  }

  auto pod_row = [&](int p) -> const int* {
    return tiles + ((p >> tsh) & 1) * (L.row_words << tsh) + (p & ((1 << tsh) - 1)) * L.row_words;
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
  // The service carry's slot s, as warp 0 last committed it (past L1
  // in device memory).
  auto carry_anchor = [&](int s) {
    return svc_shared ? anchor[s] : *reinterpret_cast<volatile const int*>(anchor + s);
  };
  auto carry_peers = [&](int s) {
    return svc_shared ? svc_total[s] : *reinterpret_cast<volatile const float*>(svc_total + s);
  };
  // The pod's entry of the service carry: its service's, or the scratch
  // slot's when it has none.
  auto svc_slot = [&](int svc) { return svc >= 0 ? svc : scratch; };
  // Anti-affinity instance i's weight, zone vocabulary and first bin: in
  // the arguments for the first kMaxAA, past them in device memory.
  auto aa_w = [&](int i) { return i < kMaxAA ? a.aa_w[i] : __ldg(a.aa_more + 3 * (i - kMaxAA)); };
  auto aa_nz = [&](int i) {
    return i < kMaxAA ? a.aa_nz[i] : __ldg(a.aa_more + 3 * (i - kMaxAA) + 1);
  };
  auto aa_off = [&](int i) {
    return i < kMaxAA ? a.aa_off[i] : __ldg(a.aa_more + 3 * (i - kMaxAA) + 2);
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
  // Under HostName no node can take a pod pinned outside [0, N) (the
  // padding's -2); without it a pin means nothing.
  auto unplaceable = [&](int p) {
    const int pin = pod_row(p)[kRowPin];
    return (flags & kHostname) != 0 && pin != -1 && (pin < 0 || pin >= N);
  };
  // The tile of pods from `first` into its buffer.
  auto issue_tile = [&](int first) {
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
  // Issued after step p's last barrier: the count row of pod p + 3 (its
  // pod row landed at step p's first block barrier) and the tile that
  // starts at pod p + 4.
  auto prefetch = [&](int p) {
    if (p + 4 < a.P && ((p + 4) & ((1 << tsh) - 1)) == 0) issue_tile(p + 4);
    if (p + 3 < a.P) issue_row(p + 3);
  };
  // A commit's adds to the counts in device memory wait one step: they
  // are issued after the next block barrier, when the count rows fetched
  // so far have all landed without them, and before the next fetch,
  // with a barrier between that orders them before it. The rows that
  // landed without them (pods p + 1 to p + 3) get the adds from the
  // owning thread instead. pend_j: the node of the commit still to issue
  // (-1 none), pend_p its pod.
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
  // The service carry (solver._commit_services), by warp 0, one lane per
  // id: a placed pod becomes a peer of each service it matches and the
  // anchor of each that had none; invalid ids, and all ids of an unplaced
  // pod, go to the scratch slot. Every add to a slot is +1.0 rounded to
  // nearest and every anchor written is c, so the order in which the
  // lanes' atomics land changes nothing: the result is JAX's scatter's.
  auto commit_services = [&](int p, int c) {
    const int* ids = pod_row(p) + ids_at;
    for (int k = lane; k < K; k += 32) {
      const int slot = (ids[k] >= 0 && c >= 0) ? ids[k] : scratch;
      atomicAdd(svc_total + slot, 1.0f);
      atomicCAS(anchor + slot, -1, c);
    }
  };
  // Every thread's copy of the current pod's (anchor, peers), and the
  // next pod's: read from the arrays after the step's first barrier
  // (warp 0 has applied every earlier commit by then and applies this
  // step's only after the last barrier), then advanced past this step's
  // commit once the winner is known.
  int s_anchor = -1, n_anchor = -1;
  float s_peers = 0.0f, n_peers = 0.0f;
  int hits_placed = 0, hits_unplaced = 0;  // pod p's ids that land on the next pod's slot
  auto read_next = [&](int p) {
    if (!carry_svc || p + 1 >= a.P) return;
    const int s = svc_slot(pod_row(p + 1)[kRowSvc]);
    n_anchor = carry_anchor(s);
    n_peers = carry_peers(s);
    const int* ids = pod_row(p) + ids_at;
    hits_placed = 0;
    for (int k = 0; k < K; ++k) hits_placed += (ids[k] >= 0 ? ids[k] : scratch) == s;
    hits_unplaced = s == scratch ? K : 0;
  };
  auto advance = [&](int c) {
    if (!carry_svc) return;
    const int hits = c >= 0 ? hits_placed : hits_unplaced;
    for (int k = 0; k < hits; ++k) n_peers = __fadd_rn(n_peers, 1.0f);
    if (hits > 0 && n_anchor == -1) n_anchor = c;
    s_anchor = n_anchor;
    s_peers = n_peers;
  };

  // -- prologue: the slice and the service carry into shared memory, the
  // first pods' rows, and the max count of the first pod's service ------
  if (a.P > 0) issue_tile(0);
  if (resident) {
    float* f = const_cast<float*>(cpu_cap);
    int* w = const_cast<int*>(labels);
    int* q = const_cast<int*>(prio);
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
      b[2 * NPC + j] = a.policy_ok != nullptr ? a.policy_ok[n] : 1;
      for (int x = 0; x < SW; ++x) w[x * NPC + j] = a.labels[(size_t)n * SW + x];
      for (int x = 0; x < PW; ++x) uport[x * NPC + j] = a.uport[(size_t)n * PW + x];
      for (int x = 0; x < VW; ++x) {
        uvol_any[x * NPC + j] = a.uvol_any[(size_t)n * VW + x];
        uvol_rw[x * NPC + j] = a.uvol_rw[(size_t)n * VW + x];
      }
      if (n_prio) q[j] = a.static_prio[n];
      for (int k = 0; k < KA; ++k) q[(n_prio + k) * NPC + j] = a.aff_vid[(size_t)n * KA + k];
      for (int i = 0; i < n_aa; ++i) q[(n_prio + KA + i) * NPC + j] = a.aa_zone[(size_t)n * n_aa + i];
    }
  }
  if (carry_svc && svc_shared) {
    for (int s = tid; s < a.SA; s += T) {
      anchor[s] = a.anchor[s];
      svc_total[s] = a.svc_total[s];
    }
  }
  if (resident) {
    for (int b = tid; b < zb; b += T) zsum[b] = 0;
    for (int b = tid; b < zb; b += T) zpart[b] = 0;
  }
  cp_async_wait_all();
  __syncthreads();
  for (int p = 0; p < min(a.P, 3); ++p) issue_row(p);
  if (carry_svc && a.P > 0) {
    const int s = svc_slot(pod_row(0)[kRowSvc]);
    s_anchor = carry_anchor(s);
    s_peers = carry_peers(s);
  }
  cp_async_wait_all();
  // Every CTA of the cluster has started before any stores into another's
  // shared memory.
  cluster.sync();
  const int first_svc = a.P > 0 ? pod_row(0)[kRowSvc] : -1;
  int m = 0;  // the max count of the current pod's service, over the cluster
  if (first_svc >= 0) {
    int top = INT_MIN;
    for (int j = tid; j < n_real; j += T) top = max(top, count_of(0, j));
    top = warp_max_int(top);
    if (lane == 0) red_max[warp] = top;
    __syncthreads();
    top = warp_max_int(lane < n_warps ? red_max[lane] : INT_MIN);
    if (warp == 0 && lane < C) cluster.map_shared_rank(slots + kMaxCluster + r, lane)->max_count = top;
    cluster.sync();
    m = warp_max_int(lane < C ? slots[kMaxCluster + lane].max_count : INT_MIN);
  }

  unsigned phase = 0;  // cluster steps taken, for the slots' parity
  unsigned zsteps = 0;  // zone steps taken, for the device zone sums' parity
  for (int p = 0; p < a.P; ++p) {
    const bool has_next = p + 1 < a.P;
    if (unplaceable(p) && (!has_next || unplaceable(p + 1))) {
      // No node can take this pod, and the next pod needs no max count:
      // the same in every CTA, so no cluster barrier. The first block
      // barrier makes the rows issued at the previous step visible; the
      // second orders the flushed adds before the next fetch, and the
      // service carry's reads before warp 0's commit.
      if (r == 0 && tid == 0) a.choice[p] = -1;
      cp_async_wait_all();
      __syncthreads();
      flush_commit();
      read_next(p);
      advance(-1);
      __syncthreads();
      if (carry_svc && warp == 0) commit_services(p, -1);
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
    const int* aff_pin = row + pins_at;
    const int next_svc = has_next ? pod_row(p + 1)[kRowSvc] : -1;
    // ServiceAntiAffinity's numServicePods. With no peers every labelled
    // node's zone term is 10, so the zone sums matter only when num > 0:
    // the same in every CTA, whose service carries are equal.
    const int num = svc >= 0 ? __float2int_rz(s_peers) : 0;
    const bool zones = n_aa > 0 && num > 0;
    // Where this CTA's nodes add their counts: its partials, or the
    // step's device sums.
    int* const zadd = resident ? zpart : zdev + (zsteps & 1) * zb;
    // ServiceAffinity: what each affinity label must equal (-1: free).
    // The anchor's row is a node constant of any CTA's slice: read from
    // device memory through the read-only cache.
    // The first kMaxAff requirements are kept in registers; any further
    // label's is worked out again at each node (need_of).
    int need[kMaxAff];
    bool anchor_err = false, anchor_ok = false;
    int arow = 0;
    auto need_of = [&](int k) {
      return aff_pin[k] >= 0 ? aff_pin[k]
             : anchor_ok     ? __ldg(a.aff_vid + (size_t)arow * KA + k)
                             : -1;
    };
    if (flags & kServiceAffinity) {
      bool any_unpinned = false;
      for (int k = 0; k < KA; ++k) any_unpinned |= aff_pin[k] < 0;
      const bool consults = any_unpinned && svc >= 0 && s_peers > 0.0f;
      anchor_err = consults && s_anchor == -2;
      anchor_ok = consults && s_anchor >= 0;
      arow = min(max(s_anchor, 0), N - 1);
#pragma unroll
      for (int k = 0; k < kMaxAff; ++k) {
        if (k < KA) need[k] = need_of(k);
      }
    }

    // -- phase A: feasibility and the score, the zone terms aside when
    // the zone sums decide them -------------------------------------------
    long long best = LLONG_MIN;
    int next_max = INT_MIN;  // the slice's max count of the next pod's service
    for (int j = tid; j < n_real; j += T) {
      const int n = start + j;
      // Every base predicate is evaluated and the flags pick which count:
      // one straight run of loads and arithmetic, no branch between them.
      const float cap_c = cpu_cap[j];
      const float cap_m = mem_cap[j];
      const float cap_p = pods_cap[j];
      const float used_p = pods_used[j];
      const bool fits_cpu = cap_c == 0.0f || __fadd_rn(cpu_fit[j], cpu) <= cap_c;
      const bool fits_mem = cap_m == 0.0f || __fadd_rn(mem_fit[j], mem) <= cap_m;
      const bool fits_count = __fadd_rn(used_p, 1.0f) <= cap_p;
      const bool nonzero_ok = (over[j] == 0) & fits_cpu & fits_mem & fits_count;
      const bool zero_ok = used_p < cap_p;
      bool sel_ok = true, port_ok = true, disk_ok = true;
      for (int w = 0; w < SW; ++w) {
        const int sw = sel[w];
        sel_ok &= (sw & labels[w * ws + j * ns_sel]) == sw;
      }
      for (int w = 0; w < PW; ++w) port_ok &= (port[w] & uport[w * ws + j * ns_port]) == 0;
      for (int w = 0; w < VW; ++w) {
        disk_ok &= ((vol_rw[w] & uvol_any[w * ws + j * ns_vol]) |
                    (vol_any[w] & uvol_rw[w * ws + j * ns_vol])) == 0;
      }
      bool ok = (sched[j] != 0) & ((zero ? zero_ok : nonzero_ok) | !(flags & kResources)) &
                (sel_ok | !(flags & kSelector)) & (port_ok | !(flags & kPorts)) &
                (disk_ok | !(flags & kDisk)) &
                ((pin == -1) | (pin == n) | !(flags & kHostname));
      if (flags & kNodeLabel) ok &= pol_ok[j] != 0;
      if (flags & kServiceAffinity) {
#pragma unroll
        for (int k = 0; k < kMaxAff; ++k) {
          if (k < KA) ok &= (need[k] < 0) | (aff[k * ws + j * ns_aff] == need[k]);
        }
        for (int k = kMaxAff; k < KA; ++k) {
          const int nk = need_of(k);
          ok &= (nk < 0) | (aff[k * ws + j * ns_aff] == nk);
        }
        ok &= !anchor_err;
      }

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
      const int count = count_of(p, j);
      int spread = 10;
      if (svc >= 0 && m != 0) spread = floor_div(wmul(10, wsub(m, count)), m > 1 ? m : 1);
      int total = wadd(wadd(wmul(lr, a.w_lr), wmul(bra, a.w_bra)), wmul(spread, a.w_spread));
      if (n_prio) total = wadd(total, prio[j]);

      if (zones) {
        // This CTA's part of each instance's zone sums: the feasible
        // nodes' counts; JAX's scatter drops a zone past the vocabulary.
        if (ok && count != 0) {
          for (int i = 0; i < n_aa; ++i) {
            const int zone = zone_of[i * ws + j * ns_aa];
            if (zone >= 0 && zone < aa_nz(i)) atomicAdd(zadd + aa_off(i) + zone, count);
          }
        }
        part[j] = total;
        feas[j] = ok;
      } else {
        for (int i = 0; i < n_aa; ++i) {
          total = wadd(total, wmul(zone_of[i * ws + j * ns_aa] < 0 ? 0 : 10, aa_w(i)));
        }
        const long long key = make_key(ok ? total : -1, n);
        best = key > best ? key : best;
      }
      if (next_svc >= 0) next_max = max(next_max, count_of(p + 1, j));
    }
    next_max = warp_max_int(next_max);
    if (lane == 0) red_max[warp] = next_max;

    if (zones) {
      cp_async_wait_all();  // pod p + 2's count row and tile
      __syncthreads();      // this CTA's partials are whole
      flush_commit();
      read_next(p);
      if (resident && C > 1) {
        // Every non-zero partial into every CTA's sums, one (CTA, bin)
        // pair a thread. Integer adds: the order they land in is moot.
        for (int i = tid; i < C * zb; i += T) {
          const int d = i / zb;
          const int b = i - d * zb;
          const int v = zpart[b];
          if (v != 0) atomicAdd(cluster.map_shared_rank(zsum, d) + b, v);
        }
      }
      cluster.sync();  // every CTA's partials have reached every sum
      // -- phase B: the zone terms from the sums over the cluster --------
      for (int j = tid; j < n_real; j += T) {
        int total = part[j];
        for (int i = 0; i < n_aa; ++i) {
          const int zone = zone_of[i * ws + j * ns_aa];
          // JAX's gather clamps a zone past the vocabulary.
          const int bin = aa_off(i) + min(max(zone, 0), aa_nz(i) - 1);
          const int count_z = resident ? zsum[bin] : __ldcg(zadd + bin);
          const int score = zone < 0 ? 0 : floor_div(wmul(10, wsub(num, count_z)), num);
          total = wadd(total, wmul(score, aa_w(i)));
        }
        const long long key = make_key(feas[j] ? total : -1, start + j);
        best = key > best ? key : best;
      }
      best = warp_max_key(best);
      if (lane == 0) red[warp] = best;
      __syncthreads();  // every read of this step's sums and partials is done
      if (resident) {
        for (int b = tid; b < zb; b += T) zsum[b] = 0;
        if (C > 1) {
          for (int b = tid; b < zb; b += T) zpart[b] = 0;
        }
      } else {
        // The previous zone step's sums, which every CTA read before
        // this step's first barrier: the next zone step adds into them.
        int* last = zdev + ((zsteps + 1) & 1) * zb;
        for (int b = r * T + tid; b < zb; b += C * T) last[b] = 0;
      }
      ++zsteps;
    } else {
      best = warp_max_key(best);
      if (lane == 0) red[warp] = best;
      cp_async_wait_all();  // pod p + 2's count row and tile
      __syncthreads();
      flush_commit();
      read_next(p);
    }

    // -- select: first max by lowest index, over the cluster -------------
    best = warp_max_key(lane < n_warps ? red[lane] : LLONG_MIN);
    next_max = warp_max_int(lane < n_warps ? red_max[lane] : INT_MIN);
    if (warp == 0 && lane < C) {
      // This CTA's best, its max count of the next pod's service, and
      // that count at its best node, stored into every CTA's slot.
      Slot s;
      s.key = best;
      s.max_count = next_max;
      s.best_count = 0;
      if (next_svc >= 0 && best != LLONG_MIN) {
        s.best_count = count_of(p + 1, (int)(0xffffffffu - (unsigned)(best & 0xffffffffLL)) - start);
      }
      *cluster.map_shared_rank(slots + (phase & 1) * kMaxCluster + r, lane) = s;
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
    advance(c);
    if (carry_svc && warp == 0) commit_services(p, c);

    // -- commit (solver._commit), by the thread that owns node c ---------
    if (owner == r && tid == (c - start) % T) {
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

  // -- epilogue: the slice's carry and the service carry back to device
  // memory ----------------------------------------------------------------
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
  // No CTA leaves while another may still store into its slots; warp
  // 0's last service commit is done.
  cluster.sync();
  if (r == 0 && carry_svc && svc_shared) {
    for (int s = tid; s < a.SA; s += T) {
      a.anchor[s] = anchor[s];
      a.svc_total[s] = svc_total[s];
    }
  }
}

using Kernel = void (*)(PolicyArgs);

// The lowering pads every bitset to a multiple of 2 words and keeps 8
// service ids per pod, so nearly every launch has these widths.
Kernel kernel_for(int SW, int PW, int VW, int K, int resident) {
  if (SW == 2 && PW == 2 && VW == 2 && K == 8) {
    return resident ? policy_scan_kernel<2, 2, 2, 8, true> : policy_scan_kernel<2, 2, 2, 8, false>;
  }
  return resident ? policy_scan_kernel<0, 0, 0, 0, true> : policy_scan_kernel<0, 0, 0, 0, false>;
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
extern "C" int ktt_policy_smem_bytes(int N, int SW, int PW, int VW, int K, int KA, int n_prio,
                                     int n_aa, int SA, int zone_bins, int cluster, int resident) {
  return make_layout(N, SW, PW, VW, K, KA, n_prio, n_aa, SA, zone_bins, cluster, resident).bytes;
}

// cudaOccupancyMaxActiveClusters for a launch plan, into *active.
extern "C" int ktt_policy_occupancy(int N, int SW, int PW, int VW, int K, int KA, int n_prio,
                                    int n_aa, int SA, int zone_bins, int cluster, int resident,
                                    int threads, int* active) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  const Layout L =
      make_layout(N, SW, PW, VW, K, KA, n_prio, n_aa, SA, zone_bins, cluster, resident);
  const Kernel kernel = kernel_for(SW, PW, VW, K, resident);
  cudaError_t e = configure(kernel, cluster, threads, L, &cfg, &attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(active, kernel, &cfg));
}

extern "C" int ktt_policy_launch(
    const void* pod_rows,
    const void* cpu_cap, const void* mem_cap, const void* pods_cap,
    const void* over, const void* sched, const void* labels,
    const void* policy_ok, const void* static_prio, const void* aff_vid, const void* aa_zone,
    void* cpu_fit, void* mem_fit, void* cpu_used, void* mem_used,
    void* pods_used, void* uport, void* uvol_any, void* uvol_rw,
    void* counts, void* anchor, void* svc_total, void* spill, void* choice,
    int P, int N, int S, int SW, int PW, int VW, int K, int KA, int SA,
    int flags, int w_lr, int w_bra, int w_spread,
    int n_aa, const int* aa_w, const int* aa_nz, const void* aa_more, int cluster, int threads,
    int resident, void* stream) {
  if (n_aa < 0 || KA < 0 || S < 1 || ((flags & kServiceCarry) && SA < 1) ||
      (n_aa > kMaxAA && aa_more == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PolicyArgs a;
  a.pod_rows = static_cast<const int*>(pod_rows);
  a.cpu_cap = static_cast<const float*>(cpu_cap);
  a.mem_cap = static_cast<const float*>(mem_cap);
  a.pods_cap = static_cast<const float*>(pods_cap);
  a.over = static_cast<const unsigned char*>(over);
  a.sched = static_cast<const unsigned char*>(sched);
  a.labels = static_cast<const int*>(labels);
  a.policy_ok = static_cast<const unsigned char*>(policy_ok);
  a.static_prio = static_cast<const int*>(static_prio);
  a.aff_vid = static_cast<const int*>(aff_vid);
  a.aa_zone = static_cast<const int*>(aa_zone);
  a.cpu_fit = static_cast<float*>(cpu_fit);
  a.mem_fit = static_cast<float*>(mem_fit);
  a.cpu_used = static_cast<float*>(cpu_used);
  a.mem_used = static_cast<float*>(mem_used);
  a.pods_used = static_cast<float*>(pods_used);
  a.uport = static_cast<int*>(uport);
  a.uvol_any = static_cast<int*>(uvol_any);
  a.uvol_rw = static_cast<int*>(uvol_rw);
  a.counts = static_cast<int*>(counts);
  a.anchor = static_cast<int*>(anchor);
  a.svc_total = static_cast<float*>(svc_total);
  a.spill = static_cast<int*>(spill);
  a.choice = static_cast<int*>(choice);
  a.P = P;
  a.N = N;
  a.S = S;
  a.SW = SW;
  a.PW = PW;
  a.VW = VW;
  a.K = K;
  a.KA = KA;
  a.SA = (flags & kServiceCarry) ? SA : 0;
  a.C = cluster;
  a.flags = flags;
  a.w_lr = w_lr;
  a.w_bra = w_bra;
  a.w_spread = w_spread;
  a.n_aa = n_aa;
  a.zone_bins = 0;
  // The first kMaxAA instances travel in the arguments; the wrapper
  // passes the rest as (w, nz, off) triples in aa_more.
  a.aa_more = static_cast<const int*>(aa_more);
  for (int i = 0; i < kMaxAA; ++i) a.aa_w[i] = a.aa_nz[i] = a.aa_off[i] = 0;
  for (int i = 0; i < n_aa; ++i) {
    if (aa_nz[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (i < kMaxAA) {
      a.aa_w[i] = aa_w[i];
      a.aa_nz[i] = aa_nz[i];
      a.aa_off[i] = a.zone_bins;
    }
    a.zone_bins += aa_nz[i];
  }
  const int n_prio = (flags & kStaticPrio) ? 1 : 0;
  a.L = make_layout(N, SW, PW, VW, K, KA, n_prio, n_aa, a.SA, a.zone_bins, cluster, resident);
  if (!resident && n_aa > 0 && spill == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  const Kernel kernel = kernel_for(SW, PW, VW, K, resident);
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

extern "C" const char* ktt_policy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
