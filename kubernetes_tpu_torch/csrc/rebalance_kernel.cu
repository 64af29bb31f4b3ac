// K2: the defrag plan in one launch, on one thread-block cluster: rows
// screened in parallel against a frozen carry, then resolved in order.
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
// What bounds it. Taken row by row, D dependent N-wide evaluations: the
// one-block design this replaces spent about 1 us fixed and 0.52 us for
// each node a thread walked on every row (a feasible node is about 120
// instructions, most of them two IEEE divisions), so one SM's issue rate
// set the pace and the other SMs sat idle. Bytes and operations are
// small beside that. But the carry changes only at a committed row, and
// a commit changes exactly two nodes (the source and the destination); a
// row that does not commit leaves the carry bit for bit as it found it,
// and commits are sparse beside rows (14 in 50,000 rows on the main
// path's placement, 4,163 in 48,998 on a full fleet). So most rows can be
// evaluated at the same time as their neighbours. What is left in order
// is a chain a commit long, which a single warp walks. Two phases a
// window of R rows [s, s + R), in one launch, with no host read:
//
//   1. Screen. Every row of the window is evaluated against the carry C_s
//      as it stands when row s is reached, in parallel over the cluster's
//      warps (rows go round the CTAs first). A row keeps its K best
//      (key, node) pairs in (key, node) order, the first-minimum order of
//      jnp.argmin, as one 64-bit word key << 32 | node each: a warp holds
//      the list one entry a lane, walks the nodes four a lane at a time,
//      and merges a batch of 32 candidates by one ballot against the K-th
//      entry and a shuffle up for each that enters. A node's key is first
//      bounded from below with the row's reciprocals in place of the two
//      divisions (RN(a * RN(1 / b)) is within 2^-22 of RN(a / b); the
//      bound takes 2^-20 off), and only a node whose bound beats the K-th
//      entry takes the exact key. The list goes to a device scratch; the
//      row's record (its fields, its list's first pair, whether it had K
//      or more feasible nodes, and the gain of a move to that first pair
//      against C_s, as its source half and its destination half) goes to
//      CTA 0's shared memory through DSMEM. A list with fewer than K
//      entries holds every node that was feasible at C_s.
//   2. Resolve. One warp of CTA 0 walks the window's rows in order,
//      keeping S, the nodes whose carry changed since C_s, as a bitmask
//      and a table of at most kMaxTouched nodes with their capacities,
//      the carry itself written through. For row r: the best untouched
//      node is the first of its K pairs not in S; every node in S has its
//      key recomputed from its current carry (behind the same lower
//      bound); dst is the first minimum of the two. If all K pairs are in
//      S and the row had K or more feasible nodes, row r's answer is not
//      known from the list: the window ends at r and the next screen
//      starts there. Otherwise the gain takes each half from the record
//      while its node is untouched (the destination half only when dst is
//      the first pair) and works the other out from the current carry;
//      the commit rule and the budget are unchanged; a commit updates
//      both nodes' carry and adds them to S. The warp takes 32 / g rows a
//      step, g lanes a row, and acts on the first row that commits or
//      ends the window; the rows before it do not commit. g halves after
//      a step in which no row acted; after one in which a row did, a step
//      takes twice the rows up to it, or one row when it was the first
//      (then the next row's list is fetched while this one commits).
//
// Why this is exact. The key of a node that is not in S is the same under
// C_s as now, since its carry is. A list ordered by (key, node) therefore
// gives the first minimum over the untouched nodes whenever one of its
// entries is untouched, or when the list already holds every node that
// was feasible at C_s. A node that was infeasible at C_s and became
// feasible (a source that a commit freed) is in S, so it is recomputed.
// Nothing else changes between C_s and row r. Ties: entries compare as
// key << 32 | node, so the lower node wins an equal key, in the list, in
// S and between the two. A gain half depends only on its node's carry
// and the row, so a half from C_s holds while its node is untouched.
//
// Windows. The next window starts where this one ended, against the
// carry with every commit so far. R adapts by a fixed rule: after a
// window that ran to its end R doubles, up to max_rows (by the plan's
// rule one row a warp of the cluster: a screen gives every warp a row,
// and S, whose keys every later row of the window works out again,
// lives no longer); after one that ended early R becomes twice the rows
// it resolved, never more than before and never below min(first_rows,
// 32). A window also ends before a row whose commit could take S past
// kMaxTouched nodes, which bounds the recomputation. A forced row
// commits whatever its gain, so when its gain is not in its record the
// resolve logs the two nodes' carry and works the gain out after the
// window's rows, a lane a logged commit, off the serial chain.
//
// Layout. Each CTA screens whole rows over its own copy of the carry and
// the node capacities (12 B a node each, in shared memory), rather than
// a slice of the node axis: a row's screen then needs no exchange
// between CTAs, a window's commits touch at most kMaxTouched nodes, so
// patching the other copies from CTA 0's after the resolve is a few
// DSMEM reads, and the resolve reads the rows, S and the carry from
// its own shared memory. When a window has fewer rows than the cluster
// has warps, each row's node axis is cut into G chunks (a power of two,
// at least kMinChunk nodes each) screened by separate warps, and one
// warp merges the G partial lists after a cluster barrier. The copies
// and a window of records fit beside each other up to about 9,000 nodes
// ("resident"); past that the carry is one copy in device memory, read
// through L2 and written by the resolve alone, the capacities are read
// from the columns, and S's bitmask lives in the scratch too. Residency
// is a template parameter. The node axis is never padded, and the
// probes are read through the read-only cache.
//
// The scores are int32 sums (wrapping, as XLA's) over the nodes and live
// probes: each CTA sums a slice of the node axis, CTA 0 adds the slices
// (order does not change a wrapping sum), then the JAX ratio in f32.
//
// Parity with the plain version is bit for bit. Build with -fmad=false
// and without fast math; the f32 arithmetic below is spelled with the
// _rn intrinsics besides, and int-to-float conversions round to nearest.
//
// Launcher: plain C, loaded with ctypes. It launches one cluster on the
// caller's stream with cudaLaunchKernelEx, never synchronises, allocates
// nothing (the wrapper passes the scratch and the stats), and returns
// the first CUDA error. The stats are eight int64: windows, rows
// screened, windows that ended early, resolve steps, rows whose gain the
// resolve worked out, and CTA 0's clock64 cycles in the screen (with its
// barriers), in the resolve, and in the whole launch.

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <climits>
#include <cstdint>

#include "scan_async.cuh"

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int kMaxCluster = 16;
constexpr int kMaxThreads = 1024;
constexpr int kMaxK = 32;          // a list is held one entry a lane
constexpr int kMaxTouched = 128;   // nodes of S a window may collect
constexpr int kDeferCap = 64;      // forced commits whose gain waits
constexpr int kMinChunk = 64;      // nodes a screen item walks at least
constexpr int kMaxChunks = 32;
constexpr int kSmemLimit = 232448;
constexpr unsigned kFull = 0xffffffffu;
constexpr u64 kNone = ~0ull;
constexpr float kFitCap = 8192.0f;   // ops/capacity.py FIT_CAP
constexpr float kFracQ = 16.0f;      // FRAC_Q
constexpr float kBigFit = 1048576.0f;  // BIG_FIT
constexpr unsigned kNoFitKey = 1u << 30;  // ops/rebalance.py NO_FIT_KEY

// What the resolve makes of a row.
enum { kNoCommit = 0, kCommit = 1, kExhausted = 2 };
// A record's flags.
enum { kRowLive = 1, kRowForce = 2, kRowFull = 4 };

__host__ __device__ constexpr long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}
__host__ __device__ inline int mask_words(int N) { return (N + 31) / 32; }

// The window's control and the launch's stats, in CTA 0's shared memory.
struct Ctl {
  int s, R, G, done, moves, n_touched, lanes;
  long long windows, rows, early, steps, gains;
};

// A screened row, as the resolve reads it from CTA 0's shared memory:
// its list's first pair, the two halves of the gain of a move there
// against C_s (the source's change of summed fits, the destination's),
// the row's fields, and kRowLive, kRowForce and kRowFull (K or more feasible
// nodes at C_s).
struct __align__(16) Rec {
  u64 head;
  unsigned gsrc, gdst;
  float cpu, mem;
  int src, flags;
};

// A forced row's commit whose gain the resolve works out later: the row,
// its source (-1: none) and destination, its pod, and the two nodes'
// carry just before the move.
struct Deferred {
  int row, src, dst, pad;
  float cpu, mem, scf, smf, spu, dcf, dmf, dpu;
};

// Fixed shared memory: the control, the score slices [2][cluster][2],
// the per-warp score sums [32][2], S's table (ids, then each node's
// three capacities, struct of arrays), and the deferred gains.
constexpr int kCtl = 0;
constexpr int kSums = (int)round_up(kCtl + (int)sizeof(Ctl), 16);
constexpr int kWarpSums = kSums + 2 * kMaxCluster * 2 * 4;
constexpr int kTable = kWarpSums + 32 * 2 * 4;
constexpr int kDeferred = (int)round_up(kTable + 4 * kMaxTouched * 4, 16);
constexpr int kFixedBytes = kDeferred + kDeferCap * (int)sizeof(Deferred);

// Bytes of a launch's dynamic shared memory: the fixed part, the
// window's records, then, when resident, S's bitmask, the carry (cf, mf,
// pu) and the node capacities (caps). ops/rebalance.py mirrors this to
// plan a launch.
__host__ __device__ inline long long smem_bytes(int N, int max_rows, int resident) {
  return kFixedBytes + (long long)sizeof(Rec) * max_rows +
         (resident ? round_up(4LL * mask_words(N), 16) + 2 * round_up(12LL * N, 16) : 0);
}

// Byte offsets of the device scratch the wrapper allocates: the
// window's lists [max_rows][K], the partial lists [warps][K], and in
// place the carry and S's bitmask.
struct Scratch {
  long long lists, partial, carry, mask, bytes;
};

__host__ __device__ inline Scratch scratch_layout(int N, int K, int max_rows, int warps,
                                                  int resident) {
  Scratch x;
  long long o = 0;
  x.lists = o;    o += 8LL * max_rows * K;
  x.partial = o;  o += 8LL * warps * K;
  x.carry = o;    o += resident ? 0 : round_up(12LL * N, 16);
  x.mask = o;     o += resident ? 0 : round_up(4LL * mask_words(N), 16);
  x.bytes = o;
  return x;
}

// Chunks of the node axis a row is screened in: as many as the cluster
// has warps for (a power of two), at least kMinChunk nodes each.
__host__ __device__ inline int chunks_for(int R, int warps, int N) {
  int gmax = 1;
  while (2 * gmax <= kMaxChunks && 2 * gmax * kMinChunk <= N) gmax *= 2;
  int g = 1;
  while (2 * g <= gmax && 2LL * g * R <= warps) g *= 2;
  return g;
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
  unsigned char* scratch;  // scratch_layout's bytes
  long long* stats;        // (8,) out
  int* dest;               // (D,) out
  unsigned char* moved;    // (D,) out
  int* gain;               // (D,) out
  int* n_moves;            // () out
  float* scores;           // (2,) out: before, after
  int D, N, Q, budget, C, K, first_rows, max_rows;
};

struct Row {
  float cpu, mem;
  int src;
  bool src_valid, force;
};

__device__ __forceinline__ Row load_row(const PlanArgs& a, int i) {
  Row w;
  w.cpu = __ldg(a.pod_cpu + i);
  w.mem = __ldg(a.pod_mem + i);
  w.src = __ldg(a.pod_node + i);
  w.src_valid = w.src >= 0 && w.src < a.N;
  w.force = __ldg(a.pod_force + i) != 0;
  return w;
}

__device__ __forceinline__ bool node_live(const PlanArgs& a, int j) {
  return __ldg(a.sched + j) != 0 && __ldg(a.over + j) == 0;
}

// A node's capacities as the plan reads them: cpu, memory and pod slots,
// the slots -inf where the node is not live, so that no pod fits it.
// Where a node is live its capacities are the columns' own; where it is
// not, nothing the plan computes from them counts (a dead node is never
// a destination, and a dead source has no gain half).
struct Caps {
  float c, m, p;
};

__device__ __forceinline__ Caps load_caps(const PlanArgs& a, int j) {
  Caps k;
  k.c = __ldg(a.cpu_cap + j);
  k.m = __ldg(a.mem_cap + j);
  k.p = node_live(a, j) ? __ldg(a.pods_cap + j) : __int_as_float(0xff800000);
  return k;
}

// Resident, every CTA keeps them in shared memory (caps: cpu [N], memory
// [N], slots [N]); in place they come from the columns.
template <bool kResident>
__device__ __forceinline__ Caps node_caps(const PlanArgs& a, const float* caps, int j) {
  if (kResident) {
    Caps k;
    k.c = caps[j];
    k.m = caps[a.N + j];
    k.p = caps[2 * a.N + j];
    return k;
  }
  return load_caps(a, j);
}

__device__ __forceinline__ bool caps_live(const Caps& k) {
  return k.p != __int_as_float(0xff800000);
}

// The carry: this CTA's shared memory when resident, else the device
// copy, which the resolve writes, read through L2.
template <bool kResident>
__device__ __forceinline__ float ldc(const float* p) {
  if (kResident) return *p;
  return __ldcg(p);
}

// max(a, 0) as jnp.maximum for the non-NaN values the columns hold.
__device__ __forceinline__ float relu(float x) { return x > 0.0f ? x : 0.0f; }

__device__ __forceinline__ u64 entry(unsigned key, int j) {
  return ((u64)key << 32) | (unsigned)j;
}

// 1 / max(x, 1) rounded to nearest, for a lower bound on a key, or 0 (no
// bound) for a divisor too large for the bound's margin.
__device__ __forceinline__ float bound_rcp(float x) {
  const float b = fmaxf(x, 1.0f);
  return b < 1e30f ? __frcp_rn(b) : 0.0f;
}

// The best-fit key of a node with free vector (fc, fm, fp) for a pod of
// (cpu, mem), or kNoFitKey where the pod does not fit; when `bound`
// says so, first a lower bound on it with the pod's reciprocals (rc, rm)
// in place of the two divisions, and kNoFitKey without the exact key
// when the bound is not below `below`. RN(a * RN(1 / b)) is within 2^-22
// of RN(a / b) relative, so that product less 2^-20 of itself is below
// the exact quotient, and min, clip and floor keep the order (a NaN
// bound clips to 0: no bound).
__device__ __forceinline__ unsigned fit_key(float fc, float fm, float fp, float cpu, float mem,
                                            float rc, float rm, unsigned below) {
  if (!(fc >= cpu && fm >= mem && fp >= 1.0f)) return kNoFitKey;
  const float qc = cpu > 0.0f ? __fmul_rn(__fsub_rn(fc, cpu), rc) : kBigFit;
  const float qm = mem > 0.0f ? __fmul_rn(__fsub_rn(fm, mem), rm) : kBigFit;
  float q = fminf(qc, qm);
  q = __fsub_rn(q, __fmul_rn(q, 9.5367431640625e-07f));  // 2^-20
  const unsigned bound = (unsigned)(int)floorf(__fmul_rn(fminf(fmaxf(q, 0.0f), kFitCap), kFracQ));
  if (bound >= below) return kNoFitKey;
  const float kc = cpu > 0.0f ? __fdiv_rn(__fsub_rn(fc, cpu), fmaxf(cpu, 1.0f)) : kBigFit;
  const float km = mem > 0.0f ? __fdiv_rn(__fsub_rn(fm, mem), fmaxf(mem, 1.0f)) : kBigFit;
  const float kf = fminf(fmaxf(fminf(kc, km), 0.0f), kFitCap);
  return (unsigned)(int)floorf(__fmul_rn(kf, kFracQ));
}

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

// A node's capacities and its carry at one moment.
struct Node {
  Caps k;
  float cf, mf, pu;
};

template <bool kResident>
__device__ __forceinline__ Node node_at(const PlanArgs& a, const float* caps, const float* cf,
                                        const float* mf, const float* pu, int j) {
  Node n;
  n.k = node_caps<kResident>(a, caps, j);
  n.cf = ldc<kResident>(cf + j);
  n.mf = ldc<kResident>(mf + j);
  n.pu = ldc<kResident>(pu + j);
  return n;
}

// The two halves of the gain of moving a pod of (cpu, mem) from node s
// (when `src_on`: a valid, live source) to node d (when `dst_on`): the
// change of the summed integral probe fit at each, after the move less
// before it, summed over the live probes first, first + stride, ... The
// caller adds the lanes' halves; the gain is their sum, wrapping as
// XLA's int32.
__device__ void gain_halves(const PlanArgs& a, const Node& s, bool src_on, const Node& d,
                            bool dst_on, float cpu, float mem, int first, int stride,
                            unsigned& gsrc, unsigned& gdst) {
  float fc[4] = {}, fm[4] = {}, fp[4] = {};
  if (src_on) {
    fc[0] = relu(__fsub_rn(s.k.c, s.cf));
    fm[0] = relu(__fsub_rn(s.k.m, s.mf));
    fp[0] = relu(__fsub_rn(s.k.p, s.pu));
    fc[1] = relu(__fsub_rn(s.k.c, __fsub_rn(s.cf, cpu)));
    fm[1] = relu(__fsub_rn(s.k.m, __fsub_rn(s.mf, mem)));
    fp[1] = relu(__fsub_rn(s.k.p, __fsub_rn(s.pu, 1.0f)));
  }
  if (dst_on) {
    const float dlive = caps_live(d.k) ? 1.0f : 0.0f;
    fc[2] = __fmul_rn(relu(__fsub_rn(d.k.c, d.cf)), dlive);
    fm[2] = __fmul_rn(relu(__fsub_rn(d.k.m, d.mf)), dlive);
    fp[2] = __fmul_rn(relu(__fsub_rn(d.k.p, d.pu)), dlive);
    fc[3] = relu(__fsub_rn(d.k.c, __fadd_rn(d.cf, cpu)));
    fm[3] = relu(__fsub_rn(d.k.m, __fadd_rn(d.mf, mem)));
    fp[3] = relu(__fsub_rn(d.k.p, __fadd_rn(d.pu, 1.0f)));
  }
  unsigned u[4] = {0u, 0u, 0u, 0u};
  if (src_on || dst_on) {
    for (int q = first; q < a.Q; q += stride) {
      if (!__ldg(a.probe_live + q)) continue;
      const float pc = __ldg(a.probe_cpu + q), pm = __ldg(a.probe_mem + q);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t < 2 ? src_on : dst_on) u[t] += fit_int(probe_fit(fc[t], fm[t], fp[t], pc, pm));
      }
    }
  }
  gsrc = u[1] - u[0];
  gdst = u[3] - u[2];
}

// The halves of row w's move to dst against the carry (cf, mf, pu): the
// source's when `src_half`, the destination's when `dst_half`.
template <bool kResident>
__device__ void gain_halves_now(const PlanArgs& a, const float* caps, const float* cf,
                                const float* mf, const float* pu, const Row& w, bool src_half,
                                int dst, bool dst_half, int first, int stride, unsigned& gsrc,
                                unsigned& gdst) {
  const Node sn = src_half && w.src_valid ? node_at<kResident>(a, caps, cf, mf, pu, w.src) : Node{};
  const Node dn = dst_half ? node_at<kResident>(a, caps, cf, mf, pu, dst) : Node{};
  gain_halves(a, sn, src_half && w.src_valid && caps_live(sn.k), dn, dst_half, w.cpu, w.mem, first,
              stride, gsrc, gdst);
}

// Merges one candidate a lane (kNone: none) into the warp's sorted list:
// lane i < K holds the i-th smallest entry so far, kNone past the count
// and on every lane from K on; `last` is the K-th entry, on every lane.
// A candidate that does not beat it is dropped by one ballot; the others
// go in one at a time, in lane order, each at the count of entries below
// it.
__device__ __forceinline__ void insert_batch(u64& mine, u64& last, u64 cand, int K, int lane) {
  unsigned pending = __ballot_sync(kFull, cand < last);
  if (!pending) return;
  while (pending) {
    const int l = __ffs(pending) - 1;
    pending &= pending - 1;
    const u64 c = __shfl_sync(kFull, cand, l);
    const int p = __popc(__ballot_sync(kFull, mine < c));
    if (p >= K) continue;
    const u64 up = __shfl_up_sync(kFull, mine, 1);
    if (lane == p) {
      mine = c;
    } else if (lane > p && lane < K) {
      mine = up;
    }
  }
  last = __shfl_sync(kFull, mine, K - 1);
}

// One warp's screen of row w over the nodes [lo, hi), walked in
// increasing order, four nodes a lane at a time (their loads issued
// together): its list. A node whose key's lower bound is not below the
// K-th entry's key cannot enter (the entries come from lower nodes,
// which win an equal key), so only the others take the exact key.
template <bool kResident>
__device__ u64 screen_nodes(const PlanArgs& a, const float* caps, const float* cf, const float* mf,
                            const float* pu, const Row& w, int lo, int hi, int K, int lane) {
  const float rc = bound_rcp(w.cpu), rm = bound_rcp(w.mem);
  u64 mine = kNone, last = kNone;
  for (int b = lo; b < hi; b += 4 * 32) {
    const unsigned below = (unsigned)(last >> 32);
    u64 cand[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = b + 32 * u + lane;
      const int jj = j < hi ? j : lo;
      const Caps k = node_caps<kResident>(a, caps, jj);
      const float fc = relu(__fsub_rn(k.c, ldc<kResident>(cf + jj)));
      const float fm = relu(__fsub_rn(k.m, ldc<kResident>(mf + jj)));
      const float fp = relu(__fsub_rn(k.p, ldc<kResident>(pu + jj)));
      cand[u] = kNone;
      if (j < hi && !(w.src_valid && j == w.src)) {
        const unsigned key = fit_key(fc, fm, fp, w.cpu, w.mem, rc, rm, below);
        if (key < kNoFitKey) cand[u] = entry(key, j);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) insert_batch(mine, last, cand[u], K, lane);
  }
  return mine;
}

// A screened row's list into the window's scratch, and its record, with
// the gain halves of a move to its first pair against the carry the
// screen read, into CTA 0's shared memory.
template <bool kResident>
__device__ void finish_row(const PlanArgs& a, const float* caps, const float* cf, const float* mf,
                           const float* pu, const Row& w, u64 mine, u64* list, Rec* rec, int K,
                           int lane) {
  if (lane < K) list[lane] = mine;
  const u64 head = __shfl_sync(kFull, mine, 0);
  const u64 last = __shfl_sync(kFull, mine, K - 1);
  unsigned gsrc, gdst;
  gain_halves_now<kResident>(a, caps, cf, mf, pu, w, true, (int)(unsigned)head, head != kNone,
                             lane, 32, gsrc, gdst);
  gsrc = __reduce_add_sync(kFull, gsrc);
  gdst = __reduce_add_sync(kFull, gdst);
  if (lane == 0) {
    Rec r;
    r.head = head;
    r.gsrc = gsrc;
    r.gdst = gdst;
    r.cpu = w.cpu;
    r.mem = w.mem;
    r.src = w.src;
    r.flags = kRowLive | (w.force ? kRowForce : 0) | (last != kNone ? kRowFull : 0);
    *rec = r;
  }
}

// A dead row's record: it never commits.
__device__ __forceinline__ void dead_row(Rec* rec, int lane) {
  if (lane == 0) {
    Rec r = {};
    r.head = kNone;
    r.src = -1;
    *rec = r;
  }
}

// The minimum over the warp of a 64-bit entry: the key half, then the
// node half among the lanes that hold the least key.
__device__ __forceinline__ u64 warp_min(u64 v) {
  const unsigned hi = __reduce_min_sync(kFull, (unsigned)(v >> 32));
  const unsigned lo = __reduce_min_sync(kFull, (unsigned)(v >> 32) == hi ? (unsigned)v : kFull);
  return ((u64)hi << 32) | lo;
}

// The minimum of v over each aligned group of g lanes (g a power of two).
__device__ __forceinline__ u64 group_min(u64 v, int g) {
  if (g == 32) return warp_min(v);
  for (int o = 1; o < g; o <<= 1) {
    const u64 t = __shfl_xor_sync(kFull, v, o);
    v = t < v ? t : v;
  }
  return v;
}

// The sum of v over each aligned group of g lanes.
__device__ __forceinline__ unsigned group_sum(unsigned v, int g) {
  if (g == 32) return __reduce_add_sync(kFull, v);
  for (int o = 1; o < g; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ bool in_set(const unsigned* mask, unsigned j) {
  return (mask[j >> 5] >> (j & 31)) & 1u;
}

// S's table in CTA 0's shared memory: the ids, then each node's
// capacities (Caps), so that a key of S is worked out from shared memory
// alone.
struct Table {
  int* id;
  float *cc, *mc, *pc;
};

__device__ __forceinline__ Table table_at(unsigned char* sm) {
  Table t;
  t.id = reinterpret_cast<int*>(sm + kTable);
  t.cc = reinterpret_cast<float*>(t.id + kMaxTouched);
  t.mc = t.cc + kMaxTouched;
  t.pc = t.mc + kMaxTouched;
  return t;
}

// The gains of the logged commits, into the outputs: a lane a commit over
// every probe, or, for many probes, the warp a commit.
template <bool kResident>
__device__ void flush_deferred(const PlanArgs& a, const float* caps, const Deferred* log, int n,
                               int lane) {
  auto halves = [&](const Deferred& e, int first, int stride, unsigned& hs, unsigned& hd) {
    Node sn = {}, dn = {};
    if (e.src >= 0) sn = {node_caps<kResident>(a, caps, e.src), e.scf, e.smf, e.spu};
    dn = {node_caps<kResident>(a, caps, e.dst), e.dcf, e.dmf, e.dpu};
    gain_halves(a, sn, e.src >= 0 && caps_live(sn.k), dn, true, e.cpu, e.mem, first, stride, hs,
                hd);
  };
  if (a.Q <= 32) {
    for (int i = lane; i < n; i += 32) {
      unsigned hs, hd;
      halves(log[i], 0, 1, hs, hd);
      a.gain[log[i].row] = (int)(hs + hd);
    }
  } else {
    for (int i = 0; i < n; ++i) {
      unsigned hs, hd;
      halves(log[i], lane, 32, hs, hd);
      hs = __reduce_add_sync(kFull, hs);
      hd = __reduce_add_sync(kFull, hd);
      if (lane == 0) a.gain[log[i].row] = (int)(hs + hd);
    }
  }
}

// The resolve of the window [ctl->s, ctl->s + ctl->R), by one warp, in
// row order, against the carry (cf, mf, pu) it keeps current; then the
// next window's control. See the note at the top. A step takes 32 / g
// rows, g lanes a row. Each lane group reads its row's record, finds the
// first untouched pair of its list (the head, unless a commit touched
// it), the best node of S from the current carry (behind the key's
// lower bound), and the gain: each half from the record while its node
// is untouched (the destination's only when it is the head), else from
// the current carry over the group's lanes. The first row that commits
// or ends the window is acted on; the rows before it do not commit. g
// halves after a step in which no row acted; after one in which a row
// did, a step takes twice the rows up to it (one row when it was the
// first).
template <bool kResident>
__device__ void resolve(const PlanArgs& a, Ctl* ctl, const Table& tab, unsigned* mask,
                        const float* caps, float* cf, float* mf, float* pu, const u64* lists,
                        const Rec* recs, Deferred* log, int warps, int lane) {
  const int s = ctl->s, K = a.K;
  const int e = min(s + ctl->R, a.D);
  // Clear the last window's S: every set bit belongs to one of its ids.
  int nt = ctl->n_touched;
  for (int k = lane; k < nt; k += 32) mask[tab.id[k] >> 5] = 0u;
  __syncwarp();
  nt = 0;
  int g = ctl->lanes, moves = ctl->moves;
  int row = s, end = e;
  bool early = false;
  long long steps = 0, gains_n = 0;
  // A step of one row reads the entries after its list's head that the
  // step before it fetched (one a lane), while it committed.
  u64 ahead = kNone;
  int ahead_row = -1;
  int n_log = 0;
  while (row < end) {
    const int gs = g;  // this step's lanes a row
    const int sub = lane & (g - 1);
    const int x = row + lane / g;
    Rec r = {};
    if (x < end) r = recs[x - s];
    const bool act = (r.flags & kRowLive) != 0;
    const bool src_valid = r.src >= 0 && r.src < a.N;
    const bool head_moved = act && r.head != kNone && in_set(mask, (unsigned)r.head);
    // The first untouched pair: the head, or, when a commit touched it,
    // the first untouched of the rest (the list is sorted).
    u64 au = act && !head_moved ? r.head : kNone;
    if (__any_sync(kFull, head_moved)) {
      if (head_moved && g == 32 && x == ahead_row) {
        if (ahead != kNone && !in_set(mask, (unsigned)ahead)) au = ahead;
      } else if (head_moved) {
        // This lane's stride of the rest, four loads in flight at a time.
        const u64* list = lists + (size_t)(x - s) * K;
        bool found = false;
        for (int i0 = 1 + sub; i0 < K && !found; i0 += 4 * g) {
          u64 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) v[u] = i0 + u * g < K ? __ldcg(list + i0 + u * g) : kNone;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (!found && v[u] != kNone && !in_set(mask, (unsigned)v[u])) {
              au = v[u];
              found = true;
            }
            found = found || v[u] == kNone;
          }
        }
      }
      au = group_min(au, g);
    }
    // The best node of S for this row, from its current carry.
    u64 bu = kNone;
    if (act && nt > 0) {
      const float rc = bound_rcp(r.cpu), rm = bound_rcp(r.mem);
      u64 thr = au;
      // Four entries of this lane's stride at a time against one bound,
      // so that their chains overlap.
      for (int k0 = sub; k0 < nt; k0 += 4 * g) {
        // An equal key may still win on the lower node.
        const unsigned below = thr == kNone ? kFull : (unsigned)(thr >> 32) + 1u;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = k0 + u * g;
          if (k >= nt) break;
          const int t = tab.id[k];
          if (src_valid && t == r.src) continue;
          const float fc = relu(__fsub_rn(tab.cc[k], ldc<kResident>(cf + t)));
          const float fm = relu(__fsub_rn(tab.mc[k], ldc<kResident>(mf + t)));
          const float fp = relu(__fsub_rn(tab.pc[k], ldc<kResident>(pu + t)));
          const unsigned key = fit_key(fc, fm, fp, r.cpu, r.mem, rc, rm, below);
          if (key < kNoFitKey) {
            const u64 v = entry(key, t);
            bu = v < bu ? v : bu;
          }
        }
        thr = bu < thr ? bu : thr;
      }
    }
    if (nt > 0) bu = group_min(bu, g);
    const u64 best = au < bu ? au : bu;
    const bool full = (r.flags & kRowFull) != 0;
    const bool forced = (r.flags & kRowForce) != 0;
    int st = kNoCommit;
    bool need_src = false, need_dst = false, defer = false;
    if (act) {
      if (au == kNone && full) {
        st = kExhausted;
      } else if (best != kNone) {
        need_src = src_valid && in_set(mask, (unsigned)r.src);
        need_dst = best != r.head || head_moved;
        // A forced row commits whatever its gain: the gain, an output
        // only, is worked out after the window's rows, off this chain.
        if (forced && (need_src || need_dst)) {
          defer = true;
          need_src = need_dst = false;
          st = kCommit;
        }
      }
    }
    unsigned gsrc = r.gsrc, gdst = r.gdst;
    if (__any_sync(kFull, need_src || need_dst)) {
      Row w;
      w.cpu = r.cpu;
      w.mem = r.mem;
      w.src = r.src;
      w.src_valid = src_valid;
      w.force = false;
      unsigned hs, hd;
      gain_halves_now<kResident>(a, caps, cf, mf, pu, w, need_src, (int)(unsigned)best, need_dst,
                                 sub, g, hs, hd);
      hs = group_sum(hs, g);
      hd = group_sum(hd, g);
      if (need_src) gsrc = hs;
      if (need_dst) gdst = hd;
      gains_n += __popc(__ballot_sync(kFull, sub == 0 && (need_src || need_dst)));
    }
    const int gn = (int)(gsrc + gdst);
    if (act && st == kNoCommit && best != kNone && (gn > 0 || forced)) st = kCommit;
    ++steps;
    const unsigned flagged = __ballot_sync(kFull, sub == 0 && st != kNoCommit);
    if (!flagged) {
      row = min(row + 32 / g, end);
      if (g > 1) g >>= 1;
      continue;
    }
    const int f = __ffs(flagged) - 1;
    const int fr = row + f / g;
    // The next steps take one row while the first row of a step acts,
    // else twice the rows up to the one that did.
    int per = 1;
    while (per < 32 && per < 2 * (f / g + 1) && f / g > 0) per <<= 1;
    g = 32 / per;
    // The acting row's fields: every lane holds them when the step took
    // one row.
    const bool one = gs == 32;
    const int fst = one ? st : __shfl_sync(kFull, st, f);
    if (g == 32 && fr + 1 < end) {
      const u64* list = lists + (size_t)(fr + 1 - s) * K;
      ahead = 1 + lane < K ? __ldcg(list + 1 + lane) : kNone;
      ahead_row = fr + 1;
    }
    if (fst == kExhausted || nt + 2 > kMaxTouched) {
      end = fr;
      early = true;
      break;
    }
    // The commit of row fr: lane 0 the destination, lane 1 the source,
    // lane 2 the outputs, lane 3 a deferred gain's entry (from the carry
    // read before any lane writes).
    const int dst = (int)(unsigned)(one ? best : __shfl_sync(kFull, best, f));
    const int gain = one ? gn : __shfl_sync(kFull, gn, f);
    const bool dfr = one ? defer : __shfl_sync(kFull, (int)defer, f) != 0;
    const int src = one ? r.src : __shfl_sync(kFull, r.src, f);
    const float cpu = one ? r.cpu : __shfl_sync(kFull, r.cpu, f);
    const float mem = one ? r.mem : __shfl_sync(kFull, r.mem, f);
    const bool has_src = src >= 0 && src < a.N;
    const bool add_d = !in_set(mask, (unsigned)dst);
    const bool add_s = has_src && !in_set(mask, (unsigned)src);
    Deferred d = {};
    if (dfr && lane == 3) {
      d.row = fr;
      d.src = has_src ? src : -1;
      d.dst = dst;
      d.cpu = cpu;
      d.mem = mem;
      if (has_src) {
        d.scf = ldc<kResident>(cf + src);
        d.smf = ldc<kResident>(mf + src);
        d.spu = ldc<kResident>(pu + src);
      }
      d.dcf = ldc<kResident>(cf + dst);
      d.dmf = ldc<kResident>(mf + dst);
      d.dpu = ldc<kResident>(pu + dst);
    }
    __syncwarp();
    if (lane < 2 && (lane == 0 || has_src)) {
      const int j = lane == 0 ? dst : src;
      const float sign = lane == 0 ? 1.0f : -1.0f;  // a - b is a + (-b) in IEEE
      cf[j] = __fadd_rn(ldc<kResident>(cf + j), __fmul_rn(sign, cpu));
      mf[j] = __fadd_rn(ldc<kResident>(mf + j), __fmul_rn(sign, mem));
      pu[j] = __fadd_rn(ldc<kResident>(pu + j), sign);
      if (lane == 0 ? add_d : add_s) {
        const int k = nt + (lane == 1 && add_d ? 1 : 0);
        tab.id[k] = j;
        const Caps nk = node_caps<kResident>(a, caps, j);
        tab.cc[k] = nk.c;
        tab.mc[k] = nk.m;
        tab.pc[k] = nk.p;
      }
    }
    if (lane == 0) {
      if (add_d) mask[dst >> 5] |= 1u << (dst & 31);
      if (add_s) mask[src >> 5] |= 1u << (src & 31);
    }
    if (lane == 2) {
      a.dest[fr] = dst;
      a.moved[fr] = 1;
      if (!dfr) a.gain[fr] = gain;
    }
    if (dfr && lane == 3) log[n_log] = d;
    nt += (add_d ? 1 : 0) + (add_s ? 1 : 0);
    n_log += dfr ? 1 : 0;
    __syncwarp();
    if (n_log == kDeferCap) {
      flush_deferred<kResident>(a, caps, log, n_log, lane);
      gains_n += n_log;
      n_log = 0;
      __syncwarp();
    }
    ++moves;
    row = fr + 1;
    if (moves >= a.budget) {
      end = row;
      break;
    }
  }
  flush_deferred<kResident>(a, caps, log, n_log, lane);
  gains_n += n_log;
  if (lane == 0) {
    const int R = ctl->R;
    const int floor_r = min(a.first_rows, 32);
    ctl->R = early ? max(floor_r, min(R, 2 * (end - s))) : min(2 * R, a.max_rows);
    ctl->G = chunks_for(ctl->R, warps, a.N);
    ctl->s = end;
    ctl->done = moves >= a.budget || end >= a.D;
    ctl->moves = moves;
    ctl->n_touched = nt;
    ctl->lanes = g;
    ctl->windows += 1;
    ctl->rows += e - s;
    ctl->early += early ? 1 : 0;
    ctl->steps += steps;
    ctl->gains += gains_n;
  }
}

// capacity_report's aggregate score of the carry: int32 totals of the
// integral and quantised fits over the nodes and live probes, then
// 1 - usable * FRAC_Q / potential in f32, clipped to [0, 1]. Each CTA
// sums a slice of the nodes into CTA 0's slot `which`; CTA 0's thread 0
// gets the score. Every thread of the cluster takes part.
template <bool kResident>
__device__ float cluster_score(const PlanArgs& a, cg::cluster_group& cluster, int r,
                               const float* cf, const float* mf, const float* pu,
                               unsigned* wsums, unsigned* sums, int which) {
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = (a.N + a.C - 1) / a.C;
  const int lo = r * chunk, hi = min(a.N, lo + chunk);
  unsigned usable = 0, potential = 0;
  for (int j = lo + tid; j < hi; j += T) {
    const float livef = node_live(a, j) ? 1.0f : 0.0f;
    const float fc = __fmul_rn(relu(__fsub_rn(__ldg(a.cpu_cap + j), ldc<kResident>(cf + j))), livef);
    const float fm = __fmul_rn(relu(__fsub_rn(__ldg(a.mem_cap + j), ldc<kResident>(mf + j))), livef);
    const float fp = __fmul_rn(relu(__fsub_rn(__ldg(a.pods_cap + j), ldc<kResident>(pu + j))), livef);
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
    wsums[2 * warp] = usable;
    wsums[2 * warp + 1] = potential;
  }
  __syncthreads();
  if (tid == 0) {
    unsigned u = 0, p = 0;
    for (int k = 0; k < T / 32; ++k) {
      u += wsums[2 * k];
      p += wsums[2 * k + 1];
    }
    unsigned* slot = cluster.map_shared_rank(sums, 0) + 2 * (which * kMaxCluster + r);
    slot[0] = u;
    slot[1] = p;
  }
  cluster.sync();
  float score = 0.0f;
  if (r == 0 && tid == 0) {
    unsigned u = 0, p = 0;
    for (int k = 0; k < a.C; ++k) {
      u += sums[2 * (which * kMaxCluster + k)];
      p += sums[2 * (which * kMaxCluster + k) + 1];
    }
    const int ui = (int)u, pi = (int)p;
    if (pi > 0) {
      const float ratio = __fsub_rn(1.0f, __fdiv_rn(__fmul_rn(__int2float_rn(ui), kFracQ),
                                                    __int2float_rn(pi)));
      score = fminf(fmaxf(ratio, 0.0f), 1.0f);
    }
  }
  return score;
}

template <bool kResident>
__global__ void __launch_bounds__(kMaxThreads, 1) plan_kernel(const PlanArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31, warp = tid >> 5;
  // Screen items go round the CTAs first, so that a short window keeps
  // every SM busy.
  const int nw = T >> 5, W = a.C * nw, gw = warp * a.C + r;
  const int N = a.N, K = a.K;
  const bool timer = r == 0 && tid == 0;
  const long long t_start = timer ? clock64() : 0;

  unsigned char* sm = dyn_smem();
  Ctl* ctl = reinterpret_cast<Ctl*>(sm + kCtl);
  unsigned* sums = reinterpret_cast<unsigned*>(sm + kSums);
  unsigned* wsums = reinterpret_cast<unsigned*>(sm + kWarpSums);
  const Table tab = table_at(sm);
  Deferred* log = reinterpret_cast<Deferred*>(sm + kDeferred);
  Rec* recs = reinterpret_cast<Rec*>(sm + kFixedBytes);
  Rec* recs0 = cluster.map_shared_rank(recs, 0);
  unsigned char* tail = sm + kFixedBytes + sizeof(Rec) * (size_t)a.max_rows;
  const Scratch X = scratch_layout(N, K, a.max_rows, W, kResident);
  u64* lists = reinterpret_cast<u64*>(a.scratch + X.lists);
  u64* partial = reinterpret_cast<u64*>(a.scratch + X.partial);
  unsigned* mask = kResident ? reinterpret_cast<unsigned*>(tail)
                             : reinterpret_cast<unsigned*>(a.scratch + X.mask);
  float* cf = kResident ? reinterpret_cast<float*>(tail + round_up(4LL * mask_words(N), 16))
                        : reinterpret_cast<float*>(a.scratch + X.carry);
  float* mf = cf + N;
  float* pu = cf + 2 * N;
  float* caps = kResident ? reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(cf) +
                                                     round_up(12LL * N, 16))
                          : nullptr;

  // The carry and the capacities (a copy in each CTA, or the carry once
  // in device memory split over the CTAs), the outputs, S and the first
  // window's control.
  if (kResident) {
    for (int j = tid; j < N; j += T) {
      cf[j] = __ldg(a.cpu_fit + j);
      mf[j] = __ldg(a.mem_fit + j);
      pu[j] = __ldg(a.pods_used + j);
      const Caps k = load_caps(a, j);
      caps[j] = k.c;
      caps[N + j] = k.m;
      caps[2 * N + j] = k.p;
    }
  } else {
    for (int j = r * T + tid; j < N; j += a.C * T) {
      cf[j] = __ldg(a.cpu_fit + j);
      mf[j] = __ldg(a.mem_fit + j);
      pu[j] = __ldg(a.pods_used + j);
    }
  }
  for (int i = r * T + tid; i < a.D; i += a.C * T) {
    a.dest[i] = -1;
    a.moved[i] = 0;
    a.gain[i] = 0;
  }
  if (r == 0) {
    for (int k = tid; k < mask_words(N); k += T) mask[k] = 0u;
    if (tid == 0) {
      Ctl c = {};
      c.s = 0;
      c.R = a.first_rows;
      c.G = chunks_for(a.first_rows, W, N);
      c.done = a.budget <= 0 || a.D == 0;
      c.lanes = 1;
      *ctl = c;
    }
  }
  cluster.sync();
  const float before = cluster_score<kResident>(a, cluster, r, cf, mf, pu, wsums, sums, 0);

  const Ctl* ctl0 = cluster.map_shared_rank(ctl, 0);
  long long screen_cycles = 0, resolve_cycles = 0;
  for (;;) {
    const int s = ctl0->s, R = ctl0->R, G = ctl0->G, done = ctl0->done;
    if (done) break;
    const long long t0 = timer ? clock64() : 0;
    const int e = min(s + R, a.D);

    // -- screen: (row, chunk) items over every warp of the cluster -------
    const int items = (e - s) * G;
    const int cs = (N + G - 1) / G;
    for (int it = gw; it < items; it += W) {
      const int i = it / G, x = s + i, ch = it % G;
      if (!__ldg(a.pod_live + x)) {  // a dead row never commits
        if (G == 1) dead_row(recs0 + i, lane);
        continue;
      }
      const Row w = load_row(a, x);
      const int lo = ch * cs;
      const u64 mine =
          screen_nodes<kResident>(a, caps, cf, mf, pu, w, lo, min(N, lo + cs), K, lane);
      if (G == 1) {
        finish_row<kResident>(a, caps, cf, mf, pu, w, mine, lists + (size_t)i * K, recs0 + i, K,
                              lane);
      } else if (lane < K) {
        partial[(size_t)it * K + lane] = mine;
      }
    }
    if (G > 1) {
      cluster.sync();  // every chunk's list is in the scratch
      for (int i = gw; i < e - s; i += W) {
        const int x = s + i;
        if (!__ldg(a.pod_live + x)) {
          dead_row(recs0 + i, lane);
          continue;
        }
        const u64* part = partial + (size_t)i * G * K;
        u64 mine = kNone, last = kNone;
        for (int b = 0; b < G * K; b += 32) {
          const int k = b + lane;
          insert_batch(mine, last, k < G * K ? __ldcg(part + k) : kNone, K, lane);
        }
        finish_row<kResident>(a, caps, cf, mf, pu, load_row(a, x), mine, lists + (size_t)i * K,
                              recs0 + i, K, lane);
      }
    }
    cluster.sync();  // the window's lists and records are in place
    const long long t1 = timer ? clock64() : 0;

    // -- resolve: one warp of CTA 0, against CTA 0's carry ---------------
    if (r == 0 && warp == 0) resolve<kResident>(a, ctl, tab, mask, caps, cf, mf, pu, lists, recs, log, W, lane);
    cluster.sync();  // the control, S and the carry of CTA 0 are final
    if (timer) {
      const long long t2 = clock64();
      screen_cycles += t1 - t0;
      resolve_cycles += t2 - t1;
    }

    // -- the window's commits into this CTA's copy of the carry ----------
    if (kResident && r != 0) {
      const int* rids = cluster.map_shared_rank(tab.id, 0);
      const float* rcf = cluster.map_shared_rank(cf, 0);
      const int nt = ctl0->n_touched;
      for (int k = tid; k < nt; k += T) {
        const int t = rids[k];
        cf[t] = rcf[t];
        mf[t] = rcf[N + t];
        pu[t] = rcf[2 * N + t];
      }
    }
    __syncthreads();
  }

  const float after = cluster_score<kResident>(a, cluster, r, cf, mf, pu, wsums, sums, 1);
  if (timer) {
    *a.n_moves = ctl->moves;
    a.scores[0] = before;
    a.scores[1] = after;
    a.stats[0] = ctl->windows;
    a.stats[1] = ctl->rows;
    a.stats[2] = ctl->early;
    a.stats[3] = ctl->steps;
    a.stats[4] = ctl->gains;
    a.stats[5] = screen_cycles;
    a.stats[6] = resolve_cycles;
    a.stats[7] = clock64() - t_start;
  }
}

using Kernel = void (*)(PlanArgs);

cudaError_t configure(Kernel kernel, int C, int threads, int bytes, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  cudaError_t e;
  if (C > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->gridDim = dim3(C, 1, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = bytes;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// The dynamic shared memory of a launch.
extern "C" long long ktt_rebalance_smem_bytes(int N, int max_rows, int resident) {
  return smem_bytes(N, max_rows, resident);
}

// The device scratch of a launch (warps: of the whole cluster).
extern "C" long long ktt_rebalance_scratch_bytes(int N, int K, int max_rows, int warps,
                                                 int resident) {
  return scratch_layout(N, K, max_rows, warps, resident).bytes;
}

extern "C" int ktt_rebalance_launch(
    const void* cpu_cap, const void* mem_cap, const void* pods_cap,
    const void* cpu_fit, const void* mem_fit, const void* pods_used,
    const void* over, const void* sched,
    const void* pod_cpu, const void* pod_mem, const void* pod_node,
    const void* pod_live, const void* pod_force,
    const void* probe_cpu, const void* probe_mem, const void* probe_live,
    void* scratch, void* stats, void* dest, void* moved, void* gain, void* n_moves, void* scores,
    int D, int N, int Q, int budget, int cluster, int threads, int k, int first_rows,
    int max_rows, int resident, void* stream) {
  if (D < 0 || N < 1 || Q < 1 || cluster < 1 || cluster > kMaxCluster || threads < 32 ||
      threads > kMaxThreads || threads % 32 || k < 1 || k > kMaxK || first_rows < 1 ||
      max_rows < first_rows || scratch == nullptr || stats == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long bytes = smem_bytes(N, max_rows, resident);
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
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
  a.scratch = static_cast<unsigned char*>(scratch);
  a.stats = static_cast<long long*>(stats);
  a.dest = static_cast<int*>(dest);
  a.moved = static_cast<unsigned char*>(moved);
  a.gain = static_cast<int*>(gain);
  a.n_moves = static_cast<int*>(n_moves);
  a.scores = static_cast<float*>(scores);
  a.D = D;
  a.N = N;
  a.Q = Q;
  a.budget = budget;
  a.C = cluster;
  a.K = k;
  a.first_rows = first_rows;
  a.max_rows = max_rows;
  const Kernel kernel = resident ? plan_kernel<true> : plan_kernel<false>;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t e = configure(kernel, cluster, threads, static_cast<int>(bytes), &cfg, &attr);
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

extern "C" const char* ktt_rebalance_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
