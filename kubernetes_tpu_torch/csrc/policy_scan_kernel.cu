// The policy-spec sequential solve ("K1P") in one launch, on one CTA.
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
// N-wide max whose winner changes what the next step reads, as for the
// scan kernel. Bytes and operations are small beside that chain of
// latencies. ServiceAntiAffinity adds a second dependency inside a
// step: no node can be scored before the zone sums over every feasible
// node exist. The design is the simplest that keeps a step on one SM:
//   - one CTA of up to 1024 threads walks the pods in order; thread t
//     owns nodes t, t + T, ...; the carry stays in device memory (L2
//     holds it), the pod's row is read by every thread (broadcast);
//   - phase A: each thread evaluates feasibility and the score without
//     the anti-affinity terms for its nodes, keeps both in shared
//     memory, and adds each feasible node's count of the pod's service
//     into the zone bins of each instance (shared-memory atomics);
//     a block barrier; phase B: each thread adds the instances' zone
//     scores read from the bins. Without anti-affinity, one phase;
//   - one block-wide max over 64-bit keys (score << 32 | ~index, an
//     infeasible node at -1), so the choice is JAX's masked argmax for
//     any int32 score: the first maximal node if that maximum is >= 0;
//   - warp 0 commits, one lane per carry entry of the chosen node; lane
//     0 updates the per-service carry in id order; the zone bins are
//     cleared by all threads; one more barrier ends the step;
//   - the max count of every service is kept current across commits
//     (counts only grow), so ServiceSpreading needs no second reduction.
// A pod that no node can take whatever the carry (hostname gated on and
// a pin outside [-1, N): the padding's -2) takes no step: its choice
// is -1 and its commit only adds its ids to the scratch slot of
// svc_total, as JAX's commit does.
//
// Parity with the plain version is bit for bit: -fmad=false, no fast
// math, the _rn intrinsics, floor_div where JAX's `//` floors, and
// int32 arithmetic that wraps. Counts and their maxima change by atomics
// (performed in L2), so they are read with __ldcg, never from L1.
//
// Launcher: plain C, loaded with ctypes. It launches on the caller's
// stream, never synchronises, allocates nothing, and returns the first
// CUDA error. The launch plan (threads, shared memory, limits) is
// checked in Python (ops/policy_scan.py) before any launch.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "scan_async.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxAA = 8;    // ServiceAntiAffinity instances
constexpr int kMaxAff = 8;   // ServiceAffinity labels

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
// ids and the affinity pins.
constexpr int kRowCpu = 0;   // f32 bits
constexpr int kRowMem = 1;   // f32 bits
constexpr int kRowZero = 2;  // 0 or 1
constexpr int kRowPin = 3;
constexpr int kRowSvc = 4;
constexpr int kRowBits = 5;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Byte offsets of the regions of the CTA's dynamic shared memory, each
// a multiple of 16. ops/policy_scan.py mirrors this to plan a launch.
struct Layout {
  int red, bins, part, feas, bytes;
};

__host__ __device__ inline Layout make_layout(int N, int n_aa, int zone_bins) {
  Layout L;
  int o = 0;
  L.red = o;   o += 32 * 8;                              // a key per warp
  L.bins = o;  o += round_up(4 * zone_bins, 16);         // zone sums
  L.part = o;  o += n_aa > 0 ? round_up(4 * N, 16) : 0;  // score before the zones
  L.feas = o;  o += n_aa > 0 ? round_up(N, 16) : 0;      // feasibility
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
  int* counts;      // (S, N)
  int* maxc;        // (S,) scratch
  int* anchor;      // (SA,) or null
  float* svc_total; // (SA,) or null
  int* choice;      // (P,) out
  int P, N, S, SW, PW, VW, K, KA, SA, row_words, flags;
  int w_lr, w_bra, w_spread;
  int n_aa;
  int aa_w[kMaxAA];
  int aa_nz[kMaxAA];
  int aa_off[kMaxAA];  // first bin of each instance
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

__global__ void __launch_bounds__(kMaxThreads, 1) policy_scan_kernel(const PolicyArgs a) {
  const Layout L = a.L;
  const int T = (int)blockDim.x;
  const int tid = (int)threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = T >> 5;
  const int N = a.N;
  const int S = a.S;
  const int SW = a.SW, PW = a.PW, VW = a.VW, K = a.K, KA = a.KA;
  const int flags = a.flags;
  const int n_aa = a.n_aa;
  const bool carry_svc = (flags & kServiceCarry) != 0;
  const int scratch = a.SA - 1;
  const int ids_at = kRowBits + SW + PW + 2 * VW;
  const int pins_at = ids_at + K;

  unsigned char* sm = dyn_smem();
  long long* red = reinterpret_cast<long long*>(sm + L.red);  // one key per warp
  int* bins = reinterpret_cast<int*>(sm + L.bins);            // [aa_off[i] + zone]
  int* part = reinterpret_cast<int*>(sm + L.part);            // [node]
  unsigned char* feas = sm + L.feas;                          // [node]

  // Prologue: zero the bins, and the max count of every service, one
  // warp per service.
  for (int b = tid; b < a.zone_bins; b += T) bins[b] = 0;
  for (int s = warp; s < S; s += n_warps) {
    int m = INT_MIN;
    for (int n = lane; n < N; n += 32) m = max(m, a.counts[(size_t)s * N + n]);
    m = warp_max_int(m);
    if (lane == 0) a.maxc[s] = m;
  }
  __syncthreads();

  for (int p = 0; p < a.P; ++p) {
    const int* row = a.pod_rows + (size_t)p * a.row_words;
    const int pin = row[kRowPin];
    const int* ids = row + ids_at;
    if ((flags & kHostname) && pin != -1 && (pin < 0 || pin >= N)) {
      // No node can take this pod: choice -1 and no step. JAX's commit
      // still sends every id of an unplaced pod to the scratch slot.
      if (tid == 0) {
        a.choice[p] = -1;
        if (carry_svc) {
          for (int k = 0; k < K; ++k) a.svc_total[scratch] = __fadd_rn(a.svc_total[scratch], 1.0f);
        }
      }
      continue;  // nothing else changed: no barrier needed
    }
    const float cpu = __int_as_float(row[kRowCpu]);
    const float mem = __int_as_float(row[kRowMem]);
    const bool zero = row[kRowZero] != 0;
    const int svc = row[kRowSvc];
    const int* sel = row + kRowBits;
    const int* port = sel + SW;
    const int* vol_any = port + PW;
    const int* vol_rw = vol_any + VW;
    const int* aff_pin = row + pins_at;
    // JAX clamps a dynamic index into range; the lowering never gives
    // one outside [-1, S).
    const int svc_row = min(max(svc, 0), S - 1);
    const int maxc = __ldcg(a.maxc + svc_row);
    const int* counts_row = a.counts + (size_t)svc_row * N;

    // The pod's service carry, read once per step: its anchor and peer
    // count, or the scratch slot's when it has no service.
    int anchor = -1;
    float peers = 0.0f;
    if (carry_svc) {
      const int slot = svc >= 0 ? svc : scratch;
      anchor = a.anchor[slot];
      peers = a.svc_total[slot];
    }
    // ServiceAntiAffinity's numServicePods.
    const int num = svc >= 0 ? __float2int_rz(peers) : 0;
    // ServiceAffinity: what each affinity label must equal (-1: free).
    int need[kMaxAff];
    bool anchor_err = false;
    if (flags & kServiceAffinity) {
      bool any_unpinned = false;
      for (int k = 0; k < KA; ++k) any_unpinned |= aff_pin[k] < 0;
      const bool consults = any_unpinned && svc >= 0 && peers > 0.0f;
      anchor_err = consults && anchor == -2;
      const bool anchor_ok = consults && anchor >= 0;
      const int arow = min(max(anchor, 0), N - 1);
#pragma unroll
      for (int k = 0; k < kMaxAff; ++k) {
        if (k < KA) {
          need[k] = aff_pin[k] >= 0 ? aff_pin[k]
                    : anchor_ok     ? a.aff_vid[(size_t)arow * KA + k]
                                    : -1;
        }
      }
    }

    // -- phase A: feasibility and the score before the zones -----------
    long long best = LLONG_MIN;
    for (int n = tid; n < N; n += T) {
      const float cap_c = a.cpu_cap[n];
      const float cap_m = a.mem_cap[n];
      const float cap_p = a.pods_cap[n];
      const float used_p = a.pods_used[n];
      bool ok = a.sched[n] != 0;
      if (flags & kResources) {
        const bool fits_cpu = cap_c == 0.0f || __fadd_rn(a.cpu_fit[n], cpu) <= cap_c;
        const bool fits_mem = cap_m == 0.0f || __fadd_rn(a.mem_fit[n], mem) <= cap_m;
        const bool fits_count = __fadd_rn(used_p, 1.0f) <= cap_p;
        const bool nonzero_ok = (a.over[n] == 0) & fits_cpu & fits_mem & fits_count;
        const bool zero_ok = used_p < cap_p;
        ok &= zero ? zero_ok : nonzero_ok;
      }
      if (flags & kSelector) {
        for (int w = 0; w < SW; ++w) {
          const int sw = sel[w];
          ok &= (sw & a.labels[(size_t)n * SW + w]) == sw;
        }
      }
      if (flags & kPorts) {
        for (int w = 0; w < PW; ++w) ok &= (port[w] & a.uport[(size_t)n * PW + w]) == 0;
      }
      if (flags & kDisk) {
        for (int w = 0; w < VW; ++w) {
          const size_t i = (size_t)n * VW + w;
          ok &= ((vol_rw[w] & a.uvol_any[i]) | (vol_any[w] & a.uvol_rw[i])) == 0;
        }
      }
      if (flags & kHostname) ok &= (pin == -1) | (pin == n);
      if (flags & kNodeLabel) ok &= a.policy_ok[n] != 0;
      if (flags & kServiceAffinity) {
#pragma unroll
        for (int k = 0; k < kMaxAff; ++k) {
          if (k < KA) ok &= (need[k] < 0) | (a.aff_vid[(size_t)n * KA + k] == need[k]);
        }
        ok &= !anchor_err;
      }

      const int icap_c = __float2int_rz(cap_c);
      const int icap_m = __float2int_rz(cap_m);
      const int req_c = __float2int_rz(__fadd_rn(a.cpu_used[n], cpu));
      const int req_m = __float2int_rz(__fadd_rn(a.mem_used[n], mem));
      const int lr = floor_div(
          wadd(least_requested(req_c, icap_c), least_requested(req_m, icap_m)), 2);
      const float cf = fraction(req_c, icap_c);
      const float mf = fraction(req_m, icap_m);
      int bra = 0;
      if (!(cf >= 1.0f || mf >= 1.0f)) {
        const float d = __fmul_rn(fabsf(__fsub_rn(cf, mf)), 10.0f);
        bra = __float2int_rz(__fadd_rn(__fsub_rn(10.0f, d), 1e-5f));
      }
      const int count = __ldcg(counts_row + n);
      int spread = 10;
      if (svc >= 0 && maxc != 0) {
        spread = floor_div(wmul(10, wsub(maxc, count)), maxc > 1 ? maxc : 1);
      }
      int total = wadd(wadd(wmul(lr, a.w_lr), wmul(bra, a.w_bra)), wmul(spread, a.w_spread));
      if (flags & kStaticPrio) total = wadd(total, a.static_prio[n]);

      if (n_aa > 0) {
        // Each instance's zone sums take the feasible nodes' counts;
        // JAX's scatter drops a zone past the vocabulary.
        for (int i = 0; i < n_aa; ++i) {
          const int zone = a.aa_zone[(size_t)n * n_aa + i];
          if (ok && zone >= 0 && zone < a.aa_nz[i] && count != 0) {
            atomicAdd(bins + a.aa_off[i] + zone, count);
          }
        }
        part[n] = total;
        feas[n] = ok;
      } else {
        const long long key = make_key(ok ? total : -1, n);
        best = key > best ? key : best;
      }
    }

    // -- phase B: the anti-affinity scores from the zone sums ----------
    if (n_aa > 0) {
      __syncthreads();  // every node's count is in the bins
      for (int n = tid; n < N; n += T) {
        int total = part[n];
        for (int i = 0; i < n_aa; ++i) {
          const int zone = a.aa_zone[(size_t)n * n_aa + i];
          // JAX's gather clamps a zone past the vocabulary.
          const int count_z = bins[a.aa_off[i] + min(max(zone, 0), a.aa_nz[i] - 1)];
          int score = num > 0 ? floor_div(wmul(10, wsub(num, count_z)), num) : 10;
          if (zone < 0) score = 0;
          total = wadd(total, wmul(score, a.aa_w[i]));
        }
        const long long key = make_key(feas[n] ? total : -1, n);
        best = key > best ? key : best;
      }
    }

    // -- select: first max by lowest index -------------------------------
    best = warp_max_key(best);
    if (lane == 0) red[warp] = best;
    __syncthreads();
    // The bins have been read by every thread: clear them for the next
    // step (the barrier at the end of the step orders this before it).
    for (int b = tid; b < a.zone_bins; b += T) bins[b] = 0;
    if (warp == 0) {
      const long long v = warp_max_key(lane < n_warps ? red[lane] : LLONG_MIN);
      const int value = (int)(unsigned)((unsigned long long)v >> 32);
      const int c =
          (N > 0 && value >= 0) ? (int)(0xffffffffu - (unsigned)(v & 0xffffffffLL)) : -1;
      if (lane == 0) {
        a.choice[p] = c;
        if (carry_svc) {
          // The placed pod becomes a peer of each service it matches
          // and the anchor of each that had none; invalid ids, and all
          // ids of an unplaced pod, go to the scratch slot. In id order,
          // as JAX's scatter applies repeats.
          for (int k = 0; k < K; ++k) {
            const int slot = (ids[k] >= 0 && c >= 0) ? ids[k] : scratch;
            a.svc_total[slot] = __fadd_rn(a.svc_total[slot], 1.0f);
            if (a.anchor[slot] == -1) a.anchor[slot] = c;
          }
        }
      }
      // -- commit: one lane per carry entry of the chosen node ------------
      if (c >= 0) {
        const int n_tasks = 5 + PW + 2 * VW + K;
        for (int t = lane; t < n_tasks; t += 32) {
          if (t < 5) {
            float* field = t == 0 ? a.cpu_fit : t == 1 ? a.mem_fit : t == 2 ? a.cpu_used
                         : t == 3 ? a.mem_used : a.pods_used;
            const float add = t == 4 ? 1.0f : (t & 1) ? mem : cpu;
            field[c] = __fadd_rn(field[c], add);
          } else if (t < 5 + PW) {
            const int w = t - 5;
            a.uport[(size_t)c * PW + w] |= port[w];
          } else if (t < 5 + PW + 2 * VW) {
            const int w = (t - 5 - PW) % VW;
            const bool rw = t - 5 - PW >= VW;
            int* words = rw ? a.uvol_rw : a.uvol_any;
            words[(size_t)c * VW + w] |= (rw ? vol_rw : vol_any)[w];
          } else {
            // Once per occurrence of an id (a repeated id adds twice, so
            // the add is atomic); ids outside [0, S) commit nothing
            // (JAX's scatter mode="drop"). Counts only grow, so the
            // service's max is the max of the new counts.
            const int sid = ids[t - 5 - PW - 2 * VW];
            if (sid >= 0 && sid < S) {
              const int cnt = atomicAdd(a.counts + (size_t)sid * N + c, 1) + 1;
              atomicMax(a.maxc + sid, cnt);
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// The dynamic shared memory of a launch.
extern "C" int ktt_policy_smem_bytes(int N, int n_aa, int zone_bins) {
  return make_layout(N, n_aa, zone_bins).bytes;
}

extern "C" int ktt_policy_launch(
    const void* pod_rows,
    const void* cpu_cap, const void* mem_cap, const void* pods_cap,
    const void* over, const void* sched, const void* labels,
    const void* policy_ok, const void* static_prio, const void* aff_vid, const void* aa_zone,
    void* cpu_fit, void* mem_fit, void* cpu_used, void* mem_used,
    void* pods_used, void* uport, void* uvol_any, void* uvol_rw,
    void* counts, void* maxc, void* anchor, void* svc_total, void* choice,
    int P, int N, int S, int SW, int PW, int VW, int K, int KA, int SA, int row_words,
    int flags, int w_lr, int w_bra, int w_spread,
    int n_aa, const int* aa_w, const int* aa_nz, int threads, void* stream) {
  if (n_aa < 0 || n_aa > kMaxAA || KA < 0 || KA > kMaxAff || threads < 32 ||
      threads > kMaxThreads || threads % 32 || S < 1) {
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
  a.maxc = static_cast<int*>(maxc);
  a.anchor = static_cast<int*>(anchor);
  a.svc_total = static_cast<float*>(svc_total);
  a.choice = static_cast<int*>(choice);
  a.P = P;
  a.N = N;
  a.S = S;
  a.SW = SW;
  a.PW = PW;
  a.VW = VW;
  a.K = K;
  a.KA = KA;
  a.SA = SA;
  a.row_words = row_words;
  a.flags = flags;
  a.w_lr = w_lr;
  a.w_bra = w_bra;
  a.w_spread = w_spread;
  a.n_aa = n_aa;
  a.zone_bins = 0;
  for (int i = 0; i < kMaxAA; ++i) {
    a.aa_w[i] = i < n_aa ? aa_w[i] : 0;
    a.aa_nz[i] = i < n_aa ? aa_nz[i] : 0;
    a.aa_off[i] = a.zone_bins;
    if (i < n_aa) {
      if (aa_nz[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
      a.zone_bins += aa_nz[i];
    }
  }
  a.L = make_layout(N, n_aa, a.zone_bins);
  cudaError_t e = cudaFuncSetAttribute(policy_scan_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, a.L.bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = a.L.bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = nullptr;
  cfg.numAttrs = 0;
  e = cudaLaunchKernelEx(&cfg, policy_scan_kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ktt_policy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
