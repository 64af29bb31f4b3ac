// The sequential-parity scan: the whole default-spec solve in one launch.
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
// operations are small beside that chain. The design is one persistent
// thread block that walks the pods in order:
//   - thread t owns nodes t, t + blockDim, ...; every step reads the
//     pod's row (the same addresses in all threads: broadcast loads);
//   - one block-wide max over 64-bit keys (score << 32 | ~index) picks
//     the first maximal node, with infeasible nodes at -1 below every
//     feasible score, for any weights and any N;
//   - warp 0 commits, one lane per carry entry of the chosen node (the
//     f32 fields, each bitset word, each service id), all at once: only
//     the chosen node's entries are written;
//   - the next pod's scalars load while this pod's max is reduced;
//   - two barriers per pod and nothing else: no launch, no host round
//     trip, no grid-wide synchronisation.
// The carry stays in device memory (L2 holds all of it at 5k nodes x
// 512 services). Service counts are (S, N) int32 so the row one pod
// reads is contiguous, and the max count of every service is kept
// current across commits (counts only grow), so a step needs no second
// reduction for ServiceSpreading.
//
// Parity with the plain version is bit for bit. Build with -fmad=false
// and without fast math; the f32 arithmetic below is spelled with the
// _rn intrinsics besides. JAX's `//` floors where C's `/` truncates:
// floor_div is used wherever an operand may be negative.
//
// Launcher: plain C, loaded with ctypes. It launches on the caller's
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

struct ScanArgs {
  // Pods, (P,) or (P, width), row-major.
  const float* pod_cpu;
  const float* pod_mem;
  const unsigned char* pod_zero;
  const int* pod_pinned;
  const int* pod_svc;
  const int* pod_sel;      // (P, SW)
  const int* pod_port;     // (P, PW)
  const int* pod_vol_any;  // (P, VW)
  const int* pod_vol_rw;   // (P, VW)
  const int* pod_svc_ids;  // (P, K)
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
  int* counts;    // (S, N)
  int* maxc;      // (S,) scratch
  int* choice;    // (P,) out
  int P, N, S, SW, PW, VW, K;
  int w_lr, w_bra, w_spread;
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

__device__ __forceinline__ long long warp_max64(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    long long other = __shfl_xor_sync(0xffffffffu, v, o);
    v = other > v ? other : v;
  }
  return v;
}

__device__ __forceinline__ int warp_max32(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// (value, node) -> a key whose signed order is value first, then the
// LOWER node index.
__device__ __forceinline__ long long make_key(int value, int node) {
  unsigned long long hi = (unsigned long long)(unsigned)value << 32;
  return (long long)(hi | (unsigned long long)(0xffffffffu - (unsigned)node));
}

struct PodScalars {
  float cpu, mem;
  bool zero;
  int pin, svc;
};

__device__ __forceinline__ PodScalars load_pod(const ScanArgs& a, int p) {
  PodScalars s;
  s.cpu = a.pod_cpu[p];
  s.mem = a.pod_mem[p];
  s.zero = a.pod_zero[p] != 0;
  s.pin = a.pod_pinned[p];
  s.svc = a.pod_svc[p];
  return s;
}

__global__ void __launch_bounds__(kThreads, 1) scan_kernel(const ScanArgs a) {
  __shared__ long long red[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int N = a.N;
  const int S = a.S;

  // Prologue: the max count of every service, one warp per service.
  for (int s = warp; s < S; s += kWarps) {
    int m = INT_MIN;
    for (int n = lane; n < N; n += 32) m = max(m, a.counts[(size_t)s * N + n]);
    m = warp_max32(m);
    if (lane == 0) a.maxc[s] = m;
  }
  __syncthreads();

  if (a.P == 0) return;
  PodScalars cur = load_pod(a, 0);
  for (int p = 0; p < a.P; ++p) {
    const float cpu = cur.cpu;
    const float mem = cur.mem;
    const bool zero = cur.zero;
    const int pin = cur.pin;
    const int svc = cur.svc;
    // JAX clamps a dynamic index into range; the lowering never gives
    // one outside [-1, S).
    const int svc_row = min(max(svc, 0), S - 1);
    // Counts and their maxima change at every commit; they are read from
    // L2 (__ldcg), where the previous pod's atomics landed.
    const int maxc = __ldcg(a.maxc + svc_row);
    const int* sel = a.pod_sel + (size_t)p * a.SW;
    const int* port = a.pod_port + (size_t)p * a.PW;
    const int* vol_any = a.pod_vol_any + (size_t)p * a.VW;
    const int* vol_rw = a.pod_vol_rw + (size_t)p * a.VW;
    const int* counts_row = a.counts + (size_t)svc_row * N;

    long long best = LLONG_MIN;
    for (int n = tid; n < N; n += kThreads) {
      // -- predicates (solver._feasible, default spec) -----------------
      const float cap_c = a.cpu_cap[n];
      const float cap_m = a.mem_cap[n];
      const float cap_p = a.pods_cap[n];
      const float used_p = a.pods_used[n];
      const bool fits_cpu = cap_c == 0.0f || __fadd_rn(a.cpu_fit[n], cpu) <= cap_c;
      const bool fits_mem = cap_m == 0.0f || __fadd_rn(a.mem_fit[n], mem) <= cap_m;
      const bool fits_count = __fadd_rn(used_p, 1.0f) <= cap_p;
      // Bitwise & rather than &&: every load is unconditional, so they
      // all issue at once instead of one branch at a time.
      const bool nonzero_ok = (a.over[n] == 0) & fits_cpu & fits_mem & fits_count;
      const bool zero_ok = used_p < cap_p;
      bool ok = (a.sched[n] != 0) & (zero ? zero_ok : nonzero_ok);
      for (int w = 0; w < a.SW; ++w) {
        const int sw = sel[w];
        ok &= (sw & a.labels[(size_t)n * a.SW + w]) == sw;
      }
      for (int w = 0; w < a.PW; ++w) ok &= (port[w] & a.uport[(size_t)n * a.PW + w]) == 0;
      for (int w = 0; w < a.VW; ++w) {
        const size_t i = (size_t)n * a.VW + w;
        ok &= ((vol_rw[w] & a.uvol_any[i]) | (vol_any[w] & a.uvol_rw[i])) == 0;
      }
      ok &= (pin == -1) | (pin == n);

      // -- priorities (solver._component_scores) -----------------------
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
      int spread = 10;
      if (svc >= 0 && maxc != 0) {
        spread = floor_div(wmul(10, wsub(maxc, __ldcg(counts_row + n))), maxc > 1 ? maxc : 1);
      }
      const int total =
          wadd(wadd(wmul(lr, a.w_lr), wmul(bra, a.w_bra)), wmul(spread, a.w_spread));

      const long long key = make_key(ok ? total : -1, n);
      best = key > best ? key : best;
    }
    // The next pod's scalars do not depend on this pod's commit: load
    // them now, so their latency hides behind the reduction.
    const PodScalars next = p + 1 < a.P ? load_pod(a, p + 1) : cur;

    // -- select: first max by lowest index ------------------------------
    best = warp_max64(best);
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      long long v = lane < kWarps ? red[lane] : LLONG_MIN;
      v = warp_max64(v);  // every lane of warp 0 holds the winner
      const int value = (int)(unsigned)((unsigned long long)v >> 32);
      const int c =
          (N > 0 && value >= 0) ? (int)(0xffffffffu - (unsigned)(v & 0xffffffffLL)) : -1;
      if (lane == 0) a.choice[p] = c;
      // -- commit (solver._commit) --------------------------------------
      // One lane per carry entry of the chosen node: the five f32 fields,
      // each port and volume word, and each service id, all at once.
      if (c >= 0) {
        const int n_tasks = 5 + a.PW + 2 * a.VW + a.K;
        for (int t = lane; t < n_tasks; t += 32) {
          if (t < 5) {
            float* field = t == 0 ? a.cpu_fit : t == 1 ? a.mem_fit : t == 2 ? a.cpu_used
                         : t == 3 ? a.mem_used : a.pods_used;
            const float add = t == 4 ? 1.0f : (t & 1) ? mem : cpu;
            field[c] = __fadd_rn(field[c], add);
          } else if (t < 5 + a.PW) {
            const int w = t - 5;
            a.uport[(size_t)c * a.PW + w] |= port[w];
          } else if (t < 5 + a.PW + 2 * a.VW) {
            const int w = (t - 5 - a.PW) % a.VW;
            const bool rw = t - 5 - a.PW >= a.VW;
            int* words = rw ? a.uvol_rw : a.uvol_any;
            words[(size_t)c * a.VW + w] |= (rw ? vol_rw : vol_any)[w];
          } else {
            // Once per occurrence of an id (a repeated id adds twice, so
            // the add is atomic); ids outside [0, S) commit nothing
            // (JAX's scatter mode="drop"). Counts only grow, so the
            // service's max is the max of the new counts.
            const int sid = a.pod_svc_ids[(size_t)p * a.K + (t - 5 - a.PW - 2 * a.VW)];
            if (sid >= 0 && sid < S) {
              const int cnt = atomicAdd(a.counts + (size_t)sid * N + c, 1) + 1;
              atomicMax(a.maxc + sid, cnt);
            }
          }
        }
      }
    }
    __syncthreads();
    cur = next;
  }
}

}  // namespace

extern "C" int ktt_scan_launch(
    const void* pod_cpu, const void* pod_mem, const void* pod_zero,
    const void* pod_pinned, const void* pod_svc, const void* pod_sel,
    const void* pod_port, const void* pod_vol_any, const void* pod_vol_rw,
    const void* pod_svc_ids,
    const void* cpu_cap, const void* mem_cap, const void* pods_cap,
    const void* over, const void* sched, const void* labels,
    void* cpu_fit, void* mem_fit, void* cpu_used, void* mem_used,
    void* pods_used, void* uport, void* uvol_any, void* uvol_rw,
    void* counts, void* maxc, void* choice,
    int P, int N, int S, int SW, int PW, int VW, int K,
    int w_lr, int w_bra, int w_spread, void* stream) {
  ScanArgs a;
  a.pod_cpu = static_cast<const float*>(pod_cpu);
  a.pod_mem = static_cast<const float*>(pod_mem);
  a.pod_zero = static_cast<const unsigned char*>(pod_zero);
  a.pod_pinned = static_cast<const int*>(pod_pinned);
  a.pod_svc = static_cast<const int*>(pod_svc);
  a.pod_sel = static_cast<const int*>(pod_sel);
  a.pod_port = static_cast<const int*>(pod_port);
  a.pod_vol_any = static_cast<const int*>(pod_vol_any);
  a.pod_vol_rw = static_cast<const int*>(pod_vol_rw);
  a.pod_svc_ids = static_cast<const int*>(pod_svc_ids);
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
  a.maxc = static_cast<int*>(maxc);
  a.choice = static_cast<int*>(choice);
  a.P = P;
  a.N = N;
  a.S = S;
  a.SW = SW;
  a.PW = PW;
  a.VW = VW;
  a.K = K;
  a.w_lr = w_lr;
  a.w_bra = w_bra;
  a.w_spread = w_spread;
  scan_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ktt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
