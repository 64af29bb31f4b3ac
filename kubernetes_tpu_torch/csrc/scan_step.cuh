// What one node's step of the default-spec scan computes, shared by the
// scan kernel (scan_kernel.cu) and the shard-step kernel
// (shard_scan_kernel.cu), so the two decide with the same arithmetic:
// the packed pod row's layout, int32 arithmetic that wraps as JAX's
// does, JAX's floor division, the resources predicate, the three
// default priorities and their weighted sum, the 64-bit selection key
// and the warp reductions over it. Every float operation is spelled
// with an _rn intrinsic; build with -fmad=false.
#pragma once

#include <cuda_runtime.h>
#include <climits>

namespace ktt_step {

// A pod's row in the packed (P, row_words) int32 matrix the wrapper
// builds: scalars, then the sel, port, vol_any, vol_rw words and the
// service ids, zero-padded to a multiple of 4 words.
constexpr int kRowCpu = 0;   // f32 bits
constexpr int kRowMem = 1;   // f32 bits
constexpr int kRowZero = 2;  // 0 or 1
constexpr int kRowPin = 3;
constexpr int kRowSvc = 4;
constexpr int kRowBits = 5;

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

// PodFitsResources (predicates.go:139-156) at one node: the resources
// and the pod count, or the pod count alone for a zero-request pod.
__device__ __forceinline__ bool resources_fit(float cap_c, float cap_m, float cap_p, float used_p,
                                              float cpu_fit, float mem_fit, bool over, float cpu,
                                              float mem, bool zero) {
  const bool fits_cpu = cap_c == 0.0f || __fadd_rn(cpu_fit, cpu) <= cap_c;
  const bool fits_mem = cap_m == 0.0f || __fadd_rn(mem_fit, mem) <= cap_m;
  const bool fits_count = __fadd_rn(used_p, 1.0f) <= cap_p;
  const bool nonzero_ok = !over & fits_cpu & fits_mem & fits_count;
  const bool zero_ok = used_p < cap_p;
  return zero ? zero_ok : nonzero_ok;
}

// The weighted default priorities at one node (solver._component_scores):
// integer LeastRequested, f32 BalancedResourceAllocation with the +1e-5
// epsilon, integer ServiceSpreading against the max count m of the pod's
// service. `count()` gives the node's count of that service; it is read
// only when the spreading score needs it.
template <class CountFn>
__device__ __forceinline__ int default_total(float cap_c, float cap_m, float cpu_used,
                                             float mem_used, float cpu, float mem, int svc, int m,
                                             CountFn count, int w_lr, int w_bra, int w_spread) {
  const int icap_c = __float2int_rz(cap_c);
  const int icap_m = __float2int_rz(cap_m);
  const int req_c = __float2int_rz(__fadd_rn(cpu_used, cpu));
  const int req_m = __float2int_rz(__fadd_rn(mem_used, mem));
  const int lr = floor_div(wadd(least_requested(req_c, icap_c), least_requested(req_m, icap_m)), 2);
  const float cf = fraction(req_c, icap_c);
  const float mf = fraction(req_m, icap_m);
  int bra = 0;
  if (!(cf >= 1.0f || mf >= 1.0f)) {
    const float d = __fmul_rn(fabsf(__fsub_rn(cf, mf)), 10.0f);
    bra = __float2int_rz(__fadd_rn(__fsub_rn(10.0f, d), 1e-5f));
  }
  int spread = 10;
  if (svc >= 0 && m != 0) spread = floor_div(wmul(10, wsub(m, count())), m > 1 ? m : 1);
  return wadd(wadd(wmul(lr, w_lr), wmul(bra, w_bra)), wmul(spread, w_spread));
}

// The node a selection key names.
__device__ __forceinline__ int key_node(long long key) {
  return (int)(0xffffffffu - (unsigned)(key & 0xffffffffLL));
}

}  // namespace ktt_step
