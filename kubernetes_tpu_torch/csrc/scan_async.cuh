// The scan kernel's inline PTX and dynamic shared memory, kept apart so
// that a CPU emulation of the kernel can supply its own versions.
#pragma once

#include <cuda_runtime.h>

// The block's dynamic shared memory (16-byte aligned).
__device__ __forceinline__ unsigned char* dyn_smem() {
  extern __shared__ __align__(16) unsigned char ktt_dyn_smem[];
  return ktt_dyn_smem;
}

// 16 bytes from device memory to shared memory, asynchronously. `.cg`
// caches in L2 only: the copy never reads a line this SM's L1 holds
// from before a later atomic to the same address.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

// Wait until every cp.async this thread issued has landed. Other
// threads see the data after a barrier that follows the wait.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
