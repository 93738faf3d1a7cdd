// Persistent kernels whose warps (or blocks) loop over work items, with the
// next item's inputs copied into a second shared-memory stage by cp.async
// (sm_80+) while the current one is computed: the device helpers for the
// copies, and the host helper that sizes the persistent grid.
#pragma once
#include <cuda_runtime.h>

#include <algorithm>

namespace mx {

constexpr size_t kSmemMax = 227 * 1024;  // dynamic shared memory of one block

// 4 bytes, cached in L1 (.ca): for gathers whose neighbours share sectors
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// 8 bytes, cached in L1 (.ca); both addresses 8-byte aligned
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}

// 16 bytes, L2 only (.cg); both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `Pending` committed groups of this thread are in flight
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// Lets `kernel` launch with `smem` bytes of dynamic shared memory (above
// 48 KB a kernel must opt in).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// One resident wave of `threads`-thread blocks with `smem` bytes of dynamic
// shared memory each (fewer if the `items` need fewer), for a kernel whose
// blocks loop over the items.
template <typename K>
cudaError_t persistent_grid(K kernel, int threads, size_t smem, long long items,
                            int* blocks) {
  cudaError_t err = allow_smem(kernel, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  *blocks = static_cast<int>(
      std::min<long long>(items, (long long)sms * std::max(per_sm, 1)));
  return err;
}

}  // namespace mx
