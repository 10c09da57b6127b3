// cp.async helpers shared by the GEMM and attention kernels (sm_80+; built
// for sm_90a).
#pragma once
#include <cuda_runtime.h>

namespace mixq {

// 16-byte chunks of a row of `row_bytes`, rounded up to a power of two: the
// attention kernels' layout of a cache row (kernel 3's lanes a row takes,
// kernel 8's ring row), so the copies and slices stay shifts at D = 96
__host__ __device__ inline int pow2_chunks(int row_bytes) {
  int n = 1;
  while (n < row_bytes / 16) n <<= 1;
  return n;
}

// 16-byte global -> shared copy; `valid == false` copies 0 source bytes,
// which zero-fills the 16 destination bytes (masked edges).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
// 4-byte global -> shared copy (both 4-byte aligned)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
// 4-byte global -> shared copy; `valid == false` zero-fills the 4 bytes
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
// 8-byte global -> shared copy; `valid == false` zero-fills the 8 bytes
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace mixq
