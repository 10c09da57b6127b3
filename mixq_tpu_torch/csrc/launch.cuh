// Host-side launch helpers shared by the cluster GEMMs (csrc/mix_gemm.cu,
// csrc/w8a16.cu).
#pragma once
#include <cuda_runtime.h>

namespace mixq {

// Lets `kernel` launch with `smem` bytes of dynamic shared memory on the
// current device. The limit is an attribute of the function on each device,
// so it is set once per device; `done` holds one bit per device (a device
// past 63 sets it on every call).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel* kernel, int smem,
                              unsigned long long& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess) done |= bit;
  return e;
}

}  // namespace mixq
