// The activation epilogue shared by the GEMM kernels (csrc/mix_gemm.cu,
// csrc/w8a16.cu), applied to the f32 result y before the output cast:
//   kNone, kSilu      y * sigmoid(y)
//   kGelu             0.5 * y * erfc(-y * sqrt(1/2))              (exact)
//   kGeluNew          y * 0.5 * (1 + tanh(sqrt(2/pi) * (y + 0.044715 y^3)))
// in jax.nn.gelu's order of operations and with its f32 constants, each
// step rounded on its own (__fmul_rn / __fadd_rn: nvcc contracts none of
// them into an FMA). The codes are the wrapper's `_build.FUSES` indices.
// tanhf, erfcf and expf are CUDA's accurate versions (no --use_fast_math).
#pragma once
#include <cuda_runtime.h>

namespace mixq {

enum Epilogue : int { kNone = 0, kSilu = 1, kGelu = 2, kGeluNew = 3 };

__device__ __forceinline__ float apply_epilogue(float y, int fuse) {
  switch (fuse) {
    case kSilu:
      return __fmul_rn(y, 1.0f / (1.0f + expf(-y)));
    case kGelu: {
      constexpr float kSqrtHalf = 0x1.6a09e6p-1f;          // f32(sqrt(0.5))
      return __fmul_rn(__fmul_rn(0.5f, y), erfcf(__fmul_rn(-y, kSqrtHalf)));
    }
    case kGeluNew: {
      constexpr float kSqrt2OverPi = 0x1.988454p-1f;       // f32(sqrt(2/pi))
      const float y3 = __fmul_rn(__fmul_rn(y, y), y);
      const float u = __fmul_rn(kSqrt2OverPi,
                                __fadd_rn(y, __fmul_rn(0.044715f, y3)));
      return __fmul_rn(y, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(u))));
    }
    default:
      return y;
  }
}

}  // namespace mixq
