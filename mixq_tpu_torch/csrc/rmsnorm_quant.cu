// Fused RMSNorm + inlier mask + per-row absmax int8 quantization, with the
// fp outlier-channel gather folded in (kernel 1).
//
// Replaces: mixq_tpu/ops/pallas/rmsnorm_quant.py::fused_rmsnorm_quant (the
// Pallas kernel), following the JAX main path's arithmetic
// (mixq_tpu/models/layers.py::rmsnorm_quant = rmsnorm + prepare_act): y is
// rounded to bf16 BEFORE it is masked and quantized, as the main path does;
// the Pallas kernel quantizes the f32 y instead. The gather of the outlier
// channels (ops/quant.py::extract_outliers, an XLA gather on the TPU) is
// done here too, from the same y.
//
// Arithmetic (the plain version's, kernels/rmsnorm_quant.py): y =
// bf16(x * (1 / sqrtf(mean(x^2) + eps)) * gamma); scale = max(absmax(y_in) /
// qmax, 1e-8) with y_in = y * k_mask; q = clamp(rint(y_in / scale), +-qmax);
// x_out = bf16(y[ind] * bf16(mask)). Both divisions are IEEE divisions (no
// --use_fast_math), as JAX's: a multiply by 1 / scale would round apart.
// Only the order of the sum of squares is the kernel's own.
//
// Bound on the card: bytes. Per row it reads H bf16 values and writes H bf16
// + H int8 values (~5 bytes a channel), a few operations a byte; at decode a
// row is 8 KB (H=4096) and 64 rows move 0.5 MB: 0.16 us at 3.35 TB/s, far
// below one launch (a one-element fill takes ~1 us). What holds a row back
// is the chain of dependent steps inside its block, so the design keeps
// that chain short: one round trip from device memory and two barriers.
// - A block of THREADS threads takes one row. Each thread owns whole chunks
//   of 8 channels (one 16-byte load of x, two 16-byte loads each of gamma
//   and k_mask) and issues every load of the row before it uses any; the
//   chunk count a thread holds is a template argument, so the row stays in
//   registers (threads past the row's last chunk hold zeros).
// - Two block reductions (sum of squares, then absmax), warp shuffles and
//   one shared word a warp, a barrier each.
// - y leaves in 16-byte stores and q_x in 8-byte stores, from registers.
// - The outlier gather reads a bf16 copy of y in shared memory (H * 2
//   bytes), written before the absmax barrier, which orders it; the
//   gather's indices are loaded with the row.
// - The IEEE divisions of the quantizer are the costliest instructions of
//   the row; a zero dividend (each masked outlier channel) would take the
//   division's slow path, so zeros skip it.
// The block has 512 threads with one chunk each, for every M: at decode
// each row has an SM of its own, and more warps hide its latency. (A second
// instantiation of 256 threads with two chunks each saved ~1 us a launch
// at M=512, a share of a prefill the end-to-end times cannot resolve.) The
// plan is kernels/rmsnorm_quant.py::plan_rmsnorm. No cluster split: one SM
// fetches an 8 KB row in one round trip, and a DSMEM exchange would add to
// the chain.
//
// Any other H (not a multiple of 8, past 4096, or an operand not 16-byte
// aligned) runs rmsnorm_quant_loop: one row a block of 256 threads, x read
// once into a bf16 row in shared memory, then passes over shared memory.
// Its shared memory (H * 2 bytes) may pass 48 KB; the limit is raised once
// per device (mixq::allow_smem).
//
// Launch: grid (M), block THREADS. The launcher returns a CUDA error code
// (cudaErrorInvalidValue for a plan its operands do not fit); it allocates
// nothing and does not synchronize.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kLoopThreads = 256;               // the looping kernel's block
constexpr int kChunk = 8;                       // channels a 16-byte chunk
// sm_90's opt-in shared memory a block (232,448 bytes), less room for the
// reduction words
constexpr int kMaxSmem = 232448 - 1024;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reduction through red[THREADS / 32]; every thread gets the
// result, summed over the warps in warp order. One barrier: a later
// reduction uses another red.
template <bool kMax, int THREADS>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) t = kMax ? fmaxf(t, red[w]) : t + red[w];
  return t;
}

__device__ __forceinline__ float bf(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}

// bf16 pairs in a 32-bit word (low half first), exactly widened; and two
// floats rounded to nearest even into one
__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a))
         | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[kChunk]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = lo_f(w[k]);
    f[2 * k + 1] = hi_f(w[k]);
  }
}

__device__ __forceinline__ void load8(const float* p, float (&f)[kChunk]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// q = clamp(rint(y_in / scale), -qmax, qmax), an IEEE division. A zero
// dividend (every masked outlier channel) would send the division down its
// slow path, which costs a warp more than all its other divisions: it gets
// a stand-in dividend and q = 0, which is 0 / scale.
__device__ __forceinline__ int quant(float yin, float scale, float qmax) {
  const bool zero = yin == 0.f;
  const float q = rintf((zero ? scale : yin) / scale);
  return zero ? 0 : (int)fminf(fmaxf(q, -qmax), qmax);
}

// The outlier slice of one row from its bf16 copy in shared memory: the bf16
// product of y and the bf16-rounded slot mask, as JAX's gather-then-mask.
// Slot `tid` comes preloaded (ind0, mask0).
template <int THREADS>
__device__ __forceinline__ void gather(const __nv_bfloat16* ys,
                                       const int32_t* __restrict__ out_ind,
                                       const float* __restrict__ out_mask,
                                       __nv_bfloat16* __restrict__ xo_row,
                                       int Bo, int ind0, float mask0) {
  int i = ind0;
  float m = mask0;
  for (int b = threadIdx.x; b < Bo; b += THREADS) {
    if (b != (int)threadIdx.x) {
      i = out_ind[b];
      m = out_mask[b];
    }
    xo_row[b] = __float2bfloat16_rn(bf(ys[i]) * bf(__float2bfloat16_rn(m)));
  }
}

// The row in registers: a block of THREADS threads a row, CPT chunks of 8
// channels a thread (chunk threadIdx.x + c * THREADS). Needs H % 8 == 0,
// H <= CPT * THREADS * 8 and 16-byte aligned x, y, gamma, k_mask.
template <int THREADS, int CPT>
__global__ void __launch_bounds__(THREADS)
rmsnorm_quant_regs(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ gamma,
                   const float* __restrict__ kmask,     // [H] or null
                   const int32_t* __restrict__ out_ind, // [Bo] or null
                   const float* __restrict__ out_mask,  // [Bo] or null
                   __nv_bfloat16* __restrict__ y,
                   int8_t* __restrict__ qx,
                   float* __restrict__ xs,
                   __nv_bfloat16* __restrict__ xo,      // [M, Bo] or null
                   int H, int Bo, float eps, float qmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* stash = reinterpret_cast<__nv_bfloat16*>(smem);  // [H]
  __shared__ float red_ss[THREADS / 32], red_max[THREADS / 32];
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const int nchunk = H / kChunk;

  // every load of the row first: x, gamma, k_mask, the gather's slot
  uint4 xv[CPT];
  float g[CPT][kChunk], km[CPT][kChunk];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int ch = tid + c * THREADS;
    xv[c] = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int k = 0; k < kChunk; ++k) g[c][k] = km[c][k] = 0.f;
    if (ch < nchunk) {
      xv[c] = __ldg(reinterpret_cast<const uint4*>(x + row * H) + ch);
      load8(gamma + ch * kChunk, g[c]);
      if (kmask) load8(kmask + ch * kChunk, km[c]);
    }
  }
  int ind0 = 0;
  float mask0 = 0.f;
  if (xo && tid < Bo) {
    ind0 = out_ind[tid];
    mask0 = out_mask[tid];
  }

  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    float f[kChunk];
    unpack8(xv[c], f);
#pragma unroll
    for (int k = 0; k < kChunk; ++k) ss += f[k] * f[k];
  }
  ss = block_reduce<false, THREADS>(ss, red_ss);

  // y = bf16(x * inv * gamma), kept as bf16 in xv; out to y and the stash
  const float inv = 1.0f / sqrtf(ss / (float)H + eps);
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int ch = tid + c * THREADS;
    float f[kChunk];
    unpack8(xv[c], f);
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = pack2(f[2 * k] * inv * g[c][2 * k],
                   f[2 * k + 1] * inv * g[c][2 * k + 1]);
      const float a = kmask ? lo_f(w[k]) * km[c][2 * k] : lo_f(w[k]);
      const float b = kmask ? hi_f(w[k]) * km[c][2 * k + 1] : hi_f(w[k]);
      amax = fmaxf(amax, fmaxf(fabsf(a), fabsf(b)));
    }
    xv[c] = make_uint4(w[0], w[1], w[2], w[3]);
    if (ch < nchunk) {
      reinterpret_cast<uint4*>(y + row * H)[ch] = xv[c];
      if (xo) reinterpret_cast<uint4*>(stash)[ch] = xv[c];
    }
  }
  amax = block_reduce<true, THREADS>(amax, red_max);  // also orders the stash

  const float scale = fmaxf(amax / qmax, 1e-8f);
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int ch = tid + c * THREADS;
    if (ch >= nchunk) break;
    float f[kChunk];
    unpack8(xv[c], f);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float yin = kmask ? f[k] * km[c][k] : f[k];
      w[k >> 2] |= (uint32_t)(quant(yin, scale, qmax) & 0xff)
                   << (8 * (k & 3));
    }
    reinterpret_cast<uint2*>(qx + row * H)[ch] = make_uint2(w[0], w[1]);
  }
  if (tid == 0) xs[row] = scale;
  if (xo) gather<THREADS>(stash, out_ind, out_mask, xo + row * Bo, Bo, ind0,
                          mask0);
}

// Any H, any alignment: one row a block, x read once into a bf16 row in
// shared memory (then overwritten by y), passes over shared memory.
__global__ void __launch_bounds__(kLoopThreads)
rmsnorm_quant_loop(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ gamma,
                   const float* __restrict__ kmask,
                   const int32_t* __restrict__ out_ind,
                   const float* __restrict__ out_mask,
                   __nv_bfloat16* __restrict__ y,
                   int8_t* __restrict__ qx,
                   float* __restrict__ xs,
                   __nv_bfloat16* __restrict__ xo,
                   int H, int Bo, float eps, float qmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* row_s = reinterpret_cast<__nv_bfloat16*>(smem);   // [H]
  __shared__ float red_ss[kLoopThreads / 32], red_max[kLoopThreads / 32];
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * H;
  int ind0 = 0;
  float mask0 = 0.f;
  if (xo && tid < Bo) {
    ind0 = out_ind[tid];
    mask0 = out_mask[tid];
  }

  float ss = 0.f;
  for (int i = tid; i < H; i += kLoopThreads) {   // each thread its own i's
    const __nv_bfloat16 v = xr[i];
    row_s[i] = v;
    ss += bf(v) * bf(v);
  }
  ss = block_reduce<false, kLoopThreads>(ss, red_ss);
  const float inv = 1.0f / sqrtf(ss / (float)H + eps);

  float amax = 0.f;
  __nv_bfloat16* yr = y + row * H;
  for (int i = tid; i < H; i += kLoopThreads) {
    const __nv_bfloat16 yb =
        __float2bfloat16_rn(bf(row_s[i]) * inv * gamma[i]);
    yr[i] = yb;
    row_s[i] = yb;
    const float yin = kmask ? bf(yb) * kmask[i] : bf(yb);
    amax = fmaxf(amax, fabsf(yin));
  }
  amax = block_reduce<true, kLoopThreads>(amax, red_max);  // orders row_s
  const float scale = fmaxf(amax / qmax, 1e-8f);

  int8_t* qr = qx + row * H;
  for (int i = tid; i < H; i += kLoopThreads) {
    const float yin = kmask ? bf(row_s[i]) * kmask[i] : bf(row_s[i]);
    qr[i] = (int8_t)quant(yin, scale, qmax);
  }
  if (tid == 0) xs[row] = scale;
  if (xo)
    gather<kLoopThreads>(row_s, out_ind, out_mask, xo + row * Bo, Bo, ind0,
                         mask0);
}

bool aligned(const void* p, uintptr_t a) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) % a) == 0;
}

template <int THREADS, int CPT>
cudaError_t launch_regs(const void* x, const void* gamma, const void* kmask,
                        const void* out_ind, const void* out_mask, void* y,
                        void* qx, void* xs, void* xo, int M, int H, int Bo,
                        float eps, float qmax, cudaStream_t stream) {
  if (H % kChunk || H > CPT * THREADS * kChunk || !aligned(x, 16)
      || !aligned(y, 16) || !aligned(gamma, 16) || !aligned(kmask, 16)
      || !aligned(qx, 8))
    return cudaErrorInvalidValue;
  const int smem = xo ? H * (int)sizeof(__nv_bfloat16) : 0;   // <= 8 KB
  rmsnorm_quant_regs<THREADS, CPT><<<M, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)x, (const float*)gamma, (const float*)kmask,
      (const int32_t*)out_ind, (const float*)out_mask, (__nv_bfloat16*)y,
      (int8_t*)qx, (float*)xs, (__nv_bfloat16*)xo, H, Bo, eps, qmax);
  return cudaGetLastError();
}

cudaError_t launch_loop(const void* x, const void* gamma, const void* kmask,
                        const void* out_ind, const void* out_mask, void* y,
                        void* qx, void* xs, void* xo, int M, int H, int Bo,
                        float eps, float qmax, cudaStream_t stream) {
  const int smem = H * (int)sizeof(__nv_bfloat16);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    static unsigned long long smem_set = 0;   // per device
    cudaError_t e = mixq::allow_smem(rmsnorm_quant_loop, kMaxSmem, smem_set);
    if (e != cudaSuccess) return e;
  }
  rmsnorm_quant_loop<<<M, kLoopThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const float*)gamma, (const float*)kmask,
      (const int32_t*)out_ind, (const float*)out_mask, (__nv_bfloat16*)y,
      (int8_t*)qx, (float*)xs, (__nv_bfloat16*)xo, H, Bo, eps, qmax);
  return cudaGetLastError();
}

}  // namespace

// threads: the block (512 or 256); chunks: chunks of 8 channels a thread
// holds in registers (1 at 512 threads), or 0 for the looping kernel (256
// threads). The plan is kernels/rmsnorm_quant.py::plan_rmsnorm.
extern "C" int rmsnorm_quant_launch(const void* x, const void* gamma,
                                    const void* kmask, const void* out_ind,
                                    const void* out_mask, void* y, void* qx,
                                    void* xs, void* xo, int M, int H, int Bo,
                                    float eps, float qmax, int threads,
                                    int chunks, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define MIXQ_ARGS x, gamma, kmask, out_ind, out_mask, y, qx, xs, xo, M, H, \
                  Bo, eps, qmax, s
  cudaError_t e = cudaErrorInvalidValue;
  if (threads == 512 && chunks == 1) e = launch_regs<512, 1>(MIXQ_ARGS);
  else if (threads == 256 && chunks == 0) e = launch_loop(MIXQ_ARGS);
#undef MIXQ_ARGS
  return (int)e;
}
