// Weight-only (a16) GEMM: bf16 activations times int8 or packed-int4 weights
// dequantized in shared memory, with the fused MixQ epilogue:
//   wd[k,n] = bf16( bf16(w[k,n]) * bf16(w_scale[g(k), n]) )
//   y = float(x) @ float(wd)  (f32 accumulation)
//       + sum_b x_out[m,b] * w_out[b,n]  (fp outlier channels, optional)
//   then the activation epilogue (none, SiLU, exact GELU or tanh GELU
//   "gelu_new"; csrc/epilogue.cuh), then the cast to bf16 or f32.
// w is int8 [K, N] or packed uint8 [K/2, N] in the halves layout of
// ops/quant.py::pack_int4 (packed row p: K-row p in the low nibble, K-row
// K/2 + p in the high one); w_scale is [N] (g = 0) or [G, N] (g = k / (K/G)).
// The scale is rounded to bf16 before the multiply and the product is
// rounded to bf16 again, as the TPU kernel computes `wd`: applying the scale
// in f32 gives another function, not a more precise one.
//
// Replaces: mixq_tpu/ops/pallas/mix_gemm.py::mix_gemm with a bf16
// activation (the a16 branch of `_kernel`/`_kernel_outlier`, with
// `_unpack_w4` and `_expand_group_scale`) and
// mixq_tpu/ops/pallas/w8a16.py::w8a16_matmul (int8, per-channel, no
// epilogue): EETQ's w8_a16_gemm.
//
// Bound on the card: at decode the weight read, K*N bytes (W8) or K*N/2
// (W4), plus the bf16 activations M*K*2: Llama-2-7B's 4096 x 11008 at M = 64
// is 45.6 MB, 13.6 us at 3.35 TB/s, against 2*M*K*N = 5.8 GFLOP, 5.8 us at
// the bf16 tensor-core peak.
//
// Design: the tiling of csrc/mix_gemm.cu with bf16 tensor cores. Each block
// owns a 64 x 32 output tile and walks the whole K; a 4-stage cp.async ring
// holds the bf16 A tile (64 x 64) and the raw weight tile (W8: 64 K-rows,
// 2 KB; W4: 32 packed rows, 1 KB, whose A tile's sub-tiles 0-1 are
// x[:, p0:p0+32] and 2-3 are x[:, K/2+p0 : K/2+p0+32]). Each stage, the
// 128 threads dequantize the raw tile into one bf16 tile (thread = one
// column of one 16-row sub-tile, so one group, and one scale load, per
// thread); the weight leaves device memory once, as int8 or int4. Four
// warps each own 16 rows x 32 columns and run bf16 WMMA (16x16x16, f32
// accumulation). The outlier term runs as a second bf16 WMMA on x_out/w_out
// tiles loaded at the start. The epilogue adds with __fadd_rn, so nvcc does
// not contract it into an FMA.
//
// Requirements (checked by the Python wrapper): K % 16 == 0 (W4: K % 32),
// N % 16 == 0, B % 16 == 0, 16-byte aligned operands, grouped:
// (K/G) % 16 == 0. M, N edges and a K tail inside the last stage are
// masked by zero-filled loads and guarded stores.
// The launcher returns cudaGetLastError(); it allocates nothing and does not
// synchronize.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "epilogue.cuh"

using namespace nvcuda;
using mixq::cp_async16;
using mixq::cp_async_commit;
using mixq::cp_async_wait;

namespace {

constexpr int BM = 64, BN = 32, KSTEP = 64, STAGES = 4, THREADS = 128;
constexpr int A_STAGE = BM * KSTEP;       // bf16 elements
constexpr int W_STAGE = KSTEP * BN;       // bytes of an int8 tile
constexpr int LDC = BN + 4;               // epilogue tile row pitch (floats)

// One stage: the A tile of x -> smem [4][BM][16] bf16 (sub-tile kc holds 16
// K-columns); the stored weight rows [s, s + SROWS) -> smem row-major
// [SROWS][BN] bytes (W8: 64 K-rows from s = k0; W4: 32 packed rows, s = p0).
template <bool W4>
__device__ __forceinline__ void load_stage(__nv_bfloat16* As, uint8_t* Ws,
                                           const __nv_bfloat16* __restrict__ x,
                                           const uint8_t* __restrict__ w,
                                           int M, int N, int K, int m0,
                                           int n0, int s) {
  const int half = K / 2;
  for (int c = threadIdx.x; c < BM * (KSTEP / 8); c += THREADS) {
    const int r = c % BM, k8 = c / BM;      // k8: 8-column chunk, 0..7
    const int kc = k8 / 2, sub = (k8 % 2) * 8;
    const int gm = m0 + r;
    int gk;
    bool ok;
    if (W4) {                   // sub-tiles 0-1: low rows, 2-3: high rows
      const int pk = s + (kc & 1) * 16 + sub;
      ok = pk < half;
      gk = (kc < 2 ? 0 : half) + pk;
    } else {
      gk = s + kc * 16 + sub;
      ok = gk < K;
    }
    ok = ok && gm < M;
    cp_async16(As + (kc * BM + r) * 16 + sub,
               ok ? x + (size_t)gm * K + gk : x, ok);
  }
  constexpr int SROWS = W4 ? KSTEP / 2 : KSTEP;
  const int rows = W4 ? half : K;
  for (int c = threadIdx.x; c < SROWS * (BN / 16); c += THREADS) {
    const int kr = c / (BN / 16), nc = c % (BN / 16);
    const int gk = s + kr, gn = n0 + nc * 16;
    const bool ok = gk < rows && gn < N;
    cp_async16(Ws + kr * BN + nc * 16, ok ? w + (size_t)gk * N + gn : w, ok);
  }
}

// Raw tile -> bf16 tile Bd [4][BN/16][16][16] (64 K-rows x 32 columns).
// Thread t dequantizes column c = t % 32 of the 16-row sub-tile rb = t / 32:
// rows of one sub-tile share one group, so one scale per thread.
template <bool W4, bool GROUPED>
__device__ __forceinline__ void dequant(const uint8_t* Ws,
                                        __nv_bfloat16* Bd,
                                        const float* __restrict__ ws,
                                        int N, int K, int n0, int s, int gs) {
  const int rb = threadIdx.x / 32, c = threadIdx.x % 32;
  const int gn = n0 + c;
  int k0, rows;                         // first K-row of the sub-tile
  if (W4) {
    k0 = (rb < 2 ? 0 : K / 2) + s + (rb & 1) * 16;
    rows = (rb < 2 ? 0 : K / 2) + K / 2;   // the half's end
  } else {
    k0 = s + rb * 16;
    rows = K;
  }
  float sc = 0.f;
  if (gn < N && k0 < rows) {
    const int g = GROUPED ? k0 / gs : 0;
    sc = __bfloat162float(__float2bfloat16_rn(ws[(size_t)g * N + gn]));
  }
  __nv_bfloat16* dst = Bd + (rb * (BN / 16) + c / 16) * 256 + (c % 16);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    int v;
    if (W4) {
      const unsigned b = Ws[((rb & 1) * 16 + i) * BN + c];
      v = rb < 2 ? (int)(b << 28) >> 28 : (int)(b << 24) >> 28;  // sign-ext.
    } else {
      v = (int)reinterpret_cast<const int8_t*>(Ws)[(rb * 16 + i) * BN + c];
    }
    dst[i * 16] = __float2bfloat16_rn(__fmul_rn((float)v, sc));
  }
}

template <bool W4, bool GROUPED>
__global__ void __launch_bounds__(THREADS)
w8a16_kernel(const __nv_bfloat16* __restrict__ x,  // [M, K]
             const uint8_t* __restrict__ w,        // [K, N] | packed [K/2, N]
             const float* __restrict__ ws,         // [N] | [G, N]
             const __nv_bfloat16* __restrict__ xo, // [M, Bo] / null
             const __nv_bfloat16* __restrict__ wo, // [Bo, N] / null
             void* __restrict__ out,               // [M, N]
             int M, int N, int K, int Bo, int gs, int fuse, int out_f32) {
  constexpr int WS = W4 ? W_STAGE / 2 : W_STAGE;  // stored tile bytes
  constexpr int SROWS = W4 ? KSTEP / 2 : KSTEP;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* Wr = reinterpret_cast<uint8_t*>(As + STAGES * A_STAGE);
  __nv_bfloat16* Bd = reinterpret_cast<__nv_bfloat16*>(Wr + STAGES * WS);
  float* Cs = reinterpret_cast<float*>(Bd + KSTEP * BN);
  float* Fs = Cs + BM * LDC;
  __nv_bfloat16* XOs = reinterpret_cast<__nv_bfloat16*>(Fs + BM * LDC);
  __nv_bfloat16* WOs = XOs + BM * Bo;

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5;
  const bool has_out = xo != nullptr;
  const int rows = W4 ? K / 2 : K;

  if (has_out) {  // outlier tiles: their own cp.async group, oldest of all
    for (int c = threadIdx.x; c < BM * (Bo / 8); c += THREADS) {
      const int r = c / (Bo / 8), bc = c % (Bo / 8);
      const bool ok = m0 + r < M;
      cp_async16(XOs + r * Bo + bc * 8,
                 ok ? xo + (size_t)(m0 + r) * Bo + bc * 8 : xo, ok);
    }
    for (int c = threadIdx.x; c < Bo * (BN / 8); c += THREADS) {
      const int b = c / (BN / 8), nc = c % (BN / 8);
      const bool ok = n0 + nc * 8 < N;
      cp_async16(WOs + b * BN + nc * 8,
                 ok ? wo + (size_t)b * N + n0 + nc * 8 : wo, ok);
    }
    cp_async_commit();
  }

  const int KT = (rows + SROWS - 1) / SROWS;
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT)
      load_stage<W4>(As + s * A_STAGE, Wr + s * WS, x, w, M, N, K, m0, n0,
                     s * SROWS);
    cp_async_commit();
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < KT) {
      const int slot = nk % STAGES;
      load_stage<W4>(As + slot * A_STAGE, Wr + slot * WS, x, w, M, N, K, m0,
                     n0, nk * SROWS);
    }
    cp_async_commit();
    dequant<W4, GROUPED>(Wr + (kt % STAGES) * WS, Bd, ws, N, K, n0,
                         kt * SROWS, gs);
    __syncthreads();

    const __nv_bfloat16* A = As + (kt % STAGES) * A_STAGE;
#pragma unroll
    for (int kk = 0; kk < KSTEP / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + (kk * BM + warp * 16) * 16, 16);
#pragma unroll
      for (int nc = 0; nc < 2; ++nc) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Bd + (kk * (BN / 16) + nc) * 256, 16);
        wmma::mma_sync(acc[nc], a, b, acc[nc]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int nc = 0; nc < 2; ++nc)
    wmma::store_matrix_sync(Cs + warp * 16 * LDC + nc * 16, acc[nc], LDC,
                            wmma::mem_row_major);
  if (has_out) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> facc[2];
    wmma::fill_fragment(facc[0], 0.f);
    wmma::fill_fragment(facc[1], 0.f);
    for (int kb = 0; kb < Bo / 16; ++kb) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, XOs + warp * 16 * Bo + kb * 16, Bo);
      for (int nc = 0; nc < 2; ++nc) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, WOs + kb * 16 * BN + nc * 16, BN);
        wmma::mma_sync(facc[nc], a, b, facc[nc]);
      }
    }
    for (int nc = 0; nc < 2; ++nc)
      wmma::store_matrix_sync(Fs + warp * 16 * LDC + nc * 16, facc[nc], LDC,
                              wmma::mem_row_major);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    float y = Cs[r * LDC + c];
    if (has_out) y = __fadd_rn(y, Fs[r * LDC + c]);
    y = mixq::apply_epilogue(y, fuse);
    if (out_f32)
      reinterpret_cast<float*>(out)[(size_t)gm * N + gn] = y;
    else
      reinterpret_cast<__nv_bfloat16*>(out)[(size_t)gm * N + gn] =
          __float2bfloat16_rn(y);
  }
}

template <bool W4, bool GROUPED>
int launch(const void* x, const void* w, const void* ws, const void* xo,
           const void* wo, void* out, int M, int N, int K, int Bo, int gs,
           int fuse, int out_f32, cudaStream_t stream) {
  static int smem_limit = 48 * 1024;   // per instantiation
  const int smem = STAGES * (A_STAGE * 2 + (W4 ? W_STAGE / 2 : W_STAGE)) +
                   KSTEP * BN * 2 + 2 * BM * LDC * 4 +
                   (BM * Bo + Bo * BN) * 2;
  if (smem > smem_limit) {
    cudaError_t e = cudaFuncSetAttribute(
        w8a16_kernel<W4, GROUPED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_limit = smem;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  w8a16_kernel<W4, GROUPED><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)w, (const float*)ws,
      (const __nv_bfloat16*)xo, (const __nv_bfloat16*)wo, out, M, N, K, Bo,
      gs, fuse, out_f32);
  return (int)cudaGetLastError();
}

}  // namespace

// w4: the weight is packed uint8 [K/2, N]; G > 1: w_scale is [G, N];
// fuse: the epilogue's code (mixq::Epilogue, csrc/epilogue.cuh).
extern "C" int w8a16_launch(const void* x, const void* w, const void* ws,
                            const void* xo, const void* wo, void* out, int M,
                            int N, int K, int Bo, int G, int w4, int fuse,
                            int out_f32, void* stream) {
  const int bo = xo ? Bo : 0;
  const int gs = G > 1 ? K / G : K;
  cudaStream_t st = (cudaStream_t)stream;
  if (w4)
    return G > 1 ? launch<true, true>(x, w, ws, xo, wo, out, M, N, K, bo, gs,
                                      fuse, out_f32, st)
                 : launch<true, false>(x, w, ws, xo, wo, out, M, N, K, bo, gs,
                                       fuse, out_f32, st);
  return G > 1 ? launch<false, true>(x, w, ws, xo, wo, out, M, N, K, bo, gs,
                                     fuse, out_f32, st)
               : launch<false, false>(x, w, ws, xo, wo, out, M, N, K, bo, gs,
                                      fuse, out_f32, st);
}
