// Int8-activation mixed-precision GEMM with the fused MixQ epilogue (kernel
// A), a template over <W4, GROUPED> in three modes:
//   W4 per-channel: y = float(sum_k q_x[m,k] * w[k,n]) * x_scale[m]
//                   * w_scale[n]
//   grouped (W4 or W8):
//                y = (sum_g float(acc_g[m,n]) * w_scale[g,n]) * x_scale[m],
//                acc_g the exact int32 sum over the K rows of group g
//   then + sum_b x_out[m,b] * w_out[b,n] (fp outlier channels), the
//   activation epilogue (none, SiLU, exact GELU or tanh GELU "gelu_new";
//   csrc/epilogue.cuh), and the cast to bf16 or f32.
// The weight is int8 [K, N] (W8) or packed int4 uint8 [K/2, N] (W4) in the
// halves layout of ops/quant.py::pack_int4: packed row p holds K-row p in
// its low nibble and K-row K/2 + p in its high nibble. The W8 per-channel
// mode (kernel 2) is csrc/mix_gemm_w8.cu; mix_gemm_launch refuses it.
//
// Replaces: mixq_tpu/ops/pallas/mix_gemm.py::mix_gemm with an int8
// activation: the packed-W4 mode (`_unpack_w4`) and grouped scales
// (`_grouped_int8_dot`).
//
// Bound on the card: at decode (M = batch <= a few hundred) the weight read
// dominates: K*N bytes for W8 (11008 x 4096: 45 MB, 13.5 us at 3.35 TB/s),
// K*N/2 for W4 (22.5 MB, 6.7 us), against 2*M*K*N = 5.8 GOP, 2.9 us at the
// int8 tensor-core peak for M = 64.
//
// Design: a plain multistage tensor-core GEMM. Each block owns a 64 x 32
// output tile and walks the whole K; a 4-stage cp.async ring keeps the A/B
// tiles in flight, and the narrow 32-wide N tile puts >= 128 blocks on the
// card at M = 64 for every Llama-2-7B linear. Four warps each own 16 rows x
// 32 columns and run int8 WMMA (16x16x16, int32 accumulation; the JAX
// layout, w row-major [K, N], feeds matrix_b directly). Tiles are staged as
// 16x16-byte sub-tiles so every fragment pointer is 256-bit aligned.
//  * W8: a stage is 64 K-rows: the A tile q_x[:, k0:k0+64] and the B tile
//    w[k0:k0+64, :].
//  * W4: a stage is 32 packed rows [p0, p0+32), i.e. K-rows [p0, p0+32) and
//    [K/2+p0, K/2+p0+32). It loads the packed B tile (1 KB, half of W8's
//    bytes) and an A tile whose sub-tiles 0-1 are q_x[:, p0:p0+32] and 2-3
//    are q_x[:, K/2+p0 : K/2+p0+32]. The block unpacks the packed tile in
//    shared memory (nibble sign extension with per-byte SIMD) into the same
//    64-row int8 sub-tile layout as W8, and the MMA loop is W8's. No
//    unpacked weight is ever written to device memory. Hopper has no int4
//    tensor-core path; the activations are int8-stored values in [-7, 7].
//  * GROUPED: the int32 accumulators are folded into an f32 sum at every
//    group boundary (group_size % 16 == 0): each warp stores its fragments
//    to its own rows of shared memory, each lane (one output column) adds
//    float(acc) * w_scale[g, n] for its 16 rows, and the fragments are
//    zeroed. With halves the low and high K-rows of a stage lie in
//    different groups, so W4 keeps a second accumulator pair for the high
//    rows (requires (K/2) % group_size == 0, so both end a group together).
//    The f32 group sum is sequential in g, where JAX's jnp.sum may pair
//    terms in another order: a few f32 ulps of |y|.
// The outlier term runs as bf16 WMMA with f32 accumulation on x_out/w_out
// tiles loaded at the start (their cp.async group overlaps the main loop).
// The epilogue applies the scales in the JAX order with non-contractible
// multiplies/adds (__fmul_rn, __fadd_rn), so it rounds as the f32
// reference does.
//
// Requirements (checked by the Python wrapper): K % 16 == 0 (W4: K % 32),
// N % 16 == 0, B % 16 == 0, 16-byte aligned operands, grouped: K/G % 16 ==
// 0 (W4: (K/2) % (K/G) == 0); M, N edges and a K tail inside the last stage
// are masked by zero-filled loads and guarded stores.
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
constexpr int A_STAGE = BM * KSTEP;       // bytes
constexpr int B_STAGE = KSTEP * BN;       // bytes of an int8 (unpacked) tile
constexpr int LDC = BN + 4;               // epilogue tile row pitch (words)

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;

// One stage: the A tile [BM, 64 K-rows] of q_x -> smem [4][BM][16]; the
// stored weight rows [s, s + SROWS) -> smem [SROWS/16][BN/16][16][16]
// (W8: SROWS = 64 K-rows from s = k0; W4: 32 packed rows from s = p0).
template <bool W4>
__device__ __forceinline__ void load_stage(int8_t* As, uint8_t* Bs,
                                           const int8_t* __restrict__ qx,
                                           const uint8_t* __restrict__ w,
                                           int M, int N, int K, int m0,
                                           int n0, int s) {
  const int half = K / 2;
  for (int c = threadIdx.x; c < BM * (KSTEP / 16); c += THREADS) {
    const int r = c % BM, kc = c / BM;
    const int gm = m0 + r;
    int gk;
    bool ok;
    if (W4) {                   // sub-tiles 0-1: low rows, 2-3: high rows
      const int pk = s + (kc & 1) * 16;
      ok = pk < half;
      gk = (kc < 2 ? 0 : half) + pk;
    } else {
      gk = s + kc * 16;
      ok = gk < K;
    }
    ok = ok && gm < M;
    cp_async16(As + (kc * BM + r) * 16, ok ? qx + (size_t)gm * K + gk : qx,
               ok);
  }
  constexpr int SROWS = W4 ? KSTEP / 2 : KSTEP;
  const int rows = W4 ? half : K;
  for (int c = threadIdx.x; c < SROWS * (BN / 16); c += THREADS) {
    const int kr = c / (BN / 16), nc = c % (BN / 16);
    const int gk = s + kr, gn = n0 + nc * 16;
    const bool ok = gk < rows && gn < N;
    cp_async16(Bs + (((kr / 16) * (BN / 16) + nc) * 16 + (kr % 16)) * 16,
               ok ? w + (size_t)gk * N + gn : w, ok);
  }
}

// Packed tile [2][2][16][16] uint8 -> int8 tile [4][2][16][16]: the low
// nibbles become sub-tile rows 0-1 (K-rows p0..p0+31), the high nibbles rows
// 2-3 (K-rows K/2+p0..). Sign extension per byte: ((v ^ 8) - 8).
__device__ __forceinline__ void unpack_w4(const uint8_t* Bp, int8_t* Bu) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(Bp);
  uint32_t* lo = reinterpret_cast<uint32_t*>(Bu);
  uint32_t* hi = lo + B_STAGE / 8;
  for (int i = threadIdx.x; i < B_STAGE / 8; i += THREADS) {
    const uint32_t p = src[i];
    lo[i] = __vsub4((p & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
    hi[i] = __vsub4(((p >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
  }
}

// acc[nc] += A[:, 16 K-rows of sub-tile kk] x B[sub-tile kk, 32 columns]
__device__ __forceinline__ void mma_step(const int8_t* A, const int8_t* B,
                                         int kk, int warp, AccFrag (&acc)[2]) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
  wmma::load_matrix_sync(a, A + (kk * BM + warp * 16) * 16, 16);
#pragma unroll
  for (int nc = 0; nc < 2; ++nc) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b;
    wmma::load_matrix_sync(b, B + (kk * (BN / 16) + nc) * 256, 16);
    wmma::mma_sync(acc[nc], a, b, acc[nc]);
  }
}

// Grouped: fsum[j] (row j of the warp's 16, column `lane`) +=
// float(acc) * w_scale[g, n0 + lane]; then acc = 0. Cw: the warp's own 16
// rows of the shared epilogue tile.
__device__ __forceinline__ void fold(AccFrag (&acc)[2], int* Cw,
                                     float (&fsum)[16],
                                     const float* __restrict__ ws, int g,
                                     int N, int gn) {
  wmma::store_matrix_sync(Cw, acc[0], LDC, wmma::mem_row_major);
  wmma::store_matrix_sync(Cw + 16, acc[1], LDC, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const float s = gn < N ? ws[(size_t)g * N + gn] : 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    fsum[j] = __fadd_rn(fsum[j], __fmul_rn((float)Cw[j * LDC + lane], s));
  __syncwarp();
  wmma::fill_fragment(acc[0], 0);
  wmma::fill_fragment(acc[1], 0);
}

template <bool W4, bool GROUPED>
__global__ void __launch_bounds__(THREADS)
mix_gemm_kernel(const int8_t* __restrict__ qx,     // [M, K]
                const uint8_t* __restrict__ w,     // [K, N] | packed [K/2, N]
                const float* __restrict__ xs,      // [M]
                const float* __restrict__ ws,      // [N] | [G, N]
                const __nv_bfloat16* __restrict__ xo,  // [M, Bo] / null
                const __nv_bfloat16* __restrict__ wo,  // [Bo, N] / null
                void* __restrict__ out,            // [M, N]
                int M, int N, int K, int Bo, int gs, int fuse, int out_f32) {
  constexpr int BS = W4 ? B_STAGE / 2 : B_STAGE;  // stored tile bytes
  constexpr int SROWS = W4 ? KSTEP / 2 : KSTEP;   // stored rows per stage
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  uint8_t* Bs = reinterpret_cast<uint8_t*>(As + STAGES * A_STAGE);
  int8_t* Bu = reinterpret_cast<int8_t*>(Bs + STAGES * BS);  // W4: unpacked
  int* Cs = reinterpret_cast<int*>(Bu + (W4 ? B_STAGE : 0));
  float* Fs = reinterpret_cast<float*>(Cs + BM * LDC);
  __nv_bfloat16* XOs = reinterpret_cast<__nv_bfloat16*>(Fs + BM * LDC);
  __nv_bfloat16* WOs = XOs + BM * Bo;

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool has_out = xo != nullptr;
  const int rows = W4 ? K / 2 : K;                // stored weight rows

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
      load_stage<W4>(As + s * A_STAGE, Bs + s * BS, qx, w, M, N, K, m0, n0,
                     s * SROWS);
    cp_async_commit();
  }

  AccFrag acc[2], acc_hi[2];            // acc_hi: W4 grouped, high K-rows
  wmma::fill_fragment(acc[0], 0);
  wmma::fill_fragment(acc[1], 0);
  wmma::fill_fragment(acc_hi[0], 0);
  wmma::fill_fragment(acc_hi[1], 0);
  float fsum[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) fsum[j] = 0.f;
  int* Cw = Cs + warp * 16 * LDC;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < KT) {
      const int slot = nk % STAGES;
      load_stage<W4>(As + slot * A_STAGE, Bs + slot * BS, qx, w, M, N, K, m0,
                     n0, nk * SROWS);
    }
    cp_async_commit();

    const int8_t* A = As + (kt % STAGES) * A_STAGE;
    const int8_t* B;
    if constexpr (W4) {
      unpack_w4(Bs + (kt % STAGES) * BS, Bu);
      __syncthreads();
      B = Bu;
    } else {
      B = reinterpret_cast<const int8_t*>(Bs + (kt % STAGES) * BS);
    }
#pragma unroll
    for (int j = 0; j < (W4 ? 2 : 4); ++j) {
      mma_step(A, B, j, warp, acc);
      if constexpr (W4) {
        if constexpr (GROUPED)
          mma_step(A, B, j + 2, warp, acc_hi);
        else
          mma_step(A, B, j + 2, warp, acc);
      }
      if constexpr (GROUPED) {
        const int e = kt * SROWS + (j + 1) * 16;   // stored rows done
        if (e % gs == 0 && e <= rows) {
          fold(acc, Cw, fsum, ws, e / gs - 1, N, n0 + lane);
          if constexpr (W4)
            fold(acc_hi, Cw, fsum, ws, (K / 2 + e) / gs - 1, N, n0 + lane);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  if constexpr (GROUPED) {
    float* Gw = reinterpret_cast<float*>(Cw);
#pragma unroll
    for (int j = 0; j < 16; ++j) Gw[j * LDC + lane] = fsum[j];
  } else {
    for (int nc = 0; nc < 2; ++nc)
      wmma::store_matrix_sync(Cw + nc * 16, acc[nc], LDC,
                              wmma::mem_row_major);
  }
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
    float y;
    if constexpr (GROUPED)
      y = __fmul_rn(reinterpret_cast<const float*>(Cs)[r * LDC + c], xs[gm]);
    else
      y = __fmul_rn(__fmul_rn((float)Cs[r * LDC + c], xs[gm]), ws[gn]);
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
int launch(const void* qx, const void* w, const void* xs, const void* ws,
           const void* xo, const void* wo, void* out, int M, int N, int K,
           int Bo, int gs, int fuse, int out_f32, cudaStream_t stream) {
  static int smem_limit = 48 * 1024;   // per instantiation
  const int smem = STAGES * (A_STAGE + (W4 ? B_STAGE / 2 : B_STAGE)) +
                   (W4 ? B_STAGE : 0) + 2 * BM * LDC * 4 +
                   (BM * Bo + Bo * BN) * 2;
  if (smem > smem_limit) {
    cudaError_t e = cudaFuncSetAttribute(
        mix_gemm_kernel<W4, GROUPED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_limit = smem;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mix_gemm_kernel<W4, GROUPED><<<grid, THREADS, smem, stream>>>(
      (const int8_t*)qx, (const uint8_t*)w, (const float*)xs,
      (const float*)ws, (const __nv_bfloat16*)xo, (const __nv_bfloat16*)wo,
      out, M, N, K, Bo, gs, fuse, out_f32);
  return (int)cudaGetLastError();
}

}  // namespace

// w4: the weight is packed uint8 [K/2, N]; G > 1: w_scale is [G, N] (W8
// takes only G > 1 here);
// fuse: the epilogue's code (mixq::Epilogue, csrc/epilogue.cuh).
extern "C" int mix_gemm_launch(const void* qx, const void* w, const void* xs,
                               const void* ws, const void* xo, const void* wo,
                               void* out, int M, int N, int K, int Bo, int G,
                               int w4, int fuse, int out_f32, void* stream) {
  const int bo = xo ? Bo : 0;
  const int gs = G > 1 ? K / G : K;
  cudaStream_t st = (cudaStream_t)stream;
  if (w4)
    return G > 1 ? launch<true, true>(qx, w, xs, ws, xo, wo, out, M, N, K, bo,
                                      gs, fuse, out_f32, st)
                 : launch<true, false>(qx, w, xs, ws, xo, wo, out, M, N, K,
                                       bo, gs, fuse, out_f32, st);
  if (G == 1) return (int)cudaErrorInvalidValue;   // csrc/mix_gemm_w8.cu
  return launch<false, true>(qx, w, xs, ws, xo, wo, out, M, N, K, bo, gs,
                             fuse, out_f32, st);
}
