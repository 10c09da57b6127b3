// Weight-only (a16) GEMM: bf16 activations times int8 or packed-int4 weights
// dequantized in registers, with the fused MixQ epilogue:
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
// the bf16 tensor-core peak. So the kernel must keep HBM busy: enough weight
// bytes in flight on every SM, and no serial walk of one block over all of K.
//
// Design (decode-shaped weight streaming):
// - Output tiles of BM x BN = 64 x 128, 8 warps: warp w owns the 32 columns
//   [32 (w & 3), +32) of all 64 rows, and of each stage the two 16-row
//   sub-tiles 2 (w >> 2) and 2 (w >> 2) + 1; the two K-halves of the block
//   add in shared memory. A stage holds 64 K-rows of weight (W8: 64 rows x
//   128 bytes, whole 128-byte lines; W4: 32 packed rows, whose A tile's
//   columns 0-31 are x[:, p0:p0+32] and 32-63 x[:, K/2+p0 : +32]), the
//   64 x 64 bf16 tile of x beside it, and for grouped scales the four
//   16-row sub-tiles' scale rows (a group boundary, K/G a multiple of 16,
//   never falls inside a sub-tile).
// - Split-K: the grid is N-tiles x M-tiles x S, and the S blocks of one
//   output tile form one thread-block cluster (1, 1, S), S <= 8. Split z
//   walks whole stages: T stages split as T/S, one more for the first
//   T % S splits (kernels/w8a16.py::plan_a16 picks S and computes the same
//   bounds). Each block leaves its f32 partial tile in its own shared
//   memory; after cluster.sync() rank r reduces a 1/S share of the tile,
//   reading every rank's partial through distributed shared memory in the
//   fixed order 0..S-1 (all S loads in flight at once), adds the outlier
//   term once, applies the epilogue and stores. One launch, no workspace,
//   no atomics: the result is deterministic.
// - A 4-stage cp.async ring (16-byte copies, addressed once per block), one
//   barrier per stage: 3 stages ahead, 24 KB of W8 weight (12 KB of W4) in
//   flight per block, two blocks per SM (128 registers).
// - Dequant in registers, straight into mma.sync.m16n8k16 B fragments. A
//   warp's 32 columns are four n8 tiles interleaved (tile j, column n ->
//   32 (w & 3) + 4n + j), so one 32-bit shared load of a weight row gives a
//   thread its column in all four tiles. One byte_perm puts byte j of two
//   rows into one bf16x2; 128 + (v & 127) as bf16 (the low 7 bits under
//   exponent 2^7) minus 128 or 256 by the sign bit is v exactly (int4:
//   128 + (v & 7) minus 128 or 136); then one bf16x2 multiply by the bf16
//   scale pair, fma.rn.bf16x2 with -0, rounds once, so wd is bit-identical
//   to the TPU recipe. Each weight byte is dequantized once per block, by
//   one thread.
// - A fragments by ldmatrix.x4 from a 144-byte-pitch tile (no bank
//   conflicts); the kernel is instantiated for 1-4 live 16-row M-tiles, so
//   rows past M cost no MMA.
// The plan (kernels/w8a16.py::plan_a16): the largest S <= 8 whose clusters
// all fit on the card at once (cudaOccupancyMaxActiveClusters: 264, 132,
// 79, 62, 47, 39, 32, 30 clusters of 1..8 blocks on an H100): a second
// wave costs a whole block's time again. At M = 64 (N-tiles x S = blocks):
// Llama-2-7B q/k/v/o 4096x4096 32 x 7 = 224; up/gate 4096x11008 86 x 2 =
// 172; down 11008x4096 32 x 7 (24-25 stages a split); Gemma-2-9B q
// 3584x4096 32 x 7; k/v 3584x2048 16 x 8 = 128; o 4096x3584 and down
// 14336x3584 28 x 8 = 224; up/gate 3584x14336 112 x 2 = 224.
// Per block at Llama-2-7B's 4096 x 11008, M = 64 (S = 2): 2048 K-rows x 128
// columns = 256 KB of weight from HBM and 64 x 2048 x 2 = 256 KB of x from
// L2; 32 KB of partial read once over the cluster.
//
// Requirements (checked by the Python wrapper): K % 16 == 0 (W4: K % 32),
// N % 16 == 0, B % 16 == 0, 16-byte aligned operands, grouped:
// (K/G) % 16 == 0, 1 <= S <= 8 and S <= the number of stages. M, N edges and
// a K tail inside the last stage are masked by zero-filled loads and
// guarded stores. The launcher returns cudaGetLastError(); it allocates
// nothing and does not synchronize.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "epilogue.cuh"
#include "launch.cuh"

namespace cg = cooperative_groups;
using mixq::cp_async16;
using mixq::cp_async_commit;
using mixq::cp_async_wait;

namespace {

// BM, BN, KSTEP, STAGES and MAX_SPLITS are mirrored in kernels/w8a16.py.
constexpr int BM = 64, BN = 128, KSTEP = 64, STAGES = 4, THREADS = 256;
constexpr int MAX_SPLITS = 8;
constexpr int A_PITCH = KSTEP + 8;        // bf16: 144-byte rows
constexpr int W_PITCH = BN + 16;          // bytes: 144-byte rows
constexpr int C_PITCH = BN + 4;           // floats: the partial tile
constexpr int A_BYTES = BM * A_PITCH * 2;

template <bool W4, bool GROUPED>
struct Layout {
  static constexpr int SROWS = W4 ? KSTEP / 2 : KSTEP;   // stored rows
  static constexpr int W_BYTES = SROWS * W_PITCH;
  static constexpr int S_BYTES = GROUPED ? 4 * BN * 4 : 0;
  static constexpr int STAGE = A_BYTES + W_BYTES + S_BYTES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int PARTIAL = BM * C_PITCH * 4;
  static constexpr int SMEM = RING > PARTIAL ? RING : PARTIAL;
};

// This thread's share of every stage's copies, addressed once per block.
// A stage is the A tile of x [BM][A_PITCH] bf16 (W4: columns 0-31 from the
// low K-rows, 32-63 from the high ones), the stored weight rows
// [s, s + SROWS) -> [SROWS][W_PITCH] bytes, and, grouped, the scale row of
// each 16-row sub-tile -> [4][BN] f32. Thread t copies A and W chunk
// t & 7 of rows t / 8 + 32 i, and (t < 128) scale chunk t % 32 of
// sub-tile t / 32.
template <bool W4, bool GROUPED>
struct Loader {
  using L = Layout<W4, GROUPED>;
  static constexpr int WCOPIES = L::SROWS / (THREADS / 8);   // 2 | 1
  const __nv_bfloat16* x;
  const uint8_t* w;
  const float* ws;
  const __nv_bfloat16* a_src[2];
  const uint8_t* w_src[WCOPIES];
  int a_kofs, krows, w_row0, N, gs, s_col;
  bool a_ok[2], w_ok;

  __device__ __forceinline__ Loader(const __nv_bfloat16* x_,
                                    const uint8_t* w_, const float* ws_,
                                    int M, int N_, int K, int m0, int n0,
                                    int gs_)
      : x(x_), w(w_), ws(ws_), N(N_), gs(gs_) {
    const int t = threadIdx.x, ch = t & 7, half = K / 2;
    a_kofs = W4 ? (ch & 3) * 8 : ch * 8;
    krows = W4 ? half : K;
    const int acol = W4 ? (ch < 4 ? 0 : half) + a_kofs : a_kofs;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gm = m0 + t / 8 + 32 * i;
      a_ok[i] = gm < M;
      a_src[i] = x + (size_t)(a_ok[i] ? gm : 0) * K + acol;
    }
    w_row0 = t / 8;
    w_ok = n0 + ch * 16 < N;
#pragma unroll
    for (int i = 0; i < WCOPIES; ++i)
      w_src[i] = w + (size_t)(w_row0 + 32 * i) * N + n0 + ch * 16;
    s_col = n0 + (t % 32) * 4;
  }

  __device__ __forceinline__ void issue(unsigned char* st, int s) const {
    const int t = threadIdx.x, ch = t & 7;
    __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(st);
    const bool k_ok = s + a_kofs < krows;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool ok = a_ok[i] && k_ok;
      cp_async16(As + (t / 8 + 32 * i) * A_PITCH + ch * 8,
                 ok ? a_src[i] + s : x, ok);
    }
    uint8_t* Ws = st + A_BYTES;
#pragma unroll
    for (int i = 0; i < WCOPIES; ++i) {
      const bool ok = w_ok && s + w_row0 + 32 * i < krows;
      cp_async16(Ws + (w_row0 + 32 * i) * W_PITCH + ch * 16,
                 ok ? w_src[i] + (size_t)s * N : w, ok);
    }
    if (GROUPED && t < 128) {
      const int kc = t / 32;
      const int r = s + (W4 ? (kc & 1) : kc) * 16;   // stored row
      const int k = (W4 && kc >= 2 ? krows : 0) + r;  // its K-row
      const bool ok = r < krows && s_col < N;
      cp_async16(reinterpret_cast<float*>(Ws + L::W_BYTES) + kc * BN +
                     (t % 32) * 4,
                 ok ? ws + (size_t)(k / gs) * N + s_col : ws, ok);
    }
  }
};

// a - b in bf16x2, rounded once (exact for the operands below).
__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(b), "r"(0xBF80BF80u), "r"(a));
  return d;
}

// a * b in bf16x2, rounded once (fma with -0 adds nothing, keeps +0).
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

// {bf16(s), bf16(s)}
__device__ __forceinline__ uint32_t scale_pair(float s) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %1;\n" : "=r"(d) : "f"(s));
  return d;
}

// {bf16(lo), bf16(hi)}, each rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4],
                                            const void* smem) {
  const unsigned p = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(p));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragments of 16-row sub-tile kk (stored rows from `row`; W4: the
// nibble at `shift`) for this thread's four n8 tiles: b[j][0] = wd rows 2q,
// 2q+1, b[j][1] = rows 2q+8, 2q+9 of column 32 wn + 4 g + j.
template <bool W4, bool GROUPED>
__device__ __forceinline__ void b_fragments(uint32_t (&b)[4][2],
                                            const uint8_t* Ws,
                                            const float* Ss,
                                            const uint32_t (&sc)[4], int kk,
                                            int row, int shift, int wc,
                                            int q) {
  const uint8_t* p = Ws + (row + 2 * q) * W_PITCH + wc;
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(
        p + ((i & 1) + (i >> 1) * 8) * W_PITCH);
    u[i] = W4 ? raw >> shift : raw;
  }
  uint32_t s[4];
  if (GROUPED) {
    const float4 f = *reinterpret_cast<const float4*>(Ss + kk * BN + wc);
    s[0] = scale_pair(f.x);
    s[1] = scale_pair(f.y);
    s[2] = scale_pair(f.z);
    s[3] = scale_pair(f.w);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] = sc[j];
  }
  // byte j of rows r and r+1 -> bytes 0 and 2 of one word; as bf16,
  // 128 + (v & 127) minus 128 or 256 by v's sign bit (int4: 128 + (v & 7)
  // minus 128 or 136) is v exactly: two values per instruction
  constexpr uint32_t kLow = W4 ? 0x00070007u : 0x007F007Fu;
  constexpr uint32_t kSign = W4 ? 0x00080008u : 0x00800080u;
  constexpr uint32_t k128 = 0x43004300u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t v = __byte_perm(u[2 * h], u[2 * h + 1], j | (4 + j) << 8);
      b[j][h] = mul_bf16x2(sub_bf16x2((v & kLow) | k128, (v & kSign) | k128),
                           s[j]);
    }
  }
}

struct Args {
  const __nv_bfloat16* x;   // [M, K]
  const uint8_t* w;         // [K, N] | packed [K/2, N]
  const float* ws;          // [N] | [G, N]
  const __nv_bfloat16* xo;  // [M, Bo] / null
  const __nv_bfloat16* wo;  // [Bo, N] / null
  void* out;                // [M, N]
  int M, N, K, Bo, gs, fuse, out_f32;
};

// One output tile's split: MT live 16-row M-tiles (1-4). Warp w owns
// columns [32 (w & 3), +32) and, of each stage, the sub-tiles
// kk = 2 (w >> 2) and 2 (w >> 2) + 1; the two K-halves add in shared
// memory, then the cluster's S partials add in rank order.
template <bool W4, bool GROUPED, int MT>
__device__ __forceinline__ void gemm_tile(const Args& a,
                                          unsigned char* smem) {
  using L = Layout<W4, GROUPED>;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = gridDim.z, z = blockIdx.z;   // the cluster is (1, 1, S)
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp & 3, wk = warp >> 2;
  const int g = lane >> 2, q = lane & 3;
  const int wc = wn * 32 + 4 * g;            // this thread's 4 columns

  // this split's stages: T / S each, one more for the first T % S
  const int rows = W4 ? a.K / 2 : a.K;
  const int T = (rows + L::SROWS - 1) / L::SROWS;
  const int first = z * (T / S) + min(z, T % S);
  const int count = T / S + (z < T % S ? 1 : 0);

  const Loader<W4, GROUPED> ld(a.x, a.w, a.ws, a.M, a.N, a.K, m0, n0, a.gs);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < count) ld.issue(smem + i * L::STAGE, (first + i) * L::SROWS);
    cp_async_commit();
  }
  uint32_t sc[4] = {0, 0, 0, 0};       // per-channel scales, bf16 pairs
  if (!GROUPED && n0 + wc < a.N) {
    const float4 f = *reinterpret_cast<const float4*>(a.ws + n0 + wc);
    sc[0] = scale_pair(f.x);
    sc[1] = scale_pair(f.y);
    sc[2] = scale_pair(f.z);
    sc[3] = scale_pair(f.w);
  }

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  // W8: sub-tile kk is stored rows 16 kk; W4: packed rows 16 (kk & 1), the
  // low nibble for kk < 2 and the high one (K-rows K/2 + p) for kk >= 2
  const int kk0 = 2 * wk;
  const int shift = W4 ? 4 * wk : 0;
  for (int kt = 0; kt < count; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();      // stage kt landed; slot (kt - 1) % STAGES is free
    const int nk = kt + STAGES - 1;
    if (nk < count)
      ld.issue(smem + (nk % STAGES) * L::STAGE, (first + nk) * L::SROWS);
    cp_async_commit();

    const unsigned char* st = smem + (kt % STAGES) * L::STAGE;
    const __nv_bfloat16* As = reinterpret_cast<const __nv_bfloat16*>(st);
    const uint8_t* Ws = st + A_BYTES;
    const float* Ss = reinterpret_cast<const float*>(Ws + L::W_BYTES);
    uint32_t b[2][4][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      b_fragments<W4, GROUPED>(b[h], Ws, Ss, sc, kk0 + h,
                               (W4 ? h : kk0 + h) * 16, shift, wc, q);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[4];
        ldmatrix_x4(af, As + (mt * 16 + (lane & 15)) * A_PITCH +
                            (kk0 + h) * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[mt][j], af, b[h][j][0], b[h][j][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                 // the ring is free: the partial goes there

  // the block's partial: K-half 0 + K-half 1, in shared memory
  float* Cs = reinterpret_cast<float*>(smem);
  for (int pass = 1; pass >= 0; --pass) {
    if (wk == pass) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* c = Cs + (mt * 16 + g) * C_PITCH + wn * 32 + 8 * q + j;
          float* e[4] = {c, c + 4, c + 8 * C_PITCH, c + 8 * C_PITCH + 4};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            *e[i] = pass ? acc[mt][j][i] : __fadd_rn(acc[mt][j][i], *e[i]);
        }
    }
    if (pass) __syncthreads();
  }
  cluster.sync();                  // every rank's partial is in place

  // rank z: chunks of 4 columns z*THREADS + t, stepping S*THREADS
  const int chunks = min(BM, a.M - m0) * (BN / 4);
  for (int i = z * THREADS + threadIdx.x; i < chunks; i += S * THREADS) {
    const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
    const int gm = m0 + r, gn = n0 + c;
    if (gn >= a.N) continue;
    float4 v[MAX_SPLITS];            // every rank's loads in flight at once
#pragma unroll
    for (int p = 0; p < MAX_SPLITS; ++p)
      if (p < S)
        v[p] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(Cs + r * C_PITCH + c, p));
    float y[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
#pragma unroll
    for (int p = 1; p < MAX_SPLITS; ++p) {   // fixed order: ranks 0..S-1
      if (p < S) {
        y[0] = __fadd_rn(y[0], v[p].x);
        y[1] = __fadd_rn(y[1], v[p].y);
        y[2] = __fadd_rn(y[2], v[p].z);
        y[3] = __fadd_rn(y[3], v[p].w);
      }
    }
    if (a.xo != nullptr) {           // the outlier term, once, in f32
      float o[4] = {0.f, 0.f, 0.f, 0.f};
      for (int bo = 0; bo < a.Bo; ++bo) {
        const float xv = __bfloat162float(a.xo[(size_t)gm * a.Bo + bo]);
        const __nv_bfloat16* wr = a.wo + (size_t)bo * a.N + gn;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = fmaf(xv, __bfloat162float(wr[e]), o[e]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = __fadd_rn(y[e], o[e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = mixq::apply_epilogue(y[e], a.fuse);
    if (a.out_f32) {
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(a.out) +
                                 (size_t)gm * a.N + gn) =
          make_float4(y[0], y[1], y[2], y[3]);
    } else {
      uint2 o;
      o.x = pack_bf16(y[0], y[1]);
      o.y = pack_bf16(y[2], y[3]);
      *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(a.out) +
                                (size_t)gm * a.N + gn) = o;
    }
  }
  cluster.sync();          // peers' partials stay alive until all are read
}

template <bool W4, bool GROUPED>
__global__ void __launch_bounds__(THREADS, 2) w8a16_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  // M-tiles of 16 rows past M cost no MMA (one cluster shares blockIdx.y)
  switch (min(BM, a.M - (int)blockIdx.y * BM + 15) / 16) {
    case 1: gemm_tile<W4, GROUPED, 1>(a, smem); break;
    case 2: gemm_tile<W4, GROUPED, 2>(a, smem); break;
    case 3: gemm_tile<W4, GROUPED, 3>(a, smem); break;
    default: gemm_tile<W4, GROUPED, 4>(a, smem); break;
  }
}

template <bool W4, bool GROUPED>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                      int S) {
  static unsigned long long smem_set = 0;   // per instantiation and device
  const int smem = Layout<W4, GROUPED>::SMEM;
  if (smem > 48 * 1024) {
    cudaError_t e = mixq::allow_smem(w8a16_kernel<W4, GROUPED>, smem,
                                     smem_set);
    if (e != cudaSuccess) return e;
  }
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = S;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <bool W4, bool GROUPED>
int launch(const Args& a, int S, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t e = configure<W4, GROUPED>(cfg, attr, S);
  if (e != cudaSuccess) return (int)e;
  cfg.gridDim = dim3((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, S);
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, w8a16_kernel<W4, GROUPED>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool W4, bool GROUPED>
int max_clusters(int S, int* n) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t e = configure<W4, GROUPED>(cfg, attr, S);
  if (e != cudaSuccess) return (int)e;
  cfg.gridDim = dim3(1, 1, S);
  return (int)cudaOccupancyMaxActiveClusters(n, w8a16_kernel<W4, GROUPED>,
                                             &cfg);
}

}  // namespace

// w4: the weight is packed uint8 [K/2, N]; G > 1: w_scale is [G, N];
// fuse: the epilogue's code (mixq::Epilogue, csrc/epilogue.cuh); splits: S,
// the split-K factor of kernels/w8a16.py::plan_a16 (the cluster size).
extern "C" int w8a16_launch(const void* x, const void* w, const void* ws,
                            const void* xo, const void* wo, void* out, int M,
                            int N, int K, int Bo, int G, int w4, int fuse,
                            int out_f32, int splits, void* stream) {
  if (splits < 1 || splits > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  const Args a{(const __nv_bfloat16*)x, (const uint8_t*)w, (const float*)ws,
               (const __nv_bfloat16*)xo, (const __nv_bfloat16*)wo, out, M, N,
               K, xo ? Bo : 0, G > 1 ? K / G : K, fuse, out_f32};
  cudaStream_t st = (cudaStream_t)stream;
  if (w4)
    return G > 1 ? launch<true, true>(a, splits, st)
                 : launch<true, false>(a, splits, st);
  return G > 1 ? launch<false, true>(a, splits, st)
               : launch<false, false>(a, splits, st);
}

// How many clusters of `splits` blocks of one weight mode fit on the card
// at once (cudaOccupancyMaxActiveClusters) into *n; returns the CUDA error.
extern "C" int w8a16_max_active_clusters(int splits, int w4, int grouped,
                                         int* n) {
  if (w4)
    return grouped ? max_clusters<true, true>(splits, n)
                   : max_clusters<true, false>(splits, n);
  return grouped ? max_clusters<false, true>(splits, n)
                 : max_clusters<false, false>(splits, n);
}
