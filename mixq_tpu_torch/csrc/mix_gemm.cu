// The int8-activation mix-GEMM with the fused MixQ epilogue, for decode: one
// template over <W4, GROUPED> serves its four weight modes, and over <W4>
// QUIK's two zero-point modes (mix_gemm_zp_kernel).
//   W8: w int8 [K, N]; W4: w packed int4 uint8 [K/2, N] in the halves layout
//   of ops/quant.py::pack_int4 (packed row p holds K-row p in its low nibble
//   and K-row K/2 + p in its high one).
//   per-channel (w_scale [N]):
//     acc[m,n] = sum_k q_x[m,k] * w[k,n]                 (int32, exact)
//     y = float(acc) * x_scale[m] * w_scale[n]          (f32, JAX's order)
//   grouped (w_scale [G, N], group_size gs = K / G):
//     y = (sum_g float(acc_g[m,n]) * w_scale[g,n]) * x_scale[m],
//     acc_g the int32 sum over the K-rows of group g
//   zero point (QUIK; per-channel W8 or W4, x_zero [M], reduced_w [N]):
//     y = (x_scale[m] * w_scale[n]) * (float(acc) + x_zero[m] * reduced_w[n])
//     (JAX's order in mixq_tpu/ops/mixed_linear.py::quik_linear; the
//     activations are asymmetric, int8 values down to -128, A4 down to -8)
//   then + sum_b x_out[m,b] * w_out[b,n] (fp outlier channels, optional;
//   bf16 operands, f32 sum), the activation epilogue (none, SiLU, exact GELU
//   or tanh GELU "gelu_new"; csrc/epilogue.cuh) and the cast to bf16 or f32.
// <false, false> is kernel 2 (W8A8, also int8_matmul_dequant's contract);
// <true, false>, <true, true> and <false, true> are kernel A (W4, W4
// grouped, W8 grouped). mix_gemm_zp_kernel<false> and <true> are the same
// per-channel kernels with the zero-point term (the tile's template
// argument ZP, so the MIX instantiations compile as before).
// mix_gemm_experts_kernel is kernel 2's tile over E experts in one launch
// (MoE's expert linears, f32 out, no outlier term or epilogue): the grid's
// y axis runs the experts' M-tiles, and each block offsets the operands to
// its expert's slices.
//
// Replaces: mixq_tpu/ops/pallas/mix_gemm.py::mix_gemm with an int8
// activation (the int32 dot of `_kernel`/`_kernel_outlier`, `_unpack_w4`
// and `_grouped_int8_dot`), and with it
// mixq_tpu/ops/pallas/int8_matmul.py::int8_matmul_dequant; the expert mode
// replaces mixq_tpu/ops/moe.py::expert_linear's int8 batched dot_general
// (a jnp product with no Pallas kernel).
//
// Bound on the card: at decode (M = batch <= a few hundred) the weight
// read, K*N bytes (W4: K*N/2): Llama-2-7B's 4096 x 11008 is 45 MB (W4:
// 22.5 MB), 13.5 us (6.7 us) at 3.35 TB/s, against 2*M*K*N = 5.8 GOP, 2.9 us
// at the int8 tensor-core peak for M = 64. So HBM must stay busy: enough
// weight bytes in flight on every SM, and no serial walk of one block over
// all of K.
//
// Design:
// - Output tiles of BM x BN = 64 x 128, 8 warps: warp w owns the 32
//   columns [32 (w & 3), +32) of all live rows. A ring stage holds KSTEP =
//   128 stored weight rows (W4: packed rows, i.e. 256 K-rows), and the two
//   warp quads (w >> 2) split it: W8, the k32 steps of stage rows [0, 64)
//   and [64, 128); W4, the low and the high nibbles, so each quad walks one
//   contiguous run of K-rows. The quads' partials add in shared memory
//   after the loop. The kernel is instantiated for 1-4 live 16-row
//   M-tiles, so rows past M cost no MMA (one cluster shares blockIdx.y).
// - Split-K: the grid is N-tiles x M-tiles x S, and the S blocks of one
//   output tile form one thread-block cluster (1, 1, S), S <= 8. Split z
//   walks whole units of `su` stages: U units split as U/S, one more for
//   the first U % S splits (kernels/mix_gemm.py::plan_mix picks S and
//   computes the same bounds). su = 1 but when grouped, where a unit is
//   lcm(KSTEP, gs) stored rows, so every split bound is a group boundary
//   and no group's int32 sum is cut between splits. Each block leaves its
//   partial tile (int32; grouped f32) in its own shared memory. Rank z owns
//   the n8 tiles [16 z / S, 16 (z+1) / S) of the output tile: after a
//   cluster barrier it sums the S partials there through distributed shared
//   memory (int32: exact in any order, |acc| <= 127 * 127 * K < 2^31 for
//   K < 133,000, so the result does not depend on S; grouped: f32 in rank
//   order, deterministic for a given S), scales once, adds the outlier
//   term, applies the epilogue and stores, 4 columns a thread (16-byte
//   loads, coalesced stores, one copy of the epilogue's code). One launch,
//   no workspace, no atomics. The row and column scales are loaded into
//   registers before the main loop and staged beside the partial after it.
// - A 4-stage cp.async ring (16-byte copies, addresses computed once per
//   block), one barrier per stage. A stage holds the weight rows
//   [s, s + 128) x [n0, n0 + 128), whole 128-byte lines at a 144-byte pitch
//   (16 KB, W8 or W4), and the A tile q_x[m0 : m0 + 64, the stage's K-rows]
//   at a pitch of its width + 16 bytes (ldmatrix rows on 8 distinct bank
//   quads): W8 columns [s, s + 128), W4 [s, s + 128) and [K/2 + s, +128).
//   3 stages ahead: 48 KB of weight in flight per block, one block per SM
//   (159 KB of shared memory, W4 191 KB). Chosen over 64-row stages (two
//   blocks per SM, 24 KB each in flight) by kernel 2's time at decode
//   shapes under the same plan rule (PERF.md): the deeper stages halve the
//   barriers per byte, and the plan lands on fewer splits, so less partial
//   tile crosses the cluster.
// - MMA: mma.sync.m16n8k32.s32.s8.s8.s32; A fragments by ldmatrix.x4. The
//   weight is N-major ([K, N] row-major, the JAX layout) while the MMA
//   wants 4 consecutive k of one n in a register, and ldmatrix.trans moves
//   only 16-bit elements. So a warp's four n8 tiles are interleaved (tile
//   j, column n -> 32 (w & 3) + 4 n + j): one 32-bit load of a weight row
//   gives a thread its column in all four tiles, and four rows (k..k+3)
//   through a 4x4 byte transpose (8 prmt) give one B register for each
//   tile, which feeds every live M-tile. W4 sign-extends the quad's nibble
//   of each byte in registers first (4 ALU ops a word, no unpack pass
//   through shared memory); the A4 activations are int8 values in [-7, 7]
//   (the card has no int4 tensor-core rate). The 16-byte chunks of rows
//   8-15 of every 16 are stored with chunk index ^ 2, so those loads hit 32
//   distinct banks.
// - Grouped: the group fold in registers. Each thread converts its int32
//   accumulators to f32, multiplies each by its column's scale of the group
//   (8 columns a thread, loaded from w_scale into registers), adds it into
//   f32 accumulators of the same fragment shape and zeroes the int32 ones.
//   A group size that is a multiple of KSTEP (the served 128) makes every
//   stage part of one group: the k-steps run as per-channel, and each quad
//   folds once, after the group's last stage, with the scales it loaded at
//   the group's first (staging them through shared memory with each stage
//   measured slower at decode shapes). Other sizes (a tile instantiation of
//   their own, STEPWISE, so its checks stay out of that loop) fold whenever
//   a quad's next k-step lies in another group (or past its split); a group
//   ending inside a k32 step (gs % 32 == 16) splits that step into its two
//   k16 MMAs (mma.m16n8k16.s8) with the fold between. A W8 quad folds its
//   own rows of a group (its half of each stage); a W4 quad folds whole
//   groups.
// - The outlier term: x_out [live rows, 128] and rank z's columns of
//   w_out [128, n8 tiles of z] load with the ring's third cp.async group
//   (in the first, they held up the first stage at decode shapes).
//   After the main loop, before the cluster barrier (while the other ranks
//   finish their splits), each warp takes (M-tile, n8 tile) units of its
//   rank's share and runs mma.sync.m16n8k16 bf16 -> f32 over the channels
//   (ldmatrix.x4, ldmatrix.x2.trans), in the same order whatever S is, and
//   leaves the f32 result in a staging tile over the outlier tiles. A
//   budget above 128 channels goes in chunks of 128 through the same
//   tiles, loaded after the main loop.
// - The scales in JAX's order with non-contractible multiplies/adds
//   (__fmul_rn, __fadd_rn), so the epilogue rounds as the f32 reference.
// - The zero point: x_zero and reduced_w are loaded with the scales (one
//   more register a thread through the main loop), staged beside them, and
//   the term is added once, to the sum of the S partials, where the scales
//   apply; so the result is the same bits at every S.
//
// Requirements (checked by the Python wrapper): K % 16 == 0 (W4: K % 32),
// N % 16 == 0, Bo % 16 == 0, 16-byte aligned operands, 1 <= S <= 8;
// grouped: gs % 16 == 0 (W4: a gs that does not divide K/2 runs
// step-wise, its group across the halves folded in two parts). M, N edges
// and a K tail inside the last stage are masked by zero-filled loads and
// guarded stores.
// The launcher returns cudaGetLastError(); it allocates nothing and does not
// synchronize.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cluster.cuh"
#include "cp_async.cuh"
#include "epilogue.cuh"
#include "launch.cuh"

using mixq::cluster_arrive;
using mixq::cluster_wait;
using mixq::cp_async16;
using mixq::cp_async_commit;
using mixq::cp_async_wait;
using mixq::ld_cluster_if;
using mixq::map_rank;

namespace {

// KSTEP: stored weight rows of one ring stage, a multiple of 64 (each W8
// warp quad takes half of every stage's k32 steps); mirrored with BM, BN,
// STAGES, MAX_SPLITS and the blocks an SM holds (MIN_BLOCKS) in
// kernels/mix_gemm.py.
constexpr int BM = 64, BN = 128, KSTEP = 128, STAGES = 4;
constexpr int THREADS = 256, MAX_SPLITS = 8;
constexpr int OB = 128;                   // outlier channels per chunk
constexpr int W_PITCH = BN + 16;          // bytes
constexpr int C_PITCH = BN + 4;           // int32 / f32: the partial tile
constexpr int O_PITCH = 128 + 8;          // bf16: x_out and w_out tiles
constexpr int Y_PITCH = BN + 8;           // f32: the outlier results
constexpr int W_BYTES = KSTEP * W_PITCH;
constexpr int PARTIAL = BM * C_PITCH * 4;
constexpr int XO_BYTES = BM * O_PITCH * 2;
constexpr int OUTLIERS = XO_BYTES + OB * O_PITCH * 2;
// blocks an SM holds: 228 KB of shared memory, 1 KB of it reserved a block
constexpr int MIN_BLOCKS = 1;
// the scales staged after the main loop: x_scale [BM], w_scale [BN], then
// (zero point) x_zero [BM], reduced_w [BN]
constexpr int STAGED = 2 * (BM + BN) * 4;
static_assert(KSTEP % 64 == 0, "a stage is whole k32 steps of both quads");
static_assert(OB == 128 && BN == 128, "the outlier tiles share O_PITCH");
static_assert(BM * Y_PITCH * 4 <= OUTLIERS,
              "the outlier results reuse the outlier tiles");

// Shared memory of one instantiation: a stage is the A tile and the weight
// tile.
template <bool W4>
struct Layout {
  static constexpr int A_COLS = W4 ? 2 * KSTEP : KSTEP;   // q_x bytes a row
  static constexpr int A_PITCH = A_COLS + 16;             // bytes
  static constexpr int A_BYTES = BM * A_PITCH;
  static constexpr int STAGE = A_BYTES + W_BYTES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SMEM = RING + OUTLIERS;
  static_assert(SMEM <= 227 * 1024, "more shared memory than a block gets");
  static_assert(2 * (SMEM + 1024) > 228 * 1024, "two blocks would fit an SM");
  static_assert(PARTIAL + STAGED <= RING,
                "the partial tile and the scales reuse the ring");
};

struct Args {
  const int8_t* qx;         // [M, K]
  const int8_t* w;          // [K, N] | packed [K/2, N]
  const float* xs;          // [M]
  const float* ws;          // [N] | [G, N]
  const __nv_bfloat16* xo;  // [M, Bo] / null
  const __nv_bfloat16* wo;  // [Bo, N] / null
  void* out;                // [M, N]
  int M, N, K, Bo, fuse, out_f32;
  int gs, su;               // grouped: group size; stages of a split unit
  const float* xz;          // [M] / null: x_zero (zero point)
  const float* rw;          // [N] / null: reduced_w (zero point)
};

// This thread's share of every stage's copies, addressed once per block:
// A chunk t % ACH of rows t / ACH + AROWS i (rows past the MT live M-tiles
// are never read and not copied; W4 chunks 8-15 from the high K-rows),
// weight chunk t & 7 of rows t / 8 + 32 i.
template <bool W4, int MT>
struct Loader {
  using L = Layout<W4>;
  static constexpr int ACH = L::A_COLS / 16;        // 16-byte chunks a row
  static constexpr int AROWS = THREADS / ACH;
  static constexpr int ACOPIES = (MT * 16 + AROWS - 1) / AROWS;
  static constexpr int WCOPIES = KSTEP / (THREADS / 8);
  const int8_t* qx;
  const int8_t* w;
  const int8_t* a_src;      // row t / ACH (or row 0 past M), chunk t % ACH
  const int8_t* w_src;      // row t / 8, columns n0 + 16 (t & 7)
  int a_k, a_dst, a_row, w_row, w_dst, M, N, K, rows;
  bool w_ok;

  __device__ __forceinline__ Loader(const Args& a, int m0, int n0)
      : qx(a.qx), w(a.w), M(a.M - m0), N(a.N), K(a.K),
        rows(W4 ? a.K / 2 : a.K) {
    const int t = threadIdx.x, ch = t & 7;
    a_row = t / ACH;
    a_dst = (t % ACH) * 16;
    a_k = W4 ? a_dst % KSTEP : a_dst;     // the chunk's stored-row offset
    a_src = a.qx + (size_t)m0 * K + (W4 && a_dst >= KSTEP ? rows : 0) + a_k;
    w_row = t / 8;
    w_ok = n0 + ch * 16 < N;
    w_src = a.w + (size_t)w_row * N + n0 + ch * 16;
    // chunk index ^ 2 in rows 8-15 of every 16 (bit 3 of the row)
    w_dst = L::A_BYTES + w_row * W_PITCH + ((ch ^ ((w_row >> 2) & 2)) * 16);
  }

  __device__ __forceinline__ void issue(unsigned char* st, int s) const {
    const bool k_ok = s + a_k < rows;
#pragma unroll
    for (int i = 0; i < ACOPIES; ++i) {
      const int r = a_row + AROWS * i;
      if (r < MT * 16) {
        const bool ok = k_ok && r < M;
        cp_async16(st + r * L::A_PITCH + a_dst,
                   ok ? a_src + (size_t)r * K + s : qx, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < WCOPIES; ++i) {
      const bool ok = w_ok && s + w_row + 32 * i < rows;
      cp_async16(st + w_dst + 32 * i * W_PITCH,
                 ok ? w_src + (size_t)(s + 32 * i) * N : w, ok);
    }
  }
};

// x_out[m0 : m0 + 16 MT, c0 : c0 + 128] and w_out[c0 : c0 + 128, the n8
// tiles [lo, hi) of the output tile] into their tiles (a chunk of fewer
// channels at the budget's end), as cp.async copies of this thread.
template <int MT>
__device__ __forceinline__ void load_outliers(const Args& a,
                                              __nv_bfloat16* XOs,
                                              __nv_bfloat16* WOs, int m0,
                                              int n0, int lo, int hi,
                                              int c0) {
  const int cb = min(OB, a.Bo - c0), bch = cb / 8;
  for (int i = threadIdx.x; i < MT * 16 * bch; i += THREADS) {
    const int r = i / bch, ch = i % bch;
    const bool ok = m0 + r < a.M;
    cp_async16(XOs + r * O_PITCH + ch * 8,
               ok ? a.xo + (size_t)(m0 + r) * a.Bo + c0 + ch * 8 : a.xo, ok);
  }
  const int nch = hi - lo;
  for (int i = threadIdx.x; i < cb * nch; i += THREADS) {
    const int b = i / nch, nt = lo + i % nch;
    const bool ok = n0 + nt * 8 < a.N;
    cp_async16(WOs + b * O_PITCH + nt * 8,
               ok ? a.wo + (size_t)(c0 + b) * a.N + n0 + nt * 8 : a.wo, ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  const unsigned p = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(p));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* smem) {
  const unsigned p = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(p));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k16 half of mma_s8: A registers {a0, a1} and B register b of the
// same half (a k32 step's first half is a[0], a[1], b0; its second a[2],
// a[3], b1).
__device__ __forceinline__ void mma_s8_k16(int (&c)[4], uint32_t a0,
                                           uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// {bf16(lo), bf16(hi)}, each rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// The B fragments of one k16 half for this thread's four n8 tiles: u[i] is
// weight row 4q + i at the thread's 4 interleaved columns (byte j: tile
// j); b[j] gets byte j of u[0..3], i.e. rows 4q..4q+3 of tile j's column.
__device__ __forceinline__ void transpose4x4(const uint32_t (&u)[4],
                                             uint32_t (&b)[4]) {
  const uint32_t lo01 = __byte_perm(u[0], u[1], 0x5140);
  const uint32_t hi01 = __byte_perm(u[0], u[1], 0x7362);
  const uint32_t lo23 = __byte_perm(u[2], u[3], 0x5140);
  const uint32_t hi23 = __byte_perm(u[2], u[3], 0x7362);
  b[0] = __byte_perm(lo01, lo23, 0x5410);
  b[1] = __byte_perm(lo01, lo23, 0x7632);
  b[2] = __byte_perm(hi01, hi23, 0x5410);
  b[3] = __byte_perm(hi01, hi23, 0x7632);
}

// The int4 values in the nibble at `shift` (0: low, 4: high) of each byte
// of v, as int8: bit 3 copied into bits 4-7 (0x08 * 0x1E = 0xF0, so no
// byte carries into the next).
__device__ __forceinline__ uint32_t nibbles(uint32_t v, int shift) {
  const uint32_t x = (v >> shift) & 0x0F0F0F0Fu;
  return x | ((x & 0x08080808u) * 0x1Eu);
}

// Grouped: the group's scales at this thread's 8 columns (tile j's column
// 2q + (e & 1) is column 32 (w & 3) + 8q + 4 (e & 1) + j): row `row` of
// w_scale from `col` on (zeros past N, which is a multiple of 16).
struct Scales {
  float4 s0, s1;
};
__device__ __forceinline__ Scales load_scales(const Args& a, int row,
                                              int col) {
  Scales r{make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  if (col < a.N) {
    const float4* p = reinterpret_cast<const float4*>(a.ws + (size_t)row * a.N
                                                      + col);
    r.s0 = __ldg(p);
    r.s1 = __ldg(p + 1);
  }
  return r;
}

// Grouped: f += float(acc) * the group's scale, then acc = 0.
template <int MT>
__device__ __forceinline__ void fold(int (&acc)[MT][4][4],
                                     float (&f)[MT][4][4], const Scales& sc) {
  const float4 s0 = sc.s0, s1 = sc.s1;
  const float s[2][4] = {{s0.x, s0.y, s0.z, s0.w}, {s1.x, s1.y, s1.z, s1.w}};
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[mt][j][e] = __fadd_rn(f[mt][j][e],
                                __fmul_rn((float)acc[mt][j][e], s[e & 1][j]));
        acc[mt][j][e] = 0;
      }
}

// A thread's chunks of the staging tile through the epilogue FUSE into
// out: chunk k is tile row r0 + k * rpp (row gm0 + k * rpp of out),
// columns [c, c + 4) (gn .. gn + 3 of out).
template <int FUSE>
__device__ __forceinline__ void finish(const Args& a, const float* Ys,
                                       int gm0, int r0, int rpp, int nk,
                                       int gn, int c) {
  for (int k = 0; k < nk; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(
        Ys + (r0 + k * rpp) * Y_PITCH + c);
    float y[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = mixq::apply_epilogue(y[e], FUSE);
    const size_t idx = (size_t)(gm0 + k * rpp) * a.N + gn;
    if (a.out_f32) {
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(a.out) + idx) =
          make_float4(y[0], y[1], y[2], y[3]);
    } else {
      uint2 o;
      o.x = pack_bf16(y[0], y[1]);
      o.y = pack_bf16(y[2], y[3]);
      *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(a.out) +
                                idx) = o;
    }
  }
}

// One output tile's split, M-tile `mtile` with MT live 16-row M-tiles
// (1-4); grouped, STEPWISE for a group size that is not a multiple of
// KSTEP; ZP adds the zero-point term (per-channel only).
template <bool W4, bool GROUPED, int MT, bool STEPWISE, bool ZP>
__device__ __forceinline__ void gemm_tile(const Args& a, unsigned char* smem,
                                          int mtile) {
  static_assert(!(ZP && GROUPED), "a zero point takes per-channel scales");
  using L = Layout<W4>;
  // the partial tile and the sums of its S copies: int32 (exact), or f32
  using Sum4 = std::conditional_t<GROUPED, float4, int4>;
  const int S = gridDim.z, z = blockIdx.z;   // the cluster is (1, 1, S)
  const int m0 = mtile * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp & 3, wk = warp >> 2;
  const int g = lane >> 2, q = lane & 3;

  // this split's stages: T / S each, one more for the first T % S; grouped,
  // in units of su stages (the last unit may be short)
  const int rows = W4 ? a.K / 2 : a.K;         // stored weight rows
  const int T = (rows + KSTEP - 1) / KSTEP;
  int first, count;
  if constexpr (GROUPED) {
    const int U = (T + a.su - 1) / a.su;
    first = (z * (U / S) + min(z, U % S)) * a.su;
    count = max(0, min((U / S + (z < U % S ? 1 : 0)) * a.su, T - first));
  } else {
    first = z * (T / S) + min(z, T % S);
    count = T / S + (z < T % S ? 1 : 0);
  }
  // this rank's n8 tiles of the output tile (reduction and outlier term)
  const int lo = z * (BN / 8) / S, hi = (z + 1) * (BN / 8) / S;
  __nv_bfloat16* XOs = reinterpret_cast<__nv_bfloat16*>(smem + L::RING);
  __nv_bfloat16* WOs = XOs + BM * O_PITCH;
  const bool has_out = a.xo != nullptr && a.Bo > 0;

  // x_scale of tile row t (t < BM) or w_scale of tile column t - BM
  // (per-channel), and with a zero point x_zero or reduced_w of the same
  // row or column, held through the main loop (their load latency hides
  // there)
  float scale = 0.f, zero = 0.f;
  {
    const int t = threadIdx.x;
    if (t < BM) {
      if (m0 + t < a.M) {
        scale = a.xs[m0 + t];
        if constexpr (ZP) zero = a.xz[m0 + t];
      }
    } else if (!GROUPED && t < BM + BN && n0 + t - BM < a.N) {
      scale = a.ws[n0 + t - BM];
      if constexpr (ZP) zero = a.rw[n0 + t - BM];
    }
  }
  const Loader<W4, MT> ld(a, m0, n0);
  // stages 0..2, a cp.async group each; the outlier tiles join the third,
  // so the first stage's wait does not include them
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < count) ld.issue(smem + i * L::STAGE, (first + i) * KSTEP);
    if (i == STAGES - 2 && has_out)
      load_outliers<MT>(a, XOs, WOs, m0, n0, lo, hi, 0);
    cp_async_commit();
  }

  int acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;
  // grouped: the folded f32 sums. A group size that is a multiple of
  // KSTEP (`aligned`, !STEPWISE: groups end only at stage ends, and the
  // splits and stages are whole groups) folds once per group, after its
  // last stage (`left`: the group's stages still to run), with the scales
  // `sc` loaded at its first. Otherwise each k-step checks: the quad's
  // current group (of stored rows), where it ends, and where the split's
  // rows end. The quad's scale rows: w_scale row hrow + group, columns
  // scol..scol + 7. W4's high quad walks K-rows K/2 + p of its stored rows
  // p: aligned, its groups are those of p offset by hrow = K/2 / gs;
  // step-wise, `kb` = K/2 moves its group bounds into stored rows, so a
  // group size that does not divide K/2 (the tiny gate's down projection:
  // K = 704, gs = 64) has a group across the halves, each part folded by
  // its own quad with that group's scales.
  float facc[GROUPED ? MT : 1][4][4];
  constexpr bool aligned = !STEPWISE;
  int cg = 0, gend = 0, lim = 0, left = 0, hrow = 0;
  const int kb = STEPWISE && W4 && wk ? rows : 0;
  const int scol = n0 + 32 * wn + 8 * q;
  Scales sc{};
  if constexpr (GROUPED) {
    hrow = !STEPWISE && W4 && wk ? rows / a.gs : 0;
    left = a.gs / KSTEP;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) facc[mt][j][e] = 0.f;
    cg = (kb + first * KSTEP + (W4 ? 0 : 64 * wk)) / a.gs;
    gend = (cg + 1) * a.gs - kb;
    lim = min((first + count) * KSTEP, rows);
  }

  // the thread's 4 interleaved columns, in the swizzled chunk of its rows
  // (rows 4q..4q+3 have bit 3 = bit 1 of q)
  const int wcol = (32 * wn + 4 * g) ^ ((q & 2) << 4);
  // k32 steps a quad runs a stage: W8 half of them, W4 all (one nibble)
  constexpr int QSTEPS = W4 ? KSTEP / 32 : KSTEP / 64;
  for (int kt = 0; kt < count; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();      // stage kt landed; slot (kt - 1) % STAGES is free
    const int nk = kt + STAGES - 1;
    if (nk < count)
      ld.issue(smem + (nk % STAGES) * L::STAGE, (first + nk) * KSTEP);
    cp_async_commit();

    const unsigned char* st = smem + (kt % STAGES) * L::STAGE;
    const int s = (first + kt) * KSTEP;
    if constexpr (GROUPED && aligned) {
      if (left == a.gs / KSTEP)                // a group's first stage
        sc = load_scales(a, hrow + cg, scol);
    }
#pragma unroll
    for (int h2 = 0; h2 < QSTEPS; ++h2) {
      const int ks = W4 ? h2 : wk * QSTEPS + h2;     // this warp's k32 step
      const int acol = (W4 ? KSTEP * wk : 0) + 32 * ks;   // its A columns
      uint32_t b[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned char* p =
            st + L::A_BYTES + (32 * ks + 16 * h + 4 * q) * W_PITCH + wcol;
        uint32_t u[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          u[i] = *reinterpret_cast<const uint32_t*>(p + i * W_PITCH);
          if constexpr (W4) u[i] = nibbles(u[i], 4 * wk);
        }
        transpose4x4(u, b[h]);
      }
      if constexpr (aligned) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t af[4];
          ldmatrix_x4(af, st + (mt * 16 + (lane & 15)) * L::A_PITCH + acol +
                              (lane >> 4) * 16);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_s8(acc[mt][j], af, b[0][j], b[1][j]);
        }
      } else if constexpr (GROUPED) {
        // stored rows [r, r + 32) of this quad; a group that ends at r + 16
        // folds between the step's two k16 halves
        const int r = s + 32 * ks;
        if (r < lim) {
          uint32_t af[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldmatrix_x4(af[mt], st + (mt * 16 + (lane & 15)) * L::A_PITCH +
                                    acol + (lane >> 4) * 16);
          bool done = false;
          if (r + 16 == gend) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                mma_s8_k16(acc[mt][j], af[mt][0], af[mt][1], b[0][j]);
            fold<MT>(acc, facc, load_scales(a, hrow + cg, scol));
            done = gend == lim;
            if (!done) {
              ++cg;
              gend += a.gs;
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  mma_s8_k16(acc[mt][j], af[mt][2], af[mt][3], b[1][j]);
            }
          } else {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                mma_s8(acc[mt][j], af[mt], b[0][j], b[1][j]);
          }
          // the quad's next step: the next 32 rows, or (W8, after its
          // second step) its rows of the next stage
          const int nr = r + 32 + (!W4 && h2 == QSTEPS - 1 ? KSTEP - 64 : 0);
          if (!done && (nr >= gend || nr >= lim)) {
            fold<MT>(acc, facc, load_scales(a, hrow + cg, scol));
            cg = (kb + nr) / a.gs;
            gend = (cg + 1) * a.gs - kb;
          }
        }
      }
    }
    if constexpr (GROUPED && aligned) {
      // fold at the group's last stage
      if (--left == 0 || kt == count - 1) {
        fold<MT>(acc, facc, sc);
        left = a.gs / KSTEP;
        ++cg;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();            // the ring is free: the partial goes there

  // the block's partial: quad 0 + quad 1, in shared memory, and beside it
  // the scales of the tile's rows and columns. Tile j's column n is
  // column 32 wn + 4 n + j, so acc[mt][0..3][e] are 4 adjacent columns:
  // one 16-byte store (the 132-word pitch puts a quarter-warp's stores on
  // 32 distinct banks).
  int* Cs = reinterpret_cast<int*>(smem);
  float* Ss = reinterpret_cast<float*>(smem + PARTIAL);
  if (threadIdx.x < BM + BN) {
    Ss[threadIdx.x] = scale;
    if constexpr (ZP) Ss[BM + BN + threadIdx.x] = zero;
  }
  for (int pass = 1; pass >= 0; --pass) {
    if (wk == pass) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int* c = Cs + (mt * 16 + g + 8 * (e >> 1)) * C_PITCH + wn * 32 +
                   8 * q + 4 * (e & 1);
          if constexpr (GROUPED) {
            float4 v = make_float4(facc[mt][0][e], facc[mt][1][e],
                                   facc[mt][2][e], facc[mt][3][e]);
            float4* cf = reinterpret_cast<float4*>(c);
            if (!pass) {
              const float4 h = *cf;
              v.x = __fadd_rn(v.x, h.x);
              v.y = __fadd_rn(v.y, h.y);
              v.z = __fadd_rn(v.z, h.z);
              v.w = __fadd_rn(v.w, h.w);
            }
            *cf = v;
          } else {
            int4 v = make_int4(acc[mt][0][e], acc[mt][1][e], acc[mt][2][e],
                               acc[mt][3][e]);
            int4* ci = reinterpret_cast<int4*>(c);
            if (!pass) {
              const int4 h = *ci;
              v.x += h.x;
              v.y += h.y;
              v.z += h.z;
              v.w += h.w;
            }
            *ci = v;
          }
        }
    }
    if (pass) __syncthreads();
  }
  if (S > 1) cluster_arrive();  // barrier 1: my partial is in place

  // The outlier term of this rank's share, while the other ranks finish
  // their splits: unit u is M-tile u % MT of n8 tile lo + u / MT, on warp
  // u % 8; its f32 result goes to the staging tile (over the outlier
  // tiles: f32 [BM][Y_PITCH], the share's results before the epilogue).
  float* Ys = reinterpret_cast<float*>(smem + L::RING);
  if (has_out) {
    constexpr int MAX_UNITS = 2 * MT;          // a warp's units at S = 1
    const int units = MT * (hi - lo);
    float o[MAX_UNITS][4];
#pragma unroll
    for (int i = 0; i < MAX_UNITS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
    for (int c0 = 0; c0 < a.Bo; c0 += OB) {    // channel chunks of 128
      if (c0 > 0) {
        __syncthreads();      // every warp is done with the last chunk
        load_outliers<MT>(a, XOs, WOs, m0, n0, lo, hi, c0);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      const int kbs = min(OB, a.Bo - c0) / 16;
#pragma unroll
      for (int i = 0; i < MAX_UNITS; ++i) {
        const int u = warp + 8 * i;
        if (u < units) {
          const int mt = u % MT, nt = lo + u / MT;
          for (int kb = 0; kb < kbs; ++kb) {
            uint32_t af[4], b0, b1;
            ldmatrix_x4(af, XOs + (mt * 16 + (lane & 15)) * O_PITCH +
                                kb * 16 + (lane >> 4) * 8);
            ldmatrix_x2_trans(b0, b1,
                              WOs + (kb * 16 + (lane & 15)) * O_PITCH +
                                  nt * 8);
            mma_bf16(o[i], af, b0, b1);
          }
        }
      }
    }
    __syncthreads();          // every warp is past the outlier tiles
#pragma unroll
    for (int i = 0; i < MAX_UNITS; ++i) {
      const int u = warp + 8 * i;
      if (u < units) {
        float* y = Ys + ((u % MT) * 16 + g) * Y_PITCH + (lo + u / MT) * 8 +
                   2 * q;
        *reinterpret_cast<float2*>(y) = make_float2(o[i][0], o[i][1]);
        *reinterpret_cast<float2*>(y + 8 * Y_PITCH) =
            make_float2(o[i][2], o[i][3]);
      }
    }
  }
  __syncthreads();            // the staging tile (and at S = 1 the partial)
  if (S > 1) cluster_wait();  // every rank's partial is in place

  // Rank z's share, 4 columns a thread: chunk k of this thread is row
  // r0 + k * rpp, columns [c, c + 4). The S partials of each chunk summed
  // (int32, exact; grouped f32 in rank order) through distributed shared
  // memory, rank by rank with all the thread's chunks in flight; then
  // scaled in JAX's order (per-channel: converted once), plus the outlier
  // term, into the staging tile; then, the peers' tiles released, the
  // epilogue and the store.
  constexpr int MAX_CHUNKS = 2 * MT;           // a thread's chunks at S = 1
  const int cols4 = (hi - lo) * 2;             // 4-column chunks a row
  const int rpp = THREADS / cols4;             // rows a pass
  const int r0 = threadIdx.x / cols4, c = lo * 8 + (threadIdx.x % cols4) * 4;
  const int live = min(MT * 16, a.M - m0);
  const int nk = threadIdx.x < rpp * cols4 && r0 < live
                     ? (live - r0 + rpp - 1) / rpp : 0;
  // chunk k's sum of partials, scaled, plus the outlier term, into the
  // staging tile
  auto stage = [&](int k, const Sum4& sum) {
    const int r = r0 + k * rpp;
    const float xsv = Ss[r];
    float4* y = reinterpret_cast<float4*>(Ys + r * Y_PITCH + c);
    float4 v;
    if constexpr (GROUPED) {
      v = make_float4(__fmul_rn(sum.x, xsv), __fmul_rn(sum.y, xsv),
                      __fmul_rn(sum.z, xsv), __fmul_rn(sum.w, xsv));
    } else if constexpr (ZP) {
      // (x_scale * w_scale) * (acc + x_zero * reduced_w)
      const float4 wsv = *reinterpret_cast<const float4*>(Ss + BM + c);
      const float xzv = Ss[BM + BN + r];
      const float4 rwv =
          *reinterpret_cast<const float4*>(Ss + 2 * BM + BN + c);
      v = make_float4(
          __fmul_rn(__fmul_rn(xsv, wsv.x),
                    __fadd_rn((float)sum.x, __fmul_rn(xzv, rwv.x))),
          __fmul_rn(__fmul_rn(xsv, wsv.y),
                    __fadd_rn((float)sum.y, __fmul_rn(xzv, rwv.y))),
          __fmul_rn(__fmul_rn(xsv, wsv.z),
                    __fadd_rn((float)sum.z, __fmul_rn(xzv, rwv.z))),
          __fmul_rn(__fmul_rn(xsv, wsv.w),
                    __fadd_rn((float)sum.w, __fmul_rn(xzv, rwv.w))));
    } else {
      const float4 wsv = *reinterpret_cast<const float4*>(Ss + BM + c);
      v = make_float4(__fmul_rn(__fmul_rn((float)sum.x, xsv), wsv.x),
                      __fmul_rn(__fmul_rn((float)sum.y, xsv), wsv.y),
                      __fmul_rn(__fmul_rn((float)sum.z, xsv), wsv.z),
                      __fmul_rn(__fmul_rn((float)sum.w, xsv), wsv.w));
    }
    if (has_out) {
      const float4 o = *y;
      v.x = __fadd_rn(v.x, o.x);
      v.y = __fadd_rn(v.y, o.y);
      v.z = __fadd_rn(v.z, o.z);
      v.w = __fadd_rn(v.w, o.w);
    }
    *y = v;
  };
  const int* mine = Cs + r0 * C_PITCH + c;
  if (S == 1) {
#pragma unroll
    for (int k = 0; k < MAX_CHUNKS; ++k)
      if (k < nk)
        stage(k, *reinterpret_cast<const Sum4*>(mine + k * rpp * C_PITCH));
  } else {
    // S > 1 leaves a thread at most 4 chunks. Predicated loads keep four
    // ranks' loads in flight at once (a branch per load would wait on
    // each; all eight ranks unrolled spill at two blocks an SM's 128
    // registers).
    constexpr int KS = MAX_CHUNKS < 4 ? MAX_CHUNKS : 4;
    Sum4 sum[KS];
#pragma unroll
    for (int k = 0; k < KS; ++k) sum[k] = Sum4{0, 0, 0, 0};
    const uint32_t at = (uint32_t)__cvta_generic_to_shared(mine);
#pragma unroll 4
    for (int p = 0; p < MAX_SPLITS; ++p) {
      const uint32_t base = map_rank(at, p < S ? p : 0);
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const int4 v = ld_cluster_if(p < S && k < nk,
                                     base + k * rpp * C_PITCH * 4);
        if constexpr (GROUPED) {       // ranks in order; a 0 adds nothing
          sum[k].x = __fadd_rn(sum[k].x, __int_as_float(v.x));
          sum[k].y = __fadd_rn(sum[k].y, __int_as_float(v.y));
          sum[k].z = __fadd_rn(sum[k].z, __int_as_float(v.z));
          sum[k].w = __fadd_rn(sum[k].w, __int_as_float(v.w));
        } else {
          sum[k].x += v.x;
          sum[k].y += v.y;
          sum[k].z += v.z;
          sum[k].w += v.w;
        }
      }
    }
    cluster_arrive();         // barrier 2: done reading the peers' tiles
#pragma unroll
    for (int k = 0; k < KS; ++k)
      if (k < nk) stage(k, sum[k]);
  }
  if (n0 + c < a.N) {
    // one branch a block: an epilogue switched per element is if-converted,
    // and every element would pay for expf, erfcf and tanhf
    const int gm0 = m0 + r0, gn = n0 + c;
    switch (a.fuse) {
      case mixq::kSilu:
        finish<mixq::kSilu>(a, Ys, gm0, r0, rpp, nk, gn, c);
        break;
      case mixq::kGelu:
        finish<mixq::kGelu>(a, Ys, gm0, r0, rpp, nk, gn, c);
        break;
      case mixq::kGeluNew:
        finish<mixq::kGeluNew>(a, Ys, gm0, r0, rpp, nk, gn, c);
        break;
      default:
        finish<mixq::kNone>(a, Ys, gm0, r0, rpp, nk, gn, c);
    }
  }
  if (S > 1) cluster_wait();  // the peers are done reading my tile
}

template <bool W4, bool GROUPED, bool STEPWISE, bool ZP = false>
__device__ __forceinline__ void gemm_tiles(const Args& a, unsigned char* smem,
                                           int mtile) {
  switch (min(BM, a.M - mtile * BM + 15) / 16) {
    case 1: gemm_tile<W4, GROUPED, 1, STEPWISE, ZP>(a, smem, mtile); break;
    case 2: gemm_tile<W4, GROUPED, 2, STEPWISE, ZP>(a, smem, mtile); break;
    case 3: gemm_tile<W4, GROUPED, 3, STEPWISE, ZP>(a, smem, mtile); break;
    default: gemm_tile<W4, GROUPED, 4, STEPWISE, ZP>(a, smem, mtile); break;
  }
}

template <bool W4, bool GROUPED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
mix_gemm_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  // the step-wise fold's code kept out of the loop of group sizes that
  // are multiples of KSTEP (with it there, that loop measured slower);
  // W4 groups that do not divide K/2 go step-wise too
  if constexpr (GROUPED) {
    if (a.gs % KSTEP || (W4 && (a.K / 2) % a.gs)) {
      gemm_tiles<W4, true, true>(a, smem, blockIdx.y);
      return;
    }
  }
  gemm_tiles<W4, GROUPED, false>(a, smem, blockIdx.y);
}

// QUIK: the per-channel kernel with the zero-point term
template <bool W4>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
mix_gemm_zp_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  gemm_tiles<W4, false, false, true>(a, smem, blockIdx.y);
}

// The expert-batched W8A8 mode (MoE): E per-channel W8 products in one
// launch, y[e] = float(q_x[e] @ w[e]) * x_scale[e] * w_scale[e] into f32
// out[e]. Args hold expert 0's operands and one expert's M = C rows; the
// grid's y axis is E x M-tiles, expert-major, and each block moves the
// operands to its expert's slices (q_x [E, C, K], w [E, K, N], x_scale
// [E, C], w_scale [E, N], out [E, C, N]) before running kernel 2's tile.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
mix_gemm_experts_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m_tiles = (a.M + BM - 1) / BM;
  const int e = blockIdx.y / m_tiles;
  Args b = a;
  b.qx += (size_t)e * a.M * a.K;
  b.w += (size_t)e * a.K * a.N;
  b.xs += (size_t)e * a.M;
  b.ws += (size_t)e * a.N;
  b.out = reinterpret_cast<float*>(a.out) + (size_t)e * a.M * a.N;
  gemm_tiles<false, false, false>(b, smem, blockIdx.y - e * m_tiles);
}

using KernelFn = void (*)(const Args);

template <bool W4, bool GROUPED, bool ZP, bool EXPERTS = false>
KernelFn kernel_fn() {
  if constexpr (EXPERTS)
    return mix_gemm_experts_kernel;
  else if constexpr (ZP)
    return mix_gemm_zp_kernel<W4>;
  else
    return mix_gemm_kernel<W4, GROUPED>;
}

template <bool W4, bool GROUPED, bool ZP, bool EXPERTS = false>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                      int S) {
  static unsigned long long smem_set = 0;   // per instantiation and device
  constexpr int smem = Layout<W4>::SMEM;
  cudaError_t e = mixq::allow_smem(kernel_fn<W4, GROUPED, ZP, EXPERTS>(),
                                   smem, smem_set);
  if (e != cudaSuccess) return e;
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

// E: the experts of the expert-batched mode (grid y = E x M-tiles)
template <bool W4, bool GROUPED, bool ZP = false, bool EXPERTS = false>
int launch(const Args& a, int S, cudaStream_t stream, int E = 1) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t e = configure<W4, GROUPED, ZP, EXPERTS>(cfg, attr, S);
  if (e != cudaSuccess) return (int)e;
  cfg.gridDim = dim3((a.N + BN - 1) / BN, E * ((a.M + BM - 1) / BM), S);
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, kernel_fn<W4, GROUPED, ZP, EXPERTS>(), a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool W4, bool GROUPED, bool ZP = false, bool EXPERTS = false>
int max_clusters(int S, int* n) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t e = configure<W4, GROUPED, ZP, EXPERTS>(cfg, attr, S);
  if (e != cudaSuccess) return (int)e;
  cfg.gridDim = dim3(1, 1, S);
  return (int)cudaOccupancyMaxActiveClusters(
      n, kernel_fn<W4, GROUPED, ZP, EXPERTS>(), &cfg);
}

int gcd(int x, int y) { return y ? gcd(y, x % y) : x; }

}  // namespace

// w4: the weight is packed uint8 [K/2, N]; G > 1: w_scale is [G, N];
// fuse: the epilogue's code (mixq::Epilogue, csrc/epilogue.cuh); splits: S,
// the split-K factor of kernels/mix_gemm.py::plan_mix (the cluster size);
// xz, rw: x_zero [M] and reduced_w [N] (QUIK's zero point, G = 1), or both
// null.
extern "C" int mix_gemm_launch(const void* qx, const void* w, const void* xs,
                               const void* ws, const void* xo, const void* wo,
                               void* out, const void* xz, const void* rw,
                               int M, int N, int K, int Bo, int G, int w4,
                               int fuse, int out_f32, int splits,
                               void* stream) {
  if (splits < 1 || splits > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  if ((xz == nullptr) != (rw == nullptr) || (xz && G > 1))
    return (int)cudaErrorInvalidValue;
  const int gs = G > 1 ? K / G : K;
  // grouped: a split unit is lcm(KSTEP, gs) stored rows
  const Args a{(const int8_t*)qx, (const int8_t*)w, (const float*)xs,
               (const float*)ws, (const __nv_bfloat16*)xo,
               (const __nv_bfloat16*)wo, out, M, N, K, xo ? Bo : 0, fuse,
               out_f32, gs, G > 1 ? gs / gcd(KSTEP, gs) : 1,
               (const float*)xz, (const float*)rw};
  cudaStream_t st = (cudaStream_t)stream;
  if (xz)
    return w4 ? launch<true, false, true>(a, splits, st)
              : launch<false, false, true>(a, splits, st);
  if (w4)
    return G > 1 ? launch<true, true>(a, splits, st)
                 : launch<true, false>(a, splits, st);
  return G > 1 ? launch<false, true>(a, splits, st)
               : launch<false, false>(a, splits, st);
}

// How many clusters of `splits` blocks of one weight mode fit on the card
// at once (cudaOccupancyMaxActiveClusters) into *n; returns the CUDA error.
extern "C" int mix_gemm_max_active_clusters(int splits, int w4, int grouped,
                                            int* n) {
  if (w4)
    return grouped ? max_clusters<true, true>(splits, n)
                   : max_clusters<true, false>(splits, n);
  return grouped ? max_clusters<false, true>(splits, n)
                 : max_clusters<false, false>(splits, n);
}

// The same for the zero-point kernel of one weight mode.
extern "C" int mix_gemm_zp_max_active_clusters(int splits, int w4, int* n) {
  return w4 ? max_clusters<true, false, true>(splits, n)
            : max_clusters<false, false, true>(splits, n);
}

// The expert-batched W8A8 mode: qx int8 [E, C, K], w int8 [E, K, N], xs f32
// [E, C], ws f32 [E, N] into out f32 [E, C, N], one launch of E x M-tiles x
// N-tiles output tiles, each split S ways (plan_mix with `experts`).
extern "C" int mix_gemm_experts_launch(const void* qx, const void* w,
                                       const void* xs, const void* ws,
                                       void* out, int E, int C, int N, int K,
                                       int splits, void* stream) {
  if (splits < 1 || splits > MAX_SPLITS || E < 1 || C < 1 ||
      (long long)E * ((C + BM - 1) / BM) > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{(const int8_t*)qx, (const int8_t*)w, (const float*)xs,
               (const float*)ws, nullptr, nullptr, out, C, N, K, 0,
               mixq::kNone, 1, K, 1, nullptr, nullptr};
  return launch<false, false, false, true>(a, splits, (cudaStream_t)stream,
                                           E);
}

// The same count for the expert-batched kernel.
extern "C" int mix_gemm_experts_max_active_clusters(int splits, int* n) {
  return max_clusters<false, false, false, true>(splits, n);
}
