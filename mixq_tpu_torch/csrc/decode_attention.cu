// T=1 decode attention over one layer of a batch-major KV cache
// [B, S, n_kv, D] (bf16, or int8 with per-(token, head) f32 scales
// [B, S, n_kv]), with per-row valid lengths and first valid positions, GQA
// groups of g query heads per kv head (g = 1, 2, 4, 8 in every mode; 3, 5,
// 6, 7 and any g past 8 without the softcap), an optional ring layout
// (sliding-window caches), gemma2's score scale and logit softcap, and
// Baichuan-13B's ALiBi bias.
//
// Replaces: mixq_tpu/ops/pallas/decode_attention.py::decode_attention, and
// with it `attend` over a batch-major cache at T=1 (mixq_tpu/models/
// layers.py), whose recipe it is:
//   s = (sum_d f32(q) * f32(k)) * scale [* k_scale]; [softcap] s =
//   tanh(s / cap) * cap; [ALiBi] s = s + slope_h * f32(p - q_pos);
//   masked slots s = -1e30; p = softmax(s) [* v_scale]; o = sum_s p *
//   f32(v)
// all in f32 (K and V widened, nothing quantized), rounded once to bf16.
// ALiBi is `attend`'s relative form: p is the absolute position (the
// kernel walks positions, on a ring too) and q_pos = len - 1, the query's;
// the bias is rounded as the plain version rounds it, a multiply then an
// add (__fmul_rn, __fadd_rn: no contraction into an fma). It goes into the
// score where the score is formed, before any max; the softcap is applied
// later to the raw scores (the cap is monotone), so the two together would
// need the cap moved before the max: the wrapper refuses that pair, which
// no ported family has. The slopes are a runtime pointer (null: none), so
// ALiBi adds no instantiation.
//
// Valid positions are [lo, hi): hi = len (non-ring: min(len, S)), lo =
// max(start, 0) and, for a ring, also len - S. A ring keeps position p in
// slot p % S; the kernel walks positions, never slots: it divides once, for
// its part's first slot, and advances the slot from there (a part is
// shorter than S, so it wraps at most once). The plain version's slot ->
// position map gives the same set. A row with no valid position gets JAX's
// answer: every score is masked to the same -1e30, so the softmax is
// uniform over all S slots; the kernel then takes every slot with score 0.
//
// Bound on the card: bytes, the valid K and V rows and their scales (~50 MB
// a layer at Mistral-7B's heads, 32/8, D=128, int8, B=64). What held the
// earlier kernel (one block of 4 warps per (kv head, batch row) walking the
// whole row) far from it was its per-block chain of dependent memory round
// trips (the k scale loaded after its dot, v_scale and V only after the
// softmax's barriers, two rows in flight a lane), a butterfly per (row,
// head) dot, a divide per ring load, int8 -> f32 conversions as costly as
// the bytes, 158 registers, and too few stripes on the B=16 ring to fill
// the card. What the design does about each:
// - A row's positions split over a thread-block cluster of R = 1, 2, 4 or 8
//   blocks (grid (R, n_kv, B); R from kernels/decode_attention.py::
//   plan_decode on static shapes, R = 1 where the stripes fill the card):
//   rank r takes a contiguous part [lo, hi) of the valid positions, cut at
//   run time in units of kUnit positions (mixq::rank_part), keeps an online
//   softmax over tiles of its part, and the ranks merge (m, l, acc) through
//   DSMEM in rank order: M = max m_r, w_r = exp(m_r - M) (0 outright for
//   an empty rank), o = sum w_r acc_r / sum w_r l_r.
// - Both dots on bf16 tensor cores (mma.sync.m16n8k16, f32 accumulators),
//   so the tensor core sums each dot over the lanes and no shuffle does.
//   int8 is exact in bf16 and a bf16 x bf16 product exact in f32, so q . k
//   is the widened recipe's dot summed in another order. K and V are
//   widened exactly: a byte permute into the mantissa of 2^23, one f32
//   subtract, and the f32 high halves as bf16 pairs (no conversion
//   instruction). p . v takes p as a bf16 high half plus a bf16 low half
//   (2^-17 of p; p rounded to bf16 alone would not be the recipe). Each
//   warp keeps two q . k chains (even and odd k16 steps).
//   q . k: A = q (the g heads as rows, fragments in shared memory, copied
//   by cp.async with the first stage), B = 8 K rows, C = 8 positions'
//   scores of each head.
//   p . v: A = V rows transposed (16 head-dim values x 16 positions, from
//   shared memory), B = p (16 positions x the g heads), C = o^T, 32 f32 a
//   lane for a 128-value slice of the head dim.
// - The latency chain: K and V rows stream through a ring of kStages
//   stages in shared memory filled by cp.async (16 bytes a lane a copy,
//   neighbouring lanes on neighbouring bytes), one stage kStages - 1 ahead
//   of the one in use, in the order K stages of a tile, then its V stages:
//   so a tile's V rows are in flight while its K rows are scored and its
//   softmax taken, and the next tile's K rows while its V rows are summed.
//   Each stage's k or v scales come by cp.async with its rows. One barrier
//   a stage; rows a lane has in flight: every stage ahead (16 B copies,
//   4 a lane a stage at Mistral's heads, 3 stages ahead; bf16: 8 a lane
//   a stage, 1 stage ahead). The ring slot of
//   a position is advanced from the part's first slot, never divided.
// - The softmax's per-(head, position) work (the cap's tanh, exp, v_scale)
//   runs on every lane of a warp, not only on the lanes that hold a head's
//   B fragment: the scores stay raw until then (the cap is monotone, so the
//   capped max is the cap of the raw max), and each lane takes 16 * g / 32
//   of its warp's group before the fragments are read back.
// - Shared-memory reads are conflict-free: a row's 16-byte chunks are
//   swizzled (swz) so that the K reads (two rows, four chunks) and the V
//   reads (four rows, two chunks) of each 8-lane phase hit distinct banks.
// - A row whose 16-byte chunks are not a power of two (D = 96: 6 int8 or
//   12 bf16 chunks) takes the next power of two of chunks in the ring
//   (mixq::pow2_chunks), so the copies, the swizzle and the slices stay
//   shifts and masks; the chunks past the row are neither copied nor read
//   (the dots and p . v take zeros there), and the output skips their
//   values.
// - g need not be a power of two: the mma tiles hold up to 8 heads (rows
//   and columns past g are zeros), a tile of scores holds a multiple of 64
//   positions, and the softmax's per-(head, position) shares cover 16 * g
//   entries in ceil(g / 2) rounds of 32 lanes.
// - At most 128 registers (no spill; chip_smoke.py's build phase prints
//   them) and under 48 KB of shared memory at the served heads: 4 blocks
//   an SM.
// - A group past 8 (Falcon-7B's 71 heads on one kv head, StarCoder2's 9,
//   ChatGLM3's 16) is cut into T = ceil(g / 8) head tiles of G = ceil(g /
//   T) heads (71: 9 tiles of 8, the last with 7; 9: 5 + 4), each a block
//   (a cluster of R) of the G <= 8 code on a grid axis beside the kv head,
//   so a stripe's tiles run together and L2 serves their re-reads; heads
//   of a tile past the group load a zero q, take no slope and write
//   nothing. No register or shared array is sized by g, and a large group
//   adds no instantiation.
// Launch: grid (R, n_kv * T, B), cluster (R, 1, 1), block 128, dynamic shared
// memory smem_bytes<G, kInt8>(D) (exported: decode_attention_smem_bytes),
// its limit set once per device (mixq::allow_smem). The launcher returns
// the CUDA error; it allocates nothing and does not synchronize.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "cp_async.cuh"
#include "launch.cuh"

namespace {

constexpr int kThreads = 128, kWarps = kThreads / 32, kMaxSplits = 8;
// positions of the rank cut (one V group: 16 rows)
constexpr int kUnit = 16;
// head-dim values of one warp's p . v accumulators
constexpr int kSlice = 128;
// dynamic shared memory a block may take: the card's 227 KB less room for
// the kernel's static shared memory (under 3 KB)
constexpr int kSmemMax = 224 * 1024;

// stages of the cp.async ring: int8, 4 of 8 KB; bf16, 2 of 16 KB, which
// leaves room for 4 blocks an SM (3 stages left room for 3, and ran the
// decode step's rows slower on the H100)
template <bool kInt8>
__host__ __device__ constexpr int stages() {
  return kInt8 ? 4 : 2;
}
// positions a tile of scores holds (f32 scores of the g heads: 4-8 KB), a
// multiple of every stage's positions (64 or 32)
template <int G>
__host__ __device__ constexpr int tile_rows() {
  return G <= 2 ? 1024 : 2048 / G / 64 * 64;
}
// head-dim slices a V row is cut into: one per warp group
__host__ __device__ inline int n_slices(int D) {
  return D > kSlice ? D / kSlice : 1;
}
// positions a stage holds: one V group of 16 for each warp on a slice (K:
// two groups of 8)
__host__ __device__ inline int stage_rows(int D) {
  return 16 * kWarps / n_slices(D);
}
// one stage: its rows, then (int8) their scales
template <bool kInt8>
__host__ __device__ inline int stage_bytes(int D) {
  return stage_rows(D) *
         (16 * mixq::pow2_chunks(D * (kInt8 ? 1 : 2)) + (kInt8 ? 4 : 0));
}
// q's fragments: a k16 step per 4 values of a lane's chunk
template <bool kInt8>
__host__ __device__ inline int q_steps(int D) {
  const int chunks = D * (kInt8 ? 1 : 2) / 16;
  return (chunks + 3) / 4 * (kInt8 ? 4 : 2);
}
template <int G, bool kInt8>
__host__ __device__ inline int ring_bytes(int D) {
  const int ring = stages<kInt8>() * stage_bytes<kInt8>(D);
  const int pv_red = kWarps * G * kSlice * 4;   // reuses the ring at the end
  return ring > pv_red ? ring : pv_red;
}
// ring | scores [G, tile_rows] f32 | q fragments [q_steps, 32] uint2 |
// the block's result [G, D] f32
template <int G, bool kInt8>
__host__ __device__ inline int smem_bytes(int D) {
  return ring_bytes<G, kInt8>(D) + G * tile_rows<G>() * 4 +
         q_steps<kInt8>(D) * 32 * 8 + G * D * 4;
}

struct Args {
  const __nv_bfloat16* q;   // [B, n_kv*g, D]
  const char* k;            // [B, S, n_kv, D]
  const char* v;
  const float* ks;          // [B, S, n_kv] or null
  const float* vs;
  const int32_t* lengths;   // [B] or null: length_all
  int length_all;
  const int32_t* starts;    // [B] or null: start_all
  int start_all;
  const float* alibi;       // [n_kv*g] ALiBi slopes or null
  __nv_bfloat16* out;       // [B, n_kv*g, D]
  int S, D, ring;
  float scale, softcap;
  int n_kv, g, tiles;       // kv heads, the group, its head tiles
};

// The head tiles of a group: T = ceil(g / 8) tiles of G = ceil(g / T)
// heads (kernels/flash_decode.py::head_tile)
__host__ __device__ inline int head_tiles(int g) { return (g + 7) / 8; }
__host__ __device__ inline int tile_group(int g) {
  const int t = head_tiles(g);
  return (g + t - 1) / t;
}

// The physical chunk of 16-byte chunk c of stage row r: rows of 8 or more
// chunks XOR the chunk's low bits with row bits 0 and 2-3, so that the K
// reads of an 8-lane phase (rows r, r+1 of an aligned pair, chunks 4i..4i+3)
// and the V reads (rows 4t + k for t = 0..3, chunks 2h, 2h+1) fall on 8
// distinct 16-byte bank groups.
__device__ __forceinline__ int swz(int r, int c, int chunks) {
  return chunks >= 8 ? c ^ (((r & 1) << 2) ^ (((r >> 2) & 3) << 1)) : c;
}

__device__ __forceinline__ uint32_t word(const int4& r, int i) {
  return (uint32_t)(i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w);
}

// One int8 byte of x = w ^ 0x80808080 widened exactly to f32: the byte
// plus 128 goes into the mantissa of 2^23, and 2^23 + 128 comes off.
__device__ __forceinline__ float s8_f32(uint32_t x, int byte) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 | byte)) -
         8388736.f;
}
// {bf16(lo), bf16(hi)} of two f32 that bf16 holds exactly (small
// integers): their high halves
__device__ __forceinline__ uint32_t hi_halves(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
// {bf16(lo), bf16(hi)}, each rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// C += A B on bf16 tensor cores, f32 accumulators (m16n8k16)
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// A K row's B fragment for one k16 step: the 4 head-dim values of unit u
// of the lane's 16-byte chunk, {d0, d0+1} and {d0+2, d0+3} as bf16 pairs
template <bool kInt8>
__device__ __forceinline__ void k_frag(const int4& raw, int u, uint32_t& b0,
                                       uint32_t& b1) {
  if constexpr (kInt8) {
    const uint32_t x = word(raw, u) ^ 0x80808080u;
    b0 = hi_halves(s8_f32(x, 0), s8_f32(x, 1));
    b1 = hi_halves(s8_f32(x, 2), s8_f32(x, 3));
  } else {
    b0 = word(raw, 2 * u);
    b1 = word(raw, 2 * u + 1);
  }
}

// The walk over a rank's part: tiles of tile_rows positions, each first as
// its K stages, then as its V stages, stage_rows positions a stage.
struct Cursor {
  int t0, tn, nst, kind, idx;   // tile start, its positions, its stages a
                                // kind, kind (0: K, 1: V), stage in kind
  __device__ void start(int lo, int hi, int T, int P) {
    t0 = lo;
    tn = min(T, hi - lo);
    nst = (tn + P - 1) / P;
    kind = idx = 0;
  }
  __device__ void advance(int hi, int T, int P) {
    if (++idx < nst) return;
    idx = 0;
    if (kind == 0) {
      kind = 1;
      return;
    }
    start(t0 + T, hi, T, P);
  }
};

template <int G, bool kInt8, bool kSoftcap>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Args a) {
  constexpr int esize = kInt8 ? 1 : 2, E = 16 / esize, U = E / 4;
  constexpr int NS = stages<kInt8>(), T = tile_rows<G>();
  const float kNegInf = __int_as_float(0xff800000);
  extern __shared__ __align__(16) unsigned char smem[];
  // a cache row: rb bytes, `chunks` chunks; a ring row: rbs bytes, cpad
  // chunks (a power of two)
  const int D = a.D, S = a.S, rb = D * esize, chunks = rb / 16;
  const int cpad = mixq::pow2_chunks(rb), rbs = 16 * cpad;
  const int cshift = __ffs(cpad) - 1;
  const int slices = n_slices(D), P = stage_rows(D);
  const int KC = q_steps<kInt8>(D), iters = KC / U;
  unsigned char* ring = smem;
  float* pv_red = reinterpret_cast<float*>(smem);       // after the walk
  float* sc = reinterpret_cast<float*>(smem + ring_bytes<G, kInt8>(D));
  uint2* qf = reinterpret_cast<uint2*>(sc + G * T);     // [KC][32]
  float* res = reinterpret_cast<float*>(qf + KC * 32);  // [G][D]
  __shared__ float red[kWarps * 8], lred[kWarps * 8];   // by warp and head
  __shared__ float cl_m[G], cl_l[G];                    // read by the peers
  __shared__ float s_w[kMaxSplits * G], s_l[G];
  __shared__ __align__(16) float pwarp[kWarps * 16 * 8];  // each warp's p

  // the cluster is (R, 1, 1) and the grid (R, n_kv * T, B): rank =
  // blockIdx.x; this block's heads h0 .. h0 + gv - 1 of kv head hk
  // (a group past 8 runs in tiles of G >= 5 heads, so the instantiations
  // of G <= 4 keep their one tile at compile time)
  constexpr bool kTiled = G >= 5;
  const int R = gridDim.x, rank = blockIdx.x, b = blockIdx.z, n_kv = a.n_kv;
  const int hk = kTiled ? blockIdx.y / a.tiles : blockIdx.y;
  const int gs = kTiled ? a.g : G;                          // the group
  const int h0 = kTiled ? (blockIdx.y - hk * a.tiles) * G : 0;
  const int gv = kTiled ? min(G, gs - h0) : G;
  const int hrow = hk * gs + h0;      // the tile's first head in its row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = lane >> 2, t = lane & 3;   // mma group and thread in it

  // ---- the row's valid positions and this rank's part of them
  const int len = a.lengths ? a.lengths[b] : a.length_all;
  const int st = a.starts ? a.starts[b] : a.start_all;
  int hi = a.ring ? len : min(len, S);
  int lo = max(st, 0);
  if (a.ring) lo = max(lo, len - S);
  const bool uniform = hi <= lo;                        // no valid position
  if (uniform) {
    lo = 0;
    hi = S;
  }
  const int2 part = mixq::rank_part(lo, hi, kUnit, R, rank);
  const int p_lo = part.x, p_hi = part.y;
  // the part's first slot (positions >= 0 here): the one division
  const int slot0 = a.ring && !uniform ? p_lo % S : p_lo;
  const size_t pos_bytes = (size_t)n_kv * rb;           // position stride
  const size_t stripe = (size_t)b * S * n_kv + hk;      // (row, kv head)
  const char* kbase = a.k + stripe * rb;
  const char* vbase = a.v + stripe * rb;
  const float* ksb = kInt8 ? a.ks + stripe : nullptr;
  const float* vsb = kInt8 ? a.vs + stripe : nullptr;

  const int sl = warp % slices;            // this warp's head-dim slice
  const int sbytes = stage_bytes<kInt8>(D);
  auto slot_of = [&](int p) {            // p in the part: wraps at most once
    const int s = slot0 + (p - p_lo);
    return s >= S ? s - S : s;
  };
  // Copies the stage at cursor c (nothing past the part) into ring slot s:
  // its rows (zeros past the tile) and, int8, their scales; one commit
  // group a call, empty or not.
  // this thread's copies of a stage: rows rt + k * rstep, chunk ch (the
  // row's swizzled chunk is the same for every k when rstep % 16 == 0);
  // none for a chunk past the row
  const int ch = tid & (cpad - 1), rt = tid >> cshift;
  const int rstep = kThreads >> cshift, ncopy = (P * cpad) / kThreads;
  auto fetch = [&](const Cursor& c, int s) {
    if (c.t0 < p_hi) {
      unsigned char* dst = ring + s * sbytes;
      const int r0 = c.t0 + c.idx * P, end = c.t0 + c.tn;
      const char* src = (c.kind ? vbase : kbase) + 16 * ch;
      if (ch < chunks) {
        if (ncopy == 0) {               // a stage of fewer chunks than lanes
          if (rt < P) {
            const int p = r0 + rt;
            const bool ok = p < end;
            mixq::cp_async16(dst + rt * rbs + 16 * swz(rt, ch, cpad),
                             ok ? src + slot_of(p) * pos_bytes : src, ok);
          }
        }
        for (int k = 0; k < ncopy; ++k) {
          const int r = rt + k * rstep, p = r0 + r;
          const bool ok = p < end;
          mixq::cp_async16(dst + r * rbs + 16 * swz(r, ch, cpad),
                           ok ? src + slot_of(p) * pos_bytes : src, ok);
        }
      }
      if constexpr (kInt8) {
        if (tid < P) {
          float* sdst = reinterpret_cast<float*>(dst + P * rbs);
          const float* ssrc = c.kind ? vsb : ksb;
          const int p = r0 + tid;
          const bool ok = p < end;
          mixq::cp_async4(sdst + tid,
                          ok ? ssrc + (size_t)slot_of(p) * n_kv : ssrc, ok);
        }
      }
    }
    mixq::cp_async_commit();
  };

  // q's A fragments, [k16 step][lane]: head j's values {d0, d0+1} and
  // {d0+2, d0+3} of unit u of chunk t + 4i (zeros past the tile's heads
  // in the group or the row), by cp.async in the first commit group
  const __nv_bfloat16* qg = a.q + ((size_t)b * n_kv * gs + hrow) * D;
  for (int f = tid; f < KC * 32; f += kThreads) {
    const int kc = f >> 5, ln = f & 31, jj = ln >> 2;
    const int ch = (ln & 3) + 4 * (kc / U), u = kc % U;
    const bool ok = jj < gv && ch < chunks;
    mixq::cp_async8(qf + f, ok ? qg + jj * D + ch * E + 4 * u : qg, ok);
  }
  Cursor ic, cc;                                    // fetch and use
  ic.start(p_lo, p_hi, T, P);
  cc = ic;
  for (int s = 0; s < NS - 1; ++s) {
    fetch(ic, s);
    if (ic.t0 < p_hi) ic.advance(p_hi, T, P);
  }

  // the online softmax: the running max of head j (this lane's scores
  // and l) and of heads 2t, 2t+1 (its p . v columns); -inf before the first
  // tile, and for an empty part to the end
  // The softmax's per-(head, position) work (the cap, exp, v_scale) runs
  // on every lane: a warp's V group is 16 positions x G heads, lane L takes
  // entries L + 32r (r < NR; none past 16 G): head hr(r) = (L + 32r) / 16.
  // Scores stay raw (scale and k_scale applied) until then; the cap is
  // monotone, so the capped max is the cap of the raw max.
  constexpr int NR = (G + 1) / 2;
  auto capped = [&](float x) {
    if constexpr (kSoftcap)
      return __fmul_rn(tanhf(__fdiv_rn(x, a.softcap)), a.softcap);
    else
      return x;
  };
  // raw running maxima: heads hr(r) (this lane's l and p) and 2t, 2t+1 (its
  // p . v columns); -inf before the first tile, and for an empty part
  float mr[NR], mc[NR], lsum[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    mr[r] = kNegInf;
    mc[r] = kNegInf;
    lsum[r] = 0.f;
  }
  float m0 = kNegInf, m1 = kNegInf, tmax = kNegInf;
  float acc[8][4];
#pragma unroll
  for (int mt = 0; mt < 8; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;

  int xs = 0, is = NS - 1;                          // slots: use, refill
  while (cc.t0 < p_hi) {
    mixq::cp_async_wait<NS - 2>();
    __syncthreads();             // stage in slot xs landed; xs - 1 is free
    fetch(ic, is);
    if (ic.t0 < p_hi) ic.advance(p_hi, T, P);
    is = is + 1 == NS ? 0 : is + 1;

    const unsigned char* rows = ring + xs * sbytes;
    const float* sscale = reinterpret_cast<const float*>(rows + P * rbs);
    const int r0 = cc.t0 + cc.idx * P, end = cc.t0 + cc.tn;
    if (cc.kind == 0) {
      // ---- K: the scores of 8 positions a group, head j's at 2t, 2t+1
      if (cc.idx == 0) tmax = kNegInf;
#pragma unroll
      for (int gi = 0; gi < 2; ++gi) {
        const int grp = warp + gi * kWarps;
        if (grp >= P / 8) continue;
        // two accumulators (even and odd k16 steps): two mma chains
        float c4[4] = {0.f, 0.f, 0.f, 0.f}, c5[4] = {0.f, 0.f, 0.f, 0.f};
        const int r = grp * 8 + j;
// (bf16: rolled, or the softcap's g = 4 instantiation spills)
#pragma unroll (kInt8 ? 2 : 1)
        for (int i = 0; i < iters; ++i) {
          const int ch = t + 4 * i;
          int4 raw = make_int4(0, 0, 0, 0);
          if (ch < chunks)
            raw = *reinterpret_cast<const int4*>(rows + r * rbs +
                                                 16 * swz(r, ch, cpad));
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const uint2 qa = qf[(i * U + u) * 32 + lane];
            uint32_t b0, b1;
            k_frag<kInt8>(raw, u, b0, b1);
            if (u & 1)
              mma_bf16(c5, qa.x, 0u, qa.y, 0u, b0, b1);
            else
              mma_bf16(c4, qa.x, 0u, qa.y, 0u, b0, b1);
          }
        }
        c4[0] += c5[0];
        c4[1] += c5[1];
        if (j < G) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int rr = grp * 8 + 2 * t + e, p = r0 + rr;
            float sv = kNegInf;
            if (p < end) {
              sv = __fmul_rn(c4[e], a.scale);
              if constexpr (kInt8)
                sv = __fmul_rn(sv, sscale[rr]);
              if (a.alibi)      // head j's slope; the query at len - 1
                sv = __fadd_rn(sv, __fmul_rn(
                                       j < gv ? a.alibi[hrow + j] : 0.f,
                                       (float)(p - (len - 1))));
              if (uniform) sv = 0.f;
              tmax = fmaxf(tmax, sv);
            }
            sc[j * T + (p - cc.t0)] = sv;
          }
        }
      }
      if (cc.idx == cc.nst - 1) {   // the tile's max of head j, per warp
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        if (t == 0 && j < G) red[warp * 8 + j] = tmax;
      }
    } else {
      // ---- V: a 16-position group of one head-dim slice a warp
      if (cc.idx == 0) {
        // the tile's max over the warps (the same in every lane that keeps
        // a head), the running maxima and the rescale of l and acc
        auto tile_max = [&](int h) {
          float x = red[h];
          for (int w = 1; w < kWarps; ++w) x = fmaxf(x, red[w * 8 + h]);
          return x;
        };
        // alpha = exp(cap(m_old) - cap(m_new)): acc and l are 0 while
        // m_old = -inf, whatever alpha is
        auto update = [&](float& m, int h) {
          if (h >= G) return 1.f;
          const float mn = fmaxf(m, tile_max(h));
          const float alpha = expf(capped(m) - capped(mn));
          m = mn;
          return alpha;
        };
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          lsum[r] *= update(mr[r], (lane + 32 * r) >> 4);
          mc[r] = capped(mr[r]);
        }
        const float a0 = update(m0, 2 * t), a1 = update(m1, 2 * t + 1);
#pragma unroll
        for (int mt = 0; mt < 8; ++mt) {
          acc[mt][0] *= a0;
          acc[mt][1] *= a1;
          acc[mt][2] *= a0;
          acc[mt][3] *= a1;
        }
      }
      // a loop of one trip: the same body as a plain block made ptxas
      // spill 4 bytes in the <8, bf16> instantiation (H100 build of this
      // source; chip_smoke.py's build phase fails on any spill)
      for (int vi = 0; vi < 1; ++vi) {
        const int vgrp = warp / slices + vi * (kWarps / slices);
        const int rv = vgrp * 16 + 4 * t;     // this lane's 4 positions
        // p of the group's 16 positions x G heads (times v_scale), every lane
        // a share, into this warp's pw[head][16]; masked positions p = 0
        float* pw = pwarp + warp * 16 * 8;
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const int idx = lane + 32 * r, h = idx >> 4, q = idx & 15;
          if (idx < 16 * G) {
            const float sv = sc[h * T + (r0 - cc.t0) + vgrp * 16 + q];
            float e = sv > kNegInf ? expf(capped(sv) - mc[r]) : 0.f;
            if (sl == 0) lsum[r] += e;
            if constexpr (kInt8) e = __fmul_rn(e, sscale[vgrp * 16 + q]);
            pw[h * 16 + q] = e;
          }
        }
        __syncwarp();
        // B: head j's p at the lane's 4 rows, high and low halves
        uint32_t bh0 = 0u, bh1 = 0u, bl0 = 0u, bl1 = 0u;
        if (j < G) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(pw + j * 16 + 4 * t);
          const float e[4] = {p4.x, p4.y, p4.z, p4.w};
          bh0 = pack_bf16(e[0], e[1]);
          bh1 = pack_bf16(e[2], e[3]);
          bl0 = pack_bf16(e[0] - bf16_lo(bh0), e[1] - bf16_hi(bh0));
          bl1 = pack_bf16(e[2] - bf16_lo(bh1), e[3] - bf16_hi(bh1));
        }
        // A: the V rows' chunks of this slice that lane group j holds (int8:
        // chunk j, 16 values; bf16: chunk j, then chunk j + 8, 8 values each),
        // m16 tile mt: rows j and j + 8 are head-dim values d and d + 1 of
        // the lane group's chunk, k = 2t, 2t+1 rows rv, rv+1 and k = 2t+8,
        // 2t+9 rows rv+2, rv+3
        constexpr int NH = kInt8 ? 1 : 2, MT = 8 / NH;
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const int ch = sl * (kSlice / E) + j + 8 * h;
          int4 vr[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int r = rv + k;
            vr[k] = ch < chunks ? *reinterpret_cast<const int4*>(
                                      rows + r * rbs + 16 * swz(r, ch, cpad))
                                : make_int4(0, 0, 0, 0);
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int mt = h * MT + m;
            uint32_t a0, a1, a2, a3;
            if constexpr (kInt8) {
              // bytes by, by + 1 (values d, d + 1) of the four rows' words
              const int wi = m >> 1, by = 2 * (m & 1);
              const uint32_t w0 = word(vr[0], wi), w1 = word(vr[1], wi);
              const uint32_t w2 = word(vr[2], wi), w3 = word(vr[3], wi);
              const uint32_t x0 = w0 ^ 0x80808080u, x1 = w1 ^ 0x80808080u;
              const uint32_t x2 = w2 ^ 0x80808080u, x3 = w3 ^ 0x80808080u;
              a0 = hi_halves(s8_f32(x0, by), s8_f32(x1, by));
              a1 = hi_halves(s8_f32(x0, by + 1), s8_f32(x1, by + 1));
              a2 = hi_halves(s8_f32(x2, by), s8_f32(x3, by));
              a3 = hi_halves(s8_f32(x2, by + 1), s8_f32(x3, by + 1));
            } else {
              const uint32_t w0 = word(vr[0], m), w1 = word(vr[1], m);
              const uint32_t w2 = word(vr[2], m), w3 = word(vr[3], m);
              a0 = __byte_perm(w0, w1, 0x5410);
              a1 = __byte_perm(w0, w1, 0x7632);
              a2 = __byte_perm(w2, w3, 0x5410);
              a3 = __byte_perm(w2, w3, 0x7632);
            }
            mma_bf16(acc[mt], a0, a1, a2, a3, bh0, bh1);
            mma_bf16(acc[mt], a0, a1, a2, a3, bl0, bl1);
          }
        }
        __syncwarp();                 // pw is rewritten by the next group
      }
    }
    cc.advance(p_hi, T, P);
    xs = xs + 1 == NS ? 0 : xs + 1;
  }
  mixq::cp_async_wait<0>();
  __syncthreads();                         // the ring is free for pv_red

  // ---- the block's (m, l, acc): l over the lanes and warps in order, the
  // warps' p . v partials of each slice in warp order into res
  // l of head hr over the 16 lanes that hold it; the block's (capped) max,
  // -inf for an empty part
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    float x = lsum[r];
    for (int off = 1; off < 16; off <<= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    const int h = (lane + 32 * r) >> 4;
    if ((lane & 15) == 0 && h < G) {
      lred[warp * 8 + h] = x;
      if (warp == 0) cl_m[h] = mr[r] == kNegInf ? kNegInf : capped(mr[r]);
    }
  }
#pragma unroll
  for (int mt = 0; mt < 8; ++mt) {
    // the slice's value of row j of tile mt (and of row j + 8: d + 1)
    const int d = kInt8 ? 16 * j + 2 * mt
                        : 8 * j + 64 * (mt >> 2) + 2 * (mt & 3);
    if (sl * kSlice + d < D) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = 2 * t + (e & 1);
        if (h < G)
          pv_red[(warp * G + h) * kSlice + d + (e >> 1)] = acc[mt][e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int h = i / D, d = i - h * D;
    const int s = d / kSlice, dd = d % kSlice;
    float x = 0.f;
    for (int w = s; w < kWarps; w += slices)
      x += pv_red[(w * G + h) * kSlice + dd];
    res[i] = x;
  }
  if (tid < G) {
    float l = lred[tid];
    for (int w = 1; w < kWarps; ++w) l += lred[w * 8 + tid];
    cl_l[tid] = l;
  }

  // ---- the ranks merged in rank order: M = max m_r, w_r = exp(m_r - M)
  // (0 for an empty rank), l = sum w_r l_r; rank r finishes the output
  // slots r * 128 + tid + k * R * 128
  if (R > 1) mixq::cluster_sync(); else __syncthreads();
  // the value at `mine` (this block's shared memory) in rank r's block
  auto peer = [](const float* mine, int r) {
    return __uint_as_float(mixq::ld_cluster_u32(mixq::map_rank(
        (uint32_t)__cvta_generic_to_shared(mine), r)));
  };
  if (tid < G) {
    const int h = tid;
    if (R > 1) {
      const float M = mixq::cluster_max_f32(cl_m + h, R);
      float l = 0.f;
      for (int r = 0; r < R; ++r) {
        const float mr = peer(cl_m + h, r);
        const float w = mr == kNegInf ? 0.f : expf(mr - M);
        s_w[r * G + h] = w;
        l = __fadd_rn(l, __fmul_rn(w, peer(cl_l + h, r)));
      }
      s_l[h] = l;
    } else {
      s_w[h] = 1.f;
      s_l[h] = cl_l[h];
    }
  }
  __syncthreads();
  __nv_bfloat16* o = a.out + ((size_t)b * n_kv * gs + hrow) * D;
  for (int i = rank * kThreads + tid; i < gv * D; i += R * kThreads) {
    const int h = i / D;
    float y = res[i];
    if (R > 1) {
      y = 0.f;
      for (int r = 0; r < R; ++r)
        y = __fadd_rn(y, __fmul_rn(s_w[r * G + h], peer(res + i, r)));
    }
    o[i] = __float2bfloat16_rn(__fdiv_rn(y, s_l[h]));
  }
  if (R > 1) mixq::cluster_sync();   // no rank leaves while a peer reads it
}

// Configures the cluster launch of one instantiation at R blocks a row and
// `smem` bytes; the shared-memory limit is set once per device, at the most
// a block may take.
template <int G, bool kInt8, bool kSoftcap>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                      int R, int smem) {
  static unsigned long long smem_set = 0;   // per instantiation and device
  cudaError_t e = mixq::allow_smem(decode_attention_kernel<G, kInt8, kSoftcap>,
                                   kSmemMax, smem_set);
  if (e != cudaSuccess) return e;
  if (R < 1 || R > kMaxSplits || smem > kSmemMax) return cudaErrorInvalidValue;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = R;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int G, bool kInt8, bool kSoftcap>
int launch(const Args& a, int B, int n_kv, int R, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t e = configure<G, kInt8, kSoftcap>(cfg, attr, R,
                                                smem_bytes<G, kInt8>(a.D));
  if (e != cudaSuccess) return (int)e;
  cfg.gridDim = dim3(R, n_kv * a.tiles, B);
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, decode_attention_kernel<G, kInt8, kSoftcap>,
                         a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int G, bool kInt8, bool kSoftcap>
int max_clusters(int R, int D, int* n) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t e = configure<G, kInt8, kSoftcap>(cfg, attr, R,
                                                smem_bytes<G, kInt8>(D));
  if (e != cudaSuccess) return (int)e;
  cfg.gridDim = dim3(R, 1, 1);
  return (int)cudaOccupancyMaxActiveClusters(
      n, decode_attention_kernel<G, kInt8, kSoftcap>, &cfg);
}

// One call on the instantiation of (g, int8, softcap): with `n` null a
// launch, else the clusters of R blocks the card holds at once into *n.
template <int G, bool kInt8, bool kSoftcap>
int call(const Args& a, int B, int n_kv, int R, cudaStream_t stream,
         int* n) {
  return n ? max_clusters<G, kInt8, kSoftcap>(R, a.D, n)
           : launch<G, kInt8, kSoftcap>(a, B, n_kv, R, stream);
}

// g = 3, 5, 6, 7 (Phi-4-mini's 24/8, Qwen2.5-14B's 40/8, Qwen2-1.5B's
// 12/2, Qwen2/2.5-7B's 28/4) only without the softcap: no family with a
// softcap has such a group, and each instantiation costs build time
template <bool kInt8, bool kSoftcap>
int dispatch(int g, const Args& a, int B, int n_kv, int R,
             cudaStream_t stream, int* n) {
  if constexpr (!kSoftcap) {
    switch (g) {
      case 3: return call<3, kInt8, false>(a, B, n_kv, R, stream, n);
      case 5: return call<5, kInt8, false>(a, B, n_kv, R, stream, n);
      case 6: return call<6, kInt8, false>(a, B, n_kv, R, stream, n);
      case 7: return call<7, kInt8, false>(a, B, n_kv, R, stream, n);
      default: break;
    }
  }
  switch (g) {
    case 1: return call<1, kInt8, kSoftcap>(a, B, n_kv, R, stream, n);
    case 2: return call<2, kInt8, kSoftcap>(a, B, n_kv, R, stream, n);
    case 4: return call<4, kInt8, kSoftcap>(a, B, n_kv, R, stream, n);
    case 8: return call<8, kInt8, kSoftcap>(a, B, n_kv, R, stream, n);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kInt8>
int smem_of(int g, int D) {
  switch (g) {
    case 1: return smem_bytes<1, kInt8>(D);
    case 2: return smem_bytes<2, kInt8>(D);
    case 3: return smem_bytes<3, kInt8>(D);
    case 4: return smem_bytes<4, kInt8>(D);
    case 5: return smem_bytes<5, kInt8>(D);
    case 6: return smem_bytes<6, kInt8>(D);
    case 7: return smem_bytes<7, kInt8>(D);
    case 8: return smem_bytes<8, kInt8>(D);
    default: return -1;
  }
}

// g: the group; its head tiles' G picks the instantiation
int route(int int8, bool cap, int g, const Args& a, int B, int n_kv, int R,
          cudaStream_t stream, int* n) {
  if (g < 1 || (cap && head_tiles(g) > 1)) return (int)cudaErrorInvalidValue;
  g = tile_group(g);
  if (int8)
    return cap ? dispatch<true, true>(g, a, B, n_kv, R, stream, n)
               : dispatch<true, false>(g, a, B, n_kv, R, stream, n);
  return cap ? dispatch<false, true>(g, a, B, n_kv, R, stream, n)
             : dispatch<false, false>(g, a, B, n_kv, R, stream, n);
}

}  // namespace

// lengths / starts: a [B] int32 array, or null and the scalar beside it.
// softcap > 0: scores = tanh(scores / softcap) * softcap after the scale.
// alibi: [n_kv * g] f32 slopes, or null for no ALiBi (not with a softcap).
// g past 8 runs in head tiles (not with a softcap).
// ring != 0: position p lives in slot p % S, and lengths are absolute.
// splits: R, the blocks of one row's cluster
// (kernels/decode_attention.py::plan_decode).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* lengths, int length_all, const void* starts,
    int start_all, const void* alibi, void* out, int B, int S, int n_kv,
    int g, int D, float scale, float softcap, int int8, int ring, int splits,
    void* stream) {
  if (splits < 1 || splits > kMaxSplits) return (int)cudaErrorInvalidValue;
  if (alibi && softcap > 0.f) return (int)cudaErrorInvalidValue;
  const Args a{(const __nv_bfloat16*)q, (const char*)k, (const char*)v,
               (const float*)ks, (const float*)vs, (const int32_t*)lengths,
               length_all, (const int32_t*)starts, start_all,
               (const float*)alibi, (__nv_bfloat16*)out, S, D, ring, scale,
               softcap, n_kv, g, head_tiles(g)};
  return route(int8, softcap > 0.f, g, a, B, n_kv, splits,
               (cudaStream_t)stream, nullptr);
}

// How many clusters of `splits` blocks of the instantiation of group g (its
// head tiles' G), at head dim D, fit on the card at once (cudaOccupancyMaxActiveClusters) into *n;
// returns the CUDA error.
extern "C" int decode_attention_max_active_clusters(int splits, int int8,
                                                    int g, int softcap, int D,
                                                    int* n) {
  if (splits < 1 || splits > kMaxSplits) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.D = D;
  return route(int8, softcap != 0, g, a, 0, 0, splits, nullptr, n);
}

// The dynamic shared memory of one block of the (g, int8) instantiations
// (g's head tiles' G) at head dim D, as a launch takes it; -1 for g < 1.
extern "C" int decode_attention_smem_bytes(int int8, int g, int D) {
  if (g < 1) return -1;
  g = tile_group(g);
  return int8 ? smem_of<true>(g, D) : smem_of<false>(g, D);
}
