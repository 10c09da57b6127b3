// T=1 decode attention over one layer of a head-major KV cache
// [n_kv, B, S, D] (bf16, or int8 with per-(token, head) f32 scales), with
// per-row valid lengths and first valid slots (left-padded prompts) and GQA
// groups of g query heads per kv head (g = 1, 2, 4, 8 in every mode; 3, 5,
// 6, 7 and any g past 8 without the softcap, which only gemma2 takes, at
// g = 2).
//
// Replaces: mixq_tpu/ops/pallas/flash_decode.py::flash_decode_attention
// (its main-cache path, with the softcap and the score-scale override of
// gemma2 and the ALiBi bias of Baichuan-13B; no tail window; a sliding
// window comes in as the per-row first valid slot).
// It repeats the Pallas kernel's single-pass whole-row softmax exactly:
//   int8: q is absmax-quantized per head, s = int32(q_i8 . k) * q_scale *
//         k_scale * scale; [softcap] s = tanh(s / cap) * cap;
//         p = exp(s - max); l = sum(p); p2 = p * v_scale;
//         p_scale = max(max(p2) / 127, 1e-20); p_i8 = round(p2 / p_scale);
//         o = int32(p_i8 . v) * p_scale / l
//   bf16: s = (q . k) * scale in f32; [softcap]; o = (bf16(p) . v) / l
//   [ALiBi] after the softcap, s = s + slope_h * f32(slot), the Pallas
//   kernel's absolute form (the query's -slope * q_pos is a constant of
//   the row, which the softmax drops); the slot is the absolute index in
//   the row, so under a cluster split the rank's part start plus i.
// `scale` is a runtime float (1/sqrt(D), or gemma2's
// query_pre_attn_scalar^-0.5); the softcap is a template flag, so the
// instantiations without it are the ones llama runs. The softcap uses the
// accurate tanhf (no tanh.approx, no --use_fast_math). The ALiBi slopes
// are a runtime pointer (null: none), so ALiBi adds no instantiation; the
// bias is rounded as the plain version rounds it, a multiply then an add
// (__fmul_rn, __fadd_rn: no contraction into an fma).
// Masked slots get exactly the probability the Pallas kernel gives them, 0,
// so they are skipped instead of read. A row with no valid slot is written
// as zeros (the Pallas kernel's `live` factor; it zeroes only rows of
// length 0 and averages over masked slots when start >= length > 0).
//
// Bound on the card: bytes, the valid K and V rows plus their scales. At
// Llama-2-7B decode (B=64, S=512, 32 heads, D=128, int8) that is 268 MB per
// layer against 2*2*n_q*D*valid operations; at 8 kv heads (Gemma-2,
// Mistral) a quarter of the (kv head, batch row) stripes carry the bytes.
// Design: a thread-block cluster of R blocks (R = 1, 2, 4 or 8, from
// kernels/flash_decode.py::plan_flash) per (kv head, batch row), 4 warps a
// block, holding the row's g query heads. Rank r takes a contiguous part of
// the row's valid slots [start, length), cut at run time in whole warp
// steps (mixq::rank_part), so that on ragged rows every rank has work; with
// few stripes (small batches) R > 1 puts enough warps and loads on every
// SM, and where the stripes fill the card the plan keeps R = 1. Each rank
// keeps its part's scores [g, part] in f32 shared memory, and the Pallas
// recipe stays exact across ranks through distributed shared memory:
//   1. the part's dots (int8: dp4a on the int8 q), then its scores (the
//      scales and the cap) in a pass of all threads over the part;
//   2. the cluster max m (a max: independent of R);
//   3. p = exp(s - m) on the part, its block sum of l; int8 also p2 =
//      p * v_scale and the part's max of p2;
//   4. l = the ranks' sums added in rank order, pmax = their max, so
//      p_scale is the whole row's;
//   5. p_i8 = round(p2 / p_scale) on the part;
//   6. the part's p . v, [g, D]: int32 for int8, f32 for bf16;
//   7. the R partials added in rank order (int32: exact), each rank
//      finishing a slice of the output.
// int8: the scores, m, p_scale, p_i8 and the int32 p . v do not depend on
// R; only l's f32 sum does. bf16: the f32 partials add in rank order. So a
// plan always gives the same bits. With R = 1 no cluster barrier runs.
// Each K and V row is read once, 16 bytes per lane with neighbouring lanes
// on neighbouring bytes: a row of c 16-byte chunks takes the next power of
// two of c lanes (mixq::pow2_chunks), so a row of 96 bytes (int8 at
// D = 96) takes 8 lanes and 192 (bf16) 16, the lanes past its chunks
// reading zeros and writing nothing; the butterflies then sum a row over
// whole lane bits. Rows are read in one of two load pipelines (uses_ring,
// chosen per instantiation by what measured faster on the H100):
//   the ring: a per-lane ring of 4 stages of 2 rows in shared memory filled
//     by cp.async; each lane copies the 16 bytes it later reads, so no
//     barrier guards the ring, and while a lane works on one stage the
//     next three are in flight (bf16, and int8 with g >= 4);
//   registers: 4 rows a lane loaded before any is used (int8 with g <= 2,
//     where the ring's shared-memory round trip cost more than it hid).
// The part's k and v scales come in by cp.async with K's first rows, and
// V's first rows are issued before the cluster reductions of step 2, so the
// V stream overlaps the softmax. A row's dots and the p . v partials are
// summed over its lanes by a reduce-scatter butterfly (lane_sum).
//
// A group past 8 (Falcon-7B's 71 heads on one kv head, StarCoder2's 9,
// ChatGLM3's 16) is cut into T = ceil(g / 8) head tiles of G = ceil(g / T)
// heads (71: 9 tiles of 8, the last with 7; 9: 5 + 4; 12: 6 + 6; 16: 8 +
// 8), and each tile is a block (a cluster of R) of the G <= 8 code: the
// tile index is a grid axis beside the kv head, so the tiles of one
// (kv head, batch row) are neighbours in the launch order and run
// together, and L2 serves each one's re-read of the stripe. A tile past
// the group's end (the last tile's heads >= g) loads a zero q, takes no
// slope and writes nothing. So no register or shared array is sized by g,
// only by G, and a large group adds no instantiation. The design keeps the
// per-tile K/V walk as it is; looping over the tiles inside a block over
// the stripe in shared memory would read it once from L2, but needs the
// scores of every tile's heads at once (g*P*4 bytes: 71 heads do not fit
// at S = 512 with the ring).
// Launch: grid (R, n_kv * T, B), cluster (R, 1, 1), block 128, dynamic shared
// memory ring + g*D*4 + g*D + 4*g*D*4 + g*P*4 (+ 2*P*4 int8) bytes, P = the
// longest part (kernels/flash_decode.py::smem_bytes). The launcher returns
// the CUDA error; it allocates nothing and does not synchronize.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cluster.cuh"
#include "cp_async.cuh"
#include "launch.cuh"

namespace {

constexpr int kThreads = 128, kWarps = kThreads / 32, kMaxSplits = 8;

// each instantiation's loads: the pipeline measured faster for it on the
// H100, the cp.async ring except for int8 K/V with g <= 2
template <int G, bool kInt8>
__host__ __device__ constexpr bool uses_ring() {
  return !kInt8 || G >= 4;
}
// the ring: 4 stages of 2 rows a lane; registers: 4 rows a lane
template <bool kRing>
struct Pipe {
  static constexpr int kUnroll = kRing ? 2 : 4, kStages = kRing ? 4 : 1;
  static constexpr int kRingBytes = kRing ? kThreads * kUnroll * kStages * 16
                                          : 0;
};

// dynamic shared memory a block may take: the card's 227 KB less room for
// the kernel's static shared memory
constexpr int kSmemMax = 226 * 1024;

struct Args {
  const __nv_bfloat16* q;   // [B, n_kv*g, D]
  const char* k;            // [n_kv, B, S, D]
  const char* v;
  const float* ks;          // [n_kv, B, Sp]
  const float* vs;
  const int32_t* lengths;   // [B] or null: length_all
  int length_all;
  const int32_t* starts;    // [B] or null: 0
  const float* alibi;       // [n_kv*g] ALiBi slopes or null
  __nv_bfloat16* out;       // [B, n_kv*g, D]
  int B, S, Sp, D, P;       // P: the longest part a rank takes
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

// Slots per warp step (a row takes mixq::pow2_chunks lanes), the longest
// part of S slots a rank takes at R, and the dynamic shared memory of a
// block.
__host__ __device__ inline int rows_per_step(int row_bytes) {
  return 32 / mixq::pow2_chunks(row_bytes);
}
inline int part_rows(int S, int rpw, int R) {
  return ((S + rpw - 1) / rpw + R - 1) / R * rpw;
}
template <int G, bool kInt8>
int smem_bytes(int S, int D, int R) {
  const int P = part_rows(S, rows_per_step(D * (kInt8 ? 1 : 2)), R);
  return Pipe<uses_ring<G, kInt8>()>::kRingBytes + G * D * 4 + G * D +
         kWarps * G * D * 4 + G * P * 4 + (kInt8 ? 2 * P * 4 : 0);
}

// v over the block's threads (the max, or the sum: lanes by a butterfly,
// then the warps in order); `red` holds kWarps * G floats.
template <int G, bool kMax>
__device__ void block_reduce(float (&v)[G], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int h = 0; h < G; ++h) {
    float x = v[h];
    for (int o = 16; o > 0; o >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x, o);
      x = kMax ? fmaxf(x, y) : x + y;
    }
    if (lane == 0) red[warp * G + h] = x;
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < G; ++h) {
    float x = red[h];
    for (int w = 1; w < kWarps; ++w)
      x = kMax ? fmaxf(x, red[w * G + h]) : x + red[w * G + h];
    v[h] = x;
  }
  __syncthreads();
}

// Sums each v[i] over the lanes that differ in the bits lo..hi (powers of
// two; none when hi < lo) and calls put(i, sum) once for every i, from one
// lane. A reduce-scatter butterfly: each level swaps half of the values a
// lane still holds with its partner's, so NV/2 + NV/4 + ... shuffles do
// the work of NV * log2(hi / lo * 2); the last levels, once a lane holds
// an odd number of values (one when NV is a power of two; 7 of 14 at
// g = 7), are a plain butterfly on each and the lanes with those bits 0
// put.
// p ? a : b as a register select (a ternary over array elements may become
// a select of addresses, which puts the array in local memory)
__device__ __forceinline__ int pick(bool p, int a, int b) {
  int d;
  asm("{\n .reg .pred q;\n setp.ne.b32 q, %3, 0;\n"
      " selp.b32 %0, %1, %2, q;\n}\n"
      : "=r"(d)
      : "r"(a), "r"(b), "r"((int)p));
  return d;
}
__device__ __forceinline__ float pick(bool p, float a, float b) {
  return __int_as_float(pick(p, __float_as_int(a), __float_as_int(b)));
}

// One level of lane_sum per HALF = NV/2, NV/4, ..., 1 while off >= lo,
// each in code of its own (compile-time array indices throughout).
template <int HALF, int NV, typename T>
__device__ __forceinline__ void halve(T (&v)[NV], int lo, int lane, int& off,
                                      int& base, int& held) {
  if constexpr (HALF >= 1) {
    if (off >= lo) {
      const bool up = lane & off;
#pragma unroll
      for (int j = 0; j < HALF; ++j) {
        const T send = pick(up, v[j], v[j + HALF]);
        const T keep = pick(up, v[j + HALF], v[j]);
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
      if (up) base += HALF;
      held = HALF;
      off >>= 1;
      if constexpr (HALF % 2 == 0)
        halve<HALF / 2>(v, lo, lane, off, base, held);
    }
  }
}

template <int NV, typename T, class Put>
__device__ __forceinline__ void lane_sum(T (&v)[NV], int lo, int hi,
                                         Put put) {
  // the values a lane holds once the halving levels are spent
  constexpr int kOdd = NV / (NV & -NV);
  const int lane = threadIdx.x & 31;
  int base = 0, held = NV, off = hi;
  halve<NV / 2>(v, lo, lane, off, base, held);
  bool mine = true;
  for (; off >= lo; off >>= 1) {
#pragma unroll
    for (int j = 0; j < kOdd; ++j)
      v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
    mine = mine && !(lane & off);
  }
  if (mine)
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (j < held) put(base + j, v[j]);
}

// Element e of a 16-byte chunk held in four 32-bit words (little endian),
// unpacked with shifts so the chunk stays in registers.
__device__ __forceinline__ unsigned word(const int4& r, int i) {
  return (unsigned)(i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w);
}
__device__ __forceinline__ float bf16_at(const int4& r, int e) {
  const unsigned w = word(r, e >> 1);
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}
__device__ __forceinline__ int s8_at(const int4& r, int e) {
  return (int)(signed char)((word(r, e >> 2) >> (8 * (e & 3))) & 0xffu);
}

// This lane's rows of one (kv head, batch row) stripe of the cache: at a
// block step from row s0 of its warp, rows s0 + u * rpw + rr for
// u < kUnroll, each the lane's 16-byte chunk; rows at or past `hi`, and
// every row of a lane past the row's chunks (`on` false), read as zeros.
// `each(raw, s0)` runs once per block step, with the rows loaded.
template <bool kRing>
struct Rows {
  static constexpr int kUnroll = Pipe<kRing>::kUnroll;
  static constexpr int kStages = Pipe<kRing>::kStages;
  const char* stripe;
  int row_bytes, chunk, rpw, rr, hi, step;
  bool on;                  // the lane holds a chunk of the row
  int4* ring;               // this lane's ring slots

  __device__ bool has(int s) const { return on && s < hi; }
  __device__ const char* at(int s) const {
    return stripe + (size_t)s * row_bytes + chunk;
  }
  __device__ void load(int s0, int4 (&raw)[kUnroll]) const {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * rpw + rr;
      raw[u] = has(s) ? *reinterpret_cast<const int4*>(at(s))
                      : make_int4(0, 0, 0, 0);
    }
  }
  // the ring: stage j of this lane (zero-filled past hi), one commit group
  __device__ void issue(int s0, int j) const {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * rpw + rr;
      mixq::cp_async16(ring + (j * kUnroll + u) * kThreads,
                       has(s) ? at(s) : stripe, has(s));
    }
    mixq::cp_async_commit();
  }
  // The loads of the first block step(s), issued before the walk so that
  // other work overlaps them.
  __device__ void prime(int first, int4 (&raw)[kUnroll]) const {
    if constexpr (kRing) {
      for (int j = 0; j < kStages - 1; ++j) issue(first + j * step, j);
    } else {
      load(first, raw);
    }
  }
  template <class F>
  __device__ void walk(int first, int4 (&raw)[kUnroll], F each) const {
    int it = 0;
    for (int s0 = first; s0 < hi; s0 += step, ++it) {
      if constexpr (kRing) {
        // the compiler barriers keep the slot reads between the refill of
        // the slot read last step and the wait for this one
        asm volatile("" ::: "memory");
        issue(s0 + (kStages - 1) * step, (it + kStages - 1) % kStages);
        mixq::cp_async_wait<kStages - 1>();
        asm volatile("" ::: "memory");
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          raw[u] = ring[((it % kStages) * kUnroll + u) * kThreads];
      } else if (it > 0) {
        load(s0, raw);
      }
      each(raw, s0);
    }
    if constexpr (kRing) mixq::cp_async_wait<0>();  // ring reusable
  }
};

template <int G, bool kInt8, bool kSoftcap>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const Args a) {
  constexpr int E = kInt8 ? 16 : 8;   // elements in a 16-byte chunk
  constexpr int esize = kInt8 ? 1 : 2;
  constexpr bool kRing = uses_ring<G, kInt8>();
  constexpr int kUnroll = Pipe<kRing>::kUnroll;
  // shared memory, 16-byte aligned pieces first (D * esize % 16 == 0):
  // ring | qf [G, D] f32 | qi [G, D] int8 | pv_red [kWarps, G, D] (its row
  // 0 ends as the block's partial) | sc [G, P] f32 | int8: the part's
  // k and v scales [2, P]
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, P = a.P;
  float* qf = reinterpret_cast<float*>(smem + Pipe<kRing>::kRingBytes);
  int8_t* qi = reinterpret_cast<int8_t*>(qf + G * D);
  float* pv_red = reinterpret_cast<float*>(qi + G * D);
  float* sc = pv_red + kWarps * G * D;
  float* ksm = sc + G * P;
  float* vsm = ksm + P;
  __shared__ float red[kWarps * G];
  __shared__ float qscale[G];
  __shared__ float cl_m[G], cl_l[G], cl_pmax[G];   // read by the peers
  __shared__ float s_l[G], s_pscale[G];

  // the cluster is (R, 1, 1) and the grid (R, n_kv * T, B): rank =
  // blockIdx.x; this block's heads h0 .. h0 + gv - 1 of kv head hk
  // (a group past 8 runs in tiles of G >= 5 heads, so the instantiations
  // of G <= 4 keep their one tile at compile time)
  constexpr bool kTiled = G >= 5;
  const int R = gridDim.x, rank = blockIdx.x, b = blockIdx.z;
  const int hk = kTiled ? blockIdx.y / a.tiles : blockIdx.y;
  const int gs = kTiled ? a.g : G;                          // the group
  const int h0 = kTiled ? (blockIdx.y - hk * a.tiles) * G : 0;
  const int gv = kTiled ? min(G, gs - h0) : G;
  const int hrow = hk * gs + h0;      // the tile's first head in its row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(a.lengths ? a.lengths[b] : a.length_all, a.S);
  const int st = max(a.starts ? a.starts[b] : 0, 0);
  const bool live = len > st;
  // lpr lanes a row, the first cpr of them on its chunks
  const int row_bytes = D * esize, cpr = row_bytes / 16;
  const int lpr = mixq::pow2_chunks(row_bytes), rpw = 32 / lpr;
  const int c = lane % lpr, rr = lane / lpr;
  const bool on = c < cpr;
  const int step = kWarps * rpw * kUnroll;           // rows a block step
  // this rank's part [lo, hi) of the valid slots, whole warp steps
  const int2 part = mixq::rank_part(st, len, rpw, R, rank);
  const int lo = part.x, hi = part.y, n = hi - lo;
  const size_t stripe = (size_t)hk * a.B + b;        // (kv head, batch row)
  const float* ksr = kInt8 ? a.ks + stripe * a.Sp : nullptr;
  const float* vsr = kInt8 ? a.vs + stripe * a.Sp : nullptr;
  const int first = lo + warp * rpw * kUnroll;       // this warp's first row
  int4* ring = reinterpret_cast<int4*>(smem) + tid;
  const Rows<kRing> krows{a.k + stripe * a.S * row_bytes, row_bytes, c * 16,
                          rpw, rr, hi, step, on, ring};
  const Rows<kRing> vrows{a.v + stripe * a.S * row_bytes, row_bytes, c * 16,
                          rpw, rr, hi, step, on, ring};
  int4 raw[kUnroll];

  // ---- 1. scores over the part. q's loads go out first, then the part's
  // scales (cp.async) and K's first rows, then q is quantized
  if (n > 0) {
    const int4* qg = reinterpret_cast<const int4*>(
        a.q + ((size_t)b * a.n_kv * gs + hrow) * D);
    constexpr int kQ = (G * 512 / 8 + kThreads - 1) / kThreads;  // D <= 512
    int4 qv[kQ];
    // the tile's heads past the group read as zeros
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const int i = tid + j * kThreads;
      qv[j] = i * 8 < gv * D ? qg[i] : make_int4(0, 0, 0, 0);
    }
    if constexpr (kInt8) {
      for (int i = tid; i < n; i += kThreads) {
        mixq::cp_async4(ksm + i, ksr + lo + i);
        mixq::cp_async4(vsm + i, vsr + lo + i);
      }
      mixq::cp_async_commit();
    }
    krows.prime(first, raw);
#pragma unroll
    for (int j = 0; j < kQ; ++j)
      if ((tid + j * kThreads) * 8 < G * D)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          qf[(tid + j * kThreads) * 8 + e] = bf16_at(qv[j], e);
    __syncthreads();
    if constexpr (kInt8) {
      for (int h = warp; h < G; h += kWarps) {
        float x = 0.f;
        for (int d = lane; d < D; d += 32) x = fmaxf(x, fabsf(qf[h * D + d]));
        for (int off = 16; off > 0; off >>= 1)
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
        if (lane == 0) qscale[h] = fmaxf(x / 127.0f, 1e-8f);
      }
      __syncthreads();
      // not unrolled: unrolled, the division's slow-path calls made ptxas
      // spill a register at g = 1
#pragma unroll 1
      for (int i = tid; i < G * D; i += kThreads) {
        const float x = rintf(qf[i] / qscale[i / D]);
        qi[i] = (int8_t)fminf(fmaxf(x, -127.f), 127.f);
      }
      __syncthreads();
    }
    // this lane's chunk of q (zeros on a lane past the row's chunks)
    int qreg[kInt8 ? G * 4 : 1];
    float qfr[kInt8 ? 1 : G * E];
#pragma unroll
    for (int h = 0; h < G; ++h) {
      if constexpr (kInt8) {
        const int4 w4 =
            on ? *reinterpret_cast<const int4*>(qi + h * D + c * E)
               : make_int4(0, 0, 0, 0);
        qreg[h * 4 + 0] = w4.x; qreg[h * 4 + 1] = w4.y;
        qreg[h * 4 + 2] = w4.z; qreg[h * 4 + 3] = w4.w;
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e)
          qfr[h * E + e] = on ? qf[h * D + c * E + e] : 0.f;
      }
    }
    krows.walk(first, raw, [&](const int4 (&kr)[kUnroll], int s0) {
      // this lane's partial dots of its chunk, [u][h], summed over the
      // row's lpr lanes
      using Dot = std::conditional_t<kInt8, int, float>;
      Dot dot[kUnroll * G];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int h = 0; h < G; ++h) {
          if constexpr (kInt8) {
            int x = __dp4a(kr[u].x, qreg[h * 4 + 0], 0);
            x = __dp4a(kr[u].y, qreg[h * 4 + 1], x);
            x = __dp4a(kr[u].z, qreg[h * 4 + 2], x);
            dot[u * G + h] = __dp4a(kr[u].w, qreg[h * 4 + 3], x);
          } else {
            float x = 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e)
              x = fmaf(qfr[h * E + e], bf16_at(kr[u], e), x);
            dot[u * G + h] = x;
          }
        }
      lane_sum(dot, 1, lpr / 2, [&](int i, Dot x) {
        const int s = s0 + (i / G) * rpw + rr;
        if (s < hi) sc[(i % G) * P + s - lo] = (float)x;
      });
    });
    mixq::cp_async_wait<0>();   // the scales (and the ring's last stages)
    // V's first rows, in flight through the softmax and its reductions
    vrows.prime(first, raw);
  }
  __syncthreads();   // the part's dots and scales are in place

  // ---- the scores from the dots (the scales read once, coalesced, and
  // the cap on every thread), then 2. the cluster max
  float m[G], l[G], pmax[G];
#pragma unroll
  for (int h = 0; h < G; ++h) m[h] = __int_as_float(0xff800000);  // -inf
  for (int i = tid; i < n; i += kThreads) {
    const float ksc = kInt8 ? ksm[i] : 1.f;
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float sv;
      if constexpr (kInt8)
        sv = __fmul_rn(__fmul_rn(__fmul_rn(sc[h * P + i], qscale[h]), ksc),
                       a.scale);
      else
        sv = __fmul_rn(sc[h * P + i], a.scale);
      if constexpr (kSoftcap)
        sv = __fmul_rn(tanhf(__fdiv_rn(sv, a.softcap)), a.softcap);
      if (a.alibi)      // head h's slope, read where it is used
        sv = __fadd_rn(sv, __fmul_rn(h < gv ? a.alibi[hrow + h] : 0.f,
                                     (float)(lo + i)));
      sc[h * P + i] = sv;
      m[h] = fmaxf(m[h], sv);
    }
  }
  block_reduce<G, true>(m, red);
  if (R > 1) {
    if (tid == 0)
#pragma unroll
      for (int h = 0; h < G; ++h) cl_m[h] = m[h];
    mixq::cluster_sync();
#pragma unroll
    for (int h = 0; h < G; ++h) m[h] = mixq::cluster_max_f32(cl_m + h, R);
  }

  // ---- 3. p on the part, its sum (int8: p2 = p * v_scale and its max)
#pragma unroll
  for (int h = 0; h < G; ++h) { l[h] = 0.f; pmax[h] = 0.f; }
  for (int i = tid; i < n; i += kThreads) {
    const float vsc = kInt8 ? vsm[i] : 1.f;
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const float p = expf(sc[h * P + i] - m[h]);
      l[h] += p;
      if constexpr (kInt8) {
        const float p2 = __fmul_rn(p, vsc);
        pmax[h] = fmaxf(pmax[h], p2);
        sc[h * P + i] = p2;
      } else {
        sc[h * P + i] = __bfloat162float(__float2bfloat16_rn(p));
      }
    }
  }
  block_reduce<G, false>(l, red);
  if constexpr (kInt8) block_reduce<G, true>(pmax, red);

  // ---- 4. l over the ranks in rank order, pmax over the ranks
  if (R > 1) {
    if (tid == 0)
#pragma unroll
      for (int h = 0; h < G; ++h) { cl_l[h] = l[h]; cl_pmax[h] = pmax[h]; }
    mixq::cluster_sync();
#pragma unroll
    for (int h = 0; h < G; ++h) {
      l[h] = mixq::cluster_sum_f32(cl_l + h, R);
      if constexpr (kInt8) pmax[h] = mixq::cluster_max_f32(cl_pmax + h, R);
    }
  }

  // ---- 5. p_i8 on the part
  float pscale[G];
#pragma unroll
  for (int h = 0; h < G; ++h) pscale[h] = fmaxf(pmax[h] / 127.0f, 1e-20f);
  if constexpr (kInt8) {
    for (int i = tid; i < n; i += kThreads)
#pragma unroll
      for (int h = 0; h < G; ++h)
        sc[h * P + i] = rintf(sc[h * P + i] / pscale[h]);
  }
  if (tid == 0) {
#pragma unroll
    for (int h = 0; h < G; ++h) { s_l[h] = l[h]; s_pscale[h] = pscale[h]; }
  }
  __syncthreads();

  // ---- 6. the part's p . v
  int acci[kInt8 ? G * E : 1];
  float accf[kInt8 ? 1 : G * E];
#pragma unroll
  for (int i = 0; i < G * E; ++i) {
    if constexpr (kInt8) acci[i] = 0; else accf[i] = 0.f;
  }
  if (n > 0) {
    vrows.walk(first, raw, [&](const int4 (&vr)[kUnroll], int s0) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = s0 + u * rpw + rr;
#pragma unroll
        for (int h = 0; h < G; ++h) {
          const float p = s < hi ? sc[h * P + s - lo] : 0.f;
          if constexpr (kInt8) {
            const int pi = (int)p;
#pragma unroll
            for (int e = 0; e < E; ++e)
              acci[h * E + e] += pi * s8_at(vr[u], e);
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e)
              accf[h * E + e] = fmaf(p, bf16_at(vr[u], e), accf[h * E + e]);
          }
        }
      }
    });
  }
  // the rows within a warp summed (over the lanes' rr bits), then the
  // warps in order
  auto put_pv = [&](int i, auto x) {
    if (!on) return;
    float* to = pv_red + (warp * G + i / E) * D + c * E + i % E;
    if constexpr (kInt8) *to = __int_as_float(x); else *to = x;
  };
  if constexpr (kInt8) lane_sum(acci, lpr, 16, put_pv);
  else lane_sum(accf, lpr, 16, put_pv);
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {   // thread i alone on slot i
    if constexpr (kInt8) {
      int x = 0;
      for (int w = 0; w < kWarps; ++w)
        x += __float_as_int(pv_red[w * G * D + i]);
      pv_red[i] = __int_as_float(x);
    } else {
      float x = 0.f;
      for (int w = 0; w < kWarps; ++w) x += pv_red[w * G * D + i];
      pv_red[i] = x;
    }
  }

  // ---- 7. the partials over the ranks in rank order; rank r finishes the
  // output slots r * 128 + tid + k * R * 128
  if (R > 1) mixq::cluster_sync(); else __syncthreads();
  __nv_bfloat16* o = a.out + ((size_t)b * a.n_kv * gs + hrow) * D;
  for (int i = rank * kThreads + tid; i < gv * D; i += R * kThreads) {
    const int h = i / D;
    float y = 0.f;
    if (live) {
      if constexpr (kInt8) {
        const int x = R > 1 ? mixq::cluster_sum_s32(
                                  reinterpret_cast<const int*>(pv_red) + i, R)
                            : __float_as_int(pv_red[i]);
        y = __fdiv_rn(__fmul_rn((float)x, s_pscale[h]), s_l[h]);
      } else {
        const float x = R > 1 ? mixq::cluster_sum_f32(pv_red + i, R)
                              : pv_red[i];
        y = __fdiv_rn(x, s_l[h]);
      }
    }
    o[i] = __float2bfloat16_rn(y);
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
  cudaError_t e = mixq::allow_smem(flash_decode_kernel<G, kInt8, kSoftcap>,
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
int launch(const Args& a, int n_kv, int R, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t e = configure<G, kInt8, kSoftcap>(
      cfg, attr, R, smem_bytes<G, kInt8>(a.S, a.D, R));
  if (e != cudaSuccess) return (int)e;
  cfg.gridDim = dim3(R, n_kv * a.tiles, a.B);
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, flash_decode_kernel<G, kInt8, kSoftcap>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int G, bool kInt8, bool kSoftcap>
int max_clusters(int R, int S, int D, int* n) {
  const int smem = smem_bytes<G, kInt8>(S, D, R);
  if (smem > kSmemMax) {        // this plan cannot launch
    *n = 0;
    return (int)cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t e = configure<G, kInt8, kSoftcap>(cfg, attr, R, smem);
  if (e != cudaSuccess) return (int)e;
  cfg.gridDim = dim3(R, 1, 1);
  return (int)cudaOccupancyMaxActiveClusters(
      n, flash_decode_kernel<G, kInt8, kSoftcap>, &cfg);
}

// One call on the instantiation of (g, int8, softcap): with `n` null a
// launch, else the clusters of R blocks the card holds at once into *n.
template <int G, bool kInt8, bool kSoftcap>
int call(const Args& a, int n_kv, int R, cudaStream_t stream, int* n) {
  return n ? max_clusters<G, kInt8, kSoftcap>(R, a.S, a.D, n)
           : launch<G, kInt8, kSoftcap>(a, n_kv, R, stream);
}

// g = 3, 5, 6, 7 (Phi-4-mini's 24/8, Qwen2.5-14B's 40/8, Qwen2-1.5B's
// 12/2, Qwen2/2.5-7B's 28/4) only without the softcap: no family with a
// softcap has such a group, and each instantiation costs build time
template <bool kInt8, bool kSoftcap>
int dispatch(int g, const Args& a, int n_kv, int R, cudaStream_t stream,
             int* n) {
  if constexpr (!kSoftcap) {
    switch (g) {
      case 3: return call<3, kInt8, false>(a, n_kv, R, stream, n);
      case 5: return call<5, kInt8, false>(a, n_kv, R, stream, n);
      case 6: return call<6, kInt8, false>(a, n_kv, R, stream, n);
      case 7: return call<7, kInt8, false>(a, n_kv, R, stream, n);
      default: break;
    }
  }
  switch (g) {
    case 1: return call<1, kInt8, kSoftcap>(a, n_kv, R, stream, n);
    case 2: return call<2, kInt8, kSoftcap>(a, n_kv, R, stream, n);
    case 4: return call<4, kInt8, kSoftcap>(a, n_kv, R, stream, n);
    case 8: return call<8, kInt8, kSoftcap>(a, n_kv, R, stream, n);
    default: return (int)cudaErrorInvalidValue;
  }
}

// g: the group; its head tiles' G picks the instantiation
int route(int int8, bool cap, int g, const Args& a, int n_kv, int R,
          cudaStream_t stream, int* n) {
  if (g < 1 || (cap && head_tiles(g) > 1)) return (int)cudaErrorInvalidValue;
  g = tile_group(g);
  if (int8)
    return cap ? dispatch<true, true>(g, a, n_kv, R, stream, n)
               : dispatch<true, false>(g, a, n_kv, R, stream, n);
  return cap ? dispatch<false, true>(g, a, n_kv, R, stream, n)
             : dispatch<false, false>(g, a, n_kv, R, stream, n);
}

}  // namespace

// softcap > 0: scores = tanh(scores / softcap) * softcap after the scale
// (g <= 8 only); alibi: [n_kv * g] f32 slopes, or null for no ALiBi; g past
// 8 runs in head tiles;
// splits: R, the blocks of one row's cluster
// (kernels/flash_decode.py::plan_flash).
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* ks,
                                   const void* vs, const void* lengths,
                                   int length_all, const void* starts,
                                   const void* alibi, void* out, int B,
                                   int n_kv, int g, int S, int Sp, int D,
                                   float scale, float softcap, int int8,
                                   int splits, void* stream) {
  if (splits < 1 || splits > kMaxSplits) return (int)cudaErrorInvalidValue;
  const Args a{(const __nv_bfloat16*)q, (const char*)k, (const char*)v,
               (const float*)ks, (const float*)vs, (const int32_t*)lengths,
               length_all, (const int32_t*)starts, (const float*)alibi,
               (__nv_bfloat16*)out, B, S, Sp, D,
               part_rows(S, rows_per_step(D * (int8 ? 1 : 2)), splits),
               scale, softcap, n_kv, g, head_tiles(g)};
  return route(int8, softcap > 0.f, g, a, n_kv, splits,
               (cudaStream_t)stream, nullptr);
}

// How many clusters of `splits` blocks of the instantiation of group g (its
// head tiles' G), at S slots of head dim D, fit on the card at once
// (cudaOccupancyMaxActiveClusters) into *n; returns the CUDA error.
extern "C" int flash_decode_max_active_clusters(int splits, int int8, int g,
                                                int softcap, int S, int D,
                                                int* n) {
  if (splits < 1 || splits > kMaxSplits) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.S = S;
  a.D = D;
  return route(int8, softcap != 0, g, a, 0, splits, nullptr, n);
}
