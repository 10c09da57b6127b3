// T=1 decode attention over one layer of a batch-major KV cache
// [B, S, n_kv, D] (bf16, or int8 with per-(token, head) f32 scales
// [B, S, n_kv]), with per-row valid lengths and first valid positions, GQA
// groups of g query heads per kv head, an optional ring layout
// (sliding-window caches), gemma2's score scale and logit softcap.
//
// Replaces: mixq_tpu/ops/pallas/decode_attention.py::decode_attention, and
// with it `attend` over a batch-major cache at T=1 (mixq_tpu/models/
// layers.py), whose recipe it is:
//   s = (sum_d f32(q) * f32(k)) * scale [* k_scale]; [softcap] s =
//   tanh(s / cap) * cap; masked slots s = -1e30; p = softmax(s)
//   [* v_scale]; o = sum_s p * f32(v)
// all in f32 (K and V widened, nothing quantized), rounded once to bf16.
//
// Valid positions are [lo, hi): hi = len (non-ring: min(len, S)), lo =
// max(start, 0) and, for a ring, also len - S. A ring keeps position p in
// slot p % S; the kernel walks positions, never slots, so it divides only
// p >= 0 and needs no floor of a negative number (the slot -> position map
// s + S*floor((len-1-s)/S), negative for a slot never written, is the
// plain version's; both give the same set). A row with no valid position
// gets JAX's answer: every score is masked to the same -1e30, so the
// softmax is uniform over all S slots; the kernel then takes every slot
// with score 0.
//
// Bound on the card: bytes, the valid K and V rows and their scales (two
// f32 operations per K or V element, far under the f32 rate). Design: one
// block of 4 warps per (kv head, batch row) holding its g query heads (q in
// registers as packed bf16). The row's [S, D] stripe is strided by n_kv*D;
// each lane reads 16 bytes of a row (D*esize/16 lanes per row, the rest of
// the warp on the next rows, two rows in flight per lane). Positions go in
// tiles of 128 through an online softmax, so shared memory does not bound S
// (Mistral's 4096-slot window, 32768 context): per tile, phase A writes the
// tile's scores to shared memory, phase B takes the tile max over the
// block, rescales the running max, sum and accumulators and turns the
// scores into p (times v_scale), phase C adds p . v to per-lane f32
// accumulators. The running max is the same in every thread, so the
// per-thread accumulators and partial sums add up at the end as they are.
//
// Launch: grid (n_kv, B), block 128, dynamic shared memory 4*g*D*4 bytes
// (the cross-warp sum of the accumulators; above 48 KB only for int8 with
// g*D > 3072). The launcher returns cudaGetLastError(); it allocates
// nothing and does not synchronize.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128, kWarps = kThreads / 32;
constexpr int kTile = kThreads;   // positions per tile, one per thread in B
constexpr int kUnroll = 2;        // rows each lane loads before using them

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

// Element e of a 16-byte chunk held in four 32-bit words (little endian),
// unpacked with shifts so the chunk stays in registers.
__device__ __forceinline__ unsigned word(const int4& r, int i) {
  return (unsigned)(i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w);
}
__device__ __forceinline__ float bf16_bits(unsigned w, int hi) {
  return __uint_as_float(hi ? (w & 0xffff0000u) : (w << 16));
}
template <bool kInt8>
__device__ __forceinline__ float elem(const int4& r, int e) {
  if constexpr (kInt8)
    return (float)(int)(signed char)((word(r, e >> 2) >> (8 * (e & 3))) & 0xffu);
  else
    return bf16_bits(word(r, e >> 1), e & 1);
}

template <int G, bool kInt8, bool kSoftcap>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,  // [B, n_kv*G, D]
                        const void* __restrict__ kc,          // [B, S, n_kv, D]
                        const void* __restrict__ vc,
                        const float* __restrict__ ks,         // [B, S, n_kv]
                        const float* __restrict__ vs,
                        const int32_t* __restrict__ lengths,  // [B] or null
                        int length_all,
                        const int32_t* __restrict__ starts,   // [B] or null
                        int start_all,
                        __nv_bfloat16* __restrict__ out,      // [B, n_kv*G, D]
                        int S, int n_kv, int D, float scale, float softcap,
                        int ring) {
  constexpr int E = kInt8 ? 16 : 8;                     // elements per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* pv_red = reinterpret_cast<float*>(smem);       // [kWarps, G, D]
  __shared__ float sc[G * kTile];                       // scores, then p
  __shared__ float red[kWarps * G];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = lengths ? lengths[b] : length_all;
  const int st = starts ? starts[b] : start_all;
  int hi = ring ? len : min(len, S);
  int lo = max(st, 0);
  if (ring) lo = max(lo, len - S);
  const bool uniform = hi <= lo;                        // no valid position
  if (uniform) { lo = 0; hi = S; }
  const bool wrap = ring && !uniform;

  const int esize = kInt8 ? 1 : 2;
  const int cpr = D * esize / 16;                       // lanes per row
  const int rpw = 32 / cpr;                             // rows per warp step
  const int c = lane % cpr, rr = lane / cpr;
  const char* kb = reinterpret_cast<const char*>(kc) + c * 16;
  const char* vb = reinterpret_cast<const char*>(vc) + c * 16;
  const size_t row_bytes = (size_t)D * esize;

  // q of the group's heads, this lane's E elements of each, packed bf16
  unsigned qw[G * E / 2];
  const __nv_bfloat16* qg = q + ((size_t)b * n_kv + hk) * G * D;
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int j = 0; j < E / 8; ++j) {
      const uint4 w4 = *reinterpret_cast<const uint4*>(qg + h * D + c * E + 8 * j);
      qw[h * E / 2 + 4 * j + 0] = w4.x; qw[h * E / 2 + 4 * j + 1] = w4.y;
      qw[h * E / 2 + 4 * j + 2] = w4.z; qw[h * E / 2 + 4 * j + 3] = w4.w;
    }

  float m[G], l[G], acc[G * E];
#pragma unroll
  for (int h = 0; h < G; ++h) { m[h] = __int_as_float(0xff800000); l[h] = 0.f; }
#pragma unroll
  for (int i = 0; i < G * E; ++i) acc[i] = 0.f;

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int tn = min(kTile, hi - t0);
    // ---- A: the tile's scores
    for (int base = warp * rpw * kUnroll; base < tn;
         base += kWarps * rpw * kUnroll) {
      int4 raw[kUnroll];
      size_t idx[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * rpw + rr;
        const int p = t0 + i;
        idx[u] = ((size_t)b * S + (wrap ? p % S : p)) * n_kv + hk;
        raw[u] = i < tn ? *reinterpret_cast<const int4*>(kb + idx[u] * row_bytes)
                        : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * rpw + rr;
#pragma unroll
        for (int h = 0; h < G; ++h) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e)
            a = fmaf(bf16_bits(qw[h * E / 2 + e / 2], e & 1), elem<kInt8>(raw[u], e), a);
          for (int off = cpr / 2; off > 0; off >>= 1)
            a += __shfl_xor_sync(0xffffffffu, a, off);
          if (i < tn && c == 0) {
            float sv = __fmul_rn(a, scale);
            if constexpr (kInt8) sv = __fmul_rn(sv, ks[idx[u]]);
            if constexpr (kSoftcap)
              sv = __fmul_rn(tanhf(__fdiv_rn(sv, softcap)), softcap);
            sc[h * kTile + i] = uniform ? 0.f : sv;
          }
        }
      }
    }
    __syncthreads();

    // ---- B: running max, rescale, p (times v_scale) in place of the scores
    float alpha[G];
    {
      float tmax[G];
#pragma unroll
      for (int h = 0; h < G; ++h)
        tmax[h] = tid < tn ? sc[h * kTile + tid] : __int_as_float(0xff800000);
      block_reduce<G, true>(tmax, red);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float mn = fmaxf(m[h], tmax[h]);
        alpha[h] = expf(m[h] - mn);
        m[h] = mn;
        l[h] *= alpha[h];
      }
      if (tid < tn) {
        const int p = t0 + tid;
        const float vsc = kInt8
            ? vs[((size_t)b * S + (wrap ? p % S : p)) * n_kv + hk] : 1.f;
#pragma unroll
        for (int h = 0; h < G; ++h) {
          const float e = expf(sc[h * kTile + tid] - m[h]);
          l[h] += e;
          sc[h * kTile + tid] = kInt8 ? __fmul_rn(e, vsc) : e;
        }
      }
    }
    __syncthreads();

    // ---- C: p . v into the accumulators
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[h * E + e] *= alpha[h];
    for (int base = warp * rpw * kUnroll; base < tn;
         base += kWarps * rpw * kUnroll) {
      int4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * rpw + rr;
        const int p = t0 + i;
        const size_t idx = ((size_t)b * S + (wrap ? p % S : p)) * n_kv + hk;
        raw[u] = i < tn ? *reinterpret_cast<const int4*>(vb + idx * row_bytes)
                        : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * rpw + rr;
        if (i < tn) {
#pragma unroll
          for (int h = 0; h < G; ++h) {
            const float p = sc[h * kTile + i];
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[h * E + e] = fmaf(p, elem<kInt8>(raw[u], e), acc[h * E + e]);
          }
        }
      }
    }
    __syncthreads();                     // sc is rewritten by the next tile
  }

  // ---- rows within a warp -> lanes rr == 0, then warps through shared memory
#pragma unroll
  for (int i = 0; i < G * E; ++i)
    for (int off = cpr; off < 32; off <<= 1)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  if (rr == 0) {
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int e = 0; e < E; ++e)
        pv_red[(warp * G + h) * D + c * E + e] = acc[h * E + e];
  }
  block_reduce<G, false>(l, red);        // its barriers publish pv_red too
  __nv_bfloat16* o = out + ((size_t)b * n_kv + hk) * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) a += pv_red[w * G * D + i];
    float lh = l[0];
#pragma unroll
    for (int h = 1; h < G; ++h) if (i / D == h) lh = l[h];
    o[i] = __float2bfloat16_rn(__fdiv_rn(a, lh));
  }
}

template <int G, bool kInt8, bool kSoftcap>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* lengths, int length_all,
           const void* starts, int start_all, void* out, int B, int S,
           int n_kv, int D, float scale, float softcap, int ring,
           cudaStream_t stream) {
  static int smem_limit = 48 * 1024;
  const int smem = kWarps * G * D * 4;
  if (smem > smem_limit) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<G, kInt8, kSoftcap>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_limit = smem;
  }
  dim3 grid(n_kv, B);
  decode_attention_kernel<G, kInt8, kSoftcap><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, k, v, (const float*)ks, (const float*)vs,
      (const int32_t*)lengths, length_all, (const int32_t*)starts, start_all,
      (__nv_bfloat16*)out, S, n_kv, D, scale, softcap, ring);
  return (int)cudaGetLastError();
}

template <bool kInt8, bool kSoftcap>
int dispatch(int g, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, const void* lengths,
             int length_all, const void* starts, int start_all, void* out,
             int B, int S, int n_kv, int D, float scale, float softcap,
             int ring, cudaStream_t stream) {
  switch (g) {
#define MIXQ_DA_CASE(G)                                                      \
  case G:                                                                    \
    return launch<G, kInt8, kSoftcap>(q, k, v, ks, vs, lengths, length_all,  \
                                      starts, start_all, out, B, S, n_kv, D, \
                                      scale, softcap, ring, stream);
    MIXQ_DA_CASE(1)
    MIXQ_DA_CASE(2)
    MIXQ_DA_CASE(4)
    MIXQ_DA_CASE(8)
#undef MIXQ_DA_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// lengths / starts: a [B] int32 array, or null and the scalar beside it.
// softcap > 0: scores = tanh(scores / softcap) * softcap after the scale.
// ring != 0: position p lives in slot p % S, and lengths are absolute.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* lengths, int length_all, const void* starts,
    int start_all, void* out, int B, int S, int n_kv, int g, int D,
    float scale, float softcap, int int8, int ring, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool cap = softcap > 0.f;
#define MIXQ_DA_ARGS                                                       \
  g, q, k, v, ks, vs, lengths, length_all, starts, start_all, out, B, S,   \
      n_kv, D, scale, softcap, ring, st
  if (int8)
    return cap ? dispatch<true, true>(MIXQ_DA_ARGS)
               : dispatch<true, false>(MIXQ_DA_ARGS);
  return cap ? dispatch<false, true>(MIXQ_DA_ARGS)
             : dispatch<false, false>(MIXQ_DA_ARGS);
#undef MIXQ_DA_ARGS
}
