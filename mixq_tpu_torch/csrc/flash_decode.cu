// T=1 decode attention over one layer of a head-major KV cache
// [n_kv, B, S, D] (bf16, or int8 with per-(token, head) f32 scales), with
// per-row valid lengths and first valid slots (left-padded prompts) and GQA
// groups of g query heads per kv head.
//
// Replaces: mixq_tpu/ops/pallas/flash_decode.py::flash_decode_attention
// (its main-cache path, with the softcap and the score-scale override of
// gemma2; no tail window or ALiBi; a sliding window comes in as the
// per-row first valid slot).
// It repeats the Pallas kernel's single-pass whole-row softmax exactly:
//   int8: q is absmax-quantized per head, s = int32(q_i8 . k) * q_scale *
//         k_scale * scale; [softcap] s = tanh(s / cap) * cap;
//         p = exp(s - max); l = sum(p); p2 = p * v_scale;
//         p_scale = max(max(p2) / 127, 1e-20); p_i8 = round(p2 / p_scale);
//         o = int32(p_i8 . v) * p_scale / l
//   bf16: s = (q . k) * scale in f32; [softcap]; o = (bf16(p) . v) / l
// `scale` is a runtime float (1/sqrt(D), or gemma2's
// query_pre_attn_scalar^-0.5); the softcap is a template flag, so the
// instantiations without it are the ones llama runs. The softcap uses the
// accurate tanhf (no tanh.approx, no --use_fast_math).
// Masked slots get exactly the probability the Pallas kernel gives them, 0,
// so they are skipped instead of read. A row with no valid slot is written
// as zeros (the Pallas kernel's `live` factor; it zeroes only rows of
// length 0 and averages over masked slots when start >= length > 0).
//
// Bound on the card: bytes, the valid K and V rows plus their scales. At
// Llama-2-7B decode (B=64, S=512, 32 heads, D=128, int8) that is 268 MB per
// layer against 2*2*n_q*D*valid operations. Design: one block per
// (kv head, batch row) holding its g query heads, 2048 blocks at the main
// shape. The row's scores [g, S] are staged in f32 shared memory: that is
// the TPU design's whole-S single-pass softmax, and the two passes over the
// staged scores give the p_i8 quantization its whole-row max. Each K and V
// row is read once, 16 bytes per lane with neighbouring lanes on
// neighbouring bytes; the int8 q.k runs on __dp4a and p.v on int32
// multiply-adds (both exact), the bf16 dots in f32.
//
// Launch: grid (n_kv, B), block 128, dynamic shared memory
// g*S*4 + 4*g*D*4 + g*D*4 + g*D bytes (kernels/flash_decode.py::smem_bytes;
// gemma2's g=2, D=256 at S=4096, its window: 43,520 bytes). The launcher
// returns cudaGetLastError(); it allocates nothing and does not synchronize.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128, kWarps = kThreads / 32;

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

// One 16-byte chunk of a cache row: 16 int8 or 8 bf16 values.
template <bool kInt8>
struct Chunk {
  static constexpr int kElems = kInt8 ? 16 : 8;
};

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

template <int G, bool kInt8, bool kSoftcap>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,  // [B, n_kv*G, D]
                    const void* __restrict__ kc,          // [n_kv, B, S, D]
                    const void* __restrict__ vc,
                    const float* __restrict__ ks,         // [n_kv, B, Sp]
                    const float* __restrict__ vs,
                    const int32_t* __restrict__ lengths,  // [B] or null
                    int length_all,
                    const int32_t* __restrict__ starts,   // [B] or null
                    __nv_bfloat16* __restrict__ out,      // [B, n_kv*G, D]
                    int B, int S, int Sp, int D, float scale,
                    float softcap) {
  constexpr int E = Chunk<kInt8>::kElems;
  // shared memory, 16-byte aligned pieces first (D * esize % 16 == 0):
  // qf [G, D] f32 | qi [G, D] int8 | pv_red [kWarps, G, D] | sc [G, S] f32
  extern __shared__ __align__(16) unsigned char smem[];
  float* qf = reinterpret_cast<float*>(smem);
  int8_t* qi = reinterpret_cast<int8_t*>(qf + G * D);
  float* pv_red = reinterpret_cast<float*>(qi + G * D);
  float* sc = pv_red + kWarps * G * D;
  __shared__ float red[kWarps * G];
  __shared__ float qscale[G];

  const int hk = blockIdx.x, b = blockIdx.y, n_kv = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(lengths ? lengths[b] : length_all, S);
  const int st = max(starts ? starts[b] : 0, 0);
  const size_t row0 = ((size_t)hk * B + b) * S;          // first cache row
  const int esize = kInt8 ? 1 : 2;
  const int cpr = D * esize / 16;                        // chunks per row
  const int rpw = 32 / cpr;                              // rows per warp step
  const int c = lane % cpr, rr = lane / cpr;
  __nv_bfloat16* o = out + ((size_t)b * n_kv + hk) * G * D;

  if (len <= st) {                                       // no valid slot
    for (int i = tid; i < G * D; i += kThreads) o[i] = __float2bfloat16_rn(0.f);
    return;
  }

  // ---- q for this group of heads (absmax-quantized per head for int8)
  const __nv_bfloat16* qg = q + ((size_t)b * n_kv + hk) * G * D;
  for (int i = tid; i < G * D; i += kThreads) qf[i] = __bfloat162float(qg[i]);
  __syncthreads();
  if constexpr (kInt8) {
    for (int h = warp; h < G; h += kWarps) {
      float a = 0.f;
      for (int d = lane; d < D; d += 32) a = fmaxf(a, fabsf(qf[h * D + d]));
      for (int off = 16; off > 0; off >>= 1)
        a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
      if (lane == 0) qscale[h] = fmaxf(a / 127.0f, 1e-8f);
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      const float v = rintf(qf[i] / qscale[i / D]);
      qi[i] = (int8_t)fminf(fmaxf(v, -127.f), 127.f);
    }
    __syncthreads();
  }

  // ---- scores over the valid slots [st, len)
  int qreg[kInt8 ? G * 4 : 1];
  float qfr[kInt8 ? 1 : G * E];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    if constexpr (kInt8) {
      const int4 w4 = *reinterpret_cast<const int4*>(qi + h * D + c * E);
      qreg[h * 4 + 0] = w4.x; qreg[h * 4 + 1] = w4.y;
      qreg[h * 4 + 2] = w4.z; qreg[h * 4 + 3] = w4.w;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qfr[h * E + e] = qf[h * D + c * E + e];
    }
  }
  for (int base = st + warp * rpw; base < len; base += kWarps * rpw) {
    const int s = base + rr;
    const bool ok = s < len;
    int4 raw = make_int4(0, 0, 0, 0);
    if (ok) {
      const char* kr = reinterpret_cast<const char*>(kc) +
                       ((row0 + s) * D) * esize + c * 16;
      raw = *reinterpret_cast<const int4*>(kr);
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float dot;
      if constexpr (kInt8) {
        int a = __dp4a(raw.x, qreg[h * 4 + 0], 0);
        a = __dp4a(raw.y, qreg[h * 4 + 1], a);
        a = __dp4a(raw.z, qreg[h * 4 + 2], a);
        a = __dp4a(raw.w, qreg[h * 4 + 3], a);
        for (int off = cpr / 2; off > 0; off >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, off);
        dot = (float)a;
      } else {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) a = fmaf(qfr[h * E + e], bf16_at(raw, e), a);
        for (int off = cpr / 2; off > 0; off >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, off);
        dot = a;
      }
      if (ok && c == 0) {
        float sv;
        if constexpr (kInt8)
          sv = __fmul_rn(__fmul_rn(__fmul_rn(dot, qscale[h]),
                                   ks[((size_t)hk * B + b) * Sp + s]), scale);
        else
          sv = __fmul_rn(dot, scale);
        if constexpr (kSoftcap)
          sv = __fmul_rn(tanhf(__fdiv_rn(sv, softcap)), softcap);
        sc[h * S + s] = sv;
      }
    }
  }
  __syncthreads();

  // ---- softmax over the staged scores (two passes) and p quantization
  float m[G], l[G], pmax[G];
#pragma unroll
  for (int h = 0; h < G; ++h) m[h] = __int_as_float(0xff800000);  // -inf
  for (int s = st + tid; s < len; s += kThreads)
#pragma unroll
    for (int h = 0; h < G; ++h) m[h] = fmaxf(m[h], sc[h * S + s]);
  block_reduce<G, true>(m, red);
#pragma unroll
  for (int h = 0; h < G; ++h) { l[h] = 0.f; pmax[h] = 0.f; }
  for (int s = st + tid; s < len; s += kThreads) {
    const float vsc = kInt8 ? vs[((size_t)hk * B + b) * Sp + s] : 1.f;
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const float p = expf(sc[h * S + s] - m[h]);
      l[h] += p;
      if constexpr (kInt8) {
        const float p2 = __fmul_rn(p, vsc);
        pmax[h] = fmaxf(pmax[h], p2);
        sc[h * S + s] = p2;
      } else {
        sc[h * S + s] = __bfloat162float(__float2bfloat16_rn(p));
      }
    }
  }
  block_reduce<G, false>(l, red);
  __shared__ float s_l[G], s_pscale[G];
  float pscale[G];
  if constexpr (kInt8) {
    block_reduce<G, true>(pmax, red);
#pragma unroll
    for (int h = 0; h < G; ++h) pscale[h] = fmaxf(pmax[h] / 127.0f, 1e-20f);
    for (int s = st + tid; s < len; s += kThreads)
#pragma unroll
      for (int h = 0; h < G; ++h)
        sc[h * S + s] = rintf(sc[h * S + s] / pscale[h]);
    __syncthreads();
  }

  // ---- p . v over the valid slots
  int acci[kInt8 ? G * E : 1];
  float accf[kInt8 ? 1 : G * E];
#pragma unroll
  for (int i = 0; i < G * E; ++i) {
    if constexpr (kInt8) acci[i] = 0; else accf[i] = 0.f;
  }
  for (int base = st + warp * rpw; base < len; base += kWarps * rpw) {
    const int s = base + rr;
    if (s < len) {
      const char* vr = reinterpret_cast<const char*>(vc) +
                       ((row0 + s) * D) * esize + c * 16;
      const int4 raw = *reinterpret_cast<const int4*>(vr);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float p = sc[h * S + s];
        if constexpr (kInt8) {
          const int pi = (int)p;
#pragma unroll
          for (int e = 0; e < E; ++e) acci[h * E + e] += pi * s8_at(raw, e);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e)
            accf[h * E + e] = fmaf(p, bf16_at(raw, e), accf[h * E + e]);
        }
      }
    }
  }
  // rows within a warp -> lanes rr == 0, then warps through shared memory
#pragma unroll
  for (int i = 0; i < G * E; ++i) {
    for (int off = cpr; off < 32; off <<= 1) {
      if constexpr (kInt8) acci[i] += __shfl_xor_sync(0xffffffffu, acci[i], off);
      else accf[i] += __shfl_xor_sync(0xffffffffu, accf[i], off);
    }
  }
  if (rr == 0) {
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if constexpr (kInt8)
          pv_red[(warp * G + h) * D + c * E + e] = __int_as_float(acci[h * E + e]);
        else
          pv_red[(warp * G + h) * D + c * E + e] = accf[h * E + e];
      }
  }
  if (tid == 0) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      s_l[h] = l[h];
      if constexpr (kInt8) s_pscale[h] = pscale[h];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int h = i / D;
    float r;
    if constexpr (kInt8) {
      int a = 0;
      for (int w = 0; w < kWarps; ++w) a += __float_as_int(pv_red[w * G * D + i]);
      r = __fdiv_rn(__fmul_rn((float)a, s_pscale[h]), s_l[h]);
    } else {
      float a = 0.f;
      for (int w = 0; w < kWarps; ++w) a += pv_red[w * G * D + i];
      r = __fdiv_rn(a, s_l[h]);
    }
    o[i] = __float2bfloat16_rn(r);
  }
}

template <int G, bool kInt8, bool kSoftcap>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* lengths, int length_all,
           const void* starts, void* out, int B, int n_kv, int S, int Sp,
           int D, float scale, float softcap, cudaStream_t stream) {
  static int smem_limit = 48 * 1024;
  const int smem = G * S * 4 + kWarps * G * D * 4 + G * D * 4 + G * D;
  if (smem > smem_limit) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel<G, kInt8, kSoftcap>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_limit = smem;
  }
  dim3 grid(n_kv, B);
  flash_decode_kernel<G, kInt8, kSoftcap><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, k, v, (const float*)ks, (const float*)vs,
      (const int32_t*)lengths, length_all, (const int32_t*)starts,
      (__nv_bfloat16*)out, B, S, Sp, D, scale, softcap);
  return (int)cudaGetLastError();
}

template <bool kInt8, bool kSoftcap>
int dispatch(int g, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, const void* lengths,
             int length_all, const void* starts, void* out, int B, int n_kv,
             int S, int Sp, int D, float scale, float softcap,
             cudaStream_t stream) {
  switch (g) {
#define MIXQ_FD_CASE(G)                                                     \
  case G:                                                                   \
    return launch<G, kInt8, kSoftcap>(q, k, v, ks, vs, lengths, length_all, \
                                      starts, out, B, n_kv, S, Sp, D, scale, \
                                      softcap, stream);
    MIXQ_FD_CASE(1)
    MIXQ_FD_CASE(2)
    MIXQ_FD_CASE(4)
    MIXQ_FD_CASE(8)
#undef MIXQ_FD_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// softcap > 0: scores = tanh(scores / softcap) * softcap after the scale.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* ks,
                                   const void* vs, const void* lengths,
                                   int length_all, const void* starts,
                                   void* out, int B, int n_kv, int g, int S,
                                   int Sp, int D, float scale, float softcap,
                                   int int8, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool cap = softcap > 0.f;
  if (int8)
    return cap ? dispatch<true, true>(g, q, k, v, ks, vs, lengths, length_all,
                                      starts, out, B, n_kv, S, Sp, D, scale,
                                      softcap, st)
               : dispatch<true, false>(g, q, k, v, ks, vs, lengths,
                                       length_all, starts, out, B, n_kv, S,
                                       Sp, D, scale, softcap, st);
  return cap ? dispatch<false, true>(g, q, k, v, ks, vs, lengths, length_all,
                                     starts, out, B, n_kv, S, Sp, D, scale,
                                     softcap, st)
             : dispatch<false, false>(g, q, k, v, ks, vs, lengths, length_all,
                                      starts, out, B, n_kv, S, Sp, D, scale,
                                      softcap, st);
}
