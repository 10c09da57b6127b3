// Thread-block cluster helpers shared by the kernels that split work over a
// cluster and reduce it through distributed shared memory (DSMEM):
// csrc/mix_gemm.cu (split-K) and csrc/flash_decode.cu (a row's slots).
// sm_90; built for sm_90a.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace mixq {

// The cluster barrier in two halves, so work can go between them: arrive
// releases this thread's shared-memory accesses, wait acquires every
// thread's in the cluster. Every thread of every block of the cluster must
// reach both (an early return before one hangs the cluster).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The address of shared-memory address `at` in cluster rank `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t at, int rank) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d)
               : "r"(at), "r"(rank));
  return d;
}

// 16 bytes of a cluster rank's shared memory when `pred`, else zeros.
__device__ __forceinline__ int4 ld_cluster_if(bool pred, uint32_t at) {
  int4 v = make_int4(0, 0, 0, 0);
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %4, 0;\n"
      " @p ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%5];\n}\n"
      : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w)
      : "r"((int)pred), "r"(at));
  return v;
}

// 4 bytes of a cluster rank's shared memory.
__device__ __forceinline__ uint32_t ld_cluster_u32(uint32_t at) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(at));
  return v;
}

// Rank r's part [first, end) of the range [lo, hi) cut into R contiguous
// parts of whole units of `unit` positions: the n = ceil((hi - lo) / unit)
// units split as n / R, one more for the first n % R ranks; the last part
// ends at hi. An empty range (hi <= lo) gives every rank an empty part, and
// so does R beyond the units for the ranks past them.
// (kernels/flash_decode.py::rank_bounds is the same rule.)
__device__ __forceinline__ int2 rank_part(int lo, int hi, int unit, int R,
                                          int r) {
  const int n = hi > lo ? (hi - lo + unit - 1) / unit : 0;
  const int base = n / R, extra = n % R;
  const int first = r * base + min(r, extra);
  const int a = lo + first * unit;
  const int b = lo + (first + base + (r < extra)) * unit;
  return make_int2(min(a, hi), min(b, hi));
}

// The reductions over the cluster's R ranks of one 4-byte value that each
// rank keeps at the same shared-memory address `mine`, read through DSMEM
// rank by rank: a max, an f32 sum in rank order (__fadd_rn, so one plan
// always gives the same bits), an int32 sum (exact in any order). The
// caller puts a cluster barrier between the writes and these reads, and
// another before any rank overwrites or leaves its value.
__device__ __forceinline__ float cluster_max_f32(const float* mine, int R) {
  const uint32_t at = (uint32_t)__cvta_generic_to_shared(mine);
  float x = __uint_as_float(ld_cluster_u32(map_rank(at, 0)));
  for (int p = 1; p < R; ++p)
    x = fmaxf(x, __uint_as_float(ld_cluster_u32(map_rank(at, p))));
  return x;
}
__device__ __forceinline__ float cluster_sum_f32(const float* mine, int R) {
  const uint32_t at = (uint32_t)__cvta_generic_to_shared(mine);
  float x = __uint_as_float(ld_cluster_u32(map_rank(at, 0)));
  for (int p = 1; p < R; ++p)
    x = __fadd_rn(x, __uint_as_float(ld_cluster_u32(map_rank(at, p))));
  return x;
}
__device__ __forceinline__ int cluster_sum_s32(const int* mine, int R) {
  const uint32_t at = (uint32_t)__cvta_generic_to_shared(mine);
  int x = (int)ld_cluster_u32(map_rank(at, 0));
  for (int p = 1; p < R; ++p) x += (int)ld_cluster_u32(map_rank(at, p));
  return x;
}

}  // namespace mixq
