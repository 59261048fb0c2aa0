// What the kernels of this directory share: the dropout counter hash
// (flash_fwd.cu and flash_bwd.cu), the f32 <-> input-dtype conversions, the
// warp reductions, the small pieces of the flash kernels' tiles (exp2, bf16
// packing, paired stores, the causal key range) and the fixed-order merge
// of split partials (paged_decode.cu, paged_chunk.cu).  The hash
// must be bit-identical in both kernels, in ops/attention.py's plain
// version and in the JAX package: the backward replays the forward's
// keep-mask from the seed.
// ops/_kernels.py folds this header into each library's build hash.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace zoo_flash {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// counter hash: lowbias32 finaliser, computed in uint32 so shifts are
// logical and multiplies wrap, exactly as the int32 JAX version behaves
constexpr uint32_t kMixC1 = 0x7FEB352Du;
constexpr uint32_t kMixC2 = 0x846CA68Bu;
constexpr uint32_t kSeedC = 0x9E3779B9u;
constexpr uint32_t kQC = 0x85EBCA77u;
constexpr uint32_t kKC = 0xC2B2AE3Du;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= kMixC1;
  x ^= x >> 15;
  x *= kMixC2;
  return x ^ (x >> 16);
}

// per-(batch, head) stream of the hash: mix32(seed * kSeedC ^ bh)
__device__ __forceinline__ uint32_t head_hash(uint32_t seed, int bh) {
  return mix32(seed * kSeedC ^ static_cast<uint32_t>(bh));
}

// keep iff the top 24 bits of mix32(head ^ q*kQC ^ k*kKC) reach thresh
__device__ __forceinline__ bool keep(uint32_t head, int q_pos, int k_pos,
                                     uint32_t thresh) {
  const uint32_t bits = mix32(head ^ (static_cast<uint32_t>(q_pos) * kQC) ^
                              (static_cast<uint32_t>(k_pos) * kKC));
  return (bits >> 8) >= thresh;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// 2^x in one MUFU instruction (exp2f adds a denormal fix-up around it);
// 2^-inf = 0, and results below 2^-126 flush to 0, which no weight minds
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Column d of the merge of n split partials of one row, in split order:
// partial s is an output row normalised by its own sum (o + s * o_step,
// f32) with the log-sum-exp of its scaled scores (lse[s * lse_step], -1e30
// where it saw no key); returns sum_s w_s o_s[d] / sum_s w_s with
// w_s = exp(lse_s - max_s lse_s), and 0 for n == 0.  No atomics: the same
// partials give the same bits.
__device__ __forceinline__ float merge_splits(const float* o, int64_t o_step,
                                              const float* lse,
                                              int64_t lse_step, int n,
                                              int d) {
  float mx = kNegInf;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, lse[s * lse_step]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n; ++s) {
    const float w = expf(lse[s * lse_step] - mx);
    num = fmaf(w, o[s * o_step + d], num);
    den += w;
  }
  return n > 0 ? num / den : 0.f;
}

// last key (exclusive) that rows [lo, hi) may see
__device__ __forceinline__ int key_end(int lo, int hi, int Tq, int Tk,
                                       int causal) {
  if (!causal) return Tk;
  const int last_row = min(hi, Tq) - 1;
  return min(Tk, max(0, last_row + Tk - Tq + 1));
}

}  // namespace zoo_flash
