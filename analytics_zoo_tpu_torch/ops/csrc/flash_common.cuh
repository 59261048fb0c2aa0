// What the flash-attention forward (flash_fwd.cu) and backward
// (flash_bwd.cu) share: the dropout counter hash, the f32 <-> input-dtype
// conversions and the warp reductions.  The hash must be bit-identical in
// both kernels, in ops/attention.py's plain version and in the JAX
// package: the backward replays the forward's keep-mask from the seed.
// ops/_kernels.py folds this header into each library's build hash.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace zoo_flash {

constexpr float kNegInf = -1e30f;

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

// x rounded to T and read back as f32 (what a cast to the input dtype
// before a product does)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
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

}  // namespace zoo_flash
