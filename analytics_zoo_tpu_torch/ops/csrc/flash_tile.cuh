// The tiles of the flash forward, shared by flash_fwd.cu and paged_chunk.cu:
// the online-softmax step on accumulator fragments, the epilogue, the bf16
// tile geometry with its wgmma products (S = Q.K^T from swizzled shared
// memory, O += P.V with P from registers), and the f32 3xTF32 mma.sync
// products on padded staged tiles.
//
// Both products leave each thread the same accumulator fragment: rows g and
// g + 8 of a 16-row slice, columns 8j + 2c and 8j + 2c + 1, g = lane / 4,
// c = lane % 4 (wgmma's m64 per warp, mma.sync's m16n8 per n-chunk), so
// the masks, the softmax and the epilogue below serve both.
// ops/_kernels.py folds this header into each library's build hash.

#pragma once

#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace zoo_flash {

constexpr float kLn2 = 0.6931471805599453f;
constexpr float kInf = INFINITY;

// what the softmax of every tile of one (batch, head) needs
struct TileCtx {
  const int32_t* mrow;  // (Tk) padding mask row, 0 = padded key; or null
  int Tk;               // keys at or past Tk are masked
  int causal_offset;    // row i sees key j iff j <= i + causal_offset
  int causal;
  float scale2;         // sm_scale * log2(e): exp2 of raw scores
  uint32_t head;        // head_hash(seed, bh_offset + b*H + h)
  uint32_t thresh;      // drop iff (bits >> 8) < thresh; 0 = no dropout
  float keep_scale;
};

// Whether a tile of n keys from k0 needs per-score masking for rows from
// row_lo on: a padding mask, the ragged end of the keys, or the diagonal.
__device__ __forceinline__ bool tile_masked(const TileCtx& x, int k0, int n,
                                            int row_lo) {
  return x.mrow != nullptr || k0 + n > x.Tk ||
         (x.causal && k0 + n - 1 > row_lo + x.causal_offset);
}

// The online-softmax step of one tile of raw scores held as accumulator
// fragments (NC chunks of 8 keys: s[4j + 2h + e] is row r0 + 8h, key
// k0 + 8j + 2c + e).  kMask: the masks are applied per score (else the
// tile is known to be wholly visible); kDrop: dropout.  Updates the
// running max m (raw units, -inf while a row has seen no key) and the
// thread's partial sum l (rows r0, r0 + 8), returns each row's rescale
// factor in alpha and leaves in s the probabilities after dropout:
// p = exp2(s * scale2 - m * scale2), one FFMA and one exp2 a score.  Max
// and sum run as two interleaved chains for instruction-level parallelism.
template <int NC, bool kMask, bool kDrop>
__device__ __forceinline__ void online_softmax(float (&s)[NC * 4],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2],
                                               const TileCtx& x, int r0,
                                               int k0, int c) {
  if (kMask) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * c + e;
        const bool kv =
            key < x.Tk && (x.mrow == nullptr || x.mrow[key] != 0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool ok =
              kv && (!x.causal || key <= r0 + 8 * h + x.causal_offset);
          if (!ok) s[4 * j + 2 * h + e] = -kInf;
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx[2] = {-kInf, -kInf};
#pragma unroll
    for (int j = 0; j < NC; ++j)
      mx[j & 1] = fmaxf(mx[j & 1],
                        fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    float mxr = fmaxf(mx[0], mx[1]);
    mxr = fmaxf(mxr, __shfl_xor_sync(0xffffffffu, mxr, 1));
    mxr = fmaxf(mxr, __shfl_xor_sync(0xffffffffu, mxr, 2));
    const float m_new = fmaxf(m[h], mxr);
    // a row that has seen no key keeps m = -inf and gets p = 0, alpha = 0
    const float base = m_new == -kInf ? 0.f : m_new * x.scale2;
    alpha[h] = fast_exp2(m[h] * x.scale2 - base);
    m[h] = m_new;
    float psum[2] = {0.f, 0.f};
    const int row = r0 + 8 * h;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = s[4 * j + 2 * h + e];
        float pv = fast_exp2(fmaf(v, x.scale2, -base));
        psum[e] += pv;  // the normaliser takes the weights before dropout
        if (kDrop)
          pv = keep(x.head, row, k0 + 8 * j + 2 * c + e, x.thresh)
                   ? pv * x.keep_scale
                   : 0.f;
        v = pv;
      }
    }
    l[h] = alpha[h] * l[h] + (psum[0] + psum[1]);
  }
}

// online_softmax with the per-score work the tile needs
template <int NC>
__device__ __forceinline__ void softmax_tile(float (&s)[NC * 4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             const TileCtx& x, int r0,
                                             int k0, int c, bool masked) {
  if (x.thresh) {
    if (masked)
      online_softmax<NC, true, true>(s, m, l, alpha, x, r0, k0, c);
    else
      online_softmax<NC, false, true>(s, m, l, alpha, x, r0, k0, c);
  } else {
    if (masked)
      online_softmax<NC, true, false>(s, m, l, alpha, x, r0, k0, c);
    else
      online_softmax<NC, false, false>(s, m, l, alpha, x, r0, k0, c);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&a)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= a[(i >> 1) & 1];
}

// Output rows r0 and r0 + 8 of the accumulator fragment o (D columns),
// divided by the quad-reduced row sums (rows that saw no key give zeros);
// lse in the units of the scaled scores, -1e30 for such rows, when asked.
template <typename T, int D>
__device__ __forceinline__ void store_rows(const float (&o)[D / 2],
                                           float (&l)[2], const float (&m)[2],
                                           float scale2, T* og, int64_t o_st,
                                           float* lse, int r0, int Tq,
                                           int c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= Tq) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(og + row * o_st + 8 * j + 2 * c, o[4 * j + 2 * h] * inv,
             o[4 * j + 2 * h + 1] * inv);
    if (lse != nullptr && c == 0)
      lse[row] = l[h] > 0.f ? m[h] * scale2 * kLn2 + logf(l[h]) : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// bf16 on wgmma

// The shared-memory layout of the bf16 tiles: D split into atoms of one
// swizzle row (64 columns, 128 bytes; D 32: 64 bytes), each atom a box of
// rows x row bytes, 16-byte chunk q of row r stored at chunk q ^ swizzle(r)
// (TMA's 128- / 64-byte swizzle, what the wgmma descriptors read).  Q boxes
// hold 64 rows, K / V boxes BN rows.
template <int D, int BN>
struct BfTile {
  static constexpr int kAtomCols = D < 64 ? D : 64;  // one swizzle row
  static constexpr int kRowBytes = kAtomCols * 2;    // 64 or 128
  static constexpr int kAtoms = D / kAtomCols;       // boxes across D
  static constexpr uint32_t kSwizzle = kRowBytes == 128 ? 1 : 2;
  static constexpr int kQAtomBytes = 64 * kRowBytes;  // a 64-row Q box
  static constexpr int kQTile = kAtoms * kQAtomBytes;
  static constexpr int kKVAtomBytes = BN * kRowBytes;  // a BN-row K/V box
  static constexpr int kKVTile = kAtoms * kKVAtomBytes;

  // byte offset in a box of `rows` rows of the 16-byte chunk `chunk`
  // (0 .. D / 8) of row r, swizzled as TMA stores it
  static __device__ __forceinline__ uint32_t chunk_offset(int r, int chunk,
                                                          int rows) {
    constexpr int kChunksPerRow = kRowBytes / 16;  // 8 or 4
    const int atom = chunk / kChunksPerRow;
    const int q = chunk % kChunksPerRow;
    const int sw = kRowBytes == 128 ? (r & 7) : ((r >> 1) & 3);
    return atom * rows * kRowBytes + r * kRowBytes + ((q ^ sw) << 4);
  }
};

// Start S (64 x BN, f32) = Q.K^T for one warpgroup: Q a 64-row tile at
// q_base, K a BN-row tile at k_base (both K-major); commits, does not wait.
template <int D, int BN>
__device__ __forceinline__ void bf16_qk(float (&sc)[BN / 2], uint32_t q_base,
                                        uint32_t k_base) {
  using L = BfTile<D, BN>;
  constexpr int kStepsPerAtom = L::kRowBytes / 32;  // k16 steps in a row
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
  zoo_hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t atom = kk / kStepsPerAtom;
    const uint32_t within = (kk % kStepsPerAtom) * 32;
    zoo_hopper::wgmma_ss(
        sc,
        zoo_hopper::wgmma_desc(q_base + atom * L::kQAtomBytes + within, 16,
                               8 * L::kRowBytes, L::kSwizzle),
        zoo_hopper::wgmma_desc(k_base + atom * L::kKVAtomBytes + within, 16,
                               8 * L::kRowBytes, L::kSwizzle),
        kk > 0);
  }
  zoo_hopper::wgmma_commit();
}

// O (64 x D) += P.V for one warpgroup: P the probabilities in sc, rounded
// to bf16 A fragments in registers (16 keys, two 8-key chunks, a k step);
// V a BN-row tile at v_base read MN-major (the descriptor's transpose
// bit).  Waits for the product.
template <int D, int BN>
__device__ __forceinline__ void bf16_pv(float (&o)[D / 2],
                                        const float (&sc)[BN / 2],
                                        uint32_t v_base) {
  using L = BfTile<D, BN>;
  uint32_t pa[BN / 16][4];
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
  }
  zoo_hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    zoo_hopper::wgmma_rs(
        o, pa[kk],
        zoo_hopper::wgmma_desc(v_base + kk * 16 * L::kRowBytes,
                               L::kKVAtomBytes, 8 * L::kRowBytes,
                               L::kSwizzle));
  zoo_hopper::wgmma_commit();
  zoo_hopper::wgmma_wait_all();
}

// ---------------------------------------------------------------------------
// f32 on 3xTF32 mma.sync

constexpr int kF32BlockN = 64;  // keys a staged tile

// K and V tiles of kF32BlockN keys staged as f32 rows padded by 4 floats,
// so every fragment load is free of bank conflicts
template <int D>
struct F32Tile {
  static constexpr int kPitch = D + 4;  // floats a staged row
  static constexpr int kTile = kF32BlockN * kPitch;
};

// S (16 x 64, f32) of one warp's rows = Q.K^T: qf the warp's Q A fragments
// (rows r0 / r0 + 8, columns 8kd + c / + 4), ks the staged K tile
template <int D>
__device__ __forceinline__ void f32_qk(float (&sc)[32],
                                       const float (&qf)[D / 8][4],
                                       const float* ks, int g, int c) {
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
#pragma unroll
  for (int kd = 0; kd < D / 8; ++kd) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) zoo_hopper::split_tf32(qf[kd][i], ah[i], al[i]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float* kr = ks + (8 * nt + g) * F32Tile<D>::kPitch + 8 * kd + c;
      zoo_hopper::mma_3xtf32(*reinterpret_cast<float(*)[4]>(sc + 4 * nt), ah,
                             al, kr[0], kr[4]);
    }
  }
}

// O (16 x D) += P.V for one warp: P in sc (the A operand reads its keys in
// the order S's accumulator holds them: k index c is key 2c, c + 4 is key
// 2c + 1, so P needs no shuffle), vs the staged V tile
template <int D>
__device__ __forceinline__ void f32_pv(float (&o)[D / 2],
                                       const float (&sc)[32],
                                       const float* vs, int g, int c) {
  constexpr int kPitch = F32Tile<D>::kPitch;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const float pf[4] = {sc[4 * kk], sc[4 * kk + 2], sc[4 * kk + 1],
                         sc[4 * kk + 3]};
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) zoo_hopper::split_tf32(pf[i], ph[i], pl[i]);
    const float* vr = vs + (8 * kk + 2 * c) * kPitch + g;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      zoo_hopper::mma_3xtf32(*reinterpret_cast<float(*)[4]>(o + 4 * nt), ph,
                             pl, vr[8 * nt], vr[kPitch + 8 * nt]);
  }
}

}  // namespace zoo_flash
