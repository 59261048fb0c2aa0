// Flash-attention backward for Hopper (sm_90a), behind a plain C interface
// that analytics_zoo_tpu_torch/ops/_kernels.py loads with ctypes.
//
// Replaces: analytics_zoo_tpu/ops/attention.py::_bwd_kernel_single (the
// Pallas TPU kernel launched by _bwd_single_pallas, taken when all of K
// fits one block) and its jnp sibling _blockwise_bwd (the two-pass scan
// for long K): entry point zoo_flash_bwd.  It tiles over K, so it has no
// one-block limit and serves both regimes with no dispatch rule between
// them.  Entry point zoo_flash_bwd_lse is the same kernels for one block
// of ring attention (parallel/ring.py): no mask, no dropout, the ring's
// global lse and delta given, and dq, dk, dv added into f32 accumulators
// in place.  The JAX ring computes that block in jnp
// (analytics_zoo_tpu/parallel/ring.py::_block_grads), so it replaces no
// TPU kernel; in bf16 it rounds P and dS to bf16 before their products
// where the JAX ring keeps f32, so its bf16 gradients are held to the
// backward's bf16 tolerance against the ring with plain blocks.
//
// Same function as the JAX kernels: P = exp(s * scale - lse) in f32 from
// the forward's row log-sum-exp (P = 0 where masked and on rows with
// lse = -1e30, which see no key), the forward's dropout keep-mask replayed
// from the counter hash over (seed, bh_offset + b*H+h, q_pos, k_pos),
// delta = rowsum(g * o), Z = keep ? P/(1-r) : 0,
// dP = keep ? (g v^T)/(1-r) : 0, dS = P * (dP - delta) * scale, then
// dv = Z^T g, dq = dS k, dk = dS^T q, with Z and dS rounded to the input
// dtype before their products, f32 accumulation, end-aligned causal (row i
// sees key j iff j <= i + Tk - Tq), an optional (B, Tk) padding mask.
//
// What bounds it on an H100: five products, 10*Tq*Tk*D flops per head,
// against 8*T*D elements moved: at BERT's T = 128, D = 64 about 40 flops a
// byte in f32 and 80 in bf16, below the tensor cores' ridge (the bytes
// bound: 0.030 ms f32, 0.015 ms bf16 at B32 H12), and about 1300 at the
// ring's 4096-row blocks, where the products bound it (bf16 at 989
// TFLOP/s, f32 at the 3xTF32 rate of 165).
//
// What the design does about it: the products run on the tensor cores,
// and lse comes from the forward (no statistics pass).  One call launches
// a delta pre-pass (zoo_flash_bwd only: delta = rowsum(g * o), one read of
// o and g) and one grid.  Its dk/dv blocks own 64 keys of one (batch,
// head) and stream the Q / dO tiles that see them (causal tiles above the
// diagonal skipped): S^T = K.Q^T and dP^T = V.dO^T, then dv += Z^T.dO and
// dk += dS^T.Q.  dq needs a sum over key tiles, which blocks run in no
// order; no float atomics, so two runs stay bit-identical and the ring's
// in-place adds deterministic.  Two ways, picked by measurement on the
// H100 (PERF.md):
// - bf16: dq blocks beside the dk/dv blocks in the same grid, so both run
//   at once: each owns 64 query rows and streams the K / V tiles they
//   see, S = Q.K^T and dP = dO.V^T again, then dS in registers and
//   dq += dS.K: seven products where one pass would take five, but every
//   product keeps its operand in registers (the four of a role chain
//   through the accumulators) and nothing is staged but the inputs.
//   Measured faster than the f32 scheme below, built for bf16 with dS
//   staged in shared memory: by 12 % at BERT's T 128 and 4.6 times on a
//   4,096-row ring block.
// - f32: the dk/dv blocks also take dq += dS.K (five products): dS goes
//   through shared memory, and each block adds its dq tile into f32 dq
//   in global memory in key-tile order, behind a per-(batch*head, query
//   tile) counter in global memory that each block waits for and passes
//   on (FA-3's deterministic scheme).  Measured faster than the separate
//   pass at BERT's T 128 and at the ring's blocks.
// Per instruction set:
// - bf16: one consumer warpgroup of 64 rows and one producer warp.  The
//   producer loads the resident Q / dO (or K / V) tile and streams the
//   other pair through two stages with TMA (the forward's 4-D tensor maps
//   and swizzles); S and dP are wgmma m64n64k16 with both operands K-major
//   from shared memory; Z and dS go from the accumulator registers into
//   bf16 A fragments for dv / dk / dq, whose B operand (dO, Q or K) is the
//   same tile read MN-major (the descriptor's transpose bit), as the
//   forward's P.V reads V.  The dk/dv role's producer also stages each
//   streamed tile's lse * log2(e) and delta, since they run along the
//   accumulator's columns there.
// - f32: 3xTF32 on mma.sync m16n8k8 (hi/lo split, as the forward), four
//   warps of 16 keys, the resident and the streamed tiles in shared memory
//   by 16-byte cp.async (rows padded by 4 floats: every fragment load is
//   free of bank conflicts), two stages; streamed tiles of 64 rows (32 at
//   D 128, for registers).  The second-stage products read their k index
//   in the order the accumulator holds it (c <-> 2c, c + 4 <-> 2c + 1), so
//   Z and dS need no shuffle; dS is staged over the stage's spent Q / dO
//   tiles for dq.
//
// Inputs q, k, v, o, g are f32 or bf16 with unit stride in the last
// dimension and (batch, head, seq) strides that are multiples of 16 bytes
// on a 16-byte aligned base (what TMA and cp.async need; the wrapper copies
// a view that is not); the outputs are written through their own strides.

#include <cuda.h>
#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace zoo_flash;
using namespace zoo_hopper;

constexpr float kInf = INFINITY;

struct Params {
  CUtensorMap tq, tk, tv, tg;  // bf16: (D, T, H, B) maps, 64-row boxes
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const int32_t* mask;  // (B, Tk), 0 = padded key; or null
  const float* lse;     // (B, H, Tq): log-sum-exp of the scaled scores
  const float* delta;   // (B, H, Tq): rowsum(g * o)
  void* dq;
  void* dk;
  void* dv;
  int* turns;  // f32: (B*H, query tiles) counters of the dq sums, zeroed
  int64_t s[21];  // q, k, v, g, dq, dk, dv: (batch, head, seq) strides
  int64_t lse_sb, lse_sh, dl_sb, dl_sh;
  int H, Tq, Tk;
  float scale;   // sm_scale
  float scale2;  // sm_scale * log2(e)
  int causal;
  uint32_t thresh;  // drop iff (bits >> 8) < thresh; 0 = no dropout
  float keep_scale;
  const int32_t* seed;  // one int32 in device memory; read iff thresh
  uint32_t bh_offset;   // the global b*H + h of this launch's first head
};

// what the elementwise step of every tile of one (batch, head) needs
struct Ctx {
  const int32_t* mrow;
  int Tk;
  int off;  // Tk - Tq: query q sees key j iff j <= q + off
  int causal;
  float scale, scale2;
  uint32_t head;  // head_hash(seed, bh_offset + b*H + h)
  uint32_t thresh;
  float keep_scale;
};

__device__ __forceinline__ Ctx make_ctx(const Params& p, int b, int bh) {
  Ctx x;
  x.mrow = p.mask ? p.mask + static_cast<int64_t>(b) * p.Tk : nullptr;
  x.Tk = p.Tk;
  x.off = p.Tk - p.Tq;
  x.causal = p.causal;
  x.scale = p.scale;
  x.scale2 = p.scale2;
  // read from device memory, so a replayed CUDA graph sees each replay's
  x.head = p.thresh ? head_hash(static_cast<uint32_t>(__ldg(p.seed)),
                               p.bh_offset + static_cast<uint32_t>(bh))
                    : 0u;
  x.thresh = p.thresh;
  x.keep_scale = p.keep_scale;
  return x;
}

// a query row's lse * log2(e) (+inf past Tq or where the row sees no key,
// so its P is 0) and delta (0 past Tq)
__device__ __forceinline__ void row_stats(const Params& p, int b, int h,
                                          int row, float& l2, float& dl) {
  if (row < p.Tq) {
    const float lse = p.lse[b * p.lse_sb + h * p.lse_sh + row];
    l2 = lse > 0.5f * kNegInf ? lse * kLog2e : kInf;
    dl = p.delta[b * p.dl_sb + h * p.dl_sh + row];
  } else {
    l2 = kInf;
    dl = 0.f;
  }
}

// the statistics of a tile's query rows: two rows a thread in registers
// (dq role), or the streamed tile's rows in shared memory, indexed by
// column (dk/dv role)
struct Stats {
  float l2r[2], dlr[2];
  const float* l2c;
  const float* dlc;
};

// Whether keys [k0, k0 + nk) against queries from q_lo on need per-score
// masks: a padding mask, the ragged end of the keys, or the diagonal.
// Queries past Tq need none: their lse is +inf.
__device__ __forceinline__ bool tile_masked(const Ctx& x, int k0, int nk,
                                            int q_lo) {
  return x.mrow != nullptr || k0 + nk > x.Tk ||
         (x.causal && k0 + nk - 1 > q_lo + x.off);
}

// The elementwise step on one tile held as accumulator fragments (NC
// chunks of 8 columns: s[4j + 2h + e] is row r0 + 8h, column
// c0 + 8j + 2c + e).  kT: rows are keys and columns queries (the dk/dv
// role), else rows are queries and columns keys.  In: s the raw scores,
// dp the raw products g.v.  Out: Z in s and dS in dp.
template <int NC, bool kT, bool kMask, bool kDrop>
__device__ __forceinline__ void grad_step(float (&s)[NC * 4],
                                          float (&dp)[NC * 4],
                                          const Stats& st, const Ctx& x,
                                          int r0, int c0, int c) {
#pragma unroll
  for (int j = 0; j < NC; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        const int r = r0 + 8 * h, col = c0 + 8 * j + 2 * c + e;
        const int q = kT ? col : r, key = kT ? r : col;
        const float l2 = kT ? st.l2c[8 * j + 2 * c + e] : st.l2r[h];
        const float dl = kT ? st.dlc[8 * j + 2 * c + e] : st.dlr[h];
        float pr = fast_exp2(fmaf(s[i], x.scale2, -l2));
        if (kMask) {
          const bool ok = key < x.Tk &&
                          (x.mrow == nullptr || x.mrow[key] != 0) &&
                          (!x.causal || key <= q + x.off);
          if (!ok) pr = 0.f;
        }
        float z = pr, d = dp[i];
        if (kDrop) {
          const bool kept = keep(x.head, q, key, x.thresh);
          z = kept ? pr * x.keep_scale : 0.f;
          d = kept ? d * x.keep_scale : 0.f;
        }
        s[i] = z;
        dp[i] = pr * (d - dl) * x.scale;
      }
    }
  }
}

// grad_step with the per-score work the tile needs
template <int NC, bool kT>
__device__ __forceinline__ void grad_tile(float (&s)[NC * 4],
                                          float (&dp)[NC * 4],
                                          const Stats& st, const Ctx& x,
                                          int r0, int c0, int c,
                                          bool masked) {
  if (x.thresh) {
    if (masked)
      grad_step<NC, kT, true, true>(s, dp, st, x, r0, c0, c);
    else
      grad_step<NC, kT, false, true>(s, dp, st, x, r0, c0, c);
  } else {
    if (masked)
      grad_step<NC, kT, true, false>(s, dp, st, x, r0, c0, c);
    else
      grad_step<NC, kT, false, false>(s, dp, st, x, r0, c0, c);
  }
}

// Rows r0 and r0 + 8 of an accumulator fragment (D columns) to `out`
// (rows < T): stored in T_ when kAccum is false, else added to f32.
template <typename T_, bool kAccum, int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           void* out, int64_t base,
                                           int64_t st, int r0, int T, int c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= T) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int64_t at = base + row * st + 8 * j + 2 * c;
      const float a = acc[4 * j + 2 * h], b = acc[4 * j + 2 * h + 1];
      if (kAccum) {
        float2* dst = reinterpret_cast<float2*>(static_cast<float*>(out) + at);
        const float2 was = *dst;
        *dst = make_float2(was.x + a, was.y + b);
      } else {
        store2(static_cast<T_*>(out) + at, a, b);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma with TMA-fed tiles

template <int D>
struct BfCfg {
  static constexpr int kThreads = 128 + 32;  // a warpgroup + a producer warp
  static constexpr int kRows = 64;           // every tile
  static constexpr int kStages = 2;
  static constexpr int kAtomCols = D < 64 ? D : 64;  // one swizzle row
  static constexpr int kRowBytes = kAtomCols * 2;    // 64 or 128
  static constexpr int kAtoms = D / kAtomCols;       // boxes across D
  static constexpr uint32_t kSwizzle = kRowBytes == 128 ? 1 : 2;
  static constexpr int kSteps = kRowBytes / 32;  // k16 steps in one atom
  static constexpr int kAtomBytes = kRows * kRowBytes;
  static constexpr int kTile = kAtoms * kAtomBytes;
  // two resident tiles, two streamed ones a stage, then (dk/dv role) each
  // stage's lse * log2(e) and delta, then the mbarriers
  static constexpr int kStatOffset = (2 + 2 * kStages) * kTile;
  static constexpr int kBarOffset = kStatOffset + kStages * 2 * kRows * 4;
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (2 * kStages + 1);
};

// a K-major operand over the 64-row tile at `tile`: its k16 step kk
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using C = BfCfg<D>;
  return wgmma_desc(tile + (kk / C::kSteps) * C::kAtomBytes +
                        (kk % C::kSteps) * 32,
                    16, 8 * C::kRowBytes, C::kSwizzle);
}

// an MN-major B operand over the 64-row tile at `tile` (its rows the K
// dimension): the k16 step kk, rows 16kk .. 16kk + 15
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  using C = BfCfg<D>;
  return wgmma_desc(tile + kk * 16 * C::kRowBytes, C::kAtomBytes,
                    8 * C::kRowBytes, C::kSwizzle);
}

// one 64-row box per swizzle atom of a (D, T, H, B) map into `dst`
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int h,
                                         int b) {
  using C = BfCfg<D>;
#pragma unroll
  for (int a = 0; a < C::kAtoms; ++a)
    tma_load_4d(dst + a * C::kAtomBytes, map, bar, a * C::kAtomCols, row, h,
                b);
}

// the 64-column accumulator fragment as bf16 A fragments (16 columns, two
// 8-column chunks, a k step)
__device__ __forceinline__ void a_frags(const float (&x)[32],
                                        uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// dq role: 64 query rows at q0; K / V tiles streamed
template <int D, bool kAccum>
__device__ __forceinline__ void bf16_dq(const Params& p, int q0,
                                        uint32_t base) {
  using C = BfCfg<D>;
  const uint32_t sq = base, sg = sq + C::kTile;
  const uint32_t sk = sg + C::kTile;                 // [stage]
  const uint32_t sv = sk + C::kStages * C::kTile;    // [stage]
  const uint32_t full = base + C::kBarOffset;        // [stage]
  const uint32_t empty = full + 8 * C::kStages;      // [stage]
  const uint32_t bar_rows = empty + 8 * C::kStages;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int n_tiles =
      (key_end(q0, q0 + 64, p.Tq, p.Tk, p.causal) + 63) / 64;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's arrival
      mbar_init(empty + 8 * s, 4);  // each consumer warp
    }
    mbar_init(bar_rows, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {  // producer warp: one lane issues every copy
    if (tid == 128 && n_tiles > 0) {
      mbar_expect_tx(bar_rows, 2 * C::kTile);
      tma_tile<D>(sq, &p.tq, bar_rows, q0, h, b);
      tma_tile<D>(sg, &p.tg, bar_rows, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % C::kStages;
        if (it >= C::kStages)  // wait until every warp released the stage
          mbar_wait(empty + 8 * s, (it / C::kStages - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * C::kTile);
        tma_tile<D>(sk + s * C::kTile, &p.tk, full + 8 * s, it * 64, h, b);
        tma_tile<D>(sv + s * C::kTile, &p.tv, full + 8 * s, it * 64, h, b);
      }
    }
    return;
  }

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c = lane & 3;
  const int r0 = q0 + 16 * warp + (lane >> 2);
  const Ctx x = make_ctx(p, b, bh);
  Stats st;
  st.l2c = st.dlc = nullptr;
  row_stats(p, b, h, r0, st.l2r[0], st.dlr[0]);
  row_stats(p, b, h, r0 + 8, st.l2r[1], st.dlr[1]);

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  if (n_tiles > 0) mbar_wait(bar_rows, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % C::kStages;
    mbar_wait(full + 8 * s, (it / C::kStages) & 1);
    const int k0 = it * 64;
    const uint32_t ks = sk + s * C::kTile, vs = sv + s * C::kTile;
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, desc_k<D>(sq, kk), desc_k<D>(ks, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, desc_k<D>(sg, kk), desc_k<D>(vs, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();

    grad_tile<8, false>(sc, dp, st, x, r0, k0, c, tile_masked(x, k0, 64, q0));
    uint32_t da[4][4];
    a_frags(dp, da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dq, da[kk], desc_mn<D>(ks, kk));
    wgmma_commit();
    wgmma_wait_all();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // stage s is free
  }

  store_rows<__nv_bfloat16, kAccum, D>(dq, p.dq, b * p.s[12] + h * p.s[13],
                                       p.s[14], r0, p.Tq, c);
}

// dk/dv role: 64 keys at k0; Q / dO tiles (and their rows' statistics)
// streamed
template <int D, bool kAccum>
__device__ __forceinline__ void bf16_dkdv(const Params& p, int k0,
                                          uint32_t base, uint8_t* sm) {
  using C = BfCfg<D>;
  const uint32_t sk = base, sv = sk + C::kTile;
  const uint32_t sq = sv + C::kTile;                 // [stage]
  const uint32_t sg = sq + C::kStages * C::kTile;    // [stage]
  float* const stats = reinterpret_cast<float*>(sm + C::kStatOffset);
  const uint32_t full = base + C::kBarOffset;        // [stage]
  const uint32_t empty = full + 8 * C::kStages;      // [stage]
  const uint32_t bar_rows = empty + 8 * C::kStages;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  // the query tiles that see any of these keys
  const int t_begin = p.causal ? max(0, k0 - (p.Tk - p.Tq)) / 64 : 0;
  const int n_tiles = max(0, (p.Tq + 63) / 64 - t_begin);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + 8 * s, 32);  // each producer lane
      mbar_init(empty + 8 * s, 4);  // each consumer warp
    }
    mbar_init(bar_rows, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {  // producer warp: lane 0 issues the copies, every lane
                     // stages two rows' statistics
    const int lane = tid - 128;
    if (n_tiles == 0) return;
    if (lane == 0) {
      mbar_expect_tx(bar_rows, 2 * C::kTile);
      tma_tile<D>(sk, &p.tk, bar_rows, k0, h, b);
      tma_tile<D>(sv, &p.tv, bar_rows, k0, h, b);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % C::kStages;
      const int t0 = (t_begin + it) * 64;
      if (it >= C::kStages)
        mbar_wait(empty + 8 * s, (it / C::kStages - 1) & 1);
      float* l2s = stats + s * 2 * C::kRows;
      row_stats(p, b, h, t0 + lane, l2s[lane], l2s[C::kRows + lane]);
      row_stats(p, b, h, t0 + lane + 32, l2s[lane + 32],
                l2s[C::kRows + lane + 32]);
      if (lane == 0) {  // its arrival also releases its own two rows
        mbar_expect_tx(full + 8 * s, 2 * C::kTile);
        tma_tile<D>(sq + s * C::kTile, &p.tq, full + 8 * s, t0, h, b);
        tma_tile<D>(sg + s * C::kTile, &p.tg, full + 8 * s, t0, h, b);
      } else {
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c = lane & 3;
  const int kr0 = k0 + 16 * warp + (lane >> 2);
  const Ctx x = make_ctx(p, b, bh);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  if (n_tiles > 0) mbar_wait(bar_rows, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % C::kStages;
    mbar_wait(full + 8 * s, (it / C::kStages) & 1);
    const int q0 = (t_begin + it) * 64;
    const uint32_t qs = sq + s * C::kTile, gs = sg + s * C::kTile;
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, desc_k<D>(sk, kk), desc_k<D>(qs, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, desc_k<D>(sv, kk), desc_k<D>(gs, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();

    Stats st;
    st.l2c = stats + s * 2 * C::kRows;
    st.dlc = st.l2c + C::kRows;
    grad_tile<8, true>(sc, dp, st, x, kr0, q0, c, tile_masked(x, k0, 64, q0));
    uint32_t za[4][4], da[4][4];
    a_frags(sc, za);
    a_frags(dp, da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dv, za[kk], desc_mn<D>(gs, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dk, da[kk], desc_mn<D>(qs, kk));
    wgmma_commit();
    wgmma_wait_all();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // stage s is free
  }

  store_rows<__nv_bfloat16, kAccum, D>(dk, p.dk, b * p.s[15] + h * p.s[16],
                                       p.s[17], kr0, p.Tk, c);
  store_rows<__nv_bfloat16, kAccum, D>(dv, p.dv, b * p.s[18] + h * p.s[19],
                                       p.s[20], kr0, p.Tk, c);
}

// blocks y < ceil(Tq / 64) take the dq role, the rest the dk/dv role
template <int D, bool kAccum>
__global__ void __launch_bounds__(BfCfg<D>::kThreads, D > 64 ? 1 : 2)
    flash_bwd_bf16(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sm =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int n_q = (p.Tq + 63) / 64;
  const int y = blockIdx.y;
  if (y < n_q)
    bf16_dq<D, kAccum>(p, y * 64, smem_u32(sm));
  else
    bf16_dkdv<D, kAccum>(p, (y - n_q) * 64, smem_u32(sm), sm);
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 on mma.sync with cp.async-fed tiles

template <int D>
struct F32Cfg {
  static constexpr int kThreads = 128;  // four warps of 16 resident rows
  static constexpr int kRows = 64;
  static constexpr int kStream = D > 64 ? 32 : 64;  // streamed rows a tile
  static constexpr int kStages = 2;
  static constexpr int kPitch = D + 4;  // floats a staged row
  static constexpr int kRes = kRows * kPitch;
  static constexpr int kTile = kStream * kPitch;
  // a stage: two streamed tiles, then (dk/dv role) their rows' lse * log2(e)
  // and delta
  static constexpr int kStage = 2 * kTile + 2 * kStream;
  static constexpr size_t kSmem =
      sizeof(float) * (2 * kRes + kStages * kStage);
};

// rows [row0, row0 + n) of a (T, D) slice into a pitched tile by 16-byte
// cp.async; rows past T are zero-filled
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int64_t st, int row0, int n,
                                           int T) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < n * kChunks; i += F32Cfg<D>::kThreads) {
    const int r = i / kChunks;
    const int col = (i - r * kChunks) * 4;
    const int row = row0 + r;
    const bool ok = row < T;
    cp_async_16(smem_u32(dst + r * F32Cfg<D>::kPitch + col),
                src + (ok ? row : 0) * st + col, ok);
  }
}

// the A fragment of rows lo + g, lo + g + 8 and columns 8kd + c, + 4 of a
// pitched tile, split into 3xTF32 halves
template <int D>
__device__ __forceinline__ void a_split(const float* t, int lo, int kd,
                                        int g, int c, uint32_t (&hi)[4],
                                        uint32_t (&lo_)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split_tf32(t[(lo + g + 8 * (i & 1)) * F32Cfg<D>::kPitch + 8 * kd + c +
                 4 * (i >> 1)],
               hi[i], lo_[i]);
}

// chunk kk of an accumulator fragment as an A fragment whose k index c is
// column 2c and c + 4 column 2c + 1, split
__device__ __forceinline__ void acc_split(const float* x, int kk,
                                          uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  const float f[4] = {x[4 * kk], x[4 * kk + 2], x[4 * kk + 1], x[4 * kk + 3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(f[i], hi[i], lo[i]);
}

// Ordered dq (the f32 dk/dv blocks): the block's dS tile (64 keys x BS
// queries, staged in shared memory at `ds`, pitch BS + 4) times its K
// tile, added into the f32 dq rows q0 .. q0 + BS - 1
// once every key tile before this one (`mine` of them) has added its
// share, counted in `*turn`: each dq element is summed in key-tile order,
// so repeats are bit-identical.  `first`: store instead of add.
template <int D>
__device__ __forceinline__ void f32_dq_tile(const float* ds, const float* ks,
                                            float* dqg, int64_t dq_st,
                                            int q0, int Tq, int* turn,
                                            int mine, bool first) {
  using C = F32Cfg<D>;
  constexpr int BS = C::kStream;
  constexpr int kRowBlocks = BS / 16;         // 16-row blocks of the tile
  constexpr int kColSplit = 4 / kRowBlocks;   // warps across D
  constexpr int NC = D / kColSplit;           // columns a warp
  constexpr int kDsPitch = BS + 4;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int rb = warp % kRowBlocks, cb = warp / kRowBlocks;
  float acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C::kRows / 8; ++kk) {
    // A: query rows g / g + 8; k index c is key 2c, c + 4 is key 2c + 1
    const float* d0 = ds + (8 * kk + 2 * c) * kDsPitch + 16 * rb + g;
    const float f[4] = {d0[0], d0[8], d0[kDsPitch], d0[kDsPitch + 8]};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(f[i], ah[i], al[i]);
    const float* kr = ks + (8 * kk + 2 * c) * C::kPitch + cb * NC + g;
#pragma unroll
    for (int nt = 0; nt < NC / 8; ++nt)
      mma_3xtf32(*reinterpret_cast<float(*)[4]>(acc + 4 * nt), ah, al,
                 kr[8 * nt], kr[C::kPitch + 8 * nt]);
  }
  // Wait for the turn; a lost one traps.  This waits only for blocks
  // issued before this one: grid.x = B*H varies fastest, so every block of
  // key tile j - 1 is issued before any block of key tile j.
  if (threadIdx.x == 0) {
    const long long start = clock64();
    while (ld_acquire(turn) != mine)
      if (clock64() - start > (1ll << 34)) __trap();
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * rb + g + 8 * h;
    if (row >= Tq) continue;
#pragma unroll
    for (int nt = 0; nt < NC / 8; ++nt) {
      float2* dst = reinterpret_cast<float2*>(
          dqg + row * dq_st + cb * NC + 8 * nt + 2 * c);
      const float a = acc[4 * nt + 2 * h], b = acc[4 * nt + 2 * h + 1];
      if (first) {
        __stcg(dst, make_float2(a, b));
      } else {
        const float2 was = __ldcg(dst);  // L2: another SM wrote it
        __stcg(dst, make_float2(was.x + a, was.y + b));
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) st_release(turn, mine + 1);
}

// dk/dv role: 64 keys at k0 (16 a warp); Q / dO tiles and their rows'
// statistics streamed; also dq += dS.K, added in key-tile order
template <int D, bool kAccum>
__device__ __forceinline__ void f32_dkdv(const Params& p, int k0,
                                         float* smem) {
  using C = F32Cfg<D>;
  constexpr int BS = C::kStream;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int key_lo = k0 + 16 * warp;
  const int kr0 = key_lo + g;
  const int off = p.Tk - p.Tq;
  const float* qg = static_cast<const float*>(p.q) + b * p.s[0] + h * p.s[1];
  const float* kg = static_cast<const float*>(p.k) + b * p.s[3] + h * p.s[4];
  const float* vg = static_cast<const float*>(p.v) + b * p.s[6] + h * p.s[7];
  const float* gg = static_cast<const float*>(p.g) + b * p.s[9] + h * p.s[10];
  // the query tiles that see any of these keys
  const int t_begin = p.causal ? max(0, k0 - off) / BS : 0;
  const int n_tiles = max(0, (p.Tq + BS - 1) / BS - t_begin);
  float* const ks = smem;
  float* const vs = smem + C::kRes;
  auto stage = [&](int s) { return smem + 2 * C::kRes + s * C::kStage; };
  auto load_qg = [&](int it, int s) {
    const int t0 = (t_begin + it) * BS;
    stage_rows<D>(stage(s), qg, p.s[2], t0, BS, p.Tq);
    stage_rows<D>(stage(s) + C::kTile, gg, p.s[11], t0, BS, p.Tq);
    cp_async_commit();
    float* l2s = stage(s) + 2 * C::kTile;
    for (int i = tid; i < BS; i += C::kThreads)
      row_stats(p, b, h, t0 + i, l2s[i], l2s[BS + i]);
  };
  if (n_tiles > 0) {
    stage_rows<D>(ks, kg, p.s[5], k0, C::kRows, p.Tk);
    stage_rows<D>(vs, vg, p.s[8], k0, C::kRows, p.Tk);
    load_qg(0, 0);
  }
  const Ctx x = make_ctx(p, b, bh);
  float* const dqg = static_cast<float*>(p.dq) + b * p.s[12] + h * p.s[13];
  if (!kAccum && k0 == 0) {
    // key tile 0 writes the dq tiles it sees first; the rows before them
    // (causal, Tq > Tk) see no key at all
    for (int i = tid; i < min(t_begin * BS, p.Tq) * D; i += C::kThreads)
      dqg[(i / D) * p.s[14] + i % D] = 0.f;
  }

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % C::kStages;
    if (it + 1 < n_tiles) {
      load_qg(it + 1, (it + 1) % C::kStages);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it (and its statistics) landed for every thread
    const int q0 = (t_begin + it) * BS;
    float* const qs = stage(s);
    const float* gs = qs + C::kTile;
    float sc[BS / 2], dp[BS / 2];
#pragma unroll
    for (int i = 0; i < BS / 2; ++i) sc[i] = dp[i] = 0.f;
    // this warp's keys are seen from query key_lo - off on (warp-uniform)
    if (!p.causal || q0 + BS - 1 + off >= key_lo) {
#pragma unroll
      for (int kd = 0; kd < D / 8; ++kd) {
        uint32_t kh[4], kl[4], vh[4], vl[4];
        a_split<D>(ks, 16 * warp, kd, g, c, kh, kl);
        a_split<D>(vs, 16 * warp, kd, g, c, vh, vl);
#pragma unroll
        for (int nt = 0; nt < BS / 8; ++nt) {
          const float* qr = qs + (8 * nt + g) * C::kPitch + 8 * kd + c;
          const float* gr = gs + (8 * nt + g) * C::kPitch + 8 * kd + c;
          mma_3xtf32(*reinterpret_cast<float(*)[4]>(sc + 4 * nt), kh, kl,
                     qr[0], qr[4]);
          mma_3xtf32(*reinterpret_cast<float(*)[4]>(dp + 4 * nt), vh, vl,
                     gr[0], gr[4]);
        }
      }
      Stats st;
      st.l2c = qs + 2 * C::kTile;
      st.dlc = st.l2c + BS;
      grad_tile<BS / 8, true>(sc, dp, st, x, kr0, q0, c,
                              tile_masked(x, key_lo, 16, q0));
#pragma unroll
      for (int kk = 0; kk < BS / 8; ++kk) {
        uint32_t zh[4], zl[4], dh[4], dl[4];
        acc_split(sc, kk, zh, zl);
        acc_split(dp, kk, dh, dl);
        const float* gr = gs + (8 * kk + 2 * c) * C::kPitch + g;
        const float* qr = qs + (8 * kk + 2 * c) * C::kPitch + g;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          mma_3xtf32(*reinterpret_cast<float(*)[4]>(dv + 4 * nt), zh, zl,
                     gr[8 * nt], gr[C::kPitch + 8 * nt]);
          mma_3xtf32(*reinterpret_cast<float(*)[4]>(dk + 4 * nt), dh, dl,
                     qr[8 * nt], qr[C::kPitch + 8 * nt]);
        }
      }
    }
    // dS (zeros from a warp that skipped) over this stage's Q / dO tiles,
    // which every warp has finished reading
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BS / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(
            qs + (16 * warp + g + 8 * hh) * (BS + 4) + 8 * j + 2 * c) =
            make_float2(dp[4 * j + 2 * hh], dp[4 * j + 2 * hh + 1]);
    __syncthreads();
    const int t = t_begin + it;
    f32_dq_tile<D>(qs, ks, dqg, p.s[14], q0, p.Tq,
                   p.turns + bh * ((p.Tq + BS - 1) / BS) + t, k0 / 64,
                   !kAccum && k0 == 0);
    __syncthreads();  // stage s may be refilled
  }

  store_rows<float, kAccum, D>(dk, p.dk, b * p.s[15] + h * p.s[16], p.s[17],
                               kr0, p.Tk, c);
  store_rows<float, kAccum, D>(dv, p.dv, b * p.s[18] + h * p.s[19], p.s[20],
                               kr0, p.Tk, c);
}

// one block per (batch * head, key tile)
template <int D, bool kAccum>
__global__ void __launch_bounds__(F32Cfg<D>::kThreads)
    flash_bwd_f32(const __grid_constant__ Params p) {
  extern __shared__ float4 smem_f4[];
  f32_dkdv<D, kAccum>(p, blockIdx.y * 64, reinterpret_cast<float*>(smem_f4));
}

// ---------------------------------------------------------------------------
// the delta pre-pass: delta = rowsum(g * o) in f32, D / 4 threads a row
// with four elements each

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

constexpr int kDeltaThreads = 256;

template <typename T, int D>
__global__ void __launch_bounds__(kDeltaThreads)
    flash_bwd_delta(const T* o, const T* g, float* delta, int64_t o_sb,
                    int64_t o_sh, int64_t o_st, int64_t g_sb, int64_t g_sh,
                    int64_t g_st, int H, int Tq, int64_t rows) {
  constexpr int kLanes = D / 4;  // 8, 16 or 32: never across a warp
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kDeltaThreads +
                    threadIdx.x;
  const int64_t i = t / kLanes;  // the row, b*H*Tq + h*Tq + q
  const int col = static_cast<int>(t % kLanes) * 4;
  float acc = 0.f;
  if (i < rows) {
    const int q = static_cast<int>(i % Tq);
    const int64_t bh = i / Tq;
    const int64_t b = bh / H, h = bh % H;
    float a[4], bv[4];
    load4(o + b * o_sb + h * o_sh + q * o_st + col, a);
    load4(g + b * g_sb + h * g_sh + q * g_st + col, bv);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc = fmaf(a[e], bv[e], acc);
  }
#pragma unroll
  for (int m = kLanes / 2; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (i < rows && col == 0) delta[i] = acc;
}

// ---------------------------------------------------------------------------
// host side

template <int D, bool kAccum>
int launch_bf16(Params& p, int B, cudaStream_t stream) {
  if (!make_map(&p.tq, p.q, B, p.H, p.Tq, D, p.s[0], p.s[1], p.s[2], 64) ||
      !make_map(&p.tk, p.k, B, p.H, p.Tk, D, p.s[3], p.s[4], p.s[5], 64) ||
      !make_map(&p.tv, p.v, B, p.H, p.Tk, D, p.s[6], p.s[7], p.s[8], 64) ||
      !make_map(&p.tg, p.g, B, p.H, p.Tq, D, p.s[9], p.s[10], p.s[11], 64))
    return -1;
  using C = BfCfg<D>;
  const int err = set_smem(flash_bwd_bf16<D, kAccum>, C::kSmem);
  if (err != 0) return err;
  const dim3 grid(B * p.H, (p.Tq + 63) / 64 + (p.Tk + 63) / 64);
  flash_bwd_bf16<D, kAccum><<<grid, C::kThreads, C::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kAccum>
int launch_f32(const Params& p, int B, cudaStream_t stream) {
  using C = F32Cfg<D>;
  int err = set_smem(flash_bwd_f32<D, kAccum>, C::kSmem);
  if (err == 0)
    err = static_cast<int>(cudaMemsetAsync(
        p.turns, 0,
        sizeof(int) * B * p.H * ((p.Tq + C::kStream - 1) / C::kStream),
        stream));
  if (err != 0) return err;
  const dim3 grid(B * p.H, (p.Tk + 63) / 64);
  flash_bwd_f32<D, kAccum><<<grid, C::kThreads, C::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kAccum>
int run(Params& p, int B, int D, int dtype, cudaStream_t stream) {
  if (dtype == 0 && p.turns == nullptr) return -1;
  if (dtype == 0) {
    switch (D) {
      case 32: return launch_f32<32, kAccum>(p, B, stream);
      case 64: return launch_f32<64, kAccum>(p, B, stream);
      case 128: return launch_f32<128, kAccum>(p, B, stream);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return launch_bf16<32, kAccum>(p, B, stream);
      case 64: return launch_bf16<64, kAccum>(p, B, stream);
      case 128: return launch_bf16<128, kAccum>(p, B, stream);
    }
  }
  return -1;
}

template <typename T, int D>
int launch_delta(const void* o, const void* g, float* delta,
                 const long long* s, int B, int H, int Tq,
                 cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(B) * H * Tq;
  const int64_t threads = rows * (D / 4);
  const unsigned blocks =
      static_cast<unsigned>((threads + kDeltaThreads - 1) / kDeltaThreads);
  flash_bwd_delta<T, D><<<blocks, kDeltaThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(g), delta, s[0], s[1],
      s[2], s[3], s[4], s[5], H, Tq, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_delta(const void* o, const void* g, float* delta, const long long* s,
              int B, int H, int Tq, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_delta<T, 32>(o, g, delta, s, B, H, Tq, stream);
    case 64: return launch_delta<T, 64>(o, g, delta, s, B, H, Tq, stream);
    case 128: return launch_delta<T, 128>(o, g, delta, s, B, H, Tq, stream);
  }
  return -1;
}

// the fields both entry points fill alike
void fill(Params& p, const void* q, const void* k, const void* v,
          const void* g, const float* lse, const float* delta, void* dq,
          void* dk, void* dv, int H, int Tq, int Tk, float scale,
          int causal) {
  p.q = q; p.k = k; p.v = v; p.g = g;
  p.lse = lse; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.H = H; p.Tq = Tq; p.Tk = Tk;
  p.scale = scale;
  p.scale2 = scale * kLog2e;
  p.causal = causal;
}

}  // namespace

// Returns 0 on clean launches, the cudaError_t of a refused launch, or -1
// for a head dim / dtype / shape this kernel has no instance for (or views
// TMA cannot describe).  dtype: 0 = f32, 1 = bf16.  strides: (batch,
// head, seq) for q, k, v, o, g, dq, dk, dv in that order.  lse: the
// forward's contiguous (B, H, Tq) f32 row log-sum-exp (zoo_flash_fwd
// writes it); delta: (B*H*Tq) f32 scratch the pre-pass fills; turns:
// (B*H*Tq) int32 scratch of the f32 ordered dq; seed: the forward's
// dropout seed, one int32 in device memory (null when thresh is 0);
// bh_offset: the forward's (zoo_flash_fwd).  The kernels go on `stream`;
// nothing synchronises.
extern "C" int zoo_flash_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, const void* mask, void* dq, void* dk, void* dv,
    const float* lse, float* delta, int* turns, const long long* strides,
    int B, int H,
    int Tq, int Tk, int D, int dtype, float scale, int causal,
    unsigned int thresh, float keep_scale, const int* seed,
    unsigned int bh_offset, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || lse == nullptr) return -1;
  if (thresh != 0u && seed == nullptr) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long og[6] = {strides[9],  strides[10], strides[11],
                           strides[12], strides[13], strides[14]};
  const int err =
      dtype == 0 ? run_delta<float>(o, g, delta, og, B, H, Tq, D, st)
      : dtype == 1
          ? run_delta<__nv_bfloat16>(o, g, delta, og, B, H, Tq, D, st)
          : -1;
  if (err != 0) return err;
  Params p;
  fill(p, q, k, v, g, lse, delta, dq, dk, dv, H, Tq, Tk, scale, causal);
  p.mask = static_cast<const int32_t*>(mask);
  p.turns = turns;
  // q, k, v, g, dq, dk, dv from the (q, k, v, o, g, dq, dk, dv) strides
  const int from[7] = {0, 3, 6, 12, 15, 18, 21};
  for (int t = 0; t < 7; ++t)
    for (int i = 0; i < 3; ++i) p.s[3 * t + i] = strides[from[t] + i];
  p.lse_sb = static_cast<int64_t>(H) * Tq;
  p.lse_sh = Tq;
  p.dl_sb = p.lse_sb;
  p.dl_sh = p.lse_sh;
  p.thresh = thresh;
  p.keep_scale = keep_scale;
  p.seed = static_cast<const int32_t*>(seed);
  p.bh_offset = bh_offset;
  return run<false>(p, B, D, dtype, st);
}

// One block of ring attention: no mask, no dropout; lse and delta are the
// ring's global f32 statistics of these query rows; dq (B, H, Tq, D), dk
// and dv (B, H, Tk, D) are f32 accumulators the gradients are added into.
// strides: (batch, head, seq) of q, k, v, g, dq, dk, dv, then (batch,
// head) of lse and of delta (rows of unit stride); turns as zoo_flash_bwd.
// Same return codes and dtypes as zoo_flash_bwd; one kernel on `stream`.
extern "C" int zoo_flash_bwd_lse(
    const void* q, const void* k, const void* v, const void* g,
    const float* lse, const float* delta, float* dq, float* dk, float* dv,
    int* turns, const long long* strides, int B, int H, int Tq, int Tk,
    int D, int dtype, float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || lse == nullptr ||
      delta == nullptr)
    return -1;
  Params p;
  fill(p, q, k, v, g, lse, delta, dq, dk, dv, H, Tq, Tk, scale, causal);
  p.mask = nullptr;
  p.turns = turns;
  for (int i = 0; i < 21; ++i) p.s[i] = strides[i];
  p.lse_sb = strides[21];
  p.lse_sh = strides[22];
  p.dl_sb = strides[23];
  p.dl_sh = strides[24];
  p.thresh = 0u;
  p.keep_scale = 1.f;
  p.seed = nullptr;
  p.bh_offset = 0u;
  return run<true>(p, B, D, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" const char* zoo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
