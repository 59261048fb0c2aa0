// Flash-attention forward for Hopper (sm_90a), behind a plain C interface
// that analytics_zoo_tpu_torch/ops/_kernels.py loads with ctypes.
//
// Replaces two Pallas TPU kernels of analytics_zoo_tpu/ops/attention.py:
// - _flash_kernel, launched by _flash_forward: entry point zoo_flash_fwd,
//   which also writes each row's log-sum-exp when the caller will run the
//   backward (flash_bwd.cu takes it instead of recomputing it);
// - _flash_kernel_lse, launched by flash_forward_with_lse (the block that
//   ring attention merges shards with): entry point zoo_flash_fwd_lse, the
//   same kernels with no mask and no dropout that also write each row's
//   log-sum-exp m + log(l), or -1e30 for a row that sees no key (so the
//   ring's exp(lse_acc - lse_new) never meets -inf - -inf).
// Same function: online softmax with f32 running max / sum / accumulator
// over K tiles, an optional (B, Tk) padding mask, the end-aligned causal
// mask (row i sees key j iff j <= i + Tk - Tq, tiles wholly above the
// diagonal skipped), in-kernel dropout of the probabilities from the
// counter hash over (seed, b*H+h, q_pos, k_pos) with the normaliser summing
// the weights BEFORE dropout, and zeros for rows that see no key.  P is
// rounded to the input dtype before P.V, with f32 accumulation.
//
// What bounds it on an H100: 4*Tq*Tk*D flops against 4*T*D elements moved
// per head, about 64 flops per byte in bf16 at BERT's T = 128 and about
// 2000 at the ring's 4096-row blocks, so the products bound it: bf16 at
// the tensor cores' 989 TFLOP/s, f32 at the 3xTF32 rate (495 / 3 = 165
// TFLOP/s), the least time for products accurate to f32.  At D = 64 the
// exponentials come close behind: one exp2 per 4*D = 256 flops, and the
// SM's 16 exp2 a cycle match its 4096 bf16 flops a cycle.
//
// What the design does about it: two instances behind the same entry
// points, dispatched on the dtype, sharing the masks, the dropout hash, the
// online softmax and the epilogue (both products leave each thread the same
// accumulator fragment: rows g and g + 8 of a 16-row slice, columns
// 8j + 2c and 8j + 2c + 1, g = lane / 4, c = lane % 4).  Those, the tile
// layouts and both instances' products live in flash_tile.cuh, which
// paged_chunk.cu builds on too.
// - bf16: a block owns 128 query rows of one (batch, head) as two consumer
//   warpgroups of 64 rows (64 rows and one warpgroup where Tk <= 128, so
//   two blocks fit an SM) and one producer warp.  The producer loads Q
//   once and streams K and V tiles (64 keys where Tk <= 128, else 128)
//   through a two-stage ring in shared memory with TMA (4-D tensor maps
//   over the views' own strides, 128-byte swizzle for D 64 / 128, 64-byte
//   for D 32), completion on mbarriers, so the next tile's copy overlaps
//   this tile's products.  S = Q.K^T is wgmma m64nNk16 from shared memory
//   (both operands K-major); the softmax runs on the accumulator registers
//   (quad shuffles, one FFMA and one exp2 a score with log2(e) folded into
//   the scale; per-score masks and dropout compiled in only for the tiles
//   and calls that need them); P is repacked in registers as bf16 A
//   fragments and O += P.V is wgmma with V an MN-major B operand (the
//   descriptor's transpose bit), so P never touches shared memory.  The
//   two warpgroups take turns on Q.K^T (ping-pong on named barriers), so
//   one's softmax runs under the other's products.  Later work: FA3's
//   overlap of a warpgroup's softmax with its own next Q.K^T (tried
//   once: with a second score tile in flight it spilled and ran slower),
//   and three consumer warpgroups at D 64.
// - f32: 3xTF32 on mma.sync m16n8k8: each operand is split in registers
//   into hi = x with its low 13 mantissa bits cleared and lo = x - hi, and
//   each product is taken as lo.hi + hi.lo + hi.hi, accumulated in f32
//   (plain TF32 keeps 10 mantissa bits and misses the 2e-5 tolerance).
//   Four warps of 16 query rows a block; K and V tiles of 64 keys staged
//   by 16-byte cp.async into two stages, rows padded by 4 floats so every
//   fragment load is free of bank conflicts; the P.V product reads its
//   keys in the order S's accumulator holds them (k index c <-> key 2c,
//   c + 4 <-> 2c + 1), so P needs no shuffle.  Not wgmma: its tf32 form
//   takes only K-major operands, so V would need a transpose in shared
//   memory.
//
// Inputs q, k, v are f32 or bf16 with unit stride in the last dimension and
// (batch, head, seq) strides that are multiples of 16 bytes on a 16-byte
// aligned base (what TMA and cp.async need; the wrapper copies a view that
// is not), so the caller can pass head views of a fused QKV projection
// without copies; the output is written through its own strides.

#include <cuda.h>  // CUtensorMap; the encoder is fetched from the driver
#include <math.h>

#include "flash_common.cuh"
#include "flash_tile.cuh"
#include "hopper.cuh"

namespace {

using namespace zoo_flash;
using namespace zoo_hopper;

__device__ __forceinline__ TileCtx make_ctx(const int32_t* mask, int b,
                                            int bh, int Tq, int Tk,
                                            int causal, float scale2,
                                            uint32_t thresh, float keep_scale,
                                            const int32_t* seed) {
  TileCtx x;
  x.mrow = mask ? mask + static_cast<int64_t>(b) * Tk : nullptr;
  x.Tk = Tk;
  x.causal_offset = Tk - Tq;
  x.causal = causal;
  x.scale2 = scale2;
  // the seed lives in device memory, so a replayed CUDA graph reads the
  // value of each replay; it is read only when there is dropout
  x.head =
      thresh ? head_hash(static_cast<uint32_t>(__ldg(seed)), bh) : 0u;
  x.thresh = thresh;
  x.keep_scale = keep_scale;
  return x;
}

// ---------------------------------------------------------------------------
// bf16: wgmma with TMA-fed K/V

template <int D, int BN, int NWG>
struct BfCfg : BfTile<D, BN> {
  static constexpr int kConsumers = 128 * NWG;  // NWG warpgroups of 64 rows
  static constexpr int kThreads = kConsumers + 32;  // + a producer warp
  static constexpr int kBlockM = 64 * NWG;
  static constexpr int kStages = 2;  // K/V tiles in flight
  static constexpr int kBarOffset =
      NWG * BfTile<D, BN>::kQTile + 2 * kStages * BfTile<D, BN>::kKVTile;
  // + slack to align the base to 1024 bytes, + the mbarriers
  static constexpr size_t kSmem = 1024 + kBarOffset + 16 * kStages + 8;
};

struct BfParams {
  CUtensorMap tq, tk, tv;  // (D, T, H, B) maps; boxes of 64 / BN rows
  const int32_t* mask;
  __nv_bfloat16* o;
  float* lse;
  int64_t o_sb, o_sh, o_st;
  int H, Tq, Tk;
  float scale2;
  int causal;
  uint32_t thresh;
  float keep_scale;
  const int32_t* seed;  // one int32 in device memory; read iff thresh
};

template <int D, int BN, int NWG>
__global__ void __launch_bounds__(BfCfg<D, BN, NWG>::kThreads,
                                  NWG == 1 ? 2 : 1)
    flash_fwd_bf16(__grid_constant__ const BfParams p) {
  using C = BfCfg<D, BN, NWG>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;  // [warpgroup][atom] 64-row boxes of Q
  const uint32_t sk = sq + NWG * C::kQTile;           // [stage][atom]
  const uint32_t sv = sk + C::kStages * C::kKVTile;    // [stage][atom]
  const uint32_t full = base + C::kBarOffset;         // [stage]
  const uint32_t empty = full + 8 * C::kStages;        // [stage]
  const uint32_t bar_q = empty + 8 * C::kStages;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * C::kBlockM;
  const int n_wg = NWG == 2 && q0 + 64 < p.Tq ? 2 : 1;  // with rows
  const int k_end = key_end(q0, q0 + C::kBlockM, p.Tq, p.Tk, p.causal);
  const int n_tiles = (k_end + BN - 1) / BN;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + 8 * s, 1);          // the producer's arrival
      mbar_init(empty + 8 * s, 4 * n_wg);  // each consumer warp
    }
    mbar_init(bar_q, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= C::kConsumers) {  // producer warp: one lane issues every copy
    if (tid == C::kConsumers) {
      mbar_expect_tx(bar_q, n_wg * C::kQTile);
      for (int w = 0; w < n_wg; ++w)
        for (int a = 0; a < C::kAtoms; ++a)
          tma_load_4d(sq + (w * C::kAtoms + a) * C::kQAtomBytes, &p.tq,
                      bar_q, a * C::kAtomCols, q0 + 64 * w, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % C::kStages;
        if (it >= C::kStages)  // wait until every warp released the stage
          mbar_wait(empty + 8 * s, (it / C::kStages - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * C::kKVTile);
        for (int a = 0; a < C::kAtoms; ++a) {
          const uint32_t off = s * C::kKVTile + a * C::kKVAtomBytes;
          tma_load_4d(sk + off, &p.tk, full + 8 * s, a * C::kAtomCols,
                      it * BN, h, b);
          tma_load_4d(sv + off, &p.tv, full + 8 * s, a * C::kAtomCols,
                      it * BN, h, b);
        }
      }
    }
    return;
  }

  const int wg = tid >> 7;
  if (wg >= n_wg) return;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int c = lane & 3;
  const int row_lo = q0 + 64 * wg;
  const int r0 = row_lo + 16 * warp + (lane >> 2);
  const int wg_end = key_end(row_lo, row_lo + 64, p.Tq, p.Tk, p.causal);
  const TileCtx x = make_ctx(p.mask, b, bh, p.Tq, p.Tk, p.causal, p.scale2,
                             p.thresh, p.keep_scale, p.seed);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-kInf, -kInf}, l[2] = {0.f, 0.f};
  const uint32_t q_base = sq + wg * C::kQTile;
  // Ping-pong: with two warpgroups, their Q.K^T issues alternate (named
  // barriers 1 and 2), so one warpgroup's softmax runs under the other's
  // products instead of both waiting on the tensor cores, then both on
  // the exp2 units.  Both warpgroups take a turn on every tile of the
  // block, also on a tile one of them skips (the causal diagonal ends
  // warpgroup 0 first), so the turns alternate strictly: an arrive on a
  // barrier comes only after the other warpgroup's sync on its previous
  // generation, and no barrier completes on one warpgroup's arrivals.
  const bool pingpong = n_wg == 2;
  if (pingpong && wg == 1 && n_tiles > 0) named_arrive(1, 256);
  mbar_wait(bar_q, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % C::kStages;
    mbar_wait(full + 8 * s, (it / C::kStages) & 1);
    const int k0 = it * BN;
    // the other warpgroup's next turn: it has one on every tile, but
    // warpgroup 0 gives the turn after the block's last tile to no one
    const bool hand_on = pingpong && (wg == 0 || it + 1 < n_tiles);
    if (pingpong) named_sync(1 + wg, 256);  // my turn on the products
    if (k0 >= wg_end) {  // a tile this warpgroup skips: pass the turn on
      if (hand_on) named_arrive(2 - wg, 256);
    } else {  // warpgroup-uniform
      float sc[BN / 2];
      bf16_qk<D, BN>(sc, q_base, sk + s * C::kKVTile);
      if (hand_on) named_arrive(2 - wg, 256);
      wgmma_wait_all();

      float alpha[2];
      softmax_tile<BN / 8>(sc, m, l, alpha, x, r0, k0, c,
                           tile_masked(x, k0, BN, row_lo));
      rescale(o, alpha);
      bf16_pv<D, BN>(o, sc, sv + s * C::kKVTile);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // stage s is free
  }

  store_rows<__nv_bfloat16, D>(
      o, l, m, p.scale2, p.o + b * p.o_sb + h * p.o_sh, p.o_st,
      p.lse ? p.lse + static_cast<int64_t>(bh) * p.Tq : nullptr, r0, p.Tq,
      c);
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 on mma.sync with cp.async-fed K/V

constexpr int kF32Threads = 128;  // four warps of 16 query rows
constexpr int kF32BlockM = 64;
constexpr int kF32Stages = 2;

template <int D>
struct F32Cfg : F32Tile<D> {
  static constexpr size_t kSmem =
      sizeof(float) * 2 * kF32Stages * F32Tile<D>::kTile;
};

struct F32Params {
  const float* q;
  const float* k;
  const float* v;
  const int32_t* mask;
  float* o;
  float* lse;
  int64_t q_sb, q_sh, q_st;
  int64_t k_sb, k_sh, k_st;
  int64_t v_sb, v_sh, v_st;
  int64_t o_sb, o_sh, o_st;
  int H, Tq, Tk;
  float scale2;
  int causal;
  uint32_t thresh;
  float keep_scale;
  const int32_t* seed;  // one int32 in device memory; read iff thresh
};

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32(const F32Params p) {
  using C = F32Cfg<D>;
  extern __shared__ float4 smem_f4[];
  float* const smem = reinterpret_cast<float*>(smem_f4);  // [stage][K|V]

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * kF32BlockM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int row_lo = q0 + 16 * warp;
  const int r0 = row_lo + g;

  const float* qg = p.q + b * p.q_sb + h * p.q_sh;
  const float* kg = p.k + b * p.k_sb + h * p.k_sh;
  const float* vg = p.v + b * p.v_sb + h * p.v_sh;
  const int k_end = key_end(q0, q0 + kF32BlockM, p.Tq, p.Tk, p.causal);
  const int n_tiles = (k_end + kF32BlockN - 1) / kF32BlockN;
  const int warp_end = key_end(row_lo, row_lo + 16, p.Tq, p.Tk, p.causal);

  // 16-byte copies of one K and one V tile into stage s; keys past Tk are
  // zero-filled (0 . V stays 0, and their scores are masked)
  auto load_tile = [&](int it, int s) {
    float* ks = smem + s * 2 * C::kTile;
    float* vs = ks + C::kTile;
    constexpr int kChunksPerRow = D / 4;
    for (int i = tid; i < kF32BlockN * kChunksPerRow; i += kF32Threads) {
      const int r = i / kChunksPerRow;
      const int col = (i - r * kChunksPerRow) * 4;
      const int key = it * kF32BlockN + r;
      const bool ok = key < p.Tk;
      const int64_t kr = ok ? key : 0;
      cp_async_16(smem_u32(ks + r * C::kPitch + col), kg + kr * p.k_st + col,
                  ok);
      cp_async_16(smem_u32(vs + r * C::kPitch + col), vg + kr * p.v_st + col,
                  ok);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) load_tile(0, 0);

  // Q's A fragments for the whole head dim, f32: rows r0 / r0 + 8, columns
  // 8kd + c / + 4
  float qf[D / 8][4];
#pragma unroll
  for (int kd = 0; kd < D / 8; ++kd) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 8 * (i & 1);
      qf[kd][i] = row < p.Tq ? qg[row * p.q_st + 8 * kd + c + 4 * (i >> 1)]
                             : 0.f;
    }
  }
  const TileCtx x = make_ctx(p.mask, b, bh, p.Tq, p.Tk, p.causal, p.scale2,
                             p.thresh, p.keep_scale, p.seed);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-kInf, -kInf}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kF32Stages;
    if (it + 1 < n_tiles) {
      load_tile(it + 1, (it + 1) % kF32Stages);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it has landed for every thread
    const int k0 = it * kF32BlockN;
    if (k0 < warp_end) {  // warp-uniform
      const float* ks = smem + s * 2 * C::kTile;
      const float* vs = ks + C::kTile;
      float sc[32];
      f32_qk<D>(sc, qf, ks, g, c);

      float alpha[2];
      softmax_tile<8>(sc, m, l, alpha, x, r0, k0, c,
                      tile_masked(x, k0, kF32BlockN, row_lo));
      rescale(o, alpha);
      f32_pv<D>(o, sc, vs, g, c);
    }
    __syncthreads();  // stage s may be refilled
  }

  store_rows<float, D>(
      o, l, m, p.scale2, p.o + b * p.o_sb + h * p.o_sh, p.o_st,
      p.lse ? p.lse + static_cast<int64_t>(bh) * p.Tq : nullptr, r0, p.Tq,
      c);
}

// ---------------------------------------------------------------------------
// host side

// everything an entry point passes in
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* mask;
  void* o;
  float* lse;
  int64_t s[12];  // q, k, v, o: (batch, head, seq) strides in elements
  int B, H, Tq, Tk, D;
  float scale;
  int causal;
  uint32_t thresh;
  float keep_scale;
  const int32_t* seed;  // one int32 in device memory; read iff thresh
};

template <int D, int BN, int NWG>
int launch_bf16(const Args& a, cudaStream_t stream) {
  BfParams p;
  if (!make_map(&p.tq, a.q, a.B, a.H, a.Tq, D, a.s[0], a.s[1], a.s[2], 64) ||
      !make_map(&p.tk, a.k, a.B, a.H, a.Tk, D, a.s[3], a.s[4], a.s[5], BN) ||
      !make_map(&p.tv, a.v, a.B, a.H, a.Tk, D, a.s[6], a.s[7], a.s[8], BN))
    return -1;
  p.mask = a.mask;
  p.o = static_cast<__nv_bfloat16*>(a.o);
  p.lse = a.lse;
  p.o_sb = a.s[9]; p.o_sh = a.s[10]; p.o_st = a.s[11];
  p.H = a.H; p.Tq = a.Tq; p.Tk = a.Tk;
  p.scale2 = a.scale * kLog2e;
  p.causal = a.causal;
  p.thresh = a.thresh;
  p.keep_scale = a.keep_scale;
  p.seed = a.seed;
  using C = BfCfg<D, BN, NWG>;
  const int err = set_smem(flash_fwd_bf16<D, BN, NWG>, C::kSmem);
  if (err != 0) return err;
  const dim3 grid(a.B * a.H, (a.Tq + C::kBlockM - 1) / C::kBlockM);
  flash_fwd_bf16<D, BN, NWG><<<grid, C::kThreads, C::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// key ranges up to BERT's 128 take 64-row blocks with 64-key tiles (two
// blocks resident an SM and twice the blocks: short tiles are latency
// bound), longer ones 128-row blocks with 128-key tiles (half the waits
// and softmax steps per key, K/V read once per 128 rows)
template <int D>
int launch_bf16(const Args& a, cudaStream_t stream) {
  return a.Tk <= 128 ? launch_bf16<D, 64, 1>(a, stream)
                     : launch_bf16<D, 128, 2>(a, stream);
}

template <int D>
int launch_f32(const Args& a, cudaStream_t stream) {
  F32Params p;
  p.q = static_cast<const float*>(a.q);
  p.k = static_cast<const float*>(a.k);
  p.v = static_cast<const float*>(a.v);
  p.mask = a.mask;
  p.o = static_cast<float*>(a.o);
  p.lse = a.lse;
  p.q_sb = a.s[0]; p.q_sh = a.s[1]; p.q_st = a.s[2];
  p.k_sb = a.s[3]; p.k_sh = a.s[4]; p.k_st = a.s[5];
  p.v_sb = a.s[6]; p.v_sh = a.s[7]; p.v_st = a.s[8];
  p.o_sb = a.s[9]; p.o_sh = a.s[10]; p.o_st = a.s[11];
  p.H = a.H; p.Tq = a.Tq; p.Tk = a.Tk;
  p.scale2 = a.scale * kLog2e;
  p.causal = a.causal;
  p.thresh = a.thresh;
  p.keep_scale = a.keep_scale;
  p.seed = a.seed;
  constexpr size_t smem = F32Cfg<D>::kSmem;
  const int err = set_smem(flash_fwd_f32<D>, smem);
  if (err != 0) return err;
  const dim3 grid(a.B * a.H, (a.Tq + kF32BlockM - 1) / kF32BlockM);
  flash_fwd_f32<D><<<grid, kF32Threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int run(const Args& a, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    switch (a.D) {
      case 32: return launch_f32<32>(a, stream);
      case 64: return launch_f32<64>(a, stream);
      case 128: return launch_f32<128>(a, stream);
    }
  } else if (dtype == 1) {
    switch (a.D) {
      case 32: return launch_bf16<32>(a, stream);
      case 64: return launch_bf16<64>(a, stream);
      case 128: return launch_bf16<128>(a, stream);
    }
  }
  return -1;
}

}  // namespace

// Returns 0 on a clean launch, the cudaError_t of a refused launch, or -1
// for a head dim / dtype this kernel has no instance for (or views TMA
// cannot describe).  dtype: 0 = f32, 1 = bf16.  `lse`, when not null, is a
// contiguous (B, H, Tq) f32 buffer that receives each row's log-sum-exp of
// the scaled scores over the keys it sees, before dropout (what
// flash_bwd.cu rebuilds P from; -1e30 for a row that sees no key).
// `seed` points to the dropout seed, one int32 in device memory, read by
// the kernel (so a captured CUDA graph reads each replay's value); it may
// be null when thresh is 0.  Launches on `stream` and does not synchronise.
extern "C" int zoo_flash_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    float* lse, long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_st,
    int B, int H, int Tq, int Tk, int D, int dtype, float scale, int causal,
    unsigned int thresh, float keep_scale, const int* seed, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk < 0) return -1;
  if (thresh != 0u && seed == nullptr) return -1;
  const Args a = {q, k, v, static_cast<const int32_t*>(mask), o, lse,
                  {q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
                   o_sb, o_sh, o_st},
                  B, H, Tq, Tk, D, scale, causal, thresh, keep_scale,
                  static_cast<const int32_t*>(seed)};
  return run(a, dtype, static_cast<cudaStream_t>(stream));
}

// The forward of flash_forward_with_lse: no mask, no dropout, and each row's
// log-sum-exp written to `lse`, a contiguous (B, H, Tq) f32 buffer.  Same
// return codes, dtypes and strides as zoo_flash_fwd.
extern "C" int zoo_flash_fwd_lse(
    const void* q, const void* k, const void* v, void* o, float* lse,
    long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_st,
    int B, int H, int Tq, int Tk, int D, int dtype, float scale, int causal,
    void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk < 0 || lse == nullptr) return -1;
  const Args a = {q, k, v, nullptr, o, lse,
                  {q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
                   o_sb, o_sh, o_st},
                  B, H, Tq, Tk, D, scale, causal, 0u, 1.f, nullptr};
  return run(a, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" const char* zoo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
