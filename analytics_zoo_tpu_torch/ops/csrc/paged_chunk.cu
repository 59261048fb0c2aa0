// Paged chunked-prefill attention for Hopper (sm_90a), behind a plain C
// interface that analytics_zoo_tpu_torch/ops/_kernels.py loads with ctypes.
//
// Replaces: analytics_zoo_tpu/ops/paged_attention.py::paged_chunk_attention,
// which the JAX package computes with jnp (a gather of the whole page table,
// then dense masked softmax): the attention of one chunk of a prompt,
// queries at positions start .. start + Tc - 1, over every cached token of
// the sequence read through its page table, causal (query i sees key
// positions 0 .. start + i, and none at or past nb * bs), softmax(q.k *
// scale).v with f32 scores and accumulation, GQA query head h reading KV
// head h / (H / Hkv).  Padded tail rows of the chunk are computed like the
// others and discarded by the caller.  bf16 rounds P to bf16 before P.V, as
// flash_fwd.cu does (the plain version keeps P in f32; the bf16 tolerance
// covers it); f32 keeps it f32.
//
// What bounds it on an H100: at a 256-token chunk after 512 cached tokens
// (GPT-2 small: 12 heads, D 64) the work is 4 H D (Tc start + Tc (Tc + 1) /
// 2) flops, 0.50 GFLOP, over 4.7 MB of q, K, V and output in f32: about
// 100 flops per byte, so the products bound it (3.1 us at the 3xTF32 rate
// in f32; in bf16 the 2.4 MB moved, 0.7 us, come first).
//
// What the design does about it: flash_fwd.cu's tiles (flash_tile.cuh: the
// same products, fragment layout, online softmax and epilogue), with the
// K/V loader gathering rows through the page table instead of TMA's boxes.
// - bf16 on wgmma: one warpgroup owns 64 query rows of one head; S = Q.K^T
//   is wgmma m64n64k16 from shared memory, P is repacked in registers as
//   bf16 A fragments for O += P.V with V an MN-major B operand.  Q and the
//   64-key K / V tiles are copied with 16-byte cp.async straight into the
//   128- / 64-byte swizzled layout the wgmma descriptors read (each row
//   from page table[key / bs], slot key % bs: any bs), two stages deep, and
//   fenced into the async proxy before the products read them.
// - f32 on 3xTF32 mma.sync: four warps of 16 query rows, the same gathered
//   64-key tiles as padded f32 rows, two stages of cp.async.
// - The mask: key <= start + row with the diagonal at the host's `start`
//   (not an end-aligned Tk - Tq: a padded tail may run past nb * bs), keys
//   capped at nb * bs; tiles wholly above a block's (f32: a warp's) last
//   row's diagonal are skipped, and only tiles that cross it are masked per
//   score.
// - Filling the SMs: at Tc 256 and 12 heads the 64-row tiles make 48
//   blocks on 132 SMs, so the host splits each block's key tiles over
//   `splits` blocks (ops/_kernels.chunk_splits; on an H100 this beat 32-
//   and 16-row f32 blocks without a split about fourfold, PERF.md).  Each
//   writes its rows' output normalised by its own sum, with their
//   log-sum-exp, into f32 scratch from the wrapper, and a second small
//   kernel of the same call merges the splits that hold keys in split
//   order: no float atomics, so repeats are bit-identical.  With one split
//   the block writes the output.
//
// q is (Tc, H, D), the pages (P, bs, Hkv, D), with unit stride in the last
// dimension; the pages' (and in bf16 q's) other strides multiples of 16
// bytes on a 16-byte aligned base, which the 16-byte copies need (the
// wrapper copies a tensor that is not).  The page table (nb,) is int32, and
// start is an int the host knows, so the kernel reads no scalar from the
// device.  Out-of-range page ids are clamped into [0, P), as JAX's gather
// clamps them.  Output (Tc, H, D) in q's dtype.

#include <math.h>

#include "flash_common.cuh"
#include "flash_tile.cuh"
#include "hopper.cuh"

namespace {

using namespace zoo_flash;
using namespace zoo_hopper;

constexpr int kThreads = 128;  // bf16: one warpgroup; f32: four warps
constexpr int kBlockM = 64;    // query rows a block
constexpr int kBlockN = kF32BlockN;  // keys a staged tile (64)
constexpr int kStages = 2;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* table;
  void* o;
  float* part_o;    // (splits, H, Tc, D): each split's rows over its keys
  float* part_lse;  // (splits, H, Tc): their log-sum-exp
  int64_t q_st, q_sh;
  int64_t k_sp, k_ss, k_sh;
  int64_t v_sp, v_ss, v_sh;
  int64_t o_st, o_sh;
  int Tc, H, Hkv, P, bs, nb, start, splits;
  float scale2;  // sm_scale * log2(e)
};

// last key (exclusive) that chunk rows [lo, hi) may see
__device__ __forceinline__ int chunk_key_end(int lo, int hi, const Params& p) {
  const int last_row = min(hi, p.Tc) - 1;
  return min(p.nb * p.bs, max(0, p.start + last_row + 1));
}

// key tiles per split of a row block whose keys end at k_end: the block's
// tiles cut into `splits` runs of ceil(tiles / splits), so the last splits
// may be empty
__device__ __forceinline__ int tiles_per_split(int k_end, int splits) {
  const int n = (k_end + kBlockN - 1) / kBlockN;
  return max(1, (n + splits - 1) / splits);
}

__device__ __forceinline__ TileCtx chunk_ctx(const Params& p) {
  TileCtx x;
  x.mrow = nullptr;
  x.Tk = p.nb * p.bs;
  x.causal_offset = p.start;
  x.causal = 1;
  x.scale2 = p.scale2;
  x.head = 0u;
  x.thresh = 0u;
  x.keep_scale = 1.f;
  return x;
}

// 16-byte cp.async copies of the K and V rows of keys k0 .. k0 + kBlockN
// into one stage: each row from page table[key / bs] (clamped into [0, P)),
// slot key % bs; keys at or past k_end are zero-filled (0 . V stays 0, and
// their scores are masked) and their table entries not read.  dst(r, c) is
// the byte offset of 16-byte chunk c of row r in the stage's K (or V) tile.
template <typename T, int D, int kThr, typename Dst>
__device__ __forceinline__ void gather_kv(const Params& p, const T* kg,
                                          const T* vg, uint32_t sk,
                                          uint32_t sv, int k0, int k_end,
                                          int tid, Dst dst) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;  // copies a row
#pragma unroll
  for (int it = 0; it < kBlockN * kChunks / kThr; ++it) {
    const int i = tid + it * kThr;
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const int key = k0 + r;
    const bool ok = key < k_end;
    int64_t ko = 0, vo = 0;
    if (ok) {
      const int blk = key / p.bs;
      const int page = min(max(p.table[blk], 0), p.P - 1);
      const int slot = key - blk * p.bs;
      ko = page * p.k_sp + slot * p.k_ss;
      vo = page * p.v_sp + slot * p.v_ss;
    }
    const uint32_t off = dst(r, c);
    cp_async_16(sk + off, kg + ko + c * kVec, ok);
    cp_async_16(sv + off, vg + vo + c * kVec, ok);
  }
}

// The block's rows, normalised: the output itself with one split, else
// the split's partial and its lse
template <typename T, int D>
__device__ __forceinline__ void store_block(const float (&o)[D / 2],
                                            float (&l)[2], const float (&m)[2],
                                            const Params& p, int h, int split,
                                            int r0, int c) {
  if (p.splits == 1) {
    store_rows<T, D>(o, l, m, p.scale2, static_cast<T*>(p.o) + h * p.o_sh,
                     p.o_st, nullptr, r0, p.Tc, c);
  } else {
    const int64_t rows = (static_cast<int64_t>(split) * p.H + h) * p.Tc;
    store_rows<float, D>(o, l, m, p.scale2, p.part_o + rows * D, D,
                         p.part_lse + rows, r0, p.Tc, c);
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma on cp.async-gathered swizzled tiles

template <int D>
struct BfChunk : BfTile<D, kBlockN> {
  // Q, then the stages' K tiles and V tiles; + slack to align the base to
  // 1024 bytes (the swizzle atoms)
  static constexpr size_t kSmem = 1024 + BfTile<D, kBlockN>::kQTile +
                                  2 * kStages * BfTile<D, kBlockN>::kKVTile;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    paged_chunk_bf16(const Params p) {
  using L = BfTile<D, kBlockN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;                      // [atom] 64-row boxes
  const uint32_t sk = sq + L::kQTile;            // [stage][atom]
  const uint32_t sv = sk + kStages * L::kKVTile;  // [stage][atom]

  const int h = blockIdx.x;
  const int q0 = blockIdx.y * kBlockM;
  const int split = blockIdx.z;
  const int k_end = chunk_key_end(q0, q0 + kBlockM, p);
  const int per = tiles_per_split(k_end, p.splits);
  const int n_tiles = (k_end + kBlockN - 1) / kBlockN;
  const int t_lo = min(n_tiles, split * per);
  const int t_hi = min(n_tiles, t_lo + per);
  if (p.splits > 1 && t_lo >= t_hi) return;  // the merge skips this split
  const int kvh = h / (p.H / p.Hkv);
  const int tid = threadIdx.x;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + kvh * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + kvh * p.v_sh;
  auto kv_dst = [](int r, int c) { return L::chunk_offset(r, c, kBlockN); };

  // Q's 64 rows (zero past Tc) and the first K / V tile: one group
  {
    const __nv_bfloat16* qg =
        static_cast<const __nv_bfloat16*>(p.q) + h * p.q_sh;
    constexpr int kChunks = D / 8;
#pragma unroll
    for (int it = 0; it < kBlockM * kChunks / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kChunks;
      const int c = i - r * kChunks;
      const bool ok = q0 + r < p.Tc;
      cp_async_16(sq + L::chunk_offset(r, c, kBlockM),
                  qg + (ok ? q0 + r : 0) * p.q_st + c * 8, ok);
    }
  }
  if (t_lo < t_hi)
    gather_kv<__nv_bfloat16, D, kThreads>(p, kg, vg, sk, sv,
                                          t_lo * kBlockN, k_end, tid,
                                          kv_dst);
  cp_async_commit();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c = lane & 3;
  const int r0 = q0 + 16 * warp + (lane >> 2);
  const TileCtx x = chunk_ctx(p);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-kInf, -kInf}, l[2] = {0.f, 0.f};

  for (int it = t_lo; it < t_hi; ++it) {
    const int s = (it - t_lo) % kStages;
    if (it + 1 < t_hi) {
      const int s1 = (it + 1 - t_lo) % kStages;
      gather_kv<__nv_bfloat16, D, kThreads>(
          p, kg, vg, sk + s1 * L::kKVTile, sv + s1 * L::kKVTile,
          (it + 1) * kBlockN, k_end, tid, kv_dst);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();  // tile it as the tensor cores read it
    __syncthreads();
    const int k0 = it * kBlockN;
    float sc[kBlockN / 2];
    bf16_qk<D, kBlockN>(sc, sq, sk + s * L::kKVTile);
    wgmma_wait_all();
    float alpha[2];
    softmax_tile<kBlockN / 8>(sc, m, l, alpha, x, r0, k0, c,
                              tile_masked(x, k0, kBlockN, q0));
    rescale(o, alpha);
    bf16_pv<D, kBlockN>(o, sc, sv + s * L::kKVTile);
    __syncthreads();  // stage s may be refilled
  }
  cp_async_wait<0>();  // Q's copies, where the block had no key tile

  store_block<__nv_bfloat16, D>(o, l, m, p, h, split, r0, c);
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 mma.sync on cp.async-gathered padded tiles

template <int D>
struct F32Chunk : F32Tile<D> {
  static constexpr size_t kSmem =
      sizeof(float) * 2 * kStages * F32Tile<D>::kTile;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    paged_chunk_f32(const Params p) {
  using L = F32Tile<D>;
  extern __shared__ float4 smem_f4[];
  float* const smem = reinterpret_cast<float*>(smem_f4);  // [stage][K|V]

  const int h = blockIdx.x;
  const int q0 = blockIdx.y * kBlockM;
  const int split = blockIdx.z;
  const int k_end = chunk_key_end(q0, q0 + kBlockM, p);
  const int per = tiles_per_split(k_end, p.splits);
  const int n_tiles = (k_end + kBlockN - 1) / kBlockN;
  const int t_lo = min(n_tiles, split * per);
  const int t_hi = min(n_tiles, t_lo + per);
  if (p.splits > 1 && t_lo >= t_hi) return;  // the merge skips this split
  const int kvh = h / (p.H / p.Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int row_lo = q0 + 16 * warp;
  const int r0 = row_lo + g;
  const int warp_end = chunk_key_end(row_lo, row_lo + 16, p);

  const float* qg = static_cast<const float*>(p.q) + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + kvh * p.v_sh;
  auto kv_dst = [](int r, int cc) {
    return static_cast<uint32_t>((r * L::kPitch + 4 * cc) * sizeof(float));
  };
  auto stage = [&](int s) { return smem_u32(smem + s * 2 * L::kTile); };
  if (t_lo < t_hi) {
    gather_kv<float, D, kThreads>(p, kg, vg, stage(0),
                                        stage(0) + L::kTile * 4,
                                        t_lo * kBlockN, k_end, tid, kv_dst);
    cp_async_commit();
  }

  // Q's A fragments for the whole head dim: rows r0 / r0 + 8, columns
  // 8kd + c / + 4
  float qf[D / 8][4];
#pragma unroll
  for (int kd = 0; kd < D / 8; ++kd) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 8 * (i & 1);
      qf[kd][i] = row < p.Tc ? qg[row * p.q_st + 8 * kd + c + 4 * (i >> 1)]
                             : 0.f;
    }
  }
  const TileCtx x = chunk_ctx(p);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-kInf, -kInf}, l[2] = {0.f, 0.f};

  for (int it = t_lo; it < t_hi; ++it) {
    const int s = (it - t_lo) % kStages;
    if (it + 1 < t_hi) {
      const int s1 = (it + 1 - t_lo) % kStages;
      gather_kv<float, D, kThreads>(p, kg, vg, stage(s1),
                                          stage(s1) + L::kTile * 4,
                                          (it + 1) * kBlockN, k_end, tid,
                                          kv_dst);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it has landed for every thread
    const int k0 = it * kBlockN;
    if (k0 < warp_end) {  // warp-uniform
      const float* ks = smem + s * 2 * L::kTile;
      const float* vs = ks + L::kTile;
      float sc[32];
      f32_qk<D>(sc, qf, ks, g, c);
      float alpha[2];
      softmax_tile<8>(sc, m, l, alpha, x, r0, k0, c,
                      tile_masked(x, k0, kBlockN, row_lo));
      rescale(o, alpha);
      f32_pv<D>(o, sc, vs, g, c);
    }
    __syncthreads();  // stage s may be refilled
  }

  store_block<float, D>(o, l, m, p, h, split, r0, c);
}

// ---------------------------------------------------------------------------
// the merge over splits, and the host side

// Row blockIdx.x of head blockIdx.y from the partials of the splits that
// hold keys of its row block, in split order.
template <typename T, int D>
__global__ void __launch_bounds__(D) paged_chunk_merge(const Params p) {
  const int row = blockIdx.x;
  const int h = blockIdx.y;
  const int q0 = row / kBlockM * kBlockM;
  const int k_end = chunk_key_end(q0, q0 + kBlockM, p);
  const int per = tiles_per_split(k_end, p.splits);
  const int n = ((k_end + kBlockN - 1) / kBlockN + per - 1) / per;
  const int64_t first = static_cast<int64_t>(h) * p.Tc + row;
  const int64_t step = static_cast<int64_t>(p.H) * p.Tc;
  T* og = static_cast<T*>(p.o) + row * p.o_st + h * p.o_sh;
  og[threadIdx.x] = from_f32<T>(merge_splits(
      p.part_o + first * D, step * D, p.part_lse + first, step, n,
      threadIdx.x));
}

template <typename T, int D, typename K>
int launch(K kernel, size_t smem, SmemOptIn& opt_in, const Params& p,
           cudaStream_t stream) {
  const int err = opt_in(kernel, smem);
  if (err != 0) return err;
  const dim3 grid(p.H, (p.Tc + kBlockM - 1) / kBlockM, p.splits);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  if (p.splits > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    paged_chunk_merge<T, D><<<dim3(p.Tc, p.H), D, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const Params& p, cudaStream_t stream) {
  static SmemOptIn opt_in;
  return launch<__nv_bfloat16, D>(paged_chunk_bf16<D>, BfChunk<D>::kSmem,
                                  opt_in, p, stream);
}

template <int D>
int launch_f32(const Params& p, cudaStream_t stream) {
  static SmemOptIn opt_in;
  return launch<float, D>(paged_chunk_f32<D>, F32Chunk<D>::kSmem, opt_in, p,
                          stream);
}

}  // namespace

// Returns 0 on a clean launch, the cudaError_t of a refused launch, or -1
// for arguments this kernel has no instance for.  dtype: 0 = f32, 1 = bf16.
// Each 64-row block's key tiles are cut into `splits` runs; with splits >
// 1, part_o (splits * H * Tc * D f32) and part_lse (splits * H * Tc f32)
// are the scratch the splits merge through, and the call runs a second,
// merging kernel.  Launches on `stream` and does not synchronise.
extern "C" int zoo_paged_chunk(
    const void* q, const void* k_pages, const void* v_pages,
    const int* page_table, void* out, float* part_o, float* part_lse,
    long long q_st, long long q_sh,
    long long k_sp, long long k_ss, long long k_sh,
    long long v_sp, long long v_ss, long long v_sh,
    long long o_st, long long o_sh,
    int Tc, int H, int Hkv, int D, int P, int bs, int nb, int start,
    int splits, int dtype, float sm_scale, void* stream) {
  if (Tc <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || P <= 0 || bs <= 0 ||
      nb < 0 || start < 0 || splits <= 0 ||
      (splits > 1 && (part_o == nullptr || part_lse == nullptr)))
    return -1;
  Params p;
  p.q = q; p.k = k_pages; p.v = v_pages;
  p.table = page_table; p.o = out;
  p.part_o = part_o; p.part_lse = part_lse;
  p.q_st = q_st; p.q_sh = q_sh;
  p.k_sp = k_sp; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sp = v_sp; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_st = o_st; p.o_sh = o_sh;
  p.Tc = Tc; p.H = H; p.Hkv = Hkv; p.P = P; p.bs = bs; p.nb = nb;
  p.start = start;
  p.splits = splits;
  p.scale2 = sm_scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (D) {
      case 32: return launch_f32<32>(p, s);
      case 64: return launch_f32<64>(p, s);
      case 128: return launch_f32<128>(p, s);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return launch_bf16<32>(p, s);
      case 64: return launch_bf16<64>(p, s);
      case 128: return launch_bf16<128>(p, s);
    }
  }
  return -1;
}

extern "C" const char* zoo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
