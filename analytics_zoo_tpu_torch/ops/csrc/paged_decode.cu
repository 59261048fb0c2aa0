// Paged decode attention for Hopper (sm_90a), behind a plain C interface
// that analytics_zoo_tpu_torch/ops/_kernels.py loads with ctypes.
//
// Replaces: analytics_zoo_tpu/ops/paged_attention.py::_pallas_paged (jax's
// library paged-attention TPU kernel) behind paged_decode_attention.  Same
// function as its gather reference _gather_reference: one new token per
// sequence attends over the first lengths[b] cached tokens, read through the
// sequence's block table, softmax(q.k * scale).v with f32 scores, weights
// and accumulation (P stays f32 in both dtypes); query head h reads KV head
// h / (H / Hkv) (GQA); a sequence with lengths[b] == 0 (a dead decode lane)
// gets zeros.
//
// What bounds it on an H100: every cached K and V element of the visible
// tokens is read once and feeds one multiply-add for the score and one for
// the output, half a flop per f32 byte (a quarter of the 3xTF32 ridge, far
// below every ridge), so the bound is bytes: at GPT-2 small serving (B 32,
// 12 heads, D 64, 1024 tokens) 201 MB in f32, 0.060 ms, and half in bf16.
// Reaching it takes about 2.3 MB of loads in flight on the card (3.35 TB/s
// times about 0.7 us of latency), some 18 KB an SM.
//
// What the design does about it (flash-decoding):
// - A split over keys.  The grid is (splits, Hkv x head groups, B): a block
//   owns one contiguous range of whole pages of one (sequence, KV head) and
//   serves up to GB of the group's G = H / Hkv query heads from one read of
//   its K/V.  The host picks the split from the table width nb * bs
//   (ops/_kernels.decode_splits), so it never reads the lengths; a block
//   whose range starts at or past lengths[b] exits at once, and table
//   entries past ceil(len / bs) are never read.  On an H100 the split is
//   what fills the card for few sequences (B 4 at 4,096 tokens: about 1.4x
//   in f32 and 2x in bf16 against one split); at 32 sequences the blocks
//   fill it already and the merge's cost about cancels the gain
//   (PERF.md; chip_smoke.py's paged phase times the rule against one
//   split).
// - 16-byte staged loads, many in flight.  Each of the block's 4 warps takes
//   every fourth 16-key chunk of the range and streams it through its own
//   two-stage ring in shared memory with 16-byte cp.async (lanes 0-15 look
//   up their key's page once; the copies read it by shuffle), so each warp
//   has its next chunk of K and V in flight while it computes on this one,
//   with no block-wide barrier; rows are padded by 16 bytes, which keeps
//   the reads below free of bank conflicts.  Small blocks (37 KB of shared
//   memory in bf16, 70 KB in f32 at D 64) let 6 / 3 of them share an SM:
//   deeper rings (4 stages) and 8-warp blocks measured slower.
// - Scores: lanes j and j + 16 take key j of the chunk, each half of its D
//   columns (16-byte shared loads, q broadcast from shared memory), joined
//   by one shuffle.  P.V: each lane owns D/32 adjacent output columns and
//   reads them from each staged V row, with P passed by shuffle.  An f32
//   online softmax per warp and head (exp2, the scale folded in), merged
//   over the four warps in warp order at the end.
// - The merge over splits.  With one split the block writes the output.
//   Otherwise each block writes its partial (the output normalised by its
//   own sum, and its log-sum-exp) into f32 scratch that the wrapper
//   allocates, and a second small kernel of the same call merges the splits
//   that saw keys in split order: no float atomics, so repeats are
//   bit-identical.
// - No tensor cores: on the MHA main path (G = 1) each K/V element meets
//   one query, so there is no product to batch.  A GQA variant that scores
//   the G heads of a group with mma is later work.
//
// q is (B, H, D), the pages (P, bs, Hkv, D), all with unit stride in the
// last dimension; the pages' other strides multiples of 16 bytes on a
// 16-byte aligned base (what cp.async needs; the wrapper copies a pool that
// is not); lengths (B,) and the block tables (B, nb) are int32.
// Out-of-range page ids are clamped into [0, P), as JAX's gather clamps
// them.  Output (B, H, D) in q's dtype.

#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace zoo_flash;
using namespace zoo_hopper;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 16;   // keys a warp stages and scores at a time
constexpr int kStages = 2;   // chunks a warp's ring holds
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kAll = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* lengths;
  const int32_t* tables;
  void* o;
  float* part_o;    // (B, H, splits, D): each split's output over its keys
  float* part_lse;  // (B, H, splits): each split's log-sum-exp
  int64_t q_sb, q_sh;
  int64_t k_sp, k_ss, k_sh;
  int64_t v_sp, v_ss, v_sh;
  int64_t o_sb, o_sh;
  int64_t t_sb;
  int B, H, Hkv, P, bs, nb;
  int splits, split_keys;  // blocks per (sequence, head group), keys each
  float scale2;            // sm_scale * log2(e)
};

// A warp's ring: stages of kChunk K rows then kChunk V rows, each row D
// elements and 16 bytes of padding (an odd number of 16-byte units, so the
// 16-byte reads of 8 consecutive rows hit 8 distinct bank groups)
template <typename T, int D>
struct Cfg {
  static constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte copy
  static constexpr int kPitch = D + kVec;      // elements a staged row
  static constexpr int kStageElems = 2 * kChunk * kPitch;
  static constexpr int kStageBytes = kStageElems * sizeof(T);
  static constexpr int kRowChunks = D * sizeof(T) / 16;  // copies a row
  static constexpr int kRowsPerPass = 32 / kRowChunks;    // rows a warp copy
  static constexpr size_t kRing =
      static_cast<size_t>(kWarps) * kStages * kStageBytes;
};

// block shared memory: q of the block's heads (f32), then the warps'
// rings, which the merge over warps reuses at the end
template <typename T, int D, int GB>
constexpr size_t smem_bytes() {
  constexpr size_t merge = sizeof(float) * kWarps * GB * (D + 2);
  return sizeof(float) * GB * D +
         (Cfg<T, D>::kRing > merge ? Cfg<T, D>::kRing : merge);
}

// score halves: s[g] += q[g][0 .. D/2) . k[0 .. D/2) for the lane's half
template <int D, int GB>
__device__ __forceinline__ void half_dots(float (&s)[GB], const float* kr,
                                          const float* q) {
#pragma unroll
  for (int t = 0; t < D / 2; t += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(kr + t);
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float4 qv = *reinterpret_cast<const float4*>(q + g * D + t);
      s[g] = fmaf(qv.x, kv.x, s[g]);
      s[g] = fmaf(qv.y, kv.y, s[g]);
      s[g] = fmaf(qv.z, kv.z, s[g]);
      s[g] = fmaf(qv.w, kv.w, s[g]);
    }
  }
}

template <int D, int GB>
__device__ __forceinline__ void half_dots(float (&s)[GB],
                                          const __nv_bfloat16* kr,
                                          const float* q) {
#pragma unroll
  for (int t = 0; t < D / 2; t += 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(kr + t);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    float kv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      kv[2 * i] = f.x;
      kv[2 * i + 1] = f.y;
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int i = 0; i < 8; i += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(q + g * D + t + i);
        s[g] = fmaf(qv.x, kv[i], s[g]);
        s[g] = fmaf(qv.y, kv[i + 1], s[g]);
        s[g] = fmaf(qv.z, kv[i + 2], s[g]);
        s[g] = fmaf(qv.w, kv[i + 3], s[g]);
      }
    }
  }
}

// N adjacent staged elements as f32
template <int N>
__device__ __forceinline__ void load_cols(float (&v)[N], const float* p) {
  if constexpr (N == 1) {
    v[0] = p[0];
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
}

template <int N>
__device__ __forceinline__ void load_cols(float (&v)[N],
                                          const __nv_bfloat16* p) {
  if constexpr (N == 1) {
    v[0] = __bfloat162float(p[0]);
  } else if constexpr (N == 2) {
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = x.x;
    v[1] = x.y;
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
}

// One block: split blockIdx.x of query heads g0 .. g0 + GB of KV head kvh of
// sequence blockIdx.z.
template <typename T, int D, int GB>
__global__ void __launch_bounds__(kThreads)
    paged_decode_split(const Params p) {
  using C = Cfg<T, D>;
  constexpr int kCols = D / 32;  // output columns a lane owns
  extern __shared__ float4 smem_f4[];
  float* const qs = reinterpret_cast<float*>(smem_f4);  // [GB][D]
  uint8_t* const ring = reinterpret_cast<uint8_t*>(qs + GB * D);

  const int split = blockIdx.x;
  const int G = p.H / p.Hkv;
  const int groups = (G + GB - 1) / GB;
  const int kvh = blockIdx.y / groups;
  const int g0 = (blockIdx.y - kvh * groups) * GB;
  const int gn = min(GB, G - g0);  // the block's query heads
  const int h0 = kvh * G + g0;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int len = min(max(p.lengths[b], 0), p.nb * p.bs);
  const int k_lo = split * p.split_keys;
  T* const og = static_cast<T*>(p.o) + b * p.o_sb + h0 * p.o_sh;
  if (k_lo >= len) {  // no key here; one split: the output is zeros
    if (p.splits == 1)
      for (int i = tid; i < gn * D; i += kThreads)
        og[(i / D) * p.o_sh + i % D] = from_f32<T>(0.f);
    return;
  }
  const int k_hi = min(len, k_lo + p.split_keys);

  // this warp's chunks: warp, warp + 4, ... of the block's range
  const int n_chunks = (k_hi - k_lo + kChunk - 1) / kChunk;
  const int n_mine =
      n_chunks > warp ? (n_chunks - warp + kWarps - 1) / kWarps : 0;
  const int32_t* table = p.tables + b * p.t_sb;
  const T* kbase = static_cast<const T*>(p.k) + kvh * p.k_sh;
  const T* vbase = static_cast<const T*>(p.v) + kvh * p.v_sh;
  T* const wring =
      reinterpret_cast<T*>(ring + warp * kStages * C::kStageBytes);

  // the warp's i-th chunk into stage i % kStages, as one commit group (an
  // empty one past the last chunk, so the waits below count uniformly);
  // keys at or past k_hi are zero-filled and their table entries not read
  auto load = [&](int i) {
    if (i < n_mine) {
      const int k0 = k_lo + (warp + i * kWarps) * kChunk;
      int page = 0, slot = 0;
      const int key = k0 + (lane & (kChunk - 1));
      if (lane < kChunk && key < k_hi) {
        const int blk = key / p.bs;
        page = min(max(table[blk], 0), p.P - 1);
        slot = key - blk * p.bs;
      }
      T* ks = wring + (i % kStages) * C::kStageElems;
      T* vs = ks + kChunk * C::kPitch;
      const int col = (lane % C::kRowChunks) * C::kVec;
#pragma unroll
      for (int t = 0; t < kChunk / C::kRowsPerPass; ++t) {
        const int r = t * C::kRowsPerPass + lane / C::kRowChunks;
        const int pg = __shfl_sync(kAll, page, r);
        const int sl = __shfl_sync(kAll, slot, r);
        const bool ok = k0 + r < k_hi;
        cp_async_16(smem_u32(ks + r * C::kPitch + col),
                    kbase + pg * p.k_sp + sl * p.k_ss + col, ok);
        cp_async_16(smem_u32(vs + r * C::kPitch + col),
                    vbase + pg * p.v_sp + sl * p.v_ss + col, ok);
      }
    }
    cp_async_commit();
  };

  float m[GB], l[GB], acc[GB][kCols];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[g][c] = 0.f;
  }
  const int j = lane & (kChunk - 1);  // the key this lane scores
  const int half = lane >> 4;         // and which half of D

  // the first chunks' copies, then q of the block's heads (f32) under them
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load(i);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h0 * p.q_sh;
  for (int i = tid; i < GB * D; i += kThreads) {
    const int g = i / D;
    qs[i] = g < gn ? to_f32(qg[g * p.q_sh + i - g * D]) : 0.f;
  }
  __syncthreads();
  for (int i = 0; i < n_mine; ++i) {
    load(i + kStages - 1);
    cp_async_wait<kStages - 1>();  // chunk i has landed
    __syncwarp();
    const T* ks = wring + (i % kStages) * C::kStageElems;
    const T* vs = ks + kChunk * C::kPitch;
    const int k0 = k_lo + (warp + i * kWarps) * kChunk;

    float s[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) s[g] = 0.f;
    half_dots<D, GB>(s, ks + j * C::kPitch + half * (D / 2),
                     qs + half * (D / 2));
    const bool valid = k0 + j < k_hi;  // key k0 always is
    float pr[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      s[g] += __shfl_xor_sync(kAll, s[g], 16);
      const float s2 = valid ? s[g] * p.scale2 : -INFINITY;
      float mx = s2;
#pragma unroll
      for (int off = 1; off < kChunk; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = fast_exp2(m[g] - m_new);  // 0 on the first chunk
      pr[g] = fast_exp2(s2 - m_new);                 // 0 for a masked key
      float ps = pr[g];
#pragma unroll
      for (int off = 1; off < kChunk; off <<= 1)
        ps += __shfl_xor_sync(kAll, ps, off);
      l[g] = fmaf(alpha, l[g], ps);
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[g][c] *= alpha;
    }
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      float vv[kCols];
      load_cols<kCols>(vv, vs + jj * C::kPitch + lane * kCols);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float pj = __shfl_sync(kAll, pr[g], jj);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[g][c] = fmaf(pj, vv[c], acc[g][c]);
      }
    }
    __syncwarp();  // the stage is refilled by a later load
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring is idle: the merge reuses the space

  // merge the four warps in warp order; a warp without keys has m = -inf
  float* const wacc = reinterpret_cast<float*>(ring);  // [warp][GB][D]
  float* const wm = wacc + kWarps * GB * D;             // [warp][GB]
  float* const wl = wm + kWarps * GB;                   // [warp][GB]
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      wacc[(warp * GB + g) * D + lane * kCols + c] = acc[g][c];
    if (lane == 0) {
      wm[warp * GB + g] = m[g];
      wl[warp * GB + g] = l[g];
    }
  }
  __syncthreads();
  for (int i = tid; i < gn * D; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * GB + g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = fast_exp2(wm[w * GB + g] - mx);
      den = fmaf(wl[w * GB + g], f, den);
      num = fmaf(wacc[(w * GB + g) * D + d], f, num);
    }
    if (p.splits == 1) {
      og[g * p.o_sh + d] = from_f32<T>(num / den);
    } else {
      const int64_t row =
          (static_cast<int64_t>(b) * p.H + h0 + g) * p.splits + split;
      p.part_o[row * D + d] = num / den;
      if (d == 0) p.part_lse[row] = (mx + log2f(den)) * kLn2;
    }
  }
}

// The output of head blockIdx.x of sequence blockIdx.y from the partials
// of the splits that saw keys, in split order; zeros for a dead lane.
template <typename T, int D>
__global__ void __launch_bounds__(D) paged_decode_merge(const Params p) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int len = min(max(p.lengths[b], 0), p.nb * p.bs);
  const int n = (len + p.split_keys - 1) / p.split_keys;
  const int64_t row = (static_cast<int64_t>(b) * p.H + h) * p.splits;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  og[threadIdx.x] = from_f32<T>(merge_splits(
      p.part_o + row * D, D, p.part_lse + row, 1, n, threadIdx.x));
}

template <typename T, int D, int GB>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D, GB>();
  static SmemOptIn opt_in;
  const int err = opt_in(paged_decode_split<T, D, GB>, smem);
  if (err != 0) return err;
  const int G = p.H / p.Hkv;
  const dim3 grid(p.splits, p.Hkv * ((G + GB - 1) / GB), p.B);
  paged_decode_split<T, D, GB><<<grid, kThreads, smem, stream>>>(p);
  if (p.splits > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    paged_decode_merge<T, D><<<dim3(p.H, p.B), D, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// heads a block serves: the group size rounded up to 1, 2, 4 or 8 (larger
// groups take several blocks, each reading the K/V again)
template <typename T, int D>
int dispatch_g(const Params& p, cudaStream_t stream) {
  const int G = p.H / p.Hkv;
  if (G <= 1) return launch<T, D, 1>(p, stream);
  if (G <= 2) return launch<T, D, 2>(p, stream);
  if (G <= 4) return launch<T, D, 4>(p, stream);
  return launch<T, D, 8>(p, stream);
}

template <typename T>
int dispatch_d(int D, const Params& p, cudaStream_t stream) {
  switch (D) {
    case 32: return dispatch_g<T, 32>(p, stream);
    case 64: return dispatch_g<T, 64>(p, stream);
    case 128: return dispatch_g<T, 128>(p, stream);
    default: return -1;
  }
}

}  // namespace

// Returns 0 on a clean launch, the cudaError_t of a refused launch, or -1
// for arguments this kernel has no instance for.  dtype: 0 = f32, 1 = bf16.
// The keys are cut into `splits` ranges of `split_pages` table entries
// (splits * split_pages >= nb); with splits > 1, part_o (B * H * splits * D
// f32) and part_lse (B * H * splits f32) are the scratch the splits merge
// through, and the call runs a second, merging kernel.  Launches on
// `stream` and does not synchronise.
extern "C" int zoo_paged_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const int* lengths, const int* block_tables, void* out, float* part_o,
    float* part_lse, long long q_sb, long long q_sh,
    long long k_sp, long long k_ss, long long k_sh,
    long long v_sp, long long v_ss, long long v_sh,
    long long o_sb, long long o_sh, long long t_sb,
    int B, int H, int Hkv, int D, int P, int bs, int nb, int splits,
    int split_pages, int dtype, float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || P <= 0 || bs <= 0 ||
      nb < 0 || splits <= 0 || split_pages <= 0 ||
      static_cast<long long>(splits) * split_pages < nb ||
      (splits > 1 && (part_o == nullptr || part_lse == nullptr)))
    return -1;
  Params p;
  p.q = q; p.k = k_pages; p.v = v_pages;
  p.lengths = lengths; p.tables = block_tables; p.o = out;
  p.part_o = part_o; p.part_lse = part_lse;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sp = k_sp; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sp = v_sp; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sh = o_sh; p.t_sb = t_sb;
  p.B = B; p.H = H; p.Hkv = Hkv; p.P = P; p.bs = bs; p.nb = nb;
  p.splits = splits;
  p.split_keys = split_pages * bs;
  p.scale2 = sm_scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(D, p, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(D, p, s);
  return -1;
}

extern "C" const char* zoo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
