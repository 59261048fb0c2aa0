// Flash-attention backward for Hopper (sm_90a), behind a plain C interface
// that analytics_zoo_tpu_torch/ops/_kernels.py loads with ctypes.
//
// Replaces: analytics_zoo_tpu/ops/attention.py::_bwd_kernel_single (the
// Pallas TPU kernel launched by _bwd_single_pallas, taken when all of K
// fits one block) and its jnp sibling _blockwise_bwd (the two-pass scan
// for long K).  This kernel tiles over K, so it has no one-block limit
// and serves both regimes with no dispatch rule between them.  Same
// function: recompute P in f32 from the scores (rows that see no key give
// P = 0), replay the forward's dropout keep-mask from the counter hash
// over (seed, b*H+h, q_pos, k_pos), delta = rowsum(g * o) (the FA-2
// dropout identity), Z = keep ? P/(1-r) : 0, dP = keep ? (g v^T)/(1-r) : 0,
// dS = P * (dP - delta) * scale, then dv = Z^T g, dq = dS k, dk = dS^T q,
// with Z and dS rounded to the input dtype before their products and f32
// accumulation, outputs in the input dtype.
//
// What bounds it on an H100: the five products take 10*Tq*Tk*D flops per
// head against 8*T*D elements moved; at BERT's T = 128, D = 64 that is
// about 40 flops per byte in f32, above the f32 SIMT ridge (67 TFLOP/s
// over 3.35 TB/s is 20), so the bound is arithmetic.  This first version
// recomputes the scores in both of its kernels (seven products and a
// row-statistics pass in all) on the SIMT f32 pipes, and is bound in
// practice by the shared-memory loads feeding those FMAs.
//
// What the design does about it: two kernels, no float atomics, so two
// runs give bit-identical gradients.
//   dq kernel: one block of 4 warps per (batch*head, 32 query rows).  It
//     stages its q and g rows in shared memory, computes delta, walks the
//     K tiles once for each row's max and sum (lse = m + log l, +inf for a
//     row that sees no key) and once more for dS and dq (dq in
//     registers).  It writes lse and delta for the second kernel.
//   dk/dv kernel: one block per (batch*head, 32 keys).  It stages its K
//     and V tiles once and walks the Q tiles that can see them (causal
//     tiles above the diagonal skipped), with dk and dv in registers.
// In the score phase lane j scores key j of the tile against the warp's
// 8 rows (K and V rows padded to D+1 floats so lanes hit distinct banks);
// in the product phase each lane owns D/32 output columns.  wgmma, TMA
// and a single fused kernel are later work.
//
// Inputs q, k, v, o, g are f32 or bf16 with unit stride in the last
// dimension and arbitrary (batch, head, seq) strides; dq, dk, dv are
// written through their own strides.  Causal is end-aligned: row i sees
// key j iff j <= i + Tk - Tq.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace zoo_flash;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockM = kWarps * kRowsPerWarp;  // query rows per tile
constexpr int kBlockN = 32;                     // keys per tile: one a lane
constexpr int kPad = kBlockN + 1;               // (kBlockM, kBlockN) tiles

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g;
  const int32_t* mask;  // (B, Tk), 0 = padded key; null when no mask
  void* dq;
  void* dk;
  void* dv;
  float* lse;    // (B*H, Tq) scratch: written by the dq kernel
  float* delta;  // (B*H, Tq) scratch: written by the dq kernel
  int64_t q_sb, q_sh, q_st;
  int64_t k_sb, k_sh, k_st;
  int64_t v_sb, v_sh, v_st;
  int64_t o_sb, o_sh, o_st;
  int64_t g_sb, g_sh, g_st;
  int64_t dq_sb, dq_sh, dq_st;
  int64_t dk_sb, dk_sh, dk_st;
  int64_t dv_sb, dv_sh, dv_st;
  int B, H, Tq, Tk;
  float scale;
  int causal;
  uint32_t thresh;  // drop iff (bits >> 8) < thresh; 0 = no dropout
  float keep_scale;
  uint32_t seed;
};

// shared-memory layout, in floats
template <int D>
struct Smem {
  static constexpr int kQ = 0;                             // [kBlockM][D]
  static constexpr int kG = kQ + kBlockM * D;              // [kBlockM][D]
  static constexpr int kK = kG + kBlockM * D;              // [kBlockN][D+1]
  static constexpr int kV = kK + kBlockN * (D + 1);        // [kBlockN][D+1]
  static constexpr int kZ = kV + kBlockN * (D + 1);        // [kBlockM][kPad]
  static constexpr int kS = kZ + kBlockM * kPad;           // [kBlockM][kPad]
  static constexpr int kLse = kS + kBlockM * kPad;         // [kBlockM]
  static constexpr int kDelta = kLse + kBlockM;            // [kBlockM]
  static constexpr int kValid = kDelta + kBlockM;          // [kBlockN] int
  static constexpr size_t kBytes = sizeof(float) * (kValid + kBlockN);
};

// rows [row0, row0 + kBlockM) of a (T, D) head slice -> f32 [kBlockM][D],
// zeros past the end
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           int64_t st, int row0, int T_) {
  for (int i = threadIdx.x; i < kBlockM * D; i += kThreads) {
    const int r = i / D, d = i - (i / D) * D;
    const int row = row0 + r;
    dst[i] = row < T_ ? to_f32(src[row * st + d]) : 0.f;
  }
}

// keys [k0, k0 + kBlockN): K and V rows padded to D+1, zeros past the end,
// and each key's validity (in range and not padded)
template <typename T, int D, bool kWithV>
__device__ __forceinline__ void stage_keys(const Params& p, float* ks,
                                           float* vs, int* kvalid,
                                           const T* kg, const T* vg,
                                           const int32_t* mrow, int k0) {
  for (int i = threadIdx.x; i < kBlockN * D; i += kThreads) {
    const int r = i / D, d = i - (i / D) * D;
    const int key = k0 + r;
    const bool in = key < p.Tk;
    ks[r * (D + 1) + d] = in ? to_f32(kg[key * p.k_st + d]) : 0.f;
    if (kWithV) vs[r * (D + 1) + d] = in ? to_f32(vg[key * p.v_st + d]) : 0.f;
  }
  for (int i = threadIdx.x; i < kBlockN; i += kThreads) {
    const int key = k0 + i;
    kvalid[i] = key < p.Tk && (mrow == nullptr || mrow[key] != 0);
  }
}

// whether row `row` may attend to key `key` of the staged tile (lane j)
__device__ __forceinline__ bool visible(const Params& p, const int* kvalid,
                                        int row, int key, int j) {
  return row < p.Tq && kvalid[j] &&
         (!p.causal || row + (p.Tk - p.Tq) >= key);
}

// The score phase, shared by both kernels: for the warp's rows
// (tile row warp*8 + r, query position q0 + that) against key `lane` of
// the staged tile (position k0 + lane): Z = P after dropout and dS, both
// rounded to T.  Needs qs, gs, ks, vs, kvalid and the rows' lse / delta.
template <typename T, int D>
__device__ __forceinline__ void score_phase(
    const Params& p, const float* qs, const float* gs, const float* ks,
    const float* vs, const int* kvalid, const float* row_lse,
    const float* row_delta, int q0, int k0, uint32_t head,
    float (&z)[kRowsPerWarp], float (&ds)[kRowsPerWarp]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* kr = ks + lane * (D + 1);
  const float* vr = vs + lane * (D + 1);
  float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float kd = kr[d], vd = vr[d];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int rl = warp * kRowsPerWarp + r;
      s[r] = fmaf(qs[rl * D + d], kd, s[r]);
      dp[r] = fmaf(gs[rl * D + d], vd, dp[r]);
    }
  }
  const int key = k0 + lane;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int rl = warp * kRowsPerWarp + r;
    const int row = q0 + rl;
    // lse is +inf for a row with no visible key, so P is 0 there too
    const float pr = visible(p, kvalid, row, key, lane)
                         ? expf(s[r] * p.scale - row_lse[rl])
                         : 0.f;
    float zr = pr, dpr = dp[r];
    if (p.thresh) {
      const bool kept = keep(head, row, key, p.thresh);
      zr = kept ? pr * p.keep_scale : 0.f;
      dpr = kept ? dpr * p.keep_scale : 0.f;
    }
    z[r] = round_to<T>(zr);
    ds[r] = round_to<T>(pr * (dpr - row_delta[rl]) * p.scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Params p) {
  constexpr int kCols = D / 32;  // output columns per lane
  using S = Smem<D>;
  extern __shared__ float smem[];
  float* qs = smem + S::kQ;
  float* gs = smem + S::kG;
  float* ks = smem + S::kK;
  float* vs = smem + S::kV;
  float* dss = smem + S::kS;
  float* row_lse = smem + S::kLse;
  float* row_delta = smem + S::kDelta;
  int* kvalid = reinterpret_cast<int*>(smem + S::kValid);

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * kBlockM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* og = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const T* gg = static_cast<const T*>(p.g) + b * p.g_sb + h * p.g_sh;
  T* dqg = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  const int32_t* mrow =
      p.mask ? p.mask + static_cast<int64_t>(b) * p.Tk : nullptr;
  const int64_t stat0 = static_cast<int64_t>(bh) * p.Tq;

  stage_rows<T, D>(qs, qg, p.q_st, q0, p.Tq);
  stage_rows<T, D>(gs, gg, p.g_st, q0, p.Tq);

  // delta = rowsum(g * o) in f32, one warp per row
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int rl = warp * kRowsPerWarp + r;
    const int row = q0 + rl;
    float acc = 0.f;
    if (row < p.Tq) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        acc = fmaf(to_f32(gg[row * p.g_st + d]), to_f32(og[row * p.o_st + d]),
                   acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      row_delta[rl] = acc;
      if (row < p.Tq) p.delta[stat0 + row] = acc;
    }
  }

  int k_end = p.Tk;
  if (p.causal) {
    // keys past the last row's diagonal are masked for every row here
    const int last_row = min(q0 + kBlockM, p.Tq) - 1;
    k_end = min(p.Tk, max(0, last_row + (p.Tk - p.Tq) + 1));
  }

  // pass 1: each row's max and sum of exp over its visible keys
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  for (int k0 = 0; k0 < k_end; k0 += kBlockN) {
    __syncthreads();  // q / g staged, or the previous tile consumed
    stage_keys<T, D, false>(p, ks, vs, kvalid, kg, vg, mrow, k0);
    __syncthreads();
    const float* kr = ks + lane * (D + 1);
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        s[r] = fmaf(qs[(warp * kRowsPerWarp + r) * D + d], kd, s[r]);
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = q0 + warp * kRowsPerWarp + r;
      const bool ok = visible(p, kvalid, row, k0 + lane, lane);
      const float sv = ok ? s[r] * p.scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float e = ok ? expf(sv - m_new) : 0.f;
      l[r] = l[r] * expf(m[r] - m_new) + warp_sum(e);
      m[r] = m_new;
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int rl = warp * kRowsPerWarp + r;
    const int row = q0 + rl;
    const float lse = l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
    if (lane == 0) {
      row_lse[rl] = lse;
      if (row < p.Tq) p.lse[stat0 + row] = lse;
    }
  }

  // pass 2: dS and dq = dS k
  const uint32_t head = p.thresh ? head_hash(p.seed, bh) : 0u;
  float acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  for (int k0 = 0; k0 < k_end; k0 += kBlockN) {
    __syncthreads();  // the previous tile fully consumed
    stage_keys<T, D, true>(p, ks, vs, kvalid, kg, vg, mrow, k0);
    __syncthreads();
    float z[kRowsPerWarp], ds[kRowsPerWarp];
    score_phase<T, D>(p, qs, gs, ks, vs, kvalid, row_lse, row_delta, q0, k0,
                      head, z, ds);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      dss[(warp * kRowsPerWarp + r) * kPad + lane] = ds[r];
    __syncwarp();  // the warp reads back only its own rows
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float* dsr = dss + (warp * kRowsPerWarp + r) * kPad;
#pragma unroll 8
      for (int j = 0; j < kBlockN; ++j) {
        const float dsv = dsr[j];
        const float* kr = ks + j * (D + 1) + lane;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[r][c] = fmaf(dsv, kr[32 * c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row < p.Tq) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        dqg[row * p.dq_st + lane + 32 * c] = from_f32<T>(acc[r][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const Params p) {
  constexpr int kCols = D / 32;  // output columns per lane
  using S = Smem<D>;
  extern __shared__ float smem[];
  float* qs = smem + S::kQ;
  float* gs = smem + S::kG;
  float* ks = smem + S::kK;
  float* vs = smem + S::kV;
  float* zs = smem + S::kZ;
  float* dss = smem + S::kS;
  float* row_lse = smem + S::kLse;
  float* row_delta = smem + S::kDelta;
  int* kvalid = reinterpret_cast<int*>(smem + S::kValid);

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int k0 = blockIdx.y * kBlockN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* gg = static_cast<const T*>(p.g) + b * p.g_sb + h * p.g_sh;
  T* dkg = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvg = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  const int32_t* mrow =
      p.mask ? p.mask + static_cast<int64_t>(b) * p.Tk : nullptr;
  const int64_t stat0 = static_cast<int64_t>(bh) * p.Tq;

  stage_keys<T, D, true>(p, ks, vs, kvalid, kg, vg, mrow, k0);

  // causal: rows before k0 - (Tk - Tq) see none of these keys
  int q_begin = 0;
  if (p.causal) q_begin = max(0, k0 - (p.Tk - p.Tq)) / kBlockM * kBlockM;
  const uint32_t head = p.thresh ? head_hash(p.seed, bh) : 0u;

  // this thread accumulates keys warp*8 + r, columns lane + 32c
  float adk[kRowsPerWarp][kCols], adv[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) adk[r][c] = adv[r][c] = 0.f;

  for (int q0 = q_begin; q0 < p.Tq; q0 += kBlockM) {
    __syncthreads();  // keys staged, or the previous Q tile consumed
    stage_rows<T, D>(qs, qg, p.q_st, q0, p.Tq);
    stage_rows<T, D>(gs, gg, p.g_st, q0, p.Tq);
    for (int i = tid; i < kBlockM; i += kThreads) {
      const int row = q0 + i;
      row_lse[i] = row < p.Tq ? p.lse[stat0 + row] : INFINITY;
      row_delta[i] = row < p.Tq ? p.delta[stat0 + row] : 0.f;
    }
    __syncthreads();
    float z[kRowsPerWarp], ds[kRowsPerWarp];
    score_phase<T, D>(p, qs, gs, ks, vs, kvalid, row_lse, row_delta, q0, k0,
                      head, z, ds);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      zs[(warp * kRowsPerWarp + r) * kPad + lane] = z[r];
      dss[(warp * kRowsPerWarp + r) * kPad + lane] = ds[r];
    }
    __syncthreads();  // every warp reads every row of Z and dS
#pragma unroll 4
    for (int i = 0; i < kBlockM; ++i) {
      float gc[kCols], qc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        gc[c] = gs[i * D + lane + 32 * c];
        qc[c] = qs[i * D + lane + 32 * c];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int j = warp * kRowsPerWarp + r;
        const float zv = zs[i * kPad + j];
        const float dsv = dss[i * kPad + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          adv[r][c] = fmaf(zv, gc[c], adv[r][c]);
          adk[r][c] = fmaf(dsv, qc[c], adk[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int key = k0 + warp * kRowsPerWarp + r;
    if (key < p.Tk) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dkg[key * p.dk_st + lane + 32 * c] = from_f32<T>(adk[r][c]);
        dvg[key * p.dv_st + lane + 32 * c] = from_f32<T>(adv[r][c]);
      }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Smem<D>::kBytes;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dkdv_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(p.B * p.H, (p.Tq + kBlockM - 1) / kBlockM);
  flash_bwd_dq_kernel<T, D><<<grid_q, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_k(p.B * p.H, (p.Tk + kBlockN - 1) / kBlockN);
  flash_bwd_dkdv_kernel<T, D><<<grid_k, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const Params& p, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return -1;
  }
}

}  // namespace

// Returns 0 on clean launches, the cudaError_t of a refused launch, or -1
// for a head dim / dtype / shape this kernel has no instance for.  dtype:
// 0 = f32, 1 = bf16.  strides: (batch, head, seq) for q, k, v, o, g, dq,
// dk, dv in that order.  lse and delta are (B*H*Tq) f32 scratch.  Both
// kernels go on `stream`; nothing synchronises.
extern "C" int zoo_flash_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, const void* mask, void* dq, void* dk, void* dv,
    float* lse, float* delta, const long long* strides, int B, int H,
    int Tq, int Tk, int D, int dtype, float scale, int causal,
    unsigned int thresh, float keep_scale, int seed, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return -1;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.g = g;
  p.mask = static_cast<const int32_t*>(mask);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.lse = lse; p.delta = delta;
  int64_t* dst[] = {&p.q_sb, &p.q_sh, &p.q_st, &p.k_sb, &p.k_sh, &p.k_st,
                    &p.v_sb, &p.v_sh, &p.v_st, &p.o_sb, &p.o_sh, &p.o_st,
                    &p.g_sb, &p.g_sh, &p.g_st, &p.dq_sb, &p.dq_sh, &p.dq_st,
                    &p.dk_sb, &p.dk_sh, &p.dk_st, &p.dv_sb, &p.dv_sh,
                    &p.dv_st};
  for (int i = 0; i < 24; ++i) *dst[i] = strides[i];
  p.B = B; p.H = H; p.Tq = Tq; p.Tk = Tk;
  p.scale = scale;
  p.causal = causal;
  p.thresh = thresh;
  p.keep_scale = keep_scale;
  p.seed = static_cast<uint32_t>(seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(D, p, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(D, p, s);
  return -1;
}

extern "C" const char* zoo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
