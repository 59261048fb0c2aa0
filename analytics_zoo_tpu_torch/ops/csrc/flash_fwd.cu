// Flash-attention forward for Hopper (sm_90a), behind a plain C interface
// that analytics_zoo_tpu_torch/ops/_kernels.py loads with ctypes.
//
// Replaces: analytics_zoo_tpu/ops/attention.py::_flash_kernel, launched by
// _flash_forward (the Pallas TPU kernel).  Same function: online softmax
// with f32 running max / sum / accumulator over K tiles, an optional (B, Tk)
// padding mask, the end-aligned causal mask (row i sees key j iff
// j <= i + Tk - Tq, tiles wholly above the diagonal skipped), in-kernel
// dropout of the probabilities from the counter hash over
// (seed, b*H+h, q_pos, k_pos) with the normaliser summing the weights
// BEFORE dropout, and zeros for rows that see no key.
//
// What bounds it on an H100: at BERT's shapes (Tq = Tk = 128, D = 64) the
// work is 4*Tq*Tk*D flops against 4*T*D elements moved per head, about 32
// flops per byte in f32: above the f32 SIMT ridge (67 TFLOP/s over
// 3.35 TB/s is 20), so the bound is arithmetic.  This first version runs the
// products on the SIMT f32 pipes (no tensor cores), so in practice it is
// bound by shared-memory loads feeding those FMAs.
//
// What the design does about it: one block of 4 warps owns 32 query rows of
// one (batch, head); K and V are staged tile by tile (64 keys) in shared
// memory as f32 and read by every row of the block, so device memory sees
// each K/V element once per block, and scores never leave registers.  Each
// warp walks its 8 rows; for a row, lane j scores keys j and j+32 (the K
// tile's rows are padded to D+1 floats so those reads hit distinct banks),
// max and sum are warp shuffles, and the P.V update gives each lane D/32
// output columns.  wgmma, TMA and tuned tile sizes are later work.
//
// Inputs q, k, v are f32 or bf16 with unit stride in the last dimension and
// arbitrary (batch, head, seq) strides, so the caller can pass head views of
// a fused QKV projection without copies; the output is written through its
// own strides.  P is rounded to v's dtype before P.V, as the TPU kernel does,
// with f32 accumulation.

#include "flash_common.cuh"

namespace {

using namespace zoo_flash;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockM = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockN = 64;                     // keys per staged tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* mask;  // (B, Tk), 0 = padded key; null when no mask
  void* o;
  int64_t q_sb, q_sh, q_st;
  int64_t k_sb, k_sh, k_st;
  int64_t v_sb, v_sh, v_st;
  int64_t o_sb, o_sh, o_st;
  int B, H, Tq, Tk;
  float scale;
  int causal;
  uint32_t thresh;  // drop iff (bits >> 8) < thresh; 0 = no dropout
  float keep_scale;
  uint32_t seed;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockM * D + kBlockN * (D + 1) + kBlockN * D +
                          kWarps * kBlockN) +
         sizeof(int) * kBlockN;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  constexpr int kCols = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* qs = smem;                           // [kBlockM][D]
  float* ks = qs + kBlockM * D;               // [kBlockN][D + 1]
  float* vs = ks + kBlockN * (D + 1);         // [kBlockN][D]
  float* ps = vs + kBlockN * D;               // [kWarps][kBlockN]
  int* kvalid = reinterpret_cast<int*>(ps + kWarps * kBlockN);  // [kBlockN]

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * kBlockM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int32_t* mrow = p.mask ? p.mask + static_cast<int64_t>(b) * p.Tk
                               : nullptr;

  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int r = i / D, d = i - (i / D) * D;
    const int row = q0 + r;
    qs[i] = row < p.Tq ? to_f32(qg[row * p.q_st + d]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const int causal_offset = p.Tk - p.Tq;
  int k_end = p.Tk;
  if (p.causal) {
    // keys past the last row's diagonal are masked for every row here
    const int last_row = min(q0 + kBlockM, p.Tq) - 1;
    k_end = min(p.Tk, max(0, last_row + causal_offset + 1));
  }
  const uint32_t hbh = p.thresh ? head_hash(p.seed, bh) : 0u;

  for (int k0 = 0; k0 < k_end; k0 += kBlockN) {
    __syncthreads();  // Q staged / the previous tile fully consumed
    for (int i = tid; i < kBlockN * D; i += kThreads) {
      const int r = i / D, d = i - (i / D) * D;
      const int key = k0 + r;
      float kv = 0.f, vv = 0.f;  // zero-fill the ragged edge: 0 * V stays 0
      if (key < p.Tk) {
        kv = to_f32(kg[key * p.k_st + d]);
        vv = to_f32(vg[key * p.v_st + d]);
      }
      ks[r * (D + 1) + d] = kv;
      vs[r * D + d] = vv;
    }
    for (int i = tid; i < kBlockN; i += kThreads) {
      const int key = k0 + i;
      kvalid[i] = key < p.Tk && (mrow == nullptr || mrow[key] != 0);
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int rl = warp * kRowsPerWarp + r;
      const int row = q0 + rl;
      if (row < p.Tq) {  // warp-uniform
        const float* qr = qs + rl * D;
        float s[kBlockN / 32];
        float mx = kNegInf;
#pragma unroll
        for (int c = 0; c < kBlockN / 32; ++c) {
          const int key = lane + 32 * c;
          const float* kr = ks + key * (D + 1);
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
          const bool ok = kvalid[key] &&
                          (!p.causal || row + causal_offset >= k0 + key);
          s[c] = ok ? dot * p.scale : kNegInf;
          mx = fmaxf(mx, s[c]);
        }
        mx = warp_max(mx);
        const float m_new = fmaxf(m[r], mx);
        const float alpha = expf(m[r] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int c = 0; c < kBlockN / 32; ++c) {
          const int key = lane + 32 * c;
          // masked entries contribute 0 even when the whole row is masked
          float pc = s[c] <= kNegInf / 2 ? 0.f : expf(s[c] - m_new);
          psum += pc;  // the normaliser takes the weights before dropout
          if (p.thresh)
            pc = keep(hbh, row, k0 + key, p.thresh) ? pc * p.keep_scale : 0.f;
          ps[warp * kBlockN + key] = round_to<T>(pc);
        }
        psum = warp_sum(psum);
        l[r] = alpha * l[r] + psum;
        m[r] = m_new;
        __syncwarp();
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
        const float* pw = ps + warp * kBlockN;
#pragma unroll 8
        for (int j = 0; j < kBlockN; ++j) {
          const float pj = pw[j];
          const float* vr = vs + j * D + lane;
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[r][c] = fmaf(pj, vr[32 * c], acc[r][c]);
        }
        __syncwarp();  // ps is rewritten by this warp's next row
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row < p.Tq) {
      const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);  // empty rows -> 0
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        og[row * p.o_st + lane + 32 * c] = from_f32<T>(acc[r][c] * inv);
    }
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(p.B * p.H, (p.Tq + kBlockM - 1) / kBlockM);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
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

// Returns 0 on a clean launch, the cudaError_t of a refused launch, or -1
// for a head dim / dtype this kernel has no instance for.  dtype: 0 = f32,
// 1 = bf16.  Launches on `stream` and does not synchronise.
extern "C" int zoo_flash_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_st,
    int B, int H, int Tq, int Tk, int D, int dtype, float scale, int causal,
    unsigned int thresh, float keep_scale, int seed, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk < 0) return -1;
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.mask = static_cast<const int32_t*>(mask);
  p.o = o;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_st = q_st;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_st = o_st;
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
