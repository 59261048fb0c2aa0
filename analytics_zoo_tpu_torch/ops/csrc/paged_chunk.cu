// Paged chunked-prefill attention for Hopper (sm_90a), behind a plain C
// interface that analytics_zoo_tpu_torch/ops/_kernels.py loads with ctypes.
//
// Replaces: analytics_zoo_tpu/ops/paged_attention.py::paged_chunk_attention,
// which the JAX package computes with jnp (a gather of the whole page table,
// then dense masked softmax): the attention of one chunk of a prompt,
// queries at positions start .. start + Tc - 1, over every cached token of
// the sequence read through its page table, causal (query i sees key
// positions 0 .. start + i), softmax(q.k * scale).v with f32 scores, weights
// and accumulation, GQA query head h reading KV head h / (H / Hkv).  Padded
// tail rows of the chunk are computed like the others and discarded by the
// caller.
//
// What bounds it on an H100: at a 256-token chunk after 512 cached tokens
// (GPT-2 small: 12 heads, D 64) the work is 4 H Tc (start + Tc/2) D flops,
// 0.50 GFLOP, over 4.7 MB of q, K, V and output: about 100 flops per f32
// byte, above the f32 SIMT ridge (67 TFLOP/s over 3.35 TB/s is 20), so the
// bound is arithmetic (7.5 us).  This first version runs the products on the
// SIMT f32 pipes, so in practice it is bound by the shared-memory loads that
// feed those FMAs, as flash_fwd.cu is.
//
// What the design does about it: flash_fwd.cu's shape with the K/V tile
// gathered through the page table.  One block of 4 warps owns 32 query rows
// of one head; K and V are staged 64 keys at a time in shared memory as f32
// (key j of the tile from page table[(k0 + j) / bs], slot (k0 + j) % bs), so
// device memory sees each K/V element once per block, and scores never leave
// registers.  Each warp walks its 8 rows: lane j scores keys j and j + 32
// (the K tile's rows padded to D + 1 floats, so those reads hit distinct
// banks), max and sum are warp shuffles, and the P.V update gives each lane
// D/32 output columns.  Tiles wholly above the block's last diagonal are
// skipped.  Tensor cores, TMA and tuned tiles are later work.
//
// q is (Tc, H, D), the pages (P, bs, Hkv, D), with unit stride in the last
// dimension and any other strides; the page table (nb,) is int32, and start
// is an int the host knows, so the kernel reads no scalar from the device.
// Out-of-range page ids are clamped into [0, P), as JAX's gather clamps
// them.  Output (Tc, H, D) in q's dtype.

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
  const int32_t* table;
  void* o;
  int64_t q_st, q_sh;
  int64_t k_sp, k_ss, k_sh;
  int64_t v_sp, v_ss, v_sh;
  int64_t o_st, o_sh;
  int Tc, H, Hkv, P, bs, nb, start;
  float scale;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockM * D + kBlockN * (D + 1) + kBlockN * D +
                          kWarps * kBlockN);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_chunk_kernel(const Params p) {
  constexpr int kCols = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* qs = smem;                    // [kBlockM][D]
  float* ks = qs + kBlockM * D;        // [kBlockN][D + 1]
  float* vs = ks + kBlockN * (D + 1);  // [kBlockN][D]
  float* ps = vs + kBlockN * D;        // [kWarps][kBlockN]

  const int h = blockIdx.x;
  const int kvh = h / (p.H / p.Hkv);
  const int q0 = blockIdx.y * kBlockM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const T* qg = static_cast<const T*>(p.q) + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + kvh * p.v_sh;
  T* og = static_cast<T*>(p.o) + h * p.o_sh;

  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int r = i / D, d = i - (i / D) * D;
    const int row = q0 + r;
    qs[i] = row < p.Tc ? to_f32(qg[row * p.q_st + d]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  // keys past the block's last row's position are masked for every row
  const int last_row = min(q0 + kBlockM, p.Tc) - 1;
  const int k_end = min(p.nb * p.bs, max(0, p.start + last_row + 1));

  for (int k0 = 0; k0 < k_end; k0 += kBlockN) {
    __syncthreads();  // Q staged / the previous tile fully consumed
    for (int i = tid; i < kBlockN * D; i += kThreads) {
      const int r = i / D, d = i - (i / D) * D;
      const int key = k0 + r;
      float kv = 0.f, vv = 0.f;  // zero-fill the ragged edge: 0 * V stays 0
      if (key < k_end) {
        const int blk = key / p.bs;
        const int page = min(max(p.table[blk], 0), p.P - 1);
        const int slot = key - blk * p.bs;
        kv = to_f32(kg[page * p.k_sp + slot * p.k_ss + d]);
        vv = to_f32(vg[page * p.v_sp + slot * p.v_ss + d]);
      }
      ks[r * (D + 1) + d] = kv;
      vs[r * D + d] = vv;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int rl = warp * kRowsPerWarp + r;
      const int row = q0 + rl;
      if (row < p.Tc) {  // warp-uniform
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
          const bool ok = k0 + key < k_end && k0 + key <= p.start + row;
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
          const float pc = s[c] <= kNegInf / 2 ? 0.f : expf(s[c] - m_new);
          psum += pc;
          ps[warp * kBlockN + key] = pc;  // f32 weights, as the reference
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
    if (row < p.Tc) {
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no key -> zeros
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
        paged_chunk_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(p.H, (p.Tc + kBlockM - 1) / kBlockM);
  paged_chunk_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
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
// for arguments this kernel has no instance for.  dtype: 0 = f32, 1 = bf16.
// Launches on `stream` and does not synchronise.
extern "C" int zoo_paged_chunk(
    const void* q, const void* k_pages, const void* v_pages,
    const int* page_table, void* out,
    long long q_st, long long q_sh,
    long long k_sp, long long k_ss, long long k_sh,
    long long v_sp, long long v_ss, long long v_sh,
    long long o_st, long long o_sh,
    int Tc, int H, int Hkv, int D, int P, int bs, int nb, int start,
    int dtype, float sm_scale, void* stream) {
  if (Tc <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || P <= 0 || bs <= 0 ||
      nb < 0 || start < 0)
    return -1;
  Params p;
  p.q = q; p.k = k_pages; p.v = v_pages;
  p.table = page_table; p.o = out;
  p.q_st = q_st; p.q_sh = q_sh;
  p.k_sp = k_sp; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sp = v_sp; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_st = o_st; p.o_sh = o_sh;
  p.Tc = Tc; p.H = H; p.Hkv = Hkv; p.P = P; p.bs = bs; p.nb = nb;
  p.start = start;
  p.scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(D, p, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(D, p, s);
  return -1;
}

extern "C" const char* zoo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
