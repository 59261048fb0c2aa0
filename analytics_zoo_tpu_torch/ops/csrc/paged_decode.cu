// Paged decode attention for Hopper (sm_90a), behind a plain C interface
// that analytics_zoo_tpu_torch/ops/_kernels.py loads with ctypes.
//
// Replaces: analytics_zoo_tpu/ops/paged_attention.py::_pallas_paged (jax's
// library paged-attention TPU kernel) behind paged_decode_attention.  Same
// function as its gather reference _gather_reference: one new token per
// sequence attends over the first lengths[b] cached tokens, read through the
// sequence's block table, softmax(q.k * scale).v with f32 scores, weights
// and accumulation; query head h reads KV head h / (H / Hkv) (GQA); a
// sequence with lengths[b] == 0 (a dead decode lane) gets zeros.
//
// What bounds it on an H100: every cached K and V element of the visible
// tokens is read once and feeds one multiply-add for the score and one for
// the output: half a flop per f32 byte, far below the ridge (67 TFLOP/s over
// 3.35 TB/s is 20), so the bound is bytes.  At GPT-2 small serving (B 32,
// 12 heads, D 64, 1024 tokens, f32) that is 201 MB, 0.060 ms.
//
// What the design does about it: one block of 4 warps per (sequence, KV
// head) serves the group's G = H / Hkv query heads, so each K/V row leaves
// device memory once.  The warps split the keys (warp w takes keys
// 32 w + lane, stepping 128) and walk only the table's first ceil(len / bs)
// entries; later entries are never read.  A lane reads its key's K row (L1
// keeps the row's sector for the next columns) and scores it for each head of
// the group; max and sum are warp shuffles; for the P.V update each lane owns
// D/32 output columns and reads the chunk's 32 V rows with coalesced loads,
// the row offsets passed round by shuffles.  Each warp keeps its own online
// softmax (max, sum, accumulator) per head in shared memory, so the key loop
// has no block-wide barrier; the four are merged at the end.  Vector loads,
// cp.async / TMA staging and splitting one long sequence over several blocks
// are later work.
//
// q is (B, H, D), the pages (P, bs, Hkv, D), all with unit stride in the
// last dimension and any other strides; lengths (B,) and the block tables
// (B, nb) are int32.  Out-of-range page ids are clamped into [0, P), as
// JAX's gather clamps them.  Output (B, H, D) in q's dtype.

#include "flash_common.cuh"

namespace {

using namespace zoo_flash;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr size_t kMaxSmem = 227 * 1024;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* lengths;
  const int32_t* tables;
  void* o;
  int64_t q_sb, q_sh;
  int64_t k_sp, k_ss, k_sh;
  int64_t v_sp, v_ss, v_sh;
  int64_t o_sb, o_sh;
  int64_t t_sb;
  int B, H, Hkv, P, bs, nb;
  float scale;
};

// q of the group, then per warp and head: accumulator, running max and sum
size_t smem_bytes(int G, int D) {
  return sizeof(float) * (static_cast<size_t>(G) * D * (1 + kWarps) +
                          2 * kWarps * static_cast<size_t>(G));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const Params p) {
  constexpr int kCols = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  const int G = p.H / p.Hkv;
  float* qs = smem;                   // [G][D]
  float* accs = qs + G * D;           // [kWarps][G][D]
  float* ms = accs + kWarps * G * D;  // [kWarps][G]
  float* ls = ms + kWarps * G;        // [kWarps][G]

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int len = min(max(p.lengths[b], 0), p.nb * p.bs);

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb +
                static_cast<int64_t>(kvh) * G * p.q_sh;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i - (i / D) * D;
    qs[i] = to_f32(qg[g * p.q_sh + d]);
  }
  for (int i = tid; i < kWarps * G * D; i += kThreads) accs[i] = 0.f;
  for (int i = tid; i < kWarps * G; i += kThreads) {
    ms[i] = kNegInf;
    ls[i] = 0.f;
  }
  __syncthreads();

  const int32_t* table = p.tables + b * p.t_sb;
  const T* kbase = static_cast<const T*>(p.k) + kvh * p.k_sh;
  const T* vbase = static_cast<const T*>(p.v) + kvh * p.v_sh;
  float* wacc = accs + warp * G * D;
  float* wm = ms + warp * G;
  float* wl = ls + warp * G;

  for (int k0 = warp * 32; k0 < len; k0 += kWarps * 32) {  // warp-uniform
    const int key = k0 + lane;
    const bool valid = key < len;
    long long koff = 0, voff = 0;
    if (valid) {
      const int blk = key / p.bs;
      const int page = min(max(table[blk], 0), p.P - 1);
      const int slot = key - blk * p.bs;
      koff = page * p.k_sp + slot * p.k_ss;
      voff = page * p.v_sp + slot * p.v_ss;
    }
    const T* krow = kbase + koff;
    const int n = min(32, len - k0);  // live keys of this chunk
    for (int g = 0; g < G; ++g) {
      const float* qr = qs + g * D;
      float s = kNegInf;
      if (valid) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], to_f32(krow[d]), dot);
        s = dot * p.scale;
      }
      const float m_old = wm[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      // masked entries contribute 0 even when no key is visible yet
      const float pk = s <= kNegInf / 2 ? 0.f : expf(s - m_new);
      const float alpha = expf(m_old - m_new);
      const float psum = warp_sum(pk);
      float* ag = wacc + g * D + lane;
      float acc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = ag[32 * c] * alpha;
      for (int j = 0; j < n; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pk, j);
        const T* vrow = vbase + __shfl_sync(0xffffffffu, voff, j) + lane;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[c] = fmaf(pj, to_f32(vrow[32 * c]), acc[c]);
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) ag[32 * c] = acc[c];
      __syncwarp();  // every lane has read wm[g] and wl[g]
      if (lane == 0) {
        wl[g] = alpha * wl[g] + psum;
        wm[g] = m_new;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // merge the four warps' partial softmaxes; no visible key -> zeros
  T* og = static_cast<T*>(p.o) + b * p.o_sb +
          static_cast<int64_t>(kvh) * G * p.o_sh;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i - (i / D) * D;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, ms[w * G + g]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(ms[w * G + g] - m);
      l = fmaf(ls[w * G + g], f, l);
      a = fmaf(accs[(w * G + g) * D + d], f, a);
    }
    og[g * p.o_sh + d] = from_f32<T>(l > 0.f ? a / l : 0.f);
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.H / p.Hkv, D);
  if (smem > kMaxSmem) return -1;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(p.B, p.Hkv);
  paged_decode_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
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
extern "C" int zoo_paged_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const int* lengths, const int* block_tables, void* out,
    long long q_sb, long long q_sh,
    long long k_sp, long long k_ss, long long k_sh,
    long long v_sp, long long v_ss, long long v_sh,
    long long o_sb, long long o_sh, long long t_sb,
    int B, int H, int Hkv, int D, int P, int bs, int nb, int dtype,
    float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || P <= 0 || bs <= 0 ||
      nb < 0)
    return -1;
  Params p;
  p.q = q; p.k = k_pages; p.v = v_pages;
  p.lengths = lengths; p.tables = block_tables; p.o = out;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sp = k_sp; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sp = v_sp; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sh = o_sh; p.t_sb = t_sb;
  p.B = B; p.H = H; p.Hkv = Hkv; p.P = P; p.bs = bs; p.nb = nb;
  p.scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(D, p, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(D, p, s);
  return -1;
}

extern "C" const char* zoo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
