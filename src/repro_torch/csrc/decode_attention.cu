// One-token GQA decode attention over a dense or paged KV cache, for Hopper
// (sm_90a). Plain C entry point, loaded with ctypes.
//
// Replaces the TPU kernels decode_attention_pallas (dense cache) and
// decode_attention_pallas_paged (page-table pool) of
// src/repro/kernels/decode_attention.py.
//
// Semantics follow the plain PyTorch version (decode_attention_plain in
// src/repro_torch/kernels/decode_attention.py, itself the port of the XLA
// path decode_attention_xla): an entry t of the T attended entries is masked
// when pos_cache[t] < 0, when it lies after the query position, or outside
// the sliding window; masked scores take the finite value -1e30 (never
// -inf), so a row whose T entries are all masked returns the mean of its T
// value rows, exactly as the XLA path does. Entries past T are not attended.
// Softmax runs online in f32; output = acc / max(l, 1e-30).
//
// Bound on the card: decode reads each K and V row of the attended context
// once, 2 * B * T * K * hd * sizeof(dtype) bytes, and does about 4 flops per
// element read, far below the ~295 flop/byte ridge of an H100: the kernel is
// bound by memory bytes. Design: one block per (slot, KV head) holds all G
// query heads of its group, so each K/V row crosses device memory once and
// serves G heads. The context streams through shared memory in tiles of 32
// rows (one warp-width, so each head's tile softmax is one warp reduction).
// Rows are addressed by strides (dense: base + b*sb + t*st + h*sh; paged:
// pages[b, t / page] * page_stride + (t % page) * row_stride + h*sh), which
// takes a context-bucket view k[:, :teff] or a layer slice of the stacked
// cache without a copy. The grid is only B*K blocks (8-16 at the serving
// shapes) on 132 SMs; splitting the context across blocks (flash-decoding)
// is the next step and is not done here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // context rows per tile == warp size
constexpr int kMaxG = 8;   // query heads per KV head
constexpr int kMaxHd = 128;
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Args {
  const void* q;        // (B, 1, H, hd) contiguous
  const void* k;        // dense (B, T, K, hd) or paged (P, page, K, hd), strided
  const void* v;
  const int* pos_q;     // (B,)
  const int* pos_c;     // (B, >=T), row stride pc_sb
  const int* pages;     // (B, >=ceil(T/page)), row stride pg_sb; null = dense
  void* out;            // (B, 1, H, hd) contiguous
  int H, K, hd, T, page, window;
  int64_t k_sb, k_st, k_sh, v_sb, v_st, v_sh;  // element strides
  int64_t pc_sb, pg_sb;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_kernel(Args a) {
  __shared__ float q_s[kMaxG][kMaxHd];
  __shared__ float k_s[kTile][kMaxHd + 1];  // +1: conflict-free column reads
  __shared__ float v_s[kTile][kMaxHd];
  __shared__ float p_s[kMaxG][kTile];
  __shared__ int state_s[kTile];  // 0 past T, 1 masked, 2 attended
  __shared__ float m_s[kMaxG], l_s[kMaxG], corr_s[kMaxG];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int hd = a.hd;
  const int G = a.H / a.K;
  const int gh = G * hd;

  const T* q = static_cast<const T*>(a.q) + ((int64_t)b * a.H + (int64_t)kh * G) * hd;
  for (int i = tid; i < gh; i += kThreads) q_s[i / hd][i % hd] = to_f32(q[i]);
  if (tid < G) {
    m_s[tid] = kMasked;
    l_s[tid] = 0.f;
  }
  float acc[kMaxG];
#pragma unroll
  for (int j = 0; j < kMaxG; ++j) acc[j] = 0.f;

  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  const int pq = a.pos_q[b];
  const int* pc = a.pos_c + (int64_t)b * a.pc_sb;
  const int* pt = a.pages ? a.pages + (int64_t)b * a.pg_sb : nullptr;

  for (int t0 = 0; t0 < a.T; t0 += kTile) {
    if (tid < kTile) {
      const int t = t0 + tid;
      int st = 0;
      if (t < a.T) {
        const int p = pc[t];
        const int d = pq - p;
        const bool ok = p >= 0 && d >= 0 && (a.window <= 0 || d < a.window);
        st = ok ? 2 : 1;
      }
      state_s[tid] = st;
    }
    for (int i = tid; i < kTile * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      const int t = t0 + r;
      float kv = 0.f, vv = 0.f;
      if (t < a.T) {
        int64_t kb, vb;
        if (pt) {
          const int64_t pg = pt[t / a.page];
          const int64_t off = t % a.page;
          kb = pg * a.k_sb + off * a.k_st + (int64_t)kh * a.k_sh;
          vb = pg * a.v_sb + off * a.v_st + (int64_t)kh * a.v_sh;
        } else {
          kb = (int64_t)b * a.k_sb + (int64_t)t * a.k_st + (int64_t)kh * a.k_sh;
          vb = (int64_t)b * a.v_sb + (int64_t)t * a.v_st + (int64_t)kh * a.v_sh;
        }
        kv = to_f32(kp[kb + d]);
        vv = to_f32(vp[vb + d]);
      }
      k_s[r][d] = kv;
      v_s[r][d] = vv;
    }
    __syncthreads();

    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, r = i - g * kTile;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += q_s[g][d] * k_s[r][d];
      s *= a.scale;
      p_s[g][r] = state_s[r] == 1 ? kMasked : s;
    }
    __syncthreads();

    // online softmax update, one warp per query head
    for (int g = warp; g < G; g += kThreads / 32) {
      const bool in = state_s[lane] != 0;
      const float s = p_s[g][lane];
      float mx = in ? s : -3.0e38f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p = in ? expf(s - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[g][lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        m_s[g] = m_new;
        l_s[g] = l_s[g] * corr + sum;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kMaxG; ++j) {
      const int e = tid + j * kThreads;
      if (e < gh) {
        const int g = e / hd, d = e - g * hd;
        float s = 0.f;
        for (int r = 0; r < kTile; ++r) s += p_s[g][r] * v_s[r][d];
        acc[j] = acc[j] * corr_s[g] + s;
      }
    }
    __syncthreads();
  }

  T* out = static_cast<T*>(a.out) + ((int64_t)b * a.H + (int64_t)kh * G) * hd;
#pragma unroll
  for (int j = 0; j < kMaxG; ++j) {
    const int e = tid + j * kThreads;
    if (e < gh) store(out + e, acc[j] / fmaxf(l_s[e / hd], 1e-30f));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. pages == nullptr selects the dense cache.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int decode_attention_launch(
    int dtype, const void* q, const void* k, const void* v, const int* pos_q,
    const int* pos_c, const int* pages, void* out, int B, int H, int K, int hd,
    int T, int page, int window, int64_t k_sb, int64_t k_st, int64_t k_sh,
    int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t pc_sb, int64_t pg_sb,
    float scale, void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.pos_q = pos_q; a.pos_c = pos_c;
  a.pages = pages; a.out = out;
  a.H = H; a.K = K; a.hd = hd; a.T = T; a.page = page; a.window = window;
  a.k_sb = k_sb; a.k_st = k_st; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_st = v_st; a.v_sh = v_sh;
  a.pc_sb = pc_sb; a.pg_sb = pg_sb; a.scale = scale;
  const dim3 grid(K, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    decode_kernel<float><<<grid, kThreads, 0, s>>>(a);
  } else if (dtype == 1) {
    decode_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
