// Prefill self-attention (flash attention) with GQA, for Hopper (sm_90a).
// Plain C entry point, loaded with ctypes.
//
// Replaces the TPU kernel flash_attention_pallas of
// src/repro/kernels/flash_attention.py (reached through ops.flash_attention
// by attn_impl="pallas").
//
// Semantics follow flash_attention_plain in
// src/repro_torch/kernels/flash_attention.py: q (B, S, H, hd), k and v
// (B, S, K, hd), query head h reads KV head h / (H / K), position == index.
// A score is masked when causal and col > row, or when a window is set and
// row - col >= window; masked scores take the finite -1e30 and the running
// max starts at -1e30, as in the Pallas body, so a tile whose entries are
// all masked for a row adds weight that the first attended tile rescales by
// exp(-1e30 - m) = 0. Keys past S (the ragged last tile) are excluded
// outright. Scores are scaled by the true hd^-0.5; the softmax runs online
// in f32 and the output is acc / max(l, 1e-30) in q's dtype. Any S: both
// tiles are masked at S, where the Pallas kernel asserts S % 128 == 0 once
// S passes 128.
//
// Bound on the card: at the serving shapes (R = 4 rows, S = 272-512,
// hd = 128, bf16) a launch moves 9-21 MB of q, k, v and o and does ~1-3
// GFLOP of causal products: ~3-6 us of bytes against ~1-3 us of bf16
// tensor-core operations, so the bytes bound it, and the tiles sit close
// to the ridge. Design: one block of 4 warps per (64-row query tile, query
// head, batch row); K/V tiles of 64 rows of KV head h / G stream through
// shared memory (the G query heads of a group read the same tiles, which
// L2 serves after the first), tiles wholly above the diagonal or wholly
// outside the window are skipped, and each query tile is read once and
// written once. The bf16 path multiplies with mma.sync m16n8k16 (bf16 in,
// f32 accumulate): each warp holds 16 query rows, its scores stay in
// registers, and the probabilities, rounded to bf16, feed the PV product
// straight from the score fragments. The f32 path must not use TF32, so it
// multiplies with plain f32 FMAs over shared-memory tiles (each thread 4
// rows x 8 keys of scores, 4 rows x hd/8 columns of output). Rows are
// addressed by strides, so a q view from rope goes in without a copy;
// 16-byte vector loads are used when every row start is 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBlockQ = 64;    // query rows per block
constexpr int kBlockK = 64;    // key rows per tile
constexpr float kMasked = -1e30f;

struct Args {
  const void* q;  // (B, S, H, hd), strided, unit stride on hd
  const void* k;  // (B, S, K, hd), strided
  const void* v;
  void* out;      // (B, S, H, hd) contiguous
  int S, H, K, causal, window, vec;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;  // elements
  float scale;
};

// The key tiles [lo, hi] that query tile q0 reads: tiles wholly above the
// diagonal (causal) or wholly before the window are skipped.
__device__ __forceinline__ void tile_range(const Args& a, int q0, int& lo,
                                           int& hi) {
  const int n_k = (a.S + kBlockK - 1) / kBlockK;
  const int q_last = min(q0 + kBlockQ, a.S) - 1;
  hi = a.causal ? q_last / kBlockK : n_k - 1;
  lo = 0;
  if (a.window > 0) {
    // tile kt is all masked iff its last key kt*64+63 <= q0 - window
    const int t = q0 - a.window - (kBlockK - 1);
    lo = t >= 0 ? t / kBlockK + 1 : 0;
  }
}

__device__ __forceinline__ float mask_score(const Args& a, float x, int row,
                                            int col) {
  if (col >= a.S) return -INFINITY;  // past S: excluded outright
  if ((a.causal && col > row) || (a.window > 0 && row - col >= a.window))
    return kMasked;
  return x;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, f32 accumulation
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 64 rows of hd bf16 into shared memory (row stride HD + 8); rows at and
// past `rows` are zero (a zero V row keeps 0 * garbage out of the PV sum).
template <int HD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int64_t row_stride, int rows,
                                               int vec) {
  constexpr int LD = HD + 8;
  if (vec) {
    constexpr int kChunks = HD / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows)
        val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < kBlockK * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      dst[r * LD + c] = r < rows ? src[r * row_stride + c]
                                 : __float2bfloat16(0.f);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bf16_kernel(Args a) {
  constexpr int LD = HD + 8;  // +16 bytes: conflict-free fragment loads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kBlockQ * LD;
  __nv_bfloat16* v_s = k_s + kBlockK * LD;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const __nv_bfloat16* qp =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const __nv_bfloat16* vp =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + kh * a.v_sh;

  load_tile_bf16<HD>(q_s, qp + q0 * a.q_ss, a.q_ss, a.S - q0, a.vec);
  __syncthreads();

  // this warp's 16 query rows as A fragments, for the whole kernel
  const int r0 = warp * 16 + g;
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) {
    const __nv_bfloat16* p0 = q_s + r0 * LD + kc * 16 + t4 * 2;
    const __nv_bfloat16* p1 = p0 + 8 * LD;
    qf[kc][0] = ld32(p0);
    qf[kc][1] = ld32(p1);
    qf[kc][2] = ld32(p0 + 8);
    qf[kc][3] = ld32(p1 + 8);
  }

  float o[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;
  const int row0 = q0 + r0, row1 = row0 + 8;

  int lo, hi;
  tile_range(a, q0, lo, hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
    load_tile_bf16<HD>(k_s, kp + k0 * a.k_ss, a.k_ss, a.S - k0, a.vec);
    load_tile_bf16<HD>(v_s, vp + k0 * a.v_ss, a.v_ss, a.S - k0, a.vec);
    __syncthreads();

    // scores: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kr = k_s + (nt * 8 + g) * LD + kc * 16 + t4 * 2;
        mma_bf16(s[nt], qf[kc], ld32(kr), ld32(kr + 8));
      }
    }

    // online softmax; rows row0 (c0, c1) and row1 (c2, c3), each shared by
    // the 4 lanes of a quad
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        const float x = mask_score(a, s[nt][e] * a.scale, e < 2 ? row0 : row1, col);
        s[nt][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float c0 = expf(m0 - mx0), c1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - (e < 2 ? m0 : m1));
        s[nt][e] = p;
        if (e < 2) sum0 += p; else sum1 += p;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      o[nt][0] *= c0; o[nt][1] *= c0;
      o[nt][2] *= c1; o[nt][3] *= c1;
    }

    // o += P V: the score fragments of n-tiles 2kc, 2kc+1 are the A
    // fragment of key chunk kc; V's B fragments pair rows 2*t4, 2*t4+1
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc) {
      const uint32_t pa[4] = {pack_f32(s[2 * kc][0], s[2 * kc][1]),
                              pack_f32(s[2 * kc][2], s[2 * kc][3]),
                              pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const __nv_bfloat16* v0 = v_s + (kc * 16 + t4 * 2) * LD + g;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        const __nv_bfloat16* vr = v0 + nt * 8;
        mma_bf16(o[nt], pa, pack_raw(vr[0], vr[LD]),
                 pack_raw(vr[8 * LD], vr[9 * LD]));
      }
    }
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    const int col = nt * 8 + t4 * 2;
    if (row0 < a.S)
      *reinterpret_cast<__nv_bfloat162*>(
          out + (((int64_t)b * a.S + row0) * a.H + h) * HD + col) =
          __floats2bfloat162_rn(o[nt][0] / d0, o[nt][1] / d0);
    if (row1 < a.S)
      *reinterpret_cast<__nv_bfloat162*>(
          out + (((int64_t)b * a.S + row1) * a.H + h) * HD + col) =
          __floats2bfloat162_rn(o[nt][2] / d1, o[nt][3] / d1);
  }
}

// ---------------------------------------------------------------------------
// f32: plain FMAs (no TF32)
// ---------------------------------------------------------------------------

// 64 rows of hd floats into shared memory with row stride ld; rows at and
// past `rows` are zero.
template <int HD>
__device__ __forceinline__ void load_tile_f32(float* dst, int ld,
                                              const float* src,
                                              int64_t row_stride, int rows,
                                              int vec) {
  if (vec) {
    constexpr int kChunks = HD / 4;
    for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows) val = *reinterpret_cast<const float4*>(src + r * row_stride + c);
      float* d = dst + r * ld + c;
      d[0] = val.x; d[1] = val.y; d[2] = val.z; d[3] = val.w;
    }
  } else {
    for (int i = threadIdx.x; i < kBlockK * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      dst[r * ld + c] = r < rows ? src[r * row_stride + c] : 0.f;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(Args a) {
  constexpr int LQ = HD + 1;   // padded: conflict-free row-wise reads
  constexpr int LP = kBlockK + 1;
  constexpr int NO = HD / 8;   // output columns per thread
  extern __shared__ float smem_f[];
  float* q_s = smem_f;              // 64 x LQ
  float* k_s = q_s + kBlockQ * LQ;  // 64 x LQ
  float* v_s = k_s + kBlockK * LQ;  // 64 x HD
  float* p_s = v_s + kBlockK * HD;  // 64 x LP

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.K);
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;  // 8 x 16

  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + kh * a.v_sh;
  load_tile_f32<HD>(q_s, LQ, qp + q0 * a.q_ss, a.q_ss, a.S - q0, a.vec);

  // thread owns rows ty*4+i (i < 4), score columns tx+8j (j < 8) and output
  // columns tx+8j (j < HD/8)
  float o[4][NO], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j) o[i][j] = 0.f;
  }

  int lo, hi;
  tile_range(a, q0, lo, hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    load_tile_f32<HD>(k_s, LQ, kp + k0 * a.k_ss, a.k_ss, a.S - k0, a.vec);
    load_tile_f32<HD>(v_s, HD, vp + k0 * a.v_ss, a.v_ss, a.S - k0, a.vec);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * LQ + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = k_s[(tx + 8 * j) * LQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = mask_score(a, s[i][j] * a.scale, row, k0 + tx + 8 * j);
        mx = fmaxf(mx, s[i][j]);
      }
      // the 8 lanes of a row are lanes tx = 0..7 of one octet
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float corr = expf(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - mx);
        p_s[(ty * 4 + i) * LP + tx + 8 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int j = 0; j < NO; ++j) o[i][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < kBlockK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * LP + c];
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const float vv = v_s[c * HD + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][j] = fmaf(pv[i], vv, o[i][j]);
      }
    }
  }

  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = out + (((int64_t)b * a.S + row) * a.H + h) * HD;
#pragma unroll
    for (int j = 0; j < NO; ++j) orow[tx + 8 * j] = o[i][j] / den;
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, dim3 grid, cudaStream_t stream,
           const Args& a) {
  // above 48 KB a block gets its shared memory only after this opt-in
  // (a per-device attribute, so it is set on every launch)
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(int dtype, dim3 grid, cudaStream_t stream, const Args& a) {
  if (dtype == 0) {
    const size_t smem =
        sizeof(float) * ((kBlockQ + kBlockK) * (HD + 1) + kBlockK * HD +
                         kBlockQ * (kBlockK + 1));
    return launch(flash_f32_kernel<HD>, smem, grid, stream, a);
  }
  if (dtype == 1) {
    const size_t smem =
        sizeof(__nv_bfloat16) * (kBlockQ + 2 * kBlockK) * (HD + 8);
    return launch(flash_bf16_kernel<HD>, smem, grid, stream, a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. causal: 0/1. window <= 0: none.
// vec: 1 when every row start of q, k and v is 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* out, int B,
    int S, int H, int K, int hd, int causal, int window, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale, int vec,
    void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.S = S; a.H = H; a.K = K; a.causal = causal; a.window = window;
  a.vec = vec;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.scale = scale;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_hd<32>(dtype, grid, s, a);
    case 64: return launch_hd<64>(dtype, grid, s, a);
    case 128: return launch_hd<128>(dtype, grid, s, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
