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
// GFLOP of causal products: ~3-10 us of bytes against ~1-4 us of bf16
// tensor-core operations, so the bytes bound it and the tiles sit close to
// the ridge; a long prompt (S = 4096) is bound by the operations, and so
// is whisper-small's encoder (hd 64, R = 4, S = 1500, non-causal: 28.0 us
// of products); phi-3-vision's prompt (hd 96, R = 4, S = 640) by the bytes
// (18.8 us); recurrentgemma's windowed prompt (hd 256, 16/1, R = 1, S =
// 3000, window 2048: 67.1 us) and nemotron-4's (hd 192, 96/8, R = 1, S =
// 4096: 625.5 us) by the operations. At hd 64 a second bound sits beside the products': one exp2
// a score on the special-function units, 16 a clock an SM, is 25.8 us at
// the encoder's shape and the card's top clock. One warpgroup a block runs
// a tile's q.K^T, softmax and PV in series, so neither bound is reached:
// the blocks an SM overlap only each other's chains (PERF.md).
//
// Grid: one block of 4 warps per (query head, batch row, 64-row query
// tile), each warp 16 query rows (the warp-specialised kernel: 8 warps a
// 128-row tile, its section below). The query tile is the slowest grid
// dimension and counts from the last tile, so the blocks of the heaviest
// tiles (those that walk the most key tiles under a causal mask) start
// first and the light ones fill the tail (longest job first); neighbouring
// blocks are the heads of one KV group, so a K/V tile that one of them
// brings into L2 serves the next. Key tiles wholly above the diagonal or
// wholly before the window are skipped.
//
// bf16, the two kernels that load by cp.async:
// * Loads. q and the K/V tiles reach shared memory by 16-byte cp.async.cg
//   (no registers, no waiting at the issue); rows past S are zero-filled by
//   a source size of 0, so 0 x garbage never reaches the PV sum. K and V
//   tiles share a ring of three tile slots, in the order K0 V0 K1 V1 ...:
//   K_{j+1} is issued with tile j's q.K^T, V_{j+1} with its PV product, and
//   K_j is waited for apart from V_j, so q.K^T overlaps V_j's arrival. Two
//   block barriers a tile. Without 16-byte aligned rows (the wrapper's
//   `vec`) the same slots are filled element by element.
// * The scores stay in registers; the probabilities, rounded to bf16, are
//   the A fragments of the PV product straight from the score fragments
//   (f32 accumulation). l sums the unrounded f32 probabilities per lane and
//   reduces once at the end.
// * The softmax runs in base 2: scores are scaled by hd^-0.5 * log2(e), and
//   the masked value and the running max's start are -1e30 * log2(e), the
//   same -1e30 in that domain, so the rescale of a wholly masked leading
//   tile is unchanged. Only the tiles that need a mask compute one (per
//   warp: the diagonal tile, a window edge, the ragged last tile).
// * The output is staged through the warp's own rows of the q buffer and
//   written with 16-byte coalesced stores.
// * hd 64, 96 and 128 (whisper-small, phi-3-vision, the serving models),
//   flash_bf16_wgmma_kernel<HD>: one warpgroup runs q.K^T as wgmma with q
//   and K in shared memory, and PV as wgmma with P in registers and V read
//   transposed from shared memory; tiles are kept in wgmma's
//   128-byte-swizzle layout (conflict-free for the copies and the output
//   staging). hd 128: two atoms a tile, 168 registers, 66,560 bytes of
//   shared memory, 3 blocks an SM. hd 64: one atom a tile (a 128-byte
//   row), a 32-register accumulator, 125 registers and 33,792 bytes: 4
//   blocks an SM (asking for 5 caps the kernel at 96 registers and
//   spills). hd 96: a 192-byte row is 1.5 atoms, so the tile takes the
//   hd-128 layout with columns 96-127 written as zeros (cp.async with a
//   source size of 0: no bytes read); q.K^T steps over the 6 real chunks
//   only, PV runs N = 128 and its 32 extra output columns are never
//   stored: the HBM bytes are hd 96's, the PV products a third more (the
//   reference pads every head dim to 128, src/repro/kernels/ops.py:86-94);
//   168 registers, 3 blocks an SM. The same design on mma.sync with
//   ldmatrix fragments (below) was ~1.4x slower at hd 128 on an H100 and
//   1.14x / 1.25x slower at hd 96 / 64: every warp read the whole K and V
//   tile from shared memory for its 16 rows, and those reads, not the
//   products or the exponentials, set its pace.
// * hd 32, which only the reduced configs have (no model of the zoo runs
//   it at full width), flash_bf16_kernel: mma.sync m16n8k16, fragments by
//   ldmatrix.x4 (.trans for V) from rows padded to hd + 8 elements (the 8
//   row addresses of each 8x8 matrix fall on 8 disjoint groups of 4
//   banks), 3 blocks an SM.
// * hd 192 and 256 (nemotron-4, recurrentgemma), flash_bf16_ws_kernel (its
//   section below): two consumer warpgroups over a TMA-fed K/V ring, taking
//   turns at the tensor cores. Any GQA group: a block reads the KV head of
//   its query head.
// flash_attention_tiled_plain (same Python module) is this tile loop in
// PyTorch (at the warp-specialised kernel's 128-row query tiles: tiles() in
// the module), and the tests hold every bf16 kernel to it.
//
// f32 (tests and reduced f32 engines) must not use TF32, so it multiplies
// with plain FMAs over shared-memory tiles (each thread 4 rows x 8 keys of
// scores, 4 rows x hd/8 columns of output), in the natural exp domain; at
// hd 256 its tiles take 213,760 bytes of shared memory, under the 227 KB a
// block may have.
//
// Rows are addressed by strides, so a q view from rope goes in without a
// copy. The shared-memory opt-in is made once per kernel and device, so a
// launch can be captured in a CUDA graph.

#include <cuda.h>  // CUtensorMap and its enums; the driver call is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBlockQ = 64;    // query rows per block
constexpr int kBlockK = 64;    // key rows per tile
constexpr int kSlots = 3;      // K/V tile slots of the bf16 ring
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked2 = kMasked * kLog2e;  // kMasked in the base-2 domain

struct Args {
  const void* q;  // (B, S, H, hd), strided, unit stride on hd
  const void* k;  // (B, S, K, hd), strided
  const void* v;
  void* out;      // (B, S, H, hd) contiguous
  int S, H, K, causal, window, vec;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;  // elements
  float scale;
};

// Grid (H, B, n_q): the query tile counts from the last, so the heaviest
// blocks start first.
__device__ __forceinline__ void block_coords(int& q0, int& h, int& b) {
  h = blockIdx.x;
  b = blockIdx.y;
  q0 = (gridDim.z - 1 - blockIdx.z) * kBlockQ;
}

// The key tiles [lo, hi] that the query tile of rows q0 .. q0 + block_q - 1
// reads: tiles wholly above the diagonal (causal) or wholly before the
// window are skipped.
__device__ __forceinline__ void tile_range(const Args& a, int q0, int& lo,
                                           int& hi, int block_q = kBlockQ) {
  const int n_k = (a.S + kBlockK - 1) / kBlockK;
  const int q_last = min(q0 + block_q, a.S) - 1;
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
// bf16: cp.async ring, ldmatrix, mma.sync m16n8k16 with f32 accumulation
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes = 0 writes 16 zero bytes and reads none
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group of this thread but the newest N has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// Stage 64 rows of hd bf16 into shared memory (row stride HD + 8); rows at
// and past `rows` are zero. vec: asynchronous 16-byte copies (the caller
// commits and waits); otherwise element copies, done on return.
template <int HD>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int64_t row_stride, int rows,
                                           int vec) {
  constexpr int LD = HD + 8;
  if (vec) {
    constexpr int kChunks = HD / 8;  // 16-byte chunks per row
    // the thread index through an empty asm: each call recomputes the
    // copies' offsets, which the compiler would otherwise hoist out of the
    // tile loop and hold (2 x 16 of 64 bits at hd 256, past 255 registers)
    unsigned tid = threadIdx.x;
    asm volatile("" : "+r"(tid));
#pragma unroll
    for (int it = 0; it < kBlockK * kChunks / kThreads; ++it) {
      const unsigned i = it * kThreads + tid;
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool in = r < rows;
      cp_async16(smem_addr(dst + r * LD + c),
                 src + (in ? r * row_stride + c : 0), in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBlockK * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      dst[r * LD + c] = r < rows ? src[r * row_stride + c]
                                 : __float2bfloat16(0.f);
    }
  }
}

// 2^x: exp2f, or the bare ex2.approx.ftz (2 ulp; results below 2^-126
// flush to 0, weights at most 2^-126 of the row's largest) without exp2f's
// range handling. Only flash_bf16_ws_kernel takes the approximation; the
// other kernels and flash_attention_tiled_plain compute exp2 exactly
template <bool kFast>
__device__ __forceinline__ float exp2_of(float x) {
  if constexpr (kFast) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
  } else {
    return exp2f(x);
  }
}

// One tile's online softmax in base 2 for a warp's 16 rows: rows row0 (c0,
// c1) and row0 + 8 (c2, c3) of the score fragments, each shared by the 4
// lanes of a quad. Masks only when the tile needs it (diagonal, window
// edge, ragged last tile), updates the running max m and the lane's partial
// sum l, turns s into probabilities and returns in r0, r1 the factors
// 2^(m - m') by which the output rows are to be rescaled.
template <bool kFastExp = false>
__device__ __forceinline__ void softmax_probs(const Args& a, float (&s)[8][4],
                                              int k0, int w_lo, int row0,
                                              int t4, float scale2, float& m0,
                                              float& m1, float& l0, float& l1,
                                              float& r0, float& r1) {
  const int w_hi = w_lo + 15, row1 = row0 + 8;
  float mx0 = m0, mx1 = m1;
  const bool need_mask = (a.causal && k0 + kBlockK - 1 > w_lo) ||
                         (a.window > 0 && w_hi - k0 >= a.window) ||
                         k0 + kBlockK > a.S;
  if (need_mask) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1;
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        float x = s[nt][e] * scale2;
        if (col >= a.S)
          x = -INFINITY;  // past S: excluded outright
        else if ((a.causal && col > row) ||
                 (a.window > 0 && row - col >= a.window))
          x = kMasked2;
        s[nt][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[nt][e] * scale2;
        s[nt][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float c0 = exp2_of<kFastExp>(m0 - mx0);
  const float c1 = exp2_of<kFastExp>(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_of<kFastExp>(s[nt][e] - (e < 2 ? m0 : m1));
      s[nt][e] = p;
      if (e < 2) sum0 += p; else sum1 += p;
    }
  }
  l0 = l0 * c0 + sum0;
  l1 = l1 * c1 + sum1;
  r0 = c0;
  r1 = c1;
}

// o's rows row0 (c0, c1) and row0 + 8 (c2, c3) times r0 and r1
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N][4], float r0, float r1) {
#pragma unroll
  for (int nt = 0; nt < N; ++nt) {
    o[nt][0] *= r0; o[nt][1] *= r0;
    o[nt][2] *= r1; o[nt][3] *= r1;
  }
}

// softmax_probs, then o rescaled: one tile's softmax where no product owns o
template <int HD>
__device__ __forceinline__ void softmax_tile(const Args& a, float (&s)[8][4],
                                             float (&o)[HD / 8][4], int k0,
                                             int w_lo, int row0, int t4,
                                             float scale2, float& m0,
                                             float& m1, float& l0,
                                             float& l1) {
  float r0, r1;
  softmax_probs(a, s, k0, w_lo, row0, t4, scale2, m0, m1, l0, l1, r0, r1);
  rescale(o, r0, r1);
}

template <int HD>
constexpr size_t smem_bf16() {
  return sizeof(__nv_bfloat16) * (kBlockQ + kSlots * kBlockK) * (HD + 8);
}

// hd 32 only (kHasMma): 3 blocks an SM
template <int HD>
__global__ void __launch_bounds__(kThreads, 3) flash_bf16_kernel(Args a) {
  constexpr int LD = HD + 8;          // +16 bytes: conflict-free ldmatrix
  constexpr int kTile = kBlockK * LD;  // elements of one staged tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = q_s + kBlockQ * LD;  // kSlots tiles

  int q0, h, b;
  block_coords(q0, h, b);
  const int kh = h / (a.H / a.K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const __nv_bfloat16* qp =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const __nv_bfloat16* vp =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + kh * a.v_sh;

  int lo, hi;
  tile_range(a, q0, lo, hi);

  // prologue: q with the first K tile (one group), the first V tile (the
  // next); slots: K_j in ks, V_j in vs, the third is free
  int ks = 0, vs = 1, fs = 2;
  stage_tile<HD>(q_s, qp + q0 * a.q_ss, a.q_ss, a.S - q0, a.vec);
  stage_tile<HD>(ring, kp + lo * kBlockK * a.k_ss, a.k_ss,
                 a.S - lo * kBlockK, a.vec);
  cp_async_commit();
  stage_tile<HD>(ring + kTile, vp + lo * kBlockK * a.v_ss, a.v_ss,
                 a.S - lo * kBlockK, a.vec);
  cp_async_commit();

  // ldmatrix row addresses of this lane (bytes): q rows of the warp (A,
  // 16x16 per x4), K rows as n (B of q.K^T, two n-tiles x 16 of depth), V
  // rows as depth (B of PV by .trans, 16 keys x two n-tiles of 8 dims)
  const uint32_t q_lane =
      smem_addr(q_s + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  const uint32_t k_lane = 2 * (((lane & 7) + (lane >> 4) * 8) * LD +
                               ((lane >> 3) & 1) * 8);
  const uint32_t v_lane = 2 * (((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                               (lane >> 4) * 8);
  const uint32_t ring_addr = smem_addr(ring);

  float o[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m0 = kMasked2, m1 = kMasked2, l0 = 0.f, l1 = 0.f;  // l: lane partial
  const float scale2 = a.scale * kLog2e;
  const int w_lo = q0 + warp * 16, row0 = w_lo + g;  // the warp's rows

  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kBlockK;
    cp_async_wait<1>();  // K_j (and q) landed for this thread; V_j may not
    __syncthreads();     // ... for every thread; every warp is done with V_{j-1}
    if (kt < hi)
      stage_tile<HD>(ring + fs * kTile, kp + (k0 + kBlockK) * a.k_ss, a.k_ss,
                     a.S - k0 - kBlockK, a.vec);
    cp_async_commit();

    // scores: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys; q's
    // fragments are re-read per tile
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const uint32_t k_addr = ring_addr + ks * kTile * 2 + k_lane;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      uint32_t qa[4];
      ldmatrix_x4(qa, q_lane + kc * 32);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, k_addr + (np * 16 * LD + kc * 16) * 2);
        mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }

    softmax_tile<HD>(a, s, o, k0, w_lo, row0, t4, scale2, m0, m1, l0, l1);

    cp_async_wait<1>();  // V_j landed for this thread; K_{j+1} may not
    __syncthreads();     // ... for every thread; every warp is done with K_j
    if (kt < hi)
      stage_tile<HD>(ring + ks * kTile, vp + (k0 + kBlockK) * a.v_ss, a.v_ss,
                     a.S - k0 - kBlockK, a.vec);
    cp_async_commit();

    // o += P V: the probabilities of n-tiles 2kc, 2kc+1, rounded to bf16,
    // are the A fragment of key chunk kc
    const uint32_t v_addr = ring_addr + vs * kTile * 2 + v_lane;
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc) {
      const uint32_t pa[4] = {pack_f32(s[2 * kc][0], s[2 * kc][1]),
                              pack_f32(s[2 * kc][2], s[2 * kc][3]),
                              pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, v_addr + (kc * 16 * LD + dp * 16) * 2);
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    // K_{j+1} is in fs, V_{j+1} in ks; V_j's slot is free after the barrier
    const int f = fs;
    fs = vs;
    vs = ks;
    ks = f;
  }
  cp_async_wait<0>();  // only empty groups remain

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);

  // stage the warp's 16 output rows in its own rows of q_s (no other warp
  // reads them), then write them with 16-byte stores
  __nv_bfloat16* os = q_s + warp * 16 * LD;
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    const int col = nt * 8 + t4 * 2;
    *reinterpret_cast<__nv_bfloat162*>(os + g * LD + col) =
        __floats2bfloat162_rn(o[nt][0] / d0, o[nt][1] / d0);
    *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * LD + col) =
        __floats2bfloat162_rn(o[nt][2] / d1, o[nt][3] / d1);
  }
  __syncwarp();
  constexpr int kChunks = HD / 8;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) +
                       ((int64_t)b * a.S * a.H + h) * HD;
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int i = it * 32 + lane, r = i / kChunks, c = (i % kChunks) * 8;
    if (w_lo + r < a.S)
      *reinterpret_cast<uint4*>(out + (int64_t)(w_lo + r) * a.H * HD + c) =
          *reinterpret_cast<const uint4*>(os + r * LD + c);
  }
}

// ---------------------------------------------------------------------------
// bf16, hd 64, 96 and 128: wgmma
// ---------------------------------------------------------------------------

constexpr int kAtom = 64 * 128;  // bytes of a swizzle atom: 64 rows x 128 B

// Byte offset of 16-byte chunk c (0..15) of row r (0..63) of a 64 x 64 or
// 64 x 128 bf16 tile kept as wgmma's canonical 128-byte-swizzle layout:
// columns 0-63 in atom 0, 64-127 in atom 1, each row 128 B, chunk c of an
// atom at chunk c ^ (r % 8). The 8 rows of a 1024-byte group cover all 32
// banks for any chunk, so a quarter-warp's 16-byte accesses never conflict.
__device__ __forceinline__ int sw128(int r, int c) {
  return (c >> 3) * kAtom + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Columns of the staged wgmma tile: one 128-byte atom at hd 64, two at hd 96
// and 128 (hd 96 takes the hd-128 layout, columns 96-127 zero).
template <int HD>
struct WgmmaTile {
  static constexpr int kCols = HD <= 64 ? 64 : 128;
  static constexpr int kBytes = 64 * kCols * 2;  // 64 rows
};

// 64 rows of HD bf16 into the swizzled layout of WgmmaTile<HD>; rows at and
// past `rows`, and columns HD to kCols - 1, are zero. vec: 16-byte cp.async
// (the caller commits and waits); a source size of 0 writes the zeros.
template <int HD>
__device__ __forceinline__ void stage_sw128(unsigned char* dst,
                                            const __nv_bfloat16* src,
                                            int64_t row_stride, int rows,
                                            int vec) {
  constexpr int kChunks = WgmmaTile<HD>::kCols / 8;  // 16-byte chunks a row
  if (vec) {
#pragma unroll
    for (int it = 0; it < 64 * kChunks / kThreads; ++it) {
      const unsigned i = it * kThreads + threadIdx.x;
      const int r = i / kChunks, c = i % kChunks;
      const bool in = r < rows && c < HD / 8;
      cp_async16(smem_addr(dst + sw128(r, c)),
                 src + (in ? r * row_stride + c * 8 : 0), in ? 16 : 0);
    }
  } else {
    for (unsigned i = threadIdx.x; i < 64 * kChunks * 8; i += kThreads) {
      const int r = i / (kChunks * 8), col = i % (kChunks * 8);
      reinterpret_cast<__nv_bfloat16*>(dst + sw128(r, col >> 3))[col & 7] =
          r < rows && col < HD ? src[r * row_stride + col]
                               : __float2bfloat16(0.f);
    }
  }
}

// wgmma shared-memory matrix descriptor with 128-byte swizzle. K-major
// operands (q, K): sbo = 1024 (8-row groups), lbo unused. MN-major (V, read
// transposed): lbo = the stride between 64-column atoms, sbo = 1024.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// cp.async writes are generic-proxy writes; wgmma reads through the async
// proxy, which sees them only after this fence
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keep the compiler from touching accumulators while a wgmma owns them
template <int N>
__device__ __forceinline__ void pin(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// d (64 x 64 f32, warp w rows 16w.., mma.sync's C layout per warp) {=, +=}
// A (smem) x B (smem)
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[8][4], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64 f32) += A (registers, mma.sync's A layout per warp) x B (smem,
// MN-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[8][4], uint32_t const (&a)[4], uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128 f32) += A (registers, mma.sync's A layout per warp) x B (smem,
// MN-major)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[16][4], uint32_t const (&a)[4], uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// One warpgroup per (query head, batch row, 64-row query tile). q and the
// K/V ring live in the swizzled layout; q.K^T is HD/16 wgmma m64n64k16 with
// both operands in shared memory, PV 4 wgmma m64nNk16 (N = 64 at hd 64, 128
// at hd 96 and 128) with P from registers and V read transposed from shared
// memory. The tensor cores read each K/V fragment once for the 64 rows,
// where ldmatrix has every warp read the whole tile. The softmax, masks and
// output staging are those of the mma.sync kernel (same accumulator layout
// per warp). At hd 96 the q.K^T steps over the zero columns are skipped;
// PV's 32 extra output columns are computed and never stored.
template <int HD>
constexpr size_t smem_wgmma() {
  return 1024 + (1 + kSlots) * WgmmaTile<HD>::kBytes;  // + alignment
}

// resident blocks an SM that flash_bf16_wgmma_kernel's launch bounds ask
// for: the hd-64 tile's accumulator is 32 registers a thread, not 64
template <int HD>
struct WgmmaOccupancy {
  static constexpr int kBlocks = HD <= 64 ? 4 : 3;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, WgmmaOccupancy<HD>::kBlocks)
    flash_bf16_wgmma_kernel(Args a) {
  constexpr int kCols = WgmmaTile<HD>::kCols, kTileB = WgmmaTile<HD>::kBytes;
  static_assert(HD == 64 || HD == 96 || HD == 128, "wgmma head dims");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* q_s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = q_s + kTileB;  // kSlots tiles

  int q0, h, b;
  block_coords(q0, h, b);
  const int kh = h / (a.H / a.K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const __nv_bfloat16* qp =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const __nv_bfloat16* vp =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + kh * a.v_sh;

  int lo, hi;
  tile_range(a, q0, lo, hi);

  // prologue: q with the first K tile (one group), the first V tile (the
  // next); slots: K_j in ks, V_j in vs, the third is free
  int ks = 0, vs = 1, fs = 2;
  stage_sw128<HD>(q_s, qp + q0 * a.q_ss, a.q_ss, a.S - q0, a.vec);
  stage_sw128<HD>(ring, kp + lo * kBlockK * a.k_ss, a.k_ss,
                  a.S - lo * kBlockK, a.vec);
  cp_async_commit();
  stage_sw128<HD>(ring + kTileB, vp + lo * kBlockK * a.v_ss, a.v_ss,
                  a.S - lo * kBlockK, a.vec);
  cp_async_commit();
  const uint32_t q_addr = smem_addr(q_s), ring_addr = smem_addr(ring);

  float o[kCols / 8][4];
#pragma unroll
  for (int nt = 0; nt < kCols / 8; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m0 = kMasked2, m1 = kMasked2, l0 = 0.f, l1 = 0.f;  // l: lane partial
  const float scale2 = a.scale * kLog2e;
  const int w_lo = q0 + warp * 16, row0 = w_lo + g;  // the warp's rows

  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kBlockK;
    cp_async_wait<1>();  // K_j (and q) landed for this thread; V_j may not
    fence_proxy_async();
    __syncthreads();     // ... for every thread; every warp is done with V_{j-1}

    // scores: the warpgroup's 64 rows x 64 keys, HD/16 depth steps of 16;
    // the next K tile's copies are issued while the tensor cores run
    float s[8][4];
    const uint32_t k_addr = ring_addr + ks * kTileB;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      const uint32_t off = (kc >> 2) * kAtom + (kc & 3) * 32;
      wgmma_m64n64k16_ss(s, sw128_desc(q_addr + off, 16, 1024),
                         sw128_desc(k_addr + off, 16, 1024), kc);
    }
    wgmma_commit();
    if (kt < hi)
      stage_sw128<HD>(ring + fs * kTileB, kp + (k0 + kBlockK) * a.k_ss,
                      a.k_ss, a.S - k0 - kBlockK, a.vec);
    cp_async_commit();
    wgmma_wait_all();
    pin(s);

    softmax_tile<kCols>(a, s, o, k0, w_lo, row0, t4, scale2, m0, m1, l0, l1);

    cp_async_wait<1>();  // V_j landed for this thread; K_{j+1} may not
    fence_proxy_async();
    __syncthreads();     // ... for every thread; every warp is done with K_j

    // o += P V: the probabilities of n-tiles 2kc, 2kc+1, rounded to bf16,
    // are the A fragment of key chunk kc (registers a wgmma reads stay
    // untouched until it completes); the next V tile's copies are issued
    // while the tensor cores run
    const uint32_t v_addr = ring_addr + vs * kTileB;
    uint32_t pa[4][4];
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc) {
      pa[kc][0] = pack_f32(s[2 * kc][0], s[2 * kc][1]);
      pa[kc][1] = pack_f32(s[2 * kc][2], s[2 * kc][3]);
      pa[kc][2] = pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[kc][3] = pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3]);
    }
    pin(o);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc) {
      const uint64_t desc = sw128_desc(v_addr + kc * 16 * 128, kAtom, 1024);
      if constexpr (kCols == 64)
        wgmma_m64n64k16_rs(o, pa[kc], desc, 1);
      else
        wgmma_m64n128k16_rs(o, pa[kc], desc, 1);
    }
    wgmma_commit();
    if (kt < hi)
      stage_sw128<HD>(ring + ks * kTileB, vp + (k0 + kBlockK) * a.v_ss,
                      a.v_ss, a.S - k0 - kBlockK, a.vec);
    cp_async_commit();
    wgmma_wait_all();
    pin(o);
    // K_{j+1} is in fs, V_{j+1} in ks; V_j's slot is free after the barrier
    const int f = fs;
    fs = vs;
    vs = ks;
    ks = f;
  }
  cp_async_wait<0>();  // only empty groups remain

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);

  // stage the warp's 16 output rows (the HD real columns) in its own rows
  // of q_s (swizzled as q), then write them with 16-byte stores
  __syncthreads();  // every warp's products are done with q_s
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    *reinterpret_cast<__nv_bfloat162*>(q_s + sw128(r0, nt) + t4 * 4) =
        __floats2bfloat162_rn(o[nt][0] / d0, o[nt][1] / d0);
    *reinterpret_cast<__nv_bfloat162*>(q_s + sw128(r0 + 8, nt) + t4 * 4) =
        __floats2bfloat162_rn(o[nt][2] / d1, o[nt][3] / d1);
  }
  __syncwarp();
  constexpr int kChunks = HD / 8;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) +
                       ((int64_t)b * a.S * a.H + h) * HD;
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const unsigned i = it * 32 + lane;
    const int r = i / kChunks, c = i % kChunks;
    if (w_lo + r < a.S)
      *reinterpret_cast<uint4*>(out + (int64_t)(w_lo + r) * a.H * HD + c * 8) =
          *reinterpret_cast<const uint4*>(q_s + sw128(warp * 16 + r, c));
  }
}

// ---------------------------------------------------------------------------
// bf16, hd 192 and 256 (and hd 128, off the route, for timing): warp-
// specialised, TMA
// ---------------------------------------------------------------------------
//
// The same Pallas kernel at the zoo's widest head dims, bound by the
// operations (recurrentgemma's windowed prompt 67.1 us, nemotron-4's S =
// 4096 625.5 us). FA3's structure: a block takes a 128-row query tile and
// runs two consumer warpgroups of 64 rows over every K/V tile, which TMA
// copies into rings of swizzled tiles; the consumers issue their products
// in turns on named barriers, so one's softmax runs under the other's
// products, and within a consumer tile j's q.K^T is in flight with tile
// j-1's PV.

// d (64 x 192 f32) += A (registers, mma.sync's A layout per warp) x B (smem,
// MN-major)
__device__ __forceinline__ void wgmma_m64n192k16_rs(float (&d)[24][4], uint32_t const (&a)[4], uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (64 x 256 f32) += A (registers, mma.sync's A layout per warp) x B (smem,
// MN-major)
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[32][4], uint32_t const (&a)[4], uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void pin_u(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// arrive on a barrier and add `bytes` to the transactions its phase awaits
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
      "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A wait that lasts
// ~2^34 clocks (seconds) can only be a fault in the pipeline: it traps, so
// the launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// 4-d tile (hd, head, row, batch) of a tensor map into shared memory,
// completing `bar`'s transactions; out-of-range rows arrive as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// named barriers (id 0 is __syncthreads'): 1 and 2 order the two consumers'
// products, 3 and 4 are a consumer's own
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

constexpr int kWsThreads = 256;  // two consumer warpgroups
constexpr int kWsBlockQ = 128;   // query rows a block: 64 a consumer

// q (2 consumer tiles), then a ring of K tiles and one of V tiles, each tile
// HD/64 swizzle atoms of 64 rows; then the mbarriers. Three V slots (and
// three K slots where shared memory allows: not at hd 256, whose 2 + 3
// slots and q take 224 KB) let the issue run ahead of the products
// without ever waiting on the other consumer (ws_issue).
template <int HD>
struct WsSmem {
  static constexpr int kTileB = 64 * HD * 2;
  static constexpr int kKSlots = HD == 256 ? 2 : 3, kVSlots = 3;
  static constexpr int kQ = 0, kK = 2 * kTileB;
  static constexpr int kV = kK + kKSlots * kTileB;
  static constexpr int kBars = kV + kVSlots * kTileB;
  // mbarriers: q full; K full, V full, K empty, V empty by slot
  static constexpr int kNumBars = 1 + 2 * (kKSlots + kVSlots);
  static constexpr size_t kBytes = 1024 + kBars + 8 * kNumBars;  // + align
  __device__ static uint32_t full_k(uint32_t bars, int t) {
    return bars + 8 * (1 + t % kKSlots);
  }
  __device__ static uint32_t full_v(uint32_t bars, int t) {
    return bars + 8 * (1 + kKSlots + t % kVSlots);
  }
  __device__ static uint32_t empty_k(uint32_t bars, int t) {
    return bars + 8 * (1 + kKSlots + kVSlots + t % kKSlots);
  }
  __device__ static uint32_t empty_v(uint32_t bars, int t) {
    return bars + 8 * (1 + 2 * kKSlots + kVSlots + t % kVSlots);
  }
  // the phase parity in which the slot of tile t is filled (full) and in
  // which the producer waits for it to have been released (empty)
  __device__ static uint32_t k_parity(int t) { return (t / kKSlots) & 1; }
  __device__ static uint32_t v_parity(int t) { return (t / kVSlots) & 1; }
};

// 64 rows of HD bf16 into the swizzled atoms of a WsSmem tile by element
// copies (rows at and past `rows` zero) by consumer 0's 128 threads: the
// route for views whose rows or strides TMA cannot address (not 16-byte
// aligned).
template <int HD>
__device__ __forceinline__ void ws_copy_tile(unsigned char* dst,
                                             const __nv_bfloat16* src,
                                             int64_t row_stride, int rows,
                                             unsigned ct) {
  for (unsigned i = ct; i < 64 * HD; i += 128) {
    const int r = i / HD, col = i % HD;
    reinterpret_cast<__nv_bfloat16*>(dst + sw128(r, col >> 3))[col & 7] =
        r < rows ? src[r * row_stride + col] : __float2bfloat16(0.f);
  }
}

// What the producer needs: the tensor maps, the block's coordinates and
// the next K and V tiles to issue.
struct WsLoads {
  const CUtensorMap *tq, *tk, *tv;
  int h, kh, b, q0, lo, n;
  int next_k, next_v;
};

// Consumer 0's producer duty: issue K tiles up to k_upto and V tiles up to
// v_upto (tile indices from the block's first, clamped to its last), each
// into its slot once both consumers have released that slot's previous
// tile. With TMA (a.vec) thread 0 issues the copies, each 64 x 64 box one
// swizzle atom, completing the slot's full barrier by bytes; without, the
// 128 threads copy elements, fence (the copies are generic-proxy writes
// that wgmma reads through the async proxy), meet on named barrier 3, and
// thread 0 arrives. q (both consumers' tiles) goes first, on barrier 0.
template <int HD>
__device__ __forceinline__ void ws_issue(const Args& a, WsLoads& ld,
                                         unsigned char* sm, uint32_t bars,
                                         unsigned ct, bool with_q, int k_upto,
                                         int v_upto) {
  using L = WsSmem<HD>;
  constexpr int kAtoms = HD / 64;
  const uint32_t base = smem_addr(sm);
  k_upto = min(k_upto, ld.n - 1);
  v_upto = min(v_upto, ld.n - 1);
  if (a.vec) {
    if (ct == 0) {
      if (with_q) {
        mbar_expect_tx(bars, 2 * L::kTileB);
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int at = 0; at < kAtoms; ++at)
            tma_load(base + L::kQ + c * L::kTileB + at * kAtom, ld.tq, bars,
                     at * 64, ld.h, ld.q0 + 64 * c, ld.b);
      }
      for (int t = ld.next_k; t <= k_upto; ++t) {
        const uint32_t full = L::full_k(bars, t);
        const uint32_t dst = base + L::kK + (t % L::kKSlots) * L::kTileB;
        mbar_wait(L::empty_k(bars, t), L::k_parity(t) ^ 1);
        mbar_expect_tx(full, L::kTileB);
#pragma unroll
        for (int at = 0; at < kAtoms; ++at)
          tma_load(dst + at * kAtom, ld.tk, full, at * 64, ld.kh,
                   (ld.lo + t) * kBlockK, ld.b);
      }
      for (int t = ld.next_v; t <= v_upto; ++t) {
        const uint32_t full = L::full_v(bars, t);
        const uint32_t dst = base + L::kV + (t % L::kVSlots) * L::kTileB;
        mbar_wait(L::empty_v(bars, t), L::v_parity(t) ^ 1);
        mbar_expect_tx(full, L::kTileB);
#pragma unroll
        for (int at = 0; at < kAtoms; ++at)
          tma_load(dst + at * kAtom, ld.tv, full, at * 64, ld.kh,
                   (ld.lo + t) * kBlockK, ld.b);
      }
    }
  } else {
    auto publish = [&](uint32_t bar) {
      fence_proxy_async();
      bar_sync(3, 128);
      if (ct == 0) mbar_arrive(bar);
    };
    if (with_q) {
      const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(a.q) +
                                ld.b * a.q_sb + ld.h * a.q_sh;
#pragma unroll 1
      for (int c = 0; c < 2; ++c)
        ws_copy_tile<HD>(sm + L::kQ + c * L::kTileB,
                         qp + (int64_t)(ld.q0 + 64 * c) * a.q_ss, a.q_ss,
                         a.S - ld.q0 - 64 * c, ct);
      publish(bars);
    }
    const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k) +
                              ld.b * a.k_sb + ld.kh * a.k_sh;
    const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v) +
                              ld.b * a.v_sb + ld.kh * a.v_sh;
#pragma unroll 1
    for (int t = ld.next_k; t <= k_upto; ++t) {
      const int k0 = (ld.lo + t) * kBlockK;
      mbar_wait(L::empty_k(bars, t), L::k_parity(t) ^ 1);
      ws_copy_tile<HD>(sm + L::kK + (t % L::kKSlots) * L::kTileB,
                       kp + (int64_t)k0 * a.k_ss, a.k_ss, a.S - k0, ct);
      publish(L::full_k(bars, t));
    }
#pragma unroll 1
    for (int t = ld.next_v; t <= v_upto; ++t) {
      const int k0 = (ld.lo + t) * kBlockK;
      mbar_wait(L::empty_v(bars, t), L::v_parity(t) ^ 1);
      ws_copy_tile<HD>(sm + L::kV + (t % L::kVSlots) * L::kTileB,
                       vp + (int64_t)k0 * a.v_ss, a.v_ss, a.S - k0, ct);
      publish(L::full_v(bars, t));
    }
  }
  ld.next_k = max(ld.next_k, k_upto + 1);
  ld.next_v = max(ld.next_v, v_upto + 1);
}

// A descriptor of `addr` whose address the compiler cannot see through: the
// descriptors of a tile are this one plus immediate offsets (the address
// field, bits 0-13 in 16-byte units, does not carry for shared memory
// below 256 KB), made where they are used rather than hoisted out of the
// key loop and held in registers.
__device__ __forceinline__ uint64_t opaque_desc(uint32_t addr, uint32_t lbo) {
  asm volatile("" : "+r"(addr));
  return sw128_desc(addr, lbo, 1024);
}

// s (64 x 64 f32) = q (64 x HD) K^T, HD/16 steps of 16, both in shared
// memory; issued and committed as one group
template <int HD>
__device__ __forceinline__ void ws_qk(float (&s)[8][4], uint32_t q_addr,
                                      uint32_t k_addr) {
  const uint64_t dq = opaque_desc(q_addr, 16), dk = opaque_desc(k_addr, 16);
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) {
    const uint32_t off = ((kc >> 2) * kAtom + (kc & 3) * 32) >> 4;
    wgmma_m64n64k16_ss(s, dq + off, dk + off, kc);
  }
  wgmma_commit();
}

// o (64 x HD f32) += P (64 x 64, bf16 in registers) V, V read transposed
// from shared memory; issued and committed as one group
template <int HD>
__device__ __forceinline__ void ws_pv(float (&o)[HD / 8][4],
                                      const uint32_t (&pa)[4][4],
                                      uint32_t v_addr) {
  const uint64_t dv = opaque_desc(v_addr, kAtom);
#pragma unroll
  for (int kc = 0; kc < kBlockK / 16; ++kc) {
    const uint64_t desc = dv + ((kc * 16 * 128) >> 4);
    if constexpr (HD == 128)
      wgmma_m64n128k16_rs(o, pa[kc], desc, 1);
    else if constexpr (HD == 192)
      wgmma_m64n192k16_rs(o, pa[kc], desc, 1);
    else
      wgmma_m64n256k16_rs(o, pa[kc], desc, 1);
  }
  wgmma_commit();
}

// the probabilities of n-tiles 2kc, 2kc+1, rounded to bf16: the A fragment
// of PV's key chunk kc
__device__ __forceinline__ void pack_p(uint32_t (&pa)[4][4],
                                       const float (&s)[8][4]) {
#pragma unroll
  for (int kc = 0; kc < kBlockK / 16; ++kc) {
    pa[kc][0] = pack_f32(s[2 * kc][0], s[2 * kc][1]);
    pa[kc][1] = pack_f32(s[2 * kc][2], s[2 * kc][3]);
    pa[kc][2] = pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]);
    pa[kc][3] = pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3]);
  }
}

// Consumer warpgroup cw (0, 1): query rows q0 + 64 cw .. + 63 against every
// key tile of the block. Products are issued in turns with the other
// consumer (named barriers 1 + cw: this one's turn; the other's issue
// section ends by arriving on it), so one consumer's softmax runs while the
// other's products occupy the tensor cores. Within a consumer, tile j's
// q.K^T is issued first; o is rescaled by tile j-1's factors while it runs;
// then tile j-1's PV is issued, and tile j's softmax runs while PV does.
// Every register operand of an in-flight wgmma is fenced (pin) before the
// issue and after the wait: without it the compiler gives P's packed
// registers to the score tile that the next q.K^T overwrites, and ptxas
// then serialises every wgmma.
//
// Consumer 0 also produces: right after its issue turn of round j (while
// its q.K^T runs) it issues K up to tile j + kKSlots - 1 and V up to tile
// j. The slot each takes was released by consumer 1 in its round j - 1 at
// the latest, after q.K^T of tile j - 1 (K) or PV of tile j - 3 (V, three
// slots) completed, which never waits on consumer 0, so the wait cannot
// deadlock; it gives K and V one round or more of lead. (Issued before the
// turn instead, its waits delayed the turn: 172 against 157 us at
// recurrentgemma's shape, in turns on an H100.)
template <int HD>
__device__ __forceinline__ void ws_consume(const Args& a, WsLoads& ld,
                                           unsigned char* sm, uint32_t bars,
                                           int cw) {
  using L = WsSmem<HD>;
  const unsigned ct = threadIdx.x - 128 * cw;
  const int warp = ct >> 5, lane = ct & 31, g = lane >> 2, t4 = lane & 3;
  const uint32_t base = smem_addr(sm);
  const uint32_t q_addr = base + L::kQ + cw * L::kTileB;
  const uint32_t k_addr = base + L::kK, v_addr = base + L::kV;
  const int own = 1 + cw, other = 2 - cw;  // scheduling barrier ids
  const int lo = ld.lo, n = ld.n;

  float o[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m0 = kMasked2, m1 = kMasked2, l0 = 0.f, l1 = 0.f;  // l: lane partial
  float r0, r1;  // the last softmax's rescale factors, not yet applied
  const float scale2 = a.scale * kLog2e;
  const int w_lo = ld.q0 + 64 * cw + warp * 16, row0 = w_lo + g;
  float s[8][4];
  uint32_t pa[4][4];

  if (cw == 0)
    ws_issue<HD>(a, ld, sm, bars, ct, true, L::kKSlots - 1, 0);
  else
    bar_arrive(1, 256);  // consumer 0 issues first
  mbar_wait(bars, 0);    // q

  // tile 0: q.K^T alone
  bar_sync(own, 256);
  mbar_wait(L::full_k(bars, 0), 0);
  pin(s);
  wgmma_fence();
  ws_qk<HD>(s, q_addr, k_addr);
  bar_arrive(other, 256);
  wgmma_wait<0>();
  pin(s);
  if (lane == 0) mbar_arrive(L::empty_k(bars, 0));
  softmax_probs<true>(a, s, lo * kBlockK, w_lo, row0, t4, scale2, m0, m1, l0, l1,
                r0, r1);
  pack_p(pa, s);

#pragma unroll 1
  for (int j = 1; j < n; ++j) {
    bar_sync(own, 256);
    mbar_wait(L::full_k(bars, j), L::k_parity(j));
    pin(s);
    pin(o);
    pin_u(pa);
    wgmma_fence();
    ws_qk<HD>(s, q_addr, k_addr + (j % L::kKSlots) * L::kTileB);
    rescale(o, r0, r1);
    mbar_wait(L::full_v(bars, j - 1), L::v_parity(j - 1));
    pin(o);
    wgmma_fence();
    ws_pv<HD>(o, pa, v_addr + ((j - 1) % L::kVSlots) * L::kTileB);
    bar_arrive(other, 256);
    if (cw == 0)
      ws_issue<HD>(a, ld, sm, bars, ct, false, j + L::kKSlots - 1, j);
    wgmma_wait<1>();  // q.K^T of tile j
    pin(s);
    if (lane == 0) mbar_arrive(L::empty_k(bars, j));
    softmax_probs<true>(a, s, (lo + j) * kBlockK, w_lo, row0, t4, scale2, m0, m1,
                  l0, l1, r0, r1);
    wgmma_wait<0>();  // PV of tile j - 1
    pin(o);
    pin_u(pa);
    if (lane == 0) mbar_arrive(L::empty_v(bars, j - 1));
    pack_p(pa, s);
  }

  // the last tile's PV
  bar_sync(own, 256);
  mbar_wait(L::full_v(bars, n - 1), L::v_parity(n - 1));
  rescale(o, r0, r1);
  pin(o);
  pin_u(pa);
  wgmma_fence();
  ws_pv<HD>(o, pa, v_addr + ((n - 1) % L::kVSlots) * L::kTileB);
  bar_arrive(other, 256);
  wgmma_wait<0>();
  pin(o);
  pin_u(pa);
  if (cw == 0) bar_sync(own, 256);  // consumer 1's last arrival

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);

  // stage the warp's 16 output rows in its own rows of this consumer's q
  // tile (swizzled as q), then write them with 16-byte stores
  bar_sync(3 + cw, 128);  // every warp's products are done with q
  unsigned char* q_s = sm + L::kQ + cw * L::kTileB;
  const int rr = warp * 16 + g;
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    *reinterpret_cast<__nv_bfloat162*>(q_s + sw128(rr, nt) + t4 * 4) =
        __floats2bfloat162_rn(o[nt][0] / d0, o[nt][1] / d0);
    *reinterpret_cast<__nv_bfloat162*>(q_s + sw128(rr + 8, nt) + t4 * 4) =
        __floats2bfloat162_rn(o[nt][2] / d1, o[nt][3] / d1);
  }
  __syncwarp();
  constexpr int kChunks = HD / 8;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) +
                       ((int64_t)ld.b * a.S * a.H + ld.h) * HD;
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const unsigned i = it * 32 + lane;
    const int r = i / kChunks, c = i % kChunks;
    if (w_lo + r < a.S)
      *reinterpret_cast<uint4*>(out + (int64_t)(w_lo + r) * a.H * HD + c * 8) =
          *reinterpret_cast<const uint4*>(q_s + sw128(warp * 16 + r, c));
  }
}

// One block per (query head, batch row, 128-row query tile), heaviest tiles
// first: two consumer warpgroups of 64 query rows over shared K/V tiles,
// consumer 0's first thread issuing the TMA copies. A consumer thread holds
// a 64 x HD f32 output tile (HD/2 registers, 128 at hd 256), a 64 x 64
// score tile (32) and P in bf16 (16): ~200 registers with the rest, which
// 256 threads a block allow (255 a thread). FA3's split, a producer
// warpgroup giving registers back (setmaxnreg.dec to 24) to consumers that
// raise theirs (inc to 240), compiled with ptxas of CUDA 12.9 to consumers
// held within the 168 registers a 384-thread launch gives, spilling and
// with every wgmma serialised; a single producer warp (288 threads) fared
// the same. A block keeps q (2 x 64 x HD) and its K and V rings in shared
// memory: 224 KB at hd 256, 192 KB at hd 192, so one block an SM.
template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bf16_ws_kernel(const Args a, const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv) {
  static_assert(HD == 128 || HD == 192 || HD == 256, "ws head dims");
  using L = WsSmem<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t bars = smem_addr(sm + L::kBars);

  WsLoads ld;
  ld.tq = &tq;
  ld.tk = &tk;
  ld.tv = &tv;
  ld.h = blockIdx.x;
  ld.b = blockIdx.y;
  ld.q0 = (gridDim.z - 1 - blockIdx.z) * kWsBlockQ;
  ld.kh = ld.h / (a.H / a.K);
  int hi;
  tile_range(a, ld.q0, ld.lo, hi, kWsBlockQ);
  ld.n = hi - ld.lo + 1;
  ld.next_k = ld.next_v = 0;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int i = 1; i < 1 + L::kKSlots + L::kVSlots; ++i)
      mbar_init(bars + 8 * i, 1);
    for (int i = 1 + L::kKSlots + L::kVSlots; i < L::kNumBars; ++i)
      mbar_init(bars + 8 * i, 8);  // one arrival a consumer warp
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  ws_consume<HD>(a, ld, sm, bars, threadIdx.x / 128);
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
constexpr size_t smem_f32() {
  return sizeof(float) * ((kBlockQ + kBlockK) * (HD + 1) + kBlockK * HD +
                          kBlockQ * (kBlockK + 1));
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

  int q0, h, b;
  block_coords(q0, h, b);
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

// Above 48 KB of shared memory a kernel must opt in: once per kernel and
// device (no stream work, so a capture is not disturbed). Returns the
// attribute call's error; a later launch fails on its own if it failed.
template <auto Kernel>
cudaError_t opt_in(size_t smem) {
  static unsigned done = 0;  // a bit per device and kernel
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 32 && (done >> dev & 1u)) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && dev < 32) done |= 1u << dev;
  return e;
}

// Kernels a (dtype, hd) call may run: 0 = flash_f32_kernel, 1 =
// flash_bf16_kernel (mma.sync), 2 = flash_bf16_wgmma_kernel, 3 =
// flash_bf16_ws_kernel. The route: bf16 hd 64, 96 and 128 on the wgmma
// kernel; 192 and 256 on the warp-specialised one; hd 32, which only the
// reduced configs have (no model of the zoo runs it at full width), on
// mma.sync. hd 128 has the warp-specialised kernel too, off the route: it
// is timed beside the wgmma kernel as a record.
template <int HD>
constexpr int kRoute = HD == 32 ? 1 : (HD <= 128 ? 2 : 3);
template <int HD>
constexpr bool kHasMma = HD == 32;
template <int HD>
constexpr bool kHasWgmma = HD == 64 || HD == 96 || HD == 128;
template <int HD>
constexpr bool kHasWs = HD == 128 || HD == 192 || HD == 256;

template <void (*Kernel)(Args)>
int launch(size_t smem, dim3 grid, cudaStream_t stream, const Args& a) {
  const cudaError_t e = opt_in<Kernel>(smem);
  if (e != cudaSuccess) return (int)e;
  Kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, a driver call, found through the runtime (the
// library links no libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, S, heads, HD) bf16 tensor addressed by strides (elements) as a 4-d
// map (hd, heads, S, B) with a 64 x 64 (hd x rows) box, one 128-byte
// swizzle atom: a tile lands as wgmma's swizzled layout, rows past S as
// zeros. TMA needs 16-byte aligned rows and strides (the wrapper's `vec`).
bool encode_map(CUtensorMap* m, const void* ptr, int hd, int heads, int S,
                int B, int64_t sb, int64_t ss, int64_t sh) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1}, unit[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_ws(int B, cudaStream_t stream, const Args& a) {
  const cudaError_t e = opt_in<flash_bf16_ws_kernel<HD>>(WsSmem<HD>::kBytes);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tq, tk, tv;
  memset(&tq, 0, sizeof tq);
  memset(&tk, 0, sizeof tk);
  memset(&tv, 0, sizeof tv);
  if (a.vec && !(encode_map(&tq, a.q, HD, a.H, a.S, B, a.q_sb, a.q_ss,
                            a.q_sh) &&
                 encode_map(&tk, a.k, HD, a.K, a.S, B, a.k_sb, a.k_ss,
                            a.k_sh) &&
                 encode_map(&tv, a.v, HD, a.K, a.S, B, a.v_sb, a.v_ss,
                            a.v_sh)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(a.H, B, (a.S + kWsBlockQ - 1) / kWsBlockQ);
  flash_bf16_ws_kernel<HD><<<grid, kWsThreads, WsSmem<HD>::kBytes, stream>>>(
      a, tq, tk, tv);
  return (int)cudaGetLastError();
}

// kernel: -1 = the route, else one of the ids above that hd has
template <int HD>
int launch_hd(int dtype, int kernel, int B, cudaStream_t stream,
              const Args& a) {
  const dim3 grid(a.H, B, (a.S + kBlockQ - 1) / kBlockQ);  // heaviest first
  if (dtype == 0) {
    if (kernel > 0) return (int)cudaErrorInvalidValue;
    return launch<flash_f32_kernel<HD>>(smem_f32<HD>(), grid, stream, a);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (kernel < 0) kernel = kRoute<HD>;
  if constexpr (kHasMma<HD>)
    if (kernel == 1)
      return launch<flash_bf16_kernel<HD>>(smem_bf16<HD>(), grid, stream, a);
  if constexpr (kHasWgmma<HD>)
    if (kernel == 2)
      return launch<flash_bf16_wgmma_kernel<HD>>(smem_wgmma<HD>(), grid,
                                                 stream, a);
  if constexpr (kHasWs<HD>)
    if (kernel == 3) return launch_ws<HD>(B, stream, a);
  return (int)cudaErrorInvalidValue;
}

template <auto Kernel>
int blocks_per_sm(size_t smem, int threads) {
  int n = 0;
  if (opt_in<Kernel>(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, Kernel, threads,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

template <int HD>
int blocks_per_sm_hd(int dtype, int kernel) {
  if (dtype == 0)
    return blocks_per_sm<flash_f32_kernel<HD>>(smem_f32<HD>(), kThreads);
  if (kernel < 0) kernel = kRoute<HD>;
  if constexpr (kHasMma<HD>)
    if (kernel == 1)
      return blocks_per_sm<flash_bf16_kernel<HD>>(smem_bf16<HD>(), kThreads);
  if constexpr (kHasWgmma<HD>)
    if (kernel == 2)
      return blocks_per_sm<flash_bf16_wgmma_kernel<HD>>(smem_wgmma<HD>(),
                                                        kThreads);
  if constexpr (kHasWs<HD>)
    if (kernel == 3)
      return blocks_per_sm<flash_bf16_ws_kernel<HD>>(WsSmem<HD>::kBytes,
                                                     kWsThreads);
  return -1;
}

template <int HD>
int smem_bytes_hd(int dtype, int kernel) {
  if (dtype == 0) return kernel > 0 ? -1 : (int)smem_f32<HD>();
  if (kernel < 0) kernel = kRoute<HD>;
  if constexpr (kHasMma<HD>)
    if (kernel == 1) return (int)smem_bf16<HD>();
  if constexpr (kHasWgmma<HD>)
    if (kernel == 2) return (int)smem_wgmma<HD>();
  if constexpr (kHasWs<HD>)
    if (kernel == 3) return (int)WsSmem<HD>::kBytes;
  return -1;
}

template <int HD>
int kernel_of_hd(int dtype) {
  return dtype == 0 ? 0 : dtype != 1 ? -1 : kRoute<HD>;
}

#define FLASH_HD_SWITCH(hd, call)            \
  switch (hd) {                              \
    case 32: { constexpr int HD = 32; call; }   \
    case 64: { constexpr int HD = 64; call; }   \
    case 96: { constexpr int HD = 96; call; }   \
    case 128: { constexpr int HD = 128; call; } \
    case 192: { constexpr int HD = 192; call; } \
    case 256: { constexpr int HD = 256; call; } \
    default: break;                          \
  }

}  // namespace

// As flash_attention_launch, on kernel `kernel` (an id of
// flash_attention_kernel_of; -1 = the route). A bf16 head dim runs only the
// kernels it is instantiated for; any other choice returns an error.
extern "C" int flash_attention_launch_as(
    int kernel, int dtype, const void* q, const void* k, const void* v,
    void* out, int B, int S, int H, int K, int hd, int causal, int window,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale,
    int vec, void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.S = S; a.H = H; a.K = K; a.causal = causal; a.window = window;
  a.vec = vec;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_HD_SWITCH(hd, return launch_hd<HD>(dtype, kernel, B, s, a))
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16. causal: 0/1. window <= 0: none.
// vec: 1 when every row start of q, k and v is 16-byte aligned (and, with
// it, every stride a multiple of 16 bytes).
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* out, int B,
    int S, int H, int K, int hd, int causal, int window, int64_t q_sb,
    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale, int vec,
    void* stream) {
  return flash_attention_launch_as(-1, dtype, q, k, v, out, B, S, H, K, hd,
                                   causal, window, q_sb, q_ss, q_sh, k_sb,
                                   k_ss, k_sh, v_sb, v_ss, v_sh, scale, vec,
                                   stream);
}

// The kernel that (dtype, hd) launches: 0 = flash_f32_kernel, 1 =
// flash_bf16_kernel (mma.sync), 2 = flash_bf16_wgmma_kernel, 3 =
// flash_bf16_ws_kernel; -1: not taken.
extern "C" int flash_attention_kernel_of(int dtype, int hd) {
  FLASH_HD_SWITCH(hd, return kernel_of_hd<HD>(dtype))
  return -1;
}

// Resident blocks an SM for kernel `kernel` (-1: the route) of (dtype, hd),
// from the occupancy calculator (registers, shared memory, threads); -1 on
// error or a kernel the head dim does not have.
extern "C" int flash_attention_blocks_per_sm(int dtype, int hd, int kernel) {
  FLASH_HD_SWITCH(hd, return blocks_per_sm_hd<HD>(dtype, kernel))
  return -1;
}

// Dynamic shared memory a launch of kernel `kernel` (-1: the route) of
// (dtype, hd) asks for, in bytes; -1 for a kernel the head dim does not have.
extern "C" int flash_attention_smem_bytes(int dtype, int hd, int kernel) {
  FLASH_HD_SWITCH(hd, return smem_bytes_hd<HD>(dtype, kernel))
  return -1;
}
