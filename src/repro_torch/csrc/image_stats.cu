// Image-complexity statistics and the §3.1.1 image scores for Hopper
// (sm_90a), in one launch. Plain C entry point, loaded with ctypes.
//
// Replaces the TPU kernel image_stats_pallas of
// src/repro/kernels/image_complexity.py (and fuses the scalar epilogue of
// ops.py::image_complexity_from_stats). For each image of a (B, H, W) f32
// batch in [0, 255]: the sum of the Sobel gradient magnitude, the sum and
// the sum of squares of the 4-neighbour Laplacian (stencils on an
// edge-padded image), a 256-bin histogram of clip(floor(x), 0, 255), and
// from those c_res, c_edge, c_ent, c_lap and c_img.
//
// What bounds it: at the paper's 1024x1024 reference resolution, bytes (one
// read of 4 MiB an image against ~30 flops a pixel); at the launcher's
// 64x64 image (16 KiB), the launch itself. The design answers both:
// - one launch, no memset, no allocation: the outputs and the per-band
//   workspace are one buffer the caller allocates, the ticket counters are
//   left at zero by every launch, and the scores are computed by the last
//   block of each image, so a request's score is one launch;
// - a grid of (bands, B) blocks of 256 threads; a band is a run of rows of
//   one image, sized by the caller (image_stats_grid) to about two blocks
//   an SM, which is what the registers (__launch_bounds__(256, 2)) let
//   stay resident: a 64x64 image is one block. Each thread owns four
//   adjacent columns (one 16-byte load where rows are 16-byte aligned,
//   four scalar loads otherwise) and walks down its rows with a rolling
//   window of three rows, the loads of the next kBatch rows issued before
//   their arithmetic; left and right neighbours come from the adjacent
//   lanes by shuffles (a scalar load only at a warp's or row group's edge),
//   and edge padding is a clamp of the row or column index, which only the
//   image's first and last rows and columns reach. Each pixel is read from
//   device memory once, plus two halo rows a band. The Sobel and Laplacian
//   stencils share their column sums between adjacent pixels;
// - sums per row in f32 (four pixels), per thread in double, reduced in a
//   fixed order (butterfly within a warp, warps in order); the histogram in
//   one 256-bin sub-histogram per warp in shared memory, one shared atomic a
//   pixel, summed over warps per bin. (Aggregating equal bins with
//   __match_any_sync first cost more than it saved, on flat images too:
//   the card serialises same-address shared atomics cheaply; see PERF.md.)
// - across bands no atomics on the data: each block stores its partial
//   (3 doubles and 256 ints) to its own workspace slot, fences, and takes a
//   ticket from its image's counter; the block that draws the last ticket
//   sums the slots in a fixed order (so every run gives the same bits),
//   writes the f32 outputs, computes the scores and resets the counter. A
//   single-band image needs no slot and no ticket.
//
// Concurrent calls: the wrapper gives each CUDA stream its own row of
// zeroed counters, one an image (a launch with more than one band has at
// most image_stats_grid's 264 images). Calls on one stream run in order
// and each leaves its counters at zero; a call captured into a CUDA graph
// keeps the counters of the stream it was captured on, so a graph is
// replayed on one stream at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
// One band's partial: three doubles, padding to 32 bytes, 256 int bins.
constexpr int kSlotBytes = 32 + kBins * 4;
constexpr unsigned kFull = 0xffffffffu;
// Rows a thread loads ahead of their arithmetic.
constexpr int kBatch = 4;

// The §3.1.1 constants, in f32 as the plain epilogue rounds them.
struct Consts {
  float n;                 // H * W
  float edge_p5, edge_den;  // den = p95 - p5 + eps, rounded once
  float lap_p5, lap_den;
  float c_res;
  float w_res, w_edge, w_ent, w_lap;
  float log256;
};

// Launch geometry, fixed per call.
struct Geom {
  int H, W, band_rows, bands;
  int nq;      // quads (4 columns) a row
  int wg;      // threads a row group: a power of two, at most kThreads
  int chunks;  // passes over a band's columns: ceil(nq / wg)
  int rs;      // rows a row group walks: ceil(band_rows / (kThreads / wg))
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// One row of a thread's four columns as loaded: the quad and, where the
// thread cannot take them from a neighbour lane, its left and right
// neighbours.
struct Raw {
  float4 v;
  float l, r;
};

// A row with its neighbours resolved: c[0] left, c[1..4] the quad, c[5]
// right.
struct Row {
  float c[6];
};

template <bool kVec>
__device__ __forceinline__ Raw load_row(const float* __restrict__ im,
                                        const Geom& g, int y, int q,
                                        bool need_l, bool need_r) {
  y = min(max(y, 0), g.H - 1);
  const float* row = im + (int64_t)y * g.W;
  const int ql = min(q, g.nq - 1);
  Raw raw;
  if (kVec) {
    raw.v = __ldg(reinterpret_cast<const float4*>(row) + ql);
  } else {
    const int c = 4 * ql, last = g.W - 1;
    raw.v.x = __ldg(row + min(c, last));
    raw.v.y = __ldg(row + min(c + 1, last));
    raw.v.z = __ldg(row + min(c + 2, last));
    raw.v.w = __ldg(row + min(c + 3, last));
  }
  raw.l = need_l ? __ldg(row + min(max(4 * q - 1, 0), g.W - 1)) : 0.0f;
  raw.r = need_r ? __ldg(row + min(4 * q + 4, g.W - 1)) : 0.0f;
  return raw;
}

__device__ __forceinline__ Row resolve(const Raw& raw, bool need_l,
                                       bool need_r) {
  const float from_left = __shfl_up_sync(kFull, raw.v.w, 1);
  const float from_right = __shfl_down_sync(kFull, raw.v.x, 1);
  Row row;
  row.c[0] = need_l ? raw.l : from_left;
  row.c[1] = raw.v.x;
  row.c[2] = raw.v.y;
  row.c[3] = raw.v.z;
  row.c[4] = raw.v.w;
  row.c[5] = need_r ? raw.r : from_right;
  return row;
}

__device__ __forceinline__ float clamp01(float x) {
  // torch.clamp / jnp.clip: NaN passes through
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// The last block: every slot of image b, in a fixed order, into hist_s and
// tot. Bins: thread t sums 4 bins (t % 64) over the slots t / 64,
// t / 64 + 4, ...; sums: lane l of warp w (w < 3) adds sum w of the slots
// l, l + 32, ... in band order, then the 32 lane sums meet in a fixed
// butterfly.
__device__ void merge(int b, int bands, const unsigned char* __restrict__ work,
                      int4 (*part)[kBins / 4], double* tot, int* hist_s) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned char* base = work + (int64_t)b * bands * kSlotBytes;
  const int col = t & 63, grp = t >> 6;
  int4 acc = make_int4(0, 0, 0, 0);
#pragma unroll 8
  for (int s = grp; s < bands; s += 4) {
    const int4 v = __ldcg(
        reinterpret_cast<const int4*>(base + (int64_t)s * kSlotBytes + 32) +
        col);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  part[grp][col] = acc;
  if (warp < 3) {
    double a = 0.0;
    for (int s = lane; s < bands; s += 32)
      a += __ldcg(reinterpret_cast<const double*>(
                      base + (int64_t)s * kSlotBytes) + warp);
    a = warp_sum(a);
    if (lane == 0) tot[warp] = a;
  }
  __syncthreads();
  const int* pi = reinterpret_cast<const int*>(&part[0][0]);
  hist_s[t] = pi[t] + pi[kBins + t] + pi[2 * kBins + t] + pi[3 * kBins + t];
  __syncthreads();
}

// Image b's outputs from its totals, into `out`: the stats as (4, B), the
// histograms as (B, 256), the scores as (5, B) (so each statistic and each
// score of a batch is one contiguous run). Every thread of the block calls
// it.
__device__ void finish(int b, int B, const Consts& k, float* __restrict__ out,
                       const int* hist_s, const double* tot, float* ent_s) {
  const int t = threadIdx.x;
  float* stats = out + b;
  float* hist = out + 4 * B + kBins * b;
  float* scores = out + (4 + kBins) * B + b;
  const float hv = (float)hist_s[t];
  hist[t] = hv;
  // entropy: p log p per bin, summed by a butterfly in each warp of 32
  // bins, then the 8 warp sums in order
  const float p = __fdiv_rn(hv, k.n);
  float e = p > 0.0f ? __fmul_rn(p, logf(p)) : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    e = __fadd_rn(e, __shfl_xor_sync(kFull, e, o));
  if ((t & 31) == 0) ent_s[t >> 5] = e;
  __syncthreads();
  if (t == 0) {
    float ent = 0.0f;
    for (int w = 0; w < kWarps; ++w) ent = __fadd_rn(ent, ent_s[w]);
    // ops.image_complexity_from_stats, operation by operation, in f32 (the
    // __f*_rn intrinsics keep the compiler from fusing into FMAs)
    const float sob = (float)tot[0], ls = (float)tot[1], lq = (float)tot[2];
    stats[0] = sob;
    stats[B] = ls;
    stats[2 * B] = lq;
    stats[3 * B] = 0.0f;
    const float g_mean = __fdiv_rn(sob, k.n);
    const float c_edge =
        clamp01(__fdiv_rn(__fsub_rn(g_mean, k.edge_p5), k.edge_den));
    const float lap_mean = __fdiv_rn(ls, k.n);
    const float lap_var =
        __fsub_rn(__fdiv_rn(lq, k.n), __fmul_rn(lap_mean, lap_mean));
    const float c_lap =
        clamp01(__fdiv_rn(__fsub_rn(lap_var, k.lap_p5), k.lap_den));
    const float c_ent = __fdiv_rn(-ent, k.log256);
    const float c_img = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(k.w_res, k.c_res),
                            __fmul_rn(k.w_edge, c_edge)),
                  __fmul_rn(k.w_ent, c_ent)),
        __fmul_rn(k.w_lap, c_lap));
    scores[0] = k.c_res;
    scores[B] = c_edge;
    scores[2 * B] = c_ent;
    scores[3 * B] = c_lap;
    scores[4 * B] = c_img;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
image_stats_kernel(const float* __restrict__ img, Geom g, Consts k,
                   unsigned char* __restrict__ work,
                   unsigned* __restrict__ counters, float* __restrict__ out,
                   int B) {
  __shared__ int h_w[kWarps][kBins];
  __shared__ double red[kWarps][3];
  __shared__ double tot[3];
  __shared__ int hist_s[kBins];
  __shared__ int4 part[4][kBins / 4];
  __shared__ float ent_s[kWarps];
  __shared__ bool is_last;

  const int b = blockIdx.y, band = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* im = img + (int64_t)b * g.H * g.W;

  for (int i = t; i < kWarps * kBins; i += kThreads) (&h_w[0][0])[i] = 0;
  __syncthreads();

  const int gi = t / g.wg, qi = t % g.wg;
  const int r0 = band * g.band_rows;
  const int r1 = min(r0 + g.band_rows, g.H);
  const int ys = r0 + gi * g.rs;
  const int ye = min(ys + g.rs, r1);

  double s_mag = 0.0, s_lap = 0.0, s_lap2 = 0.0;
  int* hw = h_w[warp];
  for (int chunk = 0; chunk < g.chunks; ++chunk) {
    const int q = chunk * g.wg + qi;
    const bool need_l = qi == 0 || lane == 0;
    const bool need_r = qi == g.wg - 1 || lane == 31 || q >= g.nq - 1;
    Row up = resolve(load_row<kVec>(im, g, ys - 1, q, need_l, need_r),
                     need_l, need_r);
    Row mid = resolve(load_row<kVec>(im, g, ys, q, need_l, need_r),
                      need_l, need_r);
    // rows in batches of kBatch: the batch's loads are all issued before
    // its arithmetic. Every thread of the block runs the same rows (rows
    // past its range are computed and dropped), so the shuffles stay
    // convergent.
    for (int i0 = 0; i0 < g.rs; i0 += kBatch) {
      Raw below[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        below[i] = load_row<kVec>(im, g, ys + i0 + i + 1, q, need_l, need_r);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int y = ys + i0 + i;
        const Row dn = resolve(below[i], need_l, need_r);
        const bool row_ok = i0 + i < g.rs && y < ye;
        // column terms shared by adjacent pixels: S = U + 2M + D (Sobel x),
        // V = D - U (Sobel y), T = U + D (Laplacian)
        float S[6], V[6], T[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          S[c] = up.c[c] + 2.0f * mid.c[c] + dn.c[c];
          V[c] = dn.c[c] - up.c[c];
          T[c] = up.c[c] + dn.c[c];
        }
        // the row's four pixels summed in f32, then added in double
        float q_mag = 0.0f, q_lap = 0.0f, q_lap2 = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* M = mid.c + j + 1;
          const float gx = S[j + 2] - S[j];
          const float gy = V[j] + 2.0f * V[j + 1] + V[j + 2];
          const float lap = T[j + 1] + M[-1] + M[1] - 4.0f * M[0];
          if (row_ok && 4 * q + j < g.W) {
            q_mag += sqrtf(gx * gx + gy * gy);
            q_lap += lap;
            q_lap2 += lap * lap;
            atomicAdd(&hw[min(max(__float2int_rd(M[0]), 0), 255)], 1);
          }
        }
        s_mag += (double)q_mag;
        s_lap += (double)q_lap;
        s_lap2 += (double)q_lap2;
        up = mid;
        mid = dn;
      }
    }
  }

  s_mag = warp_sum(s_mag);
  s_lap = warp_sum(s_lap);
  s_lap2 = warp_sum(s_lap2);
  if (lane == 0) {
    red[warp][0] = s_mag;
    red[warp][1] = s_lap;
    red[warp][2] = s_lap2;
  }
  __syncthreads();
  int hb = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) hb += h_w[w][t];
  double bs[3] = {0.0, 0.0, 0.0};
  if (t == 0) {
    for (int w = 0; w < kWarps; ++w)
      for (int s = 0; s < 3; ++s) bs[s] += red[w][s];
  }

  if (g.bands == 1) {
    hist_s[t] = hb;
    if (t == 0)
      for (int s = 0; s < 3; ++s) tot[s] = bs[s];
    __syncthreads();
    finish(b, B, k, out, hist_s, tot, ent_s);
    return;
  }
  // this band's partial into its slot, then a ticket
  unsigned char* slot = work + ((int64_t)b * g.bands + band) * kSlotBytes;
  reinterpret_cast<int*>(slot + 32)[t] = hb;
  if (t == 0)
    for (int s = 0; s < 3; ++s) reinterpret_cast<double*>(slot)[s] = bs[s];
  __threadfence();
  __syncthreads();
  if (t == 0) is_last = atomicAdd(&counters[b], 1u) == (unsigned)g.bands - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  merge(b, g.bands, work, part, tot, hist_s);
  finish(b, B, k, out, hist_s, tot, ent_s);
  if (t == 0) counters[b] = 0u;  // the next launch on this stream starts at 0
}

__global__ void empty_kernel() {}

}  // namespace

// img (B, H, W) f32 contiguous. out: B * (4 + 256 + 5) f32: stats (4, B),
// histograms (B, 256), scores (5, B). work: B * bands slots of 1056
// bytes, 16-byte aligned (unused when bands == 1). counters: B zeroed
// uints private to `stream`, left zeroed (unused when bands == 1). cc:
// edge_p5, edge_den, lap_p5, lap_den, c_res, w_res, w_edge, w_ent, w_lap,
// log(256) as f32.
// One kernel launch; returns the CUDA error of the launch (0 = success).
extern "C" int image_stats_launch(const float* img, int B, int H, int W,
                                  int band_rows, const float* cc,
                                  unsigned* counters, float* out,
                                  void* work, void* stream) {
  Geom g;
  g.H = H;
  g.W = W;
  g.band_rows = band_rows;
  g.bands = (H + band_rows - 1) / band_rows;
  g.nq = (W + 3) / 4;
  g.wg = 1;
  while (g.wg < g.nq && g.wg < kThreads) g.wg *= 2;
  g.chunks = (g.nq + g.wg - 1) / g.wg;
  const int groups = kThreads / g.wg;
  g.rs = (band_rows + groups - 1) / groups;
  Consts k;
  k.n = (float)((int64_t)H * W);
  k.edge_p5 = cc[0];
  k.edge_den = cc[1];
  k.lap_p5 = cc[2];
  k.lap_den = cc[3];
  k.c_res = cc[4];
  k.w_res = cc[5];
  k.w_edge = cc[6];
  k.w_ent = cc[7];
  k.w_lap = cc[8];
  k.log256 = cc[9];
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0;
  const dim3 grid(g.bands, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* w = static_cast<unsigned char*>(work);
  if (vec)
    image_stats_kernel<true><<<grid, kThreads, 0, s>>>(img, g, k, w, counters,
                                                       out, B);
  else
    image_stats_kernel<false><<<grid, kThreads, 0, s>>>(img, g, k, w,
                                                        counters, out, B);
  return (int)cudaGetLastError();
}

// An empty kernel of `blocks` blocks of 256 threads: the launch floor that
// the timing in chip_smoke.py sets beside the statistics kernel.
extern "C" int image_stats_empty_launch(int blocks, void* stream) {
  empty_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
