// Image-complexity statistics for Hopper (sm_90a). Plain C entry point,
// loaded with ctypes.
//
// Replaces the TPU kernel image_stats_pallas of
// src/repro/kernels/image_complexity.py. For each image of a (B, H, W) f32
// batch in [0, 255]: the sum of the Sobel gradient magnitude, the sum and
// the sum of squares of the 4-neighbour Laplacian (stencils on an
// edge-padded image), and a 256-bin histogram of clip(floor(x), 0, 255).
//
// Bound on the card: one read of B*H*W*4 bytes and about 30 flops a pixel,
// so bytes bound it; at the launcher's one 64x64 image (16 KiB) the work is
// a fraction of a microsecond and the launches themselves bound it. Design:
// a grid of (x tile, y tile, image) blocks; each block stages its 32x32
// tile plus a one-pixel halo in shared memory with indices clamped at the
// border (the same as pad(mode="edge")), reduces its stencil sums per block
// in double, and adds them into per-image double totals with atomics. The
// histogram counts with integer atomics in shared memory and merges into a
// global integer histogram, so it is exact. A second small kernel converts
// the totals to the f32 outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTw = 32, kTh = 32;  // tile
constexpr int kBx = 32, kBy = 8;   // block: each thread walks 4 tile rows
constexpr int kBins = 256;
constexpr int kWarps = kBx * kBy / 32;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kBx * kBy)
image_stats_kernel(const float* __restrict__ img, int H, int W,
                   double* __restrict__ acc, int* __restrict__ hist) {
  __shared__ float tile[kTh + 2][kTw + 3];
  __shared__ int h_s[kBins];
  __shared__ double red[3][kWarps];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTw, y0 = blockIdx.y * kTh;
  const float* im = img + (int64_t)b * H * W;
  const int tid = threadIdx.y * kBx + threadIdx.x;

  for (int i = tid; i < kBins; i += kBx * kBy) h_s[i] = 0;
  for (int i = tid; i < (kTh + 2) * (kTw + 2); i += kBx * kBy) {
    const int r = i / (kTw + 2), c = i % (kTw + 2);
    const int y = min(max(y0 + r - 1, 0), H - 1);
    const int x = min(max(x0 + c - 1, 0), W - 1);
    tile[r][c] = im[(int64_t)y * W + x];
  }
  __syncthreads();

  double s_mag = 0.0, s_lap = 0.0, s_lap2 = 0.0;
  for (int r = threadIdx.y; r < kTh; r += kBy) {
    const int y = y0 + r, x = x0 + threadIdx.x;
    if (y < H && x < W) {
      const int R = r + 1, C = threadIdx.x + 1;
      const float gx = tile[R - 1][C + 1] + 2.0f * tile[R][C + 1] + tile[R + 1][C + 1]
                     - tile[R - 1][C - 1] - 2.0f * tile[R][C - 1] - tile[R + 1][C - 1];
      const float gy = tile[R + 1][C - 1] + 2.0f * tile[R + 1][C] + tile[R + 1][C + 1]
                     - tile[R - 1][C - 1] - 2.0f * tile[R - 1][C] - tile[R - 1][C + 1];
      const float c0 = tile[R][C];
      const float lap = tile[R - 1][C] + tile[R + 1][C] + tile[R][C - 1]
                      + tile[R][C + 1] - 4.0f * c0;
      s_mag += (double)sqrtf(gx * gx + gy * gy);
      s_lap += (double)lap;
      s_lap2 += (double)(lap * lap);
      const int bin = (int)fminf(fmaxf(floorf(c0), 0.0f), 255.0f);
      atomicAdd(&h_s[bin], 1);
    }
  }

  s_mag = warp_sum(s_mag);
  s_lap = warp_sum(s_lap);
  s_lap2 = warp_sum(s_lap2);
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
    red[0][warp] = s_mag;
    red[1][warp] = s_lap;
    red[2][warp] = s_lap2;
  }
  __syncthreads();
  if (tid < 3) {
    double t = 0.0;
    for (int w = 0; w < kWarps; ++w) t += red[tid][w];
    atomicAdd(&acc[b * 3 + tid], t);
  }
  for (int i = tid; i < kBins; i += kBx * kBy) {
    const int n = h_s[i];
    if (n) atomicAdd(&hist[b * kBins + i], n);
  }
}

__global__ void image_stats_finish(const double* __restrict__ acc,
                                   const int* __restrict__ hist,
                                   float* __restrict__ stats,
                                   float* __restrict__ hist_out, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B * kBins) hist_out[i] = (float)hist[i];
  if (i < B * 4) {
    const int b = i / 4, k = i % 4;
    stats[i] = k < 3 ? (float)acc[b * 3 + k] : 0.0f;
  }
}

}  // namespace

// img (B, H, W) f32 contiguous; acc (B, 3) f64 and hist_i (B, 256) i32 are
// scratch; stats (B, 4) and hist (B, 256) f32 are the outputs.
// Returns the first CUDA error (0 = success).
extern "C" int image_stats_launch(const float* img, int B, int H, int W,
                                  double* acc, int* hist_i, float* stats,
                                  float* hist, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(acc, 0, sizeof(double) * 3 * (size_t)B, s);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(hist_i, 0, sizeof(int) * kBins * (size_t)B, s);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + kTw - 1) / kTw, (H + kTh - 1) / kTh, B);
  const dim3 block(kBx, kBy);
  image_stats_kernel<<<grid, block, 0, s>>>(img, H, W, acc, hist_i);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = B * kBins;
  image_stats_finish<<<(n + 255) / 256, 256, 0, s>>>(acc, hist_i, stats, hist, B);
  return (int)cudaGetLastError();
}
