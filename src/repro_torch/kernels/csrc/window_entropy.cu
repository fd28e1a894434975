// Per-cluster window entropy metrics over a reconstructed [0, 1] frame:
// for each of K centres, the 48x48 slice (its origin clipped into the
// frame) -> a 32-bin intensity histogram -> Shannon entropy, Renyi
// entropy of order 2, and the population standard deviation (contrast).
//
// Replaces the TPU kernel repro/kernels/window_entropy.py:window_entropy
// (one grid step per cluster, the histogram as a one-hot (2304, 32)
// reduction with the frame resident in VMEM). No pipeline route reaches
// it, in the reference as here.
//
// Bound on the H100: bytes, a 9,216-byte slice per cluster and 12 bytes
// out; about 10 operations a pixel. Design: one CTA of 256 threads per
// cluster. Each thread reads 9 pixels (row-contiguous across a warp, so
// the slice comes in as 48-float rows), bins them into a 32-counter
// shared-memory histogram with integer atomics (exact in any order) and
// adds them to its partial sum; a block reduction gives the mean, a
// second pass over the thread's pixels (kept in registers) the sum of
// squared deviations. One warp then turns the 32 counts into
// probabilities (IEEE division) and reduces p log2 p and p^2 across its
// lanes. The float32 sums run in another order than the reference's, so
// the three outputs agree with it to rtol 1e-5, not to the bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWindow = 48;
constexpr int kBins = 32;
constexpr int kPixels = kWindow * kWindow;                 // 2,304
constexpr int kPerThread = (kPixels + kThreads - 1) / kThreads;  // 9

__device__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (warp == 0) {
    total = lane < kThreads / 32 ? scratch[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(0xffffffffu, total, o);
    if (lane == 0) scratch[0] = total;
  }
  __syncthreads();
  return scratch[0];
}

__global__ void __launch_bounds__(kThreads) window_entropy_kernel(
    const float* __restrict__ frame, int h, int w,
    const int32_t* __restrict__ cx, const int32_t* __restrict__ cy, int k,
    float* __restrict__ out) {
  __shared__ int hist[kBins];
  __shared__ float scratch[kThreads / 32];
  const int c = blockIdx.x;
  int x0 = cx[c] - kWindow / 2;
  int y0 = cy[c] - kWindow / 2;
  x0 = x0 < 0 ? 0 : (x0 > w - kWindow ? w - kWindow : x0);
  y0 = y0 < 0 ? 0 : (y0 > h - kWindow ? h - kWindow : y0);
  if (threadIdx.x < kBins) hist[threadIdx.x] = 0;
  __syncthreads();

  float v[kPerThread];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = threadIdx.x + j * kThreads;
    v[j] = 0.f;
    if (i < kPixels) {
      const int r = i / kWindow, col = i - r * kWindow;
      const float f = frame[static_cast<long long>(y0 + r) * w + x0 + col];
      v[j] = f;
      sum += f;
      int b = static_cast<int>(f * kBins);  // truncation, as astype(int32)
      b = b < 0 ? 0 : (b > kBins - 1 ? kBins - 1 : b);
      atomicAdd(&hist[b], 1);
    }
  }
  const float mean = block_sum(sum, scratch) / kPixels;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (threadIdx.x + j * kThreads < kPixels) {
      const float d = v[j] - mean;
      sq += d * d;
    }
  }
  const float var = block_sum(sq, scratch) / kPixels;  // ends in a barrier

  if (threadIdx.x < 32) {
    const float n = static_cast<float>(hist[threadIdx.x]);
    float total = n;
    for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(0xffffffffu, total, o);
    const float p = n / fmaxf(total, 1.f);
    float ent = p > 0.f ? p * log2f(fmaxf(p, 1e-12f)) : 0.f;
    float p2 = p * p;
    for (int o = 16; o > 0; o >>= 1) {
      ent += __shfl_xor_sync(0xffffffffu, ent, o);
      p2 += __shfl_xor_sync(0xffffffffu, p2, o);
    }
    if (threadIdx.x == 0) {
      out[c] = -ent;
      out[k + c] = -log2f(fmaxf(p2, 1e-12f));
      out[2 * k + c] = sqrtf(var);
    }
  }
}

}  // namespace

extern "C" int window_entropy_launch(const void* frame, int h, int w,
                                     const void* cx, const void* cy, int k,
                                     void* out, void* stream) {
  if (k == 0) return 0;
  window_entropy_kernel<<<k, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frame), h, w, static_cast<const int32_t*>(cx),
      static_cast<const int32_t*>(cy), k, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
