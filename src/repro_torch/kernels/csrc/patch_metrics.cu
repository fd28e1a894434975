// Fused event -> 48x48 count patch + six cluster metrics.
//
// Replaces the TPU kernel repro/kernels/patch_metrics.py:patch_metrics
// (one grid step per cluster slot; the patch scatter and the histogram as
// one-hot MXU matmuls). Here one CTA owns one (window, slot) pair of a
// block of windows:
//
//   1. scatter the window's weighted in-patch events into a 48x48 int32
//      patch in shared memory, and each in-patch leader event into a
//      32-bin int32 histogram (bin = trunc(c / norm * 32)), with
//      shared-memory atomics; integer counts are exact in any order;
//   2. Sobel over the 2304 pixels, per pixel
//      e2 = (gx*gx + gy*gy) / (norm*norm) + 1e-12 in round-to-nearest
//      steps (no fused multiply-add, so e2 is the reference's value to
//      the bit), with block reductions of sum(sqrt(e2)), sum(e2), max(e2)
//      and the integer moments sum(c), sum(c*c);
//   3. the edge count against (0.25 * max(sqrt(max e2), 1e-3))^2;
//   4. one thread evaluates the six metrics as the reference's
//      repro/core/metrics.py:_exact_cluster_metrics does.
//
// Invalid slots write zeros and do no work. Built without fast math, so
// division and sqrt are IEEE; log2f is within 1-2 ulp of libm, and the
// float sums of step 2 run in another order than on the host: those two
// are why the entropies and contrast carry a tolerance in the tests.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWin = 48;
constexpr int kPix = kWin * kWin;
constexpr int kBins = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMetrics = 6;
constexpr float kEdgeThreshold = 0.25f;
constexpr float kTwoPiE = 17.079468445347132f;  // 2 * pi * e

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ long long warp_sum_ll(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float pix(const int* patch, int r, int q) {
  return (r >= 0 && r < kWin && q >= 0 && q < kWin)
             ? static_cast<float>(patch[r * kWin + q])
             : 0.0f;
}

__global__ void __launch_bounds__(kThreads) patch_metrics_kernel(
    const int32_t* __restrict__ x, const int32_t* __restrict__ y,
    const uint8_t* __restrict__ w, const int32_t* __restrict__ c,
    const uint8_t* __restrict__ leader, const int32_t* __restrict__ x0,
    const int32_t* __restrict__ y0, const int32_t* __restrict__ count,
    const uint8_t* __restrict__ cvalid, const float* __restrict__ norm,
    int n_events, int n_slots, float* __restrict__ out) {
  const long long sid = blockIdx.x;  // window * n_slots + slot
  const long long win = sid / n_slots;
  float* o = out + sid * kMetrics;
  if (!cvalid[sid]) {  // uniform over the block: every thread leaves
    if (threadIdx.x < kMetrics) o[threadIdx.x] = 0.0f;
    return;
  }

  __shared__ int patch[kPix];
  __shared__ int hist[kBins];
  __shared__ float e2s[kPix];
  __shared__ float red_g[kWarps], red_e2[kWarps], red_mx[kWarps];
  __shared__ long long red_s1[kWarps], red_s2[kWarps], red_edges[kWarps];
  __shared__ float thr_sh;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int p = tid; p < kPix; p += kThreads) patch[p] = 0;
  if (tid < kBins) hist[tid] = 0;
  __syncthreads();

  // 1. Scatter.
  const float nrm = norm[win];
  const int px0 = x0[sid];
  const int py0 = y0[sid];
  const long long base = win * n_events;
  for (int i = tid; i < n_events; i += kThreads) {
    if (!w[base + i]) continue;
    const int rx = x[base + i] - px0;
    const int ry = y[base + i] - py0;
    if (rx < 0 || rx >= kWin || ry < 0 || ry >= kWin) continue;
    atomicAdd(&patch[ry * kWin + rx], 1);
    if (leader[base + i]) {
      const float v = __fmul_rn(__fdiv_rn(static_cast<float>(c[base + i]), nrm),
                                static_cast<float>(kBins));
      const int b = min(max(static_cast<int>(v), 0), kBins - 1);
      atomicAdd(&hist[b], 1);
    }
  }
  __syncthreads();

  // 2. Sobel (zero padded) and the first reductions.
  const float nn = __fmul_rn(nrm, nrm);
  float s_g = 0.0f, s_e2 = 0.0f, mx = -INFINITY;
  long long s1 = 0, s2 = 0;
  for (int p = tid; p < kPix; p += kThreads) {
    const int r = p / kWin;
    const int q = p - r * kWin;
    const float ul = pix(patch, r - 1, q - 1), up = pix(patch, r - 1, q);
    const float ur = pix(patch, r - 1, q + 1), left = pix(patch, r, q - 1);
    const float right = pix(patch, r, q + 1), dl = pix(patch, r + 1, q - 1);
    const float down = pix(patch, r + 1, q), dr = pix(patch, r + 1, q + 1);
    const float gx = __fadd_rn(
        __fadd_rn(__fsub_rn(ur, ul), __fmul_rn(2.0f, __fsub_rn(right, left))),
        __fsub_rn(dr, dl));
    const float gy = __fadd_rn(
        __fadd_rn(__fsub_rn(dl, ul), __fmul_rn(2.0f, __fsub_rn(down, up))),
        __fsub_rn(dr, ur));
    const float e2 = __fadd_rn(
        __fdiv_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), nn), 1e-12f);
    e2s[p] = e2;
    s_g = __fadd_rn(s_g, __fsqrt_rn(e2));
    s_e2 = __fadd_rn(s_e2, e2);
    mx = fmaxf(mx, e2);
    const long long cnt = patch[p];
    s1 += cnt;
    s2 += cnt * cnt;
  }
  s_g = warp_sum(s_g);
  s_e2 = warp_sum(s_e2);
  mx = warp_max(mx);
  s1 = warp_sum_ll(s1);
  s2 = warp_sum_ll(s2);
  if (lane == 0) {
    red_g[warp] = s_g;
    red_e2[warp] = s_e2;
    red_mx[warp] = mx;
    red_s1[warp] = s1;
    red_s2[warp] = s2;
  }
  __syncthreads();
  if (tid == 0) {
    float m = red_mx[0];
    for (int k = 1; k < kWarps; ++k) m = fmaxf(m, red_mx[k]);
    const float den = fmaxf(__fsqrt_rn(m), 1e-3f);
    const float a = __fmul_rn(kEdgeThreshold, den);
    thr_sh = __fmul_rn(a, a);
  }
  __syncthreads();

  // 3. Edge count.
  const float thr = thr_sh;
  long long edges = 0;
  for (int p = tid; p < kPix; p += kThreads) edges += e2s[p] > thr ? 1 : 0;
  edges = warp_sum_ll(edges);
  if (lane == 0) red_edges[warp] = edges;
  __syncthreads();

  // 4. The six metrics.
  if (tid != 0) return;
  float g_tot = 0.0f, e2_tot = 0.0f;
  long long s1_tot = 0, s2_tot = 0, edge_tot = 0;
  for (int k = 0; k < kWarps; ++k) {
    g_tot = __fadd_rn(g_tot, red_g[k]);
    e2_tot = __fadd_rn(e2_tot, red_e2[k]);
    s1_tot += red_s1[k];
    s2_tot += red_s2[k];
    edge_tot += red_edges[k];
  }
  // The reference runs under jit, where XLA turns division by the constant
  // pixel count into multiplication by its float32 reciprocal.
  const float inv_n = __fdiv_rn(1.0f, static_cast<float>(kPix));

  int occ = 0;
  for (int b = 0; b < kBins; ++b) occ += hist[b];
  float hsum = 0.0f;
  for (int b = 0; b < kBins; ++b) {
    const float h = static_cast<float>(hist[b] + (b == 0 ? kPix - occ : 0));
    hsum = __fadd_rn(hsum, h);
  }
  const float hden = fmaxf(hsum, 1.0f);
  float shannon = 0.0f, collide = 0.0f;
  for (int b = 0; b < kBins; ++b) {
    const float h = static_cast<float>(hist[b] + (b == 0 ? kPix - occ : 0));
    const float p = __fdiv_rn(h, hden);
    if (p > 0.0f) shannon = __fadd_rn(shannon, __fmul_rn(p, log2f(fmaxf(p, 1e-12f))));
    collide = __fadd_rn(collide, __fmul_rn(p, p));
  }

  const float mean = __fmul_rn(static_cast<float>(s1_tot), inv_n);
  const float var_c = fmaxf(
      __fsub_rn(__fmul_rn(static_cast<float>(s2_tot), inv_n), __fmul_rn(mean, mean)), 0.0f);
  const float contrast = __fdiv_rn(__fsqrt_rn(var_c), nrm);

  const float m1 = __fmul_rn(g_tot, inv_n);
  const float var_g = fmaxf(
      __fsub_rn(__fmul_rn(e2_tot, inv_n), __fmul_rn(m1, m1)), 1e-12f);
  const float diff_entropy = __fmul_rn(0.5f, log2f(__fmul_rn(kTwoPiE, var_g)));

  o[0] = -shannon;
  o[1] = -log2f(fmaxf(collide, 1e-12f));
  o[2] = diff_entropy;
  o[3] = contrast;
  o[4] = __fmul_rn(static_cast<float>(edge_tot), inv_n);
  o[5] = static_cast<float>(count[sid]);
}

}  // namespace

// Event tensors (n_windows, n_events): x, y, c int32; w, leader bool.
// Slot tensors (n_windows, n_slots): x0, y0, count int32; cvalid bool.
// norm: (n_windows,) float32; out: (n_windows, n_slots, 6) float32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int patch_metrics_launch(
    const void* x, const void* y, const void* w, const void* c,
    const void* leader, const void* x0, const void* y0, const void* count,
    const void* cvalid, const void* norm, int n_windows, int n_events,
    int n_slots, void* out, void* stream) {
  const long long blocks = static_cast<long long>(n_windows) * n_slots;
  if (blocks == 0) return 0;
  patch_metrics_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<const uint8_t*>(w), static_cast<const int32_t*>(c),
      static_cast<const uint8_t*>(leader), static_cast<const int32_t*>(x0),
      static_cast<const int32_t*>(y0), static_cast<const int32_t*>(count),
      static_cast<const uint8_t*>(cvalid), static_cast<const float*>(norm),
      n_events, n_slots, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
