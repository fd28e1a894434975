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
// Bound on the H100: the bytes are the distinct frame pixels the K slices
// cover, 8 bytes of centre in and 12 out a centre; the operations about
// 10 a pixel of each slice, which is the larger once slices overlap (a
// K = 8,192 probe on a 640x480 frame: 2.8 us at 67e12 float32 operations
// a second). Below a few hundred centres no design reaches that bound:
// one slice's chain of dependent loads and reductions is the time.
//
// Design. A night-sky frame is mostly zeros, so nearly every pixel of a
// slice falls in bin 0: same-address shared-memory atomics would run as
// 32 serialized updates a warp instruction. No atomics here, shared or
// global; the counts are exact integers in any order. Two kernels, chosen
// at launch from K and the SM count (window_entropy_plan). Each wins on
// its own side of the switch (H100, 132 SMs, each path forced,
// tools/torch_k6_compare.py --paths): the wide path 0.0027 ms at K = 32
// and 0.0037 at 264, the warp path 0.0043 and 0.0044 there; at K = 265,
// one CTA past the wide path's single wave, 0.0048 against 0.0044, and
// at 8,192 0.075 against 0.018.
//
//   window_entropy_kernel, the wide path (K <= the CTAs the card holds at
//     once, 2 a SM): one CTA of 768 threads a centre, 16 rows x 48 columns
//     a pass, 3 pixels a thread, all three loads issued before any use.
//     Each warp counts its 32 pixels of a pass by votes: five ballots give
//     the bins' bit planes, and lane b counts the lanes whose bit pattern
//     is b (five masks ANDed, one popc). A warp's 32 counts (lane b, bin
//     b) and its sum go to shared memory together; one barrier; every
//     thread adds the 24 warp sums in a fixed order for the mean; the
//     squared deviations of the values still in registers, a warp sum
//     each; a second barrier, at which the last warp only arrives: it adds
//     the 24 partial counts of its lane's bin and writes the entropies,
//     while thread 0 adds the 24 partial squares for the contrast.
//   window_entropy_kernel_warps, the warp path (more centres): one warp a
//     centre, 4 warps a CTA, each warp looping over centres in a grid
//     stride, so that every SM holds 16 centres and no warp waits on
//     another. A lane loads its 72 pixels first, 3 in each pair of rows
//     (coalesced), then counts each in its own column of the warp's
//     [32 bins][32 lanes] table in shared memory (a plain increment: the
//     column is the lane's own, and lane l's entries sit in bank l), the
//     address made from the bin's float bits in one shift-add. Lane b then
//     adds row b of the table in 8 float4-wide reads, quad (i + b) mod 8
//     at step i (a quarter-warp's 8 lanes read 8 different quads, one
//     bank each), and zeroes it for the next centre. At K = 8,192 the
//     bytes do not bound it (one box 8,192 times runs about as fast as
//     8,192 random ones); the work a pixel takes does, spread over the
//     loads, the increments, the read-back and the epilogue
//     (tools/torch_k6_ablation.py times it without each). A TMA copy of
//     each box into shared memory was slower: it reads every box from L2,
//     past the L1 that overlapping boxes share.
//
// A pixel's bin is trunc(f * 32) clamped to [0, 31], as the reference's
// astype(int32) and clip: f is clamped to [0, 31.5 / 32], then one fma
// rounding down gives 2^23 + f * 32, whose low mantissa bits are floor(f *
// 32) (no float-to-int conversion, a sixteenth-rate operation).
//
// Tolerance: the counts are exact, so p = n / 2304 is the plain version's
// to the bit (IEEE division); Shannon and Renyi differ only by log2f
// against torch's log2 and the order of their 32-term sums, the contrast
// by the order of its float32 sums (the mean first, then the squared
// deviations, as jnp.std). rtol 1e-5, atol 1e-7 for exact zeros.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"

namespace {

constexpr int kWindow = 48;
constexpr int kBins = 32;
constexpr int kPixels = kWindow * kWindow;  // 2,304
constexpr unsigned kFull = 0xffffffffu;

constexpr int kWideThreads = 768;  // 16 rows x 48 columns a pass
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideRows = kWideThreads / kWindow;
constexpr int kWidePer = kPixels / kWideThreads;  // 3
constexpr int kWarpThreads = 128;  // the warp path: 4 centres at once a CTA
constexpr int kWarpWarps = kWarpThreads / 32;
constexpr int kPairs = kWindow / 2;  // a lane takes 3 pixels of each pair of rows
constexpr int kWarpPer = 3 * kPairs;  // 72

enum Path { kAuto = 0, kWide = 1, kWarp = 2 };

// 2^23 + floor(clamp(f, 0, 31.5 / 32) * 32) as float bits: 0x4B000000 + bin.
__device__ __forceinline__ unsigned bin_bits(float f) {
  return __float_as_uint(__fmaf_rd(fminf(fmaxf(f, 0.f), 0.984375f), 32.f, 8388608.f));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ const float* slice_origin(const float* frame, int h, int w,
                                                     const int32_t* cx, const int32_t* cy,
                                                     int c) {
  int x0 = cx[c] - kWindow / 2;
  int y0 = cy[c] - kWindow / 2;
  x0 = x0 < 0 ? 0 : (x0 > w - kWindow ? w - kWindow : x0);
  y0 = y0 < 0 ? 0 : (y0 > h - kWindow ? h - kWindow : y0);
  return frame + static_cast<long long>(y0) * w + x0;
}

// Shannon and Renyi of centre c from one warp whose lane b holds n, the
// count of bin b; lane 0 writes them.
__device__ __forceinline__ void entropies(int n, int lane, float* out, int c, int k) {
  const float p = static_cast<float>(n) / static_cast<float>(kPixels);  // the counts sum to 2304
  const float ent = warp_sum(p > 0.f ? p * log2f(fmaxf(p, 1e-12f)) : 0.f);
  const float p2 = warp_sum(p * p);
  if (lane == 0) {
    out[c] = -ent;
    out[k + c] = -log2f(fmaxf(p2, 1e-12f));
  }
}

__global__ void __launch_bounds__(kWideThreads, 2) window_entropy_kernel(
    const float* __restrict__ frame, int h, int w, const int32_t* __restrict__ cx,
    const int32_t* __restrict__ cy, int k, float* __restrict__ out) {
  __shared__ int s_cnt[kWideWarps][kBins];
  __shared__ float s_sum[kWideWarps], s_sq[kWideWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = blockIdx.x;
  const float* box = slice_origin(frame, h, w, cx, cy, c) + (threadIdx.x / kWindow) * w +
                     threadIdx.x % kWindow;
  float v[kWidePer];
#pragma unroll
  for (int j = 0; j < kWidePer; ++j) v[j] = box[j * kWideRows * w];
  // flip[q]: all ones where bit q of this lane's bin is 0.
  unsigned flip[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) flip[q] = ((lane >> q) & 1) ? 0u : kFull;
  int n = 0;
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kWidePer; ++j) {
    const unsigned b = bin_bits(v[j]);
    unsigned m = kFull;
#pragma unroll
    for (int q = 0; q < 5; ++q) m &= __ballot_sync(kFull, (b >> q) & 1) ^ flip[q];
    n += __popc(m);
    sum += v[j];
  }
  sum = warp_sum(sum);
  s_cnt[warp][lane] = n;
  if (lane == 0) s_sum[warp] = sum;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kWideWarps; ++i) total += s_sum[i];
  const float mean = total / kPixels;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < kWidePer; ++j) {
    const float d = v[j] - mean;
    sq += d * d;
  }
  sq = warp_sum(sq);
  if (lane == 0) s_sq[warp] = sq;
  if (warp == kWideWarps - 1) {
    // The last warp only arrives at the second barrier, then writes the
    // entropies (they need the counts alone) while thread 0 adds the squares.
    __threadfence_block();
    asm volatile("bar.arrive 1, %0;" ::"r"(kWideThreads) : "memory");
    n = 0;
#pragma unroll
    for (int i = 0; i < kWideWarps; ++i) n += s_cnt[i][lane];
    entropies(n, lane, out, c, k);
  } else {
    asm volatile("bar.sync 1, %0;" ::"r"(kWideThreads) : "memory");
    if (threadIdx.x == 0) {
      sq = 0.f;
#pragma unroll
      for (int i = 0; i < kWideWarps; ++i) sq += s_sq[i];
      out[2 * k + c] = sqrtf(sq / kPixels);
    }
  }
}

__global__ void __launch_bounds__(kWarpThreads, 4) window_entropy_kernel_warps(
    const float* __restrict__ frame, int h, int w, const int32_t* __restrict__ cx,
    const int32_t* __restrict__ cy, int k, float* __restrict__ out) {
  __shared__ __align__(16) int s_tab[kWarpWarps][kBins][32];  // [warp][bin][lane]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int(*tab)[32] = s_tab[warp];
  // tab[b][lane] as a 32-bit shared address from the bin bits: they are
  // 0x4B000000 + b, and (0x4B000000 << 7) wraps to 0x80000000, which
  // tab_s takes off beforehand.
  const uint32_t tab_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(&tab[0][lane])) - 0x80000000u;
#pragma unroll
  for (int b = 0; b < kBins; ++b) tab[b][lane] = 0;
  // Lane l's pixels in a pair of rows: q = l + 32 m (m < 3) of the pair's
  // 96, row q / 48 and column q % 48.
  int off[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int q = lane + 32 * m;
    off[m] = (q / kWindow) * w + q % kWindow;
  }
  __syncwarp();
  for (int c = blockIdx.x * kWarpWarps + warp; c < k; c += gridDim.x * kWarpWarps) {
    const float* box = slice_origin(frame, h, w, cx, cy, c);
    float v[kWarpPer];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
#pragma unroll
      for (int m = 0; m < 3; ++m) v[3 * p + m] = box[2 * p * w + off[m]];
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kWarpPer; ++j) {
      const uint32_t a = tab_s + (bin_bits(v[j]) << 7);
      uint32_t count;
      asm volatile("ld.shared.u32 %0, [%1];" : "=r"(count) : "r"(a));
      asm volatile("st.shared.u32 [%0], %1;" ::"r"(a), "r"(count + 1) : "memory");
      sum += v[j];
    }
    const float mean = warp_sum(sum) / kPixels;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kWarpPer; ++j) {
      const float d = v[j] - mean;
      sq += d * d;
    }
    const float var = warp_sum(sq) / kPixels;
    __syncwarp();
    int n = 0;
    int4* row = reinterpret_cast<int4*>(tab[lane]);
#pragma unroll
    for (int i = 0; i < kBins / 4; ++i) {
      const int q = (i + lane) & 7;
      const int4 t = row[q];
      n += t.x + t.y + t.z + t.w;
      row[q] = make_int4(0, 0, 0, 0);
    }
    __syncwarp();
    entropies(n, lane, out, c, k);
    if (lane == 0) out[2 * k + c] = sqrtf(var);
  }
}

// CTAs of each path that the card holds at once on the current device.
int ctas_at_once(bool wide) {
  const auto per_sm = [](auto kernel, int threads) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, 0) != cudaSuccess) {
      cudaGetLastError();
    }
    return n > 0 ? n : 1;
  };
  return static_cast<int>(
      wide ? per_device([&](int) -> long long {
               return sm_count() * per_sm(window_entropy_kernel, kWideThreads);
             }, 0)
           : per_device([&](int) -> long long {
               return sm_count() * per_sm(window_entropy_kernel_warps, kWarpThreads);
             }, 0));
}

}  // namespace

// The path a launch of k centres takes on the current device: 1 wide,
// 2 warp.
extern "C" int window_entropy_plan(int k) {
  return k <= ctas_at_once(true) ? kWide : kWarp;
}

// path: 0 chooses by window_entropy_plan; 1 and 2 force the wide and the
// warp path.
extern "C" int window_entropy_launch(const void* frame, int h, int w,
                                     const void* cx, const void* cy, int k, int path,
                                     void* out, void* stream) {
  if (k == 0) return 0;
  if (path == kAuto) path = window_entropy_plan(k);
  const auto f = static_cast<const float*>(frame);
  const auto x = static_cast<const int32_t*>(cx);
  const auto y = static_cast<const int32_t*>(cy);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto o = static_cast<float*>(out);
  if (path == kWide) {
    window_entropy_kernel<<<k, kWideThreads, 0, s>>>(f, h, w, x, y, k, o);
  } else if (path == kWarp) {
    const int needed = (k + kWarpWarps - 1) / kWarpWarps;
    const int at_once = ctas_at_once(false);
    const int grid = at_once > 0 && at_once < needed ? at_once : needed;
    window_entropy_kernel_warps<<<grid, kWarpThreads, 0, s>>>(f, h, w, x, y, k, o);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
