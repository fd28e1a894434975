// The fixed-point per-window chain in one launch per block of windows.
//
// Replaces the TPU kernel repro/kernels/window_pipeline.py:window_pipeline
// (one grid step per window; pairwise (E, E) compare blocks, one-hot MXU
// matmuls for the cell and patch scatters, K unrolled max passes). Here
// one CTA of 256 threads owns one window and keeps all of it in shared
// memory:
//
//   1. the window's events (x, y, t, coincidence count, three flag
//      bytes): 19 bytes an event, at most 1,024 events;
//   2. conditioning: the ROI mask, then two pairwise passes over shared
//      memory: the hot-pixel count over ROI-valid events, then, after
//      that mask, the coincidence count c over w = valid & in-sensor and
//      the leader flag (no earlier same-pixel w event); norm = max(max c, 1)
//      by a block reduction;
//   3. the 4-stat cell histogram (count, sum x, sum y, sum t) with
//      shared-memory int32 atomics, masked and clipped as the staged path
//      (repro_torch/core/fixed_point.py:cell_stats_fixed): n_cells x 16
//      bytes, 19 KB at 16 px cells, 35 KB at 12 px;
//   4. top-K by K block-wide arg-max passes over the key (count
//      descending, index ascending), lax.top_k's tie order: with fewer
//      than K non-zero cells the last slots take the lowest-index cells
//      left; then the UQ10.8 centroids and the round-half-even patch
//      origins, all in int32;
//   5. per valid slot: the 48x48 int32 patch and the 32-bin leader
//      histogram (bin (c * 32) / norm) by shared-memory atomics, s1 and
//      s2 = sum of leader c^2, the integer Sobel into a second 48x48 array
//      and its block max, then a pass for the edge count 16 * g2 > max,
//      s_g = sum isqrt(g2) and s_e2 = sum g2.
//
// Integer arithmetic: the reference divides with floor semantics (JAX
// //), C with truncation. They differ only for a negative dividend; the
// divisions here floor explicitly where one could be negative (the
// centroid of negative times) and divide non-negative values elsewhere
// (in-sensor coordinates, counts). The int32 bounds are those of
// repro/core/fixed_point.py:15-27. isqrt is exact: the float32 sqrt is
// corrected by one step each way; no fast math.
//
// Invalid slots skip step 5 and write zero surfaces: the epilogue masks
// their metrics to 0, so what the kernel must match is the cluster
// fields, the six metrics and the surfaces of valid slots.
//
// What bounds it on the H100, counted by what the function needs (not by
// this kernel's loops): the bytes, 9 per event plus t of each kept event
// in, 9 ints per slot, norm per window and 37 ints per valid slot out
// (about 17 MB at the main path's block of 4,096 windows of 256 events,
// 0.005 ms), and the integer work, which is led by about 4e4 operations
// per 48x48 patch of a valid slot; hot-pixel and coincidence counts need
// only a sort per window and top-K one selection pass over the cells
// (about 0.007 ms at the 32-bit integer rate). This first version is far
// from both: its two pairwise passes do about 4 E^2 operations a
// window, its K arg-max passes K times the cells, and each CTA runs its
// steps one after another (two barriers per arg-max pass, five per
// valid slot).
//
// Output: fields (W, 9, K) int32 in the order count, cell_x, cell_y,
// cq_x, cq_y, cq_t, x0, y0, valid; norm (W,) int32; surf (W, K, 37)
// int32: the 32 histogram bins, then s1, s2, s_g, s_e2, edges.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWin = 48;
constexpr int kPix = kWin * kWin;
constexpr int kBins = 32;
constexpr int kSurf = kBins + 5;
constexpr int kFields = 9;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxEvents = 1024;
constexpr int kMaxSlots = 128;
constexpr int kCentroidOne = 256;  // UQ10.8

struct Params {
  int n_events;
  int rx0, ry0, rx1, ry1;
  int hot_pixel_max;
  int cell_size, shift;  // shift >= 0 for power-of-two cells
  int grid_w, n_cells;
  int min_events, k;
  int width, height;
};

// Floor division for den > 0 (JAX's //).
__device__ __forceinline__ int floor_div(int num, int den) {
  int q = num / den;
  if (num - q * den < 0) --q;
  return q;
}

// Round-half-to-even division for den > 0
// (repro/core/fixed_point.py:round_div_half_even).
__device__ __forceinline__ int round_div_half_even(int num, int den) {
  const int q = floor_div(num, den);
  const int two_r = 2 * (num - q * den);
  return q + ((two_r > den || (two_r == den && (q & 1))) ? 1 : 0);
}

// UQ.8 mean in the split form q * 2^8 + rdiv(r * 2^8, den).
__device__ __forceinline__ int q8(int s, int den) {
  const int q = floor_div(s, den);
  return q * kCentroidOne + round_div_half_even((s - q * den) * kCentroidOne, den);
}

__device__ __forceinline__ int isqrt(int v) {
  int r = static_cast<int>(floorf(__fsqrt_rn(__int2float_rn(v))));
  if (r * r > v) --r;
  if ((r + 1) * (r + 1) <= v) ++r;
  return r;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ unsigned long long warp_max_u64(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  return v;
}

__device__ __forceinline__ int patch_at(const int* patch, int r, int q) {
  return (r >= 0 && r < kWin && q >= 0 && q < kWin) ? patch[r * kWin + q] : 0;
}

__global__ void __launch_bounds__(kThreads) window_pipeline_kernel(
    const int32_t* __restrict__ x, const int32_t* __restrict__ y,
    const int32_t* __restrict__ t, const uint8_t* __restrict__ valid,
    const Params p, int32_t* __restrict__ fields, int32_t* __restrict__ norm_out,
    int32_t* __restrict__ surf) {
  // Dynamic: cell stats [4][n_cells], events x, y, t, c [E], flags [3][E].
  extern __shared__ __align__(16) int dyn[];
  int* cnt = dyn;
  int* csx = cnt + p.n_cells;
  int* csy = csx + p.n_cells;
  int* cst = csy + p.n_cells;
  const int E = p.n_events;
  int* ex = cst + p.n_cells;
  int* ey = ex + E;
  int* et = ey + E;
  int* ec = et + E;
  uint8_t* roi = reinterpret_cast<uint8_t*>(ec + E);
  uint8_t* ew = roi + E;
  uint8_t* lead = ew + E;

  __shared__ int patch[kPix];
  __shared__ int g2s[kPix];
  __shared__ int hist[kBins];
  __shared__ int sl_cnt[kMaxSlots], sl_idx[kMaxSlots];
  __shared__ int sl_x0[kMaxSlots], sl_y0[kMaxSlots], sl_valid[kMaxSlots];
  __shared__ unsigned long long red_key[kWarps];
  // norm, s1, s2, occ, g2max, edges, s_g, s_e2
  __shared__ int acc[8];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long win = blockIdx.x;
  const long long base = win * E;

  // 1. Load the window; ROI mask; zero the cell stats.
  for (int i = tid; i < E; i += kThreads) {
    const int xi = x[base + i];
    const int yi = y[base + i];
    ex[i] = xi;
    ey[i] = yi;
    et[i] = t[base + i];
    roi[i] = valid[base + i] && xi >= p.rx0 && xi < p.rx1 && yi >= p.ry0 && yi < p.ry1;
  }
  for (int c = tid; c < 4 * p.n_cells; c += kThreads) cnt[c] = 0;
  if (tid == 0) acc[0] = 0;
  __syncthreads();

  // 2a. Hot-pixel filter over ROI-valid events, then w = kept & in-sensor.
  for (int i = tid; i < E; i += kThreads) {
    bool w = false;
    if (roi[i]) {
      const int xi = ex[i], yi = ey[i];
      int hot = 0;
      for (int j = 0; j < E; ++j) hot += (roi[j] && ex[j] == xi && ey[j] == yi) ? 1 : 0;
      w = hot <= p.hot_pixel_max && xi >= 0 && xi < p.width && yi >= 0 && yi < p.height;
    }
    ew[i] = w;
  }
  __syncthreads();

  // 2b. Coincidence counts and leaders over w events; cell stats.
  int cmax = 0;
  for (int i = tid; i < E; i += kThreads) {
    int c = 0;
    bool first = false;
    if (ew[i]) {
      const int xi = ex[i], yi = ey[i];
      int before = 0;
      for (int j = 0; j < i; ++j) before += (ew[j] && ex[j] == xi && ey[j] == yi) ? 1 : 0;
      c = before;
      for (int j = i; j < E; ++j) c += (ew[j] && ex[j] == xi && ey[j] == yi) ? 1 : 0;
      first = before == 0;
      cmax = max(cmax, c);
      // In-sensor coordinates are non-negative: shift and division floor.
      const int cx = p.shift >= 0 ? (xi >> p.shift) : xi / p.cell_size;
      const int cy = p.shift >= 0 ? (yi >> p.shift) : yi / p.cell_size;
      const int cell = min(max(cy * p.grid_w + cx, 0), p.n_cells - 1);
      atomicAdd(&cnt[cell], 1);
      atomicAdd(&csx[cell], xi);
      atomicAdd(&csy[cell], yi);
      atomicAdd(&cst[cell], et[i]);
    }
    ec[i] = c;
    lead[i] = first;
  }
  cmax = warp_max(cmax);
  if (lane == 0) atomicMax(&acc[0], cmax);
  __syncthreads();
  const int norm = max(acc[0], 1);
  if (tid == 0) norm_out[win] = norm;

  // 3. Top-K: K arg-max passes over (count + 1) << 32 | ~index; a taken
  //    cell's count is set to -1, so its key falls below every other.
  for (int s = 0; s < p.k; ++s) {
    unsigned long long best = 0ull;
    for (int c = tid; c < p.n_cells; c += kThreads) {
      const unsigned long long key =
          (static_cast<unsigned long long>(cnt[c] + 1) << 32) |
          static_cast<unsigned int>(~c);
      best = key > best ? key : best;
    }
    best = warp_max_u64(best);
    if (lane == 0) red_key[warp] = best;
    __syncthreads();
    if (tid == 0) {  // best already holds warp 0's maximum
      for (int v = 1; v < kWarps; ++v) best = red_key[v] > best ? red_key[v] : best;
      const int idx = static_cast<int>(~static_cast<unsigned int>(best & 0xffffffffull));
      sl_cnt[s] = static_cast<int>(best >> 32) - 1;
      sl_idx[s] = idx;
      cnt[idx] = -1;
    }
    __syncthreads();
  }

  // 4. Slot fields.
  int32_t* fo = fields + win * kFields * p.k;
  for (int s = tid; s < p.k; s += kThreads) {
    const int n = sl_cnt[s];
    const int idx = sl_idx[s];
    const bool ok = n >= p.min_events;
    const int den = max(n, 1);
    const int ox = ok ? round_div_half_even(csx[idx], den) : -1;
    const int oy = ok ? round_div_half_even(csy[idx], den) : -1;
    const int x0 = min(max(ox - kWin / 2, 0), p.width - kWin);
    const int y0 = min(max(oy - kWin / 2, 0), p.height - kWin);
    fo[0 * p.k + s] = ok ? n : 0;
    fo[1 * p.k + s] = ok ? idx % p.grid_w : -1;
    fo[2 * p.k + s] = ok ? idx / p.grid_w : -1;
    fo[3 * p.k + s] = ok ? q8(csx[idx], den) : -kCentroidOne;
    fo[4 * p.k + s] = ok ? q8(csy[idx], den) : -kCentroidOne;
    fo[5 * p.k + s] = ok ? q8(cst[idx], den) : -kCentroidOne;
    fo[6 * p.k + s] = x0;
    fo[7 * p.k + s] = y0;
    fo[8 * p.k + s] = ok;
    sl_x0[s] = x0;
    sl_y0[s] = y0;
    sl_valid[s] = ok;
  }
  __syncthreads();

  // 5. Per valid slot: patch, histogram, Sobel, moments.
  for (int s = 0; s < p.k; ++s) {
    int32_t* so = surf + (win * p.k + s) * kSurf;
    if (!sl_valid[s]) {  // uniform over the block
      if (tid < kSurf) so[tid] = 0;
      continue;
    }
    for (int q = tid; q < kPix; q += kThreads) patch[q] = 0;
    if (tid < kBins) hist[tid] = 0;
    if (tid < 8) acc[tid] = 0;
    __syncthreads();

    const int x0 = sl_x0[s], y0 = sl_y0[s];
    int s1 = 0, s2 = 0, occ = 0;
    for (int i = tid; i < E; i += kThreads) {
      if (!ew[i]) continue;
      const int rx = ex[i] - x0;
      const int ry = ey[i] - y0;
      if (rx < 0 || rx >= kWin || ry < 0 || ry >= kWin) continue;
      atomicAdd(&patch[ry * kWin + rx], 1);
      ++s1;
      if (lead[i]) {
        const int c = ec[i];  // >= 1, and norm >= 1: no negative division
        ++occ;
        s2 += c * c;
        atomicAdd(&hist[min(c * kBins / norm, kBins - 1)], 1);
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    occ = warp_sum(occ);
    if (lane == 0) {
      atomicAdd(&acc[1], s1);
      atomicAdd(&acc[2], s2);
      atomicAdd(&acc[3], occ);
    }
    __syncthreads();

    int mx = 0;
    for (int q = tid; q < kPix; q += kThreads) {
      const int r = q / kWin;
      const int col = q - r * kWin;
      const int ul = patch_at(patch, r - 1, col - 1), up = patch_at(patch, r - 1, col);
      const int ur = patch_at(patch, r - 1, col + 1), left = patch_at(patch, r, col - 1);
      const int right = patch_at(patch, r, col + 1), dl = patch_at(patch, r + 1, col - 1);
      const int down = patch_at(patch, r + 1, col), dr = patch_at(patch, r + 1, col + 1);
      const int gx = (ur - ul) + 2 * (right - left) + (dr - dl);
      const int gy = (dl - ul) + 2 * (down - up) + (dr - ur);
      const int g2 = gx * gx + gy * gy;
      g2s[q] = g2;
      mx = max(mx, g2);
    }
    mx = warp_max(mx);
    if (lane == 0) atomicMax(&acc[4], mx);
    __syncthreads();

    const int g2max = acc[4];
    int edges = 0, s_g = 0, s_e2 = 0;
    for (int q = tid; q < kPix; q += kThreads) {
      const int g2 = g2s[q];
      edges += 16 * g2 > g2max ? 1 : 0;
      s_g += isqrt(g2);
      s_e2 += g2;
    }
    edges = warp_sum(edges);
    s_g = warp_sum(s_g);
    s_e2 = warp_sum(s_e2);
    if (lane == 0) {
      atomicAdd(&acc[5], edges);
      atomicAdd(&acc[6], s_g);
      atomicAdd(&acc[7], s_e2);
    }
    __syncthreads();

    if (tid < kBins) {
      so[tid] = hist[tid] + (tid == 0 ? kPix - acc[3] : 0);
    } else if (tid < kSurf) {
      const int f = tid - kBins;  // s1, s2, s_g, s_e2, edges
      so[tid] = f == 0 ? acc[1] : f == 1 ? acc[2] : f == 2 ? acc[6] : f == 3 ? acc[7] : acc[5];
    }
    __syncthreads();
  }
}

size_t smem_bytes(int n_cells, int n_events) {
  return static_cast<size_t>(n_cells) * 4 * sizeof(int) +
         static_cast<size_t>(n_events) * (4 * sizeof(int) + 3);
}

}  // namespace

// x, y, t: (n_windows, n_events) int32; valid: (n_windows, n_events) bool.
// fields: (n_windows, 9, k) int32; norm: (n_windows,) int32;
// surf: (n_windows, k, 37) int32.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int window_pipeline_launch(
    const void* x, const void* y, const void* t, const void* valid,
    int n_windows, int n_events, int rx0, int ry0, int rx1, int ry1,
    int hot_pixel_max, int cell_size, int grid_w, int grid_h,
    int min_events, int k, int width, int height, void* fields,
    void* norm, void* surf, void* stream) {
  const int n_cells = grid_w * grid_h;
  if (n_events < 0 || n_events > kMaxEvents || k < 1 || k > kMaxSlots ||
      k > n_cells || cell_size < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(n_cells, n_events);
  cudaError_t err = cudaFuncSetAttribute(
      window_pipeline_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_windows == 0) return 0;
  Params p;
  p.n_events = n_events;
  p.rx0 = rx0;
  p.ry0 = ry0;
  p.rx1 = rx1;
  p.ry1 = ry1;
  p.hot_pixel_max = hot_pixel_max;
  p.cell_size = cell_size;
  p.shift = -1;
  if ((cell_size & (cell_size - 1)) == 0) {
    p.shift = 0;
    while ((1 << p.shift) < cell_size) ++p.shift;
  }
  p.grid_w = grid_w;
  p.n_cells = n_cells;
  p.min_events = min_events;
  p.k = k;
  p.width = width;
  p.height = height;
  window_pipeline_kernel<<<n_windows, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<const int32_t*>(t), static_cast<const uint8_t*>(valid), p,
      static_cast<int32_t*>(fields), static_cast<int32_t*>(norm),
      static_cast<int32_t*>(surf));
  return static_cast<int>(cudaGetLastError());
}
