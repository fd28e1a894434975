// The fixed-point per-window chain in one launch per block of windows.
//
// Replaces the TPU kernel repro/kernels/window_pipeline.py:window_pipeline
// (one grid step per window; pairwise (E, E) compare blocks, one-hot MXU
// matmuls for the cell and patch scatters, K unrolled max passes). Here
// one CTA of 256 threads owns one window, and each step does what the
// function needs, not a pass over every pair of events or every cell:
//
//   1. load and mask: x, y, t into shared memory; keep only the events
//      that are both ROI-valid and in-sensor. Dropping the out-of-sensor
//      ones changes no output: such an event is never a w event (w =
//      kept & in-sensor), and it never shares a pixel with an in-sensor
//      event, so it cannot change an in-sensor event's hot-pixel count.
//   2. one block-wide bitonic sort of the kept events' keys (cell, pixel,
//      event index), the cell being the clipped index of
//      core/fixed_point.py:cell_stats_fixed. The pixel field is the
//      offset inside the cell where no in-sensor pixel is clipped (grid_w
//      * cell_size >= width and grid_h * cell_size >= height, as every
//      GridConfig has), else the whole index y * width + x, since then
//      clipping can put two pixels with one in-cell offset into one cell.
//      The key is 32 bits where its fields fit (every configuration of
//      the repo: 27-30 bits), else 64, else 128. Partners in a warp swap
//      by shuffles, partners in a thread in registers, the rest through
//      shared memory with one barrier a step.
//   3. pixel runs replace both pairwise passes: every event at one pixel
//      shares the ROI test, the sensor test and so the hot verdict. A run
//      of length r is kept iff r <= hot_pixel_max; each of its events
//      gets c = r, its first (lowest index) event leads; norm = max(max c,
//      1). Run starts and lengths come from one block scan of the run
//      flags; c, leader and the histogram bin go back to each event's
//      original position for the patch pass.
//   4. cell runs: one block scan of (w, w x, w y, w t) in sorted order;
//      a run's sums are its end's prefix less its start's exclusive one,
//      exact in uint32 as the reference's int32 sums wrap. No cell table.
//   5. top-K: a slot whose count is below min_events outputs constants
//      (count 0, cells -1, cq_* -256, origin clip(-1 - 24)), so valid
//      slots are a prefix of lax.top_k's order. Only the cells with count
//      >= max(min_events, 1) are ranked, by a sort of (E - count, cell
//      run) in 32 bits: runs are in cell order, so ties go to the lower
//      cell. With min_events <= 0 the slots after them take the cells
//      with no counted event, lowest first, as top_k does.
//   6. per valid slot: the 48x48 patch, with a zero border so the Sobel
//      reads need no bounds test, and the 32-bin leader histogram by
//      shared-memory atomics; then 240 threads each run down a column of
//      one 10-row band (a warp reads consecutive words of a patch row),
//      keeping a separable 3x3 window and their g2 values in registers
//      for the edge test after the block max. Three barriers a slot.
//
// Integer arithmetic: the reference divides with floor semantics (JAX
// //), C with truncation. They differ only for a negative dividend; the
// divisions here floor explicitly where one could be negative (the
// centroid of negative times) and divide non-negative values elsewhere.
// The int32 bounds are those of repro/core/fixed_point.py:15-27. isqrt is
// exact: the float32 estimate is corrected by one step each way.
//
// Invalid slots skip step 6 and write zero surfaces: the epilogue masks
// their metrics to 0, so what the kernel must match is the cluster
// fields, the six metrics and the surfaces of valid slots.
//
// What bounds it on the H100, counted by what the function needs: the
// bytes, 9 per event plus t of each kept event in, 9 ints per slot, norm
// per window and 37 ints per valid slot out (about 17 MB at the main
// path's block of 4,096 windows of 256 events, 0.005 ms), and the integer
// work, led by about 4e4 operations per 48x48 patch of a valid slot and
// the sort per window (chip_smoke.py:time_window_pipeline). Shared
// memory: 36 bytes an event plus two key buffers, and 12 KB for the
// patch and the reductions (about 23 KB at E = 256).
//
// Output: fields (W, 9, K) int32 in the order count, cell_x, cell_y,
// cq_x, cq_y, cq_t, x0, y0, valid; norm (W,) int32; surf (W, K, 37)
// int32: the 32 histogram bins, then s1, s2, s_g, s_e2, edges.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_sort.cuh"

namespace {

constexpr int kWin = 48;
constexpr int kPad = kWin + 2;  // the patch with a zero border
constexpr int kPix = kWin * kWin;
constexpr int kBins = 32;
constexpr int kSurf = kBins + 5;
constexpr int kFields = 9;
constexpr int kMaxEvents = 1024;
constexpr int kMaxSlots = 128;
constexpr int kCentroidOne = 256;  // UQ10.8
constexpr int kBandRows = 10;      // Sobel: 48 columns x 5 bands of <= 10 rows
constexpr int kBandThreads = kWin * ((kWin + kBandRows - 1) / kBandRows);
constexpr int kLead = 1 << 11;     // info word: c (bits 0-10), leader, bin << 12

struct Params {
  int n_events;
  int rx0, ry0, rx1, ry1;
  int hot_pixel_max;
  int cell_size, shift;  // shift >= 0 for power-of-two cells
  int grid_w, n_cells;
  int min_events, k;
  int width, height;
  int in_cell;       // pixel field: offset inside the cell (1) or whole index (0)
  int ebits, obits;  // key = cell << (obits + ebits) | pixel << ebits | index
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

// Exact floor square root for 0 <= v < 2^26 (g2 <= 32 * 1024^2): the
// estimate v * rsqrt(v) is within 0.01 of sqrt(v) there, so one integer
// correction each way pins it.
__device__ __forceinline__ int isqrt(int v) {
  const float f = __int2float_rn(v);
  int r = v > 0 ? __float2int_rz(f * rsqrtf(f)) : 0;
  if (r * r > v) --r;
  if ((r + 1) * (r + 1) <= v) ++r;
  return r;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <typename Key>
__device__ __forceinline__ Key event_key(int xi, int yi, int i, const Params& p) {
  // In-sensor coordinates are non-negative: shift and division floor.
  const int cx = p.shift >= 0 ? (xi >> p.shift) : xi / p.cell_size;
  const int cy = p.shift >= 0 ? (yi >> p.shift) : yi / p.cell_size;
  const int cell = min(cy * p.grid_w + cx, p.n_cells - 1);
  const unsigned long long pix =
      p.in_cell ? static_cast<unsigned long long>(yi - cy * p.cell_size) * p.cell_size +
                      (xi - cx * p.cell_size)
                : static_cast<unsigned long long>(yi) * p.width + xi;
  return (static_cast<Key>(cell) << (p.obits + p.ebits)) |
         (static_cast<Key>(pix) << p.ebits) | static_cast<Key>(i);
}

template <typename Key, int Items>
__global__ void __launch_bounds__(kThreads) window_pipeline_kernel(
    const int32_t* __restrict__ x, const int32_t* __restrict__ y,
    const int32_t* __restrict__ t, const uint8_t* __restrict__ valid,
    const Params p, int32_t* __restrict__ fields, int32_t* __restrict__ norm_out,
    int32_t* __restrict__ surf) {
  // Dynamic: two key buffers of sort_size(E) keys; x, y, t and the info
  // word (c, leader, bin) by event index; count, sums and cell by cell run.
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = p.n_events;
  const int n_max = sort_size(E);
  Key* kbuf0 = reinterpret_cast<Key*>(smem);
  Key* kbuf1 = kbuf0 + n_max;
  int* ex = reinterpret_cast<int*>(kbuf1 + n_max);
  int* ey = ex + E;
  int* et = ey + E;
  int* info = et + E;
  uint32_t* run_n = reinterpret_cast<uint32_t*>(info + E);
  uint32_t* run_x = run_n + E;
  uint32_t* run_y = run_x + E;
  uint32_t* run_t = run_y + E;
  int* run_cell = reinterpret_cast<int*>(run_t + E);

  __shared__ __align__(16) int patch[kPad * kPad];
  __shared__ int hist[kBins];
  __shared__ uint32_t wsum[Items * kWarps * 4];
  __shared__ int red[7][kWarps];  // s1, s2, occ, s_g, s_e2, max g2, edges
  __shared__ int sl_x0[kMaxSlots], sl_y0[kMaxSlots];
  __shared__ int s_kept, s_cand, s_cmax;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long win = blockIdx.x;
  const long long base = win * E;

  if (tid == 0) {
    s_kept = 0;
    s_cand = 0;
    s_cmax = 0;
  }
  if (tid < kBins) hist[tid] = 0;
  for (int q = tid; q < kPad * kPad / 4; q += kThreads)
    reinterpret_cast<int4*>(patch)[q] = make_int4(0, 0, 0, 0);
  __syncthreads();

  // 1. Load; the kept events' keys go to kbuf0 in any order.
  for (int it = 0; it * kThreads < E; ++it) {
    const int i = it * kThreads + tid;
    bool kept = false;
    Key key = 0;
    if (i < E) {
      const int xi = x[base + i];
      const int yi = y[base + i];
      ex[i] = xi;
      ey[i] = yi;
      et[i] = t[base + i];
      info[i] = 0;
      kept = valid[base + i] && xi >= p.rx0 && xi < p.rx1 && yi >= p.ry0 && yi < p.ry1 &&
             xi >= 0 && xi < p.width && yi >= 0 && yi < p.height;
      if (kept) key = event_key<Key>(xi, yi, i, p);
    }
    warp_append(kept, key, kbuf0, &s_kept);
  }
  __syncthreads();
  const int nk = s_kept;

  int n_runs = 0;  // cell runs
  int n_cand = 0;  // cells with count >= max(min_events, 1)
  const uint32_t* top = nullptr;
  if (nk > 0) {
    // 2. Sort the kept keys.
    const int n = sort_size(nk);
    const int items = n > kThreads ? n / kThreads : 1;
    Key v[Items];
#pragma unroll
    for (int it = 0; it < Items; ++it) {
      const int e = it * kThreads + tid;
      v[it] = e < nk ? kbuf0[e] : ~static_cast<Key>(0);
    }
    __syncthreads();
    PingPong<Key> pp{{kbuf0, kbuf1}, 0};
    bitonic_sort<Key, Items>(v, n, pp);
    Key* sk = pp.take();
#pragma unroll
    for (int it = 0; it < Items; ++it) {
      const int e = it * kThreads + tid;
      if (it < items && e < nk) sk[e] = v[it];
    }
    __syncthreads();

    // 3. Pixel and cell runs: start flags, then ranks by a block scan.
    const int cshift = p.obits + p.ebits;
    const Key emask = (static_cast<Key>(1) << p.ebits) - 1;
    uint32_t f[Items][2];
    bool pst[Items], pend[Items], cst[Items], cend[Items];
#pragma unroll
    for (int it = 0; it < Items; ++it) {
      const int e = it * kThreads + tid;
      f[it][0] = f[it][1] = 0;
      pst[it] = pend[it] = cst[it] = cend[it] = false;
      if (it < items && e < nk) {
        const Key cur = v[it];
        const bool first = e == 0, last = e == nk - 1;
        const Key prev = first ? cur : sk[e - 1];
        const Key next = last ? cur : sk[e + 1];
        pst[it] = first || (prev >> p.ebits) != (cur >> p.ebits);
        pend[it] = last || (next >> p.ebits) != (cur >> p.ebits);
        cst[it] = first || (prev >> cshift) != (cur >> cshift);
        cend[it] = last || (next >> cshift) != (cur >> cshift);
        f[it][0] = pst[it];
        f[it][1] = cst[it];
      }
    }
    uint32_t tot1[2];
    block_scan<2, Items>(f, items, wsum, tot1);
    n_runs = static_cast<int>(tot1[1]);
    // The key buffers are free after the scan's barrier.
    int* run_lo = reinterpret_cast<int*>(kbuf0);
    int* run_hi = reinterpret_cast<int*>(kbuf1);
#pragma unroll
    for (int it = 0; it < Items; ++it) {
      const int e = it * kThreads + tid;
      if (pst[it]) run_lo[f[it][0] - 1] = e;
      if (pend[it]) run_hi[f[it][0] - 1] = e;
    }
    __syncthreads();

    // Hot verdict and c per pixel run; the cell sums' scan.
    int c[Items];
    int cmax = 0;
    uint32_t s[Items][4];
#pragma unroll
    for (int it = 0; it < Items; ++it) {
      const int e = it * kThreads + tid;
      c[it] = 0;
      s[it][0] = s[it][1] = s[it][2] = s[it][3] = 0;
      if (it < items && e < nk) {
        const int r = run_hi[f[it][0] - 1] - run_lo[f[it][0] - 1] + 1;
        if (r <= p.hot_pixel_max) {
          const int i = static_cast<int>(v[it] & emask);
          c[it] = r;
          s[it][0] = 1;
          s[it][1] = ex[i];
          s[it][2] = ey[i];
          s[it][3] = et[i];
          cmax = max(cmax, r);
        }
      }
    }
    cmax = warp_max(cmax);
    if (lane == 0 && cmax > 0) atomicMax(&s_cmax, cmax);
    uint32_t tot2[4];
    block_scan<4, Items>(s, items, wsum, tot2);
    const int norm = max(s_cmax, 1);

    // 4. Each cell run's start leaves its exclusive prefix; each w event
    //    its info word at its original position.
#pragma unroll
    for (int it = 0; it < Items; ++it) {
      const int e = it * kThreads + tid;
      if (!(it < items && e < nk)) continue;
      const int i = static_cast<int>(v[it] & emask);
      const int rk = static_cast<int>(f[it][1]) - 1;
      if (cst[it]) {
        const bool w = c[it] > 0;
        run_n[rk] = s[it][0] - (w ? 1u : 0u);
        run_x[rk] = s[it][1] - (w ? static_cast<uint32_t>(ex[i]) : 0u);
        run_y[rk] = s[it][2] - (w ? static_cast<uint32_t>(ey[i]) : 0u);
        run_t[rk] = s[it][3] - (w ? static_cast<uint32_t>(et[i]) : 0u);
        run_cell[rk] = static_cast<int>(v[it] >> cshift);
      }
      if (c[it] > 0) {
        // c <= norm, so the bin (c * 32) / norm needs no floor fix-up.
        info[i] = c[it] | (pst[it] ? kLead : 0) | (min(c[it] * kBins / norm, kBins - 1) << 12);
      }
    }
    __syncthreads();

    // Each cell run's end: its sums, and a candidate when counted.
    uint32_t* cand = reinterpret_cast<uint32_t*>(kbuf0);
    const int floor_n = max(p.min_events, 1);
#pragma unroll
    for (int it = 0; it < Items; ++it) {
      if (!cend[it]) continue;
      const int rk = static_cast<int>(f[it][1]) - 1;
      const uint32_t cnt = s[it][0] - run_n[rk];
      run_n[rk] = cnt;
      run_x[rk] = s[it][1] - run_x[rk];
      run_y[rk] = s[it][2] - run_y[rk];
      run_t[rk] = s[it][3] - run_t[rk];
      if (static_cast<int>(cnt) >= floor_n)
        cand[atomicAdd(&s_cand, 1)] =
            (static_cast<uint32_t>(E - static_cast<int>(cnt)) << p.ebits) | static_cast<uint32_t>(rk);
    }
    if (tid == 0) norm_out[win] = norm;
    __syncthreads();

    // 5. Rank the candidates: (count descending, cell ascending).
    n_cand = s_cand;
    if (n_cand > 0) {
      const int n2 = sort_size(n_cand);
      uint32_t cv[Items];
#pragma unroll
      for (int it = 0; it < Items; ++it) {
        const int e = it * kThreads + tid;
        cv[it] = e < n_cand ? cand[e] : kFull;
      }
      __syncthreads();
      PingPong<uint32_t> pc{{reinterpret_cast<uint32_t*>(kbuf0), reinterpret_cast<uint32_t*>(kbuf1)}, 0};
      bitonic_sort<uint32_t, Items>(cv, n2, pc);
      uint32_t* out = pc.take();
      const int n_top = min(n_cand, p.k);
#pragma unroll
      for (int it = 0; it < Items; ++it) {
        const int e = it * kThreads + tid;
        if (e < n_top) out[e] = cv[it];
      }
      top = out;
      __syncthreads();
    }
  } else if (tid == 0) {
    norm_out[win] = 1;
  }

  // Slot fields. Valid slots are a prefix: the ranked cells, then (with
  // min_events <= 0) the cells without a counted event.
  const int n_top = min(n_cand, p.k);
  const int n_valid = p.min_events <= 0 ? p.k : n_top;
  int32_t* fo = fields + win * kFields * p.k;
  for (int sl = tid; sl < p.k; sl += kThreads) {
    int n = 0, cell = -1;
    int sx = 0, sy = 0, st = 0;
    const bool ok = sl < n_valid;
    if (sl < n_top) {
      const uint32_t key = top[sl];
      const int rk = static_cast<int>(key & ((1u << p.ebits) - 1u));
      n = E - static_cast<int>(key >> p.ebits);
      cell = run_cell[rk];
      sx = static_cast<int>(run_x[rk]);
      sy = static_cast<int>(run_y[rk]);
      st = static_cast<int>(run_t[rk]);
    } else if (ok) {  // the (sl - n_top)-th cell with no counted event
      cell = sl - n_top;
      for (int r = 0; r < n_runs; ++r)
        if (run_n[r] > 0 && run_cell[r] <= cell) ++cell;
    }
    const int den = max(n, 1);
    const int ox = ok ? round_div_half_even(sx, den) : -1;
    const int oy = ok ? round_div_half_even(sy, den) : -1;
    const int x0 = min(max(ox - kWin / 2, 0), p.width - kWin);
    const int y0 = min(max(oy - kWin / 2, 0), p.height - kWin);
    fo[0 * p.k + sl] = ok ? n : 0;
    fo[1 * p.k + sl] = ok ? cell % p.grid_w : -1;
    fo[2 * p.k + sl] = ok ? cell / p.grid_w : -1;
    fo[3 * p.k + sl] = ok ? q8(sx, den) : -kCentroidOne;
    fo[4 * p.k + sl] = ok ? q8(sy, den) : -kCentroidOne;
    fo[5 * p.k + sl] = ok ? q8(st, den) : -kCentroidOne;
    fo[6 * p.k + sl] = x0;
    fo[7 * p.k + sl] = y0;
    fo[8 * p.k + sl] = ok;
    sl_x0[sl] = x0;
    sl_y0[sl] = y0;
  }
  int32_t* sw = surf + win * p.k * kSurf;
  for (int q = tid; q < (p.k - n_valid) * kSurf; q += kThreads) sw[n_valid * kSurf + q] = 0;
  __syncthreads();

  // 6. Per valid slot: patch, histogram, Sobel, moments.
  for (int sl = 0; sl < n_valid; ++sl) {
    const int x0 = sl_x0[sl], y0 = sl_y0[sl];
    int s1 = 0, s2 = 0, occ = 0;
    for (int i = tid; i < E; i += kThreads) {
      const int inf = info[i];
      if (!inf) continue;
      const int rx = ex[i] - x0;
      const int ry = ey[i] - y0;
      if (static_cast<unsigned>(rx) >= kWin || static_cast<unsigned>(ry) >= kWin) continue;
      atomicAdd(&patch[(ry + 1) * kPad + rx + 1], 1);
      ++s1;
      if (inf & kLead) {
        const int c = inf & (kLead - 1);
        ++occ;
        s2 += c * c;
        atomicAdd(&hist[inf >> 12], 1);
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    occ = warp_sum(occ);
    if (lane == 0) {
      red[0][warp] = s1;
      red[1][warp] = s2;
      red[2][warp] = occ;
    }
    __syncthreads();

    // Separable 3x3: per row h = right - left and s = left + 2 mid +
    // right; gx = h(up) + 2 h(mid) + h(down), gy = s(down) - s(up).
    int g2v[kBandRows];
    int sg = 0, se2 = 0, mx = 0;
#pragma unroll
    for (int j = 0; j < kBandRows; ++j) g2v[j] = 0;
    if (tid < kBandThreads) {
      const int col = tid % kWin;
      const int r0 = (tid / kWin) * kBandRows;
      const int* q = patch + r0 * kPad + col;  // padded row r0 = patch row r0 - 1
      int hu = q[2] - q[0], su = q[0] + 2 * q[1] + q[2];
      int hm = q[kPad + 2] - q[kPad], sm = q[kPad] + 2 * q[kPad + 1] + q[kPad + 2];
#pragma unroll
      for (int j = 0; j < kBandRows; ++j) {
        if (r0 + j < kWin) {
          const int* d = q + (j + 2) * kPad;
          const int hd = d[2] - d[0], sd = d[0] + 2 * d[1] + d[2];
          const int gx = hu + 2 * hm + hd;
          const int gy = sd - su;
          const int g2 = gx * gx + gy * gy;
          g2v[j] = g2;
          sg += isqrt(g2);
          se2 += g2;
          mx = max(mx, g2);
          hu = hm;
          su = sm;
          hm = hd;
          sm = sd;
        }
      }
    }
    sg = warp_sum(sg);
    se2 = warp_sum(se2);
    mx = warp_max(mx);
    if (lane == 0) {
      red[3][warp] = sg;
      red[4][warp] = se2;
      red[5][warp] = mx;
    }
    __syncthreads();

    int g2max = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) g2max = max(g2max, red[5][w]);
    int edges = 0;
#pragma unroll
    for (int j = 0; j < kBandRows; ++j) edges += 16 * g2v[j] > g2max ? 1 : 0;
    edges = warp_sum(edges);
    if (lane == 0) red[6][warp] = edges;
    int32_t* so = sw + sl * kSurf;
    if (tid < kBins) {
      int occ_all = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) occ_all += red[2][w];
      so[tid] = hist[tid] + (tid == 0 ? kPix - occ_all : 0);
      hist[tid] = 0;
    } else if (tid < kBins + 4) {  // s1, s2, s_g, s_e2
      const int f = tid - kBins;
      const int row = f < 2 ? f : f + 1;
      int sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[row][w];
      so[tid] = sum;
    }
    for (int q = tid; q < kPad * kPad / 4; q += kThreads)
      reinterpret_cast<int4*>(patch)[q] = make_int4(0, 0, 0, 0);
    __syncthreads();
    if (tid == kBins + 4) {
      int sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[6][w];
      so[tid] = sum;
    }
  }
}

int bit_length(unsigned long long v) {
  int b = 0;
  while (v) {
    ++b;
    v >>= 1;
  }
  return b;
}

template <typename Key, int Items>
int launch(const Params& p, int n_windows, const void* x, const void* y, const void* t,
           const void* valid, void* fields, void* norm, void* surf, cudaStream_t stream) {
  const int n_max = sort_size(p.n_events);
  const size_t smem = 2 * static_cast<size_t>(n_max) * sizeof(Key) +
                      9 * static_cast<size_t>(p.n_events) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(window_pipeline_kernel<Key, Items>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_windows == 0) return 0;
  window_pipeline_kernel<Key, Items><<<n_windows, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<const int32_t*>(t), static_cast<const uint8_t*>(valid), p,
      static_cast<int32_t*>(fields), static_cast<int32_t*>(norm), static_cast<int32_t*>(surf));
  return static_cast<int>(cudaGetLastError());
}

template <typename Key>
int launch_items(const Params& p, int n_windows, const void* x, const void* y, const void* t,
                 const void* valid, void* fields, void* norm, void* surf, cudaStream_t stream) {
  return p.n_events <= kThreads
             ? launch<Key, 1>(p, n_windows, x, y, t, valid, fields, norm, surf, stream)
             : launch<Key, kMaxEvents / kThreads>(p, n_windows, x, y, t, valid, fields, norm,
                                                  surf, stream);
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
  const long long cs = cell_size;
  p.in_cell = static_cast<long long>(grid_w) * cs >= width &&
              static_cast<long long>(grid_h) * cs >= height;
  const long long pixels = p.in_cell ? cs * cs
                                     : static_cast<long long>(width > 1 ? width : 1) *
                                           (height > 1 ? height : 1);
  p.ebits = bit_length(n_events > 0 ? n_events - 1 : 0);
  p.obits = bit_length(static_cast<unsigned long long>(pixels - 1));
  const int bits = bit_length(n_cells - 1) + p.obits + p.ebits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits < 32)
    return launch_items<uint32_t>(p, n_windows, x, y, t, valid, fields, norm, surf, st);
  if (bits < 64)
    return launch_items<unsigned long long>(p, n_windows, x, y, t, valid, fields, norm, surf, st);
  return launch_items<unsigned __int128>(p, n_windows, x, y, t, valid, fields, norm, surf, st);
}
