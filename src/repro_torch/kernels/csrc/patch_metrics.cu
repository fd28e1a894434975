// The metrics stage in one launch per block of windows: from each window's
// conditioned events and its K cluster slots to the six metrics of every
// slot.
//
// Replaces the TPU kernel repro/kernels/patch_metrics.py:patch_metrics
// (one grid step per cluster slot; the patch scatter and the histogram as
// one-hot MXU matmuls) and the event-space preprocessing the port ran in
// torch before it (core/metrics.py:event_normalizer, a pairwise (E, E)
// coincidence pass, and window_origin).
//
// Two paths, picked at launch from the sizes: the small one (E <= 1024,
// K <= 128: the main path's blocks, 1-2 valid slots a busy window) and
// the large one (any E, any K: fixed-time windows, dense sky, K past 128).
//
// The small path. Grid: one CTA of 256 threads per window, the window's
// valid slots one after another in it. A window with no valid slot writes
// zeros and exits, so no CTA is spent on an invalid slot; a block of 4,096
// windows (the scan's) is 4,096 CTAs, and a stream feed of 1-2 windows
// holds 2-4 valid slots, about a microsecond of work each, near the launch
// floor. Per window:
//
//   1. slots: validity, and each valid slot's patch origin
//      x0 = clip(rint(cx) - 24, 0, width - 48), rint rounding half to even
//      (__float2int_rn) as torch.round and jnp.round do; likewise y0.
//   2. load: x and y of every event into shared memory; the key (pixel,
//      event index) of each w event (valid and in-sensor) into a sort
//      buffer. An out-of-sensor event is never a w event and never shares
//      a pixel with one, so dropping it changes no count.
//   3. one block-wide bitonic sort of the keys in registers (32 bits at
//      every configuration of the repo: 19 pixel bits at 640 x 480 plus at
//      most 10 index bits; 64 bits for larger sensors). Pixel runs replace
//      the pairwise pass: every event of a run of length r has c = r, the
//      run's first (lowest index) event leads, norm = max(1, max c). Each
//      leader's bin trunc(c / norm * 32) is taken once, in float32 as the
//      reference does.
//   4. per valid slot: the 48x48 int32 patch (zero border, so the Sobel
//      reads need no bounds test) and the 32-bin leader histogram by
//      shared-memory atomics, reading the events from shared memory; then
//      each thread takes 9 pixels p = tid + 256 j: the Sobel in integers
//      (exact: |gx|, |gy| <= 2 * 1024, so gx*gx + gy*gy < 2^24 is the
//      float32 value the reference computes), e2 = g2 / norm^2 + 1e-12
//      and sqrt(e2) in round-to-nearest steps (no fused multiply-add, so
//      e2 is the reference's value to the bit; g2 = 0 gives e2 = 1e-12
//      exactly, and its square root is taken once), the e2 values kept in
//      registers for the edge test; block reductions of sum(sqrt(e2)),
//      sum(e2), max(e2) and the integer moments sum(c), sum(c*c);
//   5. the edge count against (0.25 * max(sqrt(max e2), 1e-3))^2; warp 0
//      takes the 32 histogram bins one a lane, and its lane 0 evaluates
//      the six metrics as the reference's
//      repro/core/metrics.py:_exact_cluster_metrics does. The bins are
//      summed by shuffles, not by one thread's loop.
//
// The float sums of step 4 run per thread over j, then by warp
// shuffles, then over the warps in order; the entropy terms of step 5 by
// shuffles over the 32 bins. Built without fast math, so division and
// sqrt are IEEE; log2f is within 1-2 ulp of libm, and the float sums run
// in another order than on the host: those two are why the entropies and
// contrast carry a tolerance in the tests (tests/test_torch_kernels.py
// models this order in numpy and holds it to that tolerance).
//
// The large path (patch_metrics_kernel_large). On a fixed-time window
// nearly every slot is valid (the scale recording's 100 ms stride windows:
// 4,096 events, 31.75 of 32 slots valid, 22 events and about 157 pixels
// with an event next to them in a patch on average), so it is built so
// that slots run side by side and a slot touches only its own events and
// pixels:
//
//   - Grid: ceil(K / g) CTAs of 256 threads a window, each taking g of its
//     slots, a valid slot a warp. g = 32 where the grid still fills the
//     card at 4 CTAs a SM (600 stride windows: 600 CTAs), else 16, else 8
//     (a few windows: more, shorter CTAs).
//   - Each CTA indexes the window's w events by sensor row: a count a row
//     (shared atomics), a block scan, then each event's x stored at its
//     row's cursor. Two passes over the events (the second reads them
//     again from device memory, mostly from L2) and no sort; the CTAs of
//     a window repeat it.
//   - norm: the largest count of one pixel, found within each row, a row
//     a lane: a lane counts repeats in a row of at most 32 events (an
//     event with no more than the running max after it is skipped), a
//     warp counts a longer row by x in counters laid over its patch table.
//     Then e2, sqrt(e2) of g2 < 128 and the bins of counts < 128 go to
//     lookup tables, the same IEEE values the Sobel would compute.
//   - Per slot, in its warp's own 50x50 table (uint16_t while E < 65,536,
//     else int32): lane l walks the events of patch rows l and l + 32
//     only, counts them into the table and marks a 48-bit occupancy word
//     a row. A pixel's count is its events' c, so each occupied pixel
//     adds its bin to the histogram (the reference's leader) and c, c*c to
//     the moments. The Sobel runs only at the candidate pixels, those with
//     an occupied pixel in their 3x3 neighbourhood (the occupancy words
//     dilated by a row and a column): every other pixel has gx = gy = 0,
//     e2 = 1e-12 and sqrt(e2) = sqrt(1e-12), which enter the sums as one
//     product n_zero * value each. The candidates, in row then column
//     order, are cut into 32 runs of ceil(n / 32), one a lane (a binary
//     search over the rows' prefix finds a run's start), so a patch's
//     busy rows do not fall to a few lanes. g2 = gx*gx + gy*gy is taken in
//     float32 steps as the reference does (exact, and equal to the integer
//     value, below 2^24); e2 and its square root as on the small path, so
//     max(e2) and the edge count stay exact. A lane sums its run's
//     non-zero terms in order, the 32 lanes by xor shuffles, then the
//     n_zero products are added. A lane keeps its first 8 g2 a byte each
//     for the edge test; only a lane with more, or with a g2 past the
//     table, walks its run again. The slot's histogram terms and six
//     metrics run in its own warp: no block barrier waits on one lane's
//     divisions, and the eight warps' tails overlap.
//   - The row table (4 bytes a row) and the x column (2 or 4 bytes an
//     event) lie in dynamic shared memory after the patch tables while
//     they fit (E up to 65,535 at 640 x 480, with 16-bit tables), past
//     that in per-CTA scratch in device memory that the wrapper
//     allocates; the code is the same, only the base pointer differs.
//
// What bounds it on the H100. The small path: bytes. Of each window that
// holds a valid slot it needs the valid flag of every event slot and x
// and y of each valid event, the valid flag of every cluster slot and the
// centroids and count of each valid slot, and writes 24 bytes per slot;
// the operations of its few valid slots stay below that. The large path
// on the stride windows: operations when every pixel of every valid slot
// is counted (19,053 slots x 2,304 pixels, 1.24e9 operations, 0.0186
// ms); counted as the function needs them (the Sobel at the 3.0e6
// candidate pixels only, no sort), bytes (the events of 600 windows, 10.8
// MB, 0.0032 ms against 0.0015 ms of operations). The kernel reads x and
// y of padding slots too: three loads issued together beat a valid flag
// read before the other two.
// The kernel is far above either: its time goes to latency-bound chains
// in shared memory (a lane's walk over a row's events, its run of
// candidates, the per-row normalizer), not to the card's rates.
//
// Output: (6, W, K) float32, the metrics in METRIC_NAMES order, zeros for
// invalid slots.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_sort.cuh"

namespace {

constexpr int kWin = 48;
constexpr int kPad = kWin + 2;  // the patch with a zero border
constexpr int kPix = kWin * kWin;
constexpr int kPixPerThread = kPix / kThreads;  // 9
constexpr int kBins = 32;
constexpr int kMetrics = 6;
constexpr int kMaxEvents = 1024;  // the small path's bounds
constexpr int kMaxSlots = 128;
constexpr float kEdgeThreshold = 0.25f;
constexpr float kTwoPiE = 17.079468445347132f;  // 2 * pi * e
// Info word of an event: w (bit 0), leader (bit 1), the leader's bin << 2.
constexpr int kW = 1;
constexpr int kLead = 2;

static_assert(kPix % kThreads == 0, "each thread takes whole pixels");
static_assert(kMaxSlots <= kThreads, "one thread per slot in step 1");

struct Params {
  int n_events, n_slots;
  int width, height;
  int ebits;  // key = pixel << ebits | event index
};

// The large path's sizes.
struct LargeParams {
  int n_events, n_slots, n_windows;
  int width, height;
  int group;     // slots a CTA takes, 1..32
  int n_groups;  // CTAs a window: ceil(n_slots / group)
  // A CTA's row table and event columns: in device scratch, one area a
  // CTA (nullptr: dynamic shared memory, after the patches).
  unsigned char* scratch;
  long long scratch_stride;
};

constexpr int kFill = 4;       // large-path CTAs a SM holds at the stride windows' sizes
constexpr int kShortRow = 32;  // rows of at most this many events: one thread each
constexpr int kTab = 128;      // g2 and pixel counts below this are looked up
constexpr uint64_t kRowMask = (uint64_t{1} << kWin) - 1;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// A slot's patch origin: clip(rint(c) - 24, 0, extent - 48), rint
// rounding half to even.
__device__ __forceinline__ int origin(float c, int extent) {
  return min(max(__float2int_rn(c) - kWin / 2, 0), extent - kWin);
}

template <typename Key, int Items>
__global__ void __launch_bounds__(kThreads) patch_metrics_kernel(
    const int32_t* __restrict__ x, const int32_t* __restrict__ y,
    const uint8_t* __restrict__ valid, const float* __restrict__ cx,
    const float* __restrict__ cy, const int32_t* __restrict__ count,
    const uint8_t* __restrict__ cvalid, const Params p, float* __restrict__ out) {
  // Dynamic: two key buffers of sort_size(E) keys, then x, y and the info
  // word by event index.
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = p.n_events;
  const int K = p.n_slots;
  const int n_max = sort_size(E);
  Key* kbuf0 = reinterpret_cast<Key*>(smem);
  Key* kbuf1 = kbuf0 + n_max;
  int* ex = reinterpret_cast<int*>(kbuf1 + n_max);
  int* ey = ex + E;
  int* info = ey + E;

  __shared__ __align__(16) int patch[kPad * kPad];
  __shared__ int hist[kBins];
  __shared__ uint32_t wsum[Items * kWarps];
  __shared__ float red_g[kWarps], red_e2[kWarps], red_mx[kWarps];
  __shared__ int red_s1[kWarps], red_s2[kWarps], red_edges[kWarps];
  __shared__ int sl_x0[kMaxSlots], sl_y0[kMaxSlots];
  __shared__ bool sl_ok[kMaxSlots];
  __shared__ int s_nw, s_cmax;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long win = blockIdx.x;
  const long long plane = static_cast<long long>(gridDim.x) * K;  // one metric's (W, K)
  float* o = out + win * K;                                       // o[m * plane + slot]

  // 1. Slots. Invalid ones get their zeros here.
  bool ok = false;
  if (tid < K) {
    const long long s = win * K + tid;
    ok = cvalid[s];
    if (ok) {
      sl_x0[tid] = origin(cx[s], p.width);
      sl_y0[tid] = origin(cy[s], p.height);
    } else {
#pragma unroll
      for (int m = 0; m < kMetrics; ++m) o[m * plane + tid] = 0.0f;
    }
    sl_ok[tid] = ok;
  }
  if (tid == 0) {
    s_nw = 0;
    s_cmax = 0;
  }
  if (!__syncthreads_or(ok)) return;  // no valid slot: every thread leaves

  if (tid < kBins) hist[tid] = 0;
  for (int q = tid; q < kPad * kPad / 4; q += kThreads)
    reinterpret_cast<int4*>(patch)[q] = make_int4(0, 0, 0, 0);

  // 2. Load; the w events' keys go to kbuf0 in any order.
  const long long base = win * E;
  for (int it = 0; it * kThreads < E; ++it) {
    const int i = it * kThreads + tid;
    bool w = false;
    Key key = 0;
    if (i < E) {
      const int xi = x[base + i];
      const int yi = y[base + i];
      ex[i] = xi;
      ey[i] = yi;
      info[i] = 0;
      w = valid[base + i] && xi >= 0 && xi < p.width && yi >= 0 && yi < p.height;
      if (w) {
        const Key pix = static_cast<Key>(yi) * static_cast<Key>(p.width) + static_cast<Key>(xi);
        key = (pix << p.ebits) | static_cast<Key>(i);
      }
    }
    warp_append(w, key, kbuf0, &s_nw);
  }
  __syncthreads();
  const int nw = s_nw;

  // 3. Sort, pixel runs: c, leaders, norm, then each w event's info word.
  float nrm = 1.0f;
  if (nw > 0) {
    const int n = sort_size(nw);
    const int items = n > kThreads ? n / kThreads : 1;
    Key v[Items];
#pragma unroll
    for (int it = 0; it < Items; ++it) {
      const int e = it * kThreads + tid;
      v[it] = e < nw ? kbuf0[e] : ~static_cast<Key>(0);
    }
    __syncthreads();
    PingPong<Key> pp{{kbuf0, kbuf1}, 0};
    bitonic_sort<Key, Items>(v, n, pp);
    Key* sk = pp.take();
#pragma unroll
    for (int it = 0; it < Items; ++it) {
      const int e = it * kThreads + tid;
      if (it < items && e < nw) sk[e] = v[it];
    }
    __syncthreads();

    uint32_t f[Items][1];
    bool st[Items], en[Items];
#pragma unroll
    for (int it = 0; it < Items; ++it) {
      const int e = it * kThreads + tid;
      f[it][0] = 0;
      st[it] = en[it] = false;
      if (it < items && e < nw) {
        const Key cur = v[it] >> p.ebits;
        st[it] = e == 0 || (sk[e - 1] >> p.ebits) != cur;
        en[it] = e == nw - 1 || (sk[e + 1] >> p.ebits) != cur;
        f[it][0] = st[it];
      }
    }
    uint32_t runs[1];
    block_scan<1, Items>(f, items, wsum, runs);
    // The key buffers are free after the scan's barrier.
    int* run_lo = reinterpret_cast<int*>(kbuf0);
    int* run_hi = reinterpret_cast<int*>(kbuf1);
#pragma unroll
    for (int it = 0; it < Items; ++it) {
      const int e = it * kThreads + tid;
      if (st[it]) run_lo[f[it][0] - 1] = e;
      if (en[it]) run_hi[f[it][0] - 1] = e;
    }
    __syncthreads();
    int c[Items];
    int cmax = 0;
#pragma unroll
    for (int it = 0; it < Items; ++it) {
      const int e = it * kThreads + tid;
      c[it] = 0;
      if (it < items && e < nw) {
        c[it] = run_hi[f[it][0] - 1] - run_lo[f[it][0] - 1] + 1;
        cmax = max(cmax, c[it]);
      }
    }
    cmax = warp_max(cmax);
    if (lane == 0) atomicMax(&s_cmax, cmax);
    __syncthreads();
    nrm = static_cast<float>(max(s_cmax, 1));
    const Key imask = (static_cast<Key>(1) << p.ebits) - 1;
#pragma unroll
    for (int it = 0; it < Items; ++it) {
      const int e = it * kThreads + tid;
      if (!(it < items && e < nw)) continue;
      int inf = kW;
      if (st[it]) {
        const float b = __fmul_rn(__fdiv_rn(static_cast<float>(c[it]), nrm),
                                  static_cast<float>(kBins));
        inf |= kLead | (min(max(static_cast<int>(b), 0), kBins - 1) << 2);
      }
      info[static_cast<int>(v[it] & imask)] = inf;
    }
  }
  __syncthreads();

  // 4-5. Per valid slot.
  const float nn = __fmul_rn(nrm, nrm);
  const float g_eps = __fsqrt_rn(1e-12f);  // sqrt(e2) where g2 = 0
  // The reference runs under jit, where XLA turns division by the constant
  // pixel count into multiplication by its float32 reciprocal.
  const float inv_n = __fdiv_rn(1.0f, static_cast<float>(kPix));
  for (int sl = 0; sl < K; ++sl) {
    if (!sl_ok[sl]) continue;  // uniform over the block
    const int x0 = sl_x0[sl];
    const int y0 = sl_y0[sl];
    for (int i = tid; i < E; i += kThreads) {
      const int inf = info[i];
      if (!inf) continue;
      const int rx = ex[i] - x0;
      const int ry = ey[i] - y0;
      if (static_cast<unsigned>(rx) >= kWin || static_cast<unsigned>(ry) >= kWin) continue;
      atomicAdd(&patch[(ry + 1) * kPad + rx + 1], 1);
      if (inf & kLead) atomicAdd(&hist[inf >> 2], 1);
    }
    __syncthreads();

    float e2v[kPixPerThread];
    float s_g = 0.0f, s_e2 = 0.0f, mx = -INFINITY;
    int s1 = 0, s2 = 0;
#pragma unroll
    for (int j = 0; j < kPixPerThread; ++j) {
      const int px = tid + j * kThreads;
      const int r = px / kWin;
      const int* q = patch + r * kPad + (px - r * kWin);  // the 3x3 around (r, col)
      const int ul = q[0], up = q[1], ur = q[2];
      const int left = q[kPad], mid = q[kPad + 1], right = q[kPad + 2];
      const int dl = q[2 * kPad], down = q[2 * kPad + 1], dr = q[2 * kPad + 2];
      const int gx = (ur - ul) + 2 * (right - left) + (dr - dl);
      const int gy = (dl - ul) + 2 * (down - up) + (dr - ur);
      const int g2 = gx * gx + gy * gy;
      float e2 = 1e-12f, g = g_eps;
      if (g2 != 0) {
        e2 = __fadd_rn(__fdiv_rn(__int2float_rn(g2), nn), 1e-12f);
        g = __fsqrt_rn(e2);
      }
      e2v[j] = e2;
      s_g = __fadd_rn(s_g, g);
      s_e2 = __fadd_rn(s_e2, e2);
      mx = fmaxf(mx, e2);
      s1 += mid;
      s2 += mid * mid;
    }
    s_g = warp_sum(s_g);
    s_e2 = warp_sum(s_e2);
    mx = warp_max(mx);
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      red_g[warp] = s_g;
      red_e2[warp] = s_e2;
      red_mx[warp] = mx;
      red_s1[warp] = s1;
      red_s2[warp] = s2;
    }
    __syncthreads();

    float m = red_mx[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_mx[w]);
    const float a = __fmul_rn(kEdgeThreshold, fmaxf(__fsqrt_rn(m), 1e-3f));
    const float thr = __fmul_rn(a, a);
    int edges = 0;
#pragma unroll
    for (int j = 0; j < kPixPerThread; ++j) edges += e2v[j] > thr ? 1 : 0;
    edges = warp_sum(edges);
    if (lane == 0) red_edges[warp] = edges;
    for (int q = tid; q < kPad * kPad / 4; q += kThreads)
      reinterpret_cast<int4*>(patch)[q] = make_int4(0, 0, 0, 0);
    __syncthreads();

    // The histogram terms one bin a lane in warp 0 (kBins == 32), summed
    // by xor shuffles; lane 0 then evaluates the six metrics.
    if (warp == 0) {
      const int hb = hist[lane];
      hist[lane] = 0;
      const int occ = warp_sum(hb);
      const float h = static_cast<float>(hb + (lane == 0 ? kPix - occ : 0));
      const float hden = fmaxf(warp_sum(h), 1.0f);
      const float pb = __fdiv_rn(h, hden);
      const float shannon =
          warp_sum(pb > 0.0f ? __fmul_rn(pb, log2f(fmaxf(pb, 1e-12f))) : 0.0f);
      const float collide = warp_sum(__fmul_rn(pb, pb));
      if (lane == 0) {
        float g_tot = 0.0f, e2_tot = 0.0f;
        int s1_tot = 0, s2_tot = 0, edge_tot = 0;
        for (int w = 0; w < kWarps; ++w) {
          g_tot = __fadd_rn(g_tot, red_g[w]);
          e2_tot = __fadd_rn(e2_tot, red_e2[w]);
          s1_tot += red_s1[w];
          s2_tot += red_s2[w];
          edge_tot += red_edges[w];
        }
        const float mean = __fmul_rn(static_cast<float>(s1_tot), inv_n);
        const float var_c = fmaxf(
            __fsub_rn(__fmul_rn(static_cast<float>(s2_tot), inv_n), __fmul_rn(mean, mean)),
            0.0f);
        const float contrast = __fdiv_rn(__fsqrt_rn(var_c), nrm);

        const float m1 = __fmul_rn(g_tot, inv_n);
        const float var_g = fmaxf(
            __fsub_rn(__fmul_rn(e2_tot, inv_n), __fmul_rn(m1, m1)), 1e-12f);
        const float diff_entropy = __fmul_rn(0.5f, log2f(__fmul_rn(kTwoPiE, var_g)));

        o[sl] = -shannon;
        o[plane + sl] = -log2f(fmaxf(collide, 1e-12f));
        o[2 * plane + sl] = diff_entropy;
        o[3 * plane + sl] = contrast;
        o[4 * plane + sl] = __fmul_rn(static_cast<float>(edge_tot), inv_n);
        o[5 * plane + sl] = static_cast<float>(count[win * K + sl]);
      }
    }
    __syncthreads();
  }
}


// Bytes of one warp's patch in the large path (a 50 x 50 table of T).
template <typename T>
__host__ __device__ constexpr size_t patch_bytes() {
  return (sizeof(T) * kPad * kPad + 15) / 16 * 16;
}

// Position of the j-th (from 0) set bit of m, which has more than j.
__device__ __forceinline__ int select_bit(uint64_t m, int j) {
  int pos = 0;
  uint32_t w = static_cast<uint32_t>(m);
  const int lo = __popc(w);
  if (j >= lo) {
    j -= lo;
    w = static_cast<uint32_t>(m >> 32);
    pos = 32;
  }
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const uint32_t low = w & ((1u << half) - 1u);
    const int c = __popc(low);
    if (j >= c) {
      j -= c;
      w >>= half;
      pos += half;
    } else {
      w = low;
    }
  }
  return pos;
}

// e2 = g2 / nn + 1e-12 and sqrt(e2), g2 = gx * gx + gy * gy in float32
// steps, each rounded to nearest, as the reference computes them (g2 is
// exact, and equal to the integer, below 2^24). Out of line: the large
// path looks most gradients up in a table and comes here for the rest.
__device__ __noinline__ float2 e2_and_g(int gx, int gy, float nn) {
  const float fx = static_cast<float>(gx), fy = static_cast<float>(gy);
  const float e2 = __fadd_rn(__fdiv_rn(__fadd_rn(__fmul_rn(fx, fx), __fmul_rn(fy, fy)), nn), 1e-12f);
  return make_float2(e2, __fsqrt_rn(e2));
}

// The Sobel gradient at a patch pixel; q is its 3x3 neighbourhood's
// top-left in the bordered table.
template <typename T>
__device__ __forceinline__ void sobel(const T* q, int& gx, int& gy) {
  const int ul = q[0], up = q[1], ur = q[2];
  const int left = q[kPad], right = q[kPad + 2];
  const int dl = q[2 * kPad], down = q[2 * kPad + 1], dr = q[2 * kPad + 2];
  gx = (ur - ul) + 2 * (right - left) + (dr - dl);
  gy = (dl - ul) + 2 * (down - up) + (dr - ur);
}

// A lane's run of a slot's candidate pixels (row then column order):
// where it starts, then one candidate a call.
struct CandidateWalk {
  const uint64_t* bits;  // the candidate word of each patch row
  int r;                 // the row of the next candidate
  uint64_t rest;         // its row's candidates from it on

  __device__ __forceinline__ CandidateWalk(const uint64_t* b, const uint16_t* pre, int k) : bits(b) {
    int lo = 0, hi = kWin - 1;  // the last row whose prefix is <= k
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (pre[mid] <= k) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    r = lo;
    rest = bits[lo] & ~((uint64_t{1} << select_bit(bits[lo], k - pre[lo])) - 1);
  }

  // The next candidate's row and column; the walk holds one more.
  __device__ __forceinline__ void next(int& row, int& col) {
    while (!rest) rest = bits[++r];
    row = r;
    col = __ffsll(static_cast<long long>(rest)) - 1;
    rest &= rest - 1;
  }
};

// The large path: any E, any K. A window is n_groups CTAs, each taking
// `group` of its slots; each CTA indexes the window's events by sensor
// row itself, then its warps run its valid slots side by side, a slot a
// warp, each in its own patch table. T holds a count and an x: uint16_t
// (narrow) while E < 65,536 and width, height <= 65,536, else uint32_t.
template <typename T>
__global__ void __launch_bounds__(kThreads) patch_metrics_kernel_large(
    const int32_t* __restrict__ x, const int32_t* __restrict__ y,
    const uint8_t* __restrict__ valid, const float* __restrict__ cx,
    const float* __restrict__ cy, const int32_t* __restrict__ count,
    const uint8_t* __restrict__ cvalid, const LargeParams p, float* __restrict__ out) {
  // Dynamic: the eight warps' patch tables, then (or in device scratch)
  // the row table (height ints) and the w events' x by row (E of T).
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr size_t kPatchBytes = patch_bytes<T>();
  const int E = p.n_events;
  const int K = p.n_slots;
  const int W = p.width;
  const int H = p.height;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  unsigned char* var = p.scratch
      ? p.scratch + static_cast<long long>(blockIdx.x) * p.scratch_stride
      : smem + kWarps * kPatchBytes;
  int* row = reinterpret_cast<int*>(var);
  T* xs = reinterpret_cast<T*>(var + round_up(static_cast<size_t>(H) * sizeof(int), 16));
  T* patch = reinterpret_cast<T*>(smem + warp * kPatchBytes);

  // Per warp: a word a patch row, first its occupied pixels, then its
  // candidate pixels, and the candidates' exclusive prefix by row.
  __shared__ uint64_t bits_all[kWarps][kWin];
  __shared__ uint16_t pre_all[kWarps][kWin];
  __shared__ int hist_all[kWarps][kBins];
  // e2 = g2 / nn + 1e-12 and its square root for g2 < kTab, and the
  // histogram bin of a pixel count c < kTab, once a CTA.
  __shared__ float tab_e2[kTab], tab_g[kTab];
  __shared__ uint8_t tab_bin[kTab];
  __shared__ uint32_t wsum[kWarps];
  __shared__ int s_slot[32];
  __shared__ int s_nslot, s_cmax;

  const long long win = blockIdx.x / p.n_groups;
  const int first = static_cast<int>(blockIdx.x % p.n_groups) * p.group;
  const long long plane = static_cast<long long>(p.n_windows) * K;  // one metric's (W, K)
  float* o = out + win * K;                                          // o[m * plane + slot]

  // 1. This CTA's slots: zeros for the invalid ones, the valid ones
  //    listed in order.
  if (warp == 0) {
    const int sl = first + lane;
    const bool mine = lane < p.group && sl < K;
    const bool ok = mine && cvalid[win * K + sl];
    if (mine && !ok) {
#pragma unroll
      for (int m = 0; m < kMetrics; ++m) o[m * plane + sl] = 0.0f;
    }
    const unsigned b = __ballot_sync(kFull, ok);
    if (ok) s_slot[__popc(b & ((1u << lane) - 1u))] = sl;
    if (lane == 0) {
      s_nslot = __popc(b);
      s_cmax = 0;
    }
  }
  __syncthreads();
  const int n_slot = s_nslot;
  if (n_slot == 0) return;  // uniform over the block

  for (int i = tid; i < H; i += kThreads) row[i] = 0;
  if (tid < kWarps * kBins) (&hist_all[0][0])[tid] = 0;
  for (size_t q = tid; q < kWarps * kPatchBytes / 16; q += kThreads)
    reinterpret_cast<int4*>(smem)[q] = make_int4(0, 0, 0, 0);
  __syncthreads();

  // 2. The w events (valid, in the sensor) by row: a count a row, an
  //    exclusive scan, then each event's x at its row's cursor. After it
  //    row[y] is the end of row y's events and the start of row y + 1's;
  //    within a row the order is the atomics', which no result depends on.
  const long long base = win * E;
  for (int i = tid; i < E; i += kThreads) {
    const int xi = x[base + i], yi = y[base + i];
    if (valid[base + i] && xi >= 0 && xi < W && yi >= 0 && yi < H) atomicAdd(&row[yi], 1);
  }
  __syncthreads();
  {
    const int per = (H + kThreads - 1) / kThreads;
    const int lo = min(tid * per, H), hi = min(lo + per, H);
    uint32_t v[1][1] = {{0}};
    for (int r = lo; r < hi; ++r) v[0][0] += row[r];
    const uint32_t own = v[0][0];
    uint32_t total[1];
    block_scan<1, 1>(v, 1, wsum, total);
    int at = static_cast<int>(v[0][0] - own);
    for (int r = lo; r < hi; ++r) {
      const int c = row[r];
      row[r] = at;
      at += c;
    }
  }
  __syncthreads();
  for (int i = tid; i < E; i += kThreads) {
    const int xi = x[base + i], yi = y[base + i];
    if (valid[base + i] && xi >= 0 && xi < W && yi >= 0 && yi < H) {
      xs[atomicAdd(&row[yi], 1)] = static_cast<T>(xi);
    }
  }
  __syncthreads();

  // 3. norm = max(1, the largest count of one pixel). A warp takes 32
  //    rows at a time, a row a lane: a row of at most kShortRow events,
  //    its lane counts each event's later repeats; a longer one, the warp
  //    counts by x in 32-bit counters laid over its patch table, x in
  //    chunks of the table's size, and zeroes them after.
  int cmax = 0;
  {
    constexpr int kCap = static_cast<int>(kPatchBytes / sizeof(uint32_t));
    uint32_t* cnt = reinterpret_cast<uint32_t*>(patch);
    for (int b0 = warp * 32; b0 < H; b0 += kThreads) {
      const int yy = b0 + lane;
      const int s = yy < H ? (yy ? row[yy - 1] : 0) : 0;
      const int e = yy < H ? row[yy] : 0;
      if (e - s <= kShortRow) {
        // An event with no more than cmax events after it in its row
        // cannot raise cmax.
        for (int i = s; i < e - cmax; ++i) {
          const T xi = xs[i];
          int c = 1;
          for (int j = i + 1; j < e; ++j) c += xs[j] == xi;
          cmax = max(cmax, c);
        }
      }
      cmax = warp_max(cmax);
      unsigned long_rows = __ballot_sync(kFull, e - s > kShortRow);
      while (long_rows) {
        const int bit = __ffs(long_rows) - 1;
        long_rows &= long_rows - 1;
        const int rs = __shfl_sync(kFull, s, bit), re = __shfl_sync(kFull, e, bit);
        for (int xc = 0; xc < W; xc += kCap) {
          for (int i = rs + lane; i < re; i += 32) {
            const int xi = static_cast<int>(xs[i]) - xc;
            if (xi >= 0 && xi < kCap) cmax = max(cmax, static_cast<int>(atomicAdd(&cnt[xi], 1u)) + 1);
          }
          __syncwarp();
          for (int i = rs + lane; i < re; i += 32) {
            const int xi = static_cast<int>(xs[i]) - xc;
            if (xi >= 0 && xi < kCap) cnt[xi] = 0;
          }
          __syncwarp();
        }
      }
    }
  }
  cmax = warp_max(cmax);
  if (lane == 0) atomicMax(&s_cmax, cmax);
  __syncthreads();
  const float nrm = static_cast<float>(max(s_cmax, 1));
  const float nn = __fmul_rn(nrm, nrm);
  static_assert(2 * kTab == kThreads, "a table entry a thread");
  if (tid < kTab) {
    const float e2 = __fadd_rn(__fdiv_rn(static_cast<float>(tid), nn), 1e-12f);
    tab_e2[tid] = e2;
    tab_g[tid] = __fsqrt_rn(e2);
  } else {
    const int c = tid - kTab;
    const float b = __fmul_rn(__fdiv_rn(static_cast<float>(c), nrm), static_cast<float>(kBins));
    tab_bin[c] = static_cast<uint8_t>(min(max(static_cast<int>(b), 0), kBins - 1));
  }
  __syncthreads();

  // 4-5. A valid slot a warp.
  const float g_eps = tab_g[0];  // sqrt(e2) where g2 = 0
  const float inv_n = __fdiv_rn(1.0f, static_cast<float>(kPix));
  uint64_t* bits = bits_all[warp];
  uint16_t* pre = pre_all[warp];
  int* hist = hist_all[warp];
  for (int q = warp; q < n_slot; q += kWarps) {
    const int sl = s_slot[q];
    const long long sidx = win * K + sl;
    const int x0 = origin(cx[sidx], W);
    const int y0 = origin(cy[sidx], H);

    // The patch from the events of its 48 rows, lane l taking rows l and
    // l + 32; each occupied pixel's count into the moments and its bin
    // into the histogram (a pixel's count is its events' c, so this is
    // the reference's leader).
    uint64_t mine[2] = {0, 0};
    long long s1 = 0, s2 = 0;  // a pixel may hold up to E events, so c * c passes 32 bits
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      if (r < kWin) {
        const int yy = y0 + r;
        uint64_t m = 0;
        T* pr = patch + (r + 1) * kPad + 1;
        if (yy >= 0 && yy < H) {
          const int e = row[yy];
          for (int i = yy ? row[yy - 1] : 0; i < e; ++i) {
            const unsigned rx = static_cast<unsigned>(static_cast<int>(xs[i]) - x0);
            if (rx < kWin) {
              pr[rx] = static_cast<T>(pr[rx] + 1);
              m |= uint64_t{1} << rx;
            }
          }
        }
        mine[h] = m;
        bits[r] = m;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const T* pr = patch + (lane + 32 * h + 1) * kPad + 1;
      for (uint64_t b = mine[h]; b; b &= b - 1) {
        const int c = pr[__ffsll(static_cast<long long>(b)) - 1];
        s1 += c;
        s2 += static_cast<long long>(c) * c;
        int bin;
        if (c < kTab) {
          bin = tab_bin[c];
        } else {
          const float bf = __fmul_rn(__fdiv_rn(static_cast<float>(c), nrm), static_cast<float>(kBins));
          bin = min(max(static_cast<int>(bf), 0), kBins - 1);
        }
        atomicAdd(&hist[bin], 1);
      }
    }
    __syncwarp();

    // The candidate pixels, those with an occupied pixel in their 3x3
    // neighbourhood (the occupancy words dilated by a row and a column),
    // counted a row and prefixed over the rows in order. Every other pixel
    // has gx = gy = 0, e2 = 1e-12 and sqrt(e2) = g_eps: those enter the
    // sums below as one product n_zero * value each.
    uint64_t cand[2] = {0, 0};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      if (r < kWin) {
        const uint64_t m = bits[r] | (r > 0 ? bits[r - 1] : 0) | (r < kWin - 1 ? bits[r + 1] : 0);
        cand[h] = (m | (m << 1) | (m >> 1)) & kRowMask;
      }
    }
    const int c0 = __popcll(cand[0]);
    const int c1 = __popcll(cand[1]);  // 0 from lane 16 on
    int in0 = c0, in1 = c1;  // inclusive scans over the lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int a0 = __shfl_up_sync(kFull, in0, o), a1 = __shfl_up_sync(kFull, in1, o);
      if (lane >= o) {
        in0 += a0;
        in1 += a1;
      }
    }
    const int tot0 = __shfl_sync(kFull, in0, 31);
    const int n_cand = tot0 + __shfl_sync(kFull, in1, 31);
    __syncwarp();
    pre[lane] = static_cast<uint16_t>(in0 - c0);
    bits[lane] = cand[0];
    if (lane < kWin - 32) {
      pre[lane + 32] = static_cast<uint16_t>(tot0 + in1 - c1);
      bits[lane + 32] = cand[1];
    }
    __syncwarp();

    // The Sobel at the candidates: lane l takes the l-th of 32 runs of
    // ceil(n_cand / 32) candidates in row then column order, and sums the
    // non-zero terms of its run in that order. The lookup tables give e2
    // and sqrt(e2) of g2 < kTab; e2_and_g the rest, the same values.
    // A lane's first 8 g2 (below kTab; 0 where the gradient is zero) are
    // kept a byte each for the edge test; a lane with more candidates, or
    // a larger g2, walks its run again there.
    const int run = (n_cand + 31) >> 5;
    const int k0 = min(lane * run, n_cand), k1 = min(k0 + run, n_cand);
    float s_g = 0.0f, s_e2 = 0.0f, mx = -INFINITY;
    int nz = 0;
    uint64_t kept = 0;
    bool all_kept = k1 - k0 <= 8;
    if (k0 < k1) {
      CandidateWalk walk(bits, pre, k0);
      for (int k = k0; k < k1; ++k) {
        int r, col, gx, gy;
        walk.next(r, col);
        sobel(patch + r * kPad + col, gx, gy);
        if ((gx | gy) == 0) continue;
        float e2, g;
        const int g2 = abs(gx) < kTab && abs(gy) < kTab ? gx * gx + gy * gy : kTab;
        if (g2 < kTab) {
          e2 = tab_e2[g2];
          g = tab_g[g2];
          kept |= static_cast<uint64_t>(g2) << (8 * (k - k0) & 63);
        } else {
          const float2 v = e2_and_g(gx, gy, nn);
          e2 = v.x;
          g = v.y;
          all_kept = false;
        }
        s_g = __fadd_rn(s_g, g);
        s_e2 = __fadd_rn(s_e2, e2);
        mx = fmaxf(mx, e2);
        ++nz;
      }
    }
    s_g = warp_sum(s_g);
    s_e2 = warp_sum(s_e2);
    mx = warp_max(mx);
    nz = warp_sum(nz);
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const int n_zero = kPix - nz;
    if (n_zero > 0) mx = fmaxf(mx, 1e-12f);
    const float a = __fmul_rn(kEdgeThreshold, fmaxf(__fsqrt_rn(mx), 1e-3f));
    const float thr = __fmul_rn(a, a);
    int edges = 0;  // 1e-12 is below any threshold: only non-zero terms count
    if (all_kept) {
      for (uint64_t c = kept; c; c >>= 8) edges += (c & 0xff) && tab_e2[c & 0xff] > thr ? 1 : 0;
    } else {
      CandidateWalk walk(bits, pre, k0);
      for (int k = k0; k < k1; ++k) {
        int r, col, gx, gy;
        walk.next(r, col);
        sobel(patch + r * kPad + col, gx, gy);
        if ((gx | gy) == 0) continue;
        const int g2 = abs(gx) < kTab && abs(gy) < kTab ? gx * gx + gy * gy : kTab;
        edges += (g2 < kTab ? tab_e2[g2] : e2_and_g(gx, gy, nn).x) > thr ? 1 : 0;
      }
    }
    edges = warp_sum(edges);

    // The histogram terms one bin a lane (kBins == 32), as the small path.
    const int hb = hist[lane];
    hist[lane] = 0;
    const int occ_n = warp_sum(hb);
    const float hcount = static_cast<float>(hb + (lane == 0 ? kPix - occ_n : 0));
    const float hden = fmaxf(warp_sum(hcount), 1.0f);
    const float pb = __fdiv_rn(hcount, hden);
    const float shannon =
        warp_sum(pb > 0.0f ? __fmul_rn(pb, log2f(fmaxf(pb, 1e-12f))) : 0.0f);
    const float collide = warp_sum(__fmul_rn(pb, pb));
    if (lane == 0) {
      const float zeros = static_cast<float>(n_zero);
      const float g_tot = __fadd_rn(__fmul_rn(zeros, g_eps), s_g);
      const float e2_tot = __fadd_rn(__fmul_rn(zeros, 1e-12f), s_e2);
      const float mean = __fmul_rn(static_cast<float>(s1), inv_n);
      const float var_c = fmaxf(
          __fsub_rn(__fmul_rn(static_cast<float>(s2), inv_n), __fmul_rn(mean, mean)), 0.0f);
      const float contrast = __fdiv_rn(__fsqrt_rn(var_c), nrm);
      const float m1 = __fmul_rn(g_tot, inv_n);
      const float var_g = fmaxf(__fsub_rn(__fmul_rn(e2_tot, inv_n), __fmul_rn(m1, m1)), 1e-12f);
      const float diff_entropy = __fmul_rn(0.5f, log2f(__fmul_rn(kTwoPiE, var_g)));
      o[sl] = -shannon;
      o[plane + sl] = -log2f(fmaxf(collide, 1e-12f));
      o[2 * plane + sl] = diff_entropy;
      o[3 * plane + sl] = contrast;
      o[4 * plane + sl] = __fmul_rn(static_cast<float>(edges), inv_n);
      o[5 * plane + sl] = static_cast<float>(count[sidx]);
    }

    // Leave the table zero for the warp's next slot.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      T* pr = patch + (lane + 32 * h + 1) * kPad + 1;
      for (uint64_t b = mine[h]; b; b &= b - 1) pr[__ffsll(static_cast<long long>(b)) - 1] = 0;
    }
    __syncwarp();
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
int launch(const Params& p, size_t smem, int n_windows, const void* x, const void* y,
           const void* valid, const void* cx, const void* cy, const void* count,
           const void* cvalid, void* out, cudaStream_t stream) {
  constexpr auto kernel = patch_metrics_kernel<Key, Items>;
  if (smem > kDefaultSmem && smem > dynamic_smem_limit<kernel>()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<n_windows, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(cx),
      static_cast<const float*>(cy), static_cast<const int32_t*>(count),
      static_cast<const uint8_t*>(cvalid), p, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_large(const LargeParams& p, size_t smem, const void* x, const void* y,
                 const void* valid, const void* cx, const void* cy, const void* count,
                 const void* cvalid, void* out, cudaStream_t stream) {
  constexpr auto kernel = patch_metrics_kernel_large<T>;
  const long long blocks = static_cast<long long>(p.n_windows) * p.n_groups;
  if ((smem > kDefaultSmem && smem > dynamic_smem_limit<kernel>()) || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(cx),
      static_cast<const float*>(cy), static_cast<const int32_t*>(count),
      static_cast<const uint8_t*>(cvalid), p, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

Params make_params(int n_events, int n_slots, int width, int height) {
  Params p{};
  p.n_events = n_events;
  p.n_slots = n_slots;
  p.width = width;
  p.height = height;
  p.ebits = bit_length(static_cast<unsigned long long>(n_events > 0 ? n_events - 1 : 0));
  return p;
}

// Where a launch runs: the small path (key width: 64 bits where pixel and
// index bits pass 32), or the large path (its table type, the slots a CTA,
// and its row table and events in dynamic shared memory or in per-CTA
// device scratch).
struct Plan {
  bool large, wide, narrow;  // narrow: the large path's uint16_t tables
  int group, n_groups;
  size_t smem;           // dynamic shared memory bytes
  size_t scratch_bytes;  // per CTA, in device memory; 0: none
};

// The large path's slots a CTA: `group` where it is 1..32; else the
// largest of 32 and 16 whose grid still fills the card (kFill CTAs a SM),
// and 8 where neither does. Fewer slots a CTA cost more CTAs, each of
// which indexes its window's events again, but shorten a CTA: a small
// grid is latency-bound.
int pick_group(int group, int n_windows, int n_slots) {
  if (group >= 1 && group <= 32) return group;
  const long long fill = static_cast<long long>(kFill) * sm_count();
  for (int g = 32; g >= 16; g >>= 1) {
    if (static_cast<long long>(n_windows) * ((n_slots + g - 1) / g) >= fill) return g;
  }
  return 8;
}

Plan plan(const Params& p, int group, int n_windows) {
  Plan pl{};
  const unsigned long long pixels =
      static_cast<unsigned long long>(p.width) * static_cast<unsigned long long>(p.height);
  pl.wide = bit_length(pixels - 1) + p.ebits > 32;
  const size_t key = pl.wide ? sizeof(unsigned long long) : sizeof(uint32_t);
  const size_t events = 3 * static_cast<size_t>(p.n_events) * sizeof(int);
  if (p.n_events <= kMaxEvents && p.n_slots <= kMaxSlots) {
    // At most 2 * 1,024 * 8 + 3 * 1,024 * 4 = 28 KB: no opt-in needed.
    pl.smem = 2 * static_cast<size_t>(sort_size(p.n_events)) * key + events;
    return pl;
  }
  pl.large = true;
  pl.narrow = p.n_events < 65536 && p.width <= 65536 && p.height <= 65536;
  pl.group = pick_group(group, n_windows, p.n_slots);
  pl.n_groups = (p.n_slots + pl.group - 1) / pl.group;
  const size_t t = pl.narrow ? sizeof(uint16_t) : sizeof(uint32_t);
  const size_t patches = kWarps * (pl.narrow ? patch_bytes<uint16_t>() : patch_bytes<uint32_t>());
  const size_t var = round_up(static_cast<size_t>(p.height) * sizeof(int), 16) +
                     round_up(static_cast<size_t>(p.n_events) * t, 16);
  const size_t limit = pl.narrow ? dynamic_smem_limit<patch_metrics_kernel_large<uint16_t>>()
                                 : dynamic_smem_limit<patch_metrics_kernel_large<uint32_t>>();
  if (patches + var <= kDefaultSmem || patches + var <= limit) {
    pl.smem = patches + var;
  } else {
    pl.smem = patches;
    pl.scratch_bytes = var;
  }
  return pl;
}

template <typename Key>
int launch_small(const Plan& pl, const Params& p, int n_windows, const void* x, const void* y,
                 const void* valid, const void* cx, const void* cy, const void* count,
                 const void* cvalid, void* out, cudaStream_t stream) {
  return p.n_events <= kThreads
             ? launch<Key, 1>(p, pl.smem, n_windows, x, y, valid, cx, cy, count, cvalid, out,
                              stream)
             : launch<Key, kMaxEvents / kThreads>(p, pl.smem, n_windows, x, y, valid, cx, cy,
                                                  count, cvalid, out, stream);
}

bool sizes_ok(int n_events, int n_slots, int width, int height) {
  return n_events >= 0 && n_slots >= 0 && width >= 1 && height >= 1;
}

}  // namespace

// Bytes of device scratch per window that a launch with these sizes needs
// (0: none); the wrapper allocates n_windows times that and passes it to
// the launch. group: the large path's slots a CTA (1..32; else the
// default).
extern "C" long long patch_metrics_scratch_bytes(int n_windows, int n_events, int n_slots,
                                                 int width, int height, int group) {
  if (!sizes_ok(n_events, n_slots, width, height)) return 0;
  const Plan pl = plan(make_params(n_events, n_slots, width, height), group, n_windows);
  return static_cast<long long>(pl.scratch_bytes) * pl.n_groups;
}

// Events (n_windows, n_events): x, y int32; valid bool. Slots (n_windows,
// n_slots): cx, cy float32 centroids; count int32; cvalid bool.
// scratch: n_windows * patch_metrics_scratch_bytes(...) bytes, or null
// where that is 0. out: (6, n_windows, n_slots) float32.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int patch_metrics_launch(
    const void* x, const void* y, const void* valid, const void* cx, const void* cy,
    const void* count, const void* cvalid, int n_windows, int n_events, int n_slots,
    int width, int height, int group, void* out, void* scratch, void* stream) {
  if (!sizes_ok(n_events, n_slots, width, height)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_windows == 0 || n_slots == 0) return 0;
  const Params p = make_params(n_events, n_slots, width, height);
  const Plan pl = plan(p, group, n_windows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!pl.large) {
    return pl.wide ? launch_small<unsigned long long>(pl, p, n_windows, x, y, valid, cx, cy,
                                                      count, cvalid, out, st)
                   : launch_small<uint32_t>(pl, p, n_windows, x, y, valid, cx, cy, count, cvalid,
                                            out, st);
  }
  LargeParams lp{};
  lp.n_events = n_events;
  lp.n_slots = n_slots;
  lp.n_windows = n_windows;
  lp.width = width;
  lp.height = height;
  lp.group = pl.group;
  lp.n_groups = pl.n_groups;
  if (pl.scratch_bytes) {
    if (!scratch) return static_cast<int>(cudaErrorInvalidValue);
    lp.scratch = static_cast<unsigned char*>(scratch);
    lp.scratch_stride = static_cast<long long>(pl.scratch_bytes);
  }
  return pl.narrow ? launch_large<uint16_t>(lp, pl.smem, x, y, valid, cx, cy, count, cvalid, out, st)
                   : launch_large<uint32_t>(lp, pl.smem, x, y, valid, cx, cy, count, cvalid, out, st);
}
