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
// Grid: one CTA of 256 threads per window, the window's valid slots one
// after another in it. A window with no valid slot writes zeros and
// exits, so no CTA is spent on an invalid slot; a block of 4,096 windows
// (the scan's) is 4,096 CTAs, and a stream feed of 1-2 windows holds 2-4
// valid slots, about a microsecond of work each, near the launch floor.
// A thread-block cluster per window would spread a window's slots over
// SMs, at the cost of a second copy of the events per CTA; not needed at
// these counts. Per window:
//
//   1. slots: validity, and each valid slot's patch origin
//      x0 = clip(rint(cx) - 24, 0, width - 48), rint rounding half to even
//      (__float2int_rn) as torch.round and jnp.round do; likewise y0.
//   2. load: x and y of every event into shared memory; the key (pixel,
//      event index) of each w event (valid and in-sensor) into a sort
//      buffer. An out-of-sensor event is never a w event and never shares
//      a pixel with one, so dropping it changes no count.
//   3. one block-wide bitonic sort of the keys (32 bits at every
//      configuration of the repo: 19 pixel bits at 640 x 480 plus at most
//      10 index bits; 64 bits for larger sensors). Pixel runs replace the
//      pairwise pass: every event of a run of length r has c = r, the
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
//      repro/core/metrics.py:_exact_cluster_metrics does. The slots of a
//      window run one after another, so a slot's serial tail is on the
//      window's critical path: the bins are summed by shuffles, not by
//      one thread's loop.
//
// The float sums of step 4 run per thread over j, then by warp
// shuffles, then over the warps in order; the entropy terms of step 5 by
// shuffles over the 32 bins. Built without fast math, so division and
// sqrt are IEEE; log2f is within 1-2 ulp of libm, and the float sums run
// in another order than on the host: those two are why the entropies and
// contrast carry a tolerance in the tests (tests/test_torch_kernels.py
// models this order in numpy and holds it to that tolerance).
//
// Two paths, picked at launch from the sizes. The small one (E <= 1024,
// K <= 128, the main path's) is the above: keys sorted in registers, one
// thread per slot in step 1. The large one takes any E and any K: step 1
// strides over the slots (a slot's origin is computed where the slot
// runs); step 3 sorts the keys in place in memory by a bitonic network of
// compare-exchange passes, and each run's first event finds the run's end
// by a binary search over the sorted keys, so c needs no scan. The events
// and keys (12 bytes an event, 4 or 8 a key) lie in dynamic shared memory
// up to the card's 227 KB a CTA (E up to about 8,000 at 640 x 480), past
// that in a per-window scratch area in device memory that the wrapper
// allocates; the code is the same, only the base pointer differs.
//
// What bounds it on the H100: bytes. It reads x, y and valid of the
// events of each window that holds a valid slot, the valid flag of every
// slot and the centroids and count of each valid slot, and writes 24
// bytes per slot. The operations per valid slot (the 2,304-pixel Sobel
// and its reductions, about 25 each) are a small fraction of the float32
// rate at the scan's 1,720 valid slots per 4,096 windows.
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
  // Large path: the per-window scratch area in device memory (nullptr:
  // dynamic shared memory).
  unsigned char* scratch;
  long long scratch_stride;
};

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

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// A slot's patch origin: clip(rint(c) - 24, 0, extent - 48), rint
// rounding half to even.
__device__ __forceinline__ int origin(float c, int extent) {
  return min(max(__float2int_rn(c) - kWin / 2, 0), extent - kWin);
}

template <typename Key, int Items, bool kLarge>
__global__ void __launch_bounds__(kThreads) patch_metrics_kernel(
    const int32_t* __restrict__ x, const int32_t* __restrict__ y,
    const uint8_t* __restrict__ valid, const float* __restrict__ cx,
    const float* __restrict__ cy, const int32_t* __restrict__ count,
    const uint8_t* __restrict__ cvalid, const Params p, float* __restrict__ out) {
  // Dynamic (or, large path, per-window scratch): the keys, then x, y and
  // the info word by event index. Small path: two key buffers of
  // sort_size(E) keys; large path: one.
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* mem = smem;
  if constexpr (kLarge) {
    if (p.scratch) mem = p.scratch + static_cast<long long>(blockIdx.x) * p.scratch_stride;
  }
  const int E = p.n_events;
  const int K = p.n_slots;
  const int n_max = sort_size(E);
  Key* kbuf0 = reinterpret_cast<Key*>(mem);
  Key* kbuf1 = kLarge ? kbuf0 : kbuf0 + n_max;
  int* ex = reinterpret_cast<int*>(kbuf1 + n_max);
  int* ey = ex + E;
  int* info = ey + E;

  __shared__ __align__(16) int patch[kPad * kPad];
  __shared__ int hist[kBins];
  __shared__ uint32_t wsum[Items * kWarps];
  __shared__ float red_g[kWarps], red_e2[kWarps], red_mx[kWarps];
  __shared__ int red_s1[kWarps], red_s2[kWarps], red_edges[kWarps];
  __shared__ int sl_x0[kLarge ? 1 : kMaxSlots], sl_y0[kLarge ? 1 : kMaxSlots];
  __shared__ bool sl_ok[kLarge ? 1 : kMaxSlots];
  __shared__ int s_nw, s_cmax;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long win = blockIdx.x;
  const long long plane = static_cast<long long>(gridDim.x) * K;  // one metric's (W, K)
  float* o = out + win * K;                                       // o[m * plane + slot]

  // 1. Slots. Invalid ones get their zeros here.
  bool ok = false;
  if constexpr (kLarge) {
    for (int sl = tid; sl < K; sl += kThreads) {
      if (cvalid[win * K + sl]) {
        ok = true;
      } else {
#pragma unroll
        for (int m = 0; m < kMetrics; ++m) o[m * plane + sl] = 0.0f;
      }
    }
  } else if (tid < K) {
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
  if constexpr (kLarge) {
    if (nw > 0) {
      const int n = sort_size(nw);
      for (int e = nw + tid; e < n; e += kThreads) kbuf0[e] = ~static_cast<Key>(0);
      __syncthreads();
      memory_bitonic_sort(kbuf0, n);
      // A run's first event leads; its run length c is found by a binary
      // search for the first key of a higher pixel. The leader's info word
      // holds -c until the normalizer is known.
      const Key imask = (static_cast<Key>(1) << p.ebits) - 1;
      int cmax = 0;
      for (int e0 = 0; e0 < nw; e0 += kThreads) {
        const int e = e0 + tid;
        if (e < nw) {
          const Key cur = kbuf0[e] >> p.ebits;
          const int idx = static_cast<int>(kbuf0[e] & imask);
          if (e == 0 || (kbuf0[e - 1] >> p.ebits) != cur) {
            int lo = e + 1, hi = nw;  // the run ends at the first index in [lo, hi] off it
            while (lo < hi) {
              const int mid = (lo + hi) >> 1;
              if ((kbuf0[mid] >> p.ebits) == cur) {
                lo = mid + 1;
              } else {
                hi = mid;
              }
            }
            const int c = lo - e;
            cmax = max(cmax, c);
            info[idx] = -c;
          } else {
            info[idx] = kW;
          }
        }
      }
      cmax = warp_max(cmax);
      if (lane == 0) atomicMax(&s_cmax, cmax);
      __syncthreads();
      nrm = static_cast<float>(max(s_cmax, 1));
      for (int i = tid; i < E; i += kThreads) {
        const int c = -info[i];
        if (c > 0) {
          const float b = __fmul_rn(__fdiv_rn(static_cast<float>(c), nrm),
                                    static_cast<float>(kBins));
          info[i] = kW | kLead | (min(max(static_cast<int>(b), 0), kBins - 1) << 2);
        }
      }
    }
  } else if (nw > 0) {
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
    int x0, y0;
    if constexpr (kLarge) {
      const long long s = win * K + sl;
      if (!cvalid[s]) continue;  // uniform over the block
      x0 = origin(cx[s], p.width);
      y0 = origin(cy[s], p.height);
    } else {
      if (!sl_ok[sl]) continue;  // uniform over the block
      x0 = sl_x0[sl];
      y0 = sl_y0[sl];
    }
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

int bit_length(unsigned long long v) {
  int b = 0;
  while (v) {
    ++b;
    v >>= 1;
  }
  return b;
}

template <typename Key, int Items, bool kLarge>
int launch(const Params& p, size_t smem, int n_windows, const void* x, const void* y,
           const void* valid, const void* cx, const void* cy, const void* count,
           const void* cvalid, void* out, cudaStream_t stream) {
  constexpr auto kernel = patch_metrics_kernel<Key, Items, kLarge>;
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

Params make_params(int n_events, int n_slots, int width, int height) {
  Params p{};
  p.n_events = n_events;
  p.n_slots = n_slots;
  p.width = width;
  p.height = height;
  p.ebits = bit_length(static_cast<unsigned long long>(n_events > 0 ? n_events - 1 : 0));
  return p;
}

// Where a launch runs: the small path, or the large path with its events
// and keys in dynamic shared memory or in per-window device scratch; and
// the key width (64 bits where pixel and index bits pass 32).
struct Plan {
  bool large, wide;
  size_t smem;           // dynamic shared memory bytes
  size_t scratch_bytes;  // per window, in device memory; 0: none
};

Plan plan(const Params& p) {
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
  const size_t bytes = round_up(static_cast<size_t>(sort_size(p.n_events)) * key + events, 16);
  if (bytes <= kDefaultSmem ||
      bytes <= (pl.wide ? dynamic_smem_limit<patch_metrics_kernel<unsigned long long, 1, true>>()
                        : dynamic_smem_limit<patch_metrics_kernel<uint32_t, 1, true>>())) {
    pl.smem = bytes;
  } else {
    pl.scratch_bytes = bytes;
  }
  return pl;
}

template <typename Key>
int launch_path(const Plan& pl, const Params& p, int n_windows, const void* x, const void* y,
                const void* valid, const void* cx, const void* cy, const void* count,
                const void* cvalid, void* out, cudaStream_t stream) {
  if (pl.large)
    return launch<Key, 1, true>(p, pl.smem, n_windows, x, y, valid, cx, cy, count, cvalid, out,
                                stream);
  return p.n_events <= kThreads
             ? launch<Key, 1, false>(p, pl.smem, n_windows, x, y, valid, cx, cy, count, cvalid,
                                     out, stream)
             : launch<Key, kMaxEvents / kThreads, false>(p, pl.smem, n_windows, x, y, valid, cx,
                                                         cy, count, cvalid, out, stream);
}

}  // namespace

// Bytes of device scratch per window that a launch with these sizes needs
// (0: none); the wrapper allocates n_windows times that and passes it to
// the launch.
extern "C" long long patch_metrics_scratch_bytes(int n_events, int n_slots, int width,
                                                 int height) {
  if (n_events < 0 || n_slots < 0 || width < 1 || height < 1) return 0;
  return static_cast<long long>(plan(make_params(n_events, n_slots, width, height)).scratch_bytes);
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
    int width, int height, void* out, void* scratch, void* stream) {
  if (n_events < 0 || n_slots < 0 || width < 1 || height < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_windows == 0 || n_slots == 0) return 0;
  Params p = make_params(n_events, n_slots, width, height);
  const Plan pl = plan(p);
  if (pl.scratch_bytes) {
    if (!scratch) return static_cast<int>(cudaErrorInvalidValue);
    p.scratch = static_cast<unsigned char*>(scratch);
    p.scratch_stride = static_cast<long long>(pl.scratch_bytes);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pl.wide ? launch_path<unsigned long long>(pl, p, n_windows, x, y, valid, cx, cy, count,
                                                   cvalid, out, st)
                 : launch_path<uint32_t>(pl, p, n_windows, x, y, valid, cx, cy, count, cvalid,
                                         out, st);
}
