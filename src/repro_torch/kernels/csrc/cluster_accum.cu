// Fused quantize + per-cell accumulation over a block of event windows, and
// the clustering stage built on it: the top-K clusters of each window.
//
// Replaces the TPU kernel repro/kernels/cluster_accum.py:cluster_accum
// (a one-hot (4, TILE) @ (TILE, CELLS) matmul per event tile) and, in the
// stage entry, the tensor ops of core/grid_clustering.py:
// clusters_from_histogram that followed it. One kernel, two entries:
//
//   rows  (cluster_accum_launch): the four (W, n_cells) rows count, sum_x,
//         sum_y, sum_t, the TPU kernel's own function;
//   stage (cluster_accum_topk_launch): the (W, K) clusters, in lax.top_k's
//         order (counts descending, ties to the lowest cell), with no
//         n_cells row written to device memory.
//
// Grid: one CTA of 256 threads per window. A window's cells need one
// shared table (24 KB at 1,200 cells), and a stream feed of 1-2 windows
// is a launch floor whatever the grid. Per window:
//
//   1. the window's n_cells x {count, sum_x, sum_y, sum_t} in shared
//      memory, scattered with shared-memory atomics, each thread striding
//      over the events, so E has no bound here. Every accumulator is an
//      integer (int32 for count, sum_x and sum_y; int64 for sum_t), so the
//      sums are exact whatever order the atomics land in, and each is cast
//      to float32 once. The reference's float32 sums are exact too while
//      every partial sum stays below 2^24: at the pipeline's default
//      contract (256 events per window, window-relative t < 20,000 us)
//      sum_t <= 256 * 20,000 = 5.12e6 < 2^24 = 1.68e7, and sum_x <= 256 *
//      640. Past that (long stride windows, large capacities) the int64
//      sum is still exact and is rounded once, where float32 sums round
//      per add: the two then differ by at most (n + 1) 2^-24 sum|t| in
//      sum_t and (n + 3) 2^-24 sum|t| / n in centroid_t, n the cell's
//      count (kernels/ref.py:sum_t_bound). The rows entry then writes each
//      row once, coalesced.
//   2. (stage) top-K as the fixed-point megakernel (window_pipeline.cu
//      step 5) does it: a slot whose count is below min_events outputs
//      constants (count 0, cells -1, centroids -1), so the valid slots are
//      a prefix of top_k's order and only the cells with count >=
//      max(min_events, 1) are ranked: at most min(E, n_cells) of them, by
//      one block sort of the key (E - count, cell). With min_events <= 0
//      the slots after them take the cells with no event, lowest first,
//      as top_k does.
//   3. (stage) each slot's fields: centroid = float(sum) / max(float(count),
//      1) with IEEE division, as the reference divides its float32 sums.
//
// Two paths, picked at launch from the sizes. The small one (E <= 1024,
// K <= 128, the main path's) sorts 32-bit keys in registers, at most
// 1,024 of them. The large one takes any E and any K <= n_cells: 64-bit
// keys (count above, cell below, so no bit budget), sorted in place in
// memory by a bitonic network of compare-exchange passes, at most
// min(E, n_cells) keys; the slot loop strides over K. Its table and keys
// lie in dynamic shared memory (up to the card's 227 KB a CTA) or, where
// they do not fit (cells of a few pixels), in a per-window scratch area
// in device memory that the wrapper allocates; the code is the same,
// only the base pointer differs.
//
// What bounds it on the H100: bytes. It reads x, y and valid of every
// event and t of each in-sensor valid event. The rows entry writes 16
// bytes per cell (about 19 KB per window at 1,200 cells, the larger
// part); the stage entry writes 25 bytes per slot (0.8 KB at K = 32).
// The arithmetic is a few integer operations per event, two per cell for
// the selection scan and the sort of the counted cells.
//
// Out-of-sensor events (x or y outside [0, width) x [0, height)) are
// masked, never clipped into a neighbouring cell. Quantization is an
// arithmetic shift for power-of-two cells and a division otherwise; both
// equal floor division on the in-sensor (non-negative) coordinates.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sort.cuh"

namespace {

constexpr int kMaxEvents = 1024;  // the small path's bounds
constexpr int kMaxSlots = 128;

struct Params {
  int n_events;
  int cell_size, shift;  // shift >= 0 for power-of-two cells
  int grid_w, n_cells;
  int width, height;
  int min_events, k;  // the stage entry's
  int cbits;          // small path: candidate key = (E - count) << cbits | cell
  // Large path: the keys' offset from the table's base, and the per-window
  // scratch area in device memory (nullptr: dynamic shared memory).
  long long keys_offset;
  unsigned char* scratch;
  long long scratch_stride;
};

// Outputs: the rows entry's (W, n_cells) rows, or the stage entry's (3,
// W, K) float32 centroids x, y, t, (3, W, K) int32 count, cell_x, cell_y
// and (W, K) bool valid.
struct Out {
  int32_t* count;
  float* sum_x;
  float* sum_y;
  float* sum_t;
  float* cent;
  int32_t* ints;
  uint8_t* valid;
};

template <bool kTopK, int Items, bool kLarge>
__global__ void __launch_bounds__(kThreads) cluster_accum_kernel(
    const int32_t* __restrict__ x, const int32_t* __restrict__ y,
    const int32_t* __restrict__ t, const uint8_t* __restrict__ valid,
    const Params p, const Out o) {
  // Layout: int64 sum_t first (8-byte aligned), then three int32 rows,
  // then (stage) the keys: two buffers of sort_size(E) 32-bit keys on the
  // small path, one of sort_size(min(E, n_cells)) 64-bit keys at
  // keys_offset on the large path.
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* mem = smem;
  if constexpr (kLarge) {
    if (p.scratch) mem = p.scratch + static_cast<long long>(blockIdx.x) * p.scratch_stride;
  }
  const int n_cells = p.n_cells;
  unsigned long long* st = reinterpret_cast<unsigned long long*>(mem);
  int* cnt = reinterpret_cast<int*>(st + n_cells);
  int* sx = cnt + n_cells;
  int* sy = sx + n_cells;
  __shared__ int s_cand;

  const int tid = threadIdx.x;
  if (tid == 0) s_cand = 0;
  for (int c = tid; c < n_cells; c += kThreads) {
    st[c] = 0ull;
    cnt[c] = 0;
    sx[c] = 0;
    sy[c] = 0;
  }
  __syncthreads();

  // 1. Scatter.
  const int E = p.n_events;
  const long long base = static_cast<long long>(blockIdx.x) * E;
  for (int i = tid; i < E; i += kThreads) {
    const int xi = x[base + i];
    const int yi = y[base + i];
    if (!valid[base + i] || xi < 0 || xi >= p.width || yi < 0 || yi >= p.height) {
      continue;
    }
    const int cx = p.shift >= 0 ? (xi >> p.shift) : xi / p.cell_size;
    const int cy = p.shift >= 0 ? (yi >> p.shift) : yi / p.cell_size;
    const int cell = min(cy * p.grid_w + cx, n_cells - 1);
    atomicAdd(&cnt[cell], 1);
    atomicAdd(&sx[cell], xi);
    atomicAdd(&sy[cell], yi);
    // Two's complement: adding the sign-extended bits is int64 addition.
    atomicAdd(&st[cell], static_cast<unsigned long long>(
                             static_cast<long long>(t[base + i])));
  }
  __syncthreads();

  if constexpr (!kTopK) {
    const long long out = static_cast<long long>(blockIdx.x) * n_cells;
    for (int c = tid; c < n_cells; c += kThreads) {
      o.count[out + c] = cnt[c];
      o.sum_x[out + c] = static_cast<float>(sx[c]);
      o.sum_y[out + c] = static_cast<float>(sy[c]);
      o.sum_t[out + c] = static_cast<float>(static_cast<long long>(st[c]));
    }
  } else {
    // 2. The counted cells' keys, then one sort of them.
    const int floor_n = max(p.min_events, 1);
    int n_cand, n_top;
    const uint32_t* top = nullptr;                // small path
    const unsigned long long* top64 = nullptr;  // large path
    if constexpr (kLarge) {
      unsigned long long* keys = reinterpret_cast<unsigned long long*>(mem + p.keys_offset);
      for (int c0 = 0; c0 < n_cells; c0 += kThreads) {  // whole warps: warp_append
        const int c = c0 + tid;
        const int n = c < n_cells ? cnt[c] : 0;
        warp_append(n >= floor_n,
                    (static_cast<unsigned long long>(static_cast<uint32_t>(E - n)) << 32) |
                        static_cast<unsigned long long>(c),
                    keys, &s_cand);
      }
      __syncthreads();
      n_cand = s_cand;
      n_top = min(n_cand, p.k);
      if (n_cand > 1) {
        const int n = sort_size(n_cand);
        for (int e = n_cand + tid; e < n; e += kThreads) keys[e] = ~0ull;
        __syncthreads();
        memory_bitonic_sort(keys, n);
      }
      top64 = keys;
    } else {
      uint32_t* kbuf0 = reinterpret_cast<uint32_t*>(sy + n_cells);
      uint32_t* kbuf1 = kbuf0 + sort_size(E);
      for (int c0 = 0; c0 < n_cells; c0 += kThreads) {  // whole warps: warp_append
        const int c = c0 + tid;
        const int n = c < n_cells ? cnt[c] : 0;
        warp_append(n >= floor_n,
                    (static_cast<uint32_t>(E - n) << p.cbits) | static_cast<uint32_t>(c),
                    kbuf0, &s_cand);
      }
      __syncthreads();
      n_cand = s_cand;
      n_top = min(n_cand, p.k);
      top = kbuf0;
      if (n_cand > 1) {
        uint32_t v[Items];
#pragma unroll
        for (int it = 0; it < Items; ++it) {
          const int e = it * kThreads + tid;
          v[it] = e < n_cand ? kbuf0[e] : kFull;
        }
        __syncthreads();
        PingPong<uint32_t> pp{{kbuf0, kbuf1}, 0};
        bitonic_sort<uint32_t, Items>(v, sort_size(n_cand), pp);
        uint32_t* sorted = pp.take();
#pragma unroll
        for (int it = 0; it < Items; ++it) {
          const int e = it * kThreads + tid;
          if (e < n_top) sorted[e] = v[it];
        }
        top = sorted;
        __syncthreads();
      }
    }

    // 3. Slot fields. Valid slots are a prefix: the ranked cells, then
    //    (with min_events <= 0) the cells without an event.
    const int n_valid = p.min_events <= 0 ? p.k : n_top;
    const long long plane = static_cast<long long>(gridDim.x) * p.k;
    const long long w0 = static_cast<long long>(blockIdx.x) * p.k;
    for (int sl = tid; sl < p.k; sl += kThreads) {
      const bool ok = sl < n_valid;
      int n = 0, cell = -1;
      if (sl < n_top) {
        if constexpr (kLarge) {
          const unsigned long long key = top64[sl];
          cell = static_cast<int>(key & 0xffffffffull);
          n = E - static_cast<int>(key >> 32);
        } else {
          const uint32_t key = top[sl];
          cell = static_cast<int>(key & ((1u << p.cbits) - 1u));
          n = E - static_cast<int>(key >> p.cbits);
        }
      } else if (ok) {  // the (sl - n_top)-th cell with no event
        for (int c = 0, skip = sl - n_top;; ++c) {
          if (cnt[c] == 0 && skip-- == 0) {
            cell = c;
            break;
          }
        }
      }
      const float den = fmaxf(static_cast<float>(n), 1.0f);
      const long long q = w0 + sl;
      o.cent[q] = ok ? __fdiv_rn(static_cast<float>(sx[cell]), den) : -1.0f;
      o.cent[plane + q] = ok ? __fdiv_rn(static_cast<float>(sy[cell]), den) : -1.0f;
      o.cent[2 * plane + q] =
          ok ? __fdiv_rn(static_cast<float>(static_cast<long long>(st[cell])), den) : -1.0f;
      o.ints[q] = ok ? n : 0;
      o.ints[plane + q] = ok ? cell % p.grid_w : -1;
      o.ints[2 * plane + q] = ok ? cell / p.grid_w : -1;
      o.valid[q] = ok;
    }
  }
}

int bit_length(unsigned v) {
  int b = 0;
  while (v) {
    ++b;
    v >>= 1;
  }
  return b;
}

Params make_params(int n_events, int cell_size, int grid_w, int grid_h, int width,
                   int height) {
  Params p{};
  p.n_events = n_events;
  p.cell_size = cell_size;
  p.shift = -1;
  if ((cell_size & (cell_size - 1)) == 0) {
    p.shift = 0;
    while ((1 << p.shift) < cell_size) ++p.shift;
  }
  p.grid_w = grid_w;
  p.n_cells = grid_w * grid_h;
  p.width = width;
  p.height = height;
  return p;
}

// Launches Kernel on n_windows CTAs with smem bytes of dynamic shared
// memory; above the default, plan() has raised the kernel's limit.
template <auto Kernel>
int launch(size_t smem, int n_windows, cudaStream_t stream, const void* x, const void* y,
           const void* t, const void* valid, const Params& p, const Out& o) {
  if (smem > kDefaultSmem && smem > dynamic_smem_limit<Kernel>()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_windows == 0) return 0;
  Kernel<<<n_windows, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<const int32_t*>(t), static_cast<const uint8_t*>(valid), p, o);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory bytes of the cell table for n_cells cells.
size_t table_bytes(int n_cells) {
  return static_cast<size_t>(n_cells) * (sizeof(unsigned long long) + 3 * sizeof(int));
}

// Where a launch runs: the small path, or the large path with its table
// (and keys) in dynamic shared memory or in per-window device scratch.
struct Plan {
  bool large;
  size_t smem;           // dynamic shared memory bytes
  size_t scratch_bytes;  // per window, in device memory; 0: none
  long long keys_offset;
};

template <bool kTopK>
Plan plan(const Params& p) {
  Plan pl{};
  if constexpr (kTopK) {
    const int ebits = bit_length(static_cast<unsigned>(p.n_events > 0 ? p.n_events - 1 : 0));
    const size_t small = table_bytes(p.n_cells) + 2 * sizeof(uint32_t) * sort_size(p.n_events);
    if (p.n_events <= kMaxEvents && p.k <= kMaxSlots && p.cbits + ebits <= 32 &&
        (small <= kDefaultSmem ||
         small <= (p.n_events <= kThreads
                       ? dynamic_smem_limit<cluster_accum_kernel<true, 1, false>>()
                       : dynamic_smem_limit<
                             cluster_accum_kernel<true, kMaxEvents / kThreads, false>>()))) {
      pl.smem = small;
      return pl;
    }
    pl.large = true;
    pl.keys_offset = static_cast<long long>(round_up(table_bytes(p.n_cells), 8));
    const size_t bytes = round_up(
        pl.keys_offset +
            sizeof(unsigned long long) * sort_size(p.n_events < p.n_cells ? p.n_events : p.n_cells),
        16);
    if (bytes <= kDefaultSmem ||
        bytes <= dynamic_smem_limit<cluster_accum_kernel<true, 1, true>>()) {
      pl.smem = bytes;
    } else {
      pl.scratch_bytes = bytes;
    }
  } else {
    const size_t bytes = table_bytes(p.n_cells);
    if (bytes <= kDefaultSmem ||
        bytes <= dynamic_smem_limit<cluster_accum_kernel<false, 1, false>>()) {
      pl.smem = bytes;
    } else {
      pl.large = true;
      pl.scratch_bytes = round_up(bytes, 16);
    }
  }
  return pl;
}

Params topk_params(int n_events, int cell_size, int grid_w, int grid_h, int width, int height,
                   int min_events, int k) {
  Params p = make_params(n_events, cell_size, grid_w, grid_h, width, height);
  p.min_events = min_events;
  p.k = k;
  p.cbits = bit_length(static_cast<unsigned>(p.n_cells - 1));
  return p;
}

}  // namespace

// Bytes of device scratch per window that a launch with these sizes
// needs (0: none); the wrapper allocates n_windows times that and passes
// it to the launch. topk selects the stage entry.
extern "C" long long cluster_accum_scratch_bytes(int n_events, int cell_size, int grid_w,
                                                 int grid_h, int min_events, int k, int topk) {
  if (topk) {
    return static_cast<long long>(
        plan<true>(topk_params(n_events, cell_size, grid_w, grid_h, 1, 1, min_events, k))
            .scratch_bytes);
  }
  return static_cast<long long>(
      plan<false>(make_params(n_events, cell_size, grid_w, grid_h, 1, 1)).scratch_bytes);
}

// x, y, t: (n_windows, n_events) int32; valid: (n_windows, n_events) bool;
// count: (n_windows, n_cells) int32; sum_*: (n_windows, n_cells) float32;
// scratch: n_windows * cluster_accum_scratch_bytes(...) bytes, or null
// where that is 0. Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for arguments it does not take.
extern "C" int cluster_accum_launch(
    const void* x, const void* y, const void* t, const void* valid,
    int n_windows, int n_events, int cell_size, int grid_w, int grid_h,
    int width, int height, void* count, void* sum_x, void* sum_y,
    void* sum_t, void* scratch, void* stream) {
  Params p = make_params(n_events, cell_size, grid_w, grid_h, width, height);
  if (n_events < 0 || cell_size < 1 || p.n_cells < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Out o{};
  o.count = static_cast<int32_t*>(count);
  o.sum_x = static_cast<float*>(sum_x);
  o.sum_y = static_cast<float*>(sum_y);
  o.sum_t = static_cast<float*>(sum_t);
  const Plan pl = plan<false>(p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!pl.large) {
    return launch<cluster_accum_kernel<false, 1, false>>(pl.smem, n_windows, st, x, y, t, valid,
                                                         p, o);
  }
  if (!scratch) return static_cast<int>(cudaErrorInvalidValue);
  p.scratch = static_cast<unsigned char*>(scratch);
  p.scratch_stride = static_cast<long long>(pl.scratch_bytes);
  return launch<cluster_accum_kernel<false, 1, true>>(0, n_windows, st, x, y, t, valid, p, o);
}

// The stage entry. x, y, t, valid and scratch as above; cent: (3,
// n_windows, k) float32; ints: (3, n_windows, k) int32; cvalid:
// (n_windows, k) bool. Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for arguments it does not take (K
// outside [1, n_cells], as top_k refuses; no E is refused).
extern "C" int cluster_accum_topk_launch(
    const void* x, const void* y, const void* t, const void* valid,
    int n_windows, int n_events, int cell_size, int grid_w, int grid_h,
    int width, int height, int min_events, int k, void* cent, void* ints,
    void* cvalid, void* scratch, void* stream) {
  Params p = topk_params(n_events, cell_size, grid_w, grid_h, width, height, min_events, k);
  if (n_events < 0 || k < 1 || k > p.n_cells || cell_size < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Out o{};
  o.cent = static_cast<float*>(cent);
  o.ints = static_cast<int32_t*>(ints);
  o.valid = static_cast<uint8_t*>(cvalid);
  const Plan pl = plan<true>(p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!pl.large) {
    return n_events <= kThreads
               ? launch<cluster_accum_kernel<true, 1, false>>(pl.smem, n_windows, st, x, y, t,
                                                              valid, p, o)
               : launch<cluster_accum_kernel<true, kMaxEvents / kThreads, false>>(
                     pl.smem, n_windows, st, x, y, t, valid, p, o);
  }
  p.keys_offset = pl.keys_offset;
  if (pl.scratch_bytes) {
    if (!scratch) return static_cast<int>(cudaErrorInvalidValue);
    p.scratch = static_cast<unsigned char*>(scratch);
    p.scratch_stride = static_cast<long long>(pl.scratch_bytes);
  }
  return launch<cluster_accum_kernel<true, 1, true>>(pl.smem, n_windows, st, x, y, t, valid, p,
                                                     o);
}
