// Fused quantize + per-cell accumulation over a block of event windows.
//
// Replaces the TPU kernel repro/kernels/cluster_accum.py:cluster_accum
// (a one-hot (4, TILE) @ (TILE, CELLS) matmul per event tile). Here one
// CTA owns one window: it keeps the window's n_cells x {count, sum_x,
// sum_y, sum_t} in shared memory, scatters its events with shared-memory
// atomics, and writes the four rows once.
//
// Exactness: every accumulator is an integer (int32 for count, sum_x and
// sum_y; int64 for sum_t), so the sums are exact whatever order the
// atomics land in, and each is cast to float32 once at the end. The
// reference's float32 sums are exact too while every partial sum stays
// below 2^24: at the pipeline's contract (256 events per window, window-
// relative t < 20,000 us) sum_t <= 256 * 20,000 = 5.12e6 < 2^24 = 1.68e7,
// and sum_x <= 256 * 640. Out of contract (huge t) the int64 sum is still
// exact and is rounded once, where float32 sums would round per add.
//
// Out-of-sensor events (x or y outside [0, width) x [0, height)) are
// masked, never clipped into a neighbouring cell. Quantization is an
// arithmetic shift for power-of-two cells and a division otherwise; both
// equal floor division on the in-sensor (non-negative) coordinates.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) cluster_accum_kernel(
    const int32_t* __restrict__ x, const int32_t* __restrict__ y,
    const int32_t* __restrict__ t, const uint8_t* __restrict__ valid,
    int n_events, int cell_size, int shift, int grid_w, int n_cells,
    int width, int height, int32_t* __restrict__ count,
    float* __restrict__ sum_x, float* __restrict__ sum_y,
    float* __restrict__ sum_t) {
  // Layout: int64 sum_t first (8-byte aligned), then three int32 rows.
  extern __shared__ __align__(8) unsigned char smem[];
  unsigned long long* st = reinterpret_cast<unsigned long long*>(smem);
  int* cnt = reinterpret_cast<int*>(st + n_cells);
  int* sx = cnt + n_cells;
  int* sy = sx + n_cells;
  for (int c = threadIdx.x; c < n_cells; c += blockDim.x) {
    st[c] = 0ull;
    cnt[c] = 0;
    sx[c] = 0;
    sy[c] = 0;
  }
  __syncthreads();

  const long long base = static_cast<long long>(blockIdx.x) * n_events;
  for (int i = threadIdx.x; i < n_events; i += blockDim.x) {
    const int xi = x[base + i];
    const int yi = y[base + i];
    if (!valid[base + i] || xi < 0 || xi >= width || yi < 0 || yi >= height) {
      continue;
    }
    const int cx = shift >= 0 ? (xi >> shift) : xi / cell_size;
    const int cy = shift >= 0 ? (yi >> shift) : yi / cell_size;
    const int cell = min(max(cy * grid_w + cx, 0), n_cells - 1);
    atomicAdd(&cnt[cell], 1);
    atomicAdd(&sx[cell], xi);
    atomicAdd(&sy[cell], yi);
    // Two's complement: adding the sign-extended bits is int64 addition.
    atomicAdd(&st[cell], static_cast<unsigned long long>(
                             static_cast<long long>(t[base + i])));
  }
  __syncthreads();

  const long long out = static_cast<long long>(blockIdx.x) * n_cells;
  for (int c = threadIdx.x; c < n_cells; c += blockDim.x) {
    count[out + c] = cnt[c];
    sum_x[out + c] = static_cast<float>(sx[c]);
    sum_y[out + c] = static_cast<float>(sy[c]);
    sum_t[out + c] = static_cast<float>(static_cast<long long>(st[c]));
  }
}

// Shared memory bytes one CTA needs for n_cells cells.
size_t smem_bytes(int n_cells) {
  return static_cast<size_t>(n_cells) * (sizeof(unsigned long long) + 3 * sizeof(int));
}

}  // namespace

// x, y, t: (n_windows, n_events) int32; valid: (n_windows, n_events) bool;
// count: (n_windows, n_cells) int32; sum_*: (n_windows, n_cells) float32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int cluster_accum_launch(
    const void* x, const void* y, const void* t, const void* valid,
    int n_windows, int n_events, int cell_size, int grid_w, int grid_h,
    int width, int height, void* count, void* sum_x, void* sum_y,
    void* sum_t, void* stream) {
  const int n_cells = grid_w * grid_h;
  const size_t smem = smem_bytes(n_cells);
  cudaError_t err = cudaFuncSetAttribute(
      cluster_accum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_windows == 0) return 0;
  int shift = -1;
  if ((cell_size & (cell_size - 1)) == 0) {
    shift = 0;
    while ((1 << shift) < cell_size) ++shift;
  }
  cluster_accum_kernel<<<n_windows, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y),
      static_cast<const int32_t*>(t), static_cast<const uint8_t*>(valid),
      n_events, cell_size, shift, grid_w, n_cells, width, height,
      static_cast<int32_t*>(count), static_cast<float*>(sum_x),
      static_cast<float*>(sum_y), static_cast<float*>(sum_t));
  return static_cast<int>(cudaGetLastError());
}
