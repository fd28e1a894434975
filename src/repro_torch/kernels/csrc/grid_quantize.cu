// The paper's grid-quantization IP core (Fig. 4) over a stream of packed
// event words: (y << 16) | x  ->  (cy << 16) | cx, cx = x / cell_size and
// cy = y / cell_size on the 16-bit fields.
//
// Replaces the TPU kernel repro/kernels/grid_quantize.py:
// grid_quantize_packed, which runs (8, 128) VMEM tiles of words through
// the VPU. No pipeline route reaches it, in the reference as here: the
// clustering stage quantizes inside cluster_accum.
//
// Bound on the H100: bytes, 8 per word (one uint32 read, one written);
// the arithmetic is a shift or an integer division and a few masks.
// Design: one thread per word in a grid-stride loop, neighbouring threads
// on neighbouring words, so loads and stores are coalesced. The division
// is a logical shift for a power-of-two cell size (the shipped 16) and an
// unsigned integer division otherwise, as in the TPU kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) grid_quantize_kernel(
    const uint32_t* __restrict__ words, long long n, uint32_t cell_size,
    int shift, uint32_t* __restrict__ out) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const uint32_t w = words[i];
    const uint32_t x = w & 0xFFFFu;
    const uint32_t y = w >> 16;
    uint32_t cx, cy;
    if (shift >= 0) {
      cx = x >> shift;
      cy = y >> shift;
    } else {
      cx = x / cell_size;
      cy = y / cell_size;
    }
    out[i] = (cy << 16) | cx;
  }
}

}  // namespace

extern "C" int grid_quantize_launch(const void* words, long long n,
                                    int cell_size, void* out, void* stream) {
  if (n == 0) return 0;
  int shift = -1;
  if ((cell_size & (cell_size - 1)) == 0) {
    shift = 0;
    while ((1 << shift) < cell_size) ++shift;
  }
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond
  grid_quantize_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n,
      static_cast<uint32_t>(cell_size), shift, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
