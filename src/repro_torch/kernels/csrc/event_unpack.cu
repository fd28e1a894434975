// The ragged ingest wire decoded into the dense (4, S, W, cap) event
// planes and the (S, W, cap) validity mask, in two launches on one stream.
//
// Replaces the TPU kernel repro/kernels/event_unpack.py:event_unpack and
// the decode around it (repro/core/events.py:unpack_wire, the route
// make_wire_fn(capacity, use_kernels=True) of the stream and fleet
// drivers). The TPU kernel splits (8, 128) tiles of words into x and y
// and leaves the delta lane, the polarity bitplane, the spill overlay and
// the CSR gather to XLA; here the whole decode is the kernel, so the
// wire is read once and each dense plane written once.
//
// Bound on the H100: bytes. Per dense slot it writes 17 bytes (four
// int32 and a bool) and per wire event it reads 6.125 (word, delta, a
// bit of the bitplane); the arithmetic is a few integer operations a
// slot. Design:
//
//   1. gather: one thread per dense slot (s, w, slot), consecutive threads
//      on consecutive slots of one window, so every plane is written
//      coalesced. count = off[s,w+1] - off[s,w], src = off[s,w] + slot;
//      a slot below its count unpacks word src (x = bits 15:0, y = bits
//      31:16), zero-extends the 16-bit delta and takes bit src & 31 of
//      pol[src >> 5]; every other slot writes zeros.
//   2. overlay: one thread per spill entry writes its exact int32 values
//      into the slot that holds its wire position, found by a binary
//      search over the window starts, which never decrease along the
//      flattened (S * W) rows. It runs after the gather on the same
//      stream, so the two never race for a slot.
//
// The reference overlays in wire-position space before its gather; the
// two orders agree on every wire the packer writes: offsets are
// non-decreasing, each row ends where the next begins, they lie within
// [0, N], counts are at most cap and spill positions are distinct. As in
// the reference's mode="drop" scatter, a position outside [-N, N) is
// dropped and a negative one counts from the end.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) gather_kernel(
    const uint32_t* __restrict__ words, const uint16_t* __restrict__ dt,
    const uint32_t* __restrict__ pol, const int32_t* __restrict__ offsets,
    int n, int n_sensors, int n_windows, int cap, int32_t* __restrict__ packed,
    uint8_t* __restrict__ valid) {
  const long long plane = static_cast<long long>(n_sensors) * n_windows * cap;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < plane; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = i / cap;
    const int slot = static_cast<int>(i - row * cap);
    const int s = static_cast<int>(row / n_windows);
    const int w = static_cast<int>(row - static_cast<long long>(s) * n_windows);
    const int32_t* off = offsets + static_cast<long long>(s) * (n_windows + 1) + w;
    const long long start = off[0];
    const long long count = static_cast<long long>(off[1]) - start;
    int32_t x = 0, y = 0, t = 0, p = 0;
    const bool v = slot < count;
    if (v) {
      long long src = start + slot;
      src = src < 0 ? 0 : (src > n - 1 ? n - 1 : src);  // the reference's clip
      const uint32_t word = words[src];
      x = static_cast<int32_t>(word & 0xFFFFu);
      y = static_cast<int32_t>(word >> 16);
      t = static_cast<int32_t>(dt[src]);
      p = static_cast<int32_t>((pol[src >> 5] >> (src & 31)) & 1u);
    }
    packed[i] = x;
    packed[plane + i] = y;
    packed[2 * plane + i] = t;
    packed[3 * plane + i] = p;
    valid[i] = v;
  }
}

__global__ void __launch_bounds__(kThreads) overlay_kernel(
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ spill,
    int n, int m, int n_sensors, int n_windows, int cap,
    int32_t* __restrict__ packed) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  long long pos = spill[e];
  if (pos < 0) pos += n;
  if (pos < 0 || pos >= n) return;  // sentinel padding, out of the wire
  const long long rows = static_cast<long long>(n_sensors) * n_windows;
  // Last row whose start is <= pos; row r's start is
  // offsets[(r / W) * (W + 1) + r % W].
  long long lo = 0, hi = rows - 1, found = -1;
  while (lo <= hi) {
    const long long mid = (lo + hi) / 2;
    const long long ms = mid / n_windows;
    const int32_t start = offsets[ms * (n_windows + 1) + (mid - ms * n_windows)];
    if (start <= pos) {
      found = mid;
      lo = mid + 1;
    } else {
      hi = mid - 1;
    }
  }
  if (found < 0) return;
  const long long fs = found / n_windows;
  const int32_t* off = offsets + fs * (n_windows + 1) + (found - fs * n_windows);
  const long long slot = pos - off[0];
  if (pos >= off[1] || slot >= cap) return;  // in no window's kept rows
  const long long plane = rows * cap;
  const long long i = found * cap + slot;
  for (int lane = 0; lane < 4; ++lane)
    packed[lane * plane + i] = spill[static_cast<long long>(lane + 1) * m + e];
}

}  // namespace

extern "C" int event_unpack_launch(
    const void* words, const void* dt, const void* pol, const void* offsets,
    const void* spill, int n, int m, int n_sensors, int n_windows, int cap,
    void* packed, void* valid, void* stream) {
  const long long plane = static_cast<long long>(n_sensors) * n_windows * cap;
  if (plane == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long blocks = (plane + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;  // grid-stride beyond
  gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint16_t*>(dt),
      static_cast<const uint32_t*>(pol), static_cast<const int32_t*>(offsets),
      n, n_sensors, n_windows, cap, static_cast<int32_t*>(packed),
      static_cast<uint8_t*>(valid));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || m == 0) return static_cast<int>(err);
  overlay_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const int32_t*>(offsets), static_cast<const int32_t*>(spill),
      n, m, n_sensors, n_windows, cap, static_cast<int32_t*>(packed));
  return static_cast<int>(cudaGetLastError());
}
