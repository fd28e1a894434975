// The ragged ingest wire decoded into the dense (4, S, W, cap) event
// planes and the (S, W, cap) validity mask, in one launch.
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
// bit of the bitplane). On a live feed of 1-2 windows that is a few KB,
// so the launch itself is the floor. Design:
//
//   1. one CTA per (sensor, window) row (a grid-stride loop past 2^31-1
//      rows), cap threads rounded up to a warp, at most 1,024 (more slots
//      go in further passes). The CTA reads its row's start and count
//      once; thread j takes slot j, so every plane is written coalesced,
//      once: x = bits 15:0 and y = bits 31:16 of word src, the 16-bit
//      delta zero-extended, bit src & 31 of pol[src >> 5], with src =
//      start + j clipped into [0, N) as the reference clips it; zeros
//      past the count.
//   2. when the spill lane holds entries, before that write: the CTA
//      scans the whole lane, strided over its threads, and each entry
//      whose position (negative ones counted from the end, those outside
//      [0, N) dropped, as the reference's mode="drop" scatter) is the
//      clipped source of a slot of this row records its lane index there
//      by an atomic max in shared memory; after a barrier each slot with
//      an entry takes its exact int32 values instead of the wire's. The
//      reference overlays in wire-position space and then gathers, so an
//      entry lands on every slot whose clipped source it is, and of two
//      entries at one position the later in the lane wins, as the plain
//      version's index_put does. The scan needs no order of positions.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

__global__ void __launch_bounds__(kMaxThreads) event_unpack_kernel(
    const uint32_t* __restrict__ words, const uint16_t* __restrict__ dt,
    const uint32_t* __restrict__ pol, const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ spill, int n, int m, int n_windows, long long rows,
    int cap, int32_t* __restrict__ packed, uint8_t* __restrict__ valid) {
  __shared__ int last[kMaxThreads];  // per slot of a pass: its spill entry, or -1
  const long long plane = rows * cap;
  const int tid = threadIdx.x;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long s = row / n_windows;
    const int32_t* off = offsets + s * (n_windows + 1) + (row - s * n_windows);
    const long long start = off[0];
    const long long count = static_cast<long long>(off[1]) - start;
    const int n_slots = static_cast<int>(min(max(count, 0LL), static_cast<long long>(cap)));
    int32_t* out = packed + row * cap;
    uint8_t* vout = valid + row * cap;
    for (int base = 0; base < cap; base += blockDim.x) {
      const int j = base + tid;
      const bool overlay = m > 0 && n_slots > base;  // uniform over the block
      if (overlay) {
        last[tid] = -1;
        __syncthreads();
        const long long hi_slot = min(n_slots, base + static_cast<int>(blockDim.x)) - 1;
        for (int e = tid; e < m; e += blockDim.x) {
          long long pos = spill[e];
          if (pos < 0) pos += n;
          if (pos < 0 || pos >= n) continue;  // sentinel padding, out of the wire
          // The slots q with clip(start + q, 0, n - 1) == pos.
          const long long lo = max(pos == 0 ? LLONG_MIN : pos - start, static_cast<long long>(base));
          const long long hi = min(pos == n - 1 ? LLONG_MAX : pos - start, hi_slot);
          for (long long q = lo; q <= hi; ++q) atomicMax(&last[q - base], e);
        }
        __syncthreads();
      }
      if (j < cap) {
        int32_t x = 0, y = 0, t = 0, p = 0;
        const bool v = j < n_slots;
        if (v && n > 0) {
          const int e = overlay ? last[tid] : -1;
          if (e >= 0) {
            x = spill[m + e];
            y = spill[2LL * m + e];
            t = spill[3LL * m + e];
            p = spill[4LL * m + e];
          } else {
            long long src = start + j;
            src = src < 0 ? 0 : (src > n - 1 ? n - 1 : src);  // the reference's clip
            const uint32_t word = words[src];
            x = static_cast<int32_t>(word & 0xFFFFu);
            y = static_cast<int32_t>(word >> 16);
            t = static_cast<int32_t>(dt[src]);
            p = static_cast<int32_t>((pol[src >> 5] >> (src & 31)) & 1u);
          }
        }
        out[j] = x;
        out[plane + j] = y;
        out[2 * plane + j] = t;
        out[3 * plane + j] = p;
        vout[j] = v;
      }
      // A thread resets only its own entry of `last` in the next pass, and
      // other threads write there only after that pass's first barrier.
    }
  }
}

}  // namespace

// words (n,) uint32, dt (n,) uint16, pol (n / 32,) uint32, offsets
// (n_sensors, n_windows + 1) int32, spill (5, m) int32. packed: (4,
// n_sensors, n_windows, cap) int32; valid: (n_sensors, n_windows, cap)
// bool. Returns cudaGetLastError() after the launch (0 on success); with
// no slot it launches nothing and returns 0.
extern "C" int event_unpack_launch(
    const void* words, const void* dt, const void* pol, const void* offsets,
    const void* spill, int n, int m, int n_sensors, int n_windows, int cap,
    void* packed, void* valid, void* stream) {
  const long long rows = static_cast<long long>(n_sensors) * n_windows;
  if (rows == 0 || cap <= 0) return 0;
  const int threads = cap >= kMaxThreads ? kMaxThreads : (cap + 31) / 32 * 32;
  const unsigned grid = static_cast<unsigned>(rows < INT_MAX ? rows : INT_MAX);
  event_unpack_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint16_t*>(dt),
      static_cast<const uint32_t*>(pol), static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(spill), n, m, n_windows, rows, cap,
      static_cast<int32_t*>(packed), static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}
