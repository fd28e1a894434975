// Block-wide bitonic sort and scan for CTAs of kThreads threads, shared by
// the kernels that sort a window's events or its counted cells
// (window_pipeline.cu, patch_metrics.cu, cluster_accum.cu). Each kernel's
// source is its own translation unit, so everything here has internal
// linkage.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Keys a sort takes: max(32, the power of two >= n).
__host__ __device__ __forceinline__ int sort_size(int n) {
  int s = 32;
  while (s < n) s <<= 1;
  return s;
}

// Each thread of the warp whose flag is set appends v to list, at indices
// taken from the shared counter *n; the whole warp calls it. The order of
// the appended values is not defined.
template <typename T>
__device__ __forceinline__ void warp_append(bool flag, T v, T* list, int* n) {
  const unsigned ballot = __ballot_sync(kFull, flag);
  if (!ballot) return;
  const int lane = threadIdx.x & 31;
  int at = 0;
  if (lane == 0) at = atomicAdd(n, __popc(ballot));
  at = __shfl_sync(kFull, at, 0);
  if (flag) list[at + __popc(ballot & ((1u << lane) - 1u))] = v;
}

template <typename Key>
__device__ __forceinline__ Key shfl_xor(Key v, int m) {
  constexpr int n = sizeof(Key) / 4;
  uint32_t w[n];
  memcpy(w, &v, sizeof(Key));
#pragma unroll
  for (int i = 0; i < n; ++i) w[i] = __shfl_xor_sync(kFull, w[i], m);
  memcpy(&v, w, sizeof(Key));
  return v;
}

// Two shared buffers taken in turn: a buffer written after a barrier is
// never the one other threads may still read from before it.
template <typename Key>
struct PingPong {
  Key* buf[2];
  int next;
  __device__ Key* take() {
    Key* b = buf[next];
    next ^= 1;
    return b;
  }
};

// The bitonic step on element e against its partner p: the lower element
// of the pair keeps the smaller key on an ascending run.
template <typename Key>
__device__ __forceinline__ Key bitonic_pick(Key a, Key p, int e, int j, int k) {
  const bool keep_min = !(e & j) == !(e & k);
  return keep_min ? (p < a ? p : a) : (p > a ? p : a);
}

template <typename Key>
__device__ __forceinline__ void bitonic_swap(Key& a, Key& b, int e, int k) {
  if ((a > b) == !(e & k)) {
    const Key t = a;
    a = b;
    b = t;
  }
}

// Sorts, ascending, the n keys (n a power of two, 32 <= n <= Items *
// kThreads) that the block holds in registers: element e = it * kThreads
// + tid in v[it]. Every thread of the block calls it.
template <typename Key, int Items>
__device__ void bitonic_sort(Key (&v)[Items], int n, PingPong<Key>& pp) {
  const int tid = threadIdx.x;
  const int items = n > kThreads ? n / kThreads : 1;
  const bool holds = tid < n;  // whole warps: n is a multiple of 32
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= kThreads) {  // the partner is this thread's item it ^ (j / kThreads)
        if constexpr (Items == 4) {
          if (j == 2 * kThreads) {
            bitonic_swap(v[0], v[2], tid, k);
            bitonic_swap(v[1], v[3], kThreads + tid, k);
          } else {
            bitonic_swap(v[0], v[1], tid, k);
            if (items == 4) bitonic_swap(v[2], v[3], 2 * kThreads + tid, k);
          }
        }
      } else if (j >= 32) {  // the partner is in another warp
        Key* b = pp.take();
#pragma unroll
        for (int it = 0; it < Items; ++it)
          if (it < items && holds) b[it * kThreads + tid] = v[it];
        __syncthreads();
#pragma unroll
        for (int it = 0; it < Items; ++it) {
          const int e = it * kThreads + tid;
          if (it < items && holds) v[it] = bitonic_pick(v[it], b[e ^ j], e, j, k);
        }
      } else {  // the partner is in this warp
#pragma unroll
        for (int it = 0; it < Items; ++it) {
          const int e = it * kThreads + tid;
          if (it < items && holds) v[it] = bitonic_pick(v[it], shfl_xor(v[it], j), e, j, k);
        }
      }
    }
  }
}

// Sorts, ascending and in place, the n keys (n a power of two) at a, which
// may lie in shared or in device memory: each step of the bitonic network
// is a pass of compare-exchanges over the n / 2 pairs, then a barrier (a
// barrier orders the block's device memory accesses too). The large-size
// paths of the kernels take it where a window's keys outgrow the register
// sort above. Every thread of the block calls it; it ends on a barrier.
template <typename Key>
__device__ void memory_bitonic_sort(Key* a, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += kThreads) {
        const int lo = 2 * j * (i / j) + (i % j);  // bit j of lo is clear
        const Key a0 = a[lo], a1 = a[lo + j];
        if ((a0 > a1) == !(lo & k)) {
          a[lo] = a1;
          a[lo + j] = a0;
        }
      }
      __syncthreads();
    }
  }
}

__host__ __device__ __forceinline__ size_t round_up(size_t v, size_t m) {
  return (v + m - 1) / m * m;
}

// Inclusive block-wide sums (uint32, wrapping) of N values per element,
// in element order e = it * kThreads + tid; total gets the block's sums.
// wsum (Items * kWarps * N words) must not be read by another call
// before a barrier separates the two.
template <int N, int Items>
__device__ void block_scan(uint32_t (&v)[Items][N], int items, uint32_t* wsum,
                           uint32_t (&total)[N]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int it = 0; it < Items; ++it) {
    if (it >= items) break;
#pragma unroll
    for (int q = 0; q < N; ++q) {
      uint32_t x = v[it][q];
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      v[it][q] = x;
      if (lane == 31) wsum[(it * kWarps + warp) * N + q] = x;
    }
  }
  __syncthreads();
  // Every warp scans the items * kWarps (<= 32) warp totals itself.
  const int m = items * kWarps;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const uint32_t own = lane < m ? wsum[lane * N + q] : 0u;
    uint32_t s = own;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    total[q] = __shfl_sync(kFull, s, 31);
    const uint32_t before = s - own;
#pragma unroll
    for (int it = 0; it < Items; ++it)
      if (it < items) v[it][q] += __shfl_sync(kFull, before, it * kWarps + warp);
  }
}

}  // namespace
