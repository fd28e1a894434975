// Facts of the current device that the launches ask for, asked once per
// device and kept, so a plan or a launch after the first makes no runtime
// call but cudaGetDevice. Each kernel's source is its own translation
// unit, so everything here has internal linkage.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace {

// ask(dev) for the current device, called once per device (per distinct
// Ask type, so each call site keeps its own values); `fallback` where the
// device cannot be read. ask must leave no CUDA error behind.
template <typename Ask>
long long per_device(Ask ask, long long fallback) {
  constexpr int kMaxDevices = 64;
  static std::atomic<long long> known[kMaxDevices];  // value + 1; 0: not asked yet
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return fallback;
  long long v = known[dev].load(std::memory_order_relaxed);
  if (v == 0) {
    v = ask(dev) + 1;
    known[dev].store(v, std::memory_order_relaxed);
  }
  return v - 1;
}

// Streaming multiprocessors of the current device (1 where it cannot be
// read).
inline int sm_count() {
  return static_cast<int>(per_device(
      [](int dev) -> long long {
        int n = 0;
        if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
            n < 1) {
          cudaGetLastError();
          n = 1;
        }
        return n;
      },
      1));
}

// Dynamic shared memory a CTA may take without raising a kernel's limit.
constexpr size_t kDefaultSmem = 48 * 1024;

// Dynamic shared memory one CTA of Kernel may take on the current device
// (the opt-in limit less the kernel's static shared memory), with the
// kernel's own limit raised to it. 0 where it cannot be had: launches then
// stay within kDefaultSmem and larger data go to device scratch.
template <auto Kernel>
size_t dynamic_smem_limit() {
  return static_cast<size_t>(per_device(
      [](int dev) -> long long {
        int optin = 0;
        cudaFuncAttributes fa{};
        size_t lim = 0;
        if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) ==
                cudaSuccess &&
            cudaFuncGetAttributes(&fa, Kernel) == cudaSuccess &&
            optin > static_cast<int>(fa.sharedSizeBytes)) {
          lim = static_cast<size_t>(optin) - fa.sharedSizeBytes;
          if (cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(lim)) != cudaSuccess) {
            lim = 0;
          }
        }
        if (lim == 0) cudaGetLastError();  // leave no error for the next launch to report
        return static_cast<long long>(lim);
      },
      0));
}

}  // namespace
