// The number of SMs of the current device, read once a process.  The
// launch policies of the small kernels (lease_apply.cu, global_mesh.cu)
// size their blocks and lanes by it, so that a small window spreads over
// the card instead of queueing on a few SMs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess && n > 0) {
      sms = n;
    } else {
      cudaGetLastError();  // leave no error for the launch check
      sms = 132;           // the H100 SXM's
    }
  }
  return sms;
}

// Threads a block for a launch of n items, one a thread, on `sms` SMs:
// the least power of two from 32 to 256 with at most `sms` blocks' worth
// of items each.
inline int spread_threads(int64_t n, int sms) {
  int threads = 32;
  while (threads < 256 && (int64_t)threads * sms < n) threads *= 2;
  return threads;
}
