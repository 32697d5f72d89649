// The number of SMs of the current device, read once a process.  The
// launch policies of the small kernels (lease_apply.cu, global_mesh.cu)
// size their blocks and lanes by it, so that a small window spreads over
// the card instead of queueing on a few SMs.
#pragma once

#include <cuda_runtime.h>

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
