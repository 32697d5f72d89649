// An empty kernel for Hopper (sm_90a): the launch-overhead yardstick.
//
// chip_smoke.py phase 2 times one launch of it the way it times the
// other kernels (CUDA events around launches queued behind a device
// sleep), so a kernel's time can be read against what a launch alone
// costs on the card.  One block of one thread that does nothing.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int gt_empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
