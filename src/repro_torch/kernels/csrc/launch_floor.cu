// launch_floor: an empty kernel, the yardstick of what one launch costs.
//
// It replaces no Pallas kernel and no main path launches it.  chip_smoke.py
// times it with the same CUDA-graph harness as the cache kernels, so a
// kernel's time beside this floor shows how much of it is the launch
// itself: the cache kernels move far fewer bytes than one launch's
// latency would carry.
//
// Bound on the H100: none; it reads and writes nothing.  One block of one
// thread.

#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

extern "C" int launch_floor_launch(void* stream) {
  launch_floor_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
