// An empty kernel: its launch-to-launch time on a stream is the practical
// floor under any kernel launch.  Not part of the kernels' library:
// chip_smoke.py builds it alone and prints its time beside the chain
// kernels' times.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int delphy_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
