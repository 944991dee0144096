// Entry points and helpers shared by every kernel of the library.
#include <cuda_runtime.h>

#include "common.cuh"

extern "C" const char* windve_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

cudaError_t windve_sm_count(int* n) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev] > 0) {
    *n = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) cached[dev] = *n;
  return err;
}
