// Fused RMSNorm for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/rmsnorm.py
// (rmsnorm_pallas / _rmsnorm_kernel): for each row of x (R, D),
//   out = x * rsqrt(mean(x^2) + eps) * scale,
// the mean square and the products in fp32, the result in x's type.
//
// What bounds it on this card: memory.  It reads each row once, writes it
// once and reads the (D,) scale; three flops an element.  hymba-1.5b runs
// it on (B*S, 1600) rows at prefill and (B, 1600) at decode.
//
// Design: one thread block a row, threads across D, so each pass is one
// coalesced sweep of the row; a warp-shuffle block reduction forms the sum
// of squares, then each thread scales its own elements (the second read of
// the row comes from L1/L2).  The TPU kernel's (block_rows, D) VMEM tile
// becomes one block per row, with no padding of the ragged last tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, long long ldx,
               const float* __restrict__ scale, T* __restrict__ out, int D,
               float eps) {
  __shared__ float partial[THREADS / 32];
  const T* xr = x + blockIdx.x * ldx;
  T* orow = out + static_cast<long long>(blockIdx.x) * D;

  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    const float v = to_f(xr[d]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = warp_sum(lane < THREADS / 32 ? partial[lane] : 0.f);
    if (lane == 0) partial[0] = ss;
  }
  __syncthreads();
  const float inv = rsqrtf(partial[0] / static_cast<float>(D) + eps);
  for (int d = threadIdx.x; d < D; d += THREADS)
    orow[d] = from_f<T>(to_f(xr[d]) * inv * scale[d]);
}

}  // namespace

// x (R, D) with row stride ldx and unit column stride, dtype 0 = float32,
// 1 = bfloat16; scale (D,) float32 contiguous; out (R, D) contiguous, x's
// type.  Launches on `stream` and returns the launch's cudaError_t.
extern "C" int windve_rmsnorm(const void* x, long long ldx, const void* scale,
                              void* out, int dtype, int R, int D, float eps,
                              void* stream) {
  if (R <= 0 || D <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == 0) {
    rmsnorm_kernel<float><<<R, THREADS, 0, st>>>(
        static_cast<const float*>(x), ldx, sc, static_cast<float*>(out), D,
        eps);
  } else if (dtype == 1) {
    rmsnorm_kernel<__nv_bfloat16><<<R, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), ldx, sc,
        static_cast<__nv_bfloat16*>(out), D, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
