// Fused masked pooling + L2 normalisation for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/pool_norm/pool_norm.py
// (pool_norm_pallas / _pool_norm_kernel), the embedder's serving epilogue:
//   mean: pooled = sum_s h[b,s] * mask[b,s] / max(sum_s mask[b,s], 1)
//   cls:  pooled = h[b,0] * min(mask[b,0], 1)
//   out[b] = pooled / max(||pooled||, 1e-9), fp32 for fp32 or bf16 input.
// A fully masked row pools to the zero vector.
//
// What bounds it on this card: memory.  Mean pooling reads the (B, S, D)
// hidden states once and writes (B, D) fp32; CLS reads only token 0 of each
// row.  The arithmetic is one multiply-add per element read.
//
// Design: one thread block per batch row, threads across D, so each step
// of the sequence loop is one coalesced read of a D-wide row.  The pooled
// row is kept in shared memory (D floats) while a warp-shuffle block
// reduction forms ||pooled||^2, then each thread scales and writes its own
// dims.  Accumulation is fp32 for any input type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
pool_norm_kernel(const T* __restrict__ h, const float* __restrict__ mask,
                 float* __restrict__ out, int S, int D, int mean) {
  extern __shared__ float pooled[];     // D floats
  __shared__ float partial[THREADS / 32];
  const int b = blockIdx.x;
  const T* hb = h + (long long)b * S * D;
  const float* mb = mask + (long long)b * S;

  float ss = 0.f;
  if (mean) {
    float msum = 0.f;
    for (int s = 0; s < S; ++s) msum += mb[s];
    const float denom = fmaxf(msum, 1.f);
    for (int d = threadIdx.x; d < D; d += THREADS) {
      float acc = 0.f;
      for (int s = 0; s < S; ++s) acc += to_f(hb[(long long)s * D + d]) * mb[s];
      const float p = acc / denom;
      pooled[d] = p;
      ss += p * p;
    }
  } else {
    const float w = fminf(mb[0], 1.f);
    for (int d = threadIdx.x; d < D; d += THREADS) {
      const float p = to_f(hb[d]) * w;
      pooled[d] = p;
      ss += p * p;
    }
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
  const float nrm = fmaxf(sqrtf(partial[0]), 1e-9f);
  float* ob = out + (long long)b * D;
  for (int d = threadIdx.x; d < D; d += THREADS) ob[d] = pooled[d] / nrm;
}

}  // namespace

// h (B, S, D) contiguous, dtype 0 = float32, 1 = bfloat16; mask (B, S)
// float32 contiguous; out (B, D) float32.  mean = 1 for masked mean
// pooling, 0 for CLS.  Launches on `stream` and returns the launch's
// cudaError_t.
extern "C" int windve_pool_norm(const void* h, const void* mask, void* out,
                                int dtype, int B, int S, int D, int mean,
                                void* stream) {
  if (B <= 0 || D <= 0) return cudaSuccess;
  if (S <= 0) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    pool_norm_kernel<float><<<B, THREADS, smem, st>>>(
        static_cast<const float*>(h), static_cast<const float*>(mask),
        static_cast<float*>(out), S, D, mean);
  } else if (dtype == 1) {
    pool_norm_kernel<__nv_bfloat16><<<B, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(h), static_cast<const float*>(mask),
        static_cast<float*>(out), S, D, mean);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
