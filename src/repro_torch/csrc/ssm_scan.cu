// Mamba-1 selective scan for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/ssm_scan.py
// (ssm_scan_pallas / _ssm_kernel).  For each batch row b and channel d of
// d_inner, from h = 0:
//   h[n] = exp(dt[b,t,d] * A[d,n]) * h[n] + (dt[b,t,d] * x[b,t,d]) * B[b,t,n]
//   y[b,t,d] = sum_n h[n] * C[b,t,n]
// for t = 0 .. S-1; y (B, S, DI) and the final h (B, DI, N) are fp32.
//
// What bounds it on this card: memory.  x, dt and y are (B, S, DI) streams
// read or written once; B and C are (B, S, N) with N = 16, shared by every
// channel of a row; about 7 flops and one exp per (b, t, d, n).  At
// hymba-1.5b's prefill (B 16, S 64, DI 3200, N 16) that is ~36 MB against
// ~0.4 GFLOP, so bytes set the bound.
//
// Design: the recurrence is sequential in t and independent across (b, d),
// so one thread owns one (b, d) channel, holds its N-wide state and its row
// of A in registers, and loops over S; the TPU kernel's sequential chunk
// axis and (block_di, N) VMEM scratch become that loop and those registers.
// A block is 128 channels of one batch row: its x, dt and y accesses are
// coalesced along d, and every 32 steps it stages B_t and C_t (the same
// for all its channels) in shared memory.  N is 16, the state size of
// every Mamba-1 configuration in the repo.  Any S and any DI: the last
// channel block and the last time chunk are masked, not padded.  expf, not
// __expf, so the result holds fp32 tolerance against the plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;     // channels per block
constexpr int CHUNK = 32;        // time steps of B and C staged at once
constexpr int N_STATE = 16;      // the state size of every Mamba-1 config

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ A, float* __restrict__ y,
                float* __restrict__ h_out, int S, int DI) {
  __shared__ float sB[CHUNK * N];
  __shared__ float sC[CHUNK * N];
  const int b = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool active = d < DI;

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = active ? A[static_cast<long long>(d) * N + n] : 0.f;
    h[n] = 0.f;
  }
  const long long row = static_cast<long long>(b) * S;
  const float* Bb = Bm + row * N;
  const float* Cb = Cm + row * N;

  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    const int len = min(CHUNK, S - t0);
    __syncthreads();                 // the previous chunk is consumed
    for (int i = threadIdx.x; i < len * N; i += THREADS) {
      sB[i] = Bb[static_cast<long long>(t0) * N + i];
      sC[i] = Cb[static_cast<long long>(t0) * N + i];
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < len; ++t) {
      const long long off = (row + t0 + t) * DI + d;
      const float dtv = dt[off];
      const float dx = dtv * to_f(x[off]);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = h[n] * expf(dtv * a[n]) + dx * sB[t * N + n];
        acc += h[n] * sC[t * N + n];
      }
      y[off] = acc;
    }
  }
  if (active) {
    float* ho = h_out + (static_cast<long long>(b) * DI + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) ho[n] = h[n];
  }
}

}  // namespace

// x (B, S, DI) contiguous, dtype 0 = float32, 1 = bfloat16; dt (B, S, DI),
// Bm and Cm (B, S, 16), A (DI, 16), all float32 contiguous; y (B, S, DI)
// and h (B, DI, 16) float32 outputs.  Launches on `stream` and returns the
// launch's cudaError_t.
extern "C" int windve_ssm_scan(const void* x, const void* dt, const void* Bm,
                               const void* Cm, const void* A, void* y,
                               void* h, int dtype, int B, int S, int DI,
                               void* stream) {
  if (B <= 0 || DI <= 0) return cudaSuccess;
  if (S < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((DI + THREADS - 1) / THREADS, B);
  const float* dtp = static_cast<const float*>(dt);
  const float* bp = static_cast<const float*>(Bm);
  const float* cp = static_cast<const float*>(Cm);
  const float* ap = static_cast<const float*>(A);
  float* yp = static_cast<float*>(y);
  float* hp = static_cast<float*>(h);
  if (dtype == 0) {
    ssm_scan_kernel<float, N_STATE><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), dtp, bp, cp, ap, yp, hp, S, DI);
  } else if (dtype == 1) {
    ssm_scan_kernel<__nv_bfloat16, N_STATE><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), dtp, bp, cp, ap, yp, hp, S, DI);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
