// int8 projection kernels for NVIDIA Hopper (sm_90a): the weight-only GEMM,
// the per-row activation quantizer and the int8 x int8 GEMM of the W8A8
// policy.  Plain C entry points at the end, bound with ctypes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// windve_quant_matmul: out[m, n] = (sum_k x[m, k] * w8[k, n]) * scale[n]
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul/quant_matmul.py:111
// (quant_matmul_pallas / _quant_matmul_kernel), the weight-only int8
// projection of the `int8` serving policy.
//
// What bounds it on this card: operations.  The policy computes in fp32 and
// is held to the fp32 path's tolerance, so the products run as fp32 FMAs on
// the CUDA cores (67 TFLOP/s, no TF32, no tensor cores); at bge's shapes
// (M = 1536, K and N of 1024 and 4096) the 2*M*K*N operations take
// longer than moving x, w8 and out once (12x to 18x).
//
// Design: a classic shared-memory tiled GEMM.  A block owns a 64 x 64
// output tile and walks K in steps of 16.  Each step stages a 64 x 16 tile
// of x (fp32, or bf16 widened to fp32) and a 16 x 64 tile of w8 in shared
// memory; a weight byte is read from device memory once as int8 and widened
// to fp32 once, on its way into shared memory, not once per use by each of
// the 16 threads that read it.  Each of the 256 threads keeps a 4 x 4
// register tile of fp32 sums and reads its operands as float4.  The scale
// multiplies each sum once, after the K loop, then the result is cast to
// x's type.  Ragged M, N and K are zero-filled in shared memory, so a
// padded lane adds exactly 0.
// ---------------------------------------------------------------------------
constexpr int QM_BM = 64, QM_BN = 64, QM_BK = 16, QM_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(QM_THREADS)
quant_matmul_kernel(const T* __restrict__ x, long long ldx,
                    const int8_t* __restrict__ w,
                    const float* __restrict__ scale, T* __restrict__ out,
                    int M, int N, int K) {
  __shared__ __align__(16) float xs[QM_BK][QM_BM + 4];   // x tile, k-major
  __shared__ __align__(16) float ws[QM_BK][QM_BN];       // widened w8 tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * QM_BM, n0 = blockIdx.x * QM_BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += QM_BK) {
    // 16 neighbouring threads read 16 neighbouring k of one row of x
#pragma unroll
    for (int t = 0; t < QM_BM * QM_BK / QM_THREADS; ++t) {
      const int i = tid + t * QM_THREADS;
      const int r = i / QM_BK, c = i % QM_BK;
      const int m = m0 + r, k = k0 + c;
      xs[c][r] = (m < M && k < K) ? to_f(x[(long long)m * ldx + k]) : 0.f;
    }
    // 64 neighbouring threads read 64 neighbouring bytes of one row of w8
#pragma unroll
    for (int t = 0; t < QM_BK * QM_BN / QM_THREADS; ++t) {
      const int i = tid + t * QM_THREADS;
      const int r = i / QM_BN, c = i % QM_BN;
      const int k = k0 + r, n = n0 + c;
      ws[r][c] = (k < K && n < N) ? static_cast<float>(w[(long long)k * N + n])
                                  : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < QM_BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx * 4 + j;
    if (n >= N) continue;
    const float s = scale[n];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m < M) store(out + (long long)m * N + n, acc[i][j] * s);
    }
  }
}

// ---------------------------------------------------------------------------
// windve_quantize_rows: per-row symmetric int8 activations for W8A8
//   amax = max_k |x[m, k]|      (a subnormal x counts as 0)
//   scale[m] = amax > 0 ? max(amax / 127, FLT_MIN) : 1
//   x8[m, k] = clamp(rint(x[m, k] / scale[m]), -127, 127)
//
// Replaces the jnp prologue quantize_activations
// (src/repro/kernels/quant_matmul/quant_matmul.py:47-63) that the
// reference's quant_matmul_w8a8 puts into one jit with w8a8_matmul_pallas.
//
// What bounds it on this card: memory.  It reads x once per pass and writes
// one byte per value and one scale per row; the arithmetic is one divide
// per value.
//
// Design: one block per row.  Pass 1 reduces amax with a warp-shuffle block
// reduction (max is exact in any order), pass 2 re-reads the row (from L1 /
// L2: a row of bge is 4 or 16 KB) and writes int8.  The divides are true
// IEEE divisions and rintf rounds half to even, so x8 and the scales equal
// the plain version bit for bit: no __fdividef, no reciprocal, no fast math.
// Subnormals are flushed by hand, as XLA does on the CPU and the TPU, so the
// result does not depend on the compiler's -ftz setting.
// ---------------------------------------------------------------------------
constexpr int QR_THREADS = 256;

__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < FLT_MIN ? 0.f : v;
}

template <typename T>
__global__ void __launch_bounds__(QR_THREADS)
quantize_rows_kernel(const T* __restrict__ x, long long ldx,
                     int8_t* __restrict__ x8, float* __restrict__ x_scale,
                     int K) {
  __shared__ float partial[QR_THREADS / 32];
  const int m = blockIdx.x;
  const T* xr = x + (long long)m * ldx;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += QR_THREADS)
    amax = fmaxf(amax, fabsf(flush(to_f(xr[k]))));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    amax = lane < QR_THREADS / 32 ? partial[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) partial[0] = amax;
  }
  __syncthreads();
  amax = partial[0];
  const float s = amax > 0.f ? fmaxf(__fdiv_rn(amax, 127.0f), FLT_MIN) : 1.0f;
  if (threadIdx.x == 0) x_scale[m] = s;
  int8_t* qr = x8 + (long long)m * K;
  for (int k = threadIdx.x; k < K; k += QR_THREADS) {
    const float q = rintf(__fdiv_rn(flush(to_f(xr[k])), s));
    qr[k] = static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
  }
}

// ---------------------------------------------------------------------------
// windve_w8a8_matmul: out[m, n] = (float(sum_k x8[m, k] * w8[k, n])
//                                  * x_scale[m]) * w_scale[n]
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul/quant_matmul.py:182
// (w8a8_matmul_pallas / _w8a8_matmul_kernel).
//
// What bounds it on this card: bytes.  At the int8 tensor cores' 1,979
// TOP/s the 2*M*K*N operations of bge's shapes take less time than writing
// the fp32 output once.  This first kernel runs on the CUDA cores instead,
// where its operations, not its bytes, set its time.
//
// Design: __dp4a, four int8 products summed into an int32 per instruction,
// with exact int32 accumulation.  It is the simplest exact int8 x int8
// product there is: no fragment layouts, and the same 64 x 64 block tile,
// 4 x 4 register tile per thread as the weight-only kernel.  The int8
// tensor cores (mma.sync .s32.s8.s8.s32, or wgmma) are the later, faster
// kernel.  Each K step of 64 stages x8 rows and w8 columns in shared memory
// as packed int8x4 words along K (the w8 tile is transposed on the way in,
// since w8 is K-major); the rows are padded by one word so that the 16
// threads reading 16 columns hit 16 banks.  Bytes past K, M or N are
// zero-filled, so a padded lane adds exactly 0 to the sum.  The epilogue
// converts the int32 sum to fp32 and scales it in the reference's order.
// The wrapper refuses K > 133,000, past which K * 127^2 overflows int32.
// ---------------------------------------------------------------------------
constexpr int W8_BM = 64, W8_BN = 64, W8_BK = 64, W8_THREADS = 256;
constexpr int W8_KW = W8_BK / 4;            // packed words per tile row

__device__ __forceinline__ int pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return (static_cast<int>(static_cast<uint8_t>(a)))
       | (static_cast<int>(static_cast<uint8_t>(b)) << 8)
       | (static_cast<int>(static_cast<uint8_t>(c)) << 16)
       | (static_cast<int>(static_cast<uint8_t>(d)) << 24);
}

template <typename T>
__global__ void __launch_bounds__(W8_THREADS)
w8a8_matmul_kernel(const int8_t* __restrict__ x8, long long ldx,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ x_scale,
                   const float* __restrict__ w_scale, T* __restrict__ out,
                   int M, int N, int K) {
  __shared__ int xs[W8_BM][W8_KW + 1];      // x8 rows, packed along k
  __shared__ int ws[W8_BN][W8_KW + 1];      // w8 columns, packed along k
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * W8_BM, n0 = blockIdx.x * W8_BN;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += W8_BK) {
    // 16 neighbouring threads read 64 neighbouring bytes of one row of x8
#pragma unroll
    for (int t = 0; t < W8_BM * W8_KW / W8_THREADS; ++t) {
      const int i = tid + t * W8_THREADS;
      const int r = i / W8_KW, c = i % W8_KW;
      const int m = m0 + r, k = k0 + 4 * c;
      int8_t b[4] = {0, 0, 0, 0};
      if (m < M) {
        const int8_t* p = x8 + (long long)m * ldx + k;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k + j < K) b[j] = p[j];
      }
      xs[r][c] = pack4(b[0], b[1], b[2], b[3]);
    }
    // 64 neighbouring threads read 64 neighbouring bytes of a row of w8
#pragma unroll
    for (int t = 0; t < W8_BN * W8_KW / W8_THREADS; ++t) {
      const int i = tid + t * W8_THREADS;
      const int c = i % W8_BN, r = i / W8_BN;
      const int n = n0 + c, k = k0 + 4 * r;
      int8_t b[4] = {0, 0, 0, 0};
      if (n < N) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k + j < K) b[j] = w[(long long)(k + j) * N + n];
      }
      ws[c][r] = pack4(b[0], b[1], b[2], b[3]);
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < W8_KW; ++kw) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[tx + 16 * j][kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float xs_m = x_scale[m];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N)
        store(out + (long long)m * N + n,
              __fmul_rn(__fmul_rn(static_cast<float>(acc[i][j]), xs_m),
                        w_scale[n]));
    }
  }
}

constexpr int MAX_GRID_Y = 65535;

}  // namespace

// x (M, K) with row stride ldx elements and unit column stride, dtype 0 =
// float32, 1 = bfloat16; w8 (K, N) int8 contiguous; scale (N,) float32;
// out (M, N) contiguous in x's type.  Launches on `stream` and returns the
// launch's cudaError_t.
extern "C" int windve_quant_matmul(const void* x, long long ldx,
                                   const void* w8, const void* scale,
                                   void* out, int dtype, int M, int N, int K,
                                   void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || ldx < K) return cudaErrorInvalidValue;
  const dim3 grid((N + QM_BN - 1) / QM_BN, (M + QM_BM - 1) / QM_BM);
  if (grid.y > MAX_GRID_Y) return cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(w8);
  const float* s = static_cast<const float*>(scale);
  if (dtype == 0) {
    quant_matmul_kernel<float><<<grid, QM_THREADS, 0, st>>>(
        static_cast<const float*>(x), ldx, w, s, static_cast<float*>(out),
        M, N, K);
  } else if (dtype == 1) {
    quant_matmul_kernel<__nv_bfloat16><<<grid, QM_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), ldx, w, s,
        static_cast<__nv_bfloat16*>(out), M, N, K);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// x (M, K) with row stride ldx elements, dtype 0 = float32, 1 = bfloat16;
// x8 (M, K) int8 contiguous and x_scale (M,) float32 are written.
extern "C" int windve_quantize_rows(const void* x, long long ldx, void* x8,
                                    void* x_scale, int dtype, int M, int K,
                                    void* stream) {
  if (M <= 0) return cudaSuccess;
  if (K <= 0 || ldx < K) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(x8);
  float* s = static_cast<float*>(x_scale);
  if (dtype == 0) {
    quantize_rows_kernel<float><<<M, QR_THREADS, 0, st>>>(
        static_cast<const float*>(x), ldx, q, s, K);
  } else if (dtype == 1) {
    quantize_rows_kernel<__nv_bfloat16><<<M, QR_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), ldx, q, s, K);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// x8 (M, K) int8 with row stride ldx; w8 (K, N) int8 contiguous; x_scale
// (M,) and w_scale (N,) float32; out (M, N) contiguous, out_dtype 0 =
// float32, 1 = bfloat16.
extern "C" int windve_w8a8_matmul(const void* x8, long long ldx,
                                  const void* w8, const void* x_scale,
                                  const void* w_scale, void* out,
                                  int out_dtype, int M, int N, int K,
                                  void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || ldx < K) return cudaErrorInvalidValue;
  const dim3 grid((N + W8_BN - 1) / W8_BN, (M + W8_BM - 1) / W8_BM);
  if (grid.y > MAX_GRID_Y) return cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xq = static_cast<const int8_t*>(x8);
  const int8_t* w = static_cast<const int8_t*>(w8);
  const float* xs = static_cast<const float*>(x_scale);
  const float* ws = static_cast<const float*>(w_scale);
  if (out_dtype == 0) {
    w8a8_matmul_kernel<float><<<grid, W8_THREADS, 0, st>>>(
        xq, ldx, w, xs, ws, static_cast<float*>(out), M, N, K);
  } else if (out_dtype == 1) {
    w8a8_matmul_kernel<__nv_bfloat16><<<grid, W8_THREADS, 0, st>>>(
        xq, ldx, w, xs, ws, static_cast<__nv_bfloat16*>(out), M, N, K);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
