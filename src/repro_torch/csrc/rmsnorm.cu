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
// Design: one pass, the row held in registers.  A group of TPR threads (a
// warp, or up to 256) takes a row; each thread loads up to CH 16-byte
// chunks of it (4 fp32 or 8 bf16 values) at once, with the scale of those
// chunks beside them (16-byte loads that hit L1 or L2, so their latency
// hides behind the row's), sums their squares, and the group sums by warp
// shuffles (and, when it is more than a warp, through shared memory behind
// one barrier).  Then each thread scales the chunks it holds by
// rsqrt(ms + eps) and the scale and stores them with 16-byte stores.
// The host picks TPR: a warp a row while there are rows enough to give
// every SM four warps (hymba's 1,024 prefill rows: 256 blocks of 4 rows,
// one wave), else up to a block of 128 threads a row (its 16 decode rows),
// and up to 256 as a row needs to fit CH chunks a thread.  Rows whose
// stride, D or base is not a multiple of 16 bytes take the same code with
// one element a chunk.  A row wider than 256 * CH chunks (bf16 D > 16384,
// fp32 D > 8192 on the vector path) is not held: the group reads it twice,
// once to sum, once to scale.  The sum of squares runs in another order than
// the plain version's, so the two differ by fp32 rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BLOCK = 128;      // threads a block, unless a row takes more
constexpr int MAX_TPR = 256;    // threads a row
constexpr int CH = 8;           // chunks a thread holds

// V values of T as one load: a 16-byte chunk (VEC), or one element.
template <typename T, bool VEC>
struct Chunk;

template <>
struct Chunk<float, true> {
  static constexpr int V = 4;
  uint4 raw;
  __device__ __forceinline__ void load(const float* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void get(float (&f)[V]) const {
    f[0] = __uint_as_float(raw.x);
    f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z);
    f[3] = __uint_as_float(raw.w);
  }
  __device__ __forceinline__ static void put(float* p, const float (&f)[V]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <>
struct Chunk<__nv_bfloat16, true> {
  static constexpr int V = 8;
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void get(float (&f)[V]) const {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {       // a bf16 is the top half of an fp32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static void put(__nv_bfloat16* p,
                                             const float (&f)[V]) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                   pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
  }
};

template <>
struct Chunk<float, false> {
  static constexpr int V = 1;
  float raw;
  __device__ __forceinline__ void load(const float* p) { raw = *p; }
  __device__ __forceinline__ void get(float (&f)[V]) const { f[0] = raw; }
  __device__ __forceinline__ static void put(float* p, const float (&f)[V]) {
    *p = f[0];
  }
};

template <>
struct Chunk<__nv_bfloat16, false> {
  static constexpr int V = 1;
  unsigned short raw;                       // the bf16's bits
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const unsigned short*>(p);
  }
  __device__ __forceinline__ void get(float (&f)[V]) const {
    f[0] = __uint_as_float(static_cast<unsigned>(raw) << 16);
  }
  __device__ __forceinline__ static void put(__nv_bfloat16* p,
                                             const float (&f)[V]) {
    *p = __float2bfloat16(f[0]);
  }
};

// V scale values at s: 16-byte loads on the vector path.
template <int V>
__device__ __forceinline__ void load_scale(const float* s, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = *s;
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 u = *reinterpret_cast<const float4*>(s + i);
      f[i] = u.x;
      f[i + 1] = u.y;
      f[i + 2] = u.z;
      f[i + 3] = u.w;
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// out[c] = x[c] * inv * scale[c] for the V values of chunk c.
template <typename T, bool VEC>
__device__ __forceinline__ void scale_out(const Chunk<T, VEC>& ch,
                                          const float (&s)[Chunk<T, VEC>::V],
                                          T* orow, int c, float inv) {
  constexpr int V = Chunk<T, VEC>::V;
  float f[V];
  ch.get(f);
#pragma unroll
  for (int e = 0; e < V; ++e) f[e] = f[e] * inv * s[e];
  Chunk<T, VEC>::put(orow + c * V, f);
}

// Groups of tpr threads (a multiple of 32 that divides the block), a row
// each.  FITS: the row's chunks fit CH a thread and are held.
template <typename T, bool VEC, bool FITS>
__global__ void __launch_bounds__(MAX_TPR)
rmsnorm_kernel(const T* __restrict__ x, long long ldx,
               const float* __restrict__ scale, T* __restrict__ out, int R,
               int D, int tpr, float eps) {
  using C = Chunk<T, VEC>;
  __shared__ float partial[MAX_TPR / 32];
  const int lt = threadIdx.x % tpr;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / tpr)
                        + threadIdx.x / tpr;
  const bool live = row < R;
  const int nc = D / C::V;                  // chunks a row
  const T* xr = x + (live ? row : 0) * ldx;
  T* orow = out + row * D;

  C held[FITS ? CH : 1];
  float sc[FITS ? CH : 1][C::V];            // the scale of the held chunks
  float ss = 0.f;
  if (FITS) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {          // every load in flight at once
      const int c = lt + j * tpr;
      if (live && c < nc) {
        held[j].load(xr + c * C::V);
        load_scale<C::V>(scale + c * C::V, sc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = lt + j * tpr;
      if (live && c < nc) {
        float f[C::V];
        held[j].get(f);
#pragma unroll
        for (int e = 0; e < C::V; ++e) ss += f[e] * f[e];
      }
    }
  } else {
    for (int c = lt; live && c < nc; c += tpr) {
      C ch;
      ch.load(xr + c * C::V);
      float f[C::V];
      ch.get(f);
#pragma unroll
      for (int e = 0; e < C::V; ++e) ss += f[e] * f[e];
    }
  }
  ss = warp_sum(ss);
  if (tpr > 32) {                           // the same for the whole block
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) partial[warp] = ss;
    __syncthreads();
    const int w0 = (threadIdx.x / tpr) * (tpr / 32);
    ss = 0.f;
    for (int w = 0; w < tpr / 32; ++w) ss += partial[w0 + w];
  }
  if (!live) return;
  const float inv = rsqrtf(ss / static_cast<float>(D) + eps);
  if (FITS) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = lt + j * tpr;
      if (c < nc) scale_out<T, VEC>(held[j], sc[j], orow, c, inv);
    }
  } else {
    for (int c = lt; c < nc; c += tpr) {
      C ch;
      ch.load(xr + c * C::V);
      float s[C::V];
      load_scale<C::V>(scale + c * C::V, s);
      scale_out<T, VEC>(ch, s, orow, c, inv);
    }
  }
}

template <typename T, bool VEC>
cudaError_t launch(const T* x, long long ldx, const float* scale, T* out,
                   int R, int D, float eps, cudaStream_t st) {
  const int nc = D / Chunk<T, VEC>::V;
  int tpr = 32;
  while (tpr < MAX_TPR && tpr * CH < nc) tpr *= 2;
  const bool fits = tpr * CH >= nc;
  int sms = 0;
  const cudaError_t err = windve_sm_count(&sms);
  if (err != cudaSuccess) return err;
  // few rows: spread each over up to a block, until every SM has four warps
  while (tpr < BLOCK && tpr < nc
         && static_cast<long long>(R) * tpr < 128LL * sms)
    tpr *= 2;
  const int threads = tpr > BLOCK ? tpr : BLOCK;
  const int rows = threads / tpr;            // a block
  const long long blocks = (static_cast<long long>(R) + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  auto kernel = fits ? rmsnorm_kernel<T, VEC, true>
                     : rmsnorm_kernel<T, VEC, false>;
  kernel<<<static_cast<unsigned>(blocks), threads, 0, st>>>(
      x, ldx, scale, out, R, D, tpr, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, long long ldx, const void* scale,
                     void* out, int R, int D, float eps, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = D % V == 0 && ldx % V == 0
                   && reinterpret_cast<uintptr_t>(x) % 16 == 0
                   && reinterpret_cast<uintptr_t>(scale) % 16 == 0
                   && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  const float* s = static_cast<const float*>(scale);
  T* o = static_cast<T*>(out);
  if (vec) return launch<T, true>(xt, ldx, s, o, R, D, eps, st);
  return launch<T, false>(xt, ldx, s, o, R, D, eps, st);
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
  if (dtype == 0) return dispatch<float>(x, ldx, scale, out, R, D, eps, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, ldx, scale, out, R, D, eps, st);
  return cudaErrorInvalidValue;
}
