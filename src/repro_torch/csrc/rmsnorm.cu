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
//
// Backward (windve_rmsnorm_bwd): given dy, the gradient of the output,
//   dx     = r * (g - x * r^2 * mean(g * x)),  g = dy * scale,
//   dscale = sum over rows of dy * x * r,
// with r = rsqrt(mean(x^2) + eps) recomputed from x, all in fp32.  What
// bounds it: memory (it reads x and dy once and writes dx once; eight flops
// an element).  One pass a row, as the forward: a group of TPR threads (a
// warp, or up to 256, picked by the host as the forward picks it) takes a
// row and holds its x and dy in registers as 16-byte chunks, up to CHB a
// thread; it sums x^2 and g * x by warp shuffles (and, when the group is
// more than a warp, through shared memory behind the group's own named
// barrier: no block barrier a row), then writes dx with 16-byte stores.
// Each thread holds the scale of its columns, loaded once, and its columns'
// dscale partial in registers across the rows its group takes.  At the end
// the block's groups add their partials in a fixed order in shared memory,
// and the block writes its row of the fp32 workspace; a second kernel sums
// the blocks' rows column by column in a fixed order, 8 warps to 32
// columns.  No atomics: the result does not depend on the schedule.  Rows
// whose stride, D or base is not a multiple of 16 bytes take the same code
// with one element a chunk.  Rows too wide to hold (bf16 D > 16384, fp32 D >
// 8192 on the vector path) take rmsnorm_bwd_wide: a block of 256 threads a
// run of rows, the row read twice, the partials in shared memory while D
// floats fit, else in the workspace.
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

constexpr int BWD_THREADS = 256;
constexpr int BWD_SMEM_FLOATS = 8 * 1024;    // 32 KB of dscale partials

// a barrier of the n threads (a multiple of 32) that use named barrier id
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// Groups of tpr threads (a multiple of 32 that divides the block) take the
// rows r0 + group, r0 + group + groups, ... of the block's run; a thread
// holds chunks lt + j * tpr, j < CHB, of each.
template <typename T, bool VEC, int CHB>
__global__ void __launch_bounds__(BWD_THREADS, CHB <= 4 ? 2 : 1)
rmsnorm_bwd_rows(const T* __restrict__ x, long long ldx,
                 const float* __restrict__ scale, const T* __restrict__ dy,
                 long long ldy, T* __restrict__ dx, float* __restrict__ part,
                 int R, int D, int tpr, int rows_per_block, float eps) {
  using C = Chunk<T, VEC>;
  constexpr int V = C::V;
  extern __shared__ float acc_s[];            // D floats when groups > 1
  __shared__ float red[2][BWD_THREADS / 32][2];
  const int groups = BWD_THREADS / tpr, group = threadIdx.x / tpr;
  const int lt = threadIdx.x % tpr, lane = threadIdx.x % 32;
  const int nc = D / V;                       // chunks a row
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min((long long)R, r0 + rows_per_block);

  float sc[CHB][V], acc[CHB][V];
#pragma unroll
  for (int j = 0; j < CHB; ++j) {
    const int c = lt + j * tpr;
    if (c < nc) load_scale<V>(scale + c * V, sc[j]);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[j][e] = 0.f;
  }
  int parity = 0;                             // red's slot for this row
  for (long long row = r0 + group; row < r1; row += groups, parity ^= 1) {
    const T* xr = x + row * ldx;
    const T* dyr = dy + row * ldy;
    C xc[CHB], gc[CHB];
#pragma unroll
    for (int j = 0; j < CHB; ++j) {           // every load in flight at once
      const int c = lt + j * tpr;
      if (c < nc) {
        xc[j].load(xr + c * V);
        gc[j].load(dyr + c * V);
      }
    }
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int j = 0; j < CHB; ++j) {
      const int c = lt + j * tpr;
      if (c < nc) {
        float xf[V], gf[V];
        xc[j].get(xf);
        gc[j].get(gf);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          ss = fmaf(xf[e], xf[e], ss);
          gx = fmaf(gf[e] * sc[j][e], xf[e], gx);
        }
      }
    }
    ss = warp_sum(ss);
    gx = warp_sum(gx);
    if (tpr > 32) {                           // the group's warps, in order
      const int warp = threadIdx.x / 32, w0 = group * (tpr / 32);
      if (lane == 0) {
        red[parity][warp][0] = ss;
        red[parity][warp][1] = gx;
      }
      group_sync(1 + group, tpr);
      ss = gx = 0.f;
      for (int w = 0; w < tpr / 32; ++w) {
        ss += red[parity][w0 + w][0];
        gx += red[parity][w0 + w][1];
      }
    }
    const float r = rsqrtf(ss / static_cast<float>(D) + eps);
    const float kx = r * r * r * gx / static_cast<float>(D);
    T* dxr = dx + row * D;
#pragma unroll
    for (int j = 0; j < CHB; ++j) {
      const int c = lt + j * tpr;
      if (c < nc) {
        float xf[V], gf[V], out[V];
        xc[j].get(xf);
        gc[j].get(gf);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          out[e] = r * gf[e] * sc[j][e] - xf[e] * kx;
          acc[j][e] = fmaf(gf[e] * xf[e], r, acc[j][e]);
        }
        C::put(dxr + c * V, out);
      }
    }
  }
  // the block's row of the workspace: one group writes it from registers;
  // several add theirs in shared memory, group by group
  float* pb = part + (long long)blockIdx.x * D;
  if (groups == 1) {
#pragma unroll
    for (int j = 0; j < CHB; ++j) {
      const int c = lt + j * tpr;
      if (c < nc) {
#pragma unroll
        for (int e = 0; e < V; ++e) pb[c * V + e] = acc[j][e];
      }
    }
    return;
  }
  for (int gi = 0; gi < groups; ++gi) {
    if (group == gi) {
#pragma unroll
      for (int j = 0; j < CHB; ++j) {
        const int c = lt + j * tpr;
        if (c < nc) {
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc_s[c * V + e] = gi ? acc_s[c * V + e] + acc[j][e] : acc[j][e];
        }
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < D; c += BWD_THREADS) pb[c] = acc_s[c];
}

template <typename T>
__device__ __forceinline__ float to_f32(const T* p) {
  if constexpr (sizeof(T) == 2) {
    return __uint_as_float(
        static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(p))
        << 16);
  } else {
    return *p;
  }
}

// Rows too wide to hold: a block of 256 threads takes a run of rows, each
// summed block-wide, then scaled with the row read again (from L1/L2); the
// block's dscale partial in shared memory while D floats fit, else in its
// row of the workspace.
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
rmsnorm_bwd_wide(const T* __restrict__ x, long long ldx,
                 const float* __restrict__ scale, const T* __restrict__ dy,
                 long long ldy, T* __restrict__ dx, float* __restrict__ part,
                 int R, int D, int rows_per_block, float eps) {
  extern __shared__ float acc_s[];
  __shared__ float red[2][BWD_THREADS / 32];
  const bool in_smem = D <= BWD_SMEM_FLOATS;
  float* acc = in_smem ? acc_s : part + (long long)blockIdx.x * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = threadIdx.x; c < D; c += BWD_THREADS) acc[c] = 0.f;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min((long long)R, r0 + rows_per_block);
  for (long long row = r0; row < r1; ++row) {
    const T* xr = x + row * ldx;
    const T* dyr = dy + row * ldy;
    float ss = 0.f, gx = 0.f;
    for (int c = threadIdx.x; c < D; c += BWD_THREADS) {
      const float xv = to_f32(xr + c);
      ss = fmaf(xv, xv, ss);
      gx = fmaf(to_f32(dyr + c) * scale[c], xv, gx);
    }
    ss = warp_sum(ss);
    gx = warp_sum(gx);
    if (lane == 0) {
      red[0][warp] = ss;
      red[1][warp] = gx;
    }
    __syncthreads();
    ss = gx = 0.f;
#pragma unroll
    for (int w = 0; w < BWD_THREADS / 32; ++w) {
      ss += red[0][w];
      gx += red[1][w];
    }
    __syncthreads();                          // red is free for the next row
    const float r = rsqrtf(ss / static_cast<float>(D) + eps);
    const float kx = r * r * r * gx / static_cast<float>(D);
    T* dxr = dx + row * D;
    for (int c = threadIdx.x; c < D; c += BWD_THREADS) {
      const float xv = to_f32(xr + c), dyv = to_f32(dyr + c);
      const float val = r * dyv * scale[c] - xv * kx;
      if constexpr (sizeof(T) == 2) {
        dxr[c] = __float2bfloat16(val);
      } else {
        dxr[c] = val;
      }
      acc[c] = fmaf(dyv * xv, r, acc[c]);     // each thread its own columns
    }
  }
  if (in_smem) {
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += BWD_THREADS)
      part[(long long)blockIdx.x * D + c] = acc[c];
  }
}

// dscale[c] = the blocks' partials of column c, summed in a fixed order: a
// block takes 32 columns, warp w sums partials w, w + 8, w + 16, ... (its
// loads independent of each other), and the first warp adds the 8 sums in
// warp order
__global__ void __launch_bounds__(256)
rmsnorm_bwd_dscale(const float* __restrict__ part, float* __restrict__ dscale,
                   int P, int D) {
  __shared__ float sums[8][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < D)
    for (int p = warp; p < P; p += 8) s += part[(long long)p * D + c];
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < D) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) t += sums[w][lane];
    dscale[c] = t;
  }
}

// The one-pass kernel when a row fits CHB chunks a thread (chunks of one
// element unless VEC); *held = false, and nothing launched, when it does
// not.
template <typename T, bool VEC>
cudaError_t launch_bwd_rows(const T* x, long long ldx, const float* scale,
                            const T* dy, long long ldy, T* dx, float* part,
                            int blocks, int R, int D, float eps,
                            cudaStream_t st, bool* held) {
  const int nc = D / Chunk<T, VEC>::V;
  // the fewest threads a row that hold it in 4 chunks each, then (few rows)
  // more threads a row until every SM has four warps
  int tpr = 32;                                // a warp
  while (tpr < BWD_THREADS && tpr * 4 < nc) tpr *= 2;
  int sms = 0;
  const cudaError_t err = windve_sm_count(&sms);
  if (err != cudaSuccess) return err;
  while (tpr < BWD_THREADS && tpr < nc
         && static_cast<long long>(R) * tpr < 128LL * sms)
    tpr *= 2;
  *held = tpr * 8 >= nc;
  if (!*held) return cudaSuccess;
  const int rows = (R + blocks - 1) / blocks;
  const size_t smem = tpr < BWD_THREADS ? D * sizeof(float) : 0;
  if (tpr * 4 >= nc)
    rmsnorm_bwd_rows<T, VEC, 4><<<blocks, BWD_THREADS, smem, st>>>(
        x, ldx, scale, dy, ldy, dx, part, R, D, tpr, rows, eps);
  else
    rmsnorm_bwd_rows<T, VEC, 8><<<blocks, BWD_THREADS, smem, st>>>(
        x, ldx, scale, dy, ldy, dx, part, R, D, tpr, rows, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, long long ldx, const void* scale,
                       const void* dy, long long ldy, void* dx, void* dscale,
                       void* part, int blocks, int R, int D, float eps,
                       cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = D % V == 0 && ldx % V == 0 && ldy % V == 0
                   && reinterpret_cast<uintptr_t>(x) % 16 == 0
                   && reinterpret_cast<uintptr_t>(dy) % 16 == 0
                   && reinterpret_cast<uintptr_t>(scale) % 16 == 0
                   && reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const float* s = static_cast<const float*>(scale);
  T* dxt = static_cast<T*>(dx);
  float* pt = static_cast<float*>(part);
  bool held = false;
  cudaError_t err =
      vec ? launch_bwd_rows<T, true>(xt, ldx, s, dyt, ldy, dxt, pt, blocks,
                                     R, D, eps, st, &held)
          : launch_bwd_rows<T, false>(xt, ldx, s, dyt, ldy, dxt, pt, blocks,
                                      R, D, eps, st, &held);
  if (err != cudaSuccess) return err;
  if (!held) {
    const int rows = (R + blocks - 1) / blocks;
    const size_t smem = D <= BWD_SMEM_FLOATS ? D * sizeof(float) : 0;
    rmsnorm_bwd_wide<T><<<blocks, BWD_THREADS, smem, st>>>(
        xt, ldx, s, dyt, ldy, dxt, pt, R, D, rows, eps);
  }
  rmsnorm_bwd_dscale<<<(D + 31) / 32, 256, 0, st>>>(
      pt, static_cast<float*>(dscale), blocks, D);
  return cudaGetLastError();
}

}  // namespace

// The number of row blocks windve_rmsnorm_bwd uses for R rows: the size of
// its dscale workspace is that many rows of D floats.
extern "C" int windve_rmsnorm_bwd_blocks(int R) {
  int sms = 0;
  if (windve_sm_count(&sms) != cudaSuccess || sms <= 0) sms = 132;
  const int blocks = 2 * sms;
  return R < blocks ? (R > 0 ? R : 1) : blocks;
}

// x and dy (R, D) with row strides ldx, ldy and unit column stride, dtype
// 0 = float32, 1 = bfloat16; scale (D,) float32 contiguous; dx (R, D)
// contiguous, x's type; dscale (D,) float32; part a float32 workspace of
// windve_rmsnorm_bwd_blocks(R) x D.  Launches on `stream` and returns the
// launches' cudaError_t.
extern "C" int windve_rmsnorm_bwd(const void* x, long long ldx,
                                  const void* scale, const void* dy,
                                  long long ldy, void* dx, void* dscale,
                                  void* part, int dtype, int R, int D,
                                  float eps, void* stream) {
  if (R <= 0 || D <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = windve_rmsnorm_bwd_blocks(R);
  if (dtype == 0)
    return launch_bwd<float>(x, ldx, scale, dy, ldy, dx, dscale, part, blocks,
                             R, D, eps, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, ldx, scale, dy, ldy, dx, dscale, part,
                                     blocks, R, D, eps, st);
  return cudaErrorInvalidValue;
}

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
