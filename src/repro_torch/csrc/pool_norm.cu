// Fused masked pooling + L2 normalisation for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/pool_norm/pool_norm.py
// (pool_norm_pallas / _pool_norm_kernel), the embedder's serving epilogue:
//   mean: pooled = sum_s h[b,s] * mask[b,s] / max(sum_s mask[b,s], 1)
//   cls:  pooled = h[b,0] * min(mask[b,0], 1)
//   out[b] = pooled / max(||pooled||, 1e-9), fp32 for fp32 or bf16 input.
// A fully masked row pools to the zero vector.
//
// What bounds it on this card: memory.  Mean pooling reads the hidden rows
// of the (B, S, D) states once and writes (B, D) fp32; at bge's epilogue
// (16, 96, 1024) that is 3.6 MB of unmasked fp32 rows, 1.1 us at 3.35
// TB/s, so what decides the time is how many SMs read at once and how many
// loads each keeps in flight: one block a batch row would read from 16 of
// 132 SMs.  CLS reads only token 0 of each row: its time is the launch's.
//
// Mean mode: a thread-block cluster of up to 8 blocks a batch row (16 rows
// give 128 blocks).  Each block owns a slice of the row's columns and reads
// them with 16-byte loads (4 fp32 or 8 bf16), its threads split over the
// slice's vectors and, where the slice has fewer vectors than threads, over
// positions too.  Every position is read, masked or not, so no load waits
// on the mask and a non-finite masked value spreads as in the reference.
// The block sums the mask once, after its loads are in flight, and the
// position groups' partial sums meet in shared memory.  ||pooled||^2 is
// formed across the cluster with distributed shared memory: each block
// publishes its slice's sum of squares, the cluster barrier makes it
// visible, and every block reads all of them from its peers in the same
// order, so all scale by the same norm.  One launch, no second pass.  Rows
// whose D is not a multiple of the vector or whose base is not 16-byte
// aligned are read element by element.
//
// CLS mode keeps one block a row, threads across D, the pooled row in
// shared memory while a block reduction forms ||pooled||^2.  Accumulation
// is fp32 for any input type in both modes.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CLUSTER = 8;       // the portable cluster size
constexpr int SLICE_COLS = 128;      // columns a block aims at in mean mode
constexpr int PART = 2048;           // floats of partial sums a block holds

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

// The block's sum of x, in every thread; `red` holds THREADS / 32 floats.
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) total += red[w];
  __syncthreads();                     // red may be written again
  return total;
}

// VEC values of a row from p as fp32: one 16-byte load when `vec`, else
// element loads of the `left` values that exist.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&x)[VEC],
                                         bool vec, int left) {
  if (vec) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    if constexpr (VEC == 4) {
      x[0] = __uint_as_float(u.x);
      x[1] = __uint_as_float(u.y);
      x[2] = __uint_as_float(u.z);
      x[3] = __uint_as_float(u.w);
    } else {
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(b2[i]);
        x[2 * i] = f.x;
        x[2 * i + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) x[e] = e < left ? to_f(p[e]) : 0.f;
  }
}

// Mean mode: cluster rank r of batch row b pools columns [r * W, r * W + W).
template <typename T>
__global__ void __launch_bounds__(THREADS)
pool_mean_kernel(const T* __restrict__ h, const float* __restrict__ mask,
                 float* __restrict__ out, int S, int D, int W, int vec) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ __align__(16) float part[PART];
  __shared__ float red[THREADS / 32];
  __shared__ float slice_ss;
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / CL;
  const int c0 = rank * W, cols = max(0, min(W, D - c0));
  const T* hb = h + (long long)b * S * D + c0;
  const float* mb = mask + (long long)b * S;

  // work item (p, v): vector v of the slice summed over positions
  // p, p + PG, ...; the PG position groups meet in `part`
  const int NV = (cols + VEC - 1) / VEC;
  const int PG = max(1, THREADS / max(NV, 1));
  const int stride = NV * VEC;                    // floats a position group
  for (int i = threadIdx.x; i < PG * NV; i += THREADS) {
    const int p = i / NV, c = (i % NV) * VEC;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll 4
    for (int s = p; s < S; s += PG) {     // loads that wait on nothing
      const float w = mb[s];
      float x[VEC];
      load_vec<T, VEC>(hb + (long long)s * D + c, x, vec, cols - c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += x[e] * w;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) part[p * stride + c + e] = acc[e];
  }
  float msum = 0.f;                    // the mask, summed once a block
  for (int s = threadIdx.x; s < S; s += THREADS) msum += mb[s];
  const float denom = fmaxf(block_sum(msum, red), 1.f);  // and `part` is whole

  float ss = 0.f;
  for (int c = threadIdx.x; c < cols; c += THREADS) {
    float a = 0.f;
    for (int p = 0; p < PG; ++p) a += part[p * stride + c];
    const float pooled = a / denom;
    part[c] = pooled;                  // group 0's slot of column c: ours
    ss += pooled * pooled;
  }
  ss = block_sum(ss, red);
  if (threadIdx.x == 0) slice_ss = ss;
  cluster.sync();                      // every slice's sum is published
  // lane r reads rank r; lane 0's sum, in rank order, is every block's norm
  const int lane = threadIdx.x % 32;
  float x = lane < CL ? *cluster.map_shared_rank(&slice_ss, lane) : 0.f;
  float total = x;
  for (int r = 1; r < CL; ++r)
    total += __shfl_sync(0xffffffffu, x, r);
  total = __shfl_sync(0xffffffffu, total, 0);
  cluster.sync();                      // no block leaves while read
  const float nrm = fmaxf(sqrtf(total), 1e-9f);
  float* ob = out + (long long)b * D + c0;
  for (int c = threadIdx.x; c < cols; c += THREADS) ob[c] = part[c] / nrm;
}

// CLS mode: one block a batch row, threads across D.
template <typename T>
__global__ void __launch_bounds__(THREADS)
pool_cls_kernel(const T* __restrict__ h, const float* __restrict__ mask,
                float* __restrict__ out, int S, int D) {
  extern __shared__ float pooled[];     // D floats
  __shared__ float red[THREADS / 32];
  const int b = blockIdx.x;
  const T* hb = h + (long long)b * S * D;
  const float w = fminf(mask[(long long)b * S], 1.f);

  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    const float p = to_f(hb[d]) * w;
    pooled[d] = p;
    ss += p * p;
  }
  const float nrm = fmaxf(sqrtf(block_sum(ss, red)), 1e-9f);
  float* ob = out + (long long)b * D;
  for (int d = threadIdx.x; d < D; d += THREADS) ob[d] = pooled[d] / nrm;
}

template <typename T>
cudaError_t launch(const void* h, const void* mask, void* out, int B, int S,
                   int D, int mean, cudaStream_t stream) {
  const T* hp = static_cast<const T*>(h);
  const float* mp = static_cast<const float*>(mask);
  float* op = static_cast<float*>(out);
  if (!mean) {
    pool_cls_kernel<T><<<B, THREADS, static_cast<size_t>(D) * sizeof(float),
                         stream>>>(hp, mp, op, S, D);
    return cudaGetLastError();
  }
  constexpr int VEC = 16 / sizeof(T);
  const int CL = min(MAX_CLUSTER, (D + SLICE_COLS - 1) / SLICE_COLS);
  const int W = ((D + CL - 1) / CL + VEC - 1) / VEC * VEC;
  if (W > PART) return cudaErrorInvalidValue;
  const int vec = D % VEC == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * CL);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, pool_mean_kernel<T>, hp, mp, op, S, D, W,
                            vec);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(h, mask, out, B, S, D, mean, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(h, mask, out, B, S, D, mean, st);
  return cudaErrorInvalidValue;
}
