// Flash-decode attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode/flash_decode.py
// (flash_decode_pallas / _fd_kernel): one query token per (batch row, KV
// head), its G = H / KV query heads against a (B, Sc, KV, hd) cache whose
// slots carry absolute positions kpos (a ring buffer under a sliding
// window).  A slot is valid when 0 <= kpos <= pos and, with a window,
// kpos > pos - window.  Scores are q . k / sqrt(hd) in fp32, the softmax
// runs online over tiles of slots (running max, denominator, accumulator),
// and the output is acc / den in q's type.
//
// Numerics follow the LM's decode read (models/layers.py attn_decode): k is
// rounded to q's type before the dot (a no-op for fp32 q), the softmax
// weights are rounded to the cache's type before the weighted sum (a no-op
// for an fp32 cache), and sums are fp32.  A masked slot contributes exactly
// 0, so a row with no valid slot comes out as zeros.
//
// What bounds it on this card: memory.  Each valid slot's k and v rows are
// read once for the G query heads that share them; the arithmetic is
// 4 * G * hd flops a slot.  At hymba-1.5b's decode (B 16, KV 5, G 5,
// hd 64, 80 fp32 slots) that is 3.3 MB against 6.6 MFLOP.
//
// Design: one thread block per (KV head, batch row); the TPU grid's
// sequential k-block axis becomes a loop inside the block over tiles of 64
// slots.  Each tile's valid k and v rows are staged in shared memory as
// fp32 (k rows padded by one word, so threads walking slots do not hit one
// bank); the block forms the G x 64 scores, one warp per query head takes
// the tile's max and exp-sum with shuffles, and the G x hd accumulator in
// shared memory takes the weighted values.  Empty or masked slots are not
// read.  Any G and Sc, as far as G x hd fits in shared memory (the launch
// reports it when not).  Simple and right first: one block a
// (row, head) leaves most SMs idle at batch 16, and a split over the slots
// (flash-decoding's second pass) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int BK = 64;             // cache slots per shared-memory tile
constexpr float NEG = -1e30f;      // masked score and initial running max

struct Strides {
  long long b, s, h;
};

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

// x as a value of type T sees it: rounded to T, widened back to fp32.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// q strides: (b, g, h) = batch row, query head in the group, KV head.
// k and v strides: (b, s, h) = batch row, slot, KV head.
template <typename TQ, typename TC>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const TQ* __restrict__ q, const TC* __restrict__ k,
                    const TC* __restrict__ v, const int* __restrict__ kpos,
                    TQ* __restrict__ o, int KV, int G, int Sc, int hd,
                    Strides qs, Strides ks, Strides vs, float scale, int pos,
                    int window) {
  extern __shared__ float smem[];
  const int ldk = hd + 1;
  float* sq = smem;                   // G x hd
  float* acc = sq + G * hd;           // G x hd
  float* sk = acc + G * hd;           // BK x ldk
  float* sv = sk + BK * ldk;          // BK x ldk
  float* sp = sv + BK * ldk;          // G x BK scores, then weights
  float* run_max = sp + G * BK;       // G
  float* den = run_max + G;           // G
  float* corr = den + G;              // G
  __shared__ int valid[BK];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const TQ* qb = q + b * qs.b + h * qs.h;
  const TC* kb = k + b * ks.b + h * ks.h;
  const TC* vb = v + b * vs.b + h * vs.h;

  for (int i = tid; i < G * hd; i += THREADS) {
    const int g = i / hd, e = i % hd;
    sq[i] = to_f(qb[g * qs.s + e]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    run_max[g] = NEG;
    den[g] = 0.f;
  }

  for (int t0 = 0; t0 < Sc; t0 += BK) {
    const int len = min(BK, Sc - t0);
    __syncthreads();                 // the previous tile is consumed
    for (int s = tid; s < BK; s += THREADS) {
      const int kp = s < len ? kpos[t0 + s] : -1;
      valid[s] = kp >= 0 && kp <= pos && (window == 0 || kp > pos - window);
    }
    __syncthreads();
    for (int i = tid; i < len * hd; i += THREADS) {
      const int s = i / hd, e = i % hd;
      if (!valid[s]) continue;
      const long long slot = t0 + s;
      sk[s * ldk + e] = round_to<TQ>(to_f(kb[slot * ks.s + e]));
      sv[s * ldk + e] = to_f(vb[slot * vs.s + e]);
    }
    __syncthreads();
    for (int i = tid; i < G * BK; i += THREADS) {
      const int g = i / BK, s = i % BK;
      float sc = NEG;
      if (valid[s]) {
        const float* qr = sq + g * hd;
        const float* kr = sk + s * ldk;
        float dot = 0.f;
        for (int e = 0; e < hd; ++e) dot += qr[e] * kr[e];
        sc = dot * scale;
      }
      sp[i] = sc;
    }
    __syncthreads();
    for (int g = warp; g < G; g += THREADS / 32) {
      float* row = sp + g * BK;
      float mx = NEG;
      for (int s = lane; s < BK; s += 32) mx = fmaxf(mx, row[s]);
      mx = warp_max(mx);
      const float m_old = run_max[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int s = lane; s < BK; s += 32) {
        const float p = valid[s] ? expf(row[s] - m_new) : 0.f;
        row[s] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        corr[g] = c;
        den[g] = den[g] * c + sum;
        run_max[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * hd; i += THREADS) {
      const int g = i / hd, e = i % hd;
      const float* row = sp + g * BK;
      float a = acc[i] * corr[g];
      for (int s = 0; s < len; ++s)
        if (valid[s]) a += round_to<TC>(row[s]) * sv[s * ldk + e];
      acc[i] = a;
    }
  }
  __syncthreads();
  TQ* ob = o + ((static_cast<long long>(b) * KV + h) * G) * hd;
  for (int i = tid; i < G * hd; i += THREADS) {
    const float d = den[i / hd];
    ob[i] = from_f<TQ>(d > 0.f ? acc[i] / d : 0.f);
  }
}

template <typename TQ, typename TC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kpos, void* o, int B, int KV, int G, int Sc,
                   int hd, Strides qs, Strides ks, Strides vs, int pos,
                   int window, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (2 * G * hd + 2 * BK * (hd + 1) + G * BK + 3 * G);
  auto kernel = flash_decode_kernel<TQ, TC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(KV, B);
  kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k),
      static_cast<const TC*>(v), kpos, static_cast<TQ*>(o), KV, G, Sc, hd,
      qs, ks, vs, 1.0f / sqrtf(static_cast<float>(hd)), pos, window);
  return cudaGetLastError();
}

}  // namespace

// q (B, KV, G, hd) with strides (qb, qh, qg) and a unit last stride;
// k, v (B, Sc, KV, hd) with strides (kb, ks, kh) / (vb, vs, vh) and a unit
// last stride; kpos (Sc,) int32; o (B, KV, G, hd) contiguous, q's type.
// (q_dtype, c_dtype), 0 = float32 and 1 = bfloat16, one of (0, 0), (1, 0)
// and (1, 1); k and v share c_dtype.
// Launches on `stream` and returns the launch's cudaError_t.
extern "C" int windve_flash_decode(
    const void* q, const void* k, const void* v, const void* kpos, void* o,
    int q_dtype, int c_dtype, int B, int KV, int G, int Sc, int hd,
    long long qb, long long qh, long long qg, long long kb, long long ks,
    long long kh, long long vb, long long vs, long long vh, int pos,
    int window, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || hd <= 0) return cudaSuccess;
  if (Sc < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qstr{qb, qg, qh}, kstr{kb, ks, kh}, vstr{vb, vs, vh};
  const int* kp = static_cast<const int*>(kpos);
  if (q_dtype == 0 && c_dtype == 0)
    return launch<float, float>(q, k, v, kp, o, B, KV, G, Sc, hd, qstr, kstr,
                                vstr, pos, window, st);
  if (q_dtype == 1 && c_dtype == 0)
    return launch<__nv_bfloat16, float>(q, k, v, kp, o, B, KV, G, Sc, hd,
                                        qstr, kstr, vstr, pos, window, st);
  if (q_dtype == 1 && c_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, kp, o, B, KV, G,
                                                Sc, hd, qstr, kstr, vstr,
                                                pos, window, st);
  return cudaErrorInvalidValue;
}
