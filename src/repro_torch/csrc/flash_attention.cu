// Flash attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention_pallas / _flash_kernel): blockwise online-softmax
// attention with GQA (query head h reads KV head h / G), a per-row valid-key
// prefix kv_len, optional causal and sliding-window masks, fp32 scores,
// running max, denominator and accumulator, output = acc / max(den, 1e-30)
// cast to q's type.  In bf16, P is rounded to bf16 before the PV product,
// as the TPU kernel's p.astype(v.dtype) does.
//
// Masking differs from the TPU kernel in one place, on purpose: a masked key
// contributes exactly 0 (its score is -inf, so exp gives 0) instead of a
// -1e30 score.  The two agree on every query row with at least one valid
// key; a row with none (a padding row with kv_len = 0) comes out as zeros,
// the convention of the reference's attention_ref, instead of the mean of
// the masked values.  A NaN there would survive pooling (NaN * 0 is NaN).
//
// What bounds it on this card: at the embedder's shapes (S <= 96, hd 64,
// 16 heads) the work is small -- about 4 * B * H * Sq * kv_len * hd flops
// over q, k, v and o, each read or written once -- so the bound is the
// memory traffic in bf16 and the fp32 CUDA-core rate in fp32 (this kernel
// does not use tensor cores).
//
// Design: one thread block per (64-query tile, head, batch row), so blocks
// run in parallel with no carried state; the TPU grid's sequential key axis
// becomes a loop inside the block over 32-key tiles staged in shared memory
// as fp32.  Four threads share a query row; thread `sub` holds dims
// sub, sub + 4, ... of q and of the accumulator, so the four read
// neighbouring shared-memory words and the dot product is finished with two
// warp shuffles.  Tiles past kv_len[b] (and, with causal or window masks,
// outside the block's band) are skipped.  Inputs may be strided views (the
// head dim must be contiguous), so the caller passes (B, S, H, hd)
// projections without a transpose copy.  Simple and right first: wgmma, TMA
// and warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;             // queries per block
constexpr int BK = 32;             // keys per shared-memory tile
constexpr int TPR = 4;             // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr float NEG = -1e30f;      // initial running max, as in the TPU kernel

struct Strides {
  long long b, h, s;
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

// P as the PV product sees it: rounded to the value type.
template <typename T>
__device__ __forceinline__ float p_round(float p) {
  return to_f(from_f<T>(p));
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ kv_len, T* __restrict__ o,
                       int G, int Sq, int Sk, Strides qs, Strides ks,
                       Strides vs, Strides os, float scale, int causal,
                       int window) {
  constexpr int DPT = HD / TPR;    // dims per thread
  __shared__ float k_tile[BK][HD];
  __shared__ float v_tile[BK][HD];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int row = threadIdx.x / TPR, sub = threadIdx.x % TPR;
  const int qi = q0 + row;
  const bool q_ok = qi < Sq;

  float qr[DPT], acc[DPT];
  const T* qp = q + b * qs.b + h * qs.h + (long long)qi * qs.s;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = q_ok ? to_f(qp[sub + TPR * i]) : 0.f;
    acc[i] = 0.f;
  }

  const int kend = min(max(kv_len[b], 0), Sk);
  int lo = 0, hi = kend;
  if (causal) hi = min(hi, q0 + BQ);          // keys <= the tile's last query
  if (window) lo = max(0, q0 - window + 1);   // keys > first query - window
  lo = (lo / BK) * BK;

  const T* kb = k + b * ks.b + (h / G) * ks.h;
  const T* vb = v + b * vs.b + (h / G) * vs.h;
  float m = NEG, den = 0.f;
  for (int t0 = lo; t0 < hi; t0 += BK) {
    __syncthreads();                 // the previous tile is fully consumed
    for (int idx = threadIdx.x; idx < BK * HD; idx += THREADS) {
      const int j = idx / HD, d = idx % HD, key = t0 + j;
      const bool ok = key < kend;
      k_tile[j][d] = ok ? to_f(kb[key * ks.s + d]) : 0.f;
      v_tile[j][d] = ok ? to_f(vb[key * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[BK];
    float tmax = NEG;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) dot += qr[i] * k_tile[j][sub + TPR * i];
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int key = t0 + j;
      bool ok = key < kend;
      if (causal) ok = ok && key <= qi;
      if (window) ok = ok && key > qi - window;
      s[j] = ok ? dot * scale : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    den *= corr;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);   // exactly 0 for a masked key
      den += p;
      const float pv = p_round<T>(p);
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += pv * v_tile[j][sub + TPR * i];
    }
    m = m_new;
  }

  if (q_ok) {
    T* op = o + b * os.b + h * os.h + (long long)qi * os.s;
    const float d = fmaxf(den, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) op[sub + TPR * i] = from_f<T>(acc[i] / d);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_len, void* o, int B, int H, int KV, int Sq,
                   int Sk, Strides qs, Strides ks, Strides vs, Strides os,
                   int causal, int window, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, HD><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<T*>(o), H / KV, Sq, Sk, qs, ks, vs, os,
      1.0f / sqrtf(static_cast<float>(HD)), causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const void* kv_len, void* o, int B, int H, int KV,
                        int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                        Strides os, int causal, int window,
                        cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, kv_len, o, B, H, KV, Sq, Sk, qs, ks, vs,
                           os, causal, window, stream);
    case 32:
      return launch<T, 32>(q, k, v, kv_len, o, B, H, KV, Sq, Sk, qs, ks, vs,
                           os, causal, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, kv_len, o, B, H, KV, Sq, Sk, qs, ks, vs,
                           os, causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, kv_len, o, B, H, KV, Sq, Sk, qs, ks, vs,
                            os, causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, hd), k and v (B, KV, Sk, hd), o (B, H, Sq, hd), each given by
// its (batch, head, position) strides in elements with a contiguous head
// dim; kv_len (B,) int32 on the device.  dtype 0 = float32, 1 = bfloat16.
// Launches on `stream` and returns the launch's cudaError_t.
extern "C" int windve_flash_attention(
    const void* q, const void* k, const void* v, const void* kv_len, void* o,
    int dtype, int B, int H, int KV, int Sq, int Sk, int hd,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int causal, int window, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || Sk < 0) return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, kv_len, o, B, H, KV, Sq, Sk, qs,
                              ks, vs, os, causal, window, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, kv_len, o, B, H, KV, Sq,
                                      Sk, qs, ks, vs, os, causal, window, st);
  return cudaErrorInvalidValue;
}
