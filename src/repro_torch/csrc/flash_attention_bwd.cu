// Backward of flash attention for NVIDIA Hopper (sm_90a).
//
// The gradient of csrc/flash_attention.cu's function (the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py has none; the
// reference trains through its jnp attention, whose autodiff this computes):
// given q (B, H, Sq, hd), k and v (B, KV, Sk, hd), the forward's output o
// and its per-row log-sum-exp lse (fp32 (B, H, Sq), -1e30 for a row with no
// valid key), and the output's gradient dO, it writes dq, dk and dv with
// the forward's masks (ragged kv_len, causal, sliding window, GQA with query
// head h on KV head h / G, Sq != Sk):
//
//   P  = exp(scale * Q K^T - lse)          (0 where masked)
//   D  = rowsum(dO * O)
//   dS = P * (dO V^T - D)
//   dV = P^T dO,  dK = scale * dS^T Q,  dQ = scale * dS K
//
// Inputs are fp32 or bf16; every product and sum is fp32, and the gradients
// are cast to the input's type once at the end.
//
// Three kernels, in this order, no float atomics (the result does not depend
// on the schedule):
//   - delta: D, one warp a row, into an fp32 workspace;
//   - dkdv: a block owns a tile of 32 keys of one (batch row, KV head) and
//     walks every query tile of every query head of its group that can see
//     the keys, recomputing the scores and dO V^T, and holds its dK and dV
//     in registers until the end;
//   - dq: a block owns a tile of 32 queries of one (batch row, head) and
//     walks the key tiles its queries can see, recomputing P and dS.
// Both recompute the scores; that buys the determinism a shared dQ written
// with atomics would lose.
//
// A simple design, on the CUDA cores: tiles of 32 rows staged in shared
// memory as fp32 (rows padded by one float so a warp's 32 keys hit 32
// banks), 8 warps a block.  In the score step a warp takes 4 query rows and
// its lanes the 32 keys; in the accumulation a lane owns one key (dkdv) or
// one query (dq) and the warps split the head dim.  Tensor cores and TMA are
// later work: at stablelm-1.6b's training shape the bound is the multiply
// rate, and this kernel runs at a fraction of the fp32 one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

struct Strides {
  long long b, h, s;
};

constexpr int BT = 32;                 // queries or keys a tile
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int RPW = BT / WARPS;        // score rows a warp
constexpr int SP = BT + 1;             // pitch of a (query, key) tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows [0, BT) of a tile as fp32 at pitch HD + 1: row r is HD elements at
// src + r * stride for r < rows, zeros after
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int rows) {
  for (int i = threadIdx.x; i < BT * HD; i += THREADS) {
    const int r = i / HD, c = i % HD;
    dst[r * (HD + 1) + c] = r < rows ? ld(src + r * stride + c) : 0.f;
  }
}

__device__ __forceinline__ bool visible(int q, int key, int kend, int causal,
                                        int window) {
  return key < kend && (!causal || key <= q) && (!window || key > q - window);
}

template <int HD>
constexpr size_t smem_bytes() {
  // four (BT, HD) tiles, two (BT, BT) tiles, lse and D of BT rows
  return (4 * BT * (HD + 1) + 2 * BT * SP + 2 * BT) * sizeof(float);
}

// D = rowsum(dO * O) a (b, h, query) row, at delta[(b * H + h) * Sq + i]
template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
               float* __restrict__ delta, int B, int H, int Sq, int hd,
               Strides os, Strides ds) {
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * H * Sq) return;
  const int i = row % Sq;
  const int h = (row / Sq) % H;
  const int b = row / ((long long)Sq * H);
  const T* op = o + b * os.b + h * os.h + i * os.s;
  const T* dp = dout + b * ds.b + h * ds.h + i * ds.s;
  float s = 0.f;
  for (int c = lane; c < hd; c += 32) s += ld(op + c) * ld(dp + c);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// The score step both kernels share: for the warp's RPW query rows of the
// q/dO tiles and the lane's key of the k/v tiles, P and dS into p_s / ds_s
// (p_s may be null).  q0 and k0 are the tiles' first query and key.
template <int HD>
__device__ __forceinline__ void score_step(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    const float* l_s, const float* d_s, float* p_s, float* ds_s, int q0,
    int k0, int Sq, int kend, float scale, int causal, int window) {
  constexpr int P = HD + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float s[RPW], dp[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 8
  for (int c = 0; c < HD; ++c) {
    const float kc = k_s[lane * P + c], vc = v_s[lane * P + c];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int i = warp * RPW + r;
      s[r] = fmaf(q_s[i * P + c], kc, s[r]);
      dp[r] = fmaf(do_s[i * P + c], vc, dp[r]);
    }
  }
  const int key = k0 + lane;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = warp * RPW + r, q = q0 + i;
    const bool ok = q < Sq && visible(q, key, kend, causal, window);
    const float p = ok ? expf(fmaf(s[r], scale, -l_s[i])) : 0.f;
    if (p_s != nullptr) p_s[i * SP + lane] = p;
    ds_s[i * SP + lane] = p * (dp[r] - d_s[i]);
  }
}

// lse and D of query rows [q0, q0 + BT) of (b, h) into l_s / d_s
__device__ __forceinline__ void load_rows(float* l_s, float* d_s,
                                          const float* lse, const float* delta,
                                          long long base, int q0, int Sq) {
  if (threadIdx.x < BT) {
    const int q = q0 + threadIdx.x;
    l_s[threadIdx.x] = q < Sq ? lse[base + q] : NEG;
    d_s[threadIdx.x] = q < Sq ? delta[base + q] : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ kv_len, T* __restrict__ dk,
              T* __restrict__ dv, int B, int H, int G, int Sq, int Sk,
              Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,
              Strides dvs, float scale, int causal, int window) {
  constexpr int P = HD + 1, DPT = HD / WARPS;
  extern __shared__ float sm[];
  float* k_s = sm;
  float* v_s = k_s + BT * P;
  float* q_s = v_s + BT * P;
  float* do_s = q_s + BT * P;
  float* p_s = do_s + BT * P;
  float* ds_s = p_s + BT * SP;
  float* l_s = ds_s + BT * SP;
  float* d_s = l_s + BT;

  const int KV = H / G, ntk = (Sk + BT - 1) / BT;
  const int kt = blockIdx.x % ntk;
  const int kh = (blockIdx.x / ntk) % KV;
  const int b = blockIdx.x / (ntk * KV);
  const int k0 = kt * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kend = min(max(kv_len[b], 0), Sk);

  float dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int m = 0; m < DPT; ++m) dk_acc[m] = dv_acc[m] = 0.f;

  if (k0 < kend) {
    load_tile<T, HD>(k_s, k + b * ks.b + kh * ks.h + k0 * ks.s, ks.s,
                     min(BT, kend - k0));
    load_tile<T, HD>(v_s, v + b * vs.b + kh * vs.h + k0 * vs.s, vs.s,
                     min(BT, kend - k0));
    // the queries that can see a key of the tile: q >= k0 under the causal
    // mask, q < last key + window under the window
    const int qlo = causal ? (k0 / BT) * BT : 0;
    const int qhi = window ? min(Sq, k0 + BT - 1 + window) : Sq;
    for (int hh = 0; hh < G; ++hh) {
      const int h = kh * G + hh;
      const long long base = ((long long)b * H + h) * Sq;
      for (int q0 = qlo; q0 < qhi; q0 += BT) {
        __syncthreads();            // the last tile's q, dO, P and dS read
        load_tile<T, HD>(q_s, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s,
                         min(BT, Sq - q0));
        load_tile<T, HD>(do_s, dout + b * dos.b + h * dos.h + q0 * dos.s,
                         dos.s, min(BT, Sq - q0));
        load_rows(l_s, d_s, lse, delta, base, q0, Sq);
        __syncthreads();
        score_step<HD>(q_s, do_s, k_s, v_s, l_s, d_s, p_s, ds_s, q0, k0, Sq,
                       kend, scale, causal, window);
        __syncthreads();
        // the lane's key, the warp's head-dim columns
#pragma unroll 4
        for (int i = 0; i < BT; ++i) {
          const float p = p_s[i * SP + lane], dsv = ds_s[i * SP + lane];
#pragma unroll
          for (int m = 0; m < DPT; ++m) {
            const int d = warp + WARPS * m;
            dv_acc[m] = fmaf(p, do_s[i * P + d], dv_acc[m]);
            dk_acc[m] = fmaf(dsv, q_s[i * P + d], dk_acc[m]);
          }
        }
      }
    }
  }
  const int key = k0 + lane;
  if (key < Sk) {
    T* dkp = dk + b * dks.b + kh * dks.h + key * dks.s;
    T* dvp = dv + b * dvs.b + kh * dvs.h + key * dvs.s;
#pragma unroll
    for (int m = 0; m < DPT; ++m) {
      const int d = warp + WARPS * m;
      st(dkp + d, dk_acc[m] * scale);
      st(dvp + d, dv_acc[m]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const int* __restrict__ kv_len, T* __restrict__ dq, int B, int H,
            int G, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
            Strides dos, Strides dqs, float scale, int causal, int window) {
  constexpr int P = HD + 1, DPT = HD / WARPS;
  extern __shared__ float sm[];
  float* k_s = sm;
  float* v_s = k_s + BT * P;
  float* q_s = v_s + BT * P;
  float* do_s = q_s + BT * P;
  float* ds_s = do_s + BT * P + BT * SP;   // the P tile is not kept
  float* l_s = ds_s + BT * SP;
  float* d_s = l_s + BT;

  const int ntq = (Sq + BT - 1) / BT;
  const int qt = blockIdx.x % ntq;
  const int h = (blockIdx.x / ntq) % H;
  const int b = blockIdx.x / (ntq * H);
  const int q0 = qt * BT, kh = h / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kend = min(max(kv_len[b], 0), Sk);
  const long long base = ((long long)b * H + h) * Sq;

  load_tile<T, HD>(q_s, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s,
                   min(BT, Sq - q0));
  load_tile<T, HD>(do_s, dout + b * dos.b + h * dos.h + q0 * dos.s, dos.s,
                   min(BT, Sq - q0));
  load_rows(l_s, d_s, lse, delta, base, q0, Sq);

  float dq_acc[DPT];
#pragma unroll
  for (int m = 0; m < DPT; ++m) dq_acc[m] = 0.f;
  // the keys the tile's queries can see
  const int klo = window ? (max(0, q0 - window + 1) / BT) * BT : 0;
  const int khi = causal ? min(kend, q0 + BT) : kend;
  for (int k0 = klo; k0 < khi; k0 += BT) {
    __syncthreads();                // the last key tile and dS read
    load_tile<T, HD>(k_s, k + b * ks.b + kh * ks.h + k0 * ks.s, ks.s,
                     min(BT, kend - k0));
    load_tile<T, HD>(v_s, v + b * vs.b + kh * vs.h + k0 * vs.s, vs.s,
                     min(BT, kend - k0));
    __syncthreads();
    score_step<HD>(q_s, do_s, k_s, v_s, l_s, d_s, nullptr, ds_s, q0, k0, Sq,
                   kend, scale, causal, window);
    __syncthreads();
    // the lane's query, the warp's head-dim columns
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      const float dsv = ds_s[lane * SP + j];
#pragma unroll
      for (int m = 0; m < DPT; ++m)
        dq_acc[m] = fmaf(dsv, k_s[j * P + warp + WARPS * m], dq_acc[m]);
    }
  }
  const int qi = q0 + lane;
  if (qi < Sq) {
    T* dqp = dq + b * dqs.b + h * dqs.h + qi * dqs.s;
#pragma unroll
    for (int m = 0; m < DPT; ++m) st(dqp + warp + WARPS * m, dq_acc[m] * scale);
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout, *lse, *kv_len;
  void *dq, *dk, *dv, *delta;
  int B, H, KV, Sq, Sk;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int causal, window;
  cudaStream_t st;
};

template <typename T, int HD>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = smem_bytes<HD>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_dkdv<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attn_bwd_dq<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int G = a.H / a.KV;
  const float scale = 1.f / sqrtf(static_cast<float>(HD));
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  float* delta = static_cast<float*>(a.delta);
  const int* kv_len = static_cast<const int*>(a.kv_len);

  const long long rows = (long long)a.B * a.H * a.Sq;
  const long long dblocks = (rows + WARPS - 1) / WARPS;
  const long long kblocks = (long long)((a.Sk + BT - 1) / BT) * a.KV * a.B;
  const long long qblocks = (long long)((a.Sq + BT - 1) / BT) * a.H * a.B;
  if (dblocks > 0x7fffffffLL || kblocks > 0x7fffffffLL
      || qblocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  attn_bwd_delta<T><<<static_cast<unsigned>(dblocks), THREADS, 0, a.st>>>(
      static_cast<const T*>(a.o), dout, delta, a.B, a.H, a.Sq, HD, a.os,
      a.dos);
  if (kblocks > 0)
    attn_bwd_dkdv<T, HD><<<static_cast<unsigned>(kblocks), THREADS, smem,
                           a.st>>>(
        q, k, v, dout, lse, delta, kv_len, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.B, a.H, G, a.Sq, a.Sk, a.qs, a.ks, a.vs,
        a.dos, a.dks, a.dvs, scale, a.causal, a.window);
  attn_bwd_dq<T, HD><<<static_cast<unsigned>(qblocks), THREADS, smem,
                       a.st>>>(
      q, k, v, dout, lse, delta, kv_len, static_cast<T*>(a.dq), a.B, a.H, G,
      a.Sq, a.Sk, a.qs, a.ks, a.vs, a.dos, a.dqs, scale, a.causal, a.window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a) {
  switch (hd) {
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, hd), k and v (B, KV, Sk, hd), o and dout (B, H, Sq, hd), and
// the gradients dq, dk, dv (q's, k's and v's shapes), each given by its
// (batch, head, position) strides in elements with a contiguous head dim, in
// `strides` in that order (8 tensors x 3).  lse (B, H, Sq) fp32 contiguous,
// from the forward; delta an fp32 workspace of the same shape; kv_len (B,)
// int32.  dtype 0 = float32, 1 = bfloat16 (every tensor but lse, delta and
// kv_len).  Launches on `stream` and returns the launches' cudaError_t.
extern "C" int windve_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* kv_len, void* dq, void* dk,
    void* dv, void* delta, int dtype, int B, int H, int KV, int Sq, int Sk,
    int hd, const long long* strides, int causal, int window, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || Sk < 0) return cudaErrorInvalidValue;
  const long long* s = strides;
  Args a{q,  k,  v,  o,  dout, lse, kv_len, dq, dk, dv, delta,
         B,  H,  KV, Sq, Sk,
         {s[0], s[1], s[2]},    {s[3], s[4], s[5]},    {s[6], s[7], s[8]},
         {s[9], s[10], s[11]},  {s[12], s[13], s[14]}, {s[15], s[16], s[17]},
         {s[18], s[19], s[20]}, {s[21], s[22], s[23]},
         causal, window, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_hd<float>(hd, a);
  if (dtype == 1) return dispatch_hd<bf16>(hd, a);
  return cudaErrorInvalidValue;
}
