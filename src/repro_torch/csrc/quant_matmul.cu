// int8 projection kernels for NVIDIA Hopper (sm_90a): the weight-only GEMM,
// the per-row activation quantizer and the int8 x int8 GEMM of the W8A8
// policy.  Plain C entry points at the end, bound with ctypes.
#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int MAX_GRID_Y = 65535;

// ---------------------------------------------------------------------------
// windve_quant_matmul: out[m, n] = (sum_k x[m, k] * w8[k, n]) * scale[n]
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul/quant_matmul.py:111
// (quant_matmul_pallas / _quant_matmul_kernel), the weight-only int8
// projection of the `int8` serving policy.
//
// What bounds it on this card: the tensor cores' rate.  The policy computes
// in fp32 and is held to the fp32 path's tolerance, which the CUDA cores'
// fp32 FMAs (67 TFLOP/s) meet and TF32 (10-bit significands) does not.
// But the products can be formed exactly on the bf16 tensor cores
// (989 TFLOP/s):
//   - every int8 weight in [-127, 127] is exact in bf16 (8 significant
//     bits);
//   - an fp32 x is the exact sum of three bf16 terms h + m + l: h keeps
//     the top 8 of x's 24 significant bits, m the next 8 of the remainder
//     x - h, l the rest, and both subtractions are exact in fp32;
//   - a bf16 x bf16 product is exact in fp32.
// So sum_k (l w + m w + h w), accumulated in fp32, is an fp32-accurate
// product at 3 * 2MKN tensor-core operations, about a fifth of the time of
// 2MKN fp32 FMAs.  Three terms are the least that hold all 24 bits: two
// drop up to 8 bits of x (a relative error near 2^-16, a hundred times
// fp32's rounding).  A bf16 x is its own h (m = l = 0) and takes one pass.
//
// Design: mma.sync.m16n8k16 (bf16 in, fp32 accumulators in registers) on
// 128 x 128 output tiles, 8 warps of 32 x 64, K steps of 64.
//   - Staging: a ring of 3 raw tiles in shared memory, filled with 16-byte
//     cp.async copies (4 fp32 or 8 bf16 of x, 16 weights of w8): while
//     one K step computes, the next is widened and the one after loads.
//     The copies' source rows
//     and bounds are worked out once a thread.  x views whose row stride
//     or base is not 16-byte aligned, and w8 whose N is not a multiple of
//     16, take an instantiation that copies element by element.  Rows past
//     M, columns past N and K are zero-filled, so they add exactly 0.
//   - A fragments: fp32 x is read from its raw tile (rows padded by 8
//     floats, so the float2 reads are conflict-free) and split in
//     registers into h, m and l as the fragments are formed.  The split
//     truncates: h is x with its low 16 bits cleared, m likewise of x - h,
//     and l = x - h - m, which has at most 8 significant bits and so is
//     bf16 already.  Truncation splits as exactly as rounding and needs no
//     conversion instruction: a mask, a subtract and a byte permute a
//     value.  bf16 x is read with ldmatrix as it is.
//   - B fragments: while the tensor cores run step i, the block widens raw
//     w8 tile i + 1 into a second, double-buffered bf16 tile (a byte
//     becomes a bf16 through fp32: 2^23 + (b + 128) - (2^23 + 128), exact,
//     and its top 16 bits), read with ldmatrix.trans from rows padded to
//     272 bytes (conflict-free).
//   - Accumulation: the tensor cores' fp32 sum inside an mma is not
//     round-to-nearest, so each 32 values of K sum into a fresh fragment
//     (the l, then m, then h products: small to large) that is then added
//     into the running fp32 sum with an ordinary FADD.
//   - Epilogue: the scale multiplies each sum once, then the result is
//     stored in x's type.
// Subnormal terms (an x below about 1e-33 in magnitude) may be flushed by
// the tensor cores, a loss below 2^-16 of such an x.  An infinite x gives
// NaN (x - h is inf - inf) where the plain version gives an infinity.
// ---------------------------------------------------------------------------
namespace qm {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128, BN = 128, BK = 64;  // BK: a multiple of 32
constexpr int WARPS_M = 4, WARPS_N = 2, THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;    // 32 x 64 a warp
constexpr int MT = WM / 16, NT = WN / 8;               // 2 x 8 mma tiles
constexpr int STAGES = 3;                              // raw tiles in the ring
constexpr int WP = BN + 8;     // bf16 a row of the B tile: 272 bytes

template <typename T>
struct Layout {
  static constexpr int TERMS = sizeof(T) == 4 ? 3 : 1;
  // raw x rows padded by 8 values: conflict-free float2 reads of fp32 A
  // fragments, conflict-free ldmatrix of bf16 ones
  static constexpr int XP = BK + 8;
  static constexpr int X_BYTES = BM * XP * sizeof(T);        // a raw x stage
  static constexpr int W_BYTES = BK * BN;                     // a raw w8 stage
  static constexpr int B_BYTES = BK * WP * 2;                 // widened w8
  static constexpr size_t SMEM = STAGES * (X_BYTES + W_BYTES) + 2 * B_BYTES;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The top halves of two fp32 bit patterns as a bf16 pair, lo in the low
// half: the truncating fp32 -> bf16 conversion of both.
__device__ __forceinline__ unsigned top_halves(unsigned lo, unsigned hi) {
  return __byte_perm(lo, hi, 0x7632);
}

// x0, x1 = h + m + l exactly, each term a bf16 pair.
__device__ __forceinline__ void split2(float x0, float x1, unsigned& h,
                                       unsigned& m, unsigned& l) {
  const unsigned a0 = __float_as_uint(x0), a1 = __float_as_uint(x1);
  const float r0 = x0 - __uint_as_float(a0 & 0xffff0000u);
  const float r1 = x1 - __uint_as_float(a1 & 0xffff0000u);
  const unsigned b0 = __float_as_uint(r0), b1 = __float_as_uint(r1);
  const float s0 = r0 - __uint_as_float(b0 & 0xffff0000u);
  const float s1 = r1 - __uint_as_float(b1 & 0xffff0000u);
  h = top_halves(a0, a1);
  m = top_halves(b0, b1);
  l = top_halves(__float_as_uint(s0), __float_as_uint(s1));
}

// Bytes j and j + 1 of w (whose bytes are int8 + 128) as a bf16 pair.
__device__ __forceinline__ unsigned widen2(unsigned w, int j) {
  const float f0 =
      __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7440 + j)) - 8388736.f;
  const float f1 =
      __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7441 + j)) - 8388736.f;
  return top_halves(__float_as_uint(f0), __float_as_uint(f1));
}

// Copies K steps into raw stages: BM rows of BK of x, BK rows of BN of w8.
// Each thread owns the same chunks at every step (XN of x, WN8 of w8), so
// their source rows and bounds are worked out once.  XV / WV: 16-byte
// cp.async copies, else element copies.
template <typename T, bool XV, bool WV>
struct Loader {
  static constexpr int XC = 16 / sizeof(T);     // x values a 16-byte copy
  static constexpr int XPR = BK / XC;           // copies a row
  static constexpr int XN = BM * XPR / THREADS;  // x copies a thread
  static constexpr int XROWS = THREADS / XPR;    // rows between them
  static constexpr int WN8 = BK * BN / 16 / THREADS;   // w8 copies a thread
  static constexpr int WROWS = THREADS / (BN / 16);    // rows between them
  const T* xrow;         // the thread's first x row, at its column
  const int8_t* wrow;    // its first w8 row of step 0, at its column
  long long ldx;
  int xrows_ok;          // how many of its XN rows are < M
  int xc, wr, wc, K, N, n_left, ws_off, xs_off;

  __device__ __forceinline__ Loader(const T* x, long long ldx_,
                                    const int8_t* w, int M, int N_, int K_,
                                    int m0, int n0) {
    const int r = threadIdx.x / XPR;
    xc = (threadIdx.x % XPR) * XC;
    ldx = ldx_;
    xrow = x + (long long)(m0 + r) * ldx + xc;
    xrows_ok = 0;
#pragma unroll
    for (int t = 0; t < XN; ++t) xrows_ok += m0 + r + t * XROWS < M;
    xs_off = r * Layout<T>::XP + xc;
    wr = threadIdx.x / (BN / 16);
    wc = (threadIdx.x % (BN / 16)) * 16;
    K = K_;
    N = N_;
    n_left = N - (n0 + wc);
    wrow = w + (long long)wr * N + n0 + wc;
    ws_off = wr * BN + wc;
  }

  __device__ __forceinline__ void load(T* xs, int8_t* ws, int k0) const {
    const int kx = K - (k0 + xc);                  // x values left in a row
#pragma unroll
    for (int t = 0; t < XN; ++t) {
      T* d = xs + xs_off + t * XROWS * Layout<T>::XP;
      const T* src = xrow + t * XROWS * ldx + k0;
      const bool row_ok = t < xrows_ok;
      if (XV) {                                    // K % XC == 0
        if (row_ok && kx > 0)
          cp_async16(d, src);
        else
          *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      } else {
#pragma unroll
        for (int e = 0; e < XC; ++e)
          d[e] = row_ok && e < kx ? src[e] : static_cast<T>(0.f);
      }
    }
#pragma unroll
    for (int t = 0; t < WN8; ++t) {
      int8_t* d = ws + ws_off + t * WROWS * BN;
      const int kr = k0 + t * WROWS;
      const int8_t* src = wrow + (long long)kr * N;
      const bool k_ok = kr + wr < K;
      if (WV) {                                    // N % 16 == 0
        if (k_ok && n_left > 0)
          cp_async16(d, src);
        else
          *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) d[e] = k_ok && e < n_left ? src[e] : 0;
      }
    }
  }
};
static_assert(BK * BN / 16 % THREADS == 0, "whole w8 copies a thread");

// One 16 x 16 A tile of fp32 x from shared memory (p at row g, column 2t
// of it; rows XP floats apart) as its h, m and l fragments.
__device__ __forceinline__ void split_frag(const float* p, int XP,
                                           unsigned (&h)[4], unsigned (&m)[4],
                                           unsigned (&l)[4]) {
  const float2 a0 = *reinterpret_cast<const float2*>(p);
  const float2 a1 = *reinterpret_cast<const float2*>(p + 8 * XP);
  const float2 a2 = *reinterpret_cast<const float2*>(p + 8);
  const float2 a3 = *reinterpret_cast<const float2*>(p + 8 * XP + 8);
  split2(a0.x, a0.y, h[0], m[0], l[0]);
  split2(a1.x, a1.y, h[1], m[1], l[1]);
  split2(a2.x, a2.y, h[2], m[2], l[2]);
  split2(a3.x, a3.y, h[3], m[3], l[3]);
}

// Raw w8 stage -> its bf16 tile.
__device__ __forceinline__ void widen_tile(const int8_t* ws, bf16* b) {
#pragma unroll
  for (int i = threadIdx.x; i < BK * BN / 16; i += THREADS) {
    const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
    const uint4 u = *reinterpret_cast<const uint4*>(ws + r * BN + c);
    const unsigned q[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u,
                           u.z ^ 0x80808080u, u.w ^ 0x80808080u};
    *reinterpret_cast<uint4*>(b + r * WP + c) =
        make_uint4(widen2(q[0], 0), widen2(q[0], 2), widen2(q[1], 0),
                   widen2(q[1], 2));
    *reinterpret_cast<uint4*>(b + r * WP + c + 8) =
        make_uint4(widen2(q[2], 0), widen2(q[2], 2), widen2(q[3], 0),
                   widen2(q[3], 2));
  }
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

template <typename T, bool XV, bool WV>
__global__ void __launch_bounds__(THREADS, 1)
quant_matmul_tc(const T* __restrict__ x, long long ldx,
                const int8_t* __restrict__ w, const float* __restrict__ scale,
                T* __restrict__ out, int M, int N, int K) {
  using L = Layout<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xraw = reinterpret_cast<T*>(smem);                          // STAGES
  int8_t* wraw = reinterpret_cast<int8_t*>(smem + STAGES * L::X_BYTES);
  bf16* bwide = reinterpret_cast<bf16*>(
      smem + STAGES * (L::X_BYTES + L::W_BYTES));                // 2 buffers
  constexpr int XS = L::X_BYTES / sizeof(T);  // elements a raw x stage
  constexpr int XP = L::XP;
  constexpr int BS = L::B_BYTES / 2;          // bf16 a widened buffer

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int steps = (K + BK - 1) / BK;
  const Loader<T, XV, WV> loader(x, ldx, w, M, N, K, m0, n0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      loader.load(xraw + s * XS, wraw + s * L::W_BYTES, s * BK);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();              // step 0 has landed
  __syncthreads();
  widen_tile(wraw, bwide);

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int it = 0; it < steps; ++it) {
    // step it + 1 has landed; every thread is done with step it - 1's
    // buffers and has widened step it
    cp_async_wait<STAGES - 3>();
    __syncthreads();
    {
      const int ld = it + STAGES - 1;       // into the stage step it - 1 used
      if (ld < steps)
        loader.load(xraw + (ld % STAGES) * XS,
                    wraw + (ld % STAGES) * L::W_BYTES, ld * BK);
      cp_async_commit();
    }
    const T* xt = xraw + (it % STAGES) * XS;
    const bf16* bt = bwide + (it % 2) * BS;
#pragma unroll
    for (int k32 = 0; k32 < BK; k32 += 32) {
      unsigned bfr[2][NT][2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          unsigned r[4];
          ldsm_x4_trans(r, bt + (k32 + 16 * kk + (lane & 15)) * WP + wn0
                               + 8 * j + (lane >> 4) * 8);
          bfr[kk][j][0] = r[0];
          bfr[kk][j][1] = r[1];
          bfr[kk][j + 1][0] = r[2];
          bfr[kk][j + 1][1] = r[3];
        }
      // A fragments of every term: fp32 x split in registers, bf16 x read
      // with ldmatrix
      unsigned afr[L::TERMS][2][MT][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if constexpr (L::TERMS == 3) {
            split_frag(reinterpret_cast<const float*>(xt)
                           + (wm0 + 16 * i + lane / 4) * XP + k32 + 16 * kk
                           + 2 * (lane % 4),
                       XP, afr[0][kk][i], afr[1][kk][i], afr[2][kk][i]);
          } else {
            ldsm_x4(afr[0][kk][i],
                    reinterpret_cast<const bf16*>(xt)
                        + (wm0 + 16 * i + (lane & 15)) * XP + k32 + 16 * kk
                        + (lane >> 4) * 8);
          }
        }
      float t[MT][NT][4];                   // these 32 K values' products
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) t[i][j][e] = 0.f;
#pragma unroll
      for (int term = L::TERMS - 1; term >= 0; --term) {   // l, m, h
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j)
              mma(t[i][j], afr[term][kk][i], bfr[kk][j][0], bfr[kk][j][1]);
        if (k32 == 0 && term == L::TERMS - 1 && it + 1 < steps)
          // widen step it + 1 while the tensor cores work
          widen_tile(wraw + ((it + 1) % STAGES) * L::W_BYTES,
                     bwide + ((it + 1) % 2) * BS);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += t[i][j][e];
    }
  }

  const int g = lane / 4, tq = lane % 4;
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + wn0 + 8 * j + 2 * tq;
    if (n >= N) continue;
    const float s0 = scale[n];
    const float s1 = n + 1 < N ? scale[n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = m0 + wm0 + 16 * i + g + 8 * hf;
        if (m >= M) continue;
        const float v0 = acc[i][j][2 * hf] * s0;
        const float v1 = acc[i][j][2 * hf + 1] * s1;
        T* p = out + (long long)m * N + n;
        if (pairs) {
          store2(p, v0, v1);
        } else {
          store(p, v0);
          if (n + 1 < N) store(p + 1, v1);
        }
      }
  }
}

template <typename T, bool XV, bool WV>
cudaError_t launch(const void* x, long long ldx, const int8_t* w,
                   const float* s, void* out, int M, int N, int K,
                   cudaStream_t st) {
  auto kernel = quant_matmul_tc<T, XV, WV>;
  constexpr size_t smem = Layout<T>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, st>>>(static_cast<const T*>(x), ldx, w, s,
                                      static_cast<T*>(out), M, N, K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, long long ldx, const int8_t* w,
                     const float* s, void* out, int M, int N, int K,
                     cudaStream_t st) {
  constexpr int XC = 16 / sizeof(T);
  const bool xv = ldx % XC == 0 && K % XC == 0
                  && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool wv = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (xv && wv) return launch<T, true, true>(x, ldx, w, s, out, M, N, K, st);
  if (xv) return launch<T, true, false>(x, ldx, w, s, out, M, N, K, st);
  if (wv) return launch<T, false, true>(x, ldx, w, s, out, M, N, K, st);
  return launch<T, false, false>(x, ldx, w, s, out, M, N, K, st);
}

}  // namespace qm

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
// What bounds it on this card: memory.  It reads x once and writes one byte
// a value and one scale a row.  At bge's widths (M 1536, K 1024 or 4096)
// that is 8 or 31 MB, a few microseconds, so a launch's fixed cost and the
// latency of one round of loads weigh as much as the bytes.
//
// Design: a group of WPR warps takes a row (a warp at K 1024, four at K
// 4096: as few as hold the row in registers, CPL chunks a lane).  Each
// lane owns chunks of VALS = 16 consecutive values: it issues all its
// 16-byte loads of the row at once, takes its amax, and the group reduces
// by warp shuffles (max is exact in any order), across warps through
// shared memory behind one barrier.  The lane then quantizes the values it
// holds and writes each chunk's 16 bytes with one store.  The grid is one
// wave, sized from the card (its SM count times the blocks an SM holds of
// the kernel as compiled), and walks the rows in a grid-stride loop, with
// the next row's loads issued before this row is reduced.  A row too wide
// to hold (K past MAX_WPR * 32 * CPL * VALS) is read twice: once for its
// amax, once to quantize (the second read from L1 or L2).  Views whose base
// or row stride is not 16-byte aligned, or whose K is not a multiple of
// VALS, take the same code with element loads and byte stores.  One warp a
// row that reads a K 4096 row twice, two warps a row, 8-value chunks, a
// true divide a value and rintf were each timed against this design
// (benchmarks/torch_kernel_variants.py --set quantize_rows; PERF.md): the
// divide cost most, 0.0081 ms against 0.0045 at K 1024.
//
// Bit for bit the plain version (kernels/quant_matmul/ref.py), and so the
// JAX package:
//   - subnormals are flushed by hand, as XLA does on the CPU and the TPU,
//     so the result does not depend on the compiler's -ftz setting; the
//     amax is taken before the flush (the max of the flushed values is the
//     raw max unless every value is subnormal);
//   - the scale is a true IEEE divide;
//   - x / scale is the correctly rounded quotient, formed as a product
//     with r = 1 / scale (correctly rounded, once a row) and corrected by
//     one residual (e = x - q s, exact by an FMA; q + e r rounds to x / s:
//     Markstein's theorem).  It needs the residual exact, which holds for
//     every quotient that can round to a nonzero int8 once scale >= 2^-100;
//     rows with a smaller or infinite scale divide with __fdiv_rn;
//   - rounding half to even is an add of 1.5 * 2^23 to the clamped
//     quotient: the sum's ulp is 1, so the add rounds to the nearest even
//     integer, and the int8 is the low byte of its bit pattern (no
//     conversion instruction, which issues at a sixteenth of an add's rate).
// tests/test_torch_quantize_rows.py emulates this arithmetic on the CPU
// against the plain version and the JAX package.
// ---------------------------------------------------------------------------
namespace qr {

constexpr int VALS = 16;         // consecutive values a lane owns
constexpr int CPL = 2;           // chunks of VALS a lane holds
constexpr int MAX_WPR = 8;       // warps a row, at most
constexpr int BLOCK = 128;       // threads a block when a warp takes a row
constexpr float ROUNDER = 12582912.0f;  // 1.5 * 2^23
static_assert(VALS % 8 == 0 && VALS <= 32, "VALS: whole 16-byte loads");
static_assert(MAX_WPR <= 8, "launch caches occupancy for wpr 1, 2, 4, 8");
constexpr int MAX_THREADS = BLOCK > MAX_WPR * 32 ? BLOCK : MAX_WPR * 32;

// VALS consecutive values of a row: 16-byte loads (VEC), or elements, the
// ones past K read as 0.
template <typename T, bool VEC>
struct Chunk {
  static constexpr int LOADS = VALS * sizeof(T) / 16;
  uint4 v[VEC ? LOADS : 1];
  T e[VEC ? 1 : VALS];

  __device__ __forceinline__ void load(const T* p, int left) {
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < LOADS; ++i)
        v[i] = reinterpret_cast<const uint4*>(p)[i];
    } else {
#pragma unroll
      for (int i = 0; i < VALS; ++i)
        e[i] = i < left ? p[i] : static_cast<T>(0.f);
    }
  }

  __device__ __forceinline__ void get(float (&f)[VALS]) const {
    if constexpr (!VEC) {
#pragma unroll
      for (int i = 0; i < VALS; ++i) f[i] = to_f(e[i]);
    } else if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        f[4 * i] = __uint_as_float(v[i].x);
        f[4 * i + 1] = __uint_as_float(v[i].y);
        f[4 * i + 2] = __uint_as_float(v[i].z);
        f[4 * i + 3] = __uint_as_float(v[i].w);
      }
    } else {                          // bf16: two a word, low half first
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const unsigned w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          f[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
          f[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
        }
      }
    }
  }
};

__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < FLT_MIN ? 0.f : v;
}

// The int8 of v under scale s (r = 1 / s when RCP), as the low byte of the
// result.
template <bool RCP>
__device__ __forceinline__ unsigned quantize(float v, float s, float r) {
  v = flush(v);
  float d;
  if (RCP) {
    const float q = __fmul_rn(v, r);
    d = __fmaf_rn(__fmaf_rn(-q, s, v), r, q);
  } else {
    d = __fdiv_rn(v, s);
  }
  d = fminf(fmaxf(d, -127.f), 127.f);
  return __float_as_uint(__fadd_rn(d, ROUNDER));
}

// Low bytes of a, b, c, d as one word, a's lowest.
__device__ __forceinline__ unsigned pack4(unsigned a, unsigned b, unsigned c,
                                          unsigned d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// Quantizes a chunk and stores its VALS bytes at p (the first `left` of
// them on the element path).
template <bool RCP, typename T, bool VEC>
__device__ __forceinline__ void put(const Chunk<T, VEC>& c, int8_t* p,
                                    int left, float s, float r) {
  float f[VALS];
  c.get(f);
  unsigned w[VALS / 4];
#pragma unroll
  for (int i = 0; i < VALS / 4; ++i)
    w[i] = pack4(quantize<RCP>(f[4 * i], s, r),
                 quantize<RCP>(f[4 * i + 1], s, r),
                 quantize<RCP>(f[4 * i + 2], s, r),
                 quantize<RCP>(f[4 * i + 3], s, r));
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < VALS / 16; ++i)
      reinterpret_cast<uint4*>(p)[i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    if constexpr (VALS % 16 == 8)
      reinterpret_cast<uint2*>(p)[VALS / 8 - 1] =
          make_uint2(w[VALS / 4 - 2], w[VALS / 4 - 1]);
  } else {
#pragma unroll
    for (int i = 0; i < VALS; ++i)
      if (i < left) p[i] = static_cast<int8_t>(w[i / 4] >> (8 * (i % 4)));
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ float chunk_amax(const Chunk<T, VEC>& c) {
  float f[VALS];
  c.get(f);
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < VALS; ++i) a = fmaxf(a, fabsf(f[i]));
  return a;
}

// A row's group: WPR warps, one block when WPR > 1.
struct Group {
  int t, threads, wpr, K;       // thread in the group, its threads, warps
};

// The group's amax of the lanes' `a` (one barrier when the group is more
// than a warp; callers alternate `red` between rows), then the row's scale.
__device__ __forceinline__ float row_scale(float a, const Group& g,
                                           float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
  if (g.wpr > 1) {
    if (g.t % 32 == 0) red[g.t / 32] = a;
    __syncthreads();
    a = red[0];
    for (int w = 1; w < g.wpr; ++w) a = fmaxf(a, red[w]);
  }
  const float amax = a < FLT_MIN ? 0.f : a;     // every value subnormal
  return amax > 0.f ? fmaxf(__fdiv_rn(amax, 127.f), FLT_MIN) : 1.f;
}

// The chunks a lane holds of a window of the row that starts at chunk c0:
// chunks c0 + t + j * threads, j < CPL.
template <typename T, bool VEC>
struct Held {
  Chunk<T, VEC> c[CPL];

  __device__ __forceinline__ static int at(const Group& g, int c0, int j) {
    return (c0 + g.t + j * g.threads) * VALS;     // the chunk's first value
  }

  __device__ __forceinline__ void load(const T* xr, const Group& g, int c0) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int k = at(g, c0, j);
      if (k < g.K) c[j].load(xr + k, g.K - k);
    }
  }

  __device__ __forceinline__ float amax(const Group& g, int c0) const {
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      if (at(g, c0, j) < g.K) a = fmaxf(a, chunk_amax(c[j]));
    return a;
  }

  template <bool RCP>
  __device__ __forceinline__ void store_as(int8_t* qr, const Group& g, int c0,
                                           float s, float r) const {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int k = at(g, c0, j);
      if (k < g.K) put<RCP>(c[j], qr + k, g.K - k, s, r);
    }
  }

  // x / s through r = 1 / s where the correction is exact (s in [2^-100,
  // FLT_MAX]), a uniform branch a row
  __device__ __forceinline__ void store(int8_t* qr, const Group& g, int c0,
                                        float s, float r) const {
    if (s >= 0x1p-100f && s <= FLT_MAX)
      store_as<true>(qr, g, c0, s, r);
    else
      store_as<false>(qr, g, c0, s, r);
  }
};

// A held row: its amax, its scale, its bytes.
template <typename T, bool VEC>
__device__ __forceinline__ void finish_row(const Held<T, VEC>& h,
                                           int8_t* qr, float* scale,
                                           const Group& g, float* red) {
  const float s = row_scale(h.amax(g, 0), g, red);
  if (g.t == 0) *scale = s;
  h.store(qr, g, 0, s, __frcp_rn(s));
}

template <typename T, bool VEC, bool HELD>
__global__ void __launch_bounds__(MAX_THREADS)
quantize_rows_kernel(const T* __restrict__ x, long long ldx,
                     int8_t* __restrict__ x8, float* __restrict__ x_scale,
                     int M, int K, int wpr) {
  __shared__ float red[2][MAX_WPR];
  Group g;
  g.wpr = wpr;
  g.threads = wpr * 32;
  g.t = threadIdx.x % g.threads;
  g.K = K;
  // groups of several warps are whole blocks: their loops are the block's
  const int per_block = blockDim.x / g.threads;
  const int stride = gridDim.x * per_block;
  int m = blockIdx.x * per_block + threadIdx.x / g.threads;
  if constexpr (HELD) {
    // two rows in registers: the next row's loads are in flight while this
    // one is reduced, quantized and stored
    Held<T, VEC> a, b;
    if (m < M) a.load(x + m * ldx, g, 0);
    while (m < M) {
      if (m + stride < M) b.load(x + (m + stride) * ldx, g, 0);
      finish_row(a, x8 + (long long)m * K, x_scale + m, g, red[0]);
      m += stride;
      if (m >= M) break;
      if (m + stride < M) a.load(x + (m + stride) * ldx, g, 0);
      finish_row(b, x8 + (long long)m * K, x_scale + m, g, red[1]);
      m += stride;
    }
  } else {
    const int nc = (K + VALS - 1) / VALS, window = CPL * g.threads;
    for (int parity = 0; m < M; m += stride, parity ^= 1) {
      const T* xr = x + m * ldx;
      float a = 0.f;
      for (int c0 = 0; c0 < nc; c0 += window) {
        Held<T, VEC> h;
        h.load(xr, g, c0);
        a = fmaxf(a, h.amax(g, c0));
      }
      const float s = row_scale(a, g, red[parity]);
      if (g.t == 0) x_scale[m] = s;
      const float r = __frcp_rn(s);
      for (int c0 = 0; c0 < nc; c0 += window) {
        Held<T, VEC> h;
        h.load(xr, g, c0);
        h.store(x8 + (long long)m * K, g, c0, s, r);
      }
    }
  }
}

template <typename T, bool VEC, bool HELD>
cudaError_t launch(const T* x, long long ldx, int8_t* q, float* s, int M,
                   int K, int wpr, cudaStream_t st) {
  auto kernel = quantize_rows_kernel<T, VEC, HELD>;
  const int threads = wpr == 1 ? BLOCK : wpr * 32;
  const int per_block = threads / (wpr * 32);
  // one wave: as many rows a group as keep every group on the card at once
  // (the SMs times the blocks an SM holds of the kernel as compiled; asked
  // once an instantiation, block size and device, and cached)
  static int cached[64][4] = {};
  int sms = 0, dev = 0;
  cudaError_t err = windve_sm_count(&sms);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int slot = 0;
  while ((1 << slot) < wpr) ++slot;               // wpr: 1, 2, 4 or 8
  int per_sm = dev < 64 ? cached[dev][slot] : 0;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
    if (err != cudaSuccess) return err;
    if (dev < 64) cached[dev][slot] = per_sm;
  }
  const long long most = std::max(1LL, (long long)sms * per_sm * per_block);
  const long long rows = (M + most - 1) / most;
  const long long groups = (M + rows - 1) / rows;
  const long long blocks = (groups + per_block - 1) / per_block;
  kernel<<<static_cast<unsigned>(blocks), threads, 0, st>>>(x, ldx, q, s, M,
                                                            K, wpr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, long long ldx, int8_t* q, float* s,
                     int M, int K, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = K % VALS == 0 && ldx % V == 0
                   && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int nc = (K + VALS - 1) / VALS;
  // as few warps a row as hold it, CPL chunks a lane
  int wpr = 1;
  while (wpr < MAX_WPR && wpr * 32 * CPL < nc) wpr *= 2;
  const bool held = wpr * 32 * CPL >= nc;
  const T* xt = static_cast<const T*>(x);
  auto run = vec ? (held ? launch<T, true, true> : launch<T, true, false>)
                 : (held ? launch<T, false, true> : launch<T, false, false>);
  return run(xt, ldx, q, s, M, K, wpr, st);
}

}  // namespace qr

// ---------------------------------------------------------------------------
// windve_w8a8_matmul: out[m, n] = (float(sum_k x8[m, k] * w8[k, n])
//                                  * x_scale[m]) * w_scale[n]
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul/quant_matmul.py:182
// (w8a8_matmul_pallas / _w8a8_matmul_kernel).
//
// What bounds it on this card: bytes.  At the int8 tensor cores' 1,979
// TOP/s the 2*M*K*N operations of bge's w_in take less time than writing
// its fp32 output once; at w_out (K 4096) the operations do.
//
// Design: mma.sync.m16n8k32 s8 x s8 -> s32 on the int8 tensor cores.  The
// int32 sum is exact, as is the plain version's float64 one, and both round
// it to fp32 to nearest even, so with the epilogue's two fp32 multiplies in
// the reference's order the output is the plain version's bit for bit.
//   - Tiles: 128 columns a block and 128 or 64 rows (below), warps of
//     32 x 64 (8 or 4 a block), K steps of 64 through a 4-stage ring of raw
//     tiles filled with 16-byte cp.async copies.  Rows past M, columns past
//     N and K are zero-filled, so they add exactly 0.  x8 views whose row
//     stride or base is not 16-byte aligned, or K not a multiple of 16, and
//     w8 whose N is not a multiple of 16, take instantiations that copy
//     element by element.
//   - A fragments: ldmatrix of x8 rows padded to 80 bytes (conflict-free);
//     an int8 16 x 32 tile is a b16 16 x 16 one.
//   - B fragments: an 8-bit mma takes B K-contiguous (.col), but w8 is
//     (K, N) with N contiguous, and ldmatrix .trans moves only 16-bit
//     elements.  So the ring keeps w8 as it lies, with each 16 K rows
//     stored in the order 0 1 4 5 8 9 12 13 2 3 6 7 10 11 14 15 (free: the
//     copies pick their row).  One ldmatrix.x4.trans of 32 such rows then
//     gives a lane the bytes of K rows (4t, 4t + 1) and (4t + 2, 4t + 3) at
//     columns 2g and 2g + 1 of a 16-column chunk, and two byte permutes
//     make the K-contiguous words of both columns: B for two n8 tiles, one
//     of the chunk's even columns, one of its odd ones.  Rows padded to 144
//     bytes keep the ldmatrix conflict-free.
//   - Epilogue: with that column order a lane holds 4 neighbouring columns
//     of a row in each chunk, so the result is stored 16 bytes (fp32) or
//     8 bytes (bf16) at a time straight from the accumulators.
// Tile rows: 128 where that still gives two blocks to each of the card's
// SMs (asked of the device: 132 on an H100), else 64, so that bge's
// N = 1024 projections (96 blocks of 128 rows) fill the card in one wave.
// The other tile size at each of bge's shapes, fewer stages, longer K
// steps and warps of 64 x 64 were each timed against this design
// (benchmarks/torch_kernel_variants.py; numbers in PERF.md).  The wrapper
// refuses K > 133,000, past which K * 127^2 overflows int32.
// ---------------------------------------------------------------------------
namespace w8 {

constexpr int BN = 128, BK = 64, STAGES = 4;
constexpr int WM = 32, WN = 64;                 // a warp's tile
constexpr int MT = WM / 16, WARPS_N = BN / WN;
constexpr int XP = BK + 16;     // x8 bytes a row of the A tile: 80
constexpr int WP = BN + 16;     // w8 bytes a row of the B tile: 144

template <int BM>
struct Tile {
  static constexpr int WARPS_M = BM / WM;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int X_BYTES = BM * XP, W_BYTES = BK * WP;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr size_t SMEM = STAGES * STAGE;
  static constexpr int XN = BM * (BK / 16) / THREADS;  // x8 copies a thread
  static constexpr int WN16 = BK * (BN / 16) / THREADS;  // w8 copies
  static_assert(BM % WM == 0 && XN >= 1 && WN16 >= 1, "tile too small");
};

// c (16 x 8, s32) += a (16 x 32, s8, row) * b (32 x 8, s8, col)
__device__ __forceinline__ void mma(int (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B tile's row for K row p of a step: within each 16 rows, row 4t + i
// sits at 2t + i (i < 2) or 8 + 2t + i - 2.
__device__ __forceinline__ int b_row(int p) {
  const int t = (p & 15) >> 2, i = p & 3;
  return (p & ~15) + (i < 2 ? 2 * t + i : 6 + 2 * t + i);
}

// Copies K steps into a stage: BM rows of BK bytes of x8, BK rows of BN of
// w8.  Each thread owns the same chunks at every step, so their source rows
// and bounds are worked out once.  XV / WV: 16-byte cp.async copies, else
// element copies.
template <int BM, bool XV, bool WV>
struct Loader {
  using T = Tile<BM>;
  static constexpr int XROWS = T::THREADS / (BK / 16);  // rows between copies
  static constexpr int WROWS = T::THREADS / (BN / 16);
  const int8_t* xrow;    // the thread's first x8 row, at its column
  const int8_t* wrow;    // its first w8 row of step 0, at its column
  long long ldx;
  int xrows_ok, xc, wr, N, K, n_left, xs_off, ws_off;

  __device__ __forceinline__ Loader(const int8_t* x, long long ldx_,
                                    const int8_t* w, int M, int N_, int K_,
                                    int m0, int n0) {
    const int r = threadIdx.x / (BK / 16);
    xc = (threadIdx.x % (BK / 16)) * 16;
    ldx = ldx_;
    xrow = x + (long long)(m0 + r) * ldx + xc;
    xrows_ok = 0;
#pragma unroll
    for (int t = 0; t < T::XN; ++t) xrows_ok += m0 + r + t * XROWS < M;
    xs_off = r * XP + xc;
    wr = threadIdx.x / (BN / 16);
    const int wc = (threadIdx.x % (BN / 16)) * 16;
    N = N_;
    K = K_;
    n_left = N - (n0 + wc);
    wrow = w + (long long)wr * N + n0 + wc;
    ws_off = wc;
  }

  __device__ __forceinline__ void load(int8_t* at, int8_t* bt, int k0) const {
    const int kx = K - (k0 + xc);                  // x8 bytes left in a row
#pragma unroll
    for (int t = 0; t < T::XN; ++t) {
      int8_t* d = at + xs_off + t * XROWS * XP;
      const int8_t* src = xrow + t * XROWS * ldx + k0;
      const bool row_ok = t < xrows_ok;
      if (XV) {                                    // K % 16 == 0
        if (row_ok && kx > 0)
          qm::cp_async16(d, src);
        else
          *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) d[e] = row_ok && e < kx ? src[e] : 0;
      }
    }
#pragma unroll
    for (int t = 0; t < T::WN16; ++t) {
      const int p = wr + t * WROWS;                // K row within the step
      int8_t* d = bt + b_row(p) * WP + ws_off;
      const int8_t* src = wrow + (long long)(k0 + t * WROWS) * N;
      const bool k_ok = k0 + p < K;
      if (WV) {                                    // N % 16 == 0
        if (k_ok && n_left > 0)
          qm::cp_async16(d, src);
        else
          *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) d[e] = k_ok && e < n_left ? src[e] : 0;
      }
    }
  }
};

__device__ __forceinline__ void store4v(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4v(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                 *reinterpret_cast<const unsigned*>(&hi));
}

// The first `left` of 4 values: one 16- or 8-byte store where all 4 fit and
// the row allows it.
template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4], int left,
                                       bool vec) {
  if (vec && left >= 4) {
    store4v(p, v);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < left) store(p + e, v[e]);
  }
}

template <typename TO, int BM, bool XV, bool WV>
__global__ void __launch_bounds__(Tile<BM>::THREADS, 2)
w8a8_matmul_tc(const int8_t* __restrict__ x8, long long ldx,
               const int8_t* __restrict__ w,
               const float* __restrict__ x_scale,
               const float* __restrict__ w_scale, TO* __restrict__ out,
               int M, int N, int K) {
  using T = Tile<BM>;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);   // A | B tile a stage

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int steps = (K + BK - 1) / BK;
  const Loader<BM, XV, WV> loader(x8, ldx, w, M, N, K, m0, n0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      loader.load(ring + s * T::STAGE, ring + s * T::STAGE + T::X_BYTES,
                  s * BK);
    qm::cp_async_commit();
  }

  // acc[i][q][e]: m16 tile i, 16-column chunk q, its even (e 0) or odd
  // (e 1) columns
  int acc[MT][4][2][4] = {};

  for (int it = 0; it < steps; ++it) {
    // step it has landed; every thread is done with step it - 1's stage
    qm::cp_async_wait<STAGES - 2>();
    __syncthreads();
    {
      const int ld = it + STAGES - 1;       // into the stage step it - 1 used
      if (ld < steps) {
        int8_t* st = ring + (ld % STAGES) * T::STAGE;
        loader.load(st, st + T::X_BYTES, ld * BK);
      }
      qm::cp_async_commit();
    }
    const int8_t* at = ring + (it % STAGES) * T::STAGE;
    const int8_t* bt = at + T::X_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        qm::ldsm_x4(a[i], reinterpret_cast<const qm::bf16*>(
                              at + (wm0 + 16 * i + (lane & 15)) * XP + kk
                              + (lane >> 4) * 16));
      unsigned b[4][2][2];                  // [chunk][even/odd][k half]
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        unsigned r[4];
        qm::ldsm_x4_trans(r, reinterpret_cast<const qm::bf16*>(
                                 bt + (kk + lane) * WP + wn0 + 16 * q));
        b[q][0][0] = __byte_perm(r[0], r[1], 0x6420);
        b[q][1][0] = __byte_perm(r[0], r[1], 0x7531);
        b[q][0][1] = __byte_perm(r[2], r[3], 0x6420);
        b[q][1][1] = __byte_perm(r[2], r[3], 0x7531);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            mma(acc[i][q][e], a[i], b[q][e][0], b[q][e][1]);
    }
  }

  // Lane (g, t) holds, in chunk q, columns 4t .. 4t + 3 of rows g and g + 8
  // of each m16 tile: even tile's c0, odd's c0, even's c1, odd's c1 (rows
  // g), and the same of c2, c3 (rows g + 8).
  const int g = lane / 4, tq = lane % 4;
  const bool vec = N % 4 == 0;
  float wsc[4][4];
  int left[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int n = n0 + wn0 + 16 * q + 4 * tq;
    left[q] = N - n;
#pragma unroll
    for (int e = 0; e < 4; ++e) wsc[q][e] = e < left[q] ? w_scale[n + e] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + wm0 + 16 * i + g + 8 * hf;
      if (m >= M) continue;
      const float xs_m = x_scale[m];
      TO* orow = out + (long long)m * N + n0 + wn0 + 4 * tq;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (left[q] <= 0) continue;
        const int c[4] = {acc[i][q][0][2 * hf], acc[i][q][1][2 * hf],
                          acc[i][q][0][2 * hf + 1], acc[i][q][1][2 * hf + 1]};
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = __fmul_rn(__fmul_rn(static_cast<float>(c[e]), xs_m),
                           wsc[q][e]);
        store4<TO>(orow + 16 * q, v, left[q], vec);
      }
    }
}

template <typename TO, int BM, bool XV, bool WV>
cudaError_t launch(const int8_t* x8, long long ldx, const int8_t* w,
                   const float* xs, const float* ws, void* out, int M, int N,
                   int K, cudaStream_t st) {
  using T = Tile<BM>;
  auto kernel = w8a8_matmul_tc<TO, BM, XV, WV>;
  constexpr size_t smem = T::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > MAX_GRID_Y) return cudaErrorInvalidConfiguration;
  kernel<<<grid, T::THREADS, smem, st>>>(x8, ldx, w, xs, ws,
                                         static_cast<TO*>(out), M, N, K);
  return cudaGetLastError();
}

template <typename TO, int BM>
cudaError_t dispatch_copies(const int8_t* x8, long long ldx, const int8_t* w,
                            const float* xs, const float* ws, void* out,
                            int M, int N, int K, cudaStream_t st) {
  const bool xv = ldx % 16 == 0 && K % 16 == 0
                  && reinterpret_cast<uintptr_t>(x8) % 16 == 0;
  const bool wv = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  auto kernel = xv ? (wv ? launch<TO, BM, true, true>
                         : launch<TO, BM, true, false>)
                   : (wv ? launch<TO, BM, false, true>
                         : launch<TO, BM, false, false>);
  return kernel(x8, ldx, w, xs, ws, out, M, N, K, st);
}

template <typename TO>
cudaError_t dispatch(const int8_t* x8, long long ldx, const int8_t* w,
                     const float* xs, const float* ws, void* out, int M,
                     int N, int K, cudaStream_t st) {
  int sms = 0;
  const cudaError_t err = windve_sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long big = (long long)((M + 127) / 128) * ((N + BN - 1) / BN);
  auto run = big >= 2 * sms ? dispatch_copies<TO, 128>
                            : dispatch_copies<TO, 64>;
  return run(x8, ldx, w, xs, ws, out, M, N, K, st);
}

}  // namespace w8

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
  if ((M + qm::BM - 1) / qm::BM > MAX_GRID_Y)
    return cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(w8);
  const float* s = static_cast<const float*>(scale);
  if (dtype == 0)
    return qm::dispatch<float>(x, ldx, w, s, out, M, N, K, st);
  if (dtype == 1)
    return qm::dispatch<__nv_bfloat16>(x, ldx, w, s, out, M, N, K, st);
  return cudaErrorInvalidValue;
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
  if (dtype == 0) return qr::dispatch<float>(x, ldx, q, s, M, K, st);
  if (dtype == 1) return qr::dispatch<__nv_bfloat16>(x, ldx, q, s, M, K, st);
  return cudaErrorInvalidValue;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xq = static_cast<const int8_t*>(x8);
  const int8_t* w = static_cast<const int8_t*>(w8);
  const float* xs = static_cast<const float*>(x_scale);
  const float* ws = static_cast<const float*>(w_scale);
  if (out_dtype == 0)
    return w8::dispatch<float>(xq, ldx, w, xs, ws, out, M, N, K, st);
  if (out_dtype == 1)
    return w8::dispatch<__nv_bfloat16>(xq, ldx, w, xs, ws, out, M, N, K, st);
  return cudaErrorInvalidValue;
}
