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
// product there is: no fragment layouts, a 64 x 64 block tile and a
// 4 x 4 register tile per thread.  The int8
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
