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
//   dS = P * (dP - D),  dP = dO V^T
//   dV = P^T dO,  dK = scale * dS^T Q,  dQ = scale * dS K
//
// A row with no valid key gets zero gradients.  Sums are fp32 and the
// gradients are cast to the input's type once at the end.
//
// Two launches, in this order, no float atomics (the result does not depend
// on the schedule):
//   - attn_bwd_delta: D into an fp32 workspace, a row's 16-byte chunks over
//     2 to 32 lanes;
//   - attn_bwd, whose blocks take one of two roles.  dkdv: a block owns 64
//     keys (4 warps x 16) of one (batch row, KV head), stages their K and V
//     once and walks the query tiles of its G query heads in a fixed order,
//     with Q, dO, lse and D double-buffered behind the compute; it holds dK
//     and dV in fp32 registers until the end.  dq: a block owns 64 queries
//     (4 warps x 16) of one (batch row, head) and walks the key tiles its
//     queries can see, K and V double-buffered.  The role whose blocks walk
//     the most tiles goes first (dkdv under GQA, dq for whisper's 64 queries
//     over 1500 keys), and the other role's blocks fill the SMs its uneven
//     tail leaves idle (under a causal mask with G query heads a KV head,
//     the first key tiles walk G times the queries the last ones do).
// Both roles recompute the scores; that buys the determinism a shared dQ
// written with atomics would lose.
//
// What bounds it on this card.  At stablelm-1.6b's training shape (B 8, 32
// heads of 64, S 512, causal) the five products of the valid (query, key)
// pairs are 21.5 GFLOP over 40 MB of bf16 inputs and outputs: 0.040 ms of
// bytes, 0.022 ms of bf16 tensor-core work.  With the recompute (S and dP in
// both roles) and the diagonal's partly masked 16 x 16 tiles the kernels
// execute 31.0 GFLOP, so the multiply rate sets the time, and every product
// runs on the tensor cores: mma.sync.m16n8k16, bf16 in, fp32 accumulators
// in registers, the forward's layout.
//   - dkdv: each warp computes S^T = K Q^T and dP^T = V dO^T for its 16 keys
//     and 16 queries at a time (two 8-query tiles), K's and V's A fragments
//     held in registers (read from shared memory each use at hd 128, where
//     dK and dV take 128 registers), Q's and dO's B fragments by ldmatrix.
//     P^T = 2^(S^T * scale * log2 e - lse * log2 e) with the SFU's ex2, and
//     dS^T = P^T (dP^T - D).  Then dV += P^T dO and dK += dS^T Q, with P^T
//     and dS^T taken from the score fragments' accumulator layout as the A
//     operand (the forward's trick for P V), dO and Q by ldmatrix.trans.
//     Taking 16 queries at a time keeps the score fragments to 16 registers.
//   - dq: S = Q K^T and dP = dO V^T, 16 keys at a time, Q's and dO's A
//     fragments held in registers; dQ += dS K with dS from registers and K
//     by ldmatrix.trans.
//   - Masks are applied to the score fragments only on tiles that cross
//     kv_len, the diagonal or the window's edge; a warp skips a 16 x 16 tile
//     none of whose pairs is valid, and a block walks only the tiles some of
//     its rows can see.  Keys past kv_len and queries past Sq are zero in
//     shared memory, so their products vanish.
//   - Blocks of each role are handed out longest first under a causal mask:
//     dkdv's first key tiles see the most queries, dq's last query tiles the
//     most keys.
//   - Staged rows are padded by 16 bytes so ldmatrix reads hit distinct
//     banks; tiles above 48 KB of shared memory take it as dynamic shared
//     memory.  Views that are not 16-byte aligned take an instantiation
//     (VEC false) that copies element by element.
//
// bf16 (dtype 1): tiles are staged as they lie with 16-byte cp.async copies
// (lse and D with 4-byte ones), two stages.  P^T and dS^T (dS in dq) are
// rounded to bf16 before their products; dS is formed from the fp32 P.
//
// fp32 (dtype 0), through the forward's exact bf16 split: every fp32
// operand x is h + m + l, three bf16 values (csrc/mma.cuh split3), and each
// of the five products takes six bf16 products a k-step (l*h, h*l, m*m,
// m*h, h*m, h*h) into a fresh fragment that is added to the running sum
// with fp32 adds (the tensor cores' accumulation truncates).  Tiles are
// split in registers as they are staged (one stage); P^T and dS^T are split
// in registers from the score fragments.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

using namespace ptx;

struct Strides {
  long long b, h, s;
};

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BR = 16 * WARPS;     // rows a block owns, 16 a warp
constexpr int PAD = 8;             // bf16 a row: rows on distinct banks
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int HD>
struct Cfg {
  static constexpr bool SPLIT = std::is_same<T, float>::value;
  static constexpr int TERMS = SPLIT ? 3 : 1;      // bf16 planes a tile
  static constexpr int FIRST = SPLIT ? 0 : 5;      // first product, term_a/b
  static constexpr int STAGES = SPLIT ? 1 : 2;     // of the walked tiles
  // rows of a walked tile (queries or keys): 64, but 32 for fp32 at hd 128,
  // where that measured faster (benchmarks/torch_kernel_variants.py)
  static constexpr int BT = SPLIT && HD == 128 ? 32 : 64;
  static constexpr int PITCH = HD + PAD;
  static constexpr int OWN = BR * PITCH;           // a plane of an owned tile
  static constexpr int WALK = BT * PITCH;          // a plane of a walked tile
  static constexpr int KSTEPS = HD / 16;
  static constexpr int DT = HD / 8;                // 8-wide head-dim tiles
  // the owned rows' A fragments held in registers (bf16)
  static constexpr bool HOLD_DKDV = !SPLIT && HD <= 64;
  static constexpr bool HOLD_DQ = !SPLIT;
  // launch bounds: blocks an SM (bf16 at hd <= 64: 170 registers a thread)
  static constexpr int BLOCKS = SPLIT ? (HD <= 64 ? 2 : 1)
                                      : (HD <= 64 ? 3 : 2);
};

// two owned tiles, two walked ones in STAGES stages, and the walked query
// rows' lse and D
template <typename T, int HD>
constexpr size_t smem_bytes() {
  using C = Cfg<T, HD>;
  return (2 * C::TERMS * C::OWN + 2 * C::STAGES * C::TERMS * C::WALK)
             * sizeof(bf16)
         + 2 * C::STAGES * C::BT * sizeof(float);
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}

// Rows [0, ROWS) of a tile as TERMS bf16 planes of ROWS x PITCH: row r is HD
// values at src + r * stride for r < rows, zeros after.  bf16: as they lie,
// by 16-byte cp.async when VEC, element copies otherwise.  fp32: each value
// split into its three terms in registers, the loads issued in batches
// before the splits.
template <typename T, int HD, int ROWS, bool VEC>
__device__ __forceinline__ void stage(bf16* dst, const T* src,
                                      long long stride, int rows) {
  constexpr int PITCH = HD + PAD;
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int CHUNKS = HD / 8;                  // 16 bytes each
    for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      bf16* d = dst + r * PITCH + c;
      if (r >= rows) {
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      } else if (VEC) {
        cp_async16(d, src + r * stride + c);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] = src[r * stride + c + e];
      }
    }
  } else {
    constexpr int PLANE = ROWS * PITCH, CHUNKS = HD / 4;   // 4 floats each
    constexpr int PER = ROWS * CHUNKS / THREADS;           // chunks a thread
    constexpr int BATCH = PER < 8 ? PER : 8;
    static_assert(ROWS * CHUNKS % THREADS == 0, "whole chunks a thread");
#pragma unroll
    for (int u0 = 0; u0 < PER; u0 += BATCH) {
      float4 x[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = threadIdx.x + (u0 + u) * THREADS;
        const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
        x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < rows) {
          const float* p = src + r * stride + c;
          x[u] = VEC ? __ldg(reinterpret_cast<const float4*>(p))
                     : make_float4(p[0], p[1], p[2], p[3]);
        }
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = threadIdx.x + (u0 + u) * THREADS;
        const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
        float tm[4][3];
        split3(x[u].x, tm[0]);
        split3(x[u].y, tm[1]);
        split3(x[u].z, tm[2]);
        split3(x[u].w, tm[3]);
        bf16* d = dst + r * PITCH + c;
#pragma unroll
        for (int p = 0; p < 3; ++p)
          *reinterpret_cast<uint2*>(d + p * PLANE) =
              make_uint2(pack_exact(tm[0][p], tm[1][p]),
                         pack_exact(tm[2][p], tm[3][p]));
      }
    }
  }
}

// The A fragment of rows r0..r0+15, k-step kk, of a plane
template <int PITCH>
__device__ __forceinline__ void frag_a(unsigned (&a)[4], const bf16* plane,
                                       int r0, int kk) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, plane + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * PITCH
                 + 16 * kk + (lane >> 4) * 8);
}

// The B fragments of two 8-column tiles whose columns are rows n0..n0+15 of
// a plane, k-step kk (b[0], b[1] the first tile's, b[2], b[3] the second's)
template <int PITCH>
__device__ __forceinline__ void frag_b(unsigned (&b)[4], const bf16* plane,
                                       int n0, int kk) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(b, plane + (n0 + (lane & 7) + (lane >> 4) * 8) * PITCH + 16 * kk
                 + ((lane >> 3) & 1) * 8);
}

// The B fragments of head-dim tiles d and d + 1 over the k rows k0..k0+15
// of a plane (rows of the plane are the k dimension)
template <int PITCH>
__device__ __forceinline__ void frag_bt(unsigned (&b)[4], const bf16* plane,
                                        int k0, int d) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(b, plane + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * PITCH
                       + 8 * d + (lane >> 4) * 8);
}

// s (16 x 16, two 8-column tiles) = A B^T over the head dim: A the warp's 16
// owned rows (held fragments, or rows r0.. of the owned tile's planes), B
// rows n0..n0+15 of a walked tile's planes.
template <typename T, int HD, bool HOLD>
__device__ __forceinline__ void score16(float (&s)[2][4],
                                        const unsigned (&held)[HD / 16][4],
                                        const bf16* own, int r0,
                                        const bf16* walk, int n0) {
  using C = Cfg<T, HD>;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C::KSTEPS; ++kk) {
    unsigned a[C::TERMS][4], b[C::TERMS][4];
#pragma unroll
    for (int p = 0; p < C::TERMS; ++p) {
      if constexpr (HOLD) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[p][e] = held[kk][e];
      } else {
        frag_a<C::PITCH>(a[p], own + p * C::OWN, r0, kk);
      }
      frag_b<C::PITCH>(b[p], walk + p * C::WALK, n0, kk);
    }
    if constexpr (C::SPLIT) {       // a fresh fragment a k-step
      float f[2][4] = {};
#pragma unroll
      for (int i = C::FIRST; i < 6; ++i) {
        mma(f[0], a[term_a(i)], b[term_b(i)][0], b[term_b(i)][1]);
        mma(f[1], a[term_a(i)], b[term_b(i)][2], b[term_b(i)][3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[0][e] += f[0][e];
        s[1][e] += f[1][e];
      }
    } else {
      mma(s[0], a[0], b[0][0], b[0][1]);
      mma(s[1], a[0], b[0][2], b[0][3]);
    }
  }
}

// acc (16 x HD) += x (16 x 16, a score16 fragment, as the A operand) times
// rows k0..k0+15 of a walked tile's planes (16 x HD).  bf16: x rounded to
// bf16.  fp32: x split in registers, six products a fresh fragment.
template <typename T, int HD>
__device__ __forceinline__ void accumulate(float (&acc)[HD / 8][4],
                                           const float (&x)[2][4],
                                           const bf16* walk, int k0) {
  using C = Cfg<T, HD>;
  unsigned xf[C::TERMS][4];
  if constexpr (C::SPLIT) {
    const float xv[8] = {x[0][0], x[0][1], x[0][2], x[0][3],
                         x[1][0], x[1][1], x[1][2], x[1][3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float lo[3], hi[3];
      split3(xv[2 * e], lo);
      split3(xv[2 * e + 1], hi);
#pragma unroll
      for (int p = 0; p < 3; ++p) xf[p][e] = pack_exact(lo[p], hi[p]);
    }
  } else {
    xf[0][0] = pack(x[0][0], x[0][1]);
    xf[0][1] = pack(x[0][2], x[0][3]);
    xf[0][2] = pack(x[1][0], x[1][1]);
    xf[0][3] = pack(x[1][2], x[1][3]);
  }
#pragma unroll
  for (int d = 0; d < C::DT; d += 2) {
    unsigned b[C::TERMS][4];
#pragma unroll
    for (int p = 0; p < C::TERMS; ++p)
      frag_bt<C::PITCH>(b[p], walk + p * C::WALK, k0, d);
    if constexpr (C::SPLIT) {
      float f[2][4] = {};
#pragma unroll
      for (int i = C::FIRST; i < 6; ++i) {
        mma(f[0], xf[term_a(i)], b[term_b(i)][0], b[term_b(i)][1]);
        mma(f[1], xf[term_a(i)], b[term_b(i)][2], b[term_b(i)][3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[d][e] += f[0][e];
        acc[d + 1][e] += f[1][e];
      }
    } else {
      mma(acc[d], xf[0], b[0][0], b[0][1]);
      mma(acc[d + 1], xf[0], b[0][2], b[0][3]);
    }
  }
}

// rows g and g + 8 of a warp's 16 x HD accumulator, times mul, at row base
// + r * stride (rows at or past `rows` skipped)
template <typename T, int HD, bool VEC>
__device__ __forceinline__ void store_rows(T* base, long long stride, int r0,
                                           int rows,
                                           const float (&acc)[HD / 8][4],
                                           float mul) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row >= rows) continue;
      const float x0 = acc[d][2 * r] * mul, x1 = acc[d][2 * r + 1] * mul;
      T* p = base + row * stride + 8 * d + 2 * t;
      if constexpr (std::is_same<T, float>::value) {
        if (VEC) {
          *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
        } else {
          p[0] = x0;
          p[1] = x1;
        }
      } else {
        const __nv_bfloat162 val = __floats2bfloat162_rn(x0, x1);
        if (VEC) {
          *reinterpret_cast<__nv_bfloat162*>(p) = val;
        } else {
          p[0] = val.x;
          p[1] = val.y;
        }
      }
    }
  }
}

// D = rowsum(dO * O) a (b, h, query) row, at delta[(b * H + h) * Sq + i]:
// a row's 16-byte chunks over CPR lanes (HD * sizeof(T) / 16: 2 to 32),
// 32 / CPR rows a warp, summed by shuffles.  VEC: o and dO are 16-byte
// aligned, one load a chunk; else element loads.
template <typename T, int HD, bool VEC>
__global__ void __launch_bounds__(256)
attn_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
               float* __restrict__ delta, int B, int H, int Sq, Strides os,
               Strides ds) {
  constexpr int V = 16 / sizeof(T);        // values a chunk
  constexpr int CPR = HD / V;              // lanes a row
  constexpr int RPW = 32 / CPR;            // rows a warp
  const int lane = threadIdx.x % 32;
  const long long row = ((long long)blockIdx.x * 8 + threadIdx.x / 32) * RPW
                        + lane / CPR;
  const int c = (lane % CPR) * V;
  float s = 0.f;
  if (row < (long long)B * H * Sq) {
    const int i = row % Sq;
    const int h = (row / Sq) % H;
    const int b = row / ((long long)Sq * H);
    const T* op = o + b * os.b + h * os.h + i * os.s + c;
    const T* dp = dout + b * ds.b + h * ds.h + i * ds.s + c;
    if constexpr (VEC) {
      const uint4 a = *reinterpret_cast<const uint4*>(op);
      const uint4 d = *reinterpret_cast<const uint4*>(dp);
      const unsigned aw[4] = {a.x, a.y, a.z, a.w}, dw[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if constexpr (std::is_same<T, float>::value) {
          s = fmaf(__uint_as_float(aw[w]), __uint_as_float(dw[w]), s);
        } else {                  // a bf16 is the top half of an fp32
          s = fmaf(__uint_as_float(aw[w] << 16), __uint_as_float(dw[w] << 16),
                   s);
          s = fmaf(__uint_as_float(aw[w] & 0xffff0000u),
                   __uint_as_float(dw[w] & 0xffff0000u), s);
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) s = fmaf(ld(op + e), ld(dp + e), s);
    }
  }
#pragma unroll
  for (int off = CPR / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < (long long)B * H * Sq && lane % CPR == 0) delta[row] = s;
}

// What a launch of attn_bwd needs: blocks [0, first) take the first role
// (dQ if dq_first, else dK/dV) and the rest the other.
struct Params {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* kv_len;
  void *dq, *dk, *dv;
  int B, H, G, Sq, Sk;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  float scale_log2, scale;
  int causal, window, first, dq_first;
};

// dK and dV of block `blk`'s 64 keys
template <typename T, int HD, bool VEC>
__device__ __forceinline__ void dkdv_block(const Params& pr, int blk,
                                           unsigned char* smem) {
  using C = Cfg<T, HD>;
  constexpr bool HOLD = C::HOLD_DKDV;
  const T* __restrict__ q = static_cast<const T*>(pr.q);
  const T* __restrict__ k = static_cast<const T*>(pr.k);
  const T* __restrict__ v = static_cast<const T*>(pr.v);
  const T* __restrict__ dout = static_cast<const T*>(pr.dout);
  const float* __restrict__ lse = pr.lse;
  const float* __restrict__ delta = pr.delta;
  const int B = pr.B, H = pr.H, G = pr.G, Sq = pr.Sq, Sk = pr.Sk;
  const Strides qs = pr.qs, ks = pr.ks, vs = pr.vs, dos = pr.dos;
  const float scale_log2 = pr.scale_log2;
  const int causal = pr.causal, window = pr.window;
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + C::TERMS * C::OWN;
  bf16* q_s = v_s + C::TERMS * C::OWN;            // STAGES x TERMS planes
  bf16* do_s = q_s + C::STAGES * C::TERMS * C::WALK;
  float* l_s = reinterpret_cast<float*>(do_s + C::STAGES * C::TERMS * C::WALK);
  float* d_s = l_s + C::STAGES * C::BT;

  // key tiles slowest, first first: under a causal mask the first key
  // tiles see the most queries
  const int KV = H / G;
  const int kh = blk % KV, b = (blk / KV) % B;
  const int k0 = (blk / (KV * B)) * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kw = k0 + 16 * warp;                  // the warp's first key
  const int kend = min(max(pr.kv_len[b], 0), Sk);

  // the queries that can see a key of the tile: q >= k0 under the causal
  // mask, q < last key + window under the window
  const int qlo = causal ? min(k0, Sq) : 0;
  const int qhi = window ? min(Sq, k0 + BR - 1 + window) : Sq;
  const int nq = (k0 < kend && qhi > qlo) ? (qhi - qlo + C::BT - 1) / C::BT : 0;
  const int steps = G * nq;                       // (query head, tile) pairs

  const T* kb = k + b * ks.b + (long long)kh * ks.h;
  const T* vb = v + b * vs.b + (long long)kh * vs.h;
  // step it: query head kh * G + it / nq, tile qlo + (it % nq) * C::BT
  auto stage_step = [&](int it, int st) {
    const int h = kh * G + it / nq, q0 = qlo + (it % nq) * C::BT;
    const int rows = min(C::BT, Sq - q0);
    stage<T, HD, C::BT, VEC>(q_s + st * C::TERMS * C::WALK,
                          q + b * qs.b + h * qs.h + q0 * qs.s, qs.s, rows);
    stage<T, HD, C::BT, VEC>(do_s + st * C::TERMS * C::WALK,
                          dout + b * dos.b + h * dos.h + q0 * dos.s, dos.s,
                          rows);
    if (threadIdx.x < C::BT) {
      const long long r = ((long long)b * H + h) * Sq + q0 + threadIdx.x;
      float* lp = l_s + st * C::BT + threadIdx.x;
      float* dp = d_s + st * C::BT + threadIdx.x;
      if (threadIdx.x >= rows) {
        *lp = 0.f;
        *dp = 0.f;
      } else if constexpr (C::SPLIT) {
        *lp = lse[r];
        *dp = delta[r];
      } else {
        cp_async4(lp, lse + r);
        cp_async4(dp, delta + r);
      }
    }
  };

  float dka[C::DT][4], dva[C::DT][4];
#pragma unroll
  for (int d = 0; d < C::DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;
  unsigned kf[C::KSTEPS][4], vf[C::KSTEPS][4];    // HOLD: the warp's K, V

  if (steps > 0) {
    stage<T, HD, BR, VEC>(k_s, kb + k0 * ks.s, ks.s, min(BR, kend - k0));
    stage<T, HD, BR, VEC>(v_s, vb + k0 * vs.s, vs.s, min(BR, kend - k0));
    stage_step(0, 0);
  }
  if constexpr (!C::SPLIT) cp_async_commit();

  for (int it = 0; it < steps; ++it) {
    const int st = it % C::STAGES;
    if constexpr (C::SPLIT) {
      if (it > 0) stage_step(it, 0);   // freed at the last barrier
      __syncthreads();
    } else {
      if (it + 1 < steps) {            // its stage was freed at it - 1
        stage_step(it + 1, (it + 1) % C::STAGES);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (HOLD && it == 0) {
#pragma unroll
        for (int kk = 0; kk < C::KSTEPS; ++kk) {
          frag_a<C::PITCH>(kf[kk], k_s, 16 * warp, kk);
          frag_a<C::PITCH>(vf[kk], v_s, 16 * warp, kk);
        }
      }
    }
    const int q0 = qlo + (it % nq) * C::BT;
    const bf16* qt = q_s + st * C::TERMS * C::WALK;
    const bf16* dot = do_s + st * C::TERMS * C::WALK;
    const float* lt = l_s + st * C::BT;
    const float* dlt = d_s + st * C::BT;
    if (kw < kend) {
#pragma unroll 1
      for (int c = 0; c < C::BT / 16; ++c) {
        const int c0 = q0 + 16 * c;       // the 16 queries' first
        if (c0 >= Sq || (causal && c0 + 15 < kw)
            || (window && c0 >= kw + 15 + window))
          continue;
        float s[2][4], dp[2][4];
        score16<T, HD, HOLD>(s, kf, k_s, 16 * warp, qt, 16 * c);
        score16<T, HD, HOLD>(dp, vf, v_s, 16 * warp, dot, 16 * c);
        // a tile that crosses kv_len, the diagonal or the window's edge
        const bool edge = kw + 16 > kend || (causal && c0 < kw + 15)
                          || (window && c0 + 15 >= kw + window);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 16 * c + 8 * j + 2 * t + (e & 1);
            float p = ex2(fmaf(s[j][e], scale_log2, -lt[col] * LOG2E));
            if (edge) {
              const int key = kw + g + 8 * (e >> 1), qi = q0 + col;
              const bool ok = key < kend && (!causal || key <= qi)
                              && (!window || key > qi - window);
              p = ok ? p : 0.f;
            }
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - dlt[col]);
          }
        }
        accumulate<T, HD>(dva, s, dot, 16 * c);
        accumulate<T, HD>(dka, dp, qt, 16 * c);
      }
    }
    __syncthreads();                    // this stage is consumed
  }

  store_rows<T, HD, VEC>(static_cast<T*>(pr.dk) + b * pr.dks.b
                             + (long long)kh * pr.dks.h,
                         pr.dks.s, kw, Sk, dka, pr.scale);
  store_rows<T, HD, VEC>(static_cast<T*>(pr.dv) + b * pr.dvs.b
                             + (long long)kh * pr.dvs.h,
                         pr.dvs.s, kw, Sk, dva, 1.f);
}

// dQ of block `blk`'s 64 queries
template <typename T, int HD, bool VEC>
__device__ __forceinline__ void dq_block(const Params& pr, int blk,
                                         unsigned char* smem) {
  using C = Cfg<T, HD>;
  constexpr bool HOLD = C::HOLD_DQ;
  const T* __restrict__ q = static_cast<const T*>(pr.q);
  const T* __restrict__ k = static_cast<const T*>(pr.k);
  const T* __restrict__ v = static_cast<const T*>(pr.v);
  const T* __restrict__ dout = static_cast<const T*>(pr.dout);
  const float* __restrict__ lse = pr.lse;
  const float* __restrict__ delta = pr.delta;
  const int B = pr.B, H = pr.H, G = pr.G, Sq = pr.Sq, Sk = pr.Sk;
  const Strides qs = pr.qs, ks = pr.ks, vs = pr.vs, dos = pr.dos;
  const float scale_log2 = pr.scale_log2;
  const int causal = pr.causal, window = pr.window;
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + C::TERMS * C::OWN;
  bf16* k_s = do_s + C::TERMS * C::OWN;           // STAGES x TERMS planes
  bf16* v_s = k_s + C::STAGES * C::TERMS * C::WALK;

  // query tiles slowest and last first: under a causal mask the last
  // tiles see the most keys
  const int tiles = (Sq + BR - 1) / BR;
  const int h = blk % H, b = (blk / H) % B;
  const int q0 = (tiles - 1 - blk / (H * B)) * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int w0 = q0 + 16 * warp;                  // the warp's first query
  const int qa = w0 + g, qb = qa + 8;             // the thread's two rows
  const int kend = min(max(pr.kv_len[b], 0), Sk);

  int lo = 0, hi = kend;
  if (causal) hi = min(hi, q0 + BR);              // keys <= its last query
  if (window) lo = max(0, q0 - window + 1);       // keys > first query - window
  const int nk = hi > lo ? (hi - lo + C::BT - 1) / C::BT : 0;

  // rows qa and qb: -lse * log2 e and D (0 past Sq, whose products vanish)
  const long long base = ((long long)b * H + h) * Sq;
  const float nla = qa < Sq ? -lse[base + qa] * LOG2E : 0.f;
  const float nlb = qb < Sq ? -lse[base + qb] * LOG2E : 0.f;
  const float da = qa < Sq ? delta[base + qa] : 0.f;
  const float db = qb < Sq ? delta[base + qb] : 0.f;

  const T* kb = k + b * ks.b + (long long)(h / G) * ks.h;
  const T* vb = v + b * vs.b + (long long)(h / G) * vs.h;
  auto stage_step = [&](int it, int st) {
    const int t0 = lo + it * C::BT;
    stage<T, HD, C::BT, VEC>(k_s + st * C::TERMS * C::WALK, kb + t0 * ks.s,
                          ks.s, min(C::BT, kend - t0));
    stage<T, HD, C::BT, VEC>(v_s + st * C::TERMS * C::WALK, vb + t0 * vs.s,
                          vs.s, min(C::BT, kend - t0));
  };

  float dqa[C::DT][4];
#pragma unroll
  for (int d = 0; d < C::DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[d][e] = 0.f;
  unsigned qf[C::KSTEPS][4], dof[C::KSTEPS][4];   // HOLD: the warp's Q, dO

  if (nk > 0) {
    const int rows = min(BR, Sq - q0);
    stage<T, HD, BR, VEC>(q_s, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s,
                          rows);
    stage<T, HD, BR, VEC>(do_s, dout + b * dos.b + h * dos.h + q0 * dos.s,
                          dos.s, rows);
    stage_step(0, 0);
  }
  if constexpr (!C::SPLIT) cp_async_commit();

  for (int it = 0; it < nk; ++it) {
    const int st = it % C::STAGES;
    if constexpr (C::SPLIT) {
      if (it > 0) stage_step(it, 0);   // freed at the last barrier
      __syncthreads();
    } else {
      if (it + 1 < nk) {               // its stage was freed at it - 1
        stage_step(it + 1, (it + 1) % C::STAGES);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (HOLD && it == 0) {
#pragma unroll
        for (int kk = 0; kk < C::KSTEPS; ++kk) {
          frag_a<C::PITCH>(qf[kk], q_s, 16 * warp, kk);
          frag_a<C::PITCH>(dof[kk], do_s, 16 * warp, kk);
        }
      }
    }
    const int t0 = lo + it * C::BT;
    const bf16* kt = k_s + st * C::TERMS * C::WALK;
    const bf16* vt = v_s + st * C::TERMS * C::WALK;
    if (w0 < Sq) {
#pragma unroll 1
      for (int c = 0; c < C::BT / 16; ++c) {
        const int j0 = t0 + 16 * c;       // the 16 keys' first
        if (j0 >= kend || (causal && j0 > w0 + 15)
            || (window && j0 + 15 <= w0 - window))
          continue;
        float s[2][4], dp[2][4];
        score16<T, HD, HOLD>(s, qf, q_s, 16 * warp, kt, 16 * c);
        score16<T, HD, HOLD>(dp, dof, do_s, 16 * warp, vt, 16 * c);
        const bool edge = j0 + 16 > kend || (causal && j0 + 15 > w0)
                          || (window && j0 <= w0 + 15 - window);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool rb = e >> 1;
            float p = ex2(fmaf(s[j][e], scale_log2, rb ? nlb : nla));
            if (edge) {
              const int key = j0 + 8 * j + 2 * t + (e & 1);
              const int qi = rb ? qb : qa;
              const bool ok = key < kend && (!causal || key <= qi)
                              && (!window || key > qi - window);
              p = ok ? p : 0.f;
            }
            dp[j][e] = p * (dp[j][e] - (rb ? db : da));
          }
        }
        accumulate<T, HD>(dqa, dp, kt, 16 * c);
      }
    }
    __syncthreads();                    // this stage is consumed
  }

  store_rows<T, HD, VEC>(static_cast<T*>(pr.dq) + b * pr.dqs.b
                             + (long long)h * pr.dqs.h,
                         pr.dqs.s, w0, Sq, dqa, pr.scale);
}

// Both roles in one launch: the role whose blocks walk the most tiles
// first (the longest block first within it), then the other, whose blocks
// fill the SMs the first role's uneven tail leaves idle.
template <typename T, int HD, bool VEC>
__global__ void __launch_bounds__(THREADS, Cfg<T, HD>::BLOCKS)
attn_bwd(const Params pr) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int blk = blockIdx.x;
  const bool in_first = blk < pr.first;
  const int i = in_first ? blk : blk - pr.first;
  if (in_first != static_cast<bool>(pr.dq_first))
    dkdv_block<T, HD, VEC>(pr, i, smem);
  else
    dq_block<T, HD, VEC>(pr, i, smem);
}

struct Args {
  const void *q, *k, *v, *o, *dout, *lse, *kv_len;
  void *dq, *dk, *dv, *delta;
  int B, H, KV, Sq, Sk;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int causal, window;
  cudaStream_t st;
};

// 16-byte copies and paired stores need every row of the views 16-byte
// aligned: the base pointers and all three strides (multiples of `per16`
// elements, the elements in 16 bytes).
bool aligned16(const void* const* ptrs, const Strides* strides, int n,
               int per16) {
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
    if (strides[i].b % per16 || strides[i].h % per16 || strides[i].s % per16)
      return false;
  }
  return true;
}

template <typename T, int HD, bool VEC>
cudaError_t launch_bwd(const Args& a, long long kblocks, long long qblocks) {
  using C = Cfg<T, HD>;
  // the tiles the longest block of each role walks, weighted by its
  // products a tile (dK/dV four, dQ three): G query heads' query tiles,
  // or the key tiles, as far as the window reaches
  const int G = a.H / a.KV;
  const int qspan = a.window ? min(a.Sq, BR - 1 + a.window) : a.Sq;
  const int kspan = a.window ? min(a.Sk, BR - 1 + a.window) : a.Sk;
  const long long dkdv_walk = 4LL * G * ((qspan + C::BT - 1) / C::BT);
  const long long dq_walk = 3LL * ((kspan + C::BT - 1) / C::BT);
  const int dq_first = dq_walk > dkdv_walk;
  Params pr{a.q, a.k, a.v, a.dout,
            static_cast<const float*>(a.lse),
            static_cast<const float*>(a.delta),
            static_cast<const int*>(a.kv_len), a.dq, a.dk, a.dv,
            a.B, a.H, G, a.Sq, a.Sk,
            a.qs, a.ks, a.vs, a.dos, a.dqs, a.dks, a.dvs,
            LOG2E / sqrtf(static_cast<float>(HD)),
            1.f / sqrtf(static_cast<float>(HD)), a.causal, a.window,
            static_cast<int>(dq_first ? qblocks : kblocks), dq_first};
  constexpr size_t smem = smem_bytes<T, HD>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_bwd<T, HD, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  attn_bwd<T, HD, VEC><<<static_cast<unsigned>(kblocks + qblocks), THREADS,
                         smem, a.st>>>(pr);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const Args& a) {
  constexpr int per16 = 16 / sizeof(T);
  const void* dptrs[2] = {a.o, a.dout};
  const Strides dstr[2] = {a.os, a.dos};
  const void* ptrs[7] = {a.q, a.k, a.v, a.dout, a.dq, a.dk, a.dv};
  const Strides strides[7] = {a.qs, a.ks, a.vs, a.dos, a.dqs, a.dks, a.dvs};
  const long long rows = (long long)a.B * a.H * a.Sq;
  const long long dblocks = (rows * HD / per16 + 255) / 256;  // a lane a chunk
  const long long kblocks = (long long)((a.Sk + BR - 1) / BR) * a.KV * a.B;
  const long long qblocks = (long long)((a.Sq + BR - 1) / BR) * a.H * a.B;
  if (dblocks > 0x7fffffffLL || kblocks + qblocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);
  float* delta = static_cast<float*>(a.delta);
  if (aligned16(dptrs, dstr, 2, per16))
    attn_bwd_delta<T, HD, true><<<static_cast<unsigned>(dblocks), 256, 0,
                                  a.st>>>(o, dout, delta, a.B, a.H, a.Sq,
                                          a.os, a.dos);
  else
    attn_bwd_delta<T, HD, false><<<static_cast<unsigned>(dblocks), 256, 0,
                                   a.st>>>(o, dout, delta, a.B, a.H, a.Sq,
                                           a.os, a.dos);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return aligned16(ptrs, strides, 7, per16)
             ? launch_bwd<T, HD, true>(a, kblocks, qblocks)
             : launch_bwd<T, HD, false>(a, kblocks, qblocks);
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
