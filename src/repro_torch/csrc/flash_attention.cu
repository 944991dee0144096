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
// What bounds it on this card.  At the main paths' shapes the work is small:
// bge (B 16, 16 heads, S 96, hd 64) needs 4 * H * hd flops for each valid
// (query, key) pair, 0.34 GFLOP, over 9 MB of q, k, v and o in bf16 (18 MB
// in fp32); hymba's prefill (25 heads on 5 KV heads, causal, window 1024)
// needs 0.2 GFLOP at S 64 and 7.7 GFLOP at S 1100.  So the bound is the
// memory traffic, except at S 1100, where it is the multiply rate: 0.0078 ms
// at bf16's 989 TFLOP/s on the tensor cores, and 0.047 ms for fp32's six
// bf16 products a product (below).  On the CUDA cores fp32 would take
// 0.115 ms at 67 TFLOP/s, and a design that finishes each key's dot product
// with warp shuffles and runs QK^T and PV as FMAs is bound by instructions
// and latency long before that, so both dtypes run on the tensor cores.
//
// One kernel, flash_attention_tc<T, HD, VEC>, on mma.sync.m16n8k16 (bf16
// in, fp32 accumulators in registers).  4 warps own a (64-query tile, head,
// batch row), one warp 16 rows, so bge's 512 blocks, hymba S 64's 400 and
// S 1100's 900 fill the 132 SMs.  mma.sync rather than wgmma: wgmma wants a
// 64-row warpgroup tile fed from shared memory in its own swizzled layout
// and pays off on long key loops; here a block sees one to three key tiles
// at bge's and hymba S 64's shapes, and mma.sync lets P stay in registers,
// the score fragment's layout being the A operand's.
//   - S = Q K^T: Q's A fragments are held in registers for the whole key
//     loop, K's B fragments are read with ldmatrix from key tiles staged in
//     shared memory; O += P V reads V with ldmatrix.trans.  Staged rows are
//     padded by 16 bytes so ldmatrix reads hit distinct banks.
//   - Masks (kv_len, causal, window) are applied to the score fragment as
//     -inf, only on tiles that cross a boundary; a warp skips a tile its 16
//     rows cannot see.  Keys past kv_len are zero-filled in shared memory.
//   - The online softmax keeps the running max (of raw scores) and the
//     denominator in fp32 per row, and forms p = 2^(x * c - m * c), c =
//     log2(e) / sqrt(hd): one FFMA and one SFU ex2 a score.  The max is
//     reduced across the 4 threads that hold a row once a tile, the
//     denominator once at the end.
//   - GQA: query head h reads KV head h / G for any G dividing H.
//   - Head dims 16, 32, 64 and 128; tiles above 48 KB of shared memory take
//     it as dynamic shared memory after cudaFuncSetAttribute.
//   - Launch bounds of four blocks an SM at hd <= 64 (128 registers a
//     thread), so bge's 512 blocks and hymba S 64's 400 run in one wave.
//     The grid is one-dimensional, query tiles slowest and last first, so
//     under a causal mask the blocks that see the most keys start first.
//   - Views that are not 16-byte aligned go to an instantiation (VEC false)
//     that copies element by element.
//
// bf16 (dtype 1): q, k and v tiles of 64 rows are staged as they lie with
// 16-byte cp.async copies, taken row by row from the strided (B, S, heads,
// hd) views (no transpose copy).  Two stages: the next key tile loads while
// this one computes.  P is rounded to bf16 before PV, as the TPU kernel's
// p.astype(v.dtype), while the denominator sums the unrounded fp32 p.
// What bounds it: at S 1100 about 140 TFLOP/s of valid products, a seventh
// of the bf16 peak; the 4 warps of a block meet at two barriers a key tile,
// and each tile's softmax waits on its scores, so latency, not a pipe, sets
// the time.  At bge's and S 64's shapes the launch and the first tile's
// load dominate (about 4x the bytes bound).
//
// fp32 (dtype 0), through an exact bf16 split.  fp32 serving is held to 1e-5
// of the golden vectors, so neither bf16 nor TF32 (about three digits) may
// stand in for fp32.  Every fp32 operand x is instead the exact sum h + m + l
// of three bf16 values (h is x truncated to bf16, m the truncation of x - h,
// l what is left: each difference is exact in fp32 and l has at most 8
// significant bits), and a bf16 x bf16 product is exact in fp32.  So Q K^T
// and P V each take six products a k-step into the fp32 accumulators, small
// to large: l*h, h*l, m*m, m*h, h*m, h*h.  The three dropped ones (m*l, l*m,
// l*l) are below 2^-23 of the product, the rounding of an fp32 FMA, as in
// csrc/quant_matmul.cu's split of x.
//   - The q tile and k and v tiles of 32 keys are loaded with 16-byte reads
//     (all of a tile's loads issued before the first split), split in
//     registers and stored as three bf16 planes each, in the layout the
//     bf16 path's ldmatrix reads; q's planes are read again each k-step,
//     which keeps 48 registers free (55 KB of shared memory a block at hd
//     64, four blocks an SM).  One k/v stage: at the main paths' shapes a
//     block sees one to three key tiles, and the 4 blocks an SM hide each
//     other's loads.
//   - P is split in registers from the score fragment; the denominator sums
//     the fp32 p, which the three terms carry exactly.
//   - The tensor cores add into an fp32 accumulator with truncation, not
//     rounding, so 24 products (six a k-step, four k-steps) added straight
//     into a score bias it by up to 24 units in its last place.  Each
//     k-step's six products (and each 16-key step's in PV) go to a fresh
//     fragment instead, which is added to the running sum with fp32 adds.
//   - The output is written in fp32, 8 bytes a store.
//
// lse (optional, fp32 (B, H, Sq), for the backward kernel in
// flash_attention_bwd.cu): each row's log-sum-exp of its scaled scores,
// m * scale + log(den) from the running max and denominator the row already
// holds; -1e30 for a row with no valid key (its output stays zeros).
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
constexpr int BQ = 16 * WARPS;     // queries per block, 16 a warp
constexpr int PAD = 8;             // bf16 a row: ldmatrix rows on distinct banks
constexpr float NEG = -1e30f;      // initial running max, as in the TPU kernel
constexpr float LOG2E = 1.4426950408889634f;

// What each dtype stages in shared memory, in bf16 elements.  A plane is one
// key tile of one term, BK rows of PITCH.
template <typename T, int HD>
struct Tile;
// bf16: the q tile, then two stages of k tiles and two of v tiles, as they lie
template <int HD>
struct Tile<bf16, HD> {
  static constexpr int BK = 64, STAGES = 2, TERMS = 1;
  static constexpr int PITCH = HD + PAD;
  static constexpr int PLANE = BK * PITCH;
  static constexpr int KV_ELEMS = STAGES * PLANE;  // the k (or v) region
  static constexpr int Q_ELEMS = BQ * PITCH;
  static constexpr int MIN_BLOCKS = HD <= 64 ? 4 : 2;
};
// fp32: the q tile as three planes (h, m, l), read each k-step, then one
// stage of a k tile and a v tile, each as three planes
template <int HD>
struct Tile<float, HD> {
  static constexpr int BK = 32, STAGES = 1, TERMS = 3;
  static constexpr int PITCH = HD + PAD;
  static constexpr int PLANE = BK * PITCH;
  static constexpr int KV_ELEMS = TERMS * PLANE;
  static constexpr int Q_PLANE = BQ * PITCH;
  static constexpr int Q_ELEMS = TERMS * Q_PLANE;
  static constexpr int MIN_BLOCKS = HD <= 64 ? 4 : 2;
};

template <typename T, int HD>
constexpr size_t smem_bytes() {
  return (Tile<T, HD>::Q_ELEMS + 2 * Tile<T, HD>::KV_ELEMS) * sizeof(bf16);
}

// bf16: stage rows [0, BK) of a tile: row r is HD elements at src + r *
// stride for r < rows, zeros after.  16-byte cp.async copies when VEC (the
// view is 16-byte aligned), element copies otherwise.
template <int HD, bool VEC>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src,
                                      long long stride, int rows) {
  using C = Tile<bf16, HD>;
  constexpr int CHUNKS = HD / 8;                    // 16 bytes each
  for (int i = threadIdx.x; i < C::BK * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    bf16* d = dst + r * C::PITCH + c;
    if (r >= rows) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    } else if (VEC) {
      cp_async16(d, src + r * stride + c);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = src[r * stride + c + e];
    }
  }
}

// fp32: rows [0, ROWS) of NS tiles (row r of tile w is HD floats at src[w] +
// r * stride[w] for r < rows, zeros after), each stored as its three bf16
// planes of ROWS rows.  Every load is issued before the first split.
template <int HD, int ROWS, int NS, bool VEC>
__device__ __forceinline__ void stage_split(bf16* const (&dst)[NS],
                                            const float* const (&src)[NS],
                                            const long long (&stride)[NS],
                                            int rows) {
  constexpr int PITCH = HD + PAD, PLANE = ROWS * PITCH;
  constexpr int CHUNKS = HD / 4;                    // 4 floats each
  constexpr int PER = ROWS * CHUNKS / THREADS;      // chunks a thread a tile
  static_assert(ROWS * CHUNKS % THREADS == 0, "whole chunks a thread");
  float4 x[NS][PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * THREADS;
    const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
#pragma unroll
    for (int w = 0; w < NS; ++w) {
      x[w][u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows) {
        const float* p = src[w] + r * stride[w] + c;
        x[w][u] = VEC ? __ldg(reinterpret_cast<const float4*>(p))
                      : make_float4(p[0], p[1], p[2], p[3]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * THREADS;
    const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
#pragma unroll
    for (int w = 0; w < NS; ++w) {
      float t[4][3];
      split3(x[w][u].x, t[0]);
      split3(x[w][u].y, t[1]);
      split3(x[w][u].z, t[2]);
      split3(x[w][u].w, t[3]);
      bf16* d = dst[w] + r * PITCH + c;
#pragma unroll
      for (int p = 0; p < 3; ++p)
        *reinterpret_cast<uint2*>(d + p * PLANE) =
            make_uint2(pack_exact(t[0][p], t[1][p]),
                       pack_exact(t[2][p], t[3][p]));
    }
  }
}

template <typename T, int HD, bool VEC>
__global__ void __launch_bounds__(THREADS, Tile<T, HD>::MIN_BLOCKS)
flash_attention_tc(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ kv_len,
                   T* __restrict__ o, float* __restrict__ lse, int B, int H,
                   int G, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                   Strides os, float scale_log2, int causal, int window) {
  using C = Tile<T, HD>;
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int BK = C::BK, PITCH = C::PITCH, PLANE = C::PLANE;
  constexpr int TERMS = C::TERMS;
  constexpr int FIRST = SPLIT ? 0 : 5;  // the products taken, term_a/b(i)
  // fp32: each k-step's products go to a fresh fragment, added to the
  // running sums with fp32 adds (see the header)
  constexpr bool FRESH = SPLIT;
  constexpr int KSTEPS = HD / 16;     // k-steps of Q K^T
  constexpr int DT = HD / 8;          // 8-wide output column tiles
  constexpr int NT = BK / 8;          // 8-wide key tiles of a score tile
  static_assert(SPLIT || BQ == BK, "bf16 q and key tiles share one layout");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);   // q's tile (fp32: 3 planes)
  bf16* k_s = q_s + C::Q_ELEMS;
  bf16* v_s = k_s + C::KV_ELEMS;

  // Blocks are handed out in index order, heads fastest, query tiles
  // slowest and last first: under a causal mask the last tiles see the
  // most keys, and starting the longest blocks first keeps a few of them
  // from running alone at the end.
  const int tiles = (Sq + BQ - 1) / BQ;
  const int h = blockIdx.x % H, b = (blockIdx.x / H) % B;
  const int q0 = (tiles - 1 - blockIdx.x / (H * B)) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int w0 = q0 + 16 * warp;            // the warp's first query
  const int qa = w0 + g, qb = qa + 8;       // the thread's two query rows

  const int kend = min(max(kv_len[b], 0), Sk);
  int lo = 0, hi = kend;
  if (causal) hi = min(hi, q0 + BQ);          // keys <= the tile's last query
  if (window) lo = max(0, q0 - window + 1);   // keys > first query - window
  lo = (lo / BK) * BK;
  const int ntiles = hi > lo ? (hi - lo + BK - 1) / BK : 0;

  const T* kb = k + b * ks.b + (long long)(h / G) * ks.h;
  const T* vb = v + b * vs.b + (long long)(h / G) * vs.h;
  const T* qh = q + b * qs.b + h * qs.h;
  unsigned qf[KSTEPS][4];           // bf16: q's fragments, held
  if constexpr (SPLIT) {
    if (ntiles > 0) {
      bf16* const dst[1] = {q_s};
      const float* const src[1] = {qh + (long long)q0 * qs.s};
      const long long stride[1] = {qs.s};
      stage_split<HD, BQ, 1, VEC>(dst, src, stride, min(BQ, Sq - q0));
    }
  } else {
    if (ntiles > 0) {
      stage<HD, VEC>(q_s, qh + (long long)q0 * qs.s, qs.s, min(BQ, Sq - q0));
      stage<HD, VEC>(k_s, kb + lo * ks.s, ks.s, min(BK, kend - lo));
      stage<HD, VEC>(v_s, vb + lo * vs.s, vs.s, min(BK, kend - lo));
    }
    cp_async_commit();
  }

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  // rows qa and qb: running max of the raw scores, denominator
  float m0 = NEG, m1 = NEG, den0 = 0.f, den1 = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = lo + it * BK;
    const bf16* kt = k_s;
    const bf16* vt = v_s;
    if constexpr (SPLIT) {          // the planes were freed at the last barrier
      bf16* const dst[2] = {k_s, v_s};
      const float* const src[2] = {kb + t0 * ks.s, vb + t0 * vs.s};
      const long long stride[2] = {ks.s, vs.s};
      stage_split<HD, BK, 2, VEC>(dst, src, stride, min(BK, kend - t0));
      __syncthreads();
    } else {
      if (it + 1 < ntiles) {        // the stage it + 1 uses was freed at it - 1
        const int t1 = t0 + BK, nst = (it + 1) % C::STAGES;
        stage<HD, VEC>(k_s + nst * PLANE, kb + t1 * ks.s, ks.s,
                       min(BK, kend - t1));
        stage<HD, VEC>(v_s + nst * PLANE, vb + t1 * vs.s, vs.s,
                       min(BK, kend - t1));
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          ldsm_x4(qf[kk],
                  q_s + (16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8)
                            * PITCH + 16 * kk + (lane >> 4) * 8);
      }
      kt += (it % C::STAGES) * PLANE;
      vt += (it % C::STAGES) * PLANE;
    }
    // does any of the warp's 16 rows see a key of this tile?
    const bool seen = w0 < Sq && !(causal && t0 > w0 + 15)
                      && !(window && t0 + BK - 1 <= w0 - window);
    if (seen) {
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        unsigned qk[TERMS][4];      // this k-step's q fragments
#pragma unroll
        for (int p = 0; p < TERMS; ++p) {
          if constexpr (SPLIT) {
            ldsm_x4(qk[p], q_s + p * Tile<float, HD>::Q_PLANE
                               + (16 * warp + (lane & 7)
                                  + ((lane >> 3) & 1) * 8) * PITCH
                               + 16 * kk + (lane >> 4) * 8);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) qk[p][e] = qf[kk][e];
          }
        }
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          unsigned bk[TERMS][4];
#pragma unroll
          for (int p = 0; p < TERMS; ++p)
            ldsm_x4(bk[p], kt + p * PLANE
                               + (8 * j + (lane & 7) + (lane >> 4) * 8) * PITCH
                               + 16 * kk + ((lane >> 3) & 1) * 8);
          float f[2][4] = {};
          float(&c0)[4] = FRESH ? f[0] : s[j];
          float(&c1)[4] = FRESH ? f[1] : s[j + 1];
#pragma unroll
          for (int i = FIRST; i < 6; ++i) {
            mma(c0, qk[term_a(i)], bk[term_b(i)][0], bk[term_b(i)][1]);
            mma(c1, qk[term_a(i)], bk[term_b(i)][2], bk[term_b(i)][3]);
          }
          if constexpr (FRESH) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[j][e] += f[0][e];
              s[j + 1][e] += f[1][e];
            }
          }
        }
      }
      // a tile that crosses kv_len, the diagonal or the window's edge
      const bool edge = t0 + BK > kend || (causal && t0 + BK - 1 > w0)
                        || (window && t0 <= w0 + 15 - window);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x0 = s[j][e], x1 = s[j][2 + e];
          if (edge) {
            const int key = t0 + 8 * j + 2 * t + e;
            bool ok0 = key < kend, ok1 = ok0;
            if (causal) {
              ok0 = ok0 && key <= qa;
              ok1 = ok1 && key <= qb;
            }
            if (window) {
              ok0 = ok0 && key > qa - window;
              ok1 = ok1 && key > qb - window;
            }
            x0 = ok0 ? x0 : -INFINITY;
            x1 = ok1 ? x1 : -INFINITY;
          }
          s[j][e] = x0;
          s[j][2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
      // the 4 threads of a quad hold one row's scores
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // exp(scale * (x - m)) = 2^(x * scale_log2 - m * scale_log2): one FFMA
      // and one SFU op a score
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float c0 = ex2((m0 - n0) * scale_log2);
      const float c1 = ex2((m1 - n1) * scale_log2);
      const float o0 = -n0 * scale_log2, o1 = -n1 * scale_log2;
      m0 = n0;
      m1 = n1;
      den0 *= c0;
      den1 *= c1;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][0] *= c0;
        acc[d][1] *= c0;
        acc[d][2] *= c1;
        acc[d][3] *= c1;
      }
      // P (exactly 0 for a masked key) feeds PV from registers: score
      // tiles 2j and 2j + 1 are the A fragment of key step j
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        const float* sa = s[2 * j];
        const float* sc = s[2 * j + 1];
        const float pa0 = ex2(fmaf(sa[0], scale_log2, o0));
        const float pa1 = ex2(fmaf(sa[1], scale_log2, o0));
        const float pb0 = ex2(fmaf(sa[2], scale_log2, o1));
        const float pb1 = ex2(fmaf(sa[3], scale_log2, o1));
        const float pc0 = ex2(fmaf(sc[0], scale_log2, o0));
        const float pc1 = ex2(fmaf(sc[1], scale_log2, o0));
        const float pd0 = ex2(fmaf(sc[2], scale_log2, o1));
        const float pd1 = ex2(fmaf(sc[3], scale_log2, o1));
        den0 += (pa0 + pa1) + (pc0 + pc1);
        den1 += (pb0 + pb1) + (pd0 + pd1);
        unsigned pf[TERMS][4];
        if constexpr (SPLIT) {      // P's exact split: fp32 p in PV
          const float pv[8] = {pa0, pa1, pb0, pb1, pc0, pc1, pd0, pd1};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float lo2[3], hi2[3];
            split3(pv[2 * e], lo2);
            split3(pv[2 * e + 1], hi2);
#pragma unroll
            for (int p = 0; p < 3; ++p) pf[p][e] = pack_exact(lo2[p], hi2[p]);
          }
        } else {                    // P rounded to bf16, as the TPU kernel's
          pf[0][0] = pack(pa0, pa1);
          pf[0][1] = pack(pb0, pb1);
          pf[0][2] = pack(pc0, pc1);
          pf[0][3] = pack(pd0, pd1);
        }
#pragma unroll
        for (int d = 0; d < DT; d += 2) {
          unsigned bv[TERMS][4];
#pragma unroll
          for (int p = 0; p < TERMS; ++p)
            ldsm_x4_trans(bv[p], vt + p * PLANE
                                     + (16 * j + (lane & 7)
                                        + ((lane >> 3) & 1) * 8) * PITCH
                                     + 8 * d + (lane >> 4) * 8);
          float f[2][4] = {};
          float(&c0)[4] = FRESH ? f[0] : acc[d];
          float(&c1)[4] = FRESH ? f[1] : acc[d + 1];
#pragma unroll
          for (int i = FIRST; i < 6; ++i) {
            mma(c0, pf[term_a(i)], bv[term_b(i)][0], bv[term_b(i)][1]);
            mma(c1, pf[term_a(i)], bv[term_b(i)][2], bv[term_b(i)][3]);
          }
          if constexpr (FRESH) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[d][e] += f[0][e];
              acc[d + 1][e] += f[1][e];
            }
          }
        }
      }
    }
    __syncthreads();                // this stage is consumed
  }

  den0 += __shfl_xor_sync(0xffffffffu, den0, 1);
  den0 += __shfl_xor_sync(0xffffffffu, den0, 2);
  den1 += __shfl_xor_sync(0xffffffffu, den1, 1);
  den1 += __shfl_xor_sync(0xffffffffu, den1, 2);
  const float d0 = fmaxf(den0, 1e-30f), d1 = fmaxf(den1, 1e-30f);
  if (lse != nullptr && t == 0) {   // one thread of the quad a row
    const float scale = scale_log2 / LOG2E;
    float* lb = lse + ((long long)b * H + h) * Sq;
    if (qa < Sq) lb[qa] = den0 > 0.f ? fmaf(m0, scale, logf(den0)) : NEG;
    if (qb < Sq) lb[qb] = den1 > 0.f ? fmaf(m1, scale, logf(den1)) : NEG;
  }
  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = 8 * d + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r ? qb : qa;
      if (qi >= Sq) continue;
      const float dd = r ? d1 : d0;
      const float x0 = acc[d][2 * r] / dd, x1 = acc[d][2 * r + 1] / dd;
      T* op = ob + (long long)qi * os.s + col;
      if constexpr (SPLIT) {
        if (VEC) {
          *reinterpret_cast<float2*>(op) = make_float2(x0, x1);
        } else {
          op[0] = x0;
          op[1] = x1;
        }
      } else {
        const __nv_bfloat162 val = __floats2bfloat162_rn(x0, x1);
        if (VEC) {
          *reinterpret_cast<__nv_bfloat162*>(op) = val;
        } else {
          op[0] = val.x;
          op[1] = val.y;
        }
      }
    }
  }
}

template <typename T, int HD, bool VEC>
cudaError_t launch_as(const void* q, const void* k, const void* v,
                      const void* kv_len, void* o, float* lse, int B, int H,
                      int KV, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                      Strides os, int causal, int window,
                      cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, HD>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_tc<T, HD, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (long long)((Sq + BQ - 1) / BQ) * H * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_attention_tc<T, HD, VEC><<<static_cast<unsigned>(blocks), THREADS,
                                   smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<T*>(o), lse, B, H, H / KV, Sq, Sk, qs, ks, vs, os,
      LOG2E / sqrtf(static_cast<float>(HD)), causal, window);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_len, void* o, float* lse, int B, int H,
                   int KV, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                   Strides os,
                   int causal, int window, int vec, cudaStream_t stream) {
  return vec ? launch_as<T, HD, true>(q, k, v, kv_len, o, lse, B, H, KV, Sq,
                                      Sk, qs, ks, vs, os, causal, window,
                                      stream)
             : launch_as<T, HD, false>(q, k, v, kv_len, o, lse, B, H, KV, Sq,
                                       Sk, qs, ks, vs, os, causal, window,
                                       stream);
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const void* kv_len, void* o, float* lse, int B, int H,
                        int KV, int Sq, int Sk, Strides qs, Strides ks,
                        Strides vs, Strides os, int causal, int window,
                        int vec, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, kv_len, o, lse, B, H, KV, Sq, Sk, qs,
                           ks, vs, os, causal, window, vec, stream);
    case 32:
      return launch<T, 32>(q, k, v, kv_len, o, lse, B, H, KV, Sq, Sk, qs,
                           ks, vs, os, causal, window, vec, stream);
    case 64:
      return launch<T, 64>(q, k, v, kv_len, o, lse, B, H, KV, Sq, Sk, qs,
                           ks, vs, os, causal, window, vec, stream);
    case 128:
      return launch<T, 128>(q, k, v, kv_len, o, lse, B, H, KV, Sq, Sk, qs,
                            ks, vs, os, causal, window, vec, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// 16-byte reads and writes need every row of every view 16-byte aligned:
// the base pointers and all three strides (multiples of `per16` elements,
// the elements in 16 bytes).
bool aligned16(const void* const* ptrs, const Strides* strides, int n,
               int per16) {
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
    if (strides[i].b % per16 || strides[i].h % per16 || strides[i].s % per16)
      return false;
  }
  return true;
}

}  // namespace

// q (B, H, Sq, hd), k and v (B, KV, Sk, hd), o (B, H, Sq, hd), each given by
// its (batch, head, position) strides in elements with a contiguous head
// dim; kv_len (B,) int32 on the device; lse null or fp32 (B, H, Sq)
// contiguous.  dtype 0 = float32, 1 = bfloat16.  Launches on `stream` and
// returns the launch's cudaError_t.
extern "C" int windve_flash_attention(
    const void* q, const void* k, const void* v, const void* kv_len, void* o,
    void* lse, int dtype, int B, int H, int KV, int Sq, int Sk, int hd,
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
  const void* ptrs[4] = {q, k, v, o};
  const Strides strides[4] = {qs, ks, vs, os};
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, kv_len, o,
                              static_cast<float*>(lse), B, H, KV, Sq, Sk, qs,
                              ks, vs, os, causal, window,
                              aligned16(ptrs, strides, 4, 4), st);
  if (dtype == 1)
    return dispatch_hd<bf16>(hd, q, k, v, kv_len, o,
                             static_cast<float*>(lse), B, H, KV, Sq, Sk, qs,
                             ks, vs, os, causal, window,
                             aligned16(ptrs, strides, 4, 8), st);
  return cudaErrorInvalidValue;
}
