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
// (query, key) pair, 0.34 GFLOP, over 9 MB of q, k, v and o in bf16; hymba's
// prefill (25 heads on 5 KV heads, causal, window 1024) needs 0.2 GFLOP at
// S 64 and 7.7 GFLOP at S 1100.  So the bound is the memory traffic, except
// at S 1100, where it is the multiply rate: 0.115 ms at fp32's 67 TFLOP/s
// off the tensor cores, 0.0078 ms at bf16's 989 TFLOP/s on them.  A design
// that widens bf16 to fp32 in shared memory, finishes each key's dot
// product with warp shuffles and runs QK^T and PV as FMAs is bound by
// instructions and latency at bge's shapes and by the CUDA cores' rate at
// S 1100, so bf16 gets a design of its own.
//
// Two designs, one a dtype:
//
// fp32 (dtype 0), on the CUDA cores: one thread block per (64-query tile,
// head, batch row); the TPU grid's sequential key axis becomes a loop over
// 32-key tiles staged in shared memory as fp32.  Four threads share a query
// row; thread `sub` holds dims sub, sub + 4, ... of q and of the
// accumulator and the dot product is finished with two warp shuffles.  It
// stays off the tensor cores: fp32 serving is held to 1e-5 of the golden
// vectors and TF32 keeps about three digits.
//
// bf16 (dtype 1), on the tensor cores with mma.sync.m16n8k16 (bf16 in, fp32
// accumulators in registers).  The same blocks: 4 warps own a (64-query
// tile, head, batch row), one warp 16 rows, so bge's 512 blocks, hymba
// S 64's 400 and S 1100's 900 fill the 132 SMs.  mma.sync rather than
// wgmma: wgmma wants a 64-row warpgroup tile fed from shared memory in its
// own swizzled layout and pays off on long key loops; here a block sees
// one or two key tiles at bge's and hymba S 64's shapes, and mma.sync lets
// P stay in registers, the score fragment's layout being the A operand's.
//   - q, k and v tiles of 64 rows are staged in shared memory in bf16 with
//     16-byte cp.async copies, taken row by row from the strided
//     (B, S, heads, hd) views (no transpose copy); rows are padded by 16
//     bytes so ldmatrix reads hit distinct banks.  Two stages: the next
//     key tile loads while this one computes.  Views that are not 16-byte
//     aligned go to an instantiation that copies element by element.
//   - S = Q K^T: Q's A fragments are read once with ldmatrix, K's B
//     fragments with ldmatrix; O += P V reads V with ldmatrix.trans.
//   - Masks (kv_len, causal, window) are applied to the score fragment as
//     -inf, only on tiles that cross a boundary; a warp skips a tile its 16
//     rows cannot see.  Keys past kv_len are zero-filled in shared memory.
//   - The online softmax keeps the running max (of raw scores) and the
//     denominator in fp32 per row, and forms p = 2^(x * c - m * c), c =
//     log2(e) / sqrt(hd): one FFMA and one SFU ex2 a score.  The max is
//     reduced across the 4 threads that hold a row once a tile, the
//     denominator once at the end.
//   - P is rounded to bf16 before PV, as the TPU kernel's p.astype(v.dtype),
//     while the denominator sums the unrounded fp32 p.
//   - GQA: query head h reads KV head h / G for any G dividing H.
//   - Head dims 16, 32, 64 and 128; hd 128 takes 85 KB of dynamic shared
//     memory, above the default 48 KB, after cudaFuncSetAttribute.
//   - Launch bounds of four blocks an SM at hd <= 64 (128 registers a
//     thread), so bge's 512 blocks and hymba S 64's 400 run in one wave.
//     The grid is one-dimensional, query tiles slowest and last first, so
//     under a causal mask the blocks that see the most keys start first.
//   What bounds it then: at S 1100 about 140 TFLOP/s of valid products, a
//   seventh of the bf16 peak; the 4 warps of a block meet at two barriers
//   a key tile, and each tile's softmax (64 ex2 a row) waits on its scores,
//   so latency, not a pipe, sets the time.  At bge's and S 64's shapes a
//   block sees one or two key tiles, and the launch and the first tile's
//   load dominate (about 4x the bytes bound).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;             // queries per block
constexpr int BK = 32;             // keys per shared-memory tile
constexpr int TPR = 4;             // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr float NEG = -1e30f;      // initial running max, as in the TPU kernel

struct Strides {
  long long b, h, s;
};

// the SIMT kernel's element conversions (instantiated for fp32 only)
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;     // queries per block, 16 a warp
constexpr int BK = 64;             // keys per shared-memory tile
constexpr int STAGES = 2;          // key tiles in flight
constexpr int PAD = 8;             // bf16 a row: ldmatrix rows on distinct banks
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Tile {
  static constexpr int PITCH = HD + PAD;          // elements a staged row
  static constexpr int ELEMS = BK * PITCH;         // a q, k or v tile (BQ == BK)
  static constexpr size_t SMEM = (1 + 2 * STAGES) * ELEMS * sizeof(bf16);
};
static_assert(BQ == BK, "q and key tiles share one layout");

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

// 2^x, the SFU's approximation (relative error 2^-22; P is then rounded to
// bf16's 8 bits)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<unsigned*>(&v);
}

// Stage rows [0, BK) of a tile: row r is HD elements at src + r * stride
// for r < rows, zeros after.  16-byte cp.async copies when VEC (the view is
// 16-byte aligned), element copies otherwise.
template <int HD, bool VEC>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src,
                                      long long stride, int rows) {
  constexpr int CHUNKS = HD / 8;                    // 16 bytes each
  for (int i = threadIdx.x; i < BK * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    bf16* d = dst + r * Tile<HD>::PITCH + c;
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

// Blocks an SM should hold: four at hd <= 64 (at most 128 registers a
// thread) so bge's 512 blocks and hymba S 64's 400 run in one wave on 132
// SMs; hd 128's 85 KB of shared memory allows two.
template <int HD, bool VEC>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 4 : 2)
flash_attention_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ kv_len,
                   bf16* __restrict__ o, int B, int H, int G, int Sq, int Sk,
                   Strides qs, Strides ks, Strides vs, Strides os,
                   float scale_log2, int causal, int window) {
  constexpr int PITCH = Tile<HD>::PITCH, ELEMS = Tile<HD>::ELEMS;
  constexpr int KSTEPS = HD / 16;     // k-steps of Q K^T
  constexpr int DT = HD / 8;          // 8-wide output column tiles
  constexpr int NT = BK / 8;          // 8-wide key tiles of a score tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + ELEMS;            // STAGES tiles
  bf16* v_s = k_s + STAGES * ELEMS;   // STAGES tiles

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

  const bf16* kb = k + b * ks.b + (long long)(h / G) * ks.h;
  const bf16* vb = v + b * vs.b + (long long)(h / G) * vs.h;
  if (ntiles > 0) {
    stage<HD, VEC>(q_s, q + b * qs.b + h * qs.h + (long long)q0 * qs.s, qs.s,
                   min(BQ, Sq - q0));
    stage<HD, VEC>(k_s, kb + lo * ks.s, ks.s, min(BK, kend - lo));
    stage<HD, VEC>(v_s, vb + lo * vs.s, vs.s, min(BK, kend - lo));
  }
  cp_async_commit();

  unsigned qf[KSTEPS][4];
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  // rows qa and qb: running max of the raw scores, denominator
  float m0 = NEG, m1 = NEG, den0 = 0.f, den1 = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = lo + it * BK;
    if (it + 1 < ntiles) {          // the stage it + 1 uses was freed at it - 1
      const int t1 = t0 + BK, nst = (it + 1) % STAGES;
      stage<HD, VEC>(k_s + nst * ELEMS, kb + t1 * ks.s, ks.s,
                     min(BK, kend - t1));
      stage<HD, VEC>(v_s + nst * ELEMS, vb + t1 * vs.s, vs.s,
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
        ldsm_x4(qf[kk], q_s + (16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8)
                                  * PITCH + 16 * kk + (lane >> 4) * 8);
    }
    const bf16* kt = k_s + (it % STAGES) * ELEMS;
    const bf16* vt = v_s + (it % STAGES) * ELEMS;
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
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          unsigned bk[4];
          ldsm_x4(bk, kt + (8 * j + (lane & 7) + (lane >> 4) * 8) * PITCH
                          + 16 * kk + ((lane >> 3) & 1) * 8);
          mma(s[j], qf[kk], bk[0], bk[1]);
          mma(s[j + 1], qf[kk], bk[2], bk[3]);
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
      // the 4 threads of a quad hold one row's 64 scores
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
        const unsigned pf[4] = {pack(pa0, pa1), pack(pb0, pb1),
                                pack(pc0, pc1), pack(pd0, pd1)};
#pragma unroll
        for (int d = 0; d < DT; d += 2) {
          unsigned bv[4];
          ldsm_x4_trans(bv, vt + (16 * j + (lane & 7) + ((lane >> 3) & 1) * 8)
                                     * PITCH + 8 * d + (lane >> 4) * 8);
          mma(acc[d], pf, bv[0], bv[1]);
          mma(acc[d + 1], pf, bv[2], bv[3]);
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
  bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = 8 * d + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r ? qb : qa;
      if (qi >= Sq) continue;
      const float dd = r ? d1 : d0;
      const __nv_bfloat162 val = __floats2bfloat162_rn(acc[d][2 * r] / dd,
                                                       acc[d][2 * r + 1] / dd);
      bf16* op = ob + (long long)qi * os.s + col;
      if (VEC) {
        *reinterpret_cast<__nv_bfloat162*>(op) = val;
      } else {
        op[0] = val.x;
        op[1] = val.y;
      }
    }
  }
}

template <int HD, bool VEC>
cudaError_t launch_as(const void* q, const void* k, const void* v,
                      const void* kv_len, void* o, int B, int H, int KV,
                      int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                      Strides os, int causal, int window,
                      cudaStream_t stream) {
  constexpr size_t smem = Tile<HD>::SMEM;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_tc<HD, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (long long)((Sq + BQ - 1) / BQ) * H * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_attention_tc<HD, VEC><<<static_cast<unsigned>(blocks), THREADS, smem,
                                stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(kv_len),
      static_cast<bf16*>(o), B, H, H / KV, Sq, Sk, qs, ks, vs, os,
      LOG2E / sqrtf(static_cast<float>(HD)), causal, window);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_len, void* o, int B, int H, int KV, int Sq,
                   int Sk, Strides qs, Strides ks, Strides vs, Strides os,
                   int causal, int window, int vec, cudaStream_t stream) {
  return vec ? launch_as<HD, true>(q, k, v, kv_len, o, B, H, KV, Sq, Sk, qs,
                                   ks, vs, os, causal, window, stream)
             : launch_as<HD, false>(q, k, v, kv_len, o, B, H, KV, Sq, Sk, qs,
                                    ks, vs, os, causal, window, stream);
}

cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const void* kv_len, void* o, int B, int H, int KV,
                        int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                        Strides os, int causal, int window, int vec,
                        cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, kv_len, o, B, H, KV, Sq, Sk, qs, ks, vs, os,
                        causal, window, vec, stream);
    case 32:
      return launch<32>(q, k, v, kv_len, o, B, H, KV, Sq, Sk, qs, ks, vs, os,
                        causal, window, vec, stream);
    case 64:
      return launch<64>(q, k, v, kv_len, o, B, H, KV, Sq, Sk, qs, ks, vs, os,
                        causal, window, vec, stream);
    case 128:
      return launch<128>(q, k, v, kv_len, o, B, H, KV, Sq, Sk, qs, ks, vs, os,
                         causal, window, vec, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// 16-byte copies need every row of every view 16-byte aligned: the base
// pointers and all three strides (in bf16 elements, so multiples of 8).
bool aligned16(const void* const* ptrs, const Strides* strides, int n) {
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
    if (strides[i].b % 8 || strides[i].h % 8 || strides[i].s % 8) return false;
  }
  return true;
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
  if (dtype == 1) {
    const void* ptrs[4] = {q, k, v, o};
    const Strides strides[4] = {qs, ks, vs, os};
    return tc::dispatch_hd(hd, q, k, v, kv_len, o, B, H, KV, Sq, Sk, qs, ks,
                           vs, os, causal, window, aligned16(ptrs, strides, 4),
                           st);
  }
  return cudaErrorInvalidValue;
}
