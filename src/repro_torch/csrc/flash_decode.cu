// Flash-decode attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode/flash_decode.py
// (flash_decode_pallas / _fd_kernel): one query token per (batch row, KV
// head), its G = H / KV query heads against a (B, Sc, KV, hd) cache whose
// slots carry absolute positions kpos (a ring buffer under a sliding
// window).  A slot is valid when 0 <= kpos <= pos and, with a window,
// kpos > pos - window.  Scores are q . k / sqrt(hd) in fp32, the softmax
// runs online (running max, denominator, accumulator), and the output is
// acc / den in q's type.
//
// Numerics follow the LM's decode read (models/layers.py attn_decode): k is
// rounded to q's type before the dot (a no-op for fp32 q), the softmax
// weights are rounded to the cache's type before the weighted sum (a no-op
// for an fp32 cache), and sums are fp32.  A masked slot contributes exactly
// 0, so a row with no valid slot comes out as zeros.
//
// Optionally (lse != nullptr) each row's log-sum-exp over the slots it was
// given is written too, fp32 (B, KV, G): max + log(denominator) in natural
// units, -1e30 for a row with no valid slot.  That is what a shard of a
// sequence-sharded cache hands the combine (the reference's shard_map
// flash-decode, models/layers.py attn_decode_sharded): the cluster merge
// below already holds every row's max and denominator.
//
// What bounds it on this card: memory, and at the decode shapes latency.
// Each valid slot's k and v rows are read once for the G query heads that
// share them; the arithmetic is 4 * G * hd flops a slot, about 2.5 flops a
// byte, so the tensor cores would not help (and an fp32 cache against fp32
// weights cannot use them without changing the numerics).  At hymba-1.5b's
// decode (B 16, KV 5, G 5, hd 64, 80 fp32 slots) that is 3.3 MB, 1 us at
// the memory's rate: the time goes to load latency and to how many SMs
// have work.  One block per (row, KV head) gives 80 blocks there, and 10
// on a 1024-slot ring at B 2.
//
// Design: split each (row, KV head)'s slots over a thread-block cluster of
// CL blocks, one launch.
//   - Registers, not shared memory, hold the work (q, the accumulator and
//     U slots' rows in flight): 255 a thread, so a block of up to 8 warps
//     holds its SM alone.  The host picks CL (1 to 8, the portable cluster
//     size) as the largest that keeps the grid within one wave of the
//     card's SMs, with at least MIN_SLOTS slots a block; rank r takes the
//     slots [r * chunk, (r + 1) * chunk).  hymba's served decode (80
//     pairs) runs one block a pair; a 1024-slot ring at B 2 (10 pairs)
//     runs clusters of 8.
//   - Inside a block, lanes take the head dimension in 16-byte loads (4
//     fp32 or 8 bf16 a lane), so a group of LG lanes (8, 16 or 32, a
//     compile-time width) holds one cache row and a warp 32 / LG rows;
//     groups take the block's slots in turn, U at a time, loading the
//     next batch's slot positions while a batch's rows load.  q and the
//     accumulator of up to GC query heads live in registers.  k is rounded to
//     q's type once a slot; the dots of every (head, slot) pair are
//     finished together, one shuffle level at a time, so the shuffles
//     overlap; scores are kept in log2 units so a weight is one ex2.
//     Each group keeps its own online softmax, one rescale per U slots,
//     no barrier.  Masked slots are skipped without reading k or v.
//   - Merge: the groups of a warp by shuffles, the warps of a block
//     through shared memory, and the blocks of a cluster through
//     distributed shared memory after cluster.sync(), each in a fixed
//     order (rank order across the cluster), so the result does not
//     depend on scheduling.  Rank r writes its share of the outputs.  No
//     global scratch, no second launch.
//   - G query heads are taken GC = 8 at a time, each chunk its own blocks
//     (grid.y), and heads past G cost nothing (uniform branches); hd up to
//     512 (NCH 16-byte chunks a lane: NCH <= 4
//     for an fp32 cache, <= 2 for bf16).
//   - A cache view whose strides or base are not 16-byte aligned, or an hd
//     that is not a multiple of the vector, loads element by element (a
//     uniform branch).  q is read once a block, element by element, so
//     its alignment does not matter.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_CLUSTER = 8;     // the portable cluster size
constexpr int MAX_WARPS = 8;
constexpr int GC = 8;              // query heads a block keeps in registers
constexpr int MIN_SLOTS = 32;      // fewest slots worth a block of their own
constexpr float NEG = -1e30f;      // the running max before any valid slot
constexpr float LOG2E = 1.4426950408889634f;

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

// 2^x, the SFU's approximation (relative error about 2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A row's log-sum-exp in natural units from its max (log2 units, scores
// times scale * log2 e) and its denominator; NEG for a row with no slot.
// Summed in double, once a row, so the stored fp32 is rounded once: a
// combine weighs a shard by exp(lse - max), whose relative error is the
// lse's absolute error.
__device__ __forceinline__ float lse_of(float mx, float den) {
  if (!(den > 0.f)) return NEG;
  const double l2 = static_cast<double>(mx) + log2(static_cast<double>(den));
  return static_cast<float>(l2 * 0.6931471805599453);
}

// x as a value of type T sees it: rounded to T, widened back to fp32.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ unsigned bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ unsigned bits(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}

// The 16 bytes of a row chunk: one load when vec, else the `left` elements
// that exist, element by element, and zeros after them.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* p, int left, int vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  constexpr int EPL = 16 / sizeof(T), PER = EPL / 4;   // elements a word
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (i * PER + j < left) w[i] |= bits(p[i * PER + j]) << (16 * j);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Element j of a chunk as fp32.
template <typename T>
__device__ __forceinline__ float elem(const uint4& u, int j);
template <>
__device__ __forceinline__ float elem<float>(const uint4& u, int j) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
  return __uint_as_float(w[j]);
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& u, int j) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
  const unsigned b = w[j / 2];
  return __uint_as_float(j % 2 ? b & 0xffff0000u : b << 16);
}

// q strides: (b, s, h) = batch row, query head in the group, KV head.
// k and v strides: (b, s, h) = batch row, slot, KV head.
// Block (pair * CL + rank, head chunk), pair = b * KV + h.  LG lanes a cache
// row (a power of two), NCH 16-byte chunks a lane; vec: the cache takes
// 16-byte loads.
template <typename TQ, typename TC, int NCH, int LG>
__global__ void __launch_bounds__(32 * MAX_WARPS)
flash_decode_kernel(const TQ* __restrict__ q, const TC* __restrict__ k,
                    const TC* __restrict__ v, const int* __restrict__ kpos,
                    TQ* __restrict__ o, float* __restrict__ lse, int KV,
                    int G, int Sc, int hd, int chunk, int vec, Strides qs,
                    Strides ks, Strides vs, float scale_log2, int pos,
                    int window) {
  constexpr int EPL = 16 / sizeof(TC);     // elements a lane loads a chunk
  constexpr int U = NCH == 1 ? 4 : NCH == 2 ? 2 : 1;   // slots in flight
  constexpr int GPW = 32 / LG;             // groups (cache rows) a warp
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int pair = blockIdx.x / CL;
  const int h = pair % KV, b = pair / KV;
  const int W = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int li = lane % LG, grp = lane / LG;
  const int ngroups = W * GPW, step = U * ngroups;
  const int s_lo = min(Sc, rank * chunk), s_hi = min(Sc, s_lo + chunk);
  const int row = hd + 2;                  // acc[hd], then max, den
  float* wpart = smem;                     // W x GC rows: each warp's part
  float* bpart = smem + W * GC * row;      // GC rows: the block's part

  const TQ* qb = q + b * qs.b + h * qs.h;
  const TC* kb = k + b * ks.b + h * ks.h;
  const TC* vb = v + b * vs.b + h * vs.h;
  TQ* ob = o + (static_cast<long long>(b) * KV + h) * G * hd;
  float* lb = lse ? lse + (static_cast<long long>(b) * KV + h) * G : nullptr;

  const int g0 = blockIdx.y * GC;            // this block's query heads
  const int gn = min(GC, G - g0);
  // The warp's groups take slots base + grp + u * ngroups, base = s_lo +
  // warp * GPW + i * step; the loop bound is the warp's, so every lane
  // reaches every shuffle.  The first positions load beside q.
  int base = s_lo + warp * GPW;
  int kp[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int s = base + grp + u * ngroups;
    kp[u] = s < s_hi ? kpos[s] : -1;
  }
  float qr[GC][NCH][EPL], acc[GC][NCH][EPL], m[GC], den[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = NEG;
    den[g] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < EPL; ++j) {
        const int e = (c * LG + li) * EPL + j;
        qr[g][c][j] = g < gn && e < hd ? to_f(qb[(g0 + g) * qs.s + e]) : 0.f;
        acc[g][c][j] = 0.f;
      }
  }

  for (; base < s_hi; base += step) {
    bool ok[U];
    uint4 kr[U][NCH], vr[U][NCH];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = base + grp + u * ngroups;
      ok[u] = kp[u] >= 0 && kp[u] <= pos
              && (window == 0 || kp[u] > pos - window);
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int e = (c * LG + li) * EPL;
        kr[u][c] = vr[u][c] = make_uint4(0, 0, 0, 0);
        if (ok[u] && e < hd) {
          kr[u][c] = load_chunk<TC>(kb + s * ks.s + e, hd - e, vec);
          vr[u][c] = load_chunk<TC>(vb + s * vs.s + e, hd - e, vec);
        }
      }
    }
    // the next batch's positions, while these rows load
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = base + step + grp + u * ngroups;
      kp[u] = s < s_hi ? kpos[s] : -1;
    }
    // every (head, slot) score: the lanes' dots, then the group's sums
    // level by level, GC * U independent shuffles a level.  Scores are
    // kept in log2 units (times scale * log2 e), so a weight is one ex2.
    float kf[U][NCH][EPL];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < EPL; ++j)
          kf[u][c][j] = round_to<TQ>(elem<TC>(kr[u][c], j));
    float d[GC][U];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g >= gn) break;                // uniform: heads past G cost nothing
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int j = 0; j < EPL; ++j) a += qr[g][c][j] * kf[u][c][j];
        d[g][u] = a;
      }
    }
#pragma unroll
    for (int off = LG / 2; off > 0; off >>= 1) {
      float t[GC][U];
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (g >= gn) break;
#pragma unroll
        for (int u = 0; u < U; ++u)
          t[g][u] = __shfl_xor_sync(0xffffffffu, d[g][u], off);
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (g >= gn) break;
#pragma unroll
        for (int u = 0; u < U; ++u) d[g][u] += t[g][u];
      }
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g >= gn) break;
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        d[g][u] *= scale_log2;
        if (ok[u]) mx = fmaxf(mx, d[g][u]);
      }
      const float corr = ex2(m[g] - mx);
      float p[U], sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = ok[u] ? ex2(d[g][u] - mx) : 0.f;
        sum += p[u];
        p[u] = round_to<TC>(p[u]);
      }
      den[g] = den[g] * corr + sum;
      m[g] = mx;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < EPL; ++j) {
          float a = acc[g][c][j] * corr;
#pragma unroll
          for (int u = 0; u < U; ++u) a += p[u] * elem<TC>(vr[u][c], j);
          acc[g][c][j] = a;
        }
    }
  }

  // the warp's groups, pairwise by shuffles (both sides of a pair compute
  // the same sums)
#pragma unroll
  for (int off = LG; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g >= gn) break;
      const float om = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float od = __shfl_xor_sync(0xffffffffu, den[g], off);
      const float mx = fmaxf(m[g], om);
      const float ca = ex2(m[g] - mx), cb = ex2(om - mx);
      den[g] = den[g] * ca + od * cb;
      m[g] = mx;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < EPL; ++j) {
          const float oa = __shfl_xor_sync(0xffffffffu, acc[g][c][j], off);
          acc[g][c][j] = acc[g][c][j] * ca + oa * cb;
        }
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g >= gn) break;
      float* r = wpart + (warp * GC + g) * row;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < EPL; ++j) {
          const int e = (c * LG + li) * EPL + j;
          if (e < hd) r[e] = acc[g][c][j];
        }
      if (li == 0) {
        r[hd] = m[g];
        r[hd + 1] = den[g];
      }
    }
  }
  __syncthreads();

  // the block's warps, in warp order; a block alone writes the output
  for (int i = threadIdx.x; i < gn * hd; i += blockDim.x) {
    const int g = i / hd, e = i % hd;
    float mx = NEG;
    for (int w = 0; w < W; ++w)
      mx = fmaxf(mx, wpart[(w * GC + g) * row + hd]);
    float a = 0.f, d = 0.f;
    for (int w = 0; w < W; ++w) {
      const float* r = wpart + (w * GC + g) * row;
      const float c = ex2(r[hd] - mx);
      a += r[e] * c;
      d += r[hd + 1] * c;
    }
    if (CL == 1) {
      ob[(g0 + g) * hd + e] = from_f<TQ>(d > 0.f ? a / d : 0.f);
      if (lb && e == 0) lb[g0 + g] = lse_of(mx, d);
      continue;
    }
    float* br = bpart + g * row;
    br[e] = a;
    if (e == 0) {
      br[hd] = mx;
      br[hd + 1] = d;
    }
  }
  if (CL == 1) return;
  cluster.sync();            // every block's part is published

  // the cluster's blocks, in rank order; rank r writes outputs r, r + CL
  // * blockDim, ... of the gn x hd
  for (int i = rank * blockDim.x + threadIdx.x; i < gn * hd;
       i += CL * blockDim.x) {
    const int g = i / hd, e = i % hd;
    float mx = NEG;
    for (int r = 0; r < CL; ++r)
      mx = fmaxf(mx, cluster.map_shared_rank(bpart, r)[g * row + hd]);
    float a = 0.f, d = 0.f;
    for (int r = 0; r < CL; ++r) {
      const float* br = cluster.map_shared_rank(bpart, r) + g * row;
      const float c = ex2(br[hd] - mx);
      a += br[e] * c;
      d += br[hd + 1] * c;
    }
    ob[(g0 + g) * hd + e] = from_f<TQ>(d > 0.f ? a / d : 0.f);
    if (lb && e == 0) lb[g0 + g] = lse_of(mx, d);
  }
  cluster.sync();            // no block leaves while its part is read
}

template <typename TQ, typename TC, int NCH, int LG>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const int* kpos, void* o, float* lse, int B, int KV,
                         int G,
                         int Sc, int hd, int vec, Strides qs, Strides ks,
                         Strides vs, int pos, int window, cudaStream_t st) {
  constexpr int U = NCH == 1 ? 4 : NCH == 2 ? 2 : 1;
  const long long pairs = static_cast<long long>(B) * KV;
  const int ngc = (G + GC - 1) / GC;               // head chunks a pair
  // A block holds its SM alone (255 registers a thread), so the grid fills
  // one wave at most: a cluster of CL blocks a (pair, head chunk), CL as
  // large as the SMs and the slots allow.
  int CL = 1;
  if (Sc > MIN_SLOTS) {
    int sms = 0;
    const cudaError_t err = windve_sm_count(&sms);
    if (err != cudaSuccess) return err;
    const long long fit = sms / (pairs * ngc);
    const int most = (Sc + MIN_SLOTS - 1) / MIN_SLOTS;
    CL = static_cast<int>(fit < MAX_CLUSTER ? fit : MAX_CLUSTER);
    CL = max(1, min(CL, most));
  }
  if (pairs * CL > 0x7fffffffLL || ngc > 65535)
    return cudaErrorInvalidConfiguration;
  const int chunk = (Sc + CL - 1) / CL;
  // warps: about U slots for each group of LG lanes
  const int per_warp = (32 / LG) * U;
  const int W = max(1, min(MAX_WARPS, (chunk + per_warp - 1) / per_warp));
  const size_t smem = sizeof(float) * (W + 1) * GC * (hd + 2);
  auto kernel = flash_decode_kernel<TQ, TC, NCH, LG>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(pairs * CL), ngc);
  cfg.blockDim = dim3(32 * W);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1;       // a lone block is launched as a plain grid
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TQ*>(q), static_cast<const TC*>(k),
      static_cast<const TC*>(v), kpos, static_cast<TQ*>(o), lse, KV, G, Sc,
      hd,
      chunk, vec, qs, ks, vs, LOG2E / sqrtf(static_cast<float>(hd)), pos,
      window);
}

template <typename TQ, typename TC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kpos, void* o, float* lse, int B, int KV, int G,
                   int Sc,
                   int hd, Strides qs, Strides ks, Strides vs, int pos,
                   int window, cudaStream_t st) {
  constexpr int EPL = 16 / sizeof(TC);
  const int lanes = (hd + EPL - 1) / EPL;          // chunks a row
  const int vec =
      hd % EPL == 0 && ks.b % EPL == 0 && ks.s % EPL == 0 && ks.h % EPL == 0
      && vs.b % EPL == 0 && vs.s % EPL == 0 && vs.h % EPL == 0
      && reinterpret_cast<uintptr_t>(k) % 16 == 0
      && reinterpret_cast<uintptr_t>(v) % 16 == 0;
#define WINDVE_FD_LAUNCH(N, L)                                         \
  return launch_split<TQ, TC, N, L>(q, k, v, kpos, o, lse, B, KV, G, Sc, \
                                    hd, vec, qs, ks, vs, pos, window, st)
  if (lanes <= 8) WINDVE_FD_LAUNCH(1, 8);      // one chunk a lane
  if (lanes <= 16) WINDVE_FD_LAUNCH(1, 16);
  if (lanes <= 32) WINDVE_FD_LAUNCH(1, 32);
  if (lanes <= 64) WINDVE_FD_LAUNCH(2, 32);
  // hd above 256: fp32 caches only (a bf16 cache covers 512 at NCH 2)
  if constexpr (sizeof(TC) == 4) {
    if (lanes <= 128) WINDVE_FD_LAUNCH(4, 32);
  }
#undef WINDVE_FD_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, KV, G, hd) with strides (qb, qh, qg) and a unit last stride;
// k, v (B, Sc, KV, hd) with strides (kb, ks, kh) / (vb, vs, vh) and a unit
// last stride; kpos (Sc,) int32; o (B, KV, G, hd) contiguous, q's type;
// lse (B, KV, G) contiguous fp32, or null for none.
// (q_dtype, c_dtype), 0 = float32 and 1 = bfloat16, one of (0, 0), (1, 0)
// and (1, 1); k and v share c_dtype.
// Launches on `stream` and returns the launch's cudaError_t.
extern "C" int windve_flash_decode(
    const void* q, const void* k, const void* v, const void* kpos, void* o,
    void* lse_out, int q_dtype, int c_dtype, int B, int KV, int G, int Sc,
    int hd,
    long long qb, long long qh, long long qg, long long kb, long long ks,
    long long kh, long long vb, long long vs, long long vh, int pos,
    int window, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || hd <= 0) return cudaSuccess;
  if (Sc < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qstr{qb, qg, qh}, kstr{kb, ks, kh}, vstr{vb, vs, vh};
  const int* kp = static_cast<const int*>(kpos);
  float* lse = static_cast<float*>(lse_out);
  if (q_dtype == 0 && c_dtype == 0)
    return launch<float, float>(q, k, v, kp, o, lse, B, KV, G, Sc, hd, qstr,
                                kstr, vstr, pos, window, st);
  if (q_dtype == 1 && c_dtype == 0)
    return launch<__nv_bfloat16, float>(q, k, v, kp, o, lse, B, KV, G, Sc,
                                        hd, qstr, kstr, vstr, pos, window,
                                        st);
  if (q_dtype == 1 && c_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, kp, o, lse, B, KV,
                                                G, Sc, hd, qstr, kstr, vstr,
                                                pos, window, st);
  return cudaErrorInvalidValue;
}
