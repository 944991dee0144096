// Mamba-1 selective scan for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/ssm_scan.py
// (ssm_scan_pallas / _ssm_kernel).  For each batch row b and channel d of
// d_inner, from h = 0:
//   h[n] = exp(dt[b,t,d] * A[d,n]) * h[n] + (dt[b,t,d] * x[b,t,d]) * B[b,t,n]
//   y[b,t,d] = sum_n h[n] * C[b,t,n]
// for t = 0 .. S-1; y (B, S, DI) and the final h (B, DI, N) are fp32.
//
// What bounds it on this card.  x, dt and y are (B, S, DI) streams read or
// written once; B and C are (B, S, N) with N = 16, shared by every channel
// of a row.  Each (b, t, d, n) takes one exp, on the SFU (MUFU.EX2, 16 a
// clock an SM), and three FMA-pipe operations.  At hymba-1.5b's prefill
// (B 16, S 64, DI 3200) that is 52.4 M exps, 0.0125 ms at 1.98 GHz, just
// above the 0.0109 ms that its 36 MB take at 3.35 TB/s; at the 1100-token
// prompt (B 2) 113 M exps, 0.027 ms.  But the recurrence is serial in t, so
// what a design must first get out of the way is each step's latency.
//
// Design.  The TPU kernel's sequential chunk axis becomes a loop inside a
// block, its (block_di, N) VMEM scratch the registers of the threads.
//   - A channel's 16 states are split over LANES neighbouring lanes (16 /
//     LANES states a lane), each lane forming its partial of y_t.  Every
//     LANES steps a reduce-scatter over the lanes (LANES - 1 xor shuffles)
//     leaves lane l with step l's y, so no shuffle sits on the steps' chain:
//     the only dependence between steps is h's FMA.  A group of LANES steps
//     first reads its x, dt, B and C and forms its exps, which do not wait
//     on h, so the SFU's work issues back to back.
//   - A block is 128 threads, 128 / LANES channels of one batch row.  Time
//     is cut into chunks of CHUNK steps; each chunk's x, dt, B and C tiles
//     are staged in shared memory with 16-byte cp.async copies,
//     double-buffered, so chunk c + 1 loads while chunk c computes and the
//     step loop reads only shared memory and registers.  Every chunk runs
//     whole, unrolled: steps past S are staged as zeros, which leave h as
//     it is.  y is gathered in shared memory and written a chunk at a time,
//     16 bytes a thread.
//   - exp(dt * A) = 2^(dt * A log2 e) with A scaled once: one FMUL and one
//     SFU ex2 (relative error 2^-22) a state and step.
//   - LANES, 2 or 8, comes from the caller (ssm_scan.ops.scan_lanes, from
//     the card's SM count): 2 where that grid gives every SM four blocks,
//     else 8.  2 lanes take a quarter of the shared-memory reads and
//     shuffles of a channel's step that 8 do, 8 a quarter of the chain a
//     lane runs.  Hymba's prefill (B 16) takes 2: 800 blocks of 64
//     channels, six an SM.  The 1100-token prompt at B 2 takes 8: 400
//     blocks of 16 channels, where the time is one block's chain.  (4
//     lanes, between them, was slower than the one chosen at every shape
//     timed.)
//   - Any S and any DI: rows past S and channels past DI are zero-filled and
//     never stored.  Views whose rows are not 16-byte aligned (DI not a
//     multiple of 4 floats / 8 bf16) take an instantiation that copies
//     element by element.  N is 16, the state size of every Mamba-1
//     configuration in the repo.
//
// The backward (windve_ssm_scan_bwd) replaces no TPU kernel: the JAX package
// differentiates its lax.scan (src/repro/models/layers.py mamba_scan_ref,
// mamba_scan_chunked).  Given dy (and optionally the final state's
// gradient), with e_t = exp(dt_t A) and g_t the gradient of h_t,
//   g_t = C_t dy_t + e_{t+1} g_{t+1},
//   dx_t = dt_t sum_n g_t B_t,  ddt_t = x_t sum_n g_t B_t + sum_n A q_t,
//   dB_t = sum_d g_t dt_t x_t,  dC_t = sum_d dy_t h_t,  dA = sum_{b,t} dt_t q_t
// with q_t = g_t e_t h_{t-1}.  What bounds it: per (b, t, d, n) one exp (the
// kernel forms it twice, in the recompute and in the reverse step) and
// about 19 fp32 flops; at hymba-1.5b's training shape (B 8, S 512, DI 3200)
// 210 M exps, 0.050 ms on the SFU, 0.060 ms of flops, and 0.079 ms for the
// bytes (bf16 x; the forward's chunk states, 52 MB, included).  The kernel
// issues about 122 instructions a warp and step of 128 (channel, state)
// items, and its time follows that issue, not the bytes or the SFU: taking
// out its shuffle sums over n and over channels takes a quarter of it.
//   - The forward, when asked (hs not null), writes the state entering each
//     CHUNK-step chunk, (B, ceil(S / CHUNK), DI, N) fp32.  The backward walks
//     the chunks in reverse; in each it recomputes the chunk's states from
//     the saved one, as the forward formed them, then runs the reverse
//     recurrence.  h_{t-1} is never formed as h_t / e_t: e_t underflows to
//     0 at large |A| dt.
//   - 4 lanes a channel, 4 states a lane, 32 channels a block of 128
//     threads: a lane runs 4 independent recurrences and holds its states'
//     h_{t-1} for the chunk's 16 steps in 64 registers.  Registers are sized
//     for 4 blocks an SM (128 a thread).
//   - x, dt and dy are staged time-major, a channel's row of the chunk's
//     steps, so that a lane reads 4 steps of its channel in one 16-byte
//     load; B and C as (step, state) rows in 4 orders (below).  The next
//     chunk's pieces are read into registers half-way through the reverse
//     and written to the other stage buffer after it: one barrier a chunk.
//   - Every 4 steps, inside the step loops: the sums over n (dx, ddt) by a
//     reduce-scatter over the channel's 4 lanes, which leaves lane l with
//     step l's two sums; the terms of dB and dC by a reduce-scatter over the
//     warp's 8 channels (lane bits 4, 3, 2).  A lane's 4 states sit in its
//     slots permuted by its lane bits 4 and 3, so partners over those bits
//     hold each state in the slot the other sends and two of the three
//     rounds need no selects.  The warps' sums are added in warp order a
//     chunk later, after the barrier, into a per-block partial.
//   - A second kernel sums the partials over the blocks, and dA's per-row
//     partials over the batch, in a fixed order: no float atomics, so two
//     calls give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using namespace ptx;

constexpr int THREADS = 128;
constexpr int N_STATE = 16;        // the state size of every Mamba-1 config
constexpr int CHUNK = 16;          // time steps staged at once
constexpr float LOG2E = 1.4426950408889634f;

// A channel's states split over LANES lanes.
template <int LANES>
struct Lanes {
  static_assert(N_STATE % LANES == 0 && (LANES & (LANES - 1)) == 0
                    && CHUNK % LANES == 0,
                "a power-of-two number of lanes, whole states a lane");
  static constexpr int NL = N_STATE / LANES;     // states a lane
  static constexpr int CH = THREADS / LANES;     // channels a block
  // y rows: a warp's LANES steps x 32 / LANES channels land on distinct banks
  static constexpr int YPITCH = CH + 32 / LANES;
};

__device__ __forceinline__ void set_zero(float& v) { v = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16& v) {
  v = __float2bfloat16_rn(0.f);
}

template <typename X, int CH>
struct Stage {
  __align__(16) X x[CHUNK][CH];
  __align__(16) float dt[CHUNK][CH];
  __align__(16) float B[CHUNK][N_STATE];
  __align__(16) float C[CHUNK][N_STATE];
};

// One 16-byte piece of E from src to dst: a cp.async copy when VEC,
// element copies otherwise; zeros where `ok` is false.
template <typename E, bool VEC>
__device__ __forceinline__ void copy16(E* dst, const E* src, bool ok) {
  constexpr int PER = 16 / sizeof(E);
  if (!ok) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  } else if (VEC) {
    cp_async16(dst, src);
  } else {
#pragma unroll
    for (int e = 0; e < PER; ++e) dst[e] = src[e];
  }
}

// Stage time steps [t0, t0 + CHUNK) of channels [d0, d0 + CH) of row b:
// x and dt tiles (CHUNK, CH) and B and C tiles (CHUNK, N); zeros at or past
// step S and past DI.  Without VEC a 16-byte piece is copied element by element, each
// element masked alone.
template <typename X, int CH, bool VEC>
__device__ __forceinline__ void stage(Stage<X, CH>& s, const X* x,
                                      const float* dt, const float* Bm,
                                      const float* Cm, long long row, int S,
                                      int DI, int d0, int t0) {
  constexpr int XP = 16 / sizeof(X);        // x elements a 16-byte piece
  constexpr int XR = CH / XP, FR = CH / 4, NR = N_STATE / 4;  // pieces a row
  constexpr int PIECES = CHUNK * (XR + FR + 2 * NR);
  for (int i = threadIdx.x; i < PIECES; i += THREADS) {
    int j = i;
    if (j < CHUNK * XR) {                    // x
      const int t = j / XR, c = (j % XR) * XP, tt = t0 + t, d = d0 + c;
      const X* src = x + (row + tt) * DI + d;
      if (VEC || tt >= S || d + XP <= DI) {
        copy16<X, VEC>(&s.x[t][c], src, tt < S && d < DI);
      } else {
        for (int e = 0; e < XP; ++e) {
          if (d + e < DI) s.x[t][c + e] = src[e];
          else set_zero(s.x[t][c + e]);
        }
      }
      continue;
    }
    j -= CHUNK * XR;
    if (j < CHUNK * FR) {                    // dt
      const int t = j / FR, c = (j % FR) * 4, tt = t0 + t, d = d0 + c;
      const float* src = dt + (row + tt) * DI + d;
      if (VEC || tt >= S || d + 4 <= DI) {
        copy16<float, VEC>(&s.dt[t][c], src, tt < S && d < DI);
      } else {
        for (int e = 0; e < 4; ++e) s.dt[t][c + e] = d + e < DI ? src[e] : 0.f;
      }
      continue;
    }
    j -= CHUNK * FR;                         // B, then C: rows of N floats
    const int w = j / (CHUNK * NR);
    j %= CHUNK * NR;
    const int t = j / NR, c = (j % NR) * 4, tt = t0 + t;
    float* dst = w ? &s.C[t][c] : &s.B[t][c];
    copy16<float, VEC>(dst, (w ? Cm : Bm) + (row + tt) * N_STATE + c, tt < S);
  }
}

template <typename X, int LANES, bool VEC>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const X* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ A, float* __restrict__ y,
                float* __restrict__ h_out, float* __restrict__ hs, int S,
                int DI) {
  using L = Lanes<LANES>;
  constexpr int NL = L::NL, CH = L::CH;
  __shared__ Stage<X, CH> st[2];
  __shared__ __align__(16) float ys[CHUNK][L::YPITCH];
  const int b = blockIdx.y, d0 = blockIdx.x * CH;
  const int c = threadIdx.x / LANES, sub = threadIdx.x % LANES;
  const int d = d0 + c;
  const bool active = d < DI;
  const long long row = static_cast<long long>(b) * S;

  float a[NL], h[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    a[j] = active ? A[static_cast<long long>(d) * N_STATE + sub * NL + j]
                        * LOG2E
                  : 0.f;
    h[j] = 0.f;
  }

  const int chunks = (S + CHUNK - 1) / CHUNK;
  if (chunks > 0) stage<X, CH, VEC>(st[0], x, dt, Bm, Cm, row, S, DI, d0, 0);
  cp_async_commit();
  for (int ci = 0; ci < chunks; ++ci) {
    const int t0 = ci * CHUNK, len = min(CHUNK, S - t0);
    if (hs != nullptr && active) {   // the state entering chunk ci
      float* dst = hs + ((static_cast<long long>(b) * chunks + ci) * DI + d)
                            * N_STATE + sub * NL;
#pragma unroll
      for (int j = 0; j < NL; ++j) dst[j] = h[j];
    }
    if (ci + 1 < chunks) {   // the buffer chunk ci + 1 takes was freed at ci - 1
      stage<X, CH, VEC>(st[(ci + 1) & 1], x, dt, Bm, Cm, row, S, DI, d0,
                        t0 + CHUNK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Stage<X, CH>& s = st[ci & 1];
    // Whole chunks: a step past S was staged as zeros and leaves h as it is
    // (2^0 = 1, dt x = 0); its y is not stored.  Every lane runs
    // every step (the shuffles take the whole warp); lanes of channels past
    // DI carry zeros and store nothing.
#pragma unroll
    for (int g = 0; g < CHUNK; g += LANES) {
      // The group's reads and exps first: they do not wait on h, so the
      // SFU's work of LANES steps issues back to back; h's chain is FMAs.
      float e[LANES][NL], w[LANES][NL], cv[LANES][NL];
#pragma unroll
      for (int u = 0; u < LANES; ++u) {
        const int t = g + u;
        const float dtv = s.dt[t][c];
        const float dx = dtv * to_f(s.x[t][c]);
        float bv[NL];              // the lane's states of B_t (and C_t)
        if constexpr (NL % 4 == 0) {
#pragma unroll
          for (int j = 0; j < NL; j += 4) {
            const float4 b4 =
                *reinterpret_cast<const float4*>(&s.B[t][sub * NL + j]);
            const float4 c4 =
                *reinterpret_cast<const float4*>(&s.C[t][sub * NL + j]);
            bv[j] = b4.x, bv[j + 1] = b4.y, bv[j + 2] = b4.z, bv[j + 3] = b4.w;
            cv[u][j] = c4.x, cv[u][j + 1] = c4.y, cv[u][j + 2] = c4.z,
            cv[u][j + 3] = c4.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < NL; ++j) {
            bv[j] = s.B[t][sub * NL + j];
            cv[u][j] = s.C[t][sub * NL + j];
          }
        }
#pragma unroll
        for (int j = 0; j < NL; ++j) {
          e[u][j] = ex2(dtv * a[j]);
          w[u][j] = dx * bv[j];
        }
      }
      float v[LANES];          // the lane's partial y at steps g .. g + LANES
#pragma unroll
      for (int u = 0; u < LANES; ++u) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < NL; ++j) {
          h[j] = fmaf(h[j], e[u][j], w[u][j]);
          acc = fmaf(h[j], cv[u][j], acc);
        }
        v[u] = acc;
      }
      // Reduce-scatter over the channel's lanes, halves first: after the
      // round of mask m a lane holds the sums of m steps, and at the end
      // lane `sub` holds step g + sub's y, (p0 + p2) + (p1 + p3) at 4 lanes.
#pragma unroll
      for (int m = LANES / 2; m >= 1; m /= 2) {
        const bool upper = sub & m;
#pragma unroll
        for (int j = 0; j < m; ++j) {
          const float keep = upper ? v[m + j] : v[j];
          const float send = upper ? v[j] : v[m + j];
          v[j] = keep + __shfl_xor_sync(0xffffffffu, send, m);
        }
      }
      ys[g + sub][c] = v[0];
    }
    __syncthreads();
    // y rows t0 .. t0 + len of the block's channels, 16 bytes a thread
    for (int i = threadIdx.x; i < CHUNK * CH / 4; i += THREADS) {
      const int t = i / (CH / 4), cc = (i % (CH / 4)) * 4, dd = d0 + cc;
      if (t >= len) continue;
      float* dst = y + (row + t0 + t) * DI + dd;
      if (VEC) {
        if (dd < DI)
          *reinterpret_cast<float4*>(dst) =
              *reinterpret_cast<const float4*>(&ys[t][cc]);
      } else {
        for (int e = 0; e < 4; ++e)
          if (dd + e < DI) dst[e] = ys[t][cc + e];
      }
    }
  }
  if (active) {
    float* ho = h_out + (static_cast<long long>(b) * DI + d) * N_STATE
                + sub * NL;
#pragma unroll
    for (int j = 0; j < NL; ++j) ho[j] = h[j];
  }
}

template <typename X, int LANES, bool VEC>
cudaError_t launch(const void* x, const void* dt, const void* Bm,
                   const void* Cm, const void* A, void* y, void* h, void* hs,
                   int B, int S, int DI, cudaStream_t st) {
  constexpr int CH = Lanes<LANES>::CH;
  const dim3 grid((DI + CH - 1) / CH, B);
  ssm_scan_kernel<X, LANES, VEC><<<grid, THREADS, 0, st>>>(
      static_cast<const X*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<const float*>(A), static_cast<float*>(y),
      static_cast<float*>(h), static_cast<float*>(hs), S, DI);
  return cudaGetLastError();
}

template <typename X, int LANES>
cudaError_t launch_as(bool vec, const void* x, const void* dt,
                      const void* Bm, const void* Cm, const void* A, void* y,
                      void* h, void* hs, int B, int S, int DI,
                      cudaStream_t st) {
  return vec ? launch<X, LANES, true>(x, dt, Bm, Cm, A, y, h, hs, B, S, DI,
                                      st)
             : launch<X, LANES, false>(x, dt, Bm, Cm, A, y, h, hs, B, S, DI,
                                       st);
}

template <typename X>
cudaError_t dispatch(const void* x, const void* dt, const void* Bm,
                     const void* Cm, const void* A, void* y, void* h,
                     void* hs, int B, int S, int DI, int lanes,
                     cudaStream_t st) {
  // 16-byte pieces need 16-byte aligned bases and rows of whole pieces
  const void* ptrs[6] = {x, dt, Bm, Cm, y, h};
  bool vec = DI % (16 / sizeof(X)) == 0 && DI % 4 == 0;
  for (const void* p : ptrs)
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  switch (lanes) {
    case 2:
      return launch_as<X, 2>(vec, x, dt, Bm, Cm, A, y, h, hs, B, S, DI, st);
    case 8:
      return launch_as<X, 8>(vec, x, dt, Bm, Cm, A, y, h, hs, B, S, DI, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The backward
// ---------------------------------------------------------------------------

constexpr int BWD_LANES = 4;                     // lanes a channel
constexpr int BWD_NL = N_STATE / BWD_LANES;      // states a lane
constexpr int BWD_CH = 32;                       // channels a block
constexpr int BWD_THREADS = BWD_CH * BWD_LANES;
constexpr int BWD_WARPS = BWD_THREADS / 32;
// blocks an SM the registers are sized for: 128 registers a thread
constexpr int BWD_MIN_BLOCKS = 4;
constexpr int GROUP = 4;                         // steps a reduce-scatter takes
constexpr int TM_PITCH = CHUNK + 4;              // a channel's row of steps
static_assert(BWD_LANES == 4 && BWD_NL == 4 && GROUP == 4 && CHUNK % GROUP == 0,
              "a lane's 4 states as one 16-byte piece; 4 steps a group");
static_assert(CHUNK * BWD_CH / 4 == BWD_THREADS,
              "a thread a 4-channel piece of each tile");

__device__ __forceinline__ void from_f(float v, float& out) { out = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16& out) {
  out = __float2bfloat16_rn(v);
}

// element i (a constant after unrolling) of a float4
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

struct BwdStage {
  // x (as fp32), dt and dy time-major: a channel's row of the chunk's steps,
  // so that a lane reads four steps in one 16-byte load
  __align__(16) float x[BWD_CH][TM_PITCH];
  __align__(16) float dt[BWD_CH][TM_PITCH];
  __align__(16) float dy[BWD_CH][TM_PITCH];
  // B and C rows in 4 orders: in copy p each 4-state piece is permuted,
  // state 4i + (r ^ p) at 4i + r, the order of a lane whose states are
  // permuted by p (warp_channel_sums)
  __align__(16) float B[4][CHUNK][N_STATE];
  __align__(16) float C[4][CHUNK][N_STATE];
};

struct BwdSmem {
  BwdStage st[2];
  // a chunk's sums over each warp's channels of dB's (0) and dC's (1)
  // terms, by (step, state); two chunks' worth, summed over the warps a
  // chunk later
  __align__(16) float red[2][BWD_WARPS][2][CHUNK][N_STATE];
  // the state entering the next chunk, a thread's slots, copied from the
  // forward's saved states a half-chunk ahead
  __align__(16) float4 h0[BWD_THREADS];
};

// 4 elements of x as one load: 16 bytes of fp32, 8 of bf16
template <typename X> struct XWord { using T = uint4; };
template <> struct XWord<__nv_bfloat16> { using T = uint2; };

// A thread's pieces of 4 channels of a chunk's (CHUNK, BWD_CH) tiles of dt,
// dy and x, and of its B and C rows, read from global memory into
// registers and written into shared memory a chunk later.
template <typename X>
struct BwdPieces {
  static constexpr int BCN = 2 * CHUNK * N_STATE / 4;   // B and C pieces
  static constexpr int BCP = (BCN + BWD_THREADS - 1) / BWD_THREADS;
  union XPiece {                  // x's piece held as its bytes
    typename XWord<X>::T u;
    X e[4];
  };
  float dt[4], dy[4];
  XPiece x;
  float bc[BCP][4];
};

// 4 floats of a row from src, zeros past the first n: one 16-byte load
// when VEC and all n are there, element loads otherwise.
template <bool VEC>
__device__ __forceinline__ void read_piece(float (&v)[4], const float* src,
                                           int n) {
  if (VEC && n >= 4) {
    const float4 f = *reinterpret_cast<const float4*>(src);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < n ? src[e] : 0.f;
  }
}

// x's piece: its bytes in one load when VEC and all n are there
template <bool VEC, typename Piece, typename X>
__device__ __forceinline__ void read_piece(Piece& v, const X* src, int n) {
  if (VEC && n >= 4) {
    v.u = *reinterpret_cast<const decltype(v.u)*>(src);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < n) v.e[e] = src[e];
      else set_zero(v.e[e]);
    }
  }
}

// Piece tid of each tile: step tid % CHUNK, 4 channels from (tid / CHUNK)
// * 4.  A warp's pieces cover 16 steps of 8 channels, so the time-major
// stores below fall on 32 distinct banks (TM_PITCH = 20).  Then pieces tid
// (+ BWD_THREADS) of the chunk's B rows and C rows, zeros at or past S.
template <typename X, bool VEC>
__device__ __forceinline__ void read_pieces(BwdPieces<X>& p, const X* x,
                                            const float* dt, const float* dy,
                                            const float* Bm, const float* Cm,
                                            long long row, int S, int DI,
                                            int d0, int t0, int tid) {
  using P = BwdPieces<X>;
  const int t = tid % CHUNK, tt = t0 + t;
  const long long off = (row + tt) * DI;
  const int d = d0 + (tid / CHUNK) * 4;
  const int n = tt < S ? DI - d : 0;
  read_piece<VEC>(p.dt, dt + off + d, n);
  read_piece<VEC>(p.dy, dy + off + d, n);
  read_piece<VEC>(p.x, x + off + d, n);
#pragma unroll
  for (int m = 0; m < P::BCP; ++m) {
    const int i = tid + m * BWD_THREADS;
    const int j = i % (P::BCN / 2), tb = t0 + j / (N_STATE / 4);
    if (i < P::BCN)
      read_piece<VEC>(p.bc[m], (i < P::BCN / 2 ? Bm : Cm)
                                   + (row + tb) * N_STATE
                                   + (j % (N_STATE / 4)) * 4,
                      tb < S ? 4 : 0);
  }
}

template <typename X>
__device__ __forceinline__ void write_pieces(BwdStage& s,
                                             const BwdPieces<X>& p, int tid) {
  using P = BwdPieces<X>;
  const int t = tid % CHUNK, c = (tid / CHUNK) * 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    s.dt[c + e][t] = p.dt[e];
    s.dy[c + e][t] = p.dy[e];
    s.x[c + e][t] = to_f(p.x.e[e]);
  }
  // B and C in their 4 orders
#pragma unroll
  for (int m = 0; m < P::BCP; ++m) {
    const int i = tid + m * BWD_THREADS;
    const int j = i % (P::BCN / 2), tb = j / (N_STATE / 4);
    const int n = (j % (N_STATE / 4)) * 4;
    if (i < P::BCN) {
      float (&dst)[4][CHUNK][N_STATE] = i < P::BCN / 2 ? s.B : s.C;
      const float* v = p.bc[m];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float4*>(&dst[q][tb][n]) =
            make_float4(v[q], v[1 ^ q], v[2 ^ q], v[3 ^ q]);
    }
  }
}

// One round of a reduce-scatter over the lanes that differ in lane bit M,
// then the rounds of M / 2 down to LO.  v holds 2 * HALF values; the lane
// with bit M set keeps the upper half, adds its partner's upper half to it
// and sends its lower half.  After the last round v[0 .. HALF_last) hold
// the sums of the values at flat indices from the sum over rounds of (bit
// set ? HALF : 0).
template <int HALF, int M, int LO, int V>
__device__ __forceinline__ void reduce_scatter(float (&v)[V], int lane) {
  const bool upper = lane & M;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float keep = upper ? v[HALF + j] : v[j];
    const float send = upper ? v[j] : v[HALF + j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
  if constexpr (M / 2 >= LO) reduce_scatter<HALF / 2, M / 2, LO>(v, lane);
}

// A group's terms of dB or dC, v[u * 4 + r] for step u and the lane's
// slot r, summed over the warp's 8 channels (lane bits 4, 3, 2).  Slot r
// holds state n0 + (r ^ p) with p = lane bits 4 and 3, so partners over
// bits 4 and 3 hold each state in the slot the other sends, and those two
// rounds need no selects: each lane keeps slots 0 and 1, then slot 0, its
// state n = n0 + p.  The round over bit 2 splits the steps; the lane ends
// with steps 2 * (bit 2) + {0, 1} of its state, written to the warp's row.
__device__ __forceinline__ void warp_channel_sums(
    float (&v)[GROUP * BWD_NL], float (&out)[CHUNK][N_STATE], int k, int n,
    int lane) {
#pragma unroll
  for (int u = 0; u < GROUP; ++u) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      v[u * 4 + r] += __shfl_xor_sync(0xffffffffu, v[u * 4 + 2 + r], 16);
    v[u * 4] += __shfl_xor_sync(0xffffffffu, v[u * 4 + 1], 8);
  }
  float w[GROUP] = {v[0], v[4], v[8], v[12]};
  reduce_scatter<GROUP / 2, 4, 4>(w, lane);
  const int t = k * GROUP + 2 * ((lane >> 2) & 1);
  out[t][n] = w[0];
  out[t + 1][n] = w[1];
}

// The block's partial of a chunk's dB and dC: each warp's sums added in
// warp order, a 16-byte piece a thread.
__device__ __forceinline__ void flush_partials(
    const float (&red)[BWD_WARPS][2][CHUNK][N_STATE], float* part, int B,
    int S, int b, int t0, int tid) {
  constexpr int Q = CHUNK * N_STATE / 4;         // pieces of dB (and of dC)
  for (int i = tid; i < 2 * Q; i += BWD_THREADS) {
    const int w = i / Q, t = (i % Q) / (N_STATE / 4);
    const int n = (i % (N_STATE / 4)) * 4;
    if (t0 + t >= S) continue;
    float4 sum = *reinterpret_cast<const float4*>(&red[0][w][t][n]);
#pragma unroll
    for (int k = 1; k < BWD_WARPS; ++k) {
      const float4 p = *reinterpret_cast<const float4*>(&red[k][w][t][n]);
      sum.x += p.x, sum.y += p.y, sum.z += p.z, sum.w += p.w;
    }
    *reinterpret_cast<float4*>(
        part + ((static_cast<long long>(w * gridDim.x + blockIdx.x) * B + b)
                    * S + t0 + t) * N_STATE + n) = sum;
  }
}

template <typename X, bool VEC>
__global__ void __launch_bounds__(BWD_THREADS, BWD_MIN_BLOCKS)
ssm_scan_bwd_kernel(const X* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ Bm, const float* __restrict__ Cm,
                    const float* __restrict__ A, const float* __restrict__ dy,
                    const float* __restrict__ dh_final,
                    const float* __restrict__ hs, X* __restrict__ dx,
                    float* __restrict__ ddt, float* __restrict__ part,
                    float* __restrict__ dA_part, int B, int S, int DI) {
  constexpr int NL = BWD_NL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, d0 = blockIdx.x * BWD_CH;
  const int c = tid / BWD_LANES, sub = tid % BWD_LANES, n0 = sub * NL;
  // slot j of the lane's states holds state n0 + (j ^ p) (warp_channel_sums)
  const int p = (lane >> 3) & 3;
  const int d = d0 + c;
  const bool active = d < DI;
  const long long row = static_cast<long long>(b) * S;
  const long long hidx = (static_cast<long long>(b) * DI + d) * N_STATE + n0;
  // G = e_{t+1} g_{t+1}: the gradient h_t takes from later steps
  float a[NL], a2[NL], G[NL], dA[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    a[j] = active ? A[static_cast<long long>(d) * N_STATE + n0 + (j ^ p)]
                  : 0.f;
    a2[j] = a[j] * LOG2E;
    G[j] = active && dh_final != nullptr ? dh_final[hidx + (j ^ p)] : 0.f;
    dA[j] = 0.f;
  }

  const int chunks = (S + CHUNK - 1) / CHUNK;
  // the state entering chunk ci, as the forward saved it, into the
  // thread's slots of sm.h0 by 4-byte cp.async copies
  auto saved_state = [&](int ci) {
    const float* src = hs + ((static_cast<long long>(b) * chunks + ci) * DI
                             + d) * N_STATE + n0;
    float* dst = reinterpret_cast<float*>(&sm.h0[tid]);
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      if (active) cp_async4(dst + j, src + (j ^ p));
      else dst[j] = 0.f;
    }
    cp_async_commit();
  };
  BwdPieces<X> pc;
  if (chunks > 0) {
    const int t0 = (chunks - 1) * CHUNK;
    read_pieces<X, VEC>(pc, x, dt, dy, Bm, Cm, row, S, DI, d0, t0, tid);
    write_pieces(sm.st[(chunks - 1) & 1], pc, tid);
    saved_state(chunks - 1);
  }
  for (int ci = chunks - 1; ci >= 0; --ci) {
    const int t0 = ci * CHUNK;
    // The one barrier a chunk: chunk ci's tiles are staged, chunk ci + 1's
    // warp sums written, and chunk ci + 1's stage buffer is free.
    cp_async_wait<0>();
    __syncthreads();
    const BwdStage& s = sm.st[ci & 1];
    if (ci + 1 < chunks)
      flush_partials(sm.red[(ci + 1) & 1], part, B, S, b, t0 + CHUNK, tid);
    float (&red)[BWD_WARPS][2][CHUNK][N_STATE] = sm.red[ci & 1];

    // The chunk's states, formed as the forward forms them: hr[t] = h_{t-1}.
    // Steps past S were staged as zeros: e = 1 and nothing added, so h, and
    // in the reverse g, pass through them unchanged.
    float hr[CHUNK][NL];
    const float4 h04 = sm.h0[tid];
    float h[NL] = {h04.x, h04.y, h04.z, h04.w};
#pragma unroll
    for (int k = 0; k < CHUNK / GROUP; ++k) {
      const float4 dt4 = *reinterpret_cast<const float4*>(&s.dt[c][k * GROUP]);
      const float4 x4 = *reinterpret_cast<const float4*>(&s.x[c][k * GROUP]);
      const float4 dy4 = *reinterpret_cast<const float4*>(&s.dy[c][k * GROUP]);
      float v[GROUP * NL];                       // dC's terms dy_t h_t
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        const int t = k * GROUP + u;
        const float dtv = at(dt4, u), dtx = dtv * at(x4, u);
        const float4 b4 = *reinterpret_cast<const float4*>(&s.B[p][t][n0]);
#pragma unroll
        for (int j = 0; j < NL; ++j) hr[t][j] = h[j];
#pragma unroll
        for (int j = 0; j < NL; ++j) {
          h[j] = fmaf(h[j], ex2(dtv * a2[j]), dtx * at(b4, j));
          v[u * NL + j] = at(dy4, u) * h[j];
        }
      }
      warp_channel_sums(v, red[warp][1], k, n0 + p, lane);
    }

    // The reverse recurrence, each step's exp formed again.  The next
    // chunk's tiles are read into registers half-way, once the upper half's
    // held states are spent, and its state is copied into sm.h0.
#pragma unroll
    for (int k = CHUNK / GROUP - 1; k >= 0; --k) {
      if (k == CHUNK / GROUP / 2 - 1 && ci > 0) {
        read_pieces<X, VEC>(pc, x, dt, dy, Bm, Cm, row, S, DI, d0,
                            t0 - CHUNK, tid);
        saved_state(ci - 1);
      }
      const float4 dt4 = *reinterpret_cast<const float4*>(&s.dt[c][k * GROUP]);
      const float4 x4 = *reinterpret_cast<const float4*>(&s.x[c][k * GROUP]);
      const float4 dy4 = *reinterpret_cast<const float4*>(&s.dy[c][k * GROUP]);
      float v[GROUP * NL];                       // dB's terms g_t dt_t x_t
      float sn[GROUP * 2];   // a step's sum_n g B and sum_n A q, lane's part
#pragma unroll
      for (int u = GROUP - 1; u >= 0; --u) {
        const int t = k * GROUP + u;
        const float dtv = at(dt4, u), dtx = dtv * at(x4, u), dyv = at(dy4, u);
        const float4 b4 = *reinterpret_cast<const float4*>(&s.B[p][t][n0]);
        const float4 c4 = *reinterpret_cast<const float4*>(&s.C[p][t][n0]);
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int j = 0; j < NL; ++j) {
          const float g = fmaf(at(c4, j), dyv, G[j]);
          const float ge = g * ex2(dtv * a2[j]);
          const float q = ge * hr[t][j];
          s1 = j ? fmaf(g, at(b4, j), s1) : g * at(b4, j);
          s2 = j ? fmaf(a[j], q, s2) : a[j] * q;
          dA[j] = fmaf(dtv, q, dA[j]);
          v[u * NL + j] = g * dtx;
          G[j] = ge;
        }
        sn[2 * u] = s1, sn[2 * u + 1] = s2;
      }
      // over the channel's 4 lanes (bits 1, 0): lane sub ends with step
      // k * GROUP + sub's sums; its dx and ddt
      reduce_scatter<GROUP, 2, 1>(sn, lane);
      const int t = k * GROUP + sub, tt = t0 + t;
      if (active && tt < S) {
        const long long o = (row + tt) * DI + d;
        from_f(s.dt[c][t] * sn[0], dx[o]);
        ddt[o] = fmaf(s.x[c][t], sn[0], sn[1]);
      }
      warp_channel_sums(v, red[warp][0], k, n0 + p, lane);
    }
    if (ci > 0) write_pieces(sm.st[(ci - 1) & 1], pc, tid);
  }
  __syncthreads();
  if (chunks > 0) flush_partials(sm.red[0], part, B, S, b, 0, tid);
  if (active) {
#pragma unroll
    for (int j = 0; j < NL; ++j) dA_part[hidx + (j ^ p)] = dA[j];
  }
}

// dB and dC: the blocks' partials summed over the channel blocks in order;
// dA: the partials summed over the batch in order.  A thread a 16-byte
// piece (4 states), its loads unrolled so that several are in flight.
__global__ void __launch_bounds__(256)
ssm_scan_bwd_sums(const float4* __restrict__ part,
                  const float4* __restrict__ dA_part, float4* __restrict__ dB,
                  float4* __restrict__ dC, float4* __restrict__ dA, int blocks,
                  int B, int S, int DI) {
  const long long nb = static_cast<long long>(B) * S * N_STATE / 4;
  const long long na = static_cast<long long>(DI) * N_STATE / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       i < 2 * nb + na; i += stride) {
    const bool ab = i < 2 * nb, w = i >= nb;
    const long long j = ab ? (w ? i - nb : i) : i - 2 * nb;
    const float4* p = ab ? part + (w ? blocks * nb : 0) + j : dA_part + j;
    const long long step = ab ? nb : na;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int k = 0; k < (ab ? blocks : B); ++k) {
      const float4 v = p[k * step];
      sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
    }
    (ab ? (w ? dC : dB) : dA)[j] = sum;
  }
}

template <typename X, bool VEC>
cudaError_t launch_bwd(const void* x, const void* dt, const void* Bm,
                       const void* Cm, const void* A, const void* dy,
                       const void* dh_final, const void* hs, void* dx,
                       void* ddt, float* part, float* dA_part, int B, int S,
                       int DI, cudaStream_t st) {
  constexpr size_t smem = sizeof(BwdSmem);
  const dim3 grid((DI + BWD_CH - 1) / BWD_CH, B);
  auto kernel = ssm_scan_bwd_kernel<X, VEC>;
  const cudaError_t err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, BWD_THREADS, smem, st>>>(
      static_cast<const X*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<const float*>(A), static_cast<const float*>(dy),
      static_cast<const float*>(dh_final), static_cast<const float*>(hs),
      static_cast<X*>(dx), static_cast<float*>(ddt), part, dA_part, B, S,
      DI);
  return cudaGetLastError();
}

template <typename X>
cudaError_t dispatch_bwd(const void* x, const void* dt, const void* Bm,
                         const void* Cm, const void* A, const void* dy,
                         const void* dh_final, const void* hs, void* dx,
                         void* ddt, void* dB, void* dC, void* dA, void* part,
                         void* dA_part, int B, int S, int DI,
                         cudaStream_t st) {
  float* pt = static_cast<float*>(part);
  float* pa = static_cast<float*>(dA_part);
  if (B > 0) {
    // staged reads in 16-byte pieces: aligned bases, rows of whole pieces
    const void* ptrs[5] = {x, dt, dy, Bm, Cm};
    bool vec = DI % (16 / sizeof(X)) == 0 && DI % 4 == 0;
    for (const void* p : ptrs)
      vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    const cudaError_t err =
        vec ? launch_bwd<X, true>(x, dt, Bm, Cm, A, dy, dh_final, hs, dx,
                                  ddt, pt, pa, B, S, DI, st)
            : launch_bwd<X, false>(x, dt, Bm, Cm, A, dy, dh_final, hs, dx,
                                   ddt, pt, pa, B, S, DI, st);
    if (err != cudaSuccess) return err;
  }
  const long long total =
      (2LL * B * S + static_cast<long long>(DI)) * N_STATE / 4;
  const long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  ssm_scan_bwd_sums<<<blocks, 256, 0, st>>>(
      reinterpret_cast<const float4*>(pt),
      reinterpret_cast<const float4*>(pa), static_cast<float4*>(dB),
      static_cast<float4*>(dC), static_cast<float4*>(dA),
      (DI + BWD_CH - 1) / BWD_CH, B, S, DI);
  return cudaGetLastError();
}

}  // namespace

// x (B, S, DI) contiguous, dtype 0 = float32, 1 = bfloat16; dt (B, S, DI),
// Bm and Cm (B, S, 16), A (DI, 16), all float32 contiguous; y (B, S, DI)
// and h (B, DI, 16) float32 outputs; hs null, or a float32 output of
// (B, ceil(S / 16), DI, 16) for the state entering each 16-step chunk (the
// backward's input); lanes (2 or 8) a channel.  Launches on `stream` and
// returns the launch's cudaError_t.
extern "C" int windve_ssm_scan(const void* x, const void* dt, const void* Bm,
                               const void* Cm, const void* A, void* y,
                               void* h, void* hs, int dtype, int B, int S,
                               int DI, int lanes, void* stream) {
  if (B <= 0 || DI <= 0) return cudaSuccess;
  if (S < 0 || B > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, dt, Bm, Cm, A, y, h, hs, B, S, DI, lanes, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, dt, Bm, Cm, A, y, h, hs, B, S, DI,
                                   lanes, st);
  return cudaErrorInvalidValue;
}

// Channels a block of windve_ssm_scan_bwd takes: its dB / dC workspace
// holds 2 x ceil(DI / this) x B x S x 16 floats.
extern "C" int windve_ssm_scan_bwd_channels() { return BWD_CH; }

// The gradients of windve_ssm_scan's (y, h) given dy (B, S, DI) float32 and
// dh_final (B, DI, 16) float32 or null (zero), from the forward's inputs and
// its chunk states hs.  All contiguous; outputs dx (B, S, DI) in x's dtype,
// ddt (B, S, DI), dB and dC (B, S, 16) and dA (DI, 16) float32; workspaces
// part (2 x ceil(DI / 32) x B x S x 16 floats) and dA_part (B x DI x 16);
// dB, dC, dA and the workspaces 16-byte aligned.
// Two launches on `stream`; returns their cudaError_t.
extern "C" int windve_ssm_scan_bwd(const void* x, const void* dt,
                                   const void* Bm, const void* Cm,
                                   const void* A, const void* dy,
                                   const void* dh_final, const void* hs,
                                   void* dx, void* ddt, void* dB, void* dC,
                                   void* dA, void* part, void* dA_part,
                                   int dtype, int B, int S, int DI,
                                   void* stream) {
  if (DI <= 0) return cudaSuccess;
  if (B < 0 || S < 0 || B > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bwd<float>(x, dt, Bm, Cm, A, dy, dh_final, hs, dx, ddt,
                               dB, dC, dA, part, dA_part, B, S, DI, st);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(x, dt, Bm, Cm, A, dy, dh_final, hs,
                                       dx, ddt, dB, dC, dA, part, dA_part, B,
                                       S, DI, st);
  return cudaErrorInvalidValue;
}
