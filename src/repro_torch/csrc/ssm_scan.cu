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
// bytes (bf16 x; the forward's chunk states, 52 MB, included).  As written
// it takes about 13 times that: its variants in blocks an SM, channels a
// block and exps formed once or twice all time alike, so neither occupancy
// nor the SFU sets it.  Suspects, not yet measured: about nine shared-memory
// reads and two stores a thread and step, and three barriers a chunk.
//   - The forward, when asked (hs not null), writes the state entering each
//     CHUNK-step chunk, (B, ceil(S / CHUNK), DI, N) fp32.  The backward walks
//     the chunks in reverse; in each it recomputes the chunk's states from
//     the saved one, as the forward formed them, into registers, then runs
//     the reverse recurrence.  h_{t-1} is never formed as h_t / e_t: e_t
//     underflows to 0 at large |A| dt.
//   - A thread holds one (channel, state): 32 channels x 16 states a block
//     of 512 threads, so a chunk's 16 states fit its registers.
//     x, dt, dy, B and C are staged a chunk ahead by cp.async, as in the
//     forward.  The sums over n (dx, ddt) are a reduce-scatter over a
//     channel's 16 lanes once a chunk, which leaves lane n with step n's
//     sums; dx and ddt rows are written through shared memory.
//   - The sums over d (dB, dC) go through shared memory: each block sums its
//     32 channels in order and writes a partial per (block, b, t, n); dA's
//     partials are per (b, d, n).  A second kernel sums the partials over
//     the blocks, and dA's over the batch, in a fixed order: no float
//     atomics, so two calls give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void set_zero(float& v) { v = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16& v) {
  v = __float2bfloat16_rn(0.f);
}

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

// 2^x, the SFU's approximation (relative error 2^-22; 2^0 is exactly 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

constexpr int BWD_CH = 32;                       // channels a block
constexpr int BWD_THREADS = BWD_CH * N_STATE;    // a thread a (channel, state)
constexpr int BWD_MIN_BLOCKS = 2;                // blocks an SM, for registers
// a step's row of (channel, state) partials, padded so that the reducing
// threads of two steps fall on different banks
constexpr int RED_PITCH = BWD_CH * N_STATE + 16;
constexpr int OUT_PITCH = BWD_CH + 1;            // dx and ddt rows

__device__ __forceinline__ void from_f(float v, float& out) { out = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16& out) {
  out = __float2bfloat16_rn(v);
}

template <typename X>
struct BwdStage {
  __align__(16) X x[CHUNK][BWD_CH];
  __align__(16) float dt[CHUNK][BWD_CH];
  __align__(16) float dy[CHUNK][BWD_CH];
  __align__(16) float B[CHUNK][N_STATE];
  __align__(16) float C[CHUNK][N_STATE];
};

template <typename X>
struct BwdSmem {
  BwdStage<X> st[2];
  float red[2][CHUNK][RED_PITCH];   // dB's, then dC's (step, channel, state)
  float sdx[CHUNK][OUT_PITCH];
  float sddt[CHUNK][OUT_PITCH];
};

// Piece i of a (CHUNK, CH) tile of a (rows, DI) stream: steps [t0, t0 +
// CHUNK) of channels [d0, d0 + CH), zeros at or past step S and past DI.
template <typename E, int CH, bool VEC>
__device__ __forceinline__ void stage_tile(E (*dst)[CH], const E* src,
                                           long long row, int S, int DI,
                                           int d0, int t0, int i) {
  constexpr int P = 16 / sizeof(E), R = CH / P;
  const int t = i / R, c = (i % R) * P, tt = t0 + t, d = d0 + c;
  const E* s = src + (row + tt) * DI + d;
  if (VEC || tt >= S || d + P <= DI) {
    copy16<E, VEC>(&dst[t][c], s, tt < S && d < DI);
  } else {
    for (int e = 0; e < P; ++e) {
      if (d + e < DI) dst[t][c + e] = s[e];
      else set_zero(dst[t][c + e]);
    }
  }
}

template <typename X, bool VEC>
__device__ __forceinline__ void stage_bwd(BwdStage<X>& s, const X* x,
                                          const float* dt, const float* dy,
                                          const float* Bm, const float* Cm,
                                          long long row, int S, int DI,
                                          int d0, int t0) {
  constexpr int NX = CHUNK * BWD_CH * static_cast<int>(sizeof(X)) / 16;
  constexpr int NF = CHUNK * BWD_CH / 4, NN = CHUNK * N_STATE / 4;
  for (int i = threadIdx.x; i < NX + 2 * NF + 2 * NN; i += BWD_THREADS) {
    int j = i;
    if (j < NX) {
      stage_tile<X, BWD_CH, VEC>(s.x, x, row, S, DI, d0, t0, j);
    } else if ((j -= NX) < 2 * NF) {
      const bool w = j >= NF;
      stage_tile<float, BWD_CH, VEC>(w ? s.dy : s.dt, w ? dy : dt, row, S,
                                     DI, d0, t0, w ? j - NF : j);
    } else {
      j -= 2 * NF;
      const bool w = j >= NN;
      if (w) j -= NN;
      const int t = j / (N_STATE / 4), c = (j % (N_STATE / 4)) * 4;
      const int tt = t0 + t;
      copy16<float, VEC>(w ? &s.C[t][c] : &s.B[t][c],
                         (w ? Cm : Bm) + (row + tt) * N_STATE + c, tt < S);
    }
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<X>& sm = *reinterpret_cast<BwdSmem<X>*>(smem_raw);
  const int b = blockIdx.y, d0 = blockIdx.x * BWD_CH;
  const int c = threadIdx.x / N_STATE, n = threadIdx.x % N_STATE;
  const int d = d0 + c;
  const bool active = d < DI;
  const long long row = static_cast<long long>(b) * S;
  const long long hidx = (static_cast<long long>(b) * DI + d) * N_STATE + n;
  const float a = active ? A[static_cast<long long>(d) * N_STATE + n] : 0.f;
  const float a2 = a * LOG2E;
  // G = e_{t+1} g_{t+1}: the gradient h_t takes from later steps
  float G = active && dh_final != nullptr ? dh_final[hidx] : 0.f;
  float dA_acc = 0.f;

  const int chunks = (S + CHUNK - 1) / CHUNK;
  // the state entering chunk ci, as the forward saved it
  auto saved_state = [&](int ci) {
    return active ? hs[((static_cast<long long>(b) * chunks + ci) * DI + d)
                           * N_STATE + n]
                  : 0.f;
  };
  float h_next = chunks > 0 ? saved_state(chunks - 1) : 0.f;
  if (chunks > 0)
    stage_bwd<X, VEC>(sm.st[(chunks - 1) & 1], x, dt, dy, Bm, Cm, row, S, DI,
                      d0, (chunks - 1) * CHUNK);
  cp_async_commit();
  for (int ci = chunks - 1; ci >= 0; --ci) {
    const int t0 = ci * CHUNK;
    const float h0 = h_next;                 // loaded a chunk ahead
    if (ci > 0) {      // the buffer chunk ci - 1 takes was freed at ci + 1
      h_next = saved_state(ci - 1);
      stage_bwd<X, VEC>(sm.st[(ci - 1) & 1], x, dt, dy, Bm, Cm, row, S, DI,
                        d0, t0 - CHUNK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const BwdStage<X>& s = sm.st[ci & 1];
    // The chunk's states, formed as the forward forms them: hh[t] = h_{t-1}.
    // Steps past S were staged as zeros: e = 1 and nothing added, so h, and
    // in the reverse g, pass through them unchanged.
    float hh[CHUNK + 1];
    hh[0] = h0;
#pragma unroll
    for (int t = 0; t < CHUNK; ++t) {
      const float dtv = s.dt[t][c];
      const float dxv = dtv * to_f(s.x[t][c]);
      hh[t + 1] = fmaf(hh[t], ex2(dtv * a2), dxv * s.B[t][n]);
      sm.red[1][t][c * N_STATE + n] = s.dy[t][c] * hh[t + 1];   // dC's
    }
    // The reverse recurrence, each step's exp formed again (holding the
    // recompute's took 16 more registers and timed the same); v1, v2: the
    // lane's terms of sum_n g B and sum_n A q at each step.
    float v1[CHUNK], v2[CHUNK];
#pragma unroll
    for (int t = CHUNK - 1; t >= 0; --t) {
      const float dtv = s.dt[t][c];
      const float et = ex2(dtv * a2);
      const float g = fmaf(s.C[t][n], s.dy[t][c], G);
      const float q = g * et * hh[t];
      v1[t] = g * s.B[t][n];
      v2[t] = a * q;
      dA_acc = fmaf(dtv, q, dA_acc);
      sm.red[0][t][c * N_STATE + n] = g * (dtv * to_f(s.x[t][c]));  // dB's
      G = et * g;
    }
    // Reduce-scatter over the channel's 16 lanes, halves first: lane n ends
    // with step n's sums.
#pragma unroll
    for (int m = N_STATE / 2; m >= 1; m /= 2) {
      const bool upper = n & m;
#pragma unroll
      for (int j = 0; j < m; ++j) {
        const float k1 = upper ? v1[m + j] : v1[j];
        const float s1 = upper ? v1[j] : v1[m + j];
        const float k2 = upper ? v2[m + j] : v2[j];
        const float s2 = upper ? v2[j] : v2[m + j];
        v1[j] = k1 + __shfl_xor_sync(0xffffffffu, s1, m);
        v2[j] = k2 + __shfl_xor_sync(0xffffffffu, s2, m);
      }
    }
    sm.sdx[n][c] = s.dt[n][c] * v1[0];
    sm.sddt[n][c] = fmaf(to_f(s.x[n][c]), v1[0], v2[0]);
    __syncthreads();
    // dx and ddt rows: a thread an element of the (CHUNK, BWD_CH) tile
    for (int i = threadIdx.x; i < CHUNK * BWD_CH; i += BWD_THREADS) {
      const int t = i / BWD_CH, cc = i % BWD_CH, tt = t0 + t, dd = d0 + cc;
      if (tt < S && dd < DI) {
        from_f(sm.sdx[t][cc], dx[(row + tt) * DI + dd]);
        ddt[(row + tt) * DI + dd] = sm.sddt[t][cc];
      }
    }
    // dB's and dC's partials: a thread a (which, step, state), its sum over
    // the block's channels in order
    for (int i = threadIdx.x; i < 2 * CHUNK * N_STATE; i += BWD_THREADS) {
      const int w = i / (CHUNK * N_STATE), r = i % (CHUNK * N_STATE);
      const int t = r / N_STATE, nn = r % N_STATE;
      float sum = 0.f;
#pragma unroll 8
      for (int k = 0; k < BWD_CH; ++k) sum += sm.red[w][t][k * N_STATE + nn];
      if (t0 + t < S)
        part[(((static_cast<long long>(w) * gridDim.x + blockIdx.x) * B + b)
                  * S + t0 + t) * N_STATE + nn] = sum;
    }
    __syncthreads();   // the stage buffer, red and the rows are reused
  }
  if (active) dA_part[hidx] = dA_acc;
}

// dB and dC: the blocks' partials summed over the channel blocks in order;
// dA: the partials summed over the batch in order.
__global__ void __launch_bounds__(256)
ssm_scan_bwd_sums(const float* __restrict__ part,
                  const float* __restrict__ dA_part, float* __restrict__ dB,
                  float* __restrict__ dC, float* __restrict__ dA, int blocks,
                  int B, int S, int DI) {
  const long long nb = static_cast<long long>(B) * S * N_STATE;
  const long long na = static_cast<long long>(DI) * N_STATE;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       i < 2 * nb + na; i += stride) {
    float sum = 0.f;
    if (i < 2 * nb) {
      const bool w = i >= nb;
      const long long j = w ? i - nb : i;
      const float* p = part + (w ? blocks * nb : 0) + j;
      for (int k = 0; k < blocks; ++k) sum += p[k * nb];
      (w ? dC : dB)[j] = sum;
    } else {
      const long long j = i - 2 * nb;
      for (int k = 0; k < B; ++k) sum += dA_part[k * na + j];
      dA[j] = sum;
    }
  }
}

template <typename X, bool VEC>
cudaError_t launch_bwd(const void* x, const void* dt, const void* Bm,
                       const void* Cm, const void* A, const void* dy,
                       const void* dh_final, const void* hs, void* dx,
                       void* ddt, float* part, float* dA_part, int B, int S,
                       int DI, cudaStream_t st) {
  constexpr size_t smem = sizeof(BwdSmem<X>);     // 88 KB in fp32
  const cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<X, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((DI + BWD_CH - 1) / BWD_CH, B);
  ssm_scan_bwd_kernel<X, VEC><<<grid, BWD_THREADS, smem, st>>>(
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
      (2LL * B * S + static_cast<long long>(DI)) * N_STATE;
  const long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  ssm_scan_bwd_sums<<<blocks, 256, 0, st>>>(
      pt, pa, static_cast<float*>(dB), static_cast<float*>(dC),
      static_cast<float*>(dA), (DI + BWD_CH - 1) / BWD_CH, B, S, DI);
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
// part (2 x ceil(DI / 32) x B x S x 16 floats) and dA_part (B x DI x 16).
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
