// PTX helpers shared by the attention kernels (flash_attention.cu and
// flash_attention_bwd.cu) and the selective scan (ssm_scan.cu):
// shared-memory addresses, cp.async copies, ldmatrix, the bf16
// mma.sync.m16n8k16 with fp32 accumulators, the SFU's exp2, fp32 from an
// element, bf16 packing, and the exact three-term bf16 split of an fp32
// value with the order of its six significant products.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ptx {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// one 4-byte element (an fp32 row statistic), through L1
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
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

// 2^x, the SFU's approximation (relative error 2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// two fp32 values rounded to bf16, lo in the low half
__device__ __forceinline__ unsigned pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// x with its low 16 bits cleared: x truncated to bf16, as an fp32
__device__ __forceinline__ float bf16_top(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

// x = t[0] + t[1] + t[2] exactly, each term a bf16 value: each truncates
// what the ones before left
__device__ __forceinline__ void split3(float x, float (&t)[3]) {
  t[0] = bf16_top(x);
  const float r = x - t[0];
  t[1] = bf16_top(r);
  t[2] = r - t[1];
}

// two bf16 values held as fp32 (low 16 bits zero), lo in the low half
__device__ __forceinline__ unsigned pack_exact(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}

// The products of a split k-step, small to large, as (A term, B term) with
// h 0, m 1, l 2: l*h, h*l, m*m, m*h, h*m, h*h.  bf16 takes the last alone.
__host__ __device__ constexpr int term_a(int i) {
  return i == 0 ? 2 : (i == 2 || i == 3) ? 1 : 0;
}
__host__ __device__ constexpr int term_b(int i) {
  return i == 1 ? 2 : (i == 2 || i == 4) ? 1 : 0;
}

}  // namespace ptx
