// PTX building blocks of the tensor-core kernels (sm_90a): asynchronous
// global-to-shared copies (cp.async), ldmatrix, the warp-level bf16
// product mma.sync.m16n8k16 with f32 accumulators, and the conversions
// that feed it.
//
// Fragment layouts of mma.m16n8k16.row.col (lane = 4 * g + c, g = lane / 4,
// c = lane % 4), each 32-bit register holding two bf16 with the lower
// column (or k) in its low half:
//   A (16 x 16): a0 = (row g, k 2c..2c+1), a1 = (row g + 8, k 2c..),
//                a2 = (row g, k 2c+8..),   a3 = (row g + 8, k 2c+8..)
//   B (16 x 8):  b0 = (k 2c..2c+1, col g), b1 = (k 2c+8..2c+9, col g)
//   C (16 x 8):  c0, c1 = (row g, cols 2c, 2c+1), c2, c3 = (row g + 8, ...)

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in flight until cp_async_wait; with pred
// false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a * b on the tensor cores: bf16 operands, f32 accumulators. Not
// volatile: a pure function of registers, so the compiler may issue the
// next fragments' loads (volatile, kept in order) ahead of it
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two f16 rounded to bf16 (an f16 x is computed as bf16, as the FMA kernel does)
__device__ __forceinline__ uint32_t half2_to_bf16x2(uint32_t r) {
  const float2 f = __half22float2(*reinterpret_cast<__half2*>(&r));
  return pack_bf16(f.x, f.y);
}

// Byte T of w0 and byte T of w1, int8 values, as exact bf16, {lo: w0, hi:
// w1}. With u = x & 0x7F and s = x & 0x80 (x = u - 2 s): the bf16 with
// bits 0x4300 | u is 128 + u, the one with bits 0x4300 | s is 128 + 2 s,
// and their difference, an integer of at most 8 significant bits, is x
// exactly. One byte permute (the other two bytes are masked off), two
// logic ops and one bf16x2 subtraction.
// The int8 values in bytes 0 and 2 of t (bytes 1 and 3 are ignored).
__device__ __forceinline__ uint32_t s8_bytes02_to_bf16x2(uint32_t t) {
  const uint32_t a = (t & 0x007F007Fu) | 0x43004300u;
  const uint32_t b = (t & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                             *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&d);
}

template <int T>
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t w0, uint32_t w1) {
  constexpr uint32_t kSel = 0x4440u | T | ((T + 4) << 8);  // {w0.T, -, w1.T, -}
  return s8_bytes02_to_bf16x2(__byte_perm(w0, w1, kSel));
}

// Bytes 2P and 2P + 1 of w, int8 values, as exact bf16, {lo: byte 2P, hi:
// byte 2P + 1}: a row of int8 widened in place to a row of bf16.
template <int P>
__device__ __forceinline__ uint32_t s8pair_to_bf16x2(uint32_t w) {
  return s8_bytes02_to_bf16x2(__byte_perm(w, 0u, P ? 0x4342u : 0x4140u));
}

// 2^x by the special-function unit (ex2.approx.ftz: 2 ulp, subnormal
// results flushed to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace tc
