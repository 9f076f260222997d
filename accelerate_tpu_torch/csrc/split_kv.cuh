// Split-history (flash-decoding) pieces shared by the tensor-core paged
// attention kernels (paged_decode.cu's paged_decode_mma, paged_verify.cu's
// paged_verify_mma): the XOR-swizzled bf16 K/V tile, the pool row of a
// history position through the block table, the int8 tile widened to bf16,
// and the one-launch combine of a group's split partials by its last block.
//
// A split launch runs `splits` blocks for each group (a slot's kv head, and
// for verify a row tile), each over its own contiguous range of the group's
// history. Each block writes its partial in f32 to the work buffer the
// wrapper allocates: the rows' unnormalised accumulators (rows x D f32),
// then each row's (m, l), padded to whole 16-byte pieces (part_floats). An int32 ticket per
// group (the wrapper's per-device array, all zero between launches) counts
// the blocks that have finished; the last one combines the partials in
// split order and resets the ticket, so the call stays one launch and the
// result has the same bits whichever block arrives last.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace splitkv {

constexpr float kLog2e = 1.4426950408889634f;

// Byte offset of 16-byte chunk ch of row r in a bf16 tile of D-wide rows:
// chunk ch sits at ch ^ (r % 8), so the 8 rows an ldmatrix phase reads at
// one logical chunk land in 8 distinct bank groups.
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return r * (D * 2) + ((ch ^ (r & 7)) << 4);
}

// Pool row (block * block_size + offset) of history position kk of one
// table row; a power-of-two block size (the engine's 16) takes shifts in
// place of two integer divisions a row. Made by pool_rows.
struct PoolRows {
  const int* trow;
  int bs;
  int shift;  // log2(bs), or -1
  __device__ __forceinline__ long operator()(int kk) const {
    if (shift >= 0) return ((long)trow[kk >> shift] << shift) + (kk & (bs - 1));
    return (long)trow[kk / bs] * bs + kk % bs;
  }
};

__device__ __forceinline__ PoolRows pool_rows(const int* trow, int bs) {
  return PoolRows{trow, bs, (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1};
}

// The raw int8 K and V tiles at `raw` (BK rows of D bytes, V `RAW` bytes
// after K) widened to bf16 in the swizzled layout at `wide` (V `TILE`
// bytes after K); int8 values are exact in bf16. Called by every thread.
template <int D, int BK, int NT>
__device__ __forceinline__ void widen_int8(const unsigned char* raw, unsigned char* wide) {
  constexpr int CH8 = D / 16;  // 16-byte chunks of an int8 row
  constexpr int RAW = BK * D;
  constexpr int TILE = BK * D * 2;
  for (int i = threadIdx.x; i < 2 * BK * CH8; i += NT) {
    const int kv = i / (BK * CH8), r = (i / CH8) % BK, ch = i % CH8;
    const uint4 w = *reinterpret_cast<const uint4*>(raw + kv * RAW + r * D + ch * 16);
    const uint4 lo = make_uint4(tc::s8pair_to_bf16x2<0>(w.x), tc::s8pair_to_bf16x2<1>(w.x),
                                tc::s8pair_to_bf16x2<0>(w.y), tc::s8pair_to_bf16x2<1>(w.y));
    const uint4 hi = make_uint4(tc::s8pair_to_bf16x2<0>(w.z), tc::s8pair_to_bf16x2<1>(w.z),
                                tc::s8pair_to_bf16x2<0>(w.w), tc::s8pair_to_bf16x2<1>(w.w));
    unsigned char* dst = wide + kv * TILE;
    *reinterpret_cast<uint4*>(dst + swz<D>(r, 2 * ch)) = lo;
    *reinterpret_cast<uint4*>(dst + swz<D>(r, 2 * ch + 1)) = hi;
  }
}

// Floats of one block's partial: rows x (D + 2), padded to a multiple of 4
// so that every partial starts 16-byte aligned (ops/paged_decode.py's
// _split_scratch allocates the same).
__host__ __device__ constexpr int part_floats(int rows, int d) { return (rows * (d + 2) + 3) / 4 * 4; }

// Called by every thread of a block once its partial is written: whether
// it is the last of its group's `splits` blocks to finish. `flag` is an int
// in shared memory.
__device__ __forceinline__ bool last_of_group(int* ticket, int splits, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(ticket, 1) == splits - 1;
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  return true;
}

// The last block's combine of the group's partials at `parts` (split s at
// parts + s * part_floats(rows, D)), each weighed by exp(m_s - M) in split order;
// row r's D outputs go to out_row(r) as bf16 (nullptr: a row no caller
// reads). A split that saw no key holds m = NEG_INF, l = 0 and weighs 0.
// Then the ticket is reset for the next launch.
template <int D, typename OutRow>
__device__ void combine(const float* parts, int splits, int rows, OutRow out_row, int* ticket) {
  const int part = part_floats(rows, D);
  for (int i = threadIdx.x; i < rows * (D / 4); i += blockDim.x) {
    const int r = i / (D / 4), c4 = i % (D / 4);
    __nv_bfloat16* orow = out_row(r);
    if (orow == nullptr) continue;
    float M = -INFINITY;
    for (int s = 0; s < splits; ++s) M = fmaxf(M, __ldcg(parts + s * part + rows * D + 2 * r));
    float L = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      const float* ps = parts + s * part;
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(ps + rows * D + 2 * r));
      const float w = tc::exp2_approx((ml.x - M) * kLog2e);
      const float4 v = __ldcg(reinterpret_cast<const float4*>(ps + r * D) + c4);
      L += ml.y * w;
      acc.x += w * v.x;
      acc.y += w * v.y;
      acc.z += w * v.z;
      acc.w += w * v.w;
    }
    L = fmaxf(L, 1e-30f);
    *reinterpret_cast<uint2*>(orow + 4 * c4) = make_uint2(tc::pack_bf16(acc.x / L, acc.y / L),
                                                          tc::pack_bf16(acc.z / L, acc.w / L));
  }
  if (threadIdx.x == 0) *ticket = 0;
}

}  // namespace splitkv
