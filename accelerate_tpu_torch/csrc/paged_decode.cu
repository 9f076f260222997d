// Paged flash-decode for Hopper (sm_90a): one query token per slot over a
// paged KV pool.
//
// Replaces the TPU kernel accelerate_tpu/ops/paged_decode.py::_decode_kernel
// (launched by paged_flash_decode, called from models/llama.py
// _pallas_decode_override). Semantics are those of ops/attention.py
// paged_attention: keys at positions <= pos[b] attend, everything past is
// masked with the finite NEG_INF = -1e6 (so a skipped block and a masked
// block give the same bits of weight: exactly 0).
//
// What bounds it on the card: bytes. Each step reads the live K and V of
// every slot once, (pos + 1) * Hkv * D * 2 * itemsize per slot and layer,
// against 4 * (pos + 1) * H * D flops: about 1 flop per byte, far below the
// card's ~295 flop/byte ridge. What the design does about it:
//   * one block per (slot, kv head) holds the whole GQA group's n_rep query
//     rows in registers, so each K/V row is read from memory once per
//     group, never n_rep times;
//   * the block loads its own block-table row and its own pos (this takes
//     the place of the TPU kernel's scalar prefetch) and walks only blocks
//     0 .. pos / block_size: the dead tail of the row is never touched;
//   * the block's 4 warps split the live blocks round-robin, so four
//     independent streams of loads are in flight, and merge their online
//     softmax partials (m, l, acc) through shared memory at the end;
//   * each lane owns D/32 contiguous dims, so a warp reads one K row of a
//     head (D * itemsize bytes) as one coalesced request.
// Grid (Hkv, B) is small at decode batch sizes (64 blocks for 8 slots and 8
// kv heads), which leaves SMs idle; splitting a slot's blocks over several
// thread blocks (split-K) is later work. Vacant slots carry null-block
// (block 0) table entries and read block 0: always in range.
//
// Layout: q, out (B, 1, H, D); k_pool, v_pool (num_blocks, block_size, Hkv,
// D) in q's dtype, or int8 with k_scale, v_scale (num_blocks, block_size)
// f32; tables (B, blocks_per_row) int32; pos (B,) int32.
//
// The int8 branch (the TPU kernel's `quantized` path, paged_decode.py:116-118;
// entry point paged_decode_int8): each lane loads its int8 elements of a K/V
// row and the row's f32 scale, and dequantizes in registers as it loads
// (k = q * s, kv_pool.cuh), so the arithmetic after the load is the f32
// path's. It reads 1 byte per element plus 4 per row and head group instead
// of 2 (bf16): the same loop moves about half the bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "kv_pool.cuh"

namespace {

using kvpool::dequant;
using kvpool::from_f;
using kvpool::kNegInf;
using kvpool::row_scale;
using kvpool::to_f;

constexpr int NW = 4;        // warps per block
constexpr int CHUNK = 8;     // K/V rows loaded ahead per warp

// T: q/out dtype; PT: pool dtype (T, or int8_t with per-row scales)
template <typename T, typename PT, int D, int NREP>
__global__ void __launch_bounds__(NW * 32) paged_decode_kernel(
    const T* __restrict__ q, const PT* __restrict__ k_pool,
    const PT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ pos, T* __restrict__ out, int H, int Hkv, int bs,
    int bpr, float scale, float softcap) {
  constexpr int DL = D / 32;  // dims per lane
  __shared__ float s_m[NW][NREP];
  __shared__ float s_l[NW][NREP];
  __shared__ float s_acc[NW][NREP][D];

  const int g = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // slot
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int p = pos[b];
  int nblk = p < 0 ? 0 : p / bs + 1;
  if (nblk > bpr) nblk = bpr;
  const long row_stride = (long)Hkv * D;  // one position of the pool
  const int* trow = tables + (long)b * bpr;

  float qr[NREP][DL];
#pragma unroll
  for (int r = 0; r < NREP; ++r)
#pragma unroll
    for (int i = 0; i < DL; ++i)
      qr[r][i] = to_f(q[((long)b * H + g * NREP + r) * D + lane * DL + i]);

  float m[NREP], l[NREP], acc[NREP][DL];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[r][i] = 0.f;
  }

  for (int j = warp; j < nblk; j += NW) {
    const long row0 = (long)trow[j] * bs;  // pool row of the block's first position
    for (int t0 = 0; t0 < bs; t0 += CHUNK) {
      float kr[CHUNK][DL], vr[CHUNK][DL];
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        const bool in = t0 + u < bs;
        const long prow = row0 + t0 + u;
        const long off = prow * row_stride + (long)g * D + lane * DL;
        const float ks = in ? row_scale<PT>(k_scale, prow) : 0.f;
        const float vs = in ? row_scale<PT>(v_scale, prow) : 0.f;
#pragma unroll
        for (int i = 0; i < DL; ++i) {
          kr[u][i] = in ? dequant(k_pool, off + i, ks) : 0.f;
          vr[u][i] = in ? dequant(v_pool, off + i, vs) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        const int kp = j * bs + t0 + u;
        if (t0 + u >= bs) break;
#pragma unroll
        for (int r = 0; r < NREP; ++r) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < DL; ++i) dot = fmaf(qr[r][i], kr[u][i], dot);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          float sc = dot * scale;
          if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
          sc = kp <= p ? sc : kNegInf;
          const float mn = fmaxf(m[r], sc);
          const float a = expf(m[r] - mn);
          const float pe = expf(sc - mn);
          l[r] = a * l[r] + pe;
#pragma unroll
          for (int i = 0; i < DL; ++i) acc[r][i] = fmaf(pe, vr[u][i], a * acc[r][i]);
          m[r] = mn;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    if (lane == 0) {
      s_m[warp][r] = m[r];
      s_l[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DL; ++i) s_acc[warp][r][lane * DL + i] = acc[r][i];
  }
  __syncthreads();

  // merge the warps' partials; a warp that walked no block holds
  // (NEG_INF, 0, 0) and gets weight exp(NEG_INF - M) = 0
  for (int idx = threadIdx.x; idx < NREP * D; idx += NW * 32) {
    const int r = idx / D, d = idx % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, s_m[w][r]);
    float L = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float wt = expf(s_m[w][r] - M);
      L = fmaf(wt, s_l[w][r], L);
      o = fmaf(wt, s_acc[w][r][d], o);
    }
    out[((long)b * H + g * NREP + r) * D + d] = from_f<T>(o / fmaxf(L, 1e-30f));
  }
}

template <typename T, typename PT, int D, int NREP>
int launch(const void* q, const void* kp, const void* vp, const float* ks, const float* vs,
           const int* tables, const int* pos, void* out, int B, int H, int Hkv, int bs,
           int bpr, float scale, float softcap, cudaStream_t stream) {
  dim3 grid(Hkv, B);
  paged_decode_kernel<T, PT, D, NREP><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const PT*>(kp), static_cast<const PT*>(vp), ks, vs,
      tables, pos, static_cast<T*>(out), H, Hkv, bs, bpr, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T, typename PT, int D>
int by_rep(int nrep, const void* q, const void* kp, const void* vp, const float* ks,
           const float* vs, const int* tables, const int* pos, void* out, int B, int H,
           int Hkv, int bs, int bpr, float scale, float softcap, cudaStream_t s) {
  switch (nrep) {
    case 1: return launch<T, PT, D, 1>(q, kp, vp, ks, vs, tables, pos, out, B, H, Hkv, bs, bpr, scale, softcap, s);
    case 2: return launch<T, PT, D, 2>(q, kp, vp, ks, vs, tables, pos, out, B, H, Hkv, bs, bpr, scale, softcap, s);
    case 4: return launch<T, PT, D, 4>(q, kp, vp, ks, vs, tables, pos, out, B, H, Hkv, bs, bpr, scale, softcap, s);
    case 8: return launch<T, PT, D, 8>(q, kp, vp, ks, vs, tables, pos, out, B, H, Hkv, bs, bpr, scale, softcap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q/out dtype: 0 = float32, 1 = bfloat16; the pool is that dtype (PoolInt8
// false) or int8 with scales (true)
template <bool PoolInt8>
int dispatch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
             const void* tables, const void* pos, void* out, int B, int H, int Hkv, int D,
             int bs, int bpr, int dtype, float scale, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || bs <= 0 || bpr <= 0) return (int)cudaErrorInvalidValue;
  const int nrep = H / Hkv;
  const float* ksc = static_cast<const float*>(ks);
  const float* vsc = static_cast<const float*>(vs);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(pos);
  using F = float;
  using BF = __nv_bfloat16;
  using PF = typename std::conditional<PoolInt8, int8_t, F>::type;
  using PBF = typename std::conditional<PoolInt8, int8_t, BF>::type;
  if (dtype == 0 && D == 64)
    return by_rep<F, PF, 64>(nrep, q, kp, vp, ksc, vsc, t, p, out, B, H, Hkv, bs, bpr, scale, softcap, s);
  if (dtype == 0 && D == 128)
    return by_rep<F, PF, 128>(nrep, q, kp, vp, ksc, vsc, t, p, out, B, H, Hkv, bs, bpr, scale, softcap, s);
  if (dtype == 1 && D == 64)
    return by_rep<BF, PBF, 64>(nrep, q, kp, vp, ksc, vsc, t, p, out, B, H, Hkv, bs, bpr, scale, softcap, s);
  if (dtype == 1 && D == 128)
    return by_rep<BF, PBF, 128>(nrep, q, kp, vp, ksc, vsc, t, p, out, B, H, Hkv, bs, bpr, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (of q, out and a float pool): 0 = float32, 1 = bfloat16. softcap <= 0
// means off. Returns a cudaError_t code (0 on success).
extern "C" int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                            const void* tables, const void* pos, void* out, int B,
                            int H, int Hkv, int D, int bs, int bpr, int dtype,
                            float scale, float softcap, void* stream) {
  return dispatch<false>(q, k_pool, v_pool, nullptr, nullptr, tables, pos, out, B, H, Hkv, D,
                         bs, bpr, dtype, scale, softcap, stream);
}

// The int8 pool: k_pool, v_pool int8, k_scale, v_scale (num_blocks,
// block_size) f32.
extern "C" int paged_decode_int8(const void* q, const void* k_pool, const void* v_pool,
                                 const void* k_scale, const void* v_scale, const void* tables,
                                 const void* pos, void* out, int B, int H, int Hkv, int D,
                                 int bs, int bpr, int dtype, float scale, float softcap,
                                 void* stream) {
  return dispatch<true>(q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, B, H, Hkv, D,
                        bs, bpr, dtype, scale, softcap, stream);
}
