// Paged flash-verify for Hopper (sm_90a): a W-query window per slot over the
// paged KV pool plus the window's own, not yet committed, K/V.
//
// Replaces the TPU kernel accelerate_tpu/ops/paged_decode.py::_verify_kernel
// (launched by paged_flash_verify, called from models/llama.py
// _pallas_verify_override). It serves two engine paths: speculative verify
// (W = draft length + 1 = 5 per slot) and chunked prefill (one slot, W =
// the chunk, 512). Semantics are those of ops/attention.py verify_attention
// over a pool copy with the window written in at pos .. pos+W-1: query
// q_idx (absolute position pos + q_idx) attends the committed history
// strictly k_pos < pos, then the window's keys k_idx <= q_idx. Softcap comes
// before the mask; masked scores take the finite NEG_INF = -1e6, so they
// get exactly 0 weight.
//
// What bounds it on the card: at the spec shape (8 slots, W = 5, H = 32,
// Hkv = 8, D = 128) bytes: every live history row of K and V is read once
// per kv head for 5 * n_rep = 20 query rows, about 10 flops per byte, far
// below the card's ~295 flop/byte ridge. At the chunk shape (W = 512) the
// same history feeds 2,048 query rows per kv head, and it is bound by
// operations: 4 * H * D * W * (pos + (W + 1) / 2) flops. This first version
// runs its products as f32 FMA loops on the CUDA cores (no mma/wgmma), so
// at the chunk shape it is bound by the FMA rate and shared-memory reads,
// far above the tensor-core bound. What the design does about it:
//   * one block per (slot, kv head, 64-row tile of the group's n_rep * W
//     query rows), rows ordered (window index, head in group), so the GQA
//     group shares each K/V tile read and a tile's rows cover a contiguous
//     range of window indices;
//   * the block loads its own table row and pos (the TPU kernel's scalar
//     prefetch has no counterpart) and walks only the history positions
//     0 .. pos-1, in tiles of 64 keys gathered through the table; blocks at
//     or past pos are never read;
//   * then it walks the window's keys only up to its last query's index;
//   * each thread owns a 4x4 register micro-tile of the 64x64 score tile
//     and a 4x(D/16) micro-tile of the output (as flash_fwd.cu), so every
//     shared-memory read feeds 4 FMAs; the online softmax runs in f32.
// An int8 pool (entry point paged_verify_int8) is dequantized per element
// as the tile is loaded, with the position's f32 scale (kv_pool.cuh).
// Rounding: p is rounded to v's dtype before p.v where v is bf16 (a bf16
// pool and its bf16 window, as the TPU kernel's _accumulate and the plain
// version do); an int8 pool's history is dequantized to f32, so p stays f32.
// The output is written once, in q's dtype.
//
// Layout: q, out (B, W, H, D); k_pool, v_pool (num_blocks, block_size, Hkv,
// D) in q's dtype, or int8 with k_scale, v_scale (num_blocks, block_size)
// f32; win_k, win_v (B, W, Hkv, D) in q's dtype; tables (B, blocks_per_row)
// int32; pos (B,) int32. Ghost slots (vacant or done) carry null-block
// (block 0) table entries and read block 0: always in range. Window
// positions past the row's table are attended all the same (the caller
// discards those rows and never commits them).

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

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // 16 x 16 threads; thread (ty, tx)

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(long) * BK
         + sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + 2 * BK);
}

// T: q, window and out dtype; PT: pool dtype (T, or int8_t with scales)
template <typename T, typename PT, int D>
__global__ void __launch_bounds__(NT) paged_verify_kernel(
    const T* __restrict__ q, const PT* __restrict__ k_pool, const PT* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const T* __restrict__ win_k, const T* __restrict__ win_v,
    const int* __restrict__ tables, const int* __restrict__ pos, T* __restrict__ out,
    int W, int H, int Hkv, int bs, int bpr, float scale, float softcap) {
  constexpr int DP = D + 1;   // padded rows: column reads hit distinct banks
  constexpr int PP = BK + 1;
  constexpr int DC = D / 16;  // output columns per thread
  constexpr bool kRoundP = std::is_same<PT, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long* sSrc = reinterpret_cast<long*>(smem_raw);  // element offset of each key's row, or -1
  float* sQ = reinterpret_cast<float*>(sSrc + BK);
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sP = sV + BK * D;
  float* sKs = sP + BQ * PP;  // each key's dequantization scales
  float* sVs = sKs + BK;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int nrep = H / Hkv;
  const int R = W * nrep;  // query rows of this (slot, kv head): row = q_idx * nrep + r
  const int r0 = blockIdx.x * BQ;
  const int p = max(pos[b], 0);
  const int nh = min(p, bpr * bs);  // history keys: positions 0 .. nh-1
  const int* trow = tables + (long)b * bpr;
  const long kv_stride = (long)Hkv * D;  // one position of the pool or the window
  const long q_stride = (long)H * D;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int i = idx / D, c = idx % D;
    const int row = r0 + i;
    float x = 0.f;
    if (row < R) {
      const int qi = row / nrep, r = row % nrep;
      x = to_f(q[((long)b * W + qi) * q_stride + (long)(g * nrep + r) * D + c]);
    }
    sQ[i * DP + c] = x;
  }

  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_i[r] = kNegInf;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  // history tiles first, then the window's key tiles up to the tile's last
  // query index; query 0 always sees window key 0, so l > 0 at the end even
  // when pos = 0
  const int qi_hi = (min(r0 + BQ, R) - 1) / nrep;
  const int n_hist = (nh + BK - 1) / BK;
  const int n_tiles = n_hist + qi_hi / BK + 1;

  for (int j = 0; j < n_tiles; ++j) {
    const bool hist = j < n_hist;
    const int k0 = (hist ? j : j - n_hist) * BK;
    __syncthreads();  // the previous tile's reads of sK/sV/sP/sSrc are done
    for (int i = tid; i < BK; i += NT) {
      const int kk = k0 + i;
      long src = -1;
      float ks = 0.f, vs = 0.f;
      if (hist) {
        if (kk < nh) {
          const long prow = (long)trow[kk / bs] * bs + kk % bs;
          src = prow * kv_stride + (long)g * D;
          ks = row_scale<PT>(k_scale, prow);
          vs = row_scale<PT>(v_scale, prow);
        }
      } else if (kk < W) {
        src = ((long)b * W + kk) * kv_stride + (long)g * D;
      }
      sSrc[i] = src;
      sKs[i] = ks;
      sVs[i] = vs;
    }
    __syncthreads();
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int i = idx / D, c = idx % D;
      const long src = sSrc[i];
      float kx = 0.f, vx = 0.f;
      if (src >= 0) {
        if (hist) {
          kx = dequant(k_pool, src + c, sKs[i]);
          vx = dequant(v_pool, src + c, sVs[i]);
        } else {
          kx = to_f(win_k[src + c]);
          vx = to_f(win_v[src + c]);
        }
      }
      sK[i * DP + c] = kx;
      sV[i * D + c] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = sQ[(ty + 16 * r) * DP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sK[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = (r0 + ty + 16 * r) / nrep;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kk = k0 + tx + 16 * c;
        float x = s[r][c] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool vis = hist ? kk < nh : (kk <= qi && kk < W);
        s[r][c] = vis ? x : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      // a row's 64 columns live in the 16 lanes sharing ty (one half-warp)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[r], mx);
      const float alpha = expf(m_i[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pe = expf(s[r][c] - m_new);
        rs += pe;
        sP[(ty + 16 * r) * PP + tx + 16 * c] =
            kRoundP ? __bfloat162float(__float2bfloat16(pe)) : pe;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[r] = alpha * l_i[r] + rs;
      m_i[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < BK; ++t) {
      float pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = sP[(ty + 16 * r) * PP + t];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = sV[t * D + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(pv[r], vv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty + 16 * r;
    if (row >= R) continue;
    const int qi = row / nrep, rr = row % nrep;
    const float l = fmaxf(l_i[r], 1e-30f);
    T* orow = out + ((long)b * W + qi) * q_stride + (long)(g * nrep + rr) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = from_f<T>(acc[r][c] / l);
  }
}

template <typename T, typename PT, int D>
int launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
           const void* wk, const void* wv, const void* tables, const void* pos, void* out,
           int B, int W, int H, int Hkv, int bs, int bpr, float scale, float softcap,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_verify_kernel<T, PT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = W * (H / Hkv);
  dim3 grid((rows + BQ - 1) / BQ, Hkv, B);
  paged_verify_kernel<T, PT, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const PT*>(kp), static_cast<const PT*>(vp),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const T*>(wk), static_cast<const T*>(wv), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<T*>(out), W, H, Hkv, bs, bpr, scale, softcap);
  return (int)cudaGetLastError();
}

// q/window/out dtype: 0 = float32, 1 = bfloat16; the pool is that dtype
// (PoolInt8 false) or int8 with scales (true)
template <bool PoolInt8>
int dispatch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
             const void* wk, const void* wv, const void* tables, const void* pos, void* out,
             int B, int W, int H, int Hkv, int D, int bs, int bpr, int dtype, float scale,
             float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || W <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || bs <= 0 || bpr <= 0) return (int)cudaErrorInvalidValue;
  using F = float;
  using BF = __nv_bfloat16;
  using PF = typename std::conditional<PoolInt8, int8_t, F>::type;
  using PBF = typename std::conditional<PoolInt8, int8_t, BF>::type;
  if (dtype == 0 && D == 64)
    return launch<F, PF, 64>(q, kp, vp, ks, vs, wk, wv, tables, pos, out, B, W, H, Hkv, bs, bpr, scale, softcap, s);
  if (dtype == 0 && D == 128)
    return launch<F, PF, 128>(q, kp, vp, ks, vs, wk, wv, tables, pos, out, B, W, H, Hkv, bs, bpr, scale, softcap, s);
  if (dtype == 1 && D == 64)
    return launch<BF, PBF, 64>(q, kp, vp, ks, vs, wk, wv, tables, pos, out, B, W, H, Hkv, bs, bpr, scale, softcap, s);
  if (dtype == 1 && D == 128)
    return launch<BF, PBF, 128>(q, kp, vp, ks, vs, wk, wv, tables, pos, out, B, W, H, Hkv, bs, bpr, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (of q, the window, out and a float pool): 0 = float32, 1 = bfloat16.
// softcap <= 0 means off. Returns a cudaError_t code (0 on success).
extern "C" int paged_verify(const void* q, const void* k_pool, const void* v_pool,
                            const void* win_k, const void* win_v, const void* tables,
                            const void* pos, void* out, int B, int W, int H, int Hkv, int D,
                            int bs, int bpr, int dtype, float scale, float softcap,
                            void* stream) {
  return dispatch<false>(q, k_pool, v_pool, nullptr, nullptr, win_k, win_v, tables, pos, out,
                         B, W, H, Hkv, D, bs, bpr, dtype, scale, softcap, stream);
}

// The int8 pool: k_pool, v_pool int8, k_scale, v_scale (num_blocks,
// block_size) f32.
extern "C" int paged_verify_int8(const void* q, const void* k_pool, const void* v_pool,
                                 const void* k_scale, const void* v_scale, const void* win_k,
                                 const void* win_v, const void* tables, const void* pos,
                                 void* out, int B, int W, int H, int Hkv, int D, int bs,
                                 int bpr, int dtype, float scale, float softcap, void* stream) {
  return dispatch<true>(q, k_pool, v_pool, k_scale, v_scale, win_k, win_v, tables, pos, out,
                        B, W, H, Hkv, D, bs, bpr, dtype, scale, softcap, stream);
}
