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
// card's ~295 flop/byte ridge. At decode batch sizes those bytes are few
// (10.6 MB for 8 slots at positions 0-1023 and Llama-3-8B's heads: 3.2 us
// at 3.35 TB/s), so the time is set by how many of them are in flight at
// once and by the longest chain of loads and arithmetic a block walks.
// Two variants; ops/paged_decode.py::decode_kernel_for picks one by q's
// dtype, and decode_plan sizes the tensor-core launch:
//
// * paged_decode_mma (bf16 q; a bf16 pool) and paged_decode_int8_mma (bf16
//   q; an int8 pool with per-position f32 scales):
//   - Split history (flash-decoding): one block per (slot, kv head) leaves
//     most SMs idle at decode batch sizes (64 blocks for 8 slots and 8 kv
//     heads on 132 SMs), and the slot with the longest history sets the
//     time. decode_plan cuts each group into `splits` blocks (5 there: 320
//     blocks); each block reads pos on the device and takes its own
//     contiguous share of the slot's live key tiles [0, pos], so a slot's
//     splits share its real length, not the table's, and the plan depends
//     on shapes only (a CUDA graph captures the launch). A block whose
//     share is empty leaves at once (a slot at pos 0 has one tile, so
//     one block does its work and writes its output); the last of a
//     group's active blocks combines their f32 partials in split order
//     (split_kv.cuh, shared with paged_verify.cu): one launch, the same
//     bits on every launch.
//   - Loads: 16-byte cp.async copies of the kv head's whole K and V rows,
//     through the table (a thread looks up its rows of the next tile while
//     this one is computed), into XOR-swizzled bf16 tiles of 64 keys, in a
//     ring of 3 tiles: 2 are in flight while one is computed. Rows past pos
//     are zero-filled, never read: the dead tail of the row is not
//     touched. An int8 pool's rows arrive raw with their scales (each
//     tile's 64 scales copied once) and are widened to bf16 in shared
//     memory (exact: |q| <= 127).
//   - Both products on the tensor cores (mma.sync.m16n8k16, bf16 in, f32
//     accumulators). The group's n_rep <= 8 query rows are padded to the
//     MMA's 16 rows. Keys on the M side instead (S^T = K q^T, the rows as
//     N = 8) would waste less of each MMA but leave P with the keys on the
//     fragment's rows, where P.V needs them on its columns: a transpose a
//     tile. The tensor cores idle here either way (the kernel is bound by
//     bytes), so the padded rows keep S's fragments in registers as P.V's A
//     operand, as flash_fwd_mma and paged_verify_mma do. q's fragments are
//     loaded once, from global memory into registers. Each of the block's
//     4 warps takes 16 keys of every tile with its own online softmax
//     (ex2.approx with the scale folded into log2 e; softcap before the
//     mask; keys past pos in the last tile are no keys at all), and the
//     four merge through shared memory at the end. p is rounded to bf16
//     before P.V, as the TPU kernel rounds pexp to v's dtype; for an int8
//     pool k_scale scales the score columns and v_scale folds into p
//     before that rounding (l keeps the unscaled f32 p).
// * paged_decode (f32 q, or f32 q with an int8 pool: paged_decode_int8),
//   the first version: f32 FMA loops on the CUDA cores, since f32 inputs
//   keep f32 products. One block per (slot, kv head) holds the group's
//   n_rep query rows in registers, loads its own table row and pos, and
//   walks blocks 0 .. pos / block_size only; its 4 warps split the live
//   blocks round-robin and merge their online softmax partials (m, l,
//   acc) through shared memory. Each lane owns D/32 contiguous dims, so a
//   warp reads one K row of a head as one coalesced request. An int8 pool
//   is dequantized per element as it is loaded, with the position's f32
//   scale (kv_pool.cuh), and p stays f32.
//
// Layout: q, out (B, 1, H, D); k_pool, v_pool (num_blocks, block_size, Hkv,
// D) in q's dtype, or int8 with k_scale, v_scale (num_blocks, block_size)
// f32; tables (B, blocks_per_row) int32; pos (B,) int32. Vacant slots carry
// null-block (block 0) table entries and read block 0: always in range.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "kv_pool.cuh"
#include "mma.cuh"
#include "split_kv.cuh"

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

// ------------------------------------------------------ tensor-core variant
using bf16 = __nv_bfloat16;
using splitkv::kLog2e;
using splitkv::swz;

// NW warps, each taking 16 keys of every BK-key tile; a ring of STAGES
// tiles; I8: an int8 pool (each stage holds the raw K and V tiles and their
// scales, widened into one bf16 pair that every stage shares). What paces
// a block is each warp's chain of dependent products and softmax steps over
// its 16 keys of a tile, not the bytes in flight, so 4 warps on 64-key
// tiles cover a history in half the steps of 2 warps on 32-key tiles; 3
// stages keep two tiles in flight while one is computed (96 KB a block at
// D = 128: 2 blocks an SM, decode_plan's FILL_BLOCKS).
template <int D, bool I8>
struct DCfg {
  static constexpr int NW = 4;
  static constexpr int NT = 32 * NW;
  static constexpr int BK = 16 * NW;        // keys a tile (decode_plan's key_tile)
  static constexpr int STAGES = 3;
  static constexpr int ROWS = 8;            // query rows a group may have (n_rep <= 8)
  static constexpr int CH = D / 8;          // 16-byte chunks of a bf16 row
  static constexpr int TILE = BK * D * 2;   // a bf16 K or V tile
  static constexpr int RAW = BK * D;        // an int8 K or V tile
  static constexpr int STAGE = I8 ? 2 * RAW + 2 * BK * 4 : 2 * TILE;
  static constexpr int WIDE = I8 ? 2 * TILE : 0;
  static constexpr int SMEM = STAGES * STAGE + WIDE;
  // after the key loop the ring holds the warps' partials and the flag
  static constexpr int RED = 4 * NW * ROWS * (D + 2);
  static_assert(RED + 16 <= SMEM, "the warps' partials must fit in the ring");
  static_assert(BK <= NT, "one thread copies each key's scales");
};

// Grid: (splits, Hkv, B); block x = this group's split.
template <int D, bool I8, bool CAP>
__global__ void __launch_bounds__(DCfg<D, I8>::NT) paged_decode_mma_kernel(
    const bf16* __restrict__ q, const void* __restrict__ k_pool_,
    const void* __restrict__ v_pool_, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ pos, bf16* __restrict__ out, float* __restrict__ work,
    int* __restrict__ tickets, int H, int Hkv, int bs, int bpr, int splits, float scale,
    float softcap) {
  using C = DCfg<D, I8>;
  using PT = typename std::conditional<I8, int8_t, bf16>::type;
  constexpr int NT = C::NT, BK = C::BK, STAGES = C::STAGES, ROWS = C::ROWS;
  constexpr int NDT = D / 8;   // output n8 tiles
  constexpr int CH8 = D / 16;  // 16-byte chunks of an int8 row
  const PT* k_pool = static_cast<const PT*>(k_pool_);
  const PT* v_pool = static_cast<const PT*>(v_pool_);
  extern __shared__ __align__(128) unsigned char dsmem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row: query row g of the group
  const int c = lane & 3;   // fragment column pair
  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int nrep = H / Hkv;
  const int p = pos[b];
  const int nk = p < 0 ? 0 : min(p + 1, bpr * bs);  // live keys: positions 0 .. pos
  const splitkv::PoolRows pool_row = splitkv::pool_rows(tables + (long)b * bpr, bs);
  const long kv_stride = (long)Hkv * D;
  const long q0 = ((long)b * H + hk * nrep) * D;  // the group's first query row

  // this split's share of the live key tiles: [t_lo, t_lo + n_tiles).
  // Splits with an empty share leave at once: `active` splits hold a tile
  // (each holds one where the slot has fewer tiles than splits), and only
  // they meet in the combine; a slot at pos < 0 has no tile, and split 0
  // writes its zeros
  const int n_all = (nk + BK - 1) / BK;
  const int t_lo = (int)((long)split * n_all / splits);
  const int n_tiles = (int)((long)(split + 1) * n_all / splits) - t_lo;
  if (n_tiles == 0 && (n_all > 0 || split > 0)) return;
  const int active = max(1, min(splits, n_all));
  const uint32_t s0 = tc::smem_addr(dsmem);

  // tile j of this split into stage j % STAGES: 16-byte copies of the kv
  // head's row of each key through the table (int8 ones raw, with their two
  // scales); rows past pos zero-filled, never read. Thread tid copies
  // chunk tid % CPR of rows tid / CPR + RSTEP * m, m < NR (and, for an
  // int8 pool, threads tid < BK key tid's scales). Its rows' table entries
  // are looked up a tile ahead (lookup), so those loads fly while a tile
  // is computed and the next tile's copies (copy_tile) need not wait for them
  constexpr int CPR = I8 ? CH8 : C::CH;  // 16-byte chunks of a pool row
  constexpr int RSTEP = NT / CPR;
  constexpr int NR = BK / RSTEP;
  static_assert(NT % CPR == 0 && BK % RSTEP == 0, "whole rows a pass");
  const int ch = tid % CPR;
  long rows[NR + 1];  // pool rows of this thread's keys of a tile, then of its scales' key (-1: none)
  auto lookup = [&](int j) {
    const int k0 = (t_lo + j) * BK;
#pragma unroll
    for (int m = 0; m <= NR; ++m) {
      const int kk = k0 + (m < NR ? tid / CPR + m * RSTEP : tid);
      rows[m] = j < n_tiles && kk < nk && (m < NR || (I8 && tid < BK)) ? pool_row(kk) : -1;
    }
  };
  auto copy_tile = [&](int j) {
    const uint32_t st = s0 + (j % STAGES) * C::STAGE;
#pragma unroll
    for (int m = 0; m < NR; ++m) {
      const int r = tid / CPR + m * RSTEP;
      const bool ok = rows[m] >= 0;
      const long o = ok ? rows[m] * kv_stride + (long)hk * D + ch * (16 / (int)sizeof(PT)) : 0;
      if constexpr (I8) {
        tc::cp_async16(st + r * D + ch * 16, k_pool + o, ok);
        tc::cp_async16(st + C::RAW + r * D + ch * 16, v_pool + o, ok);
      } else {
        tc::cp_async16(st + swz<D>(r, ch), k_pool + o, ok);
        tc::cp_async16(st + C::TILE + swz<D>(r, ch), v_pool + o, ok);
      }
    }
    if constexpr (I8) {
      if (tid < BK) {
        const bool ok = rows[NR] >= 0;
        const long o = ok ? rows[NR] : 0;
        tc::cp_async4(st + 2 * C::RAW + 4 * tid, k_scale + o, ok);
        tc::cp_async4(st + 2 * C::RAW + 4 * (BK + tid), v_scale + o, ok);
      }
    }
  };

  for (int j = 0; j < STAGES - 1; ++j) {
    lookup(j);
    if (j < n_tiles) copy_tile(j);
    tc::cp_async_commit();
  }
  lookup(STAGES - 1);

  // q's A fragments, in registers for the whole key loop: rows g < n_rep
  // of the group; rows g >= n_rep and g + 8 (a1, a3) are zero
  uint32_t qf[D / 16][2];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* qr = q + q0 + (long)g * D + 16 * kk + 2 * c;
    qf[kk][0] = g < nrep ? *reinterpret_cast<const uint32_t*>(qr) : 0u;
    qf[kk][1] = g < nrep ? *reinterpret_cast<const uint32_t*>(qr + 8) : 0u;
  }

  const int key0 = 16 * warp;  // this warp's keys within a tile
  float o[NDT][4];
  float m_r = kNegInf;
  float l_r = 0.f;  // this thread's share of row g's sum
#pragma unroll
  for (int t = 0; t < NDT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    tc::cp_async_wait<STAGES - 2>();  // tile j (this thread's copies)
    __syncthreads();                  // everyone's copies; tile j-1's reads are done
    if (j + STAGES - 1 < n_tiles) copy_tile(j + STAGES - 1);
    tc::cp_async_commit();
    lookup(j + STAGES);
    const uint32_t st = s0 + (j % STAGES) * C::STAGE;
    uint32_t sk = st;
    if constexpr (I8) {
      sk = s0 + STAGES * C::STAGE;
      splitkv::widen_int8<D, BK, NT>(dsmem + (j % STAGES) * C::STAGE, dsmem + STAGES * C::STAGE);
      __syncthreads();
    }
    const uint32_t sv = sk + C::TILE;
    const uint32_t s_scales = st + 2 * C::RAW;  // int8: k scales, then v scales
    const int kbase = (t_lo + j) * BK + key0;   // position of this warp's first key

    // S = q K^T over the warp's 16 keys: K's rows (keys) are B's columns,
    // d-contiguous, so one ldmatrix.x4 gives both n8 tiles' B fragments
    float sc[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t bk[4];
      tc::ldmatrix_x4(bk, sk + swz<D>(key0 + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1)));
      const uint32_t a[4] = {qf[kk][0], 0u, qf[kk][1], 0u};
      tc::mma_bf16(sc[0], a, bk[0], bk[1]);
      tc::mma_bf16(sc[1], a, bk[2], bk[3]);
    }

    // row g's scores (e = 0, 1; e = 2, 3 are the zero rows g + 8): k_scale
    // per key column (int8), the scale, softcap (a template switch), then
    // the tail past pos, only in a tile that crosses it
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = sc[t][e];
        if constexpr (I8) x *= __uint_as_float(tc::lds32(s_scales + 4 * (key0 + t * 8 + 2 * c + e)));
        if constexpr (CAP) x = softcap * tanhf(x * scale / softcap);
        else x *= scale;
        sc[t][e] = x;
      }
    if (kbase + 16 > nk) {
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (kbase + t * 8 + 2 * c + e >= nk) sc[t][e] = -INFINITY;  // not a key: weight 0
    }

    // online softmax: row g's 16 columns live in the 4 lanes that share g
    float mx = fmaxf(fmaxf(sc[0][0], sc[0][1]), fmaxf(sc[1][0], sc[1][1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_r, mx);
    const float alpha = tc::exp2_approx((m_r - m_new) * kLog2e);
    const float m_log2 = m_new * kLog2e;
    m_r = m_new;
    float rs = 0.f;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pe = tc::exp2_approx(fmaf(sc[t][e], kLog2e, -m_log2));
        rs += pe;
        // int8: v_scale folds into p before p is rounded to bf16
        if constexpr (I8) sc[t][e] = pe * __uint_as_float(tc::lds32(s_scales + 4 * (BK + key0 + t * 8 + 2 * c + e)));
        else sc[t][e] = pe;
      }
    l_r = alpha * l_r + rs;
#pragma unroll
    for (int t = 0; t < NDT; ++t) {
      o[t][0] *= alpha;
      o[t][1] *= alpha;
    }

    // O += bf16(P) V: P's C fragments are the A fragment of the warp's k16
    // step (rows g + 8 zero); V's rows (keys) are B's k, so ldmatrix.trans
    // gives B fragments for two d tiles per x4
    const uint32_t pa[4] = {tc::pack_bf16(sc[0][0], sc[0][1]), 0u,
                            tc::pack_bf16(sc[1][0], sc[1][1]), 0u};
#pragma unroll
    for (int dp = 0; dp < NDT / 2; ++dp) {
      uint32_t bv[4];
      tc::ldmatrix_x4_trans(bv, sv + swz<D>(key0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                            2 * dp + (lane >> 4)));
      tc::mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
      tc::mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
    }
  }
  tc::cp_async_wait<0>();
  l_r += __shfl_xor_sync(0xffffffffu, l_r, 1);
  l_r += __shfl_xor_sync(0xffffffffu, l_r, 2);

  // the warps' partials through shared memory (the ring is dead once every
  // warp has left the loop): acc [warp][row][d], then (m, l) [warp][row]
  __syncthreads();
  float* red = reinterpret_cast<float*>(dsmem);
  float* red_ml = red + C::NW * ROWS * D;
  int* flag = reinterpret_cast<int*>(red_ml + 2 * C::NW * ROWS);
  if (g < nrep) {
#pragma unroll
    for (int t = 0; t < NDT; ++t)
      *reinterpret_cast<float2*>(red + (warp * ROWS + g) * D + t * 8 + 2 * c) = make_float2(o[t][0], o[t][1]);
    if (c == 0) *reinterpret_cast<float2*>(red_ml + 2 * (warp * ROWS + g)) = make_float2(m_r, l_r);
  }
  __syncthreads();

  // merge the warps in order; the slot's only active split normalises and
  // writes the output, else each writes its partial (acc, then (m, l) per
  // row) in f32, the active ones packed in split order (split s is the
  // min(s, t_lo)-th active one)
  const long tix = (long)b * Hkv + hk;
  const int part_f = splitkv::part_floats(nrep, D);
  float* part = active > 1 ? work + (tix * splits + min(split, t_lo)) * part_f : nullptr;
  for (int i = tid; i < nrep * D; i += NT) {
    const int r = i / D, d = i % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < C::NW; ++w) M = fmaxf(M, red_ml[2 * (w * ROWS + r)]);
    float L = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < C::NW; ++w) {
      const float wt = tc::exp2_approx((red_ml[2 * (w * ROWS + r)] - M) * kLog2e);
      L = fmaf(wt, red_ml[2 * (w * ROWS + r) + 1], L);
      acc = fmaf(wt, red[(w * ROWS + r) * D + d], acc);
    }
    if (part == nullptr) {
      out[q0 + (long)r * D + d] = __float2bfloat16(acc / fmaxf(L, 1e-30f));
    } else {
      part[r * D + d] = acc;
      if (d == 0) *reinterpret_cast<float2*>(part + nrep * D + 2 * r) = make_float2(M, L);
    }
  }
  if (part == nullptr) return;
  // ... and the group's last block to finish combines every split
  if (!splitkv::last_of_group(tickets + tix, active, flag)) return;
  splitkv::combine<D>(work + tix * splits * part_f, active, nrep,
                      [&](int r) { return out + q0 + (long)r * D; }, tickets + tix);
}

template <int D, bool I8, bool CAP>
int launch_mma(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
               const void* tables, const void* pos, void* out, void* work, void* tickets, int B,
               int H, int Hkv, int bs, int bpr, int splits, float scale, float softcap,
               cudaStream_t stream) {
  using C = DCfg<D, I8>;
  cudaError_t err = cudaFuncSetAttribute(paged_decode_mma_kernel<D, I8, CAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(splits, Hkv, B);
  paged_decode_mma_kernel<D, I8, CAP><<<grid, C::NT, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), kp, vp, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<bf16*>(out), static_cast<float*>(work),
      static_cast<int*>(tickets), H, Hkv, bs, bpr, splits, scale, softcap);
  return (int)cudaGetLastError();
}

template <bool I8>
int dispatch_mma(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
                 const void* tables, const void* pos, void* out, void* work, void* tickets,
                 int B, int H, int Hkv, int D, int bs, int bpr, int key_tile, int splits,
                 float scale, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > DCfg<64, I8>::ROWS || bs <= 0 || bpr <= 0 ||
      splits < 1 || key_tile != DCfg<64, I8>::BK)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (work == nullptr || tickets == nullptr)) return (int)cudaErrorInvalidValue;
  const bool cap = softcap > 0.f;
#define DECODE_MMA(D_, CAP_)                                                                 \
  if (D == D_ && cap == CAP_)                                                                \
    return launch_mma<D_, I8, CAP_>(q, kp, vp, ks, vs, tables, pos, out, work, tickets, B, H, \
                                    Hkv, bs, bpr, splits, scale, softcap, s);
  DECODE_MMA(64, false)
  DECODE_MMA(64, true)
  DECODE_MMA(128, false)
  DECODE_MMA(128, true)
#undef DECODE_MMA
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

// The tensor-core variant: bf16 q and out (rows 16-byte aligned); a bf16
// pool here, an int8 one in paged_decode_int8_mma. key_tile is the keys of
// a tile (64: the kernel refuses any other), splits the history splits of
// each (slot, kv head); with splits > 1, work holds B * Hkv * splits
// partials of split_kv.cuh's part_floats(n_rep, D) f32 and tickets B * Hkv
// int32 zeros (left zero). Returns a cudaError_t code (0 on success).
extern "C" int paged_decode_mma(const void* q, const void* k_pool, const void* v_pool,
                                const void* tables, const void* pos, void* out, void* work,
                                void* tickets, int B, int H, int Hkv, int D, int bs, int bpr,
                                int key_tile, int splits, float scale, float softcap,
                                void* stream) {
  return dispatch_mma<false>(q, k_pool, v_pool, nullptr, nullptr, tables, pos, out, work, tickets,
                             B, H, Hkv, D, bs, bpr, key_tile, splits, scale, softcap, stream);
}

// The int8 pool with bf16 q: k_pool, v_pool int8, k_scale, v_scale
// (num_blocks, block_size) f32.
extern "C" int paged_decode_int8_mma(const void* q, const void* k_pool, const void* v_pool,
                                     const void* k_scale, const void* v_scale, const void* tables,
                                     const void* pos, void* out, void* work, void* tickets, int B,
                                     int H, int Hkv, int D, int bs, int bpr, int key_tile,
                                     int splits, float scale, float softcap, void* stream) {
  return dispatch_mma<true>(q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, work, tickets,
                            B, H, Hkv, D, bs, bpr, key_tile, splits, scale, softcap, stream);
}
