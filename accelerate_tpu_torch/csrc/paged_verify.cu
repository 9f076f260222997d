// Paged flash-verify for Hopper (sm_90a): a W-query window per slot over the
// paged KV pool plus the window's own, not yet committed, K/V.
//
// Replaces the TPU kernel accelerate_tpu/ops/paged_decode.py::_verify_kernel
// (launched by paged_flash_verify, called from models/llama.py
// _kernel_verify_override). It serves two engine paths: speculative verify
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
// below the card's ~295 flop/byte ridge (27.5 MB over 3.35 TB/s at the
// phase-2 positions). At the chunk shape (W = 512) the same history feeds
// 2,048 query rows per kv head, and it is bound by operations: 4 * H * D *
// W * (pos + (W + 1) / 2) flops over the 989 TFLOP/s of bf16 tensor cores.
// Two variants; ops/paged_decode.py::verify_kernel_for picks one by q's
// dtype, and verify_plan sizes the tensor-core launch:
//
// * paged_verify_mma (bf16 q; a bf16 pool) and paged_verify_int8_mma (bf16
//   q; an int8 pool): both products on the tensor cores (mma.sync.m16n8k16,
//   bf16 in, f32 accumulators in registers, Q's fragments held in registers
//   for the whole key loop), as flash_fwd.cu's flash_fwd_mma. History rows
//   come through the table (the lanes that copy one key row read its entry
//   together, one broadcast load, and a power-of-two block size turns the
//   row's block and offset into shifts: two integer divisions a row cost
//   the chunk shape 9 % on an NVIDIA H100 80GB HBM3 at 700 W) as 16-byte
//   cp.async copies of the kv head's row into bf16 tiles, XOR-swizzled so
//   ldmatrix (and ldmatrix.trans for V) is free of bank
//   conflicts, double-buffered so tile j+1 loads while tile j computes; an
//   int8 pool's rows arrive raw with their scales and are widened to bf16
//   in shared memory (exact: |q| <= 127), k_scale applied to each score
//   column after the product and v_scale folded into p before p is
//   rounded to bf16 for P.V (l keeps the f32 p); the FMA variant kept p in
//   f32 for an int8 pool, and this rounding is what the 2e-2 limit holds.
//   Rows: R = n_rep * W query rows per (slot, kv head), ordered (window
//   index, head in group) so a GQA group shares each K/V tile. The spec
//   shape (R = 20) takes 32-row blocks of 2 warps and 32-key tiles (a
//   64-row tile would leave 44 of 64 rows idle; 32 keys keep the stages at
//   40-57 KB so 4-5 blocks share an SM while streaming); the chunk shape
//   (R = 2,048) 64-row blocks of 4 warps and 64-key tiles. Split history
//   (flash-decoding): where B * Hkv * row tiles fall short of the SMs (64
//   blocks at the spec shape), each (slot, kv head, row tile)'s history
//   tiles are cut into `splits` contiguous ranges, one block each, so the
//   grid reaches 2 blocks per SM; the window's key tiles go to the last
//   split. Each block writes its partial (acc, m, l) in f32 to scratch
//   the wrapper allocates; the last block of the group to finish (an int32
//   ticket the wrapper keeps per device, reset by that block) combines the
//   partials in split order, so the call stays one launch and a second
//   launch gives the same bits (split_kv.cuh, shared with paged_decode.cu). Only tiles that cross the end of the
//   history, and the window's tiles, pay for masks; softcap is a template
//   switch.
// * paged_verify (f32 q, or f32 q with an int8 pool: paged_verify_int8),
//   the first version: f32 FMA loops on the CUDA cores, since f32 inputs
//   must keep f32 products. One block per (slot, kv head, 64-row tile),
//   which loads its own table row and pos and walks the history
//   positions 0 .. pos-1 in tiles of 64 keys gathered through the table,
//   then the window's keys up to its last query's index; each thread owns
//   a 4x4 register micro-tile of the 64x64 score tile and a 4x(D/16)
//   micro-tile of the output; the online softmax runs in f32. An int8
//   pool is dequantized per element as the tile is loaded, with the
//   position's f32 scale (kv_pool.cuh), and p stays f32.
// Rounding: p is rounded to bf16 before P.V for bf16 q (as the TPU kernel's
// _accumulate and the plain version do for a bf16 pool). The output is
// written once, in q's dtype.
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
#include "mma.cuh"
#include "split_kv.cuh"

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

// ------------------------------------------------------ tensor-core variant
using bf16 = __nv_bfloat16;
using splitkv::kLog2e;
using splitkv::swz;

// RW warps of 16 query rows each, BK keys a tile; I8: an int8 pool with
// per-position scales (the window stays bf16). Each stage holds the bf16 K
// and V tiles and, for an int8 pool, the raw int8 tiles and their scales.
template <int D, int RW, int BK, bool I8>
struct VCfg {
  static constexpr int NT = 32 * RW;
  static constexpr int BQ = 16 * RW;
  static constexpr int ROW = 2 * D;            // bytes of a bf16 row
  static constexpr int CH = D / 8;             // 16-byte chunks of a bf16 row
  static constexpr int TILE = BK * ROW;        // a bf16 K or V tile
  static constexpr int RAW = I8 ? BK * D : 0;  // an int8 K or V tile
  static constexpr int STAGE = 2 * TILE + 2 * RAW + (I8 ? 2 * BK * 4 : 0);
  static constexpr int Q_BYTES = BQ * ROW;
  static constexpr int SMEM = Q_BYTES + 2 * STAGE;
  static constexpr int PART = splitkv::part_floats(BQ, D);  // floats of one split's partial
};

// Grid: (row tiles * splits, Hkv, B); block x = row tile * splits + split.
template <int D, int RW, int BK, bool I8, bool CAP>
__global__ void __launch_bounds__(32 * RW) paged_verify_mma_kernel(
    const bf16* __restrict__ q, const void* __restrict__ k_pool_,
    const void* __restrict__ v_pool_, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const bf16* __restrict__ win_k,
    const bf16* __restrict__ win_v, const int* __restrict__ tables,
    const int* __restrict__ pos, bf16* __restrict__ out, float* __restrict__ work,
    int* __restrict__ tickets, int W, int H, int Hkv, int bs, int bpr, int splits, float scale,
    float softcap) {
  using C = VCfg<D, RW, BK, I8>;
  using PT = typename std::conditional<I8, int8_t, bf16>::type;
  constexpr int NT = C::NT;
  constexpr int NKT = BK / 8;  // score n8 tiles per key tile
  constexpr int NDT = D / 8;   // output n8 tiles
  constexpr int CH8 = D / 16;  // 16-byte chunks of an int8 row
  const PT* k_pool = static_cast<const PT*>(k_pool_);
  const PT* v_pool = static_cast<const PT*>(v_pool_);
  extern __shared__ __align__(128) unsigned char vsmem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row (and +8)
  const int c = lane & 3;   // fragment column pair
  const int split = blockIdx.x % splits;
  const int rt = blockIdx.x / splits;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int nrep = H / Hkv;
  const int R = W * nrep;  // query rows of this (slot, kv head): row = q_idx * nrep + r
  const int r0 = rt * C::BQ;
  const int p = max(pos[b], 0);
  const int nh = min(p, bpr * bs);  // history keys: positions 0 .. nh-1
  const splitkv::PoolRows pool_row = splitkv::pool_rows(tables + (long)b * bpr, bs);
  const long kv_stride = (long)Hkv * D;
  const long q_stride = (long)H * D;

  // this split's history tiles [h_lo, h_lo + n_hist); the last split also
  // takes the window's key tiles up to the block's last query index
  const int n_hist_all = (nh + BK - 1) / BK;
  const int h_lo = (int)((long)split * n_hist_all / splits);
  const int n_hist = (int)((long)(split + 1) * n_hist_all / splits) - h_lo;
  const int qi_hi = (min(r0 + C::BQ, R) - 1) / nrep;
  const int n_win = split == splits - 1 ? qi_hi / BK + 1 : 0;
  const int n_tiles = n_hist + n_win;
  const uint32_t sQ = tc::smem_addr(vsmem);
  auto stage_off = [](int stage) { return C::Q_BYTES + stage * C::STAGE; };

  // tile j of this block into a stage: history rows through the table
  // (16-byte copies of the kv head's row, int8 ones raw with their two
  // scales), window rows from win_k / win_v; rows past the end zero-filled
  auto load_tile = [&](int stage, int j) {
    const uint32_t sk = sQ + stage_off(stage);
    const uint32_t sv = sk + C::TILE;
    if (j < n_hist) {
      const int k0 = (h_lo + j) * BK;
      if constexpr (I8) {
        const uint32_t rk = sv + C::TILE;
        const uint32_t rv = rk + C::RAW;
        for (int i = tid; i < BK * CH8; i += NT) {
          const int r = i / CH8, ch = i % CH8, kk = k0 + r;
          const bool ok = kk < nh;
          const long off = ok ? pool_row(kk) * kv_stride + (long)hk * D + ch * 16 : 0;
          tc::cp_async16(rk + r * D + ch * 16, k_pool + off, ok);
          tc::cp_async16(rv + r * D + ch * 16, v_pool + off, ok);
        }
        if (tid < BK) {
          const int kk = k0 + tid;
          const bool ok = kk < nh;
          const long prow = ok ? pool_row(kk) : 0;
          tc::cp_async4(rv + C::RAW + 4 * tid, k_scale + prow, ok);
          tc::cp_async4(rv + C::RAW + 4 * (BK + tid), v_scale + prow, ok);
        }
      } else {
        for (int i = tid; i < BK * C::CH; i += NT) {
          const int r = i / C::CH, ch = i % C::CH, kk = k0 + r;
          const bool ok = kk < nh;
          const long off = ok ? pool_row(kk) * kv_stride + (long)hk * D + ch * 8 : 0;
          tc::cp_async16(sk + swz<D>(r, ch), k_pool + off, ok);
          tc::cp_async16(sv + swz<D>(r, ch), v_pool + off, ok);
        }
      }
    } else {
      const int k0 = (j - n_hist) * BK;
      for (int i = tid; i < BK * C::CH; i += NT) {
        const int r = i / C::CH, ch = i % C::CH, kk = k0 + r;
        const bool ok = kk < W;
        const long off = ok ? ((long)b * W + kk) * kv_stride + (long)hk * D + ch * 8 : 0;
        tc::cp_async16(sk + swz<D>(r, ch), win_k + off, ok);
        tc::cp_async16(sv + swz<D>(r, ch), win_v + off, ok);
      }
    }
  };

  for (int i = tid; i < C::BQ * C::CH; i += NT) {
    const int r = i / C::CH, ch = i % C::CH, row = r0 + r;
    const bool ok = row < R;
    const long off = ok ? ((long)b * W + row / nrep) * q_stride + (long)(hk * nrep + row % nrep) * D + ch * 8 : 0;
    tc::cp_async16(sQ + swz<D>(r, ch), q + off, ok);
  }
  if (n_tiles > 0) load_tile(0, 0);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  // Q's A fragments stay in registers for the whole key loop
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    tc::ldmatrix_x4(qf[kk], sQ + swz<D>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));

  // this thread's rows: row0 and row0 + 8, query indices qrow[]
  const int row0 = r0 + warp * 16 + g;
  const int qrow[2] = {row0 / nrep, (row0 + 8) / nrep};
  float o[NDT][4];
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums
#pragma unroll
  for (int t = 0; t < NDT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j > 0) {
      tc::cp_async_wait<0>();  // tile j (this thread's copies)
      __syncthreads();         // everyone's copies; tile j-1's reads are done
    }
    if (j + 1 < n_tiles) load_tile(stage ^ 1, j + 1);
    tc::cp_async_commit();
    const uint32_t sk = sQ + stage_off(stage);
    const uint32_t sv = sk + C::TILE;
    const bool hist = j < n_hist;
    const int k0 = hist ? (h_lo + j) * BK : (j - n_hist) * BK;
    bool scaled = false;  // an int8 history tile: k_scale / v_scale per key
    if constexpr (I8) {
      scaled = hist;
      if (hist) {
        // widen the raw int8 tiles to bf16 in the stage's bf16 tiles
        unsigned char* st = vsmem + stage_off(stage);
        splitkv::widen_int8<D, BK, NT>(st + 2 * C::TILE, st);
        __syncthreads();
      }
    }
    const uint32_t s_scales = sv + C::TILE + 2 * C::RAW;  // k scales, then v scales

    // S = Q K^T: K's rows (keys) are B's columns, d-contiguous, so plain
    // ldmatrix gives B fragments for two n8 tiles per x4
    float sc[NKT][4];
#pragma unroll
    for (int t = 0; t < NKT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int np = 0; np < NKT / 2; ++np) {
        uint32_t bk[4];
        tc::ldmatrix_x4(bk, sk + swz<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                         2 * kk + ((lane >> 3) & 1)));
        tc::mma_bf16(sc[2 * np], qf[kk], bk[0], bk[1]);
        tc::mma_bf16(sc[2 * np + 1], qf[kk], bk[2], bk[3]);
      }

    // k_scale per key column (int8), the scale, softcap (a template
    // switch), then the masks, only where some key of the tile may be
    // hidden (branches on uniform values, outside the element loops)
    if (scaled) {
#pragma unroll
      for (int t = 0; t < NKT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[t][e] *= __uint_as_float(tc::lds32(s_scales + 4 * (t * 8 + 2 * c + (e & 1))));
    }
#pragma unroll
    for (int t = 0; t < NKT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (CAP) sc[t][e] = softcap * tanhf(sc[t][e] * scale / softcap);
        else sc[t][e] *= scale;
      }
    if (!hist || k0 + BK > nh) {
#pragma unroll
      for (int t = 0; t < NKT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + t * 8 + 2 * c + (e & 1);
          if (hist) {
            // past the history: not a key at all (weight exactly 0 either way)
            if (kj >= nh) sc[t][e] = -INFINITY;
          } else if (kj >= W) {
            sc[t][e] = -INFINITY;
          } else if (kj > qrow[e >> 1]) {
            sc[t][e] = kNegInf;
          }
        }
    }

    // online softmax on the fragments: a row's BK columns live in the 4
    // lanes that share g
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < NKT; ++t) mx = fmaxf(mx, fmaxf(sc[t][2 * hr], sc[t][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hr], mx);
      const float alpha = tc::exp2_approx((m_r[hr] - m_new) * kLog2e);
      const float m_log2 = m_new * kLog2e;
      m_r[hr] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int t = 0; t < NKT; ++t)
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          const float pe = tc::exp2_approx(fmaf(sc[t][e], kLog2e, -m_log2));
          sc[t][e] = pe;
          rs += pe;
        }
      l_r[hr] = alpha * l_r[hr] + rs;
#pragma unroll
      for (int t = 0; t < NDT; ++t) {
        o[t][2 * hr] *= alpha;
        o[t][2 * hr + 1] *= alpha;
      }
    }
    // an int8 history tile: v_scale folds into p before p is rounded to
    // bf16 (l keeps the unscaled f32 p)
    if (scaled) {
#pragma unroll
      for (int t = 0; t < NKT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[t][e] *= __uint_as_float(tc::lds32(s_scales + 4 * (BK + t * 8 + 2 * c + (e & 1))));
    }

    // O += bf16(P) V: P's C fragments of n8 tiles 2kk, 2kk+1 are the A
    // fragment of k16 step kk; V's rows (keys) are B's k, so ldmatrix.trans
    // gives B fragments for two d tiles per x4
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = tc::pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = tc::pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = tc::pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = tc::pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < NDT / 2; ++dp) {
        uint32_t bv[4];
        tc::ldmatrix_x4_trans(bv, sv + swz<D>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                               2 * dp + (lane >> 4)));
        tc::mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        tc::mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  }
  tc::cp_async_wait<0>();

  float l_row[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_r[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[hr] = l;
  }
  if (splits == 1) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      if (row >= R) continue;
      const float l = fmaxf(l_row[hr], 1e-30f);
      bf16* orow = out + ((long)b * W + row / nrep) * q_stride + (long)(hk * nrep + row % nrep) * D + 2 * c;
#pragma unroll
      for (int t = 0; t < NDT; ++t)
        *reinterpret_cast<uint32_t*>(orow + t * 8) = tc::pack_bf16(o[t][2 * hr] / l, o[t][2 * hr + 1] / l);
    }
    return;
  }

  // split history: this block's partial (acc, m, l) in f32 ...
  const long tix = ((long)b * Hkv + hk) * (gridDim.x / splits) + rt;
  float* part = work + (tix * splits + split) * C::PART;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = warp * 16 + g + 8 * hr;
#pragma unroll
    for (int t = 0; t < NDT; ++t)
      *reinterpret_cast<float2*>(part + r * D + t * 8 + 2 * c) = make_float2(o[t][2 * hr], o[t][2 * hr + 1]);
    if (c == 0) *reinterpret_cast<float2*>(part + C::BQ * D + 2 * r) = make_float2(m_r[hr], l_row[hr]);
  }
  // ... and the last of the (slot, kv head, row tile)'s blocks to finish
  // combines all splits (split_kv.cuh); its flag lives in Q's tile, dead
  // since Q went to registers: no static shared memory, so two int8 chunk
  // blocks still share an SM
  if (!splitkv::last_of_group(tickets + tix, splits, reinterpret_cast<int*>(vsmem))) return;
  splitkv::combine<D>(work + tix * splits * C::PART, splits, C::BQ, [&](int r) -> bf16* {
    const int row = r0 + r;
    if (row >= R) return nullptr;
    return out + ((long)b * W + row / nrep) * q_stride + (long)(hk * nrep + row % nrep) * D;
  }, tickets + tix);
}

template <int D, int RW, int BK, bool I8, bool CAP>
int launch_mma(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
               const void* wk, const void* wv, const void* tables, const void* pos, void* out,
               void* work, void* tickets, int B, int W, int H, int Hkv, int bs, int bpr,
               int splits, float scale, float softcap, cudaStream_t stream) {
  using C = VCfg<D, RW, BK, I8>;
  cudaError_t err = cudaFuncSetAttribute(paged_verify_mma_kernel<D, RW, BK, I8, CAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int rows = W * (H / Hkv);
  dim3 grid(((rows + C::BQ - 1) / C::BQ) * splits, Hkv, B);
  paged_verify_mma_kernel<D, RW, BK, I8, CAP><<<grid, C::NT, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), kp, vp, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const bf16*>(wk), static_cast<const bf16*>(wv),
      static_cast<const int*>(tables), static_cast<const int*>(pos), static_cast<bf16*>(out),
      static_cast<float*>(work), static_cast<int*>(tickets), W, H, Hkv, bs, bpr, splits, scale,
      softcap);
  return (int)cudaGetLastError();
}

// (block_rows, key_tile) (32, 32): 2 warps (the spec shape); (64, 64): 4
// warps (the chunk shape); ops/paged_decode.py::verify_plan picks the pair
template <bool I8>
int dispatch_mma(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
                 const void* wk, const void* wv, const void* tables, const void* pos, void* out,
                 void* work, void* tickets, int B, int W, int H, int Hkv, int D, int bs, int bpr,
                 int block_rows, int key_tile, int splits, float scale, float softcap,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || W <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || bs <= 0 || bpr <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
  if (splits > 1 && (work == nullptr || tickets == nullptr)) return (int)cudaErrorInvalidValue;
  const bool cap = softcap > 0.f;
#define VERIFY_MMA(D_, RW_, BK_, CAP_)                                                          \
  if (D == D_ && block_rows == 16 * RW_ && key_tile == BK_ && cap == CAP_)                      \
    return launch_mma<D_, RW_, BK_, I8, CAP_>(q, kp, vp, ks, vs, wk, wv, tables, pos, out, work, \
                                              tickets, B, W, H, Hkv, bs, bpr, splits, scale,     \
                                              softcap, s);
  VERIFY_MMA(64, 2, 32, false)
  VERIFY_MMA(64, 2, 32, true)
  VERIFY_MMA(64, 4, 64, false)
  VERIFY_MMA(64, 4, 64, true)
  VERIFY_MMA(128, 2, 32, false)
  VERIFY_MMA(128, 2, 32, true)
  VERIFY_MMA(128, 4, 64, false)
  VERIFY_MMA(128, 4, 64, true)
#undef VERIFY_MMA
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

// The tensor-core variant: bf16 q, window and out (rows 16-byte aligned);
// a bf16 pool here, an int8 one in paged_verify_int8_mma. block_rows is 32
// or 64 (query rows of a block), key_tile the keys of a tile (32 with 32
// rows, 64 with 64), splits the history splits of each (slot,
// kv head, row tile); with splits > 1, work holds B * Hkv * row tiles *
// splits partials of block_rows * (D + 2) f32 and tickets B * Hkv * row
// tiles int32 zeros (left zero). Returns a cudaError_t code (0 on success).
extern "C" int paged_verify_mma(const void* q, const void* k_pool, const void* v_pool,
                                const void* win_k, const void* win_v, const void* tables,
                                const void* pos, void* out, void* work, void* tickets, int B,
                                int W, int H, int Hkv, int D, int bs, int bpr, int block_rows,
                                int key_tile, int splits, float scale, float softcap,
                                void* stream) {
  return dispatch_mma<false>(q, k_pool, v_pool, nullptr, nullptr, win_k, win_v, tables, pos, out,
                             work, tickets, B, W, H, Hkv, D, bs, bpr, block_rows, key_tile,
                             splits, scale, softcap, stream);
}

// The int8 pool with bf16 q: k_pool, v_pool int8, k_scale, v_scale
// (num_blocks, block_size) f32.
extern "C" int paged_verify_int8_mma(const void* q, const void* k_pool, const void* v_pool,
                                     const void* k_scale, const void* v_scale, const void* win_k,
                                     const void* win_v, const void* tables, const void* pos,
                                     void* out, void* work, void* tickets, int B, int W, int H,
                                     int Hkv, int D, int bs, int bpr, int block_rows, int key_tile,
                                     int splits, float scale, float softcap, void* stream) {
  return dispatch_mma<true>(q, k_pool, v_pool, k_scale, v_scale, win_k, win_v, tables, pos, out,
                            work, tickets, B, W, H, Hkv, D, bs, bpr, block_rows, key_tile,
                            splits, scale, softcap, stream);
}
