// Flash-attention forward for Hopper (sm_90a): two variants.
//
// Replaces the TPU kernel accelerate_tpu/ops/flash_attention.py:98
// _fwd_kernel (its pallas_call at :206, launched by _flash_fwd). Computes,
// per (batch, q head), the tiled online-softmax attention of a q tile
// against every visible kv tile and writes `out` and the per-row f32
// log-sum-exp `lse` (kept for the backward kernels and for LSE merges).
//
// What bounds it on this card: at the training shape (B=4 S=2048 H=32
// D=128, causal) the 4*D*H*B*S(S+1)/2 operations over the 989 TFLOP/s of
// bf16 tensor cores; at the serving prefill shape (B=1 S=512) the bytes
// of q, k, v, out and lse over 3.35 TB/s. Which variant serves which
// inputs (ops/flash_attention.py::flash_fwd_kernel_for):
//
// * flash_fwd_mma (bf16 q/k/v): both products on the tensor cores
//   (mma.sync.m16n8k16, bf16 in, f32 accumulators in registers; not
//   wgmma, for the reason given in quant_matmul.cu). A block is 4 warps
//   and 64 or 128 q rows (ops/flash_attention.py::flash_fwd_block_q: 128
//   where that still gives 2 blocks per SM), 16 or 32 rows a warp; at 32,
//   each K/V fragment feeds two row tiles. Q's fragments are loaded with
//   ldmatrix once and stay in registers for the whole kv loop where they
//   fit beside the accumulators (16 rows a warp, or D = 64), and are
//   re-read from shared memory per step otherwise. K and
//   V tiles of 64 rows arrive as bf16 through a double-buffered cp.async
//   ring (tile j+1 in flight while tile j is computed), XOR-swizzled so
//   that ldmatrix (and ldmatrix.trans for V) is free of bank conflicts:
//   one barrier per kv tile. The online softmax runs on the score
//   fragments in registers (exp2 by the special-function unit, one FFMA
//   a score); P is rounded to bf16 in registers and fed
//   straight back as the A operand of P.V (as the TPU kernel rounds P to
//   V's dtype), while l sums the f32 P. Only tiles on the causal diagonal,
//   at a window's edge, past Skv, or with segment ids pay for masks,
//   compared on fragment coordinates. q tiles are issued last tile first
//   (the heaviest under a causal mask), every head's before the next.
// * flash_fwd (f32 q/k/v): f32 FMA loops on the CUDA cores, since f32
//   inputs must keep f32 products (TF32 would be another function). Each
//   thread owns a 4x4 register micro-tile of the score tile and a 4x(D/16)
//   micro-tile of the output.
//
// Layout (the JAX package's public layout, read in place, no transposes):
//   q, out (B, Sq, H, D); k, v (B, Skv, Hkv, D); lse (B, H, Sq) f32;
//   qseg (B, Sq), kseg (B, Skv) int32 packed-sequence labels, or null.
// GQA: q head h reads kv head h / (H / Hkv); KV is never repeated. The kv
// loop runs inside the block, because blocks run in no order and nothing
// carries between them (the TPU kernel carried acc/m/l across a
// sequential grid dimension). Tiles that hold no visible (q, k) pair are
// skipped (_block_visible). Masking follows _mask_scores: softcap first,
// then causal (q >= k), then the Mistral window (q - k < window), then
// equal segment labels, with the finite NEG_INF = -1e6 (segments prune no
// tiles). Keys past Skv read as zeros and take no weight at all (-inf), as
// in the backward kernels (the JAX kernel needs S divisible by its block;
// these mask the ragged edge instead).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma.cuh"

namespace {

// ------------------------------------------------------------ FMA variant
// Grid: (ceil(Sq / BQ), B * H), 256 threads.

constexpr float kNegInf = -1.0e6f;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;  // 16 x 16 threads; thread (ty, tx)

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1))
         + sizeof(int) * (BQ + BK);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, const int* __restrict__ qseg,
    const int* __restrict__ kseg, int Sq, int Skv, int H, int Hkv, int causal,
    int window, float softcap, float scale) {
  constexpr int DP = D + 1;   // padded rows: column reads hit distinct banks
  constexpr int PP = BK + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sP = sV + BK * D;
  int* sQseg = reinterpret_cast<int*>(sP + BQ * PP);
  int* sKseg = sQseg + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hkv * D;
  const float* qb = q + (long)b * Sq * q_stride + (long)h * D;
  const float* kb = k + (long)b * Skv * kv_stride + (long)hk * D;
  const float* vb = v + (long)b * Skv * kv_stride + (long)hk * D;
  const bool masked = causal || window > 0;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int qi = q0 + r;
    sQ[r * DP + c] = qi < Sq ? qb[(long)qi * q_stride + c] : 0.f;
  }
  for (int i = tid; i < BQ; i += NT) {
    const int qi = q0 + i;
    sQseg[i] = (qi < Sq && qseg) ? qseg[(long)b * Sq + qi] : 0;
  }

  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_i[r] = kNegInf;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  // tile pruning (_block_visible): causal keeps tiles whose first key is at
  // or below the tile's last real query; the window drops tiles whose last
  // key is out of every row's window
  const int q_hi = min(q0 + BQ, Sq) - 1;
  int j_end = (Skv + BK - 1) / BK;
  if (masked) j_end = min(j_end, q_hi / BK + 1);
  int j_start = 0;
  if (window > 0) {
    const int t = q0 - window - (BK - 1);  // visible iff j*BK > t
    j_start = t < 0 ? 0 : t / BK + 1;
  }

  for (int j = j_start; j < j_end; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's sK/sV/sP reads are done
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, c = idx % D;
      const int kj = k0 + r;
      const bool in = kj < Skv;
      sK[r * DP + c] = in ? kb[(long)kj * kv_stride + c] : 0.f;
      sV[r * D + c] = in ? vb[(long)kj * kv_stride + c] : 0.f;
    }
    for (int i = tid; i < BK; i += NT) {
      const int kj = k0 + i;
      sKseg[i] = (kj < Skv && kseg) ? kseg[(long)b * Skv + kj] : 0;
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
      const int qi = q0 + ty + 16 * r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        float x = s[r][c] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool vis = true;
        if (masked) vis = qi >= kj;
        if (window > 0) vis = vis && (qi - kj) < window;
        if (qseg) vis = vis && sQseg[ty + 16 * r] == sKseg[tx + 16 * c];
        // every processed tile holds a key below Skv, so each row's max
        // stays finite and exp(-inf - m) is an exact 0
        s[r][c] = kj < Skv ? (vis ? x : kNegInf) : __int_as_float(0xff800000);  // -inf
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
        const float p = expf(s[r][c] - m_new);
        rs += p;
        sP[(ty + 16 * r) * PP + tx + 16 * c] = p;
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
    const int qi = q0 + ty + 16 * r;
    if (qi >= Sq) continue;
    const float l = fmaxf(l_i[r], 1e-30f);
    float* orow = out + ((long)b * Sq + qi) * q_stride + (long)h * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = acc[r][c] / l;
    if (tx == 0) lse[((long)b * H + h) * Sq + qi] = m_i[r] + logf(l);
  }
}

template <int D>
int launch_fma(const void* q, const void* k, const void* v, void* out, void* lse,
               const void* qseg, const void* kseg, int B, int Sq, int Skv, int H,
               int Hkv, int causal, int window, float softcap, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), Sq, Skv, H, Hkv, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------- tensor-core variant
constexpr int MBK = 64;   // kv rows per tile
constexpr int MNT = 128;  // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

// MT m16 row tiles per warp: a block holds 64 * MT q rows
template <int D, int MT>
struct MmaCfg {
  static constexpr int BQ = 64 * MT;
  static constexpr int ROW = D * 2;           // bytes per bf16 row
  static constexpr int CH = D / 8;            // 16-byte chunks per row
  static constexpr int TILE = MBK * ROW;      // one K or V tile
  static constexpr int Q_BYTES = BQ * ROW;
  static constexpr int STAGE = 2 * TILE + MBK * 4;  // K, V, kv segment ids
  static constexpr int SMEM = Q_BYTES + 2 * STAGE;
  // Q's fragments stay in registers when they fit beside the accumulators;
  // with 32 rows a warp at D = 128 they are reloaded from shared memory
  static constexpr bool Q_IN_REGS = MT * D <= 128;
};

// chunk ch of row r sits at chunk ch ^ (r % 8) of its row: the 8 rows an
// ldmatrix phase reads at one logical chunk land in 8 distinct bank groups
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return r * (D * 2) + ((ch ^ (r & 7)) << 4);
}

using bf16 = __nv_bfloat16;

// Grid: (B * H, ceil(Sq / BQ)); block y runs q tile gridDim.y - 1 - y.
// Each warp owns 16 * MT q rows; MT = 2 halves the K/V fragment reads per
// product (each K or V fragment feeds two row tiles).
template <int D, int MT>
__global__ void __launch_bounds__(MNT) flash_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, float* __restrict__ lse, const int* __restrict__ qseg,
    const int* __restrict__ kseg, int Sq, int Skv, int H, int Hkv, int causal, int window,
    float softcap, float scale) {
  using C = MmaCfg<D, MT>;
  constexpr int NKT = MBK / 8;  // score n8 tiles per kv tile
  constexpr int NDT = D / 8;    // output n8 tiles
  extern __shared__ __align__(128) unsigned char mma_smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row (and +8)
  const int c = lane & 3;   // fragment column pair
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;
  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hkv * D;
  const bf16* qb = q + (long)b * Sq * q_stride + (long)h * D;
  const bf16* kb = k + (long)b * Skv * kv_stride + (long)hk * D;
  const bf16* vb = v + (long)b * Skv * kv_stride + (long)hk * D;
  const int* ksb = kseg ? kseg + (long)b * Skv : nullptr;
  const bool masked = causal || window > 0;
  const uint32_t sQ = tc::smem_addr(mma_smem);
  const int wrow = warp * 16 * MT;  // the warp's first row in the block

  // tile pruning (_block_visible), as in the FMA variant
  const int q_hi = min(q0 + C::BQ, Sq) - 1;
  int j_end = (Skv + MBK - 1) / MBK;
  if (masked) j_end = min(j_end, q_hi / MBK + 1);
  int j_start = 0;
  if (window > 0) {
    const int t = q0 - window - (MBK - 1);
    j_start = t < 0 ? 0 : t / MBK + 1;
  }

  auto load_kv = [&](int stage, int j) {
    const uint32_t sk = sQ + C::Q_BYTES + stage * C::STAGE;
    const uint32_t sv = sk + C::TILE;
    const int k0 = j * MBK;
#pragma unroll
    for (int i = tid; i < MBK * C::CH; i += MNT) {
      const int r = i / C::CH, ch = i % C::CH;
      const bool ok = k0 + r < Skv;
      const long off = ok ? (long)(k0 + r) * kv_stride + ch * 8 : 0;
      tc::cp_async16(sk + swz<D>(r, ch), kb + off, ok);
      tc::cp_async16(sv + swz<D>(r, ch), vb + off, ok);
    }
    if (ksb && tid < MBK) {
      const bool ok = k0 + tid < Skv;
      tc::cp_async4(sv + C::TILE + 4 * tid, ksb + (ok ? k0 + tid : 0), ok);
    }
  };

#pragma unroll
  for (int i = tid; i < C::BQ * C::CH; i += MNT) {
    const int r = i / C::CH, ch = i % C::CH;
    const bool ok = q0 + r < Sq;
    tc::cp_async16(sQ + swz<D>(r, ch), qb + (ok ? (long)(q0 + r) * q_stride + ch * 8 : 0), ok);
  }
  if (j_start < j_end) load_kv(0, j_start);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  // Q's A fragment of row tile i at k16 step kk
  uint32_t qf[C::Q_IN_REGS ? MT : 1][C::Q_IN_REGS ? D / 16 : 1][4];
  auto q_frag = [&](int i, int kk, uint32_t (&a)[4]) {
    const uint32_t addr = sQ + swz<D>(wrow + i * 16 + (lane & 15), 2 * kk + (lane >> 4));
    if constexpr (C::Q_IN_REGS) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = qf[i][kk][e];
    } else {
      tc::ldmatrix_x4(a, addr);
    }
  };
  if constexpr (C::Q_IN_REGS) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        tc::ldmatrix_x4(qf[i][kk], sQ + swz<D>(wrow + i * 16 + (lane & 15), 2 * kk + (lane >> 4)));
  }

  // this thread's rows: row0 + 16 i + 8 hr
  const int row0 = q0 + wrow + g;
  int qs[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qi = row0 + 16 * i + 8 * hr;
      qs[i][hr] = (qseg && qi < Sq) ? qseg[(long)b * Sq + qi] : 0;
    }
  float o[MT][NDT][4];
  float m_r[MT][2], l_r[MT][2];  // l_r: this thread's share of the row sums
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int t = 0; t < NDT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][t][e] = 0.f;
    m_r[i][0] = m_r[i][1] = kNegInf;
    l_r[i][0] = l_r[i][1] = 0.f;
  }

  for (int j = j_start; j < j_end; ++j) {
    const int stage = (j - j_start) & 1;
    if (j > j_start) {
      tc::cp_async_wait<0>();  // tile j (this thread's copies)
      __syncthreads();         // everyone's copies; tile j-1's reads are done
    }
    if (j + 1 < j_end) load_kv(stage ^ 1, j + 1);
    tc::cp_async_commit();
    const uint32_t sk = sQ + C::Q_BYTES + stage * C::STAGE;
    const uint32_t sv = sk + C::TILE;
    const int k0 = j * MBK;

    // S = Q K^T: K's rows (kv) are B's columns, d-contiguous, so plain
    // ldmatrix gives B fragments for two n8 tiles per x4
    float sc[MT][NKT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int t = 0; t < NKT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) q_frag(i, kk, a[i]);
#pragma unroll
      for (int np = 0; np < NKT / 2; ++np) {
        uint32_t bk[4];
        tc::ldmatrix_x4(bk, sk + swz<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                        2 * kk + ((lane >> 3) & 1)));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          tc::mma_bf16(sc[i][2 * np], a[i], bk[0], bk[1]);
          tc::mma_bf16(sc[i][2 * np + 1], a[i], bk[2], bk[3]);
        }
      }
    }

    // scale and softcap, then the masks, only where some pair of the tile
    // may be hidden (branches on uniform values, outside the element loops)
    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int t = 0; t < NKT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[i][t][e] = softcap * tanhf(sc[i][t][e] * scale / softcap);
    } else {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int t = 0; t < NKT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[i][t][e] *= scale;
    }
    const bool need_mask = qseg != nullptr || k0 + MBK > Skv ||
                           (masked && k0 + MBK - 1 > q0) ||
                           (window > 0 && q0 + C::BQ - 1 - k0 >= window);
    if (need_mask) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int t = 0; t < NKT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = row0 + 16 * i + ((e >> 1) << 3);
            const int kc = t * 8 + 2 * c + (e & 1);
            const int kj = k0 + kc;
            bool vis = true;
            if (masked) vis = qi >= kj;
            if (window > 0) vis = vis && (qi - kj) < window;
            if (qseg) vis = vis && qs[i][e >> 1] == (int)tc::lds32(sv + C::TILE + 4 * kc);
            // every processed tile holds a key below Skv, so each row's max
            // stays finite and exp(-inf - m) is an exact 0
            sc[i][t][e] = kj < Skv ? (vis ? sc[i][t][e] : kNegInf) : __int_as_float(0xff800000);
          }
    }

    // online softmax on the fragments: a row's 64 columns live in the 4
    // lanes that share g
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = kNegInf;
#pragma unroll
        for (int t = 0; t < NKT; ++t)
          mx = fmaxf(mx, fmaxf(sc[i][t][2 * hr], sc[i][t][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[i][hr], mx);
        const float alpha = tc::exp2_approx((m_r[i][hr] - m_new) * kLog2e);
        const float m_log2 = m_new * kLog2e;
        m_r[i][hr] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int t = 0; t < NKT; ++t)
#pragma unroll
          for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
            const float p = tc::exp2_approx(fmaf(sc[i][t][e], kLog2e, -m_log2));
            sc[i][t][e] = p;
            rs += p;
          }
        l_r[i][hr] = alpha * l_r[i][hr] + rs;
#pragma unroll
        for (int t = 0; t < NDT; ++t) {
          o[i][t][2 * hr] *= alpha;
          o[i][t][2 * hr + 1] *= alpha;
        }
      }

    // O += bf16(P) V: P's C fragments of n8 tiles 2kk, 2kk+1 are the A
    // fragment of k16 step kk; V's rows (kv) are B's k, so ldmatrix.trans
    // gives B fragments for two d tiles per x4
#pragma unroll
    for (int kk = 0; kk < MBK / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        pa[i][0] = tc::pack_bf16(sc[i][2 * kk][0], sc[i][2 * kk][1]);
        pa[i][1] = tc::pack_bf16(sc[i][2 * kk][2], sc[i][2 * kk][3]);
        pa[i][2] = tc::pack_bf16(sc[i][2 * kk + 1][0], sc[i][2 * kk + 1][1]);
        pa[i][3] = tc::pack_bf16(sc[i][2 * kk + 1][2], sc[i][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < NDT / 2; ++dp) {
        uint32_t bv[4];
        tc::ldmatrix_x4_trans(bv, sv + swz<D>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                              2 * dp + (lane >> 4)));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          tc::mma_bf16(o[i][2 * dp], pa[i], bv[0], bv[1]);
          tc::mma_bf16(o[i][2 * dp + 1], pa[i], bv[2], bv[3]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float l = l_r[i][hr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int qi = row0 + 16 * i + 8 * hr;
      if (qi >= Sq) continue;
      l = fmaxf(l, 1e-30f);
      bf16* orow = out + ((long)b * Sq + qi) * q_stride + (long)h * D + 2 * c;
#pragma unroll
      for (int t = 0; t < NDT; ++t)
        *reinterpret_cast<uint32_t*>(orow + t * 8) =
            tc::pack_bf16(o[i][t][2 * hr] / l, o[i][t][2 * hr + 1] / l);
      if (c == 0) lse[((long)b * H + h) * Sq + qi] = m_r[i][hr] + logf(l);
    }
}

template <int D, int MT>
int launch_mma(const void* q, const void* k, const void* v, void* out, void* lse,
               const void* qseg, const void* kseg, int B, int Sq, int Skv, int H, int Hkv,
               int causal, int window, float softcap, float scale, cudaStream_t stream) {
  constexpr int smem = MmaCfg<D, MT>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Sq + MmaCfg<D, MT>::BQ - 1) / MmaCfg<D, MT>::BQ);
  flash_fwd_mma_kernel<D, MT><<<grid, MNT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), Sq, Skv, H, Hkv, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The FMA variant: float32 q/k/v. window <= 0 and softcap <= 0 mean off;
// qseg/kseg null mean no segments. Returns a cudaError_t code (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out,
                         void* lse, const void* qseg, const void* kseg, int B,
                         int Sq, int Skv, int H, int Hkv, int D, int causal,
                         int window, float softcap, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || B <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return launch_fma<64>(q, k, v, out, lse, qseg, kseg, B, Sq, Skv, H, Hkv, causal, window, softcap, scale, s);
  if (D == 128)
    return launch_fma<128>(q, k, v, out, lse, qseg, kseg, B, Sq, Skv, H, Hkv, causal, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core variant: bfloat16 q/k/v (16-byte aligned), the same
// arguments plus block_q, the q rows of a block (64 or 128). Returns a
// cudaError_t code (0 on success).
extern "C" int flash_fwd_mma(const void* q, const void* k, const void* v, void* out,
                             void* lse, const void* qseg, const void* kseg, int B,
                             int Sq, int Skv, int H, int Hkv, int D, int causal,
                             int window, int block_q, float softcap, float scale,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || B <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
#define FLASH_MMA(D_, MT_)                                                                  \
  if (D == D_ && block_q == 64 * MT_)                                                        \
    return launch_mma<D_, MT_>(q, k, v, out, lse, qseg, kseg, B, Sq, Skv, H, Hkv, causal,     \
                               window, softcap, scale, s);
  FLASH_MMA(64, 1)
  FLASH_MMA(64, 2)
  FLASH_MMA(128, 1)
  FLASH_MMA(128, 2)
#undef FLASH_MMA
  return (int)cudaErrorInvalidValue;
}
