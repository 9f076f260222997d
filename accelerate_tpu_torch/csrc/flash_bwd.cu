// Flash-attention backward for Hopper (sm_90a): two kernels, dq and dk/dv,
// each in two variants with their own C entry points.
//
// Replaces the TPU kernels accelerate_tpu/ops/flash_attention.py::
// _bwd_dq_kernel (B2) and ::_bwd_dkv_kernel (B3), launched by _flash_bwd.
// Both use the recompute formulation: the forward (csrc/flash_fwd.cu) saved
// only `out` and the per-row f32 `lse`; each kernel recomputes, per tile,
//   s  = softcap(q k^T * scale), masked       p  = exp(s - lse)
//   dp = do v^T                               ds = p * (dp - delta) [* (1 - t^2)]
// with delta = rowsum(out * do) - dlse computed by the wrapper in PyTorch.
//   B2: dq = sum over kv tiles of ds k * scale
//   B3: dv = sum of p^T do, dk = sum of ds^T q * scale, over the kv head's
//       n_rep q heads and every visible q tile.
// As the Pallas kernels do, p is rounded to do's dtype before p^T do and ds
// to q/k's dtype before the two ds products, so bf16 results track the
// plain version (ops/flash_attention.py::flash_attention_bwd_reference).
//
// Why two kernels and no atomics: dq sums over kv tiles and dk/dv over q
// tiles; one pass (FlashAttention-2) would add dq across blocks with
// atomics in no fixed order, so bf16 gradients would change run to run.
// Each kernel here owns its output tile and writes it once: deterministic.
//
// What bounds it on the card: at the training shape (B=4, S=2048, H=32,
// Hkv=8, D=128) B2 does three products and B3 four over the S(S+1)/2
// visible pairs, ~0.5 TFLOP together against ~0.2 GB of operands: bound by
// the tensor cores' 989 TFLOP/s (bf16). The variants (chosen in Python by
// ops/flash_attention.py::flash_bwd_kernel_for from the dtype):
//
// * flash_bwd_dq_mma / flash_bwd_dkv_mma (bf16): the products on the tensor
//   cores (mma.sync.m16n8k16, bf16 in, f32 accumulators in registers; see
//   the section below).
// * flash_bwd_dq / flash_bwd_dkv (f32, and bf16 when asked for by name):
//   f32 FMA loops on the CUDA cores. An f32 backward must keep f32 products
//   (TF32 would be another function). Each thread owns 4x4 register
//   micro-tiles of the 64x64 score tiles and 4x(D/16) micro-tiles of the
//   64xD accumulators, so every shared-memory read feeds 4 FMAs.
// Both skip tiles with no visible (q, k) pair (causal, window) and map q
// head h to kv head h / n_rep without repeating K/V (GQA).
//
// Layout (the JAX package's public layout, read in place):
//   q, do, dq (B, Sq, H, D); k, v, dk, dv (B, Skv, Hkv, D);
//   lse, delta (B, H, Sq) f32; qseg (B, Sq), kseg (B, Skv) int32 or null.
// Masks follow _mask_scores: softcap first, then causal (q >= k), then the
// window (q - k < window), then equal segment labels, with the finite
// NEG_INF = -1e6. Rows and keys past the sequence ends (any S works; the
// JAX kernels need S divisible by their block) contribute nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr float kNegInf = -1.0e6f;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;  // 16 x 16 threads; thread (ty, tx)
constexpr int PP = BK + 1;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// the value x takes once stored in T (the Pallas kernels' .astype)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// whether any (q, k) pair of the tile is visible (_block_visible): causal
// needs some k <= q, the window some q - k < window
__device__ __forceinline__ bool tile_visible(int q_lo, int q_hi, int k_lo, int k_hi,
                                             int causal, int window) {
  if ((causal || window > 0) && k_lo > q_hi) return false;
  if (window > 0 && q_lo - k_hi >= window) return false;
  return true;
}

__device__ __forceinline__ bool pair_visible(int qi, int kj, int causal, int window) {
  bool vis = true;
  if (causal || window > 0) vis = qi >= kj;
  if (window > 0) vis = vis && (qi - kj) < window;
  return vis;
}

// rows [r0, r0 + 64) of one head of a (B, S, Hx, D) tensor into shared
// memory (row stride LD), zeros past row S
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* base, long row_stride,
                                          int r0, int S) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int row = r0 + r;
    dst[r * LD + c] = row < S ? to_f(base[(long)row * row_stride + c]) : 0.f;
  }
}

// out[r][c] = sum_d A[ty + 16r][d] * B[tx + 16c][d]: the thread's 4x4 part
// of a 64x64 product of two row-major 64xD tiles (LD = D + 1, so the column
// walk over B hits distinct banks)
template <int D, int LD>
__device__ __forceinline__ void rowdot(const float* A, const float* B, int ty, int tx,
                                       float out[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[r][c] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[(ty + 16 * r) * LD + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = B[(tx + 16 * c) * LD + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) out[r][c] = fmaf(a[r], b[c], out[r][c]);
  }
}

// acc[r][c] += sum_t P'[ty + 16r][t] * X[t][tx + 16c] for a 64x64 P in
// shared memory (row stride PP) and a 64xD tile X (row stride LD); P' is P,
// or its transpose when TRANS (B3 sums over the q rows of P)
template <int D, int LD, bool TRANS>
__device__ __forceinline__ void accum(const float* P, const float* X, int ty, int tx,
                                      float acc[4][D / 16]) {
#pragma unroll 4
  for (int t = 0; t < 64; ++t) {
    float p[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[r] = TRANS ? P[t * PP + ty + 16 * r] : P[(ty + 16 * r) * PP + t];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float x = X[t * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(p[r], x, acc[r][c]);
    }
  }
}

// p and ds of one score element: s the raw q.k, dp the raw do.v
__device__ __forceinline__ void p_and_ds(float s, float dp, bool in_range, bool vis,
                                         float lse, float delta, float softcap,
                                         float scale, float* p_out, float* ds_out) {
  float x = s * scale;
  float dcap = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(x / softcap);
    x = softcap * t;
    dcap = 1.f - t * t;
  }
  const float p = in_range ? expf((vis ? x : kNegInf) - lse) : 0.f;
  *p_out = p;
  *ds_out = p * (dp - delta) * dcap;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * PP + 2 * BQ)
         + sizeof(int) * (BQ + BK);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * PP + 2 * BQ)
         + sizeof(int) * (BQ + BK);
}

// B2. Grid (ceil(Sq / BQ), B * H): one block per (b, h, 64-row q tile).
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ qseg,
    const int* __restrict__ kseg, T* __restrict__ dq, int Sq, int Skv, int H, int Hkv,
    int causal, int window, float softcap, float scale) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + BQ * LD;
  float* sK = sDO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sDS = sV + BK * LD;
  float* sLse = sDS + BQ * PP;
  float* sDelta = sLse + BQ;
  int* sQseg = reinterpret_cast<int*>(sDelta + BQ);
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
  const long q_off = (long)b * Sq * q_stride + (long)h * D;
  const long kv_off = (long)b * Skv * kv_stride + (long)hk * D;

  load_tile<T, D, LD>(sQ, q + q_off, q_stride, q0, Sq);
  load_tile<T, D, LD>(sDO, dout + q_off, q_stride, q0, Sq);
  for (int i = tid; i < BQ; i += NT) {
    const int qi = q0 + i;
    const bool in = qi < Sq;
    sLse[i] = in ? lse[((long)b * H + h) * Sq + qi] : 0.f;
    sDelta[i] = in ? delta[((long)b * H + h) * Sq + qi] : 0.f;
    sQseg[i] = (in && qseg) ? qseg[(long)b * Sq + qi] : 0;
  }

  float acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;

  const int q_hi = min(q0 + BQ, Sq) - 1;
  const int nk = (Skv + BK - 1) / BK;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    if (!tile_visible(q0, q_hi, k0, min(k0 + BK, Skv) - 1, causal, window)) continue;
    __syncthreads();  // the q-side loads, or the previous tile's reads, are done
    load_tile<T, D, LD>(sK, k + kv_off, kv_stride, k0, Skv);
    load_tile<T, D, LD>(sV, v + kv_off, kv_stride, k0, Skv);
    for (int i = tid; i < BK; i += NT) {
      const int kj = k0 + i;
      sKseg[i] = (kj < Skv && kseg) ? kseg[(long)b * Skv + kj] : 0;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    rowdot<D, LD>(sQ, sK, ty, tx, s);
    rowdot<D, LD>(sDO, sV, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty + 16 * r;
      const int qi = q0 + row;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c;
        const int kj = k0 + col;
        bool vis = pair_visible(qi, kj, causal, window);
        if (qseg) vis = vis && sQseg[row] == sKseg[col];
        float p, ds;
        p_and_ds(s[r][c], dp[r][c], kj < Skv, vis, sLse[row], sDelta[row], softcap,
                 scale, &p, &ds);
        sDS[row * PP + col] = round_to<T>(ds);
      }
    }
    __syncthreads();
    accum<D, LD, false>(sDS, sK, ty, tx, acc);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= Sq) continue;
    T* row = dq + q_off + (long)qi * q_stride;
#pragma unroll
    for (int c = 0; c < DC; ++c) row[tx + 16 * c] = from_f<T>(acc[r][c] * scale);
  }
}

// B3. Grid (ceil(Skv / BK), B * Hkv): one block per (b, kv head, 64-row kv
// tile), looping over the group's n_rep q heads x the visible q tiles.
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ qseg,
    const int* __restrict__ kseg, T* __restrict__ dk, T* __restrict__ dv, int Sq,
    int Skv, int H, int Hkv, int causal, int window, float softcap, float scale) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sDO = sQ + BQ * LD;
  float* sP = sDO + BQ * LD;
  float* sDS = sP + BQ * PP;
  float* sLse = sDS + BQ * PP;
  float* sDelta = sLse + BQ;
  int* sQseg = reinterpret_cast<int*>(sDelta + BQ);
  int* sKseg = sQseg + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bg = blockIdx.y;
  const int b = bg / Hkv;
  const int hk = bg % Hkv;
  const int n_rep = H / Hkv;
  const int k0 = blockIdx.x * BK;
  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hkv * D;
  const long kv_off = (long)b * Skv * kv_stride + (long)hk * D;

  load_tile<T, D, LD>(sK, k + kv_off, kv_stride, k0, Skv);
  load_tile<T, D, LD>(sV, v + kv_off, kv_stride, k0, Skv);
  for (int i = tid; i < BK; i += NT) {
    const int kj = k0 + i;
    sKseg[i] = (kj < Skv && kseg) ? kseg[(long)b * Skv + kj] : 0;
  }

  // rows of these accumulators are the block's kv rows
  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  const int k_hi = min(k0 + BK, Skv) - 1;
  const int nq = (Sq + BQ - 1) / BQ;
  for (int rep = 0; rep < n_rep; ++rep) {
    const int h = hk * n_rep + rep;
    const long q_off = (long)b * Sq * q_stride + (long)h * D;
    for (int i = 0; i < nq; ++i) {
      const int q0 = i * BQ;
      if (!tile_visible(q0, min(q0 + BQ, Sq) - 1, k0, k_hi, causal, window)) continue;
      __syncthreads();  // the kv-side loads, or the previous tile's reads, are done
      load_tile<T, D, LD>(sQ, q + q_off, q_stride, q0, Sq);
      load_tile<T, D, LD>(sDO, dout + q_off, q_stride, q0, Sq);
      for (int t = tid; t < BQ; t += NT) {
        const int qi = q0 + t;
        const bool in = qi < Sq;
        sLse[t] = in ? lse[((long)b * H + h) * Sq + qi] : 0.f;
        sDelta[t] = in ? delta[((long)b * H + h) * Sq + qi] : 0.f;
        sQseg[t] = (in && qseg) ? qseg[(long)b * Sq + qi] : 0;
      }
      __syncthreads();

      // score tile with rows = q (ty + 16r), columns = kv (tx + 16c)
      float s[4][4], dp[4][4];
      rowdot<D, LD>(sQ, sK, ty, tx, s);
      rowdot<D, LD>(sDO, sV, ty, tx, dp);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = ty + 16 * r;
        const int qi = q0 + row;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = tx + 16 * c;
          const int kj = k0 + col;
          bool vis = pair_visible(qi, kj, causal, window);
          if (qseg) vis = vis && sQseg[row] == sKseg[col];
          float p, ds;
          p_and_ds(s[r][c], dp[r][c], qi < Sq && kj < Skv, vis, sLse[row], sDelta[row],
                   softcap, scale, &p, &ds);
          sP[row * PP + col] = round_to<T>(p);
          sDS[row * PP + col] = round_to<T>(ds);
        }
      }
      __syncthreads();
      accum<D, LD, true>(sP, sDO, ty, tx, dv_acc);
      accum<D, LD, true>(sDS, sQ, ty, tx, dk_acc);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kj = k0 + ty + 16 * r;
    if (kj >= Skv) continue;
    T* krow = dk + kv_off + (long)kj * kv_stride;
    T* vrow = dv + kv_off + (long)kj * kv_stride;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      krow[tx + 16 * c] = from_f<T>(dk_acc[r][c] * scale);
      vrow[tx + 16 * c] = from_f<T>(dv_acc[r][c]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *qseg, *kseg;
  int B, Sq, Skv, H, Hkv, causal, window;
  float softcap, scale;
};

template <typename T, int D>
int launch_dq(const Args& a, void* dq, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.qseg),
      static_cast<const int*>(a.kseg), static_cast<T*>(dq), a.Sq, a.Skv, a.H, a.Hkv,
      a.causal, a.window, a.softcap, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Args& a, void* dk, void* dv, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Skv + BK - 1) / BK, a.B * a.Hkv);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.qseg),
      static_cast<const int*>(a.kseg), static_cast<T*>(dk), static_cast<T*>(dv), a.Sq,
      a.Skv, a.H, a.Hkv, a.causal, a.window, a.softcap, a.scale);
  return (int)cudaGetLastError();
}

int check_args(const Args& a, int D, int dtype) {
  if (a.Hkv <= 0 || a.H % a.Hkv != 0) return (int)cudaErrorInvalidValue;
  if ((D != 64 && D != 128) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  return 0;
}

// ---------------------------------------------------- tensor-core variants
// Both kernels run 4 warps (128 threads), each warp on 16 rows of the
// block's resident tile, with bf16 operands on mma.sync.m16n8k16 and f32
// accumulators in registers (csrc/mma.cuh has the fragment layouts):
//
// * B2, flash_bwd_dq_mma. Grid (B * H, ceil(Sq / 64)); one block per (b, h,
//   64-row q tile). Q and dO stay in shared memory; K, V and the kv segment
//   ids of each visible kv tile stream through a 2-stage cp.async ring, so
//   the next tile's copies run under this tile's products. Per kv tile: S =
//   Q K^T and dP = dO V^T (K and V as B operands by plain ldmatrix, since
//   their rows are the products' n), then the elementwise step on the C
//   fragments (scale, softcap and its 1 - t^2, masks, p = 2^((s - lse)
//   log2 e) by ex2.approx, ds = p (dp - delta) dcap), and dQ += bf16(dS) K:
//   dS's C fragments are packed into A fragments in registers (as B1 packs
//   P, csrc/flash_fwd.cu), K through ldmatrix.trans. lse and delta of the
//   thread's two rows sit in registers; dQ is scaled in the epilogue.
// * B3, flash_bwd_dkv_mma. Grid (B * Hkv, ceil(Skv / 64)); one block per
//   (b, kv head, 64-row kv tile). K and V stay in shared memory; the block
//   walks its group's n_rep q heads x its visible q tiles of MQT rows, with
//   Q, dO, lse, delta and the q segment ids streaming through the ring. It
//   computes the transposed tiles S^T = K Q^T and dP^T = V dO^T, so each
//   thread's fragment rows are kv rows (its accumulators' rows) and lse
//   and delta are read by column. bf16(P^T) is the A fragment of dV +=
//   P^T dO and bf16(dS^T) that of dK += dS^T Q (dO and Q through
//   ldmatrix.trans).
//
// Shared tiles are [rows][D] bf16 with 16-byte chunk ch of row r stored at
// chunk ch ^ (r % 8): the 8 rows that one ldmatrix phase reads at one
// logical chunk land in 8 distinct bank groups, for the plain and the
// .trans reads alike (both address whole 16-byte row chunks).
//
// Hazards, and what the design does about each:
// * Registers. At D = 128, B3's dK and dV accumulators are 2 x 64 f32 a
//   thread, and S^T and dP^T 2 x 4 MQT/8 more: with MQT = 64 that is 192
//   before addresses and fragments, and ptxas spills ~100 bytes a thread
//   (255 registers); 32 q rows fit (253, no spill) but measured slower on
//   the card (1.1538 against 1.0372 ms at B=4 S=2048 H=32 Hkv=8 D=128),
//   since at 64 each K/V fragment read from shared memory feeds twice the
//   products. Q/K/V/dO fragments are read from
//   shared memory for each product rather than kept in registers.
//   chip_smoke.py phase 1 prints each kernel's registers, spills and
//   blocks per SM (two of each kernel here, by registers and by shared
//   memory).
// * Branches. Softcap and masking are uniform per tile: the elementwise
//   step is instantiated for each (softcap, masked) pair and a tile wholly
//   inside the causal/window bound, with no ragged edge and no segment ids,
//   takes the unmasked one (B1 lost half its time to these tests inside
//   the element loops).
// * Causal imbalance. B2's last q tiles and B3's first kv tiles see the
//   most tiles. Blocks are dispatched in grid order, so B2 maps blockIdx.y
//   to q tiles from the last down and B3 to kv tiles from the first up: the
//   heaviest blocks start first and the light ones fill in at the end.
// * Determinism. Each block owns its output rows and sums its tiles in a
//   fixed order: two launches give bitwise equal gradients.
// These are mma.sync products, not wgmma, and cp.async, not TMA: their
// fragments are fixed register layouts that can be checked one by one.

constexpr int MBR = 64;   // rows of a block's resident tile (B2: q, B3: kv)
constexpr int MBS = 64;   // B2: kv rows per streamed tile
constexpr int MQT = 64;   // B3: q rows per streamed tile
constexpr int MNT = 128;  // 4 warps of 16 rows
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// byte offset of 16-byte chunk ch of row r in a swizzled [rows][D] bf16 tile
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return r * (D * 2) + ((ch ^ (r & 7)) << 4);
}

// rows [r0, r0 + ROWS) of one head of a (B, S, Hx, D) tensor (row stride
// `stride` elements) into a swizzled tile, zeros past row S
template <int D, int ROWS>
__device__ __forceinline__ void copy_rows(uint32_t dst, const bf16* base, long stride, int r0,
                                          int S, int tid) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = tid; i < ROWS * CH; i += MNT) {
    const int r = i / CH, ch = i % CH;
    const bool ok = r0 + r < S;
    tc::cp_async16(dst + swz<D>(r, ch), base + (ok ? (long)(r0 + r) * stride + ch * 8 : 0), ok);
  }
}

// A fragment (16 rows x k16 step kk) of a swizzled tile, rows from r0
template <int D>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], uint32_t tile, int r0, int kk,
                                       int lane) {
  tc::ldmatrix_x4(a, tile + swz<D>(r0 + (lane & 15), 2 * kk + (lane >> 4)));
}

// B fragments of n8 tiles 2 np and 2 np + 1 at k16 step kk, from a tile
// whose rows are the product's n and whose columns are its k (K for Q K^T)
template <int D>
__device__ __forceinline__ void b_frag_nk(uint32_t (&b)[4], uint32_t tile, int np, int kk,
                                          int lane) {
  tc::ldmatrix_x4(b, tile + swz<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                   2 * kk + ((lane >> 3) & 1)));
}

// B fragments of n8 tiles 2 dp and 2 dp + 1 at k16 step kk, from a tile
// whose rows are the product's k and whose columns are its n (K for dS K)
template <int D>
__device__ __forceinline__ void b_frag_kn(uint32_t (&b)[4], uint32_t tile, int dp, int kk,
                                          int lane) {
  tc::ldmatrix_x4_trans(b, tile + swz<D>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                         2 * dp + (lane >> 4)));
}

// the A fragment of k16 step kk from the C fragments of n8 tiles 2 kk and
// 2 kk + 1, rounded to bf16 (the Pallas kernels' .astype before a product)
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&f)[N][4], int kk) {
  a[0] = tc::pack_bf16(f[2 * kk][0], f[2 * kk][1]);
  a[1] = tc::pack_bf16(f[2 * kk][2], f[2 * kk][3]);
  a[2] = tc::pack_bf16(f[2 * kk + 1][0], f[2 * kk + 1][1]);
  a[3] = tc::pack_bf16(f[2 * kk + 1][2], f[2 * kk + 1][3]);
}

// p and ds of one score, in place: s the raw q.k becomes p, dp the raw
// do.v becomes ds. vis: the pair passes the masks; in: both rows exist.
template <bool CAP, bool MASK>
__device__ __forceinline__ void grad_of_score(float& s, float& dp, float lse, float delta,
                                              float scale, float cap, bool vis, bool in) {
  float x = s * scale;
  float dcap = 1.f;
  if constexpr (CAP) {
    const float t = tanhf(x / cap);
    x = cap * t;
    dcap = 1.f - t * t;
  }
  if constexpr (MASK) x = vis ? x : kNegInf;
  // (x - lse) first: exact when both are near NEG_INF (a row with no
  // visible key), where fma(x, log2e, -lse log2e) would cancel badly
  float p = tc::exp2_approx((x - lse) * kLog2e);
  if constexpr (MASK) p = in ? p : 0.f;
  const float ds = p * (dp - delta);
  s = p;
  dp = CAP ? ds * dcap : ds;
}

template <int D>
struct DqCfg {
  static constexpr int TILE = MBR * D * 2;            // Q or dO
  static constexpr int KV_TILE = MBS * D * 2;         // K or V
  static constexpr int STAGE = 2 * KV_TILE + MBS * 4;  // K, V, kv segment ids
  static constexpr int SMEM = 2 * TILE + 2 * STAGE;
};

template <int D>
struct DkvCfg {
  static constexpr int TILE = MBR * D * 2;                // K or V
  static constexpr int Q_TILE = MQT * D * 2;              // Q or dO
  static constexpr int STAGE = 2 * Q_TILE + 3 * MQT * 4;  // Q, dO, lse, delta, q segment ids
  static constexpr int SMEM = 2 * TILE + 2 * STAGE;
};

// B2's elementwise step on one kv tile: fragment rows are q rows qi[hr]
// (hr = e / 2), columns kv rows k0 + 8 t + 2 c + e % 2
template <bool CAP, bool MASK, int NT8>
__device__ __forceinline__ void dq_tile_grads(float (&s)[NT8][4], float (&dp)[NT8][4],
                                              const float (&lse)[2], const float (&delta)[2],
                                              const int (&qi)[2], const int (&qs)[2],
                                              const int* kseg_tile, int k0, int c, int Skv,
                                              bool masked, int window, float scale,
                                              float cap) {
#pragma unroll
  for (int t = 0; t < NT8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hr = e >> 1;
      bool vis = true, in = true;
      if constexpr (MASK) {
        const int kc = t * 8 + 2 * c + (e & 1);
        const int kj = k0 + kc;
        if (masked) vis = qi[hr] >= kj;
        if (window > 0) vis = vis && (qi[hr] - kj) < window;
        if (kseg_tile) vis = vis && qs[hr] == kseg_tile[kc];
        in = kj < Skv;
      }
      grad_of_score<CAP, MASK>(s[t][e], dp[t][e], lse[hr], delta[hr], scale, cap, vis, in);
    }
}

// B3's elementwise step on one q tile: fragment rows are kv rows kj[hr],
// columns q rows q0 + 8 t + 2 c + e % 2, whose lse, delta and segment ids
// come from the tile's stage
template <bool CAP, bool MASK, int NT8>
__device__ __forceinline__ void dkv_tile_grads(float (&s)[NT8][4], float (&dp)[NT8][4],
                                               const float* lse_tile, const float* delta_tile,
                                               const int* qseg_tile, const int (&kj)[2],
                                               const int (&ks)[2], int q0, int c, int Sq,
                                               int Skv, bool masked, int window, float scale,
                                               float cap) {
#pragma unroll
  for (int t = 0; t < NT8; ++t) {
    const int qc = t * 8 + 2 * c;
    const float2 l2 = *reinterpret_cast<const float2*>(lse_tile + qc);
    const float2 d2 = *reinterpret_cast<const float2*>(delta_tile + qc);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hr = e >> 1;
      bool vis = true, in = true;
      if constexpr (MASK) {
        const int qi = q0 + qc + (e & 1);
        if (masked) vis = qi >= kj[hr];
        if (window > 0) vis = vis && (qi - kj[hr]) < window;
        if (qseg_tile) vis = vis && ks[hr] == qseg_tile[qc + (e & 1)];
        in = qi < Sq && kj[hr] < Skv;
      }
      grad_of_score<CAP, MASK>(s[t][e], dp[t][e], (e & 1) ? l2.y : l2.x,
                               (e & 1) ? d2.y : d2.x, scale, cap, vis, in);
    }
  }
}

// B2 on the tensor cores (bf16). Grid (B * H, ceil(Sq / 64)); block y runs
// q tile gridDim.y - 1 - y.
template <int D>
__global__ void __launch_bounds__(MNT) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ qseg,
    const int* __restrict__ kseg, bf16* __restrict__ dq, int Sq, int Skv, int H, int Hkv,
    int causal, int window, float softcap, float scale) {
  using C = DqCfg<D>;
  constexpr int NT8 = MBS / 8;  // score n8 tiles per kv tile
  constexpr int NDT = D / 8;    // dq n8 tiles
  extern __shared__ __align__(128) unsigned char smem_dq[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wrow = (tid >> 5) * 16;  // the warp's first row in the block
  const int g = lane >> 2;
  const int c = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MBR;
  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hkv * D;
  const long q_off = (long)b * Sq * q_stride + (long)h * D;
  const bf16* kb = k + (long)b * Skv * kv_stride + (long)hk * D;
  const bf16* vb = v + (long)b * Skv * kv_stride + (long)hk * D;
  const int* ksb = kseg ? kseg + (long)b * Skv : nullptr;
  const bool masked = causal || window > 0;
  const uint32_t sQ = tc::smem_addr(smem_dq);
  const uint32_t sDO = sQ + C::TILE;
  const uint32_t sRing = sDO + C::TILE;

  // the visible kv tiles (_block_visible): causal needs k0 <= the last q
  // row, the window k0 + 63 > q0 - window
  const int q_hi = min(q0 + MBR, Sq) - 1;
  int j_end = (Skv + MBS - 1) / MBS;
  if (masked) j_end = min(j_end, q_hi / MBS + 1);
  int j_start = 0;
  if (window > 0) {
    const int t = q0 - window - (MBS - 1);
    j_start = t < 0 ? 0 : t / MBS + 1;
  }

  auto load_kv = [&](int stage, int j) {
    const uint32_t sk = sRing + stage * C::STAGE;
    const int k0 = j * MBS;
    copy_rows<D, MBS>(sk, kb, kv_stride, k0, Skv, tid);
    copy_rows<D, MBS>(sk + C::KV_TILE, vb, kv_stride, k0, Skv, tid);
    if (ksb && tid < MBS) {
      const bool ok = k0 + tid < Skv;
      tc::cp_async4(sk + 2 * C::KV_TILE + 4 * tid, ksb + (ok ? k0 + tid : 0), ok);
    }
  };

  copy_rows<D, MBR>(sQ, q + q_off, q_stride, q0, Sq, tid);
  copy_rows<D, MBR>(sDO, dout + q_off, q_stride, q0, Sq, tid);
  if (j_start < j_end) load_kv(0, j_start);
  tc::cp_async_commit();

  // this thread's rows q0 + wrow + g + 8 hr: lse, delta, segment id
  int qi[2], qs[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    qi[hr] = q0 + wrow + g + 8 * hr;
    const bool in = qi[hr] < Sq;
    const long row = ((long)b * H + h) * Sq + qi[hr];
    lse_r[hr] = in ? lse[row] : 0.f;
    delta_r[hr] = in ? delta[row] : 0.f;
    qs[hr] = (qseg && in) ? qseg[(long)b * Sq + qi[hr]] : 0;
  }
  float acc[NDT][4];
#pragma unroll
  for (int t = 0; t < NDT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  for (int j = j_start; j < j_end; ++j) {
    const int stage = (j - j_start) & 1;
    tc::cp_async_wait<0>();  // tile j (and, first, Q and dO): this thread's copies
    __syncthreads();         // everyone's copies; tile j-1's reads are done
    if (j + 1 < j_end) load_kv(stage ^ 1, j + 1);
    tc::cp_async_commit();
    const uint32_t sk = sRing + stage * C::STAGE;
    const uint32_t sv = sk + C::KV_TILE;
    const int k0 = j * MBS;

    // S = Q K^T and dP = dO V^T
    float s[NT8][4], dp[NT8][4];
#pragma unroll
    for (int t = 0; t < NT8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ado[4];
      a_frag<D>(aq, sQ, wrow, kk, lane);
      a_frag<D>(ado, sDO, wrow, kk, lane);
#pragma unroll
      for (int np = 0; np < NT8 / 2; ++np) {
        uint32_t bk[4], bv[4];
        b_frag_nk<D>(bk, sk, np, kk, lane);
        b_frag_nk<D>(bv, sv, np, kk, lane);
        tc::mma_bf16(s[2 * np], aq, bk[0], bk[1]);
        tc::mma_bf16(s[2 * np + 1], aq, bk[2], bk[3]);
        tc::mma_bf16(dp[2 * np], ado, bv[0], bv[1]);
        tc::mma_bf16(dp[2 * np + 1], ado, bv[2], bv[3]);
      }
    }

    // p and ds; masks only where some pair of the tile may be hidden
    const int* kst = ksb ? reinterpret_cast<const int*>(smem_dq + (sk - sQ) + 2 * C::KV_TILE)
                         : nullptr;
    const bool need_mask = ksb != nullptr || k0 + MBS > Skv ||
                           (masked && k0 + MBS - 1 > q0) ||
                           (window > 0 && q0 + MBR - 1 - k0 >= window);
#define DQ_GRADS(CAP, MASK)                                                                 \
  dq_tile_grads<CAP, MASK>(s, dp, lse_r, delta_r, qi, qs, kst, k0, c, Skv, masked, window, \
                           scale, softcap)
    if (softcap > 0.f) {
      if (need_mask) DQ_GRADS(true, true); else DQ_GRADS(true, false);
    } else {
      if (need_mask) DQ_GRADS(false, true); else DQ_GRADS(false, false);
    }
#undef DQ_GRADS

    // dQ += bf16(dS) K
#pragma unroll
    for (int kk = 0; kk < MBS / 16; ++kk) {
      uint32_t a[4];
      pack_a(a, dp, kk);
#pragma unroll
      for (int dpi = 0; dpi < NDT / 2; ++dpi) {
        uint32_t bk[4];
        b_frag_kn<D>(bk, sk, dpi, kk, lane);
        tc::mma_bf16(acc[2 * dpi], a, bk[0], bk[1]);
        tc::mma_bf16(acc[2 * dpi + 1], a, bk[2], bk[3]);
      }
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (qi[hr] >= Sq) continue;
    bf16* row = dq + q_off + (long)qi[hr] * q_stride + 2 * c;
#pragma unroll
    for (int t = 0; t < NDT; ++t)
      *reinterpret_cast<uint32_t*>(row + t * 8) =
          tc::pack_bf16(acc[t][2 * hr] * scale, acc[t][2 * hr + 1] * scale);
  }
}

// B3 on the tensor cores (bf16). Grid (B * Hkv, ceil(Skv / 64)); block y
// runs kv tile y (the first kv tiles see the most q tiles under causal
// masking and start first).
template <int D>
__global__ void __launch_bounds__(MNT) flash_bwd_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ qseg,
    const int* __restrict__ kseg, bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
    int Skv, int H, int Hkv, int causal, int window, float softcap, float scale) {
  using C = DkvCfg<D>;
  constexpr int NT8 = MQT / 8;  // score n8 tiles per q tile
  constexpr int NDT = D / 8;   // dk/dv n8 tiles
  extern __shared__ __align__(128) unsigned char smem_dkv[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wrow = (tid >> 5) * 16;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int bg = blockIdx.x;
  const int b = bg / Hkv;
  const int hk = bg % Hkv;
  const int n_rep = H / Hkv;
  const int k0 = blockIdx.y * MBR;
  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hkv * D;
  const long kv_off = (long)b * Skv * kv_stride + (long)hk * D;
  const bool masked = causal || window > 0;
  const uint32_t sK = tc::smem_addr(smem_dkv);
  const uint32_t sV = sK + C::TILE;
  const uint32_t sRing = sV + C::TILE;

  // the visible q tiles: causal needs a q row >= k0, the window a q row
  // below the last kv row + window
  const int k_hi = min(k0 + MBR, Skv) - 1;
  const int nq = (Sq + MQT - 1) / MQT;
  const int i_start = masked ? k0 / MQT : 0;
  const int i_end = window > 0 ? min(nq, (k_hi + window - 1) / MQT + 1) : nq;
  const int ni = max(i_end - i_start, 0);
  const int n_it = n_rep * ni;  // (q head, q tile) pairs, q tiles fastest

  auto load_q = [&](int stage, int it) {
    const int h = hk * n_rep + it / ni;
    const int q0 = (i_start + it % ni) * MQT;
    const long q_off = (long)b * Sq * q_stride + (long)h * D;
    const uint32_t sq = sRing + stage * C::STAGE;
    copy_rows<D, MQT>(sq, q + q_off, q_stride, q0, Sq, tid);
    copy_rows<D, MQT>(sq + C::Q_TILE, dout + q_off, q_stride, q0, Sq, tid);
    if (tid < MQT) {
      const bool ok = q0 + tid < Sq;
      const long row = ((long)b * H + h) * Sq + (ok ? q0 + tid : 0);
      const uint32_t sl = sq + 2 * C::Q_TILE;
      tc::cp_async4(sl + 4 * tid, lse + row, ok);
      tc::cp_async4(sl + 4 * MQT + 4 * tid, delta + row, ok);
      if (qseg) tc::cp_async4(sl + 8 * MQT + 4 * tid, qseg + (long)b * Sq + (ok ? q0 + tid : 0), ok);
    }
  };

  copy_rows<D, MBR>(sK, k + kv_off, kv_stride, k0, Skv, tid);
  copy_rows<D, MBR>(sV, v + kv_off, kv_stride, k0, Skv, tid);
  if (n_it > 0) load_q(0, 0);
  tc::cp_async_commit();

  int kj[2], ks[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    kj[hr] = k0 + wrow + g + 8 * hr;
    ks[hr] = (kseg && kj[hr] < Skv) ? kseg[(long)b * Skv + kj[hr]] : 0;
  }
  float dka[NDT][4], dva[NDT][4];
#pragma unroll
  for (int t = 0; t < NDT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[t][e] = dva[t][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    tc::cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_it) load_q(stage ^ 1, it + 1);
    tc::cp_async_commit();
    const uint32_t sq = sRing + stage * C::STAGE;
    const uint32_t sdo = sq + C::Q_TILE;
    const int q0 = (i_start + it % ni) * MQT;

    // S^T = K Q^T and dP^T = V dO^T
    float s[NT8][4], dp[NT8][4];
#pragma unroll
    for (int t = 0; t < NT8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      a_frag<D>(ak, sK, wrow, kk, lane);
      a_frag<D>(av, sV, wrow, kk, lane);
#pragma unroll
      for (int np = 0; np < NT8 / 2; ++np) {
        uint32_t bq[4], bdo[4];
        b_frag_nk<D>(bq, sq, np, kk, lane);
        b_frag_nk<D>(bdo, sdo, np, kk, lane);
        tc::mma_bf16(s[2 * np], ak, bq[0], bq[1]);
        tc::mma_bf16(s[2 * np + 1], ak, bq[2], bq[3]);
        tc::mma_bf16(dp[2 * np], av, bdo[0], bdo[1]);
        tc::mma_bf16(dp[2 * np + 1], av, bdo[2], bdo[3]);
      }
    }

    const unsigned char* st = smem_dkv + (sq - sK) + 2 * C::Q_TILE;
    const float* lse_t = reinterpret_cast<const float*>(st);
    const float* delta_t = lse_t + MQT;
    const int* qseg_t = qseg ? reinterpret_cast<const int*>(delta_t + MQT) : nullptr;
    const bool need_mask = qseg != nullptr || q0 + MQT > Sq || k0 + MBR > Skv ||
                           (masked && q0 < k0 + MBR - 1) ||
                           (window > 0 && q0 + MQT - 1 - k0 >= window);
#define DKV_GRADS(CAP, MASK)                                                                \
  dkv_tile_grads<CAP, MASK>(s, dp, lse_t, delta_t, qseg_t, kj, ks, q0, c, Sq, Skv, masked, \
                            window, scale, softcap)
    if (softcap > 0.f) {
      if (need_mask) DKV_GRADS(true, true); else DKV_GRADS(true, false);
    } else {
      if (need_mask) DKV_GRADS(false, true); else DKV_GRADS(false, false);
    }
#undef DKV_GRADS

    // dV += bf16(P^T) dO and dK += bf16(dS^T) Q
#pragma unroll
    for (int kk = 0; kk < MQT / 16; ++kk) {
      uint32_t pa[4], dsa[4];
      pack_a(pa, s, kk);
      pack_a(dsa, dp, kk);
#pragma unroll
      for (int dpi = 0; dpi < NDT / 2; ++dpi) {
        uint32_t bdo[4], bq[4];
        b_frag_kn<D>(bdo, sdo, dpi, kk, lane);
        b_frag_kn<D>(bq, sq, dpi, kk, lane);
        tc::mma_bf16(dva[2 * dpi], pa, bdo[0], bdo[1]);
        tc::mma_bf16(dva[2 * dpi + 1], pa, bdo[2], bdo[3]);
        tc::mma_bf16(dka[2 * dpi], dsa, bq[0], bq[1]);
        tc::mma_bf16(dka[2 * dpi + 1], dsa, bq[2], bq[3]);
      }
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (kj[hr] >= Skv) continue;
    bf16* krow = dk + kv_off + (long)kj[hr] * kv_stride + 2 * c;
    bf16* vrow = dv + kv_off + (long)kj[hr] * kv_stride + 2 * c;
#pragma unroll
    for (int t = 0; t < NDT; ++t) {
      *reinterpret_cast<uint32_t*>(krow + t * 8) =
          tc::pack_bf16(dka[t][2 * hr] * scale, dka[t][2 * hr + 1] * scale);
      *reinterpret_cast<uint32_t*>(vrow + t * 8) =
          tc::pack_bf16(dva[t][2 * hr], dva[t][2 * hr + 1]);
    }
  }
}

template <int D>
int launch_dq_mma(const Args& a, void* dq, cudaStream_t stream) {
  constexpr int smem = DqCfg<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.B * a.H, (a.Sq + MBR - 1) / MBR);
  flash_bwd_dq_mma_kernel<D><<<grid, MNT, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int*>(a.qseg), static_cast<const int*>(a.kseg), static_cast<bf16*>(dq),
      a.Sq, a.Skv, a.H, a.Hkv, a.causal, a.window, a.softcap, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_mma(const Args& a, void* dk, void* dv, cudaStream_t stream) {
  constexpr int smem = DkvCfg<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.B * a.Hkv, (a.Skv + MBR - 1) / MBR);
  flash_bwd_dkv_mma_kernel<D><<<grid, MNT, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int*>(a.qseg), static_cast<const int*>(a.kseg), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), a.Sq, a.Skv, a.H, a.Hkv, a.causal, a.window, a.softcap, a.scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 and softcap <= 0 mean off;
// qseg/kseg null mean no segments. Returns a cudaError_t code (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* qseg,
                            const void* kseg, void* dq, int B, int Sq, int Skv, int H,
                            int Hkv, int D, int dtype, int causal, int window,
                            float softcap, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, qseg, kseg, B, Sq, Skv, H, Hkv, causal, window,
               softcap, scale};
  if (Sq <= 0 || B <= 0 || Skv <= 0) return 0;
  if (int err = check_args(a, D, dtype)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return D == 64 ? launch_dq<float, 64>(a, dq, s) : launch_dq<float, 128>(a, dq, s);
  return D == 64 ? launch_dq<__nv_bfloat16, 64>(a, dq, s) : launch_dq<__nv_bfloat16, 128>(a, dq, s);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* qseg,
                             const void* kseg, void* dk, void* dv, int B, int Sq, int Skv,
                             int H, int Hkv, int D, int dtype, int causal, int window,
                             float softcap, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, qseg, kseg, B, Sq, Skv, H, Hkv, causal, window,
               softcap, scale};
  if (Sq <= 0 || B <= 0 || Skv <= 0) return 0;
  if (int err = check_args(a, D, dtype)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D == 64 ? launch_dkv<float, 64>(a, dk, dv, s) : launch_dkv<float, 128>(a, dk, dv, s);
  return D == 64 ? launch_dkv<__nv_bfloat16, 64>(a, dk, dv, s)
                 : launch_dkv<__nv_bfloat16, 128>(a, dk, dv, s);
}

// The tensor-core variants: bfloat16 q/k/v/do (16-byte aligned), the same
// arguments as the FMA kernels without the dtype. Returns a cudaError_t
// code (0 on success).
extern "C" int flash_bwd_dq_mma(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                const void* qseg, const void* kseg, void* dq, int B, int Sq,
                                int Skv, int H, int Hkv, int D, int causal, int window,
                                float softcap, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, qseg, kseg, B, Sq, Skv, H, Hkv, causal, window,
               softcap, scale};
  if (Sq <= 0 || B <= 0 || Skv <= 0) return 0;
  if (int err = check_args(a, D, 1)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_dq_mma<64>(a, dq, s) : launch_dq_mma<128>(a, dq, s);
}

extern "C" int flash_bwd_dkv_mma(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 const void* qseg, const void* kseg, void* dk, void* dv, int B,
                                 int Sq, int Skv, int H, int Hkv, int D, int causal,
                                 int window, float softcap, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, qseg, kseg, B, Sq, Skv, H, Hkv, causal, window,
               softcap, scale};
  if (Sq <= 0 || B <= 0 || Skv <= 0) return 0;
  if (int err = check_args(a, D, 1)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_dkv_mma<64>(a, dk, dv, s) : launch_dkv_mma<128>(a, dk, dv, s);
}
