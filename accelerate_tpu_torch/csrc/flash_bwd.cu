// Flash-attention backward for Hopper (sm_90a), plain FMA version: two
// kernels, dq and dk/dv, each with its own C entry point.
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
// visible pairs, ~0.4 TFLOP together against ~0.2 GB of operands, so a
// tensor-core kernel would be compute-bound. These first versions run
// their products as f32 FMA loops on the CUDA cores (no mma/wgmma), bound
// by the FMA rate and shared-memory reads. What the design does about it:
// each thread owns 4x4 register micro-tiles of the 64x64 score tiles and
// 4x(D/16) micro-tiles of the 64xD accumulators, so every shared-memory
// read feeds 4 FMAs; tiles with no visible (q, k) pair (causal, window)
// are skipped; GQA maps q head h to kv head h / n_rep without repeating.
// B3's grid, (ceil(Skv/64), B*Hkv) = 1,024 blocks at the training shape,
// fills the 132 SMs. mma/wgmma and TMA are later work.
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
