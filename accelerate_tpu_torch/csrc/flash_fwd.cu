// Flash-attention forward for Hopper (sm_90a), plain FMA version.
//
// Replaces the TPU kernel accelerate_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd). Computes, per (batch, q head), the tiled
// online-softmax attention of a q tile against every visible kv tile and
// writes `out` and the per-row f32 log-sum-exp `lse` (kept for the training
// slice's backward kernels and for LSE merges).
//
// What bounds it on the card: at the serving shapes (S <= a few thousand,
// D = 128) the work is ~4*S^2/2*H*D flops against ~(2*Sq*H + 2*Skv*Hkv)*D
// bytes, so a tensor-core kernel would be compute-bound. This first version
// runs its two products as f32 FMA loops on the CUDA cores (no mma/wgmma),
// so it is bound by the FMA rate and by shared-memory reads, far above the
// tensor-core bound. What the design does about it: each thread owns a 4x4
// register micro-tile of the score tile and a 4x(D/16) micro-tile of the
// output, so every shared-memory read feeds 4 FMAs, and causal/window tiles
// that hold no visible (q, k) pair are skipped, not masked. wgmma/TMA are
// later work.
//
// Layout (the JAX package's public layout, read in place, no transposes):
//   q, out (B, Sq, H, D); k, v (B, Skv, Hkv, D); lse (B, H, Sq) f32.
// GQA: q head h reads kv head h / (H / Hkv); KV is never repeated.
// Grid: (ceil(Sq / BQ), B * H). The kv loop runs inside the block, because
// blocks run in no order and nothing carries between them (the TPU kernel
// carried acc/m/l across a sequential grid dimension).
// Masking follows _mask_scores: softcap first, then causal (q >= k), then
// the Mistral window (q - k < window), with the finite NEG_INF = -1e6; keys
// past Skv are masked and read as zeros (the JAX kernel needs S divisible
// by its block; this one masks the ragged edge instead).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1.0e6f;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;  // 16 x 16 threads; thread (ty, tx)

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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int Sq, int Skv, int H,
    int Hkv, int causal, int window, float softcap, float scale) {
  constexpr int DP = D + 1;   // padded rows: column reads hit distinct banks
  constexpr int PP = BK + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sP = sV + BK * D;

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
  const T* qb = q + (long)b * Sq * q_stride + (long)h * D;
  const T* kb = k + (long)b * Skv * kv_stride + (long)hk * D;
  const T* vb = v + (long)b * Skv * kv_stride + (long)hk * D;
  const bool masked = causal || window > 0;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int qi = q0 + r;
    sQ[r * DP + c] = qi < Sq ? to_f(qb[(long)qi * q_stride + c]) : 0.f;
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
      sK[r * DP + c] = in ? to_f(kb[(long)kj * kv_stride + c]) : 0.f;
      sV[r * D + c] = in ? to_f(vb[(long)kj * kv_stride + c]) : 0.f;
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
        bool vis = kj < Skv;
        if (masked) vis = vis && qi >= kj;
        if (window > 0) vis = vis && (qi - kj) < window;
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
    T* orow = out + ((long)b * Sq + qi) * q_stride + (long)h * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = from_f<T>(acc[r][c] / l);
    if (tx == 0) lse[((long)b * H + h) * Sq + qi] = m_i[r] + logf(l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int Sq, int Skv, int H, int Hkv, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), Sq, Skv, H, Hkv, causal,
      window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 and softcap <= 0 mean off.
// Returns a cudaError_t code (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out,
                         void* lse, int B, int Sq, int Skv, int H, int Hkv,
                         int D, int dtype, int causal, int window,
                         float softcap, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || B <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, causal, window, softcap, scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, causal, window, softcap, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, causal, window, softcap, scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, causal, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}
