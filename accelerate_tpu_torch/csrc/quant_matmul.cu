// Weight-only quantized matmul for Hopper (sm_90a), plain FMA version.
//
// Replaces the TPU kernel accelerate_tpu/ops/quant_matmul.py::_qmm_kernel
// (launched by quantized_matmul). Computes
//   out[m, n] = cast_out((sum_k xc[m, k] * q[k, n]) * scales[n])
// with x (M, K) f32, bf16 or f16, q (K, N) int8, scales (N,) f32 per output
// column and out (M, N) in x's dtype. xc is x itself when x is f32 and x
// rounded to bf16 otherwise (the TPU kernel's compute dtype; an f16 x is
// rounded to bf16 too). A bf16 value times an int8 is exact in f32, so the
// only roundings are the f32 sum's and the final cast; the scale multiplies
// the f32 sum once, after it.
//
// What bounds it on the card: at decode shapes (M of a few rows) the int8
// weights are the traffic, K*N bytes once, so it is bound by bytes; at
// prefill shapes (M = B*S in the thousands) by operations, 2*M*K*N. This
// first version runs its products as f32 FMA loops on the CUDA cores (no
// mma/wgmma), far above the tensor-core bound at large M. What the design
// does about it: q stays int8 in device memory and is widened to f32 only
// in shared memory, so each weight byte is read once per 64-row tile of x
// (once in all when M <= 64); each thread owns a 4x4 (or, for M <= 16, a
// 1x4) register micro-tile, so every shared-memory read feeds 4 FMAs.
//
// Layout: x, out row-major with rows of K and N elements; q row-major (K,
// N), read in place (a contiguous (K, N) layer slice of a stacked (L, K, N)
// leaf). Grid: (ceil(N / 64), ceil(M / BM)); the K loop runs inside the
// block in tiles of 32, ascending, so each output is one sequential f32 sum
// (blocks run in no order and nothing carries between them). Ragged M, N
// and K are masked: rows, columns and depths past the edge load as zero
// and are not stored.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;
constexpr int BK = 32;
constexpr int NT = 256;  // 16 x 16 threads; thread (ty, tx)

template <typename T> __device__ __forceinline__ float load_x(T x);
template <> __device__ __forceinline__ float load_x<float>(float x) { return x; }
template <> __device__ __forceinline__ float load_x<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float load_x<__half>(__half x) {
  return __bfloat162float(__float2bfloat16(__half2float(x)));  // round to bf16
}
template <typename T> __device__ __forceinline__ T store_out(float v);
template <> __device__ __forceinline__ float store_out<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 store_out<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half store_out<__half>(float v) {
  return __float2half_rn(v);
}

// RM rows of the micro-tile per thread: the block covers BM = 16 * RM rows
template <typename T, int RM>
__global__ void __launch_bounds__(NT) quant_matmul_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scales, T* __restrict__ out, int M, int K, int N) {
  constexpr int BM = 16 * RM;
  constexpr int XP = BM + 1;  // padded k-major x tile: the transposing store hits distinct banks
  __shared__ float sX[BK * XP];
  __shared__ float sQ[BK * BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  float acc[RM][4];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile (BM x BK), read along k (coalesced), stored k-major
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int m = idx / BK, k = idx % BK;
      const int gm = m0 + m, gk = k0 + k;
      sX[k * XP + m] = (gm < M && gk < K) ? load_x<T>(x[(long)gm * K + gk]) : 0.f;
    }
    // q tile (BK x BN), read along n (coalesced), widened to f32
    for (int idx = tid; idx < BK * BN; idx += NT) {
      const int k = idx / BN, n = idx % BN;
      const int gk = k0 + k, gn = n0 + n;
      sQ[k * BN + n] = (gk < K && gn < N) ? (float)q[(long)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[RM], b[4];
#pragma unroll
      for (int r = 0; r < RM; ++r) a[r] = sX[k * XP + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = sQ[k * BN + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();  // this tile's reads are done before the next loads
  }

#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int gn = n0 + tx + 16 * c;
    if (gn >= N) continue;
    const float s = scales[gn];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int gm = m0 + ty + 16 * r;
      if (gm < M) out[(long)gm * N + gn] = store_out<T>(acc[r][c] * s);
    }
  }
}

template <typename T>
int launch(const void* x, const void* q, const void* scales, void* out, int M, int K,
           int N, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const int8_t* qt = static_cast<const int8_t*>(q);
  const float* st = static_cast<const float*>(scales);
  T* ot = static_cast<T*>(out);
  if (M <= 16) {  // decode shapes: 16-row tiles waste fewer FMAs on padding rows
    dim3 grid((N + BN - 1) / BN, (M + 15) / 16);
    quant_matmul_kernel<T, 1><<<grid, NT, 0, stream>>>(xt, qt, st, ot, M, K, N);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + 63) / 64);
    quant_matmul_kernel<T, 4><<<grid, NT, 0, stream>>>(xt, qt, st, ot, M, K, N);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of x and out: 0 = float32, 1 = bfloat16, 2 = float16. Returns a
// cudaError_t code (0 on success).
extern "C" int quant_matmul(const void* x, const void* q, const void* scales, void* out,
                            int M, int K, int N, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, q, scales, out, M, K, N, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, q, scales, out, M, K, N, s);
  if (dtype == 2) return launch<__half>(x, q, scales, out, M, K, N, s);
  return (int)cudaErrorInvalidValue;
}
