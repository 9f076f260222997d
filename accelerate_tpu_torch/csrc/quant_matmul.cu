// Weight-only quantized matmul for Hopper (sm_90a): three variants.
//
// Replaces the TPU kernel accelerate_tpu/ops/quant_matmul.py:33 _qmm_kernel
// (its pallas_call at :72, launched by quantized_matmul). Computes
//   out[m, n] = cast_out((sum_k xc[m, k] * q[k, n]) * scales[n])
// with x (M, K) f32, bf16 or f16, q (K, N) int8, scales (N,) f32 per output
// column and out (M, N) in x's dtype. xc is x itself when x is f32 and x
// rounded to bf16 otherwise (the TPU kernel's compute dtype; an f16 x is
// rounded to bf16 too). A bf16 value times an int8 is exact in f32, so the
// only roundings are the f32 sum's and the final cast; the scale multiplies
// the f32 sum once, after it. The variants differ only in the order of the
// f32 sum.
//
// What bounds it on this card: at decode shapes (M of a few rows) the int8
// weights, K*N bytes once, over 3.35 TB/s; at prefill shapes (M = B*S in
// the thousands) the 2*M*K*N operations over the 989 TFLOP/s of bf16
// tensor cores. Which variant serves which shapes (chosen in Python by
// ops/quant_matmul.py::qmm_plan from M, K, N and x's dtype):
//
// * quant_matmul_mma (bf16/f16 x, M > 16, K % 8 == 0, N % 16 == 0): the
//   products on the tensor cores (mma.sync.m16n8k16, bf16 in, f32
//   accumulators in registers), fed by a 4-stage cp.async ring of 64-deep
//   K tiles: x's tile arrives as bf16 (ldmatrix from an XOR-swizzled
//   layout, free of bank conflicts) and q's as int8, half of bf16's bytes,
//   widened to bf16 in registers on its way to the tensor cores. The B
//   fragment wants pairs along k for one column, while q's rows run along
//   n, so each thread reads one 32-bit word (4 columns) from each of the 4
//   rows its fragment covers, and the 4 columns of the word become 4
//   "virtual" 8-column mma tiles: virtual column slot s of tile t is real
//   column 4*s + t, so after the products each thread holds 8 neighbouring
//   output columns per row and stores them as 16 bytes. int8 becomes bf16
//   in 4 operations a pair (csrc/mma.cuh). Tiles of 128 x 128, 4 warps of
//   128 x 32 side by side, so each weight is widened once per block (2 x 2
//   warps of 64 x 64 widen it twice and measured slower); 64 x 128 where
//   128-row tiles would leave SMs without a block (Llama-3-8B's k_v
//   projection at M = 2048: 16 x 8 = 128 tiles). The next k16 step's q
//   words and the next row tile's x fragment are read before the current
//   products. The scale multiplies in the epilogue, then the cast. These
//   are mma.sync products, not wgmma: mma.sync's fragments are fixed
//   register layouts that can be checked one by one, where a wrong wgmma
//   shared-memory descriptor or swizzle gives wrong numbers and no error,
//   so the right kernel came first; mma.sync's lower ceiling on this card
//   is what keeps it above cuBLAS (a later redesign moves to wgmma).
// * quant_matmul_splitk (bf16/f16 x, M <= 16, the same alignment): bound
//   by bytes, so the K range is cut into slices of whole 64-deep tiles that
//   give at least 2 x 132 blocks, each streaming its own slice of q through
//   the same 4-stage ring with 16-byte copies (x's rows padded to 16 with
//   zeros; the products still on the tensor cores, since f32 FMAs on the
//   CUDA cores barely keep pace with 3.35 TB/s). Each block writes f32
//   partial sums to a workspace the wrapper allocates; a second kernel sums
//   the slices in ascending order, applies the scale and casts
//   (deterministic, no atomics).
// * quant_matmul (f32 x, or rows that break 16-byte alignment, such as K =
//   4100 or N = 1000): f32 FMA loops on the CUDA cores. An f32 x must keep
//   f32 products (TF32 would be another function). Each thread owns a 4x4
//   (or, for M <= 16, a 1x4) register micro-tile; ragged edges are masked.
//
// Layout: x, out row-major with rows of K and N elements; q row-major (K,
// N), read in place (a contiguous (K, N) layer slice of a stacked (L, K, N)
// leaf). Rows, columns and depths past an edge load as zero and are not
// stored.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

// ------------------------------------------------------------ FMA variant
// Grid: (ceil(N / 64), ceil(M / BM)); the K loop runs inside the block in
// tiles of 32, ascending, so each output is one sequential f32 sum.

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


// ------------------------------------------------- tensor-core variants
constexpr int MBN = 128;     // output columns per block
constexpr int MBK = 64;      // K tile depth
constexpr int MNT = 128;     // 4 warps, side by side along N
constexpr int MSTAGES = 4;   // K tiles in the cp.async ring

// BM rows per block, each warp BM x 32
template <int BM>
struct MmaCfg {
  static constexpr int MT = BM / 16;  // m16 tiles per warp
  static constexpr int X_BYTES = BM * MBK * 2;
  static constexpr int Q_BYTES = MBK * MBN;
  static constexpr int STAGE = X_BYTES + Q_BYTES;
  static constexpr int SMEM = MSTAGES * STAGE;
};

// x tile rows are 128 bytes (8 chunks of 16); chunk ch of row r sits at
// chunk ch ^ (r % 8), so ldmatrix's 8 rows of one chunk hit 8 bank groups
__device__ __forceinline__ uint32_t x_swz(int r, int ch) {
  return r * 128 + ((ch ^ (r & 7)) << 4);
}

// q tile rows are 128 int8 (8 chunks of 16); chunk ch of row r sits at
// chunk ch ^ (2 * ((r / 2) % 4)): the fragment rows 2c, 2c+1 (+8) that
// the 4 lane groups c read in one instruction land in 4 distinct chunk
// pairs, so a warp's 32-bit reads hit 32 banks
__device__ __forceinline__ uint32_t q_swz(int r, int byte) {
  return r * MBN + (byte ^ (((r >> 1) & 3) << 5));
}

// two outputs cast to T (as store_out rounds them), lo in the low half
template <typename T> __device__ __forceinline__ uint32_t pack_out(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack_out<__nv_bfloat16>(float lo, float hi) {
  return tc::pack_bf16(lo, hi);
}
template <> __device__ __forceinline__ uint32_t pack_out<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T> __device__ __forceinline__ void to_bf16_frag(uint32_t (&a)[4]) {}
template <> __device__ __forceinline__ void to_bf16_frag<__half>(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = tc::half2_to_bf16x2(a[i]);
}

// SPLIT: blockIdx.z is the K slice (k_tiles_per_slice 64-deep tiles each)
// and `out` the f32 workspace (slices, M, N), unscaled; otherwise `out` is
// (M, N) of T, scaled and cast. Grid: (ceil(M / BM), ceil(N / 128), slices):
// the row tiles that share q's columns run side by side, so each weight
// byte comes from device memory about once. Warp wn owns columns 32 wn ..
// 32 wn + 31 of the block and all its rows, so each int8 weight is widened
// once per block.
template <typename T, int BM, bool SPLIT>
__global__ void __launch_bounds__(MNT) quant_matmul_mma_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scales,
    void* __restrict__ out, int M, int K, int N, int k_tiles_per_slice) {
  using C = MmaCfg<BM>;
  constexpr int STAGES = MSTAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wn = tid >> 5;  // the warp's 32 columns
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * MBN;
  const int k_tiles = (K + MBK - 1) / MBK;
  const int kt0 = SPLIT ? blockIdx.z * k_tiles_per_slice : 0;
  const int kt_n = SPLIT ? min(k_tiles_per_slice, k_tiles - kt0) : k_tiles;
  const uint32_t s_base = tc::smem_addr(smem);

  auto load_stage = [&](int stage, int kt) {
    const uint32_t xs = s_base + stage * C::STAGE;
    const uint32_t qs = xs + C::X_BYTES;
    const int k0 = kt * MBK;
    // K % 8 == 0: a chunk of 8 x values is all inside K or all outside
#pragma unroll
    for (int c = tid; c < BM * 8; c += MNT) {
      const int r = c >> 3, ch = c & 7;
      const int gm = m0 + r, gk = k0 + ch * 8;
      const bool ok = gm < M && gk < K;
      tc::cp_async16(xs + x_swz(r, ch), ok ? x + (long)gm * K + gk : x, ok);
    }
    // N % 16 == 0: likewise for a chunk of 16 q columns
#pragma unroll
    for (int c = tid; c < MBK * 8; c += MNT) {
      const int r = c >> 3, ch = c & 7;
      const int gk = k0 + r, gn = n0 + ch * 16;
      const bool ok = gk < K && gn < N;
      tc::cp_async16(qs + q_swz(r, ch * 16), ok ? q + (long)gk * N + gn : q, ok);
    }
  };

  // acc[m16 tile][virtual n8 tile t][C register]
  float acc[C::MT][4][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_n) load_stage(s, kt0 + s);
    tc::cp_async_commit();
  }
  // this thread's fragment rows k = 2c, 2c+1, 2c+8, 2c+9 of each k16 step
  // all read the same swizzled word of its 4 columns
  const int qword = (wn * 32 + 4 * (lane >> 2)) ^ ((lane & 3) << 5);
  auto load_q_words = [&](uint32_t (&w)[4], uint32_t qs, int kk) {
    const uint32_t qrow = qs + (kk * 16 + 2 * (lane & 3)) * MBN + qword;
    w[0] = tc::lds32(qrow);
    w[1] = tc::lds32(qrow + MBN);
    w[2] = tc::lds32(qrow + 8 * MBN);
    w[3] = tc::lds32(qrow + 9 * MBN);
  };
  for (int it = 0; it < kt_n; ++it) {
    tc::cp_async_wait<STAGES - 2>();  // tile `it` has landed (this thread's part)
    __syncthreads();                  // everyone's part; tile it-1's reads are done
    const int nx = it + STAGES - 1;
    if (nx < kt_n) load_stage(nx % STAGES, kt0 + nx);  // into tile it-1's buffer
    tc::cp_async_commit();

    const uint32_t xs = s_base + (it % STAGES) * C::STAGE;
    const uint32_t qs = xs + C::X_BYTES;
    // software pipeline: the next k16 step's q words and the next row
    // tile's x fragment are read before this one's products
    uint32_t w[4];
    load_q_words(w, qs, 0);
#pragma unroll
    for (int kk = 0; kk < MBK / 16; ++kk) {
      // virtual n8 tile t: column slot g is real column 4g + t of the warp's 32
      uint32_t b[4][2];
      b[0][0] = tc::s8x2_to_bf16x2<0>(w[0], w[1]);
      b[0][1] = tc::s8x2_to_bf16x2<0>(w[2], w[3]);
      b[1][0] = tc::s8x2_to_bf16x2<1>(w[0], w[1]);
      b[1][1] = tc::s8x2_to_bf16x2<1>(w[2], w[3]);
      b[2][0] = tc::s8x2_to_bf16x2<2>(w[0], w[1]);
      b[2][1] = tc::s8x2_to_bf16x2<2>(w[2], w[3]);
      b[3][0] = tc::s8x2_to_bf16x2<3>(w[0], w[1]);
      b[3][1] = tc::s8x2_to_bf16x2<3>(w[2], w[3]);
      if (kk + 1 < MBK / 16) load_q_words(w, qs, kk + 1);
      uint32_t a[2][4];
      tc::ldmatrix_x4(a[0], xs + x_swz(lane & 15, kk * 2 + (lane >> 4)));
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        if (i + 1 < C::MT)
          tc::ldmatrix_x4(a[(i + 1) & 1],
                          xs + x_swz((i + 1) * 16 + (lane & 15), kk * 2 + (lane >> 4)));
        to_bf16_frag<T>(a[i & 1]);
#pragma unroll
        for (int t = 0; t < 4; ++t) tc::mma_bf16(acc[i][t], a[i & 1], b[t][0], b[t][1]);
      }
    }
  }
  tc::cp_async_wait<0>();

  // C register e of virtual tile t: row g (+8 for e >= 2), real column
  // 8c + t (+4 for odd e) of the warp's 32: 8 neighbouring columns
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int gm = m0 + i * 16 + (lane >> 2) + 8 * hr;
      const int gn = n0 + wn * 32 + 8 * (lane & 3);
      if (gm >= M || gn >= N) continue;  // N % 16 == 0: all 8 columns are in
      float v[8];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        v[t] = acc[i][t][2 * hr];
        v[t + 4] = acc[i][t][2 * hr + 1];
      }
      if constexpr (SPLIT) {
        float4* dst = reinterpret_cast<float4*>(
            static_cast<float*>(out) + ((long)blockIdx.z * M + gm) * N + gn);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        float sv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) sv[j] = v[j] * scales[gn + j];
        *reinterpret_cast<uint4*>(static_cast<T*>(out) + (long)gm * N + gn) = make_uint4(
            pack_out<T>(sv[0], sv[1]), pack_out<T>(sv[2], sv[3]),
            pack_out<T>(sv[4], sv[5]), pack_out<T>(sv[6], sv[7]));
      }
    }
}

// out = cast((sum over slices, ascending, of ws[s]) * scales), elementwise
template <typename T>
__global__ void __launch_bounds__(256) quant_matmul_splitk_reduce_kernel(
    const float* __restrict__ ws, const float* __restrict__ scales, T* __restrict__ out,
    int M, int N, int slices) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long mn = (long)M * N;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < slices; ++z) s += ws[z * mn + i];
  out[i] = store_out<T>(s * scales[i % N]);
}

template <typename T, int BM, bool SPLIT>
int launch_mma(const void* x, const void* q, const void* scales, void* out, int M, int K,
               int N, int k_tiles_per_slice, int slices, cudaStream_t stream) {
  auto kernel = quant_matmul_mma_kernel<T, BM, SPLIT>;
  constexpr int smem = MmaCfg<BM>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + BM - 1) / BM, (N + MBN - 1) / MBN, slices);
  kernel<<<grid, MNT, smem, stream>>>(static_cast<const T*>(x), static_cast<const int8_t*>(q),
                                      static_cast<const float*>(scales), out, M, K, N,
                                      k_tiles_per_slice);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mma_bm(const void* x, const void* q, const void* scales, void* out, int M, int K,
                  int N, int bm, cudaStream_t s) {
  if (bm == 128) return launch_mma<T, 128, false>(x, q, scales, out, M, K, N, 0, 1, s);
  if (bm == 64) return launch_mma<T, 64, false>(x, q, scales, out, M, K, N, 0, 1, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_splitk(const void* x, const void* q, const void* scales, void* out, void* ws,
                  int M, int K, int N, int k_tiles_per_slice, int slices, cudaStream_t s) {
  int err = launch_mma<T, 16, true>(x, q, scales, ws, M, K, N, k_tiles_per_slice, slices, s);
  if (err) return err;
  const long mn = (long)M * N;
  quant_matmul_splitk_reduce_kernel<T><<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<const float*>(scales), static_cast<T*>(out),
      M, N, slices);
  return (int)cudaGetLastError();
}

bool mma_shape_ok(int M, int K, int N) { return M > 0 && K > 0 && N > 0 && K % 8 == 0 && N % 16 == 0; }

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

// Tensor-core variant, bf16 (dtype 1) or f16 (dtype 2) x, tiles of bm =
// 128 or 64 rows by 128 columns. Needs K % 8 == 0, N % 16 == 0 and 16-byte
// aligned x, q and out. Returns a cudaError_t code.
extern "C" int quant_matmul_mma(const void* x, const void* q, const void* scales, void* out,
                                int M, int K, int N, int dtype, int bm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!mma_shape_ok(M, K, N)) return (int)cudaErrorInvalidValue;
  if (dtype == 1) return launch_mma_bm<__nv_bfloat16>(x, q, scales, out, M, K, N, bm, s);
  if (dtype == 2) return launch_mma_bm<__half>(x, q, scales, out, M, K, N, bm, s);
  return (int)cudaErrorInvalidValue;
}

// Split-K variant for M <= 16: `slices` K slices of k_tiles_per_slice
// 64-deep tiles, f32 partial sums in ws (slices, M, N), then the ordered
// reduction with the scale and the cast. Returns a cudaError_t code.
extern "C" int quant_matmul_splitk(const void* x, const void* q, const void* scales, void* out,
                                   void* ws, int M, int K, int N, int dtype,
                                   int k_tiles_per_slice, int slices, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!mma_shape_ok(M, K, N) || M > 16 || k_tiles_per_slice <= 0 ||
      (long)k_tiles_per_slice * slices * MBK < K || (long)k_tiles_per_slice * (slices - 1) * MBK >= K)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_splitk<__nv_bfloat16>(x, q, scales, out, ws, M, K, N, k_tiles_per_slice, slices, s);
  if (dtype == 2)
    return launch_splitk<__half>(x, q, scales, out, ws, M, K, N, k_tiles_per_slice, slices, s);
  return (int)cudaErrorInvalidValue;
}
