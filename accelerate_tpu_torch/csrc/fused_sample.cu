// Fused sampling epilogue for Hopper (sm_90a), written in CUDA C++ (route
// chosen over Triton so all of the slice's kernels share one nvcc build
// and one ctypes binding).
//
// Replaces the TPU kernel accelerate_tpu/ops/paged_decode.py::_sample_kernel
// (launched by fused_sample, called from engine.py's decode program).
// Semantics are engine._filter_logits + engine._sample_rows, bitwise:
// temperature scaling, top-k and top-p without a sort. Both thresholds come
// from 32-step binary searches over the order-preserving uint32 image of
// f32 (_float_key): the k-th largest value exactly, and the top-p cutoff as
// the minimal key u0 with S(u0) < p * Z, where S(x) is the mass of kept
// values strictly above x and Z the top-k survivors' normaliser over
// exactly k_eff entries at ties. The draw is argmax(filtered + noise) with
// the caller's Gumbel noise as an operand; greedy (temperature <= 0) is the
// first index of the max of the raw logits. Ties resolve to the first index
// everywhere. The float sums (Z and the mass above each top-p candidate)
// add up a block tree, in another order than torch's .sum in the plain
// version: the two agree bitwise unless a row's cutoff lies within rounding
// of p * Z, which chip_smoke.py puts to the test on 512 seeded rows.
//
// What bounds it on the card: at a 128k vocabulary a row is 513 KB of f32,
// more than a block's 227 KB of shared memory and its registers, and the
// algorithm makes ~70 passes over it (2 x 32 search steps plus the
// reductions around them). The minimum traffic is one read of logits and
// noise, so the bound is bytes; this design is instead bound by L2
// bandwidth of one SM per row. What the design does: one 1024-thread block
// per row, each pass a strided read of the row (served from L2 after the
// first pass) followed by one block reduction (warp shuffles + 32 partials
// in shared memory). Splitting a row over many SMs is later work.
//
// Layout: logits, noise (S, V) f32; temperature, top_p (S,) f32; top_k (S,)
// int32; out (S,) int32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;

__device__ __forceinline__ uint32_t float_key(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

// Block-wide reductions. `red` holds 32 partials; every thread gets the
// result. Two barriers per call keep back-to-back calls race-free.
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < NT / 32 ? red[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ int block_sum_int(int x, int* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < NT / 32 ? red[lane] : 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < NT / 32 ? red[lane] : -INFINITY;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ int block_min_int(int x, int* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, off));
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < NT / 32 ? red[lane] : 0x7fffffff;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__global__ void __launch_bounds__(NT) fused_sample_kernel(
    const float* __restrict__ logits, const float* __restrict__ noise,
    const float* __restrict__ temp, const int* __restrict__ top_k,
    const float* __restrict__ top_p, int* __restrict__ out, int V) {
  __shared__ float redf[32];
  __shared__ int redi[32];
  const long row = blockIdx.x;
  const float* x = logits + row * V;
  const float* nz = noise + row * V;
  const float t = temp[row];
  const int tk = top_k[row];
  const float tp = top_p[row];

  // greedy = first index of the max of the RAW logits
  float mx = -INFINITY;
  for (int i = threadIdx.x; i < V; i += NT) mx = fmaxf(mx, x[i]);
  const float m_raw = block_max(mx, redf);
  int first = V;
  for (int i = threadIdx.x; i < V; i += NT)
    if (x[i] == m_raw) { first = i; break; }
  const int greedy = block_min_int(first, redi);

  const float safe_t = t > 0.f ? t : 1.0f;
  const bool k_on = tk > 0 && tk < V;
  const int k_eff = tk < 1 ? 1 : (tk > V ? V : tk);

  // k-th largest key: maximal key with count(key >= key0) >= k_eff
  uint32_t kkey = 0;
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t cand = kkey | (1u << bit);
    int cnt = 0;
    for (int i = threadIdx.x; i < V; i += NT) cnt += float_key(x[i] / safe_t) >= cand;
    if (block_sum_int(cnt, redi) >= k_eff) kkey = cand;
  }
  float kv = -INFINITY, ms = -INFINITY;
  for (int i = threadIdx.x; i < V; i += NT) {
    const float sc = x[i] / safe_t;
    if (float_key(sc) == kkey) kv = fmaxf(kv, sc);
    ms = fmaxf(ms, sc);
  }
  const float kth = block_max(kv, redf);
  const float m_s = block_max(ms, redf);

  // top-p over the top-k survivors: Z counts exactly k_eff entries at ties
  int gt = 0;
  float e_gt = 0.f, e_all = 0.f;
  for (int i = threadIdx.x; i < V; i += NT) {
    const float sc = x[i] / safe_t;
    const float e = expf(sc - m_s);
    e_all += e;
    if (sc > kth) { gt += 1; e_gt += e; }
  }
  const int cnt_gt = block_sum_int(gt, redi);
  const float z_gt = block_sum(e_gt, redf);
  const float z_all = block_sum(e_all, redf);
  // explicit roundings: no fused multiply-add, same as the plain version
  const float z =
      k_on ? __fadd_rn(z_gt, __fmul_rn((float)(k_eff - cnt_gt), expf(kth - m_s))) : z_all;
  const bool p_on = tp < 1.0f;
  const float pz = (p_on ? tp : 1.0f) * z;

  // minimal key u0 with S(u0) < p*Z, via the maximal key u1 with S >= p*Z
  uint32_t u1 = 0;
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t cand = u1 | (1u << bit);
    float s_above = 0.f;
    for (int i = threadIdx.x; i < V; i += NT) {
      const float sc = x[i] / safe_t;
      if (float_key(sc) > cand) s_above += expf(sc - m_s);
    }
    if (block_sum(s_above, redf) >= pz) u1 = cand;
  }
  float s_u1 = 0.f;
  for (int i = threadIdx.x; i < V; i += NT) {
    const float sc = x[i] / safe_t;
    if (float_key(sc) > u1) s_u1 += expf(sc - m_s);
  }
  const uint32_t u0 = block_sum(s_u1, redf) >= pz ? u1 + 1u : u1;

  // categorical == argmax(filtered + gumbel), first index at ties
  float gm = -INFINITY;
  for (int i = threadIdx.x; i < V; i += NT) {
    const float sc = x[i] / safe_t;
    const bool keep = (!k_on || sc >= kth) && (!p_on || float_key(sc) >= u0);
    gm = fmaxf(gm, (keep ? sc : -INFINITY) + nz[i]);
  }
  const float m_g = block_max(gm, redf);
  int sfirst = V;
  for (int i = threadIdx.x; i < V; i += NT) {
    const float sc = x[i] / safe_t;
    const bool keep = (!k_on || sc >= kth) && (!p_on || float_key(sc) >= u0);
    if ((keep ? sc : -INFINITY) + nz[i] == m_g) { sfirst = i; break; }
  }
  const int sampled = block_min_int(sfirst, redi);
  if (threadIdx.x == 0) out[row] = t > 0.f ? sampled : greedy;
}

}  // namespace

// Returns a cudaError_t code (0 on success).
extern "C" int fused_sample(const void* logits, const void* noise, const void* temp,
                            const void* top_k, const void* top_p, void* out, int S,
                            int V, void* stream) {
  if (S <= 0) return 0;
  if (V <= 0) return (int)cudaErrorInvalidValue;
  fused_sample_kernel<<<S, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(noise),
      static_cast<const float*>(temp), static_cast<const int*>(top_k),
      static_cast<const float*>(top_p), static_cast<int*>(out), V);
  return (int)cudaGetLastError();
}
