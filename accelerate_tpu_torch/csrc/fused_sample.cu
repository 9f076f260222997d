// Fused sampling epilogue for Hopper (sm_90a), written in CUDA C++ (route
// chosen over Triton so all of the port's kernels share one nvcc build
// and one ctypes binding).
//
// Replaces the TPU kernel accelerate_tpu/ops/paged_decode.py::_sample_kernel
// (launched by fused_sample, called from engine.py's decode program).
// Semantics are engine._filter_logits + engine._sample_rows, bitwise:
// temperature scaling, top-k and top-p without a sort. The top-k threshold
// is the k-th largest value exactly, and the top-p cutoff the minimal key
// u0 of the order-preserving uint32 image of f32 (float_key) with S(u0) <
// p * Z, where S(x) is the mass exp(sc - max) of the values whose key is
// strictly above x and Z the top-k survivors' normaliser over exactly k_eff
// entries at ties. The draw is argmax(filtered + noise) with the caller's
// Gumbel noise as an operand; greedy (temperature <= 0) is the first index
// of the max of the raw logits. Ties resolve to the first index everywhere.
//
// What bounds it on the card: the least traffic is one read of logits and
// noise (2 * S * V * 4 bytes; at S = 8, V = 128,256: 8.2 MB, 2.45 us at
// 3.35 TB/s), so bytes. What the design does about it:
//   * one thread block cluster of C blocks per row (C = CLUSTER = 16, the
//     non-portable cluster size; the entry point derives each block's
//     slice and refuses a row whose slices do not fit shared memory):
//     S = 8 rows run on 128 SMs, and a request's first token (S = 1) on 16.
//     Each block (256 threads) keeps its 1/C of the row in shared memory,
//     the scaled logits x / t and their exp(sc - max), 2 * 8,016 * 4 B at
//     V = 128,256,
//     so logits and noise are read once from device memory;
//   * both thresholds come from radix selects over float_key in 8-bit
//     digits, four levels each: a 256-bin histogram of the keys that match
//     the chosen prefix (counts for top-k; for top-p the mass, carrying the
//     mass above the prefix down), summed over the cluster, then a suffix
//     scan picks the digit. About a dozen passes over shared memory in
//     place of some 70 over L2 in the earlier one-block binary searches,
//     and one expf per element in place of 34;
//   * block partials are combined through distributed shared memory: each
//     block publishes its partial, cluster.sync(), and every block sums the
//     C published partials in rank order 0..C-1 (double-buffered, so one
//     cluster barrier per reduction, 12 for a sampled row with top-k and
//     top-p, 3 for a greedy row).
// Each warp counts into its own 256 bins with native 32-bit shared-memory
// atomics, summed over the warps after the pass: the logits' top bytes
// fall into a few bins (tied logits into one at every level), and one
// 64-bit histogram per block serialised its atomics there, 4x slower per
// sampled row on an H100 (NVIDIA H100 80GB HBM3, 700 W). The noise's lines
// are prefetched into L2 while the logits load.
// Determinism: every mass (the histograms, Z's terms, e_all) is summed in
// 64-bit fixed point, each exp(sc - max) <= 1 rounded to a multiple of
// 2^-43 (exact integer sums, so shared-memory atomics are exact and the
// result does not depend on their order: no float atomics anywhere), and
// turned into f32 once with one rounding. A second launch gives the same
// bits. Against the plain version's float sums (torch's .sum order) the
// two agree bitwise unless a row's cutoff lies within rounding of p * Z,
// as before; chip_smoke.py puts that to the test on 512 seeded rows. Z is
// still formed with the explicit roundings __fadd_rn / __fmul_rn of the
// plain version, and exp is expf (no fast-math approximations).
//
// Layout: logits, noise (S, V) f32; temperature, top_p (S,) f32; top_k (S,)
// int32; out (S,) int32.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 16;  // blocks per row: the non-portable size, which the H100 allows
constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int BINS = 256;
using u64 = unsigned long long;
constexpr float kFix = 8796093022208.0f;  // 2^43: exp(sc - max) <= 1; V * 2^43 < 2^64

__device__ __forceinline__ uint32_t float_key(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k >> 31) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ u64 fix(float e) { return __float2ull_rn(e * kFix); }

__device__ __forceinline__ float unfix(u64 x) { return __ull2float_rn(x) * (1.0f / kFix); }

struct Smem {
  u64 pub[2][BINS];  // published block partials, double-buffered
  u64 hist[BINS];    // this block's histogram
  u64 warp_u[NWARP];
  float warp_f[NWARP];
  int warp_i[NWARP];
  u64 carry;         // the chosen digit's carry (count left, or mass above)
  int digit;
};

// (value, index) ordered by value descending, then index ascending
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The cluster's (max, first index) of every thread's (v, i); each block
// publishes its pair and reads all C in rank order.
__device__ void cluster_argmax(cg::cluster_group& cl, Smem& sm, int& par, float& v, int& i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  if (lane == 0) { sm.warp_f[warp] = v; sm.warp_i[warp] = i; }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < NWARP; ++w)
      if (better(sm.warp_f[w], sm.warp_i[w], v, i)) { v = sm.warp_f[w]; i = sm.warp_i[w]; }
    sm.pub[par][0] = __float_as_uint(v);
    sm.pub[par][1] = (uint32_t)i;
  }
  cl.sync();
  const int C = (int)cl.num_blocks();
  v = __uint_as_float((uint32_t)*cl.map_shared_rank(&sm.pub[par][0], 0));
  i = (int)*cl.map_shared_rank(&sm.pub[par][1], 0);
  for (int r = 1; r < C; ++r) {
    const float rv = __uint_as_float((uint32_t)*cl.map_shared_rank(&sm.pub[par][0], r));
    const int ri = (int)*cl.map_shared_rank(&sm.pub[par][1], r);
    if (better(rv, ri, v, i)) { v = rv; i = ri; }
  }
  par ^= 1;
}

// The cluster's sums of up to 3 u64 values per thread (integers: exact).
__device__ void cluster_sum3(cg::cluster_group& cl, Smem& sm, int& par, u64 (&x)[3]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < 3; ++k) {
    u64 y = x[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) y += __shfl_xor_sync(0xffffffffu, y, off);
    if (lane == 0) sm.hist[warp * 3 + k] = y;  // 24 of the 256 slots
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    u64 s = 0;
    for (int w = 0; w < NWARP; ++w) s += sm.hist[w * 3 + threadIdx.x];
    sm.pub[par][threadIdx.x] = s;
  }
  cl.sync();
  const int C = (int)cl.num_blocks();
  for (int k = 0; k < 3; ++k) {
    u64 s = 0;
    for (int r = 0; r < C; ++r) s += *cl.map_shared_rank(&sm.pub[par][k], r);
    x[k] = s;
  }
  par ^= 1;
}

// Publish this block's histogram, sum it over the cluster (thread t < 256
// gets bin t) and return the inclusive suffix sum of bin t (the total of
// bins t..255) in `incl`, the bin itself in `tot`.
__device__ void cluster_hist_suffix(cg::cluster_group& cl, Smem& sm, int& par, u64& tot, u64& incl) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t < BINS) sm.pub[par][t] = sm.hist[t];
  cl.sync();
  tot = incl = 0;
  if (t < BINS) {
    const int C = (int)cl.num_blocks();
    u64 part[CLUSTER];  // all C remote loads in flight before the sum (rank order)
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) part[r] = r < C ? *cl.map_shared_rank(&sm.pub[par][t], r) : 0;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) tot += part[r];
    incl = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const u64 y = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += y;
    }
    if (lane == 0) sm.warp_u[warp] = incl;
  }
  __syncthreads();
  if (t < BINS)
    for (int w = warp + 1; w < BINS / 32; ++w) incl += sm.warp_u[w];
  par ^= 1;
}

__device__ __forceinline__ uint32_t level_mask(int level) {
  return level == 0 ? 0u : (0xffffffffu << (32 - 8 * level));
}

// One level's histogram of the keys whose bits above `shift + 8` equal
// `prefix`: into each warp's own 256 bins with 32-bit shared-memory atomics
// (native; they contend only within a warp), then summed over the warps
// into sm.hist; each thread zeroes the bins it summed, for the next level.
// MASS: the fixed-point exp (<= 2^43) in LIMBS limbs, 22 + 21 bits where a
// warp adds at most 1,024 values a level (V <= 131,072 at 16 blocks),
// 15 + 15 + 13 bits otherwise, so no limb sum can overflow 32 bits; else
// counts. Integer sums: exact in any order.
template <bool MASS, int LIMBS>
__device__ void level_hist(Smem& sm, unsigned (*wh)[3][BINS], const float* sSc, const float* sE,
                           int n, uint32_t prefix, uint32_t hi, int shift) {
  const int tid = threadIdx.x;
  constexpr int LB = LIMBS == 2 ? 22 : 15;  // bits of the low limbs
  unsigned (*mine)[BINS] = wh[tid >> 5];
  for (int i = tid; i < n; i += NT) {
    const uint32_t key = float_key(sSc[i]);
    if ((key & hi) != prefix) continue;
    const int d = (key >> shift) & 0xff;
    if constexpr (MASS) {
      const u64 v = fix(sE[i]);
      atomicAdd(&mine[0][d], (unsigned)(v & ((1u << LB) - 1)));
      atomicAdd(&mine[1][d], (unsigned)((v >> LB) & (LIMBS == 2 ? 0xffffffffu : (1u << LB) - 1)));
      if constexpr (LIMBS == 3) atomicAdd(&mine[2][d], (unsigned)(v >> (2 * LB)));
    } else {
      atomicAdd(&mine[0][d], 1u);
    }
  }
  __syncthreads();
  if (tid < BINS) {
    u64 sum = 0;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      sum += wh[w][0][tid];
      wh[w][0][tid] = 0;
      if constexpr (MASS) {
        sum += (u64)wh[w][1][tid] << LB;
        wh[w][1][tid] = 0;
        if constexpr (LIMBS == 3) {
          sum += (u64)wh[w][2][tid] << (2 * LB);
          wh[w][2][tid] = 0;
        }
      }
    }
    sm.hist[tid] = sum;
  }
}

__global__ void __launch_bounds__(NT) fused_sample_kernel(
    const float* __restrict__ logits, const float* __restrict__ noise,
    const float* __restrict__ temp, const int* __restrict__ top_k,
    const float* __restrict__ top_p, int* __restrict__ out, int V, int chunk) {
  cg::cluster_group cl = cg::this_cluster();
  __shared__ Smem sm;
  __shared__ unsigned wh[NWARP][3][BINS];  // each warp's histogram of a level
  extern __shared__ float dyn[];
  float* sSc = dyn;          // x / safe_t of this block's slice
  float* sE = dyn + chunk;   // exp(sc - m_s)
  const int C = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const long row = blockIdx.x / C;
  const int lo = min(rank * chunk, V);
  const int n = min(lo + chunk, V) - lo;
  const float* x = logits + row * V + lo;
  const float* nz = noise + row * V + lo;
  const float t = temp[row];
  const int tk = top_k[row];
  const float tp = top_p[row];
  const int tid = threadIdx.x;
  int par = 0;
  for (int i = tid; i < NWARP * 3 * BINS; i += NT) (&wh[0][0][0])[i] = 0;  // zero between levels after
  cl.sync();  // every block of the cluster is running before any reads another's shared memory

  // scaled logits into shared memory; (max, first index). With t <= 0,
  // safe_t = 1 and sc = x exactly: the greedy token.
  const float safe_t = t > 0.f ? t : 1.0f;
  float mv = -INFINITY;
  int mi = V;
  if (t > 0.f)  // the noise is read last: bring its lines into L2 now
    for (int i = tid * 32; i < n; i += NT * 32)
      asm volatile("prefetch.global.L2 [%0];" :: "l"(nz + i));
#pragma unroll 4
  for (int i = tid; i < n; i += NT) {
    const float s = x[i] / safe_t;
    sSc[i] = s;
    if (mi == V || s > mv) { mv = s; mi = lo + i; }
  }
  cluster_argmax(cl, sm, par, mv, mi);
  if (t <= 0.f) {
    if (rank == 0 && tid == 0) out[row] = mi;
    cl.sync();  // no block leaves while another still reads its shared memory
    return;
  }
  const float m_s = mv;
  const bool k_on = tk > 0 && tk < V;
  const int k_eff = tk < 1 ? 1 : (tk > V ? V : tk);
  const bool p_on = tp < 1.0f;
  for (int i = tid; i < n; i += NT) sE[i] = expf(sSc[i] - m_s);

  // top-k: the k_eff-th largest key, four 8-bit digits from the top
  uint32_t kkey = 0;
  if (k_on) {
    u64 left = (u64)k_eff;
    for (int level = 0; level < 4; ++level) {
      const int shift = 24 - 8 * level;
      const uint32_t hi = level_mask(level);
      level_hist<false, 1>(sm, wh, sSc, sE, n, kkey, hi, shift);
      u64 tot, incl;
      cluster_hist_suffix(cl, sm, par, tot, incl);
      if (tid < BINS && incl - tot < left && left <= incl) {
        sm.digit = tid;
        sm.carry = left - (incl - tot);
      }
      __syncthreads();
      kkey |= (uint32_t)sm.digit << shift;
      left = sm.carry;
    }
  }
  const float kth = key_float(kkey);

  float pz = 0.f;
  if (p_on) {
    // Z: all mass, or (top-k on) the mass above kth plus exactly k_eff -
    // cnt_gt entries at kth
    u64 sums[3] = {0, 0, 0};  // e_all, e_gt, cnt_gt
    for (int i = tid; i < n; i += NT) {
      const u64 e = fix(sE[i]);
      sums[0] += e;
      if (k_on && sSc[i] > kth) { sums[1] += e; sums[2] += 1; }
    }
    cluster_sum3(cl, sm, par, sums);
    // explicit roundings: no fused multiply-add, same as the plain version
    const float z = k_on ? __fadd_rn(unfix(sums[1]), __fmul_rn((float)(k_eff - (int)sums[2]),
                                                               expf(kth - m_s)))
                         : unfix(sums[0]);
    pz = tp * z;
  }

  // top-p: the key of the element at which the mass from the top first
  // reaches p * Z, i.e. the minimal key u0 with S(u0) < p * Z; 0 (keep
  // all) where the whole row's mass stays below it
  uint32_t u0 = 0;
  if (p_on && pz > 0.f) {  // p * Z <= 0 (top_p <= 0): every mass reaches it, u0 = 0
    const bool two_limbs = chunk <= NT * 32;  // at most 1,024 values a warp
    u64 above = 0;  // mass of the keys above the prefix's range
    for (int level = 0; level < 4; ++level) {
      const int shift = 24 - 8 * level;
      const uint32_t hi = level_mask(level);
      if (two_limbs) level_hist<true, 2>(sm, wh, sSc, sE, n, u0, hi, shift);
      else level_hist<true, 3>(sm, wh, sSc, sE, n, u0, hi, shift);
      u64 tot, incl;
      cluster_hist_suffix(cl, sm, par, tot, incl);
      // one writer: the bin where the mass from the top crosses p * Z, or
      // thread 0 (its suffix is every bin) where nothing crosses
      if (tid < BINS && unfix(above + incl) >= pz && unfix(above + incl - tot) < pz) {
        sm.digit = tid;
        sm.carry = above + incl - tot;
      }
      if (tid == 0 && unfix(above + incl) < pz) sm.digit = -1;
      __syncthreads();
      if (sm.digit < 0) break;  // level 0 only: the whole row stays below p * Z
      u0 |= (uint32_t)sm.digit << shift;
      above = sm.carry;
    }
  }

  // categorical == argmax(filtered + gumbel), first index at ties
  float gv = -INFINITY;
  int gi = V;
  for (int i = tid; i < n; i += NT) {
    const float s = sSc[i];
    const bool keep = (!k_on || s >= kth) && (!p_on || float_key(s) >= u0);
    const float g = (keep ? s : -INFINITY) + nz[i];
    if (gi == V || g > gv) { gv = g; gi = lo + i; }
  }
  cluster_argmax(cl, sm, par, gv, gi);
  if (rank == 0 && tid == 0) out[row] = gi;
  cl.sync();
}

}  // namespace

// One cluster of CLUSTER blocks per row, each holding chunk = ceil(V /
// CLUSTER) elements twice (2 * chunk * 4 bytes of dynamic shared memory
// beside the static buffers). Refuses a V whose slices do not fit the
// device's shared memory per block. Returns a cudaError_t code (0 on
// success).
extern "C" int fused_sample(const void* logits, const void* noise, const void* temp,
                            const void* top_k, const void* top_p, void* out, int S,
                            int V, void* stream) {
  if (S <= 0) return 0;
  if (V <= 0) return (int)cudaErrorInvalidValue;
  const int chunk = (V + CLUSTER - 1) / CLUSTER;
  const long smem = 2L * chunk * (long)sizeof(float);
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, fused_sample_kernel);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, optin = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if ((long)fa.sharedSizeBytes + smem > optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fused_sample_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fused_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * CLUSTER);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_sample_kernel, static_cast<const float*>(logits),
                           static_cast<const float*>(noise), static_cast<const float*>(temp),
                           static_cast<const int*>(top_k), static_cast<const float*>(top_p),
                           static_cast<int*>(out), V, chunk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
