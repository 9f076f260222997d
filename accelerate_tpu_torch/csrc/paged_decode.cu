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
// card's ~295 flop/byte ridge. What the design does about it:
//   * one block per (slot, kv head) holds the whole GQA group's n_rep query
//     rows in registers, so each K/V row is read from memory once per
//     group, never n_rep times;
//   * the block loads its own block-table row and its own pos (this takes
//     the place of the TPU kernel's scalar prefetch) and walks only blocks
//     0 .. pos / block_size: the dead tail of the row is never touched;
//   * the block's 4 warps split the live blocks round-robin, so four
//     independent streams of loads are in flight, and merge their online
//     softmax partials (m, l, acc) through shared memory at the end;
//   * each lane owns D/32 contiguous dims, so a warp reads one K row of a
//     head (D * itemsize bytes) as one coalesced request.
// Grid (Hkv, B) is small at decode batch sizes (64 blocks for 8 slots and 8
// kv heads), which leaves SMs idle; splitting a slot's blocks over several
// thread blocks (split-K) is later work. Vacant slots carry null-block
// (block 0) table entries and read block 0: always in range.
//
// Layout: q, out (B, 1, H, D); k_pool, v_pool (num_blocks, block_size, Hkv,
// D); tables (B, blocks_per_row) int32; pos (B,) int32. The int8 pool with
// per-(block, position) scales is not ported yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1.0e6f;
constexpr int NW = 4;        // warps per block
constexpr int CHUNK = 8;     // K/V rows loaded ahead per warp

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

template <typename T, int D, int NREP>
__global__ void __launch_bounds__(NW * 32) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
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
    const long base = (long)trow[j] * bs * row_stride + (long)g * D + lane * DL;
    for (int t0 = 0; t0 < bs; t0 += CHUNK) {
      float kr[CHUNK][DL], vr[CHUNK][DL];
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        const bool in = t0 + u < bs;
        const long off = base + (long)(t0 + u) * row_stride;
#pragma unroll
        for (int i = 0; i < DL; ++i) {
          kr[u][i] = in ? to_f(k_pool[off + i]) : 0.f;
          vr[u][i] = in ? to_f(v_pool[off + i]) : 0.f;
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

template <typename T, int D, int NREP>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* pos, void* out, int B, int H, int Hkv, int bs, int bpr,
           float scale, float softcap, cudaStream_t stream) {
  dim3 grid(Hkv, B);
  paged_decode_kernel<T, D, NREP><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      tables, pos, static_cast<T*>(out), H, Hkv, bs, bpr, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int by_rep(int nrep, const void* q, const void* kp, const void* vp, const int* tables,
           const int* pos, void* out, int B, int H, int Hkv, int bs, int bpr,
           float scale, float softcap, cudaStream_t s) {
  switch (nrep) {
    case 1: return launch<T, D, 1>(q, kp, vp, tables, pos, out, B, H, Hkv, bs, bpr, scale, softcap, s);
    case 2: return launch<T, D, 2>(q, kp, vp, tables, pos, out, B, H, Hkv, bs, bpr, scale, softcap, s);
    case 4: return launch<T, D, 4>(q, kp, vp, tables, pos, out, B, H, Hkv, bs, bpr, scale, softcap, s);
    case 8: return launch<T, D, 8>(q, kp, vp, tables, pos, out, B, H, Hkv, bs, bpr, scale, softcap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. softcap <= 0 means off.
// Returns a cudaError_t code (0 on success).
extern "C" int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                            const void* tables, const void* pos, void* out, int B,
                            int H, int Hkv, int D, int bs, int bpr, int dtype,
                            float scale, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || bs <= 0 || bpr <= 0) return (int)cudaErrorInvalidValue;
  const int nrep = H / Hkv;
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(pos);
  if (dtype == 0 && D == 64)
    return by_rep<float, 64>(nrep, q, k_pool, v_pool, t, p, out, B, H, Hkv, bs, bpr, scale, softcap, s);
  if (dtype == 0 && D == 128)
    return by_rep<float, 128>(nrep, q, k_pool, v_pool, t, p, out, B, H, Hkv, bs, bpr, scale, softcap, s);
  if (dtype == 1 && D == 64)
    return by_rep<__nv_bfloat16, 64>(nrep, q, k_pool, v_pool, t, p, out, B, H, Hkv, bs, bpr, scale, softcap, s);
  if (dtype == 1 && D == 128)
    return by_rep<__nv_bfloat16, 128>(nrep, q, k_pool, v_pool, t, p, out, B, H, Hkv, bs, bpr, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
