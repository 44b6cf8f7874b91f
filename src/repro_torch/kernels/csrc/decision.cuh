// Shared code of the decision-plane kernels (penalty.cu, shvs.cu,
// fused.cu, gumbel.cu). Built with -fmad=false and without fast-math: every product
// and sum rounds on its own, exactly as the separate elementwise ops of the
// plain PyTorch versions do, and expf/logf are the accurate libdevice ones.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_NEG_INF (-1e30f)
#define REPRO_FULL_MASK 0xffffffffu

namespace cg = cooperative_groups;

// Order-preserving map of float bits; -0 and +0 tie, as in a stable sort.
__device__ __forceinline__ uint32_t ord_bits(float v) {
  const uint32_t b = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_ord(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

// max(x, lo) and min(x, hi) that keep a NaN x, as torch.clamp and
// jnp.maximum / jnp.minimum do (fmaxf and fminf drop it).
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float clamp_hi(float x, float hi) {
  return x > hi ? hi : x;
}

// max(a, b) where a NaN in either wins, as torch.amax and jnp.max do.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// Packed key: value order in the high word, the inverted column in the low
// word, so the largest key is "largest value, lowest column first".
__device__ __forceinline__ uint64_t sort_key(float v, int j) {
  return ((uint64_t)ord_bits(v) << 32) | (uint64_t)(0xFFFFFFFFu - (uint32_t)j);
}

// The two halves of ref._hash_uniform: hash_mix takes the key
// x = (b * 2654435761u) ^ (v * 40503u) ^ seed to the hash value, and
// hash_to_uniform takes that to u in (0, 1]. The top 128 hash values
// (>= HASH_U_ONE) round to 2^32 in the uint32 -> f32 conversion, so
// u == 1.0 there, as in the reference.
#define HASH_U_ONE 0xFFFFFF80u

__device__ __forceinline__ uint32_t hash_mix(uint32_t x) {
  x ^= x >> 16;
  x *= 2246822519u;
  x ^= x >> 13;
  x *= 3266489917u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float hash_to_uniform(uint32_t h) {
  return ((float)h + 0.5f) * (1.0f / 4294967296.0f);
}

// ref._hash_uniform(seed, b, v), bit for bit.
__device__ __forceinline__ float hash_uniform(uint32_t seed, uint32_t b,
                                              uint32_t v) {
  return hash_to_uniform(hash_mix((b * 2654435761u) ^ (v * 40503u) ^ seed));
}

// Eq. 1 penalties, then / max(temperature, 1e-6): op for op as
// ref.penalty_ref, so the result is bit-equal to it.
__device__ __forceinline__ float penalize(float z, int cp, int co, float rep,
                                          float pres, float freq,
                                          float temp) {
  const float seen = (cp > 0 || co > 0) ? 1.0f : 0.0f;
  const float f = 1.0f + (rep - 1.0f) * seen;
  z = z > 0.0f ? z / f : z * f;
  z = z - pres * (co > 0 ? 1.0f : 0.0f);
  z = z - freq * (float)co;
  return z / clamp_lo(temp, 1e-6f);
}

// Online-softmax state: running max m and exp-sums a, b in the basis
// exp(z - m). Folding one value or merging two states rescales the sums.
__device__ __forceinline__ void mass_add(float& m, float& a, float& b,
                                         float z, bool to_a, bool to_b) {
  if (z > m) {
    const float sc = expf(m - z);
    a *= sc;
    b *= sc;
    m = z;
  }
  const float w = expf(z - m);
  if (to_a) a += w;
  if (to_b) b += w;
}

// mass_add of four values: one rescale at most, then four exps. Bit i of
// to_a / to_b says where value i goes.
__device__ __forceinline__ void mass_add4(float& m, float& a, float& b,
                                          const float v[4], unsigned to_a,
                                          unsigned to_b) {
  const float mx = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
  if (mx > m) {
    const float sc = expf(m - mx);
    a *= sc;
    b *= sc;
    m = mx;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float w = expf(v[i] - m);
    if ((to_a >> i) & 1u) a += w;
    if ((to_b >> i) & 1u) b += w;
  }
}

// Bit i set where hot[j + i] != 0, i < 4, from aligned 4-byte words: one
// word, or two joined by a funnel shift where hot + j is not 4-aligned.
// The second word then holds hot[j + 3], so both words lie in the mask's
// allocation rounded to 4 bytes.
__device__ __forceinline__ unsigned hot_bits4(const unsigned char* hot,
                                              int j) {
  const uintptr_t a = (uintptr_t)(hot + j);
  const uint32_t* w = (const uint32_t*)(a & ~(uintptr_t)3);
  const uint32_t sh = (uint32_t)(a & 3) * 8;
  const uint32_t x = sh == 0 ? w[0] : __funnelshift_r(w[0], w[1], sh);
  return (x & 0xFFu ? 1u : 0u) | (x & 0xFF00u ? 2u : 0u) |
         (x & 0xFF0000u ? 4u : 0u) | (x & 0xFF000000u ? 8u : 0u);
}

// Of the n 4-byte elements from p, those before the first one at a
// 16-byte address.
__device__ __forceinline__ int head_to_16(const void* p, int n) {
  const int h = (int)(((16u - ((uintptr_t)p & 15u)) & 15u) >> 2);
  return min(h, n);
}

__device__ __forceinline__ void mass_merge(float& m, float& a, float& b,
                                           float m2, float a2, float b2) {
  const float mn = fmaxf(m, m2);
  const float s1 = expf(m - mn);
  const float s2 = expf(m2 - mn);
  a = a * s1 + a2 * s2;
  b = b * s1 + b2 * s2;
  m = mn;
}

// Block-wide merge of every thread's (m, a, b); all threads get the result.
// `scratch` holds 3 * 32 floats of shared memory.
__device__ __forceinline__ void block_mass_reduce(float& m, float& a,
                                                  float& b, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float a2 = __shfl_xor_sync(0xffffffffu, a, off);
    const float b2 = __shfl_xor_sync(0xffffffffu, b, off);
    mass_merge(m, a, b, m2, a2, b2);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  __syncthreads();
  if (lane == 0) {
    scratch[warp] = m;
    scratch[32 + warp] = a;
    scratch[64 + warp] = b;
  }
  __syncthreads();
  m = scratch[0];
  a = scratch[32];
  b = scratch[64];
  for (int w = 1; w < nwarps; ++w)
    mass_merge(m, a, b, scratch[w], scratch[32 + w], scratch[64 + w]);
  __syncthreads();
}

// Block-wide sum of one float (all threads get it, same order every run).
__device__ __forceinline__ float block_sum(float x, float* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  float s = scratch[0];
  for (int w = 1; w < nwarps; ++w) s += scratch[w];
  __syncthreads();
  return s;
}

// Warp 0 merges the cluster's per-CTA states in rank order: lane r reads
// rank r's state (one round trip through distributed shared memory for
// all ranks), then lane 0 folds lanes 1..C-1 into lane 0's with
// mass_merge, in order, so the sums do not depend on which CTA finished
// first. `state` holds (m, a, b, x) in each CTA, and y after them where
// `y` is given; x and y are merged by nan_max. Returns the merged state in
// lane 0; call from all of warp 0.
__device__ __forceinline__ void cluster_mass_merge(cg::cluster_group& cl,
                                                   float* state, int C,
                                                   float& m, float& a,
                                                   float& b, float& x,
                                                   float* y = nullptr) {
  const int lane = threadIdx.x & 31;
  float mr = REPRO_NEG_INF, ar = 0.0f, br = 0.0f, xr = REPRO_NEG_INF;
  float yr = -INFINITY;
  if (lane < C) {
    const float* s = cl.map_shared_rank(state, lane);
    mr = s[0];
    ar = s[1];
    br = s[2];
    xr = s[3];
    if (y != nullptr) yr = s[4];
  }
  m = __shfl_sync(REPRO_FULL_MASK, mr, 0);
  a = __shfl_sync(REPRO_FULL_MASK, ar, 0);
  b = __shfl_sync(REPRO_FULL_MASK, br, 0);
  x = __shfl_sync(REPRO_FULL_MASK, xr, 0);
  float yv = __shfl_sync(REPRO_FULL_MASK, yr, 0);
  for (int r = 1; r < C; ++r) {
    const float m2 = __shfl_sync(REPRO_FULL_MASK, mr, r);
    const float a2 = __shfl_sync(REPRO_FULL_MASK, ar, r);
    const float b2 = __shfl_sync(REPRO_FULL_MASK, br, r);
    x = nan_max(x, __shfl_sync(REPRO_FULL_MASK, xr, r));
    if (y != nullptr) yv = nan_max(yv, __shfl_sync(REPRO_FULL_MASK, yr, r));
    mass_merge(m, a, b, m2, a2, b2);
  }
  if (y != nullptr) *y = yv;
}

// How shvs.cu, fused.cu and gumbel.cu split a row of `cols` columns over a
// cluster of C CTAs, each owning `chunk` contiguous columns (the last ones
// what is left, possibly none). C is the smallest power of two with
// B * C >= 528 (four CTAs for each of the 132 SMs), at most 16 and at least
// `min_clusters` (a kernel's cap on columns a CTA); then chunk is
// ceil(cols / C) rounded up to 16, but at least REPRO_MIN_COLS, and C is
// cut to the power of two at or above ceil(cols / chunk). So no CTA but
// the last real one gets fewer than 2048 columns: below that the cluster
// barrier and the merge cost more than the split saves.
#define REPRO_MAX_CLUSTER 16
#define REPRO_MIN_COLS 2048
#define REPRO_CTA_TARGET 528

struct RowSplit {
  int C, chunk;
};

static inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

static inline RowSplit row_split(int B, int cols, int min_clusters) {
  int C = 1;
  while (C < REPRO_MAX_CLUSTER && (long long)B * C < REPRO_CTA_TARGET)
    C <<= 1;
  C = C > min_clusters ? C : min_clusters;
  int chunk = (cols + C - 1) / C;
  chunk = (chunk + 15) / 16 * 16;
  chunk = chunk > REPRO_MIN_COLS ? chunk : REPRO_MIN_COLS;
  const int need = pow2_at_least((cols + chunk - 1) / chunk);
  C = need < C ? need : C;
  return {C, chunk};
}

// Launch `kernel` on a (C, B) grid of `threads`-thread CTAs in clusters of
// (C, 1, 1): one cluster a row. A cluster of 16 is past the portable 8 and
// needs the non-portable attribute. Returns the launch's error code.
template <typename... Params, typename... Args>
static inline int launch_row_clusters(void (*kernel)(Params...), int C,
                                      int B, int threads, size_t smem,
                                      cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
