// Shared device code of the decision-plane kernels (penalty.cu, shvs.cu,
// fused.cu, gumbel.cu). Built with -fmad=false and without fast-math: every product
// and sum rounds on its own, exactly as the separate elementwise ops of the
// plain PyTorch versions do, and expf/logf are the accurate libdevice ones.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_NEG_INF (-1e30f)

// Order-preserving map of float bits; -0 and +0 tie, as in a stable sort.
__device__ __forceinline__ uint32_t ord_bits(float v) {
  const uint32_t b = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_ord(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

// Packed key: value order in the high word, the inverted column in the low
// word, so the largest key is "largest value, lowest column first".
__device__ __forceinline__ uint64_t sort_key(float v, int j) {
  return ((uint64_t)ord_bits(v) << 32) | (uint64_t)(0xFFFFFFFFu - (uint32_t)j);
}

// ref._hash_uniform(seed, b, v), bit for bit. The result lies in (0, 1]:
// the top 128 hash values round to 2^32 in the uint32 -> f32 conversion,
// so u == 1.0 there, as in the reference.
__device__ __forceinline__ float hash_uniform(uint32_t seed, uint32_t b,
                                              uint32_t v) {
  uint32_t x = (b * 2654435761u) ^ (v * 40503u) ^ seed;
  x ^= x >> 16;
  x *= 2246822519u;
  x ^= x >> 13;
  x *= 3266489917u;
  x ^= x >> 16;
  return ((float)x + 0.5f) * (1.0f / 4294967296.0f);
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
  return z / fmaxf(temp, 1e-6f);
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
