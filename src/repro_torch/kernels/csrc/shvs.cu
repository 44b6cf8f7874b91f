// shvs_masses: the SHVS streaming pass (paper Eq. 6-7). Per row, in one
// read of z: m = max z, S_hot = sum_H exp(z - m), S_tail = sum_notH
// exp(z - m) and tail_max = max_notH z.
//
// Replaces the Pallas kernel src/repro/kernels/shvs_kernel.py:67
// (shvs_masses, body _shvs_kernel at :29).
//
// Bound: bytes. It reads 4 B of z per element and the (V,) hot mask once
// (1 B per entry); at B = 8, V = 49152 that is 1.62 MB, about 0.5 us at
// 3.35 TB/s. Design: one block per row; each thread folds a strided slice
// into an online (m, S_hot, S_tail) with the rescaling trick of the TPU
// kernel, and a block reduction merges the partial states. The TPU walked
// the vocabulary in order; here sums are taken in another order, so they
// agree with the plain version to rounding while m and tail_max are exact.
// With B = 8 only 8 of 132 SMs work: the pass is launch- and
// latency-bound at the main path's batch and is not tuned for it yet.
#include "decision.cuh"

#define SHVS_THREADS 512

__global__ void __launch_bounds__(SHVS_THREADS)
    shvs_masses_kernel(const float* __restrict__ z,
                       const unsigned char* __restrict__ hot,
                       float* __restrict__ m_out, float* __restrict__ hot_out,
                       float* __restrict__ tail_out,
                       float* __restrict__ tmax_out, int V) {
  __shared__ float scratch[96];
  const int row = blockIdx.x;
  const float* zr = z + (size_t)row * V;
  float m = REPRO_NEG_INF, s_hot = 0.0f, s_tail = 0.0f;
  float tmax = REPRO_NEG_INF;
  for (int j = threadIdx.x; j < V; j += blockDim.x) {
    const float v = zr[j];
    const bool h = hot[j] != 0;
    mass_add(m, s_hot, s_tail, v, h, !h);
    if (!h) tmax = fmaxf(tmax, v);
  }
  block_mass_reduce(m, s_hot, s_tail, scratch);
  for (int off = 16; off > 0; off >>= 1)
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = tmax;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      tmax = fmaxf(tmax, scratch[w]);
    m_out[row] = m;
    hot_out[row] = s_hot;
    tail_out[row] = s_tail;
    tmax_out[row] = fmaxf(tmax, scratch[0]);
  }
}

extern "C" int shvs_masses(const float* z, const unsigned char* hot,
                           float* m, float* s_hot, float* s_tail,
                           float* tail_max, int B, int V, void* stream) {
  shvs_masses_kernel<<<B, SHVS_THREADS, 0, (cudaStream_t)stream>>>(
      z, hot, m, s_hot, s_tail, tail_max, V);
  return (int)cudaGetLastError();
}
