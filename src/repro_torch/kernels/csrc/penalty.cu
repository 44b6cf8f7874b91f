// penalty_scale: Eq. 1 repetition/presence/frequency penalties, then the
// temperature scale, in one elementwise pass over the (B, V) logits.
//
// Replaces the Pallas kernel src/repro/kernels/penalty_kernel.py:55
// (penalty_scale, body _penalty_kernel at :22).
//
// Bound: bytes. Each element reads 12 B (f32 logit, two i32 counts) and
// writes 4 B; at B = 8, V = 49152 that is 6.29 MB, 1.9 us at 3.35 TB/s.
// Design: one thread per element, a row per blockIdx.y so the row's four
// parameters are loaded once, coalesced loads and stores. At the main
// path's batch the launch itself dominates; nothing is tuned for that yet.
#include "decision.cuh"

__global__ void penalty_scale_kernel(const float* __restrict__ z,
                                     const int* __restrict__ cp,
                                     const int* __restrict__ co,
                                     const float* __restrict__ rep,
                                     const float* __restrict__ pres,
                                     const float* __restrict__ freq,
                                     const float* __restrict__ temp,
                                     float* __restrict__ out, int V) {
  const int row = blockIdx.y;
  const float r = rep[row], p = pres[row], f = freq[row], t = temp[row];
  const size_t base = (size_t)row * V;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < V;
       j += gridDim.x * blockDim.x)
    out[base + j] = penalize(z[base + j], cp[base + j], co[base + j], r, p,
                             f, t);
}

extern "C" int penalty_scale(const float* z, const int* cp, const int* co,
                             const float* rep, const float* pres,
                             const float* freq, const float* temp, float* out,
                             int B, int V, void* stream) {
  const int threads = 256;
  int blocks = (V + threads - 1) / threads;
  if (blocks > 1024) blocks = 1024;
  penalty_scale_kernel<<<dim3(blocks, B), threads, 0,
                         (cudaStream_t)stream>>>(z, cp, co, rep, pres, freq,
                                                 temp, out, V);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
