// shvs_masses: the SHVS streaming pass (paper Eq. 6-7). Per row, in one
// read of z: m = max z, S_hot = sum_H exp(z - m), S_tail = sum_notH
// exp(z - m) and tail_max = max_notH z.
//
// Replaces the Pallas kernel src/repro/kernels/shvs_kernel.py:67
// (shvs_masses, body _shvs_kernel at :29).
//
// Bound: bytes. It reads 4 B of z per element and the (V,) hot mask once
// (1 B per entry); at B = 8, V = 49152 that is 1.62 MB, 0.48 us at
// 3.35 TB/s, and at B = 64, V = 151936 39.05 MB, 11.7 us. The accurate
// expf (one or two an element) is the other cost: on a few SMs the pass is
// bound by their latency, not by the bytes.
//
// Design: a row is split over a thread-block cluster of C CTAs
// (row_split in decision.cuh: C = 16 at B = 8, so 128 CTAs cover the 132
// SMs; 16 at B = 64 too), each owning a contiguous range of at least 2048
// columns. A CTA streams its range with 16-byte loads (a float4 of z and
// the four hot bytes of its columns, with a scalar head and tail where
// the row is not 16-byte aligned: V = 50021 is odd, so row r starts at
// byte 4 r V), folds four values at a time into an online (m, S_hot,
// S_tail) with one rescale at most (mass_add4), and reduces its threads
// with block_mass_reduce. After cluster.sync() warp 0 of rank 0 reads the
// C states through distributed shared memory and merges them in rank
// order: one launch, no global workspace, and no float atomics, so two
// runs give the same bits. The sums are taken in another order than the
// plain version's, so S_hot and S_tail agree with it to rounding; m and
// tail_max are maxima and equal it exactly.
//
// Degenerate rows follow the plain version too. Its m = max z and
// tail_max = max over the row with hot columns read as -1e30 keep a NaN
// and start from -inf, and where m is not finite (a NaN, +inf, or every
// z = -inf) some exp(z - m) is NaN, which poisons both sums. So the
// kernel carries the row's max mx beside the online state; a thread takes
// its maxima with fmaxf (which skips a NaN) and a flag for a NaN (and for
// a NaN in a cold column), turned into a NaN maximum before the
// NaN-keeping reductions; the sums are written as NaN where mx is not
// finite. The online m, which skips a NaN, equals mx wherever mx is
// finite (and above -1e30).
#include "decision.cuh"

#define SHVS_THREADS 256
#define SHVS_MAX_ROWS 65535

__global__ void __launch_bounds__(SHVS_THREADS)
    shvs_masses_kernel(const float* __restrict__ z,
                       const unsigned char* __restrict__ hot,
                       float* __restrict__ m_out, float* __restrict__ hot_out,
                       float* __restrict__ tail_out,
                       float* __restrict__ tmax_out, int V, int chunk) {
  __shared__ float scratch[96];
  __shared__ float state[5];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), C = (int)cl.num_blocks();
  const int row = blockIdx.y, tid = threadIdx.x;
  const int c0 = min(rank * chunk, V), c1 = min(c0 + chunk, V);
  const float* zr = z + (size_t)row * V;

  float m = REPRO_NEG_INF, s_hot = 0.0f, s_tail = 0.0f;
  float tmax = -INFINITY, mx = -INFINITY;
  bool nan_any = false, nan_cold = false;
  const int head = head_to_16(zr + c0, c1 - c0);
  const int nvec = (c1 - c0 - head) >> 2;
  const int v0 = c0 + head, v1 = v0 + 4 * nvec;
  // the scalar head [c0, v0) and tail [v1, c1), three columns at most each
  if (tid < 8) {
    const int j = tid < 4 ? c0 + tid : v1 + tid - 4;
    if (j < (tid < 4 ? v0 : c1)) {
      const float v = zr[j];
      const bool h = hot[j] != 0;
      mass_add(m, s_hot, s_tail, v, h, !h);
      tmax = fmaxf(tmax, h ? REPRO_NEG_INF : v);
      mx = fmaxf(mx, v);
      nan_any |= v != v;
      nan_cold |= v != v && !h;
    }
  }
  const float4* zv = reinterpret_cast<const float4*>(zr + v0);
#pragma unroll 4
  for (int i = tid; i < nvec; i += SHVS_THREADS) {
    const float4 q = __ldg(zv + i);
    const float v[4] = {q.x, q.y, q.z, q.w};
    const unsigned h = hot_bits4(hot, v0 + 4 * i);
    mass_add4(m, s_hot, s_tail, v, h, ~h & 0xFu);
    mx = fmaxf(mx, fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!((h >> k) & 1u)) tmax = fmaxf(tmax, v[k]);
      nan_any |= v[k] != v[k];
      nan_cold |= v[k] != v[k] && !((h >> k) & 1u);
    }
    if (h) tmax = fmaxf(tmax, REPRO_NEG_INF);
  }
  if (nan_any) mx = NAN;
  if (nan_cold) tmax = NAN;
  block_mass_reduce(m, s_hot, s_tail, scratch);
  for (int off = 16; off > 0; off >>= 1) {
    tmax = nan_max(tmax, __shfl_xor_sync(REPRO_FULL_MASK, tmax, off));
    mx = nan_max(mx, __shfl_xor_sync(REPRO_FULL_MASK, mx, off));
  }
  if ((tid & 31) == 0) {
    scratch[tid >> 5] = tmax;
    scratch[32 + (tid >> 5)] = mx;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < SHVS_THREADS / 32; ++w) {
      tmax = nan_max(tmax, scratch[w]);
      mx = nan_max(mx, scratch[32 + w]);
    }
    state[0] = m;
    state[1] = s_hot;
    state[2] = s_tail;
    state[3] = tmax;
    state[4] = mx;
  }
  cl.sync();
  if (rank == 0 && tid < 32) {
    cluster_mass_merge(cl, state, C, m, s_hot, s_tail, tmax, &mx);
    if (tid == 0) {
      const bool finite = isfinite(mx);
      m_out[row] = mx;
      hot_out[row] = finite ? s_hot : NAN;
      tail_out[row] = finite ? s_tail : NAN;
      tmax_out[row] = tmax;
    }
  }
  // no CTA leaves while rank 0 may still read its shared memory
  cl.sync();
}

// (C, chunk, threads) of the launch for (B, V).
extern "C" void shvs_masses_split(int B, int V, int* out) {
  const RowSplit s = row_split(B, V, 1);
  out[0] = s.C;
  out[1] = s.chunk;
  out[2] = SHVS_THREADS;
}

extern "C" int shvs_masses(const float* z, const unsigned char* hot,
                           float* m, float* s_hot, float* s_tail,
                           float* tail_max, int B, int V, void* stream) {
  if (B < 1 || B > SHVS_MAX_ROWS || V < 1) return (int)cudaErrorInvalidValue;
  const RowSplit s = row_split(B, V, 1);
  return launch_row_clusters(shvs_masses_kernel, s.C, B, SHVS_THREADS, 0,
                             (cudaStream_t)stream, z, hot, m, s_hot, s_tail,
                             tail_max, V, s.chunk);
}
