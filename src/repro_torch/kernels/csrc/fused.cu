// fused_sample: the whole sampling decision of one row in one kernel —
// Eq. 1 penalties -> temperature -> online masses (m, S_tot, S_hot) ->
// the K best logits -> top-k / nucleus / min-p inside them -> restricted
// Gumbel-max draw on _hash_uniform(FUSED_DRAW_SALT, row_seed, id).
//
// Replaces the Pallas kernel src/repro/kernels/fused_kernel.py:127
// (fused_sample, body _fused_kernel at :49).
//
// Bound: bytes. It must read the row's logits and two count rows (12 B an
// element) and the hot mask; at B = 8, V = 49152 that is 4.77 MB, about
// 1.4 us at 3.35 TB/s. Design: one block per row, a few passes over the
// row (196 KB of f32 logits plus the counts, which stay in the 50 MB L2):
//   1. penalised logit per element; online (m, S_tot, S_hot); histogram
//      of the top byte of its sort key;
//   2. radix select of the K-th largest 64-bit key, one byte a pass, until
//      the selected bin holds exactly the keys still wanted;
//   3. gather the K keys above the threshold, bitonic sort in shared memory;
//   4. the trunc_gumbel_draw epilogue on the K sorted entries.
// The key is the order-preserving bits of the value over the inverted
// vocabulary id, so a descending key order is "value descending, lowest id
// first" — the total order of the TPU kernel's stable merge — under any
// sort network. The penalised logit is recomputed in each pass instead of
// being stored. Columns in [V, Vp) are virtual padding (z = -1e30, zero
// counts, cold), exactly what ref.fused_pad gives the plain version, so K =
// min(k_cap, Vp) and the result equal the plain version's for the same
// block_v. Eight rows use eight SMs: at the main path's batch the kernel is
// launch- and latency-bound, and it is not tuned for that yet.
#include "decision.cuh"

#define FUSED_THREADS 512
#define FUSED_MAX_K 2048
#define FUSED_DRAW_SALT 0x46555345u

struct Row {
  const float* z;
  const int* cp;
  const int* co;
  float rep, pres, freq, temp;
  int V;
};

__device__ __forceinline__ float zs_at(const Row& r, int j) {
  if (j < r.V)
    return penalize(r.z[j], r.cp[j], r.co[j], r.rep, r.pres, r.freq, r.temp);
  return penalize(REPRO_NEG_INF, 0, 0, r.rep, r.pres, r.freq, r.temp);
}

__global__ void __launch_bounds__(FUSED_THREADS)
    fused_sample_kernel(const float* __restrict__ z,
                        const int* __restrict__ cp, const int* __restrict__ co,
                        const float* __restrict__ rep,
                        const float* __restrict__ pres,
                        const float* __restrict__ freq,
                        const float* __restrict__ temp,
                        const int* __restrict__ top_k,
                        const float* __restrict__ top_p,
                        const float* __restrict__ min_p,
                        const float* __restrict__ u_row,
                        const unsigned char* __restrict__ hot,
                        int* __restrict__ tokens,
                        unsigned char* __restrict__ exact,
                        float* __restrict__ alpha, int* __restrict__ kept,
                        int V, int Vp, int K) {
  __shared__ unsigned int hist[256];
  __shared__ uint64_t keys[FUSED_MAX_K];
  __shared__ float w_s[FUSED_MAX_K];
  __shared__ float p_s[FUSED_MAX_K];
  __shared__ float cum_s[FUSED_MAX_K];
  __shared__ float scratch[96];
  __shared__ int iscratch[64];
  __shared__ uint64_t s_prefix, s_mask;
  __shared__ unsigned int s_krem, s_count;
  __shared__ int s_done;

  const int row = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const size_t base = (size_t)row * V;
  const Row r = {z + base, cp + base, co + base, rep[row], pres[row],
                 freq[row], temp[row], V};

  // -- pass 1: masses and the top byte's histogram --------------------------
  for (int i = tid; i < 256; i += nt) hist[i] = 0;
  __syncthreads();
  float m = REPRO_NEG_INF, s_tot = 0.0f, s_hot = 0.0f;
  for (int j = tid; j < Vp; j += nt) {
    const float v = zs_at(r, j);
    mass_add(m, s_tot, s_hot, v, true, j < V && hot[j] != 0);
    atomicAdd(&hist[(unsigned)(sort_key(v, j) >> 56)], 1u);
  }
  block_mass_reduce(m, s_tot, s_hot, scratch);

  // -- pass 2: radix select of the K-th largest key -------------------------
  uint64_t prefix = 0, pmask = 0;
  unsigned int krem = (unsigned int)K;
  for (int shift = 56;; shift -= 8) {
    if (shift < 56) {
      for (int i = tid; i < 256; i += nt) hist[i] = 0;
      __syncthreads();
      for (int j = tid; j < Vp; j += nt) {
        const uint64_t key = sort_key(zs_at(r, j), j);
        if ((key & pmask) == prefix)
          atomicAdd(&hist[(unsigned)((key >> shift) & 0xFF)], 1u);
      }
      __syncthreads();
    }
    if (tid == 0) {
      unsigned int above = 0;
      int sel = 0;
      for (int b = 255; b >= 0; --b) {
        if (above + hist[b] >= krem) {
          sel = b;
          break;
        }
        above += hist[b];
      }
      s_prefix = prefix | ((uint64_t)sel << shift);
      s_mask = pmask | ((uint64_t)0xFF << shift);
      s_krem = krem - above;
      // every key left in the bin is wanted: the threshold is reached
      s_done = (hist[sel] == krem - above) || shift == 0;
    }
    __syncthreads();
    prefix = s_prefix;
    pmask = s_mask;
    krem = s_krem;
    const int done = s_done;
    __syncthreads();
    if (done) break;
  }

  // -- pass 3: gather the K largest keys, bitonic sort descending -----------
  int P2 = 1;
  while (P2 < K) P2 <<= 1;
  if (tid == 0) s_count = 0;
  for (int i = K + tid; i < P2; i += nt) keys[i] = 0;
  __syncthreads();
  for (int j = tid; j < Vp; j += nt) {
    const uint64_t key = sort_key(zs_at(r, j), j);
    if (key >= prefix) {
      const unsigned int pos = atomicAdd(&s_count, 1u);
      if (pos < (unsigned int)K) keys[pos] = key;
    }
  }
  __syncthreads();
  for (int size = 2; size <= P2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < P2; i += nt) {
        const int partner = i ^ stride;
        if (partner > i) {
          const uint64_t a = keys[i], b = keys[partner];
          const bool desc = (i & size) == 0;
          if (desc ? (a < b) : (a > b)) {
            keys[i] = b;
            keys[partner] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  // -- pass 4: truncation-first filter + restricted Gumbel-max draw ---------
  const float v0 = from_ord((uint32_t)(keys[0] >> 32));
  const int tk = top_k[row];
  const float tp = top_p[row], mp = min_p[row];
  const int kk = tk > 0 ? (tk < K ? tk : K) : K;
  float part = 0.0f;
  for (int i = tid; i < K; i += nt) {
    const float w = expf(from_ord((uint32_t)(keys[i] >> 32)) - v0);
    w_s[i] = w;
    part += w * (i < kk ? 1.0f : 0.0f);
  }
  const float subset_total = block_sum(part, scratch);
  const float norm_total = tk > 0 ? subset_total : s_tot;
  const float denom = fmaxf(norm_total, 1e-30f);
  for (int i = tid; i < K; i += nt)
    p_s[i] = w_s[i] * (i < kk ? 1.0f : 0.0f) / denom;
  __syncthreads();
  if (tid == 0) {
    float c = 0.0f;
    for (int i = 0; i < K; ++i) {
      c += p_s[i];
      cum_s[i] = c;
    }
  }
  __syncthreads();
  const float p0 = p_s[0];
  const uint32_t row_seed = (uint32_t)(u_row[row] * 16777216.0f);
  float best = -INFINITY;
  int best_i = 0x7FFFFFFF, nkeep = 0;
  for (int i = tid; i < K; i += nt) {
    const float p = p_s[i];
    const bool keep = i < kk && (cum_s[i] - p) < tp && p >= mp * p0;
    nkeep += keep ? 1 : 0;
    const uint32_t id = 0xFFFFFFFFu - (uint32_t)keys[i];
    const float u = hash_uniform(FUSED_DRAW_SALT, row_seed, id);
    const float g = -logf(-logf(u));
    const float score =
        keep ? from_ord((uint32_t)(keys[i] >> 32)) + g : -INFINITY;
    if (score > best) {
      best = score;
      best_i = i;
    }
  }
  // argmax, first maximum wins
  for (int off = 16; off > 0; off >>= 1) {
    const float b2 = __shfl_xor_sync(0xffffffffu, best, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, best_i, off);
    nkeep += __shfl_xor_sync(0xffffffffu, nkeep, off);
    if (b2 > best || (b2 == best && i2 < best_i)) {
      best = b2;
      best_i = i2;
    }
  }
  if ((tid & 31) == 0) {
    scratch[tid >> 5] = best;
    iscratch[tid >> 5] = best_i;
    iscratch[32 + (tid >> 5)] = nkeep;
  }
  __syncthreads();
  if (tid == 0) {
    best = scratch[0];
    best_i = iscratch[0];
    nkeep = iscratch[32];
    for (int w = 1; w < (nt >> 5); ++w) {
      if (scratch[w] > best || (scratch[w] == best && iscratch[w] < best_i)) {
        best = scratch[w];
        best_i = iscratch[w];
      }
      nkeep += iscratch[32 + w];
    }
    const float mass_at_cap = subset_total / denom;
    const bool explicit_k = tk > 0 && tk <= K;
    const bool nucleus_ok = tp < 1.0f && mass_at_cap >= fminf(tp, 1.0f) - 1e-7f;
    const float p_last = w_s[K - 1] / denom;
    const bool minp_ok = mp > 0.0f && p_last < mp * p0;
    const bool full_mass_ok = mass_at_cap >= 1.0f - 1e-7f;
    const int win = r.temp <= 0.0f ? 0 : best_i;
    int tok = (int)(0xFFFFFFFFu - (uint32_t)keys[win]);
    tokens[row] = tok < V - 1 ? tok : V - 1;
    exact[row] = (explicit_k || nucleus_ok || minp_ok || full_mass_ok) ? 1 : 0;
    alpha[row] = s_hot / fmaxf(s_tot, 1e-30f);
    kept[row] = nkeep;
  }
}

extern "C" int fused_sample(const float* z, const int* cp, const int* co,
                            const float* rep, const float* pres,
                            const float* freq, const float* temp,
                            const int* top_k, const float* top_p,
                            const float* min_p, const float* u_row,
                            const unsigned char* hot, int* tokens,
                            unsigned char* exact, float* alpha, int* kept,
                            int B, int V, int Vp, int K, void* stream) {
  if (K < 1 || K > FUSED_MAX_K || K > Vp || V > Vp) return (int)cudaErrorInvalidValue;
  fused_sample_kernel<<<B, FUSED_THREADS, 0, (cudaStream_t)stream>>>(
      z, cp, co, rep, pres, freq, temp, top_k, top_p, min_p, u_row, hot,
      tokens, exact, alpha, kept, V, Vp, K);
  return (int)cudaGetLastError();
}
