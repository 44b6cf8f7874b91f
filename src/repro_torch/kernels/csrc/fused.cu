// fused_sample: the whole sampling decision of one row in one kernel —
// Eq. 1 penalties -> temperature -> online masses (m, S_tot, S_hot) ->
// the K best logits -> top-k / nucleus / min-p inside them -> restricted
// Gumbel-max draw on _hash_uniform(FUSED_DRAW_SALT, row_seed, id).
//
// Replaces the Pallas kernel src/repro/kernels/fused_kernel.py:127
// (fused_sample, body _fused_kernel at :49).
//
// Bound: bytes. It must read the row's logits and two count rows (12 B an
// element) and the hot mask; at B = 8, V = 49152 that is 4.77 MB, 1.4 us
// at 3.35 TB/s, and at B = 64, V = 151936 116.8 MB, 34.9 us. What held
// the one-block-a-row design back was not the bytes: 8 of 132 SMs at
// B = 8, a radix select that re-read and re-penalised the row from
// global memory on every pass, a histogram keyed on the sign and exponent
// (a few bins, so tens of thousands of shared atomics on a few
// addresses), and a cumulative sum taken by one thread.
//
// Design: a row is split over a thread-block cluster of C CTAs (row_split
// in decision.cuh: C = 16 at B = 8, 128 CTAs), each owning a contiguous
// range of the padded vocabulary [0, Vp):
//   A. one read of the range (16-byte loads of z and both counts where the
//      three rows share their alignment, a scalar head and tail): the
//      penalised value, the CTA's online (m, S_tot, S_hot), and the
//      value's 32-bit order bits in shared memory at its local column, so
//      no later pass touches global memory and the 64-bit key (order bits
//      over the inverted column) is rebuilt from position;
//   B. the range's min(K, n) largest keys: a radix select on the order
//      bits, 8 bits a pass, into warp-private histograms with
//      warp-aggregated increments (__match_any_sync); it stops as soon as
//      the selected bin holds exactly the keys still wanted, else the last
//      pass leaves one value and the lowest columns holding it are taken
//      by an ordered block count; the selected keys are bitonic-sorted;
//   C. after cluster.sync() rank 0 merges the C partial masses in rank
//      order, and the lists merge pairwise in log2(C) levels through
//      distributed shared memory: rank r (a multiple of 2s) keeps the
//      larger of its key i and key L-1-i of rank r+s, the top L of both
//      as a bitonic sequence, then bitonic-merges it, so a level runs on
//      C/2s SMs at once; rank 0 then runs the truncation-first filter and
//      the restricted draw on the K sorted keys, with a block scan for the
//      cumulative mass.
// The bitonic networks exchange through shared memory for strides of 32
// and more and through warp shuffles below.
// A descending key is "value descending, lowest id first", the total
// order of the TPU kernel's stable merge, so any split yields the same K
// keys. Columns in [V, Vp) are virtual padding (z = -1e30, zero counts,
// cold), exactly what ref.fused_pad gives the plain version, so K =
// min(k_cap, Vp) and the result equal the plain version's for the same
// block_v. There are no float atomics: two launches give the same bits.
//
// Two paths, chosen at launch (fused_layout):
//   shared: each CTA's list of L keys, L = K rounded up to a power of two,
//     lives in shared memory and the merges above keep the top L. Dynamic
//     shared memory a CTA: 4 B a column of its range + 16 KB of histograms
//     + 8 L B, at most the card's opt-in limit
//     (cudaDevAttrMaxSharedMemoryPerBlockOptin, 227 KB on the H100), and a
//     cluster must fit on the card; 30 KB at B = 8, V = 49152, K = 256, and
//     L up to 16384 at B = 8, V = 49152 and at B = 64, V = 151936.
//   global: where the list does not fit, each CTA's sorted list of
//     L = min(K, chunk) rounded up to a power of two keys goes to a global
//     workspace of B * C * L keys that the caller owns, and the merges
//     there keep every key: rank r (a multiple of 2s) bitonic-merges its
//     run of s L keys with rank r+s's, which follows it, into one sorted
//     run of 2 s L; rank 0 draws from the row's C L keys. This takes K up
//     to Vp. A CTA keeps at most 32768 columns, so Vp is at most 16 * 32768.
// The epilogue keeps nothing per key: a weight exp(v_i - v_0) is
// recomputed from the key wherever it is needed (the same bits each time),
// so it takes any K.
//
// Degenerate rows. The plain version's buffer starts as K entries (-inf,
// Vp), and its stable sort puts a NaN after -inf and the buffer before the
// tile, so no -inf or NaN column ever enters it: it holds the K best
// values above -inf, then (-inf, Vp) entries. Here such columns take an
// order below FUSED_ORD_LOW (fused_ord), below every value above -inf, and
// such an entry decodes to (-inf, Vp), which clamps to V - 1 like the
// plain version's.
// The draw's argmax is jnp.argmax's: the first NaN, else the first
// maximum, so where nothing is kept (every score -inf) it is entry 0; the
// clamps keep a NaN mass, as torch.clamp does.
#include <mutex>

#include "decision.cuh"

#define FUSED_THREADS 512
#define FUSED_WARPS (FUSED_THREADS / 32)
#define FUSED_MAX_COLS 32768
#define FUSED_MAX_ROWS 65535
#define FUSED_HIST_BYTES (FUSED_WARPS * 256 * 4)
#define FUSED_DRAW_SALT 0x46555345u

// The list's order of a value: ord_bits plus FUSED_ORD_LIFT, mod 2^32.
// ord_bits puts every value above -inf in [0x00800000, 0xFF800000] and
// -inf and the NaNs outside it; the lift moves that range to
// [FUSED_ORD_LOW, 0xFFFFFFFF] in order and wraps -inf and every NaN below
// FUSED_ORD_LOW (the plain version's (-inf, Vp) entries): one add.
#define FUSED_ORD_LIFT 0x007FFFFFu
#define FUSED_ORD_LOW 0x00FFFFFFu

__device__ __forceinline__ uint32_t fused_ord(float v) {
  return ord_bits(v) + FUSED_ORD_LIFT;
}

// Score (b, i) beats (best, best_i) in an argmax where a NaN wins and the
// lowest index wins among equals and among NaNs.
__device__ __forceinline__ bool score_wins(float b, int i, float best,
                                           int best_i) {
  if (b != b) return best == best || i < best_i;
  return best == best && (b > best || (b == best && i < best_i));
}

__device__ __forceinline__ uint64_t key_at(uint32_t ord, int j) {
  return ((uint64_t)ord << 32) | (uint64_t)(0xFFFFFFFFu - (uint32_t)j);
}

// Bitonic networks on L keys (a power of two) in shared memory; the key
// at index i goes descending where (i & size) == 0. A stride of 32 or
// more exchanges through shared memory, one __syncthreads each; strides
// below 32 run in registers, 32 consecutive keys a warp, through shuffles,
// for several stages at once where no larger stride comes between.
__device__ __forceinline__ void bitonic_smem(uint64_t* a, int L, int size,
                                             int stride) {
  for (int q = threadIdx.x; q < (L >> 1); q += FUSED_THREADS) {
    const int i = ((q & ~(stride - 1)) << 1) | (q & (stride - 1));
    const uint64_t x = a[i], y = a[i + stride];
    if ((i & size) == 0 ? x < y : x > y) {
      a[i] = y;
      a[i + stride] = x;
    }
  }
  __syncthreads();
}

// The strides below 32 of stages size_lo .. size_hi.
__device__ __forceinline__ void bitonic_warp(uint64_t* a, int L, int size_lo,
                                             int size_hi) {
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x & ~31; b < L; b += FUSED_THREADS) {
    const int i = b + lane;
    uint64_t x = i < L ? a[i] : 0;
    for (int size = size_lo; size <= size_hi; size <<= 1) {
      for (int stride = min(size >> 1, 16); stride > 0; stride >>= 1) {
        const uint64_t y = __shfl_xor_sync(REPRO_FULL_MASK, x, stride);
        const bool keep_max = ((i & stride) == 0) == ((i & size) == 0);
        x = keep_max ? (x > y ? x : y) : (x < y ? x : y);
      }
    }
    if (i < L) a[i] = x;
  }
  __syncthreads();
}

// Sort a[0, L) descending.
__device__ __forceinline__ void bitonic_sort(uint64_t* a, int L) {
  bitonic_warp(a, L, 2, min(L, 32));
  for (int size = 64; size <= L; size <<= 1) {
    for (int stride = size >> 1; stride >= 32; stride >>= 1)
      bitonic_smem(a, L, size, stride);
    bitonic_warp(a, L, size, size);
  }
}

// a[0, L) is a bitonic sequence: sort it descending (size L: every key
// descends).
__device__ __forceinline__ void bitonic_merge(uint64_t* a, int L) {
  for (int stride = L >> 1; stride >= 32; stride >>= 1)
    bitonic_smem(a, L, L, stride);
  bitonic_warp(a, L, L, L);
}

// Three CTAs an SM (at most 40 registers a thread): at B = 64 the card
// then holds 21 clusters of 16 at once instead of 14.
__global__ void __launch_bounds__(FUSED_THREADS, 3)
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
                        uint64_t* __restrict__ gws, int V, int Vp, int K,
                        int chunk, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* key32 = reinterpret_cast<uint32_t*>(smem);
  // chunk is a multiple of 16, so every region is 16-byte aligned
  uint32_t* hist = reinterpret_cast<uint32_t*>(key32 + chunk);
  // this CTA's list: in shared memory, or its run of the row's workspace
  uint64_t* list = gws == nullptr
                       ? reinterpret_cast<uint64_t*>(hist + FUSED_WARPS * 256)
                       : gws + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                                   (size_t)L;
  __shared__ float scratch[96];
  __shared__ int iscratch[64];
  __shared__ float state[4], fin[2];
  __shared__ uint32_t s_sel[3];
  __shared__ unsigned int s_count;

  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), C = (int)cl.num_blocks();
  const int row = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int c0 = min(rank * chunk, Vp), c1 = min(c0 + chunk, Vp);
  const int n = c1 - c0;
  const size_t base = (size_t)row * V;
  const float* zr = z + base;
  const int* cpr = cp + base;
  const int* cor = co + base;
  const float rp = rep[row], pr = pres[row], fr = freq[row], tm = temp[row];

  // -- A: one read of the range ---------------------------------------------
  float m = REPRO_NEG_INF, s_tot = 0.0f, s_hot = 0.0f;
  const int r1 = max(c0, min(c1, V));      // real [c0, r1), virtual [r1, c1)
  const bool together = ((((uintptr_t)zr ^ (uintptr_t)cpr) |
                          ((uintptr_t)zr ^ (uintptr_t)cor)) & 15) == 0;
  const int head = together ? head_to_16(zr + c0, r1 - c0) : r1 - c0;
  const int nvec = (r1 - c0 - head) >> 2;
  const int v0 = c0 + head, v1 = v0 + 4 * nvec;
  for (int j = c0 + tid; j < v0; j += FUSED_THREADS) {
    const float v = penalize(zr[j], cpr[j], cor[j], rp, pr, fr, tm);
    key32[j - c0] = fused_ord(v);
    mass_add(m, s_tot, s_hot, v, true, hot[j] != 0);
  }
  for (int j = v1 + tid; j < r1; j += FUSED_THREADS) {
    const float v = penalize(zr[j], cpr[j], cor[j], rp, pr, fr, tm);
    key32[j - c0] = fused_ord(v);
    mass_add(m, s_tot, s_hot, v, true, hot[j] != 0);
  }
  {
    const float4* zv = reinterpret_cast<const float4*>(zr + v0);
    const int4* pv = reinterpret_cast<const int4*>(cpr + v0);
    const int4* ov = reinterpret_cast<const int4*>(cor + v0);
#pragma unroll 4
    for (int i = tid; i < nvec; i += FUSED_THREADS) {
      const float4 q = __ldg(zv + i);
      const int4 a = __ldg(pv + i), b = __ldg(ov + i);
      const float v[4] = {penalize(q.x, a.x, b.x, rp, pr, fr, tm),
                          penalize(q.y, a.y, b.y, rp, pr, fr, tm),
                          penalize(q.z, a.z, b.z, rp, pr, fr, tm),
                          penalize(q.w, a.w, b.w, rp, pr, fr, tm)};
      const int j = v0 + 4 * i;
#pragma unroll
      for (int k = 0; k < 4; ++k) key32[j - c0 + k] = fused_ord(v[k]);
      mass_add4(m, s_tot, s_hot, v, 0xFu, hot_bits4(hot, j));
    }
  }
  if (r1 < c1) {
    const float pad = penalize(REPRO_NEG_INF, 0, 0, rp, pr, fr, tm);
    const uint32_t pad_ord = fused_ord(pad);
    for (int j = r1 + tid; j < c1; j += FUSED_THREADS) {
      key32[j - c0] = pad_ord;
      mass_add(m, s_tot, s_hot, pad, true, false);
    }
  }
  block_mass_reduce(m, s_tot, s_hot, scratch);     // ends in __syncthreads
  if (tid == 0) {
    state[0] = m;
    state[1] = s_tot;
    state[2] = s_hot;
    state[3] = 0.0f;
  }

  // -- B: the range's min(K, n) largest keys --------------------------------
  const int Kl = min(K, n);
  uint32_t thr = 0;       // take order bits >= thr (or > thr when strict)
  bool strict = false;
  unsigned int need = 0;  // strict: keys equal to thr still wanted
  if (Kl < n) {
    uint32_t prefix = 0, pmask = 0;
    unsigned int krem = (unsigned int)Kl;
    for (int shift = 24;; shift -= 8) {
      for (int i = tid; i < FUSED_WARPS * 256; i += FUSED_THREADS)
        hist[i] = 0;
      __syncthreads();
      uint32_t* wh = hist + warp * 256;
      for (int b = 0; b < n; b += FUSED_THREADS) {
        const int i = b + tid;
        const uint32_t k = i < n ? key32[i] : 0u;
        const bool act = i < n && (k & pmask) == prefix;
        const unsigned am = __ballot_sync(REPRO_FULL_MASK, act);
        if (act) {
          const uint32_t d = (k >> shift) & 0xFFu;
          const unsigned peers = __match_any_sync(am, d);
          if (lane == __ffs(peers) - 1)
            atomicAdd(wh + d, (unsigned int)__popc(peers));
        }
      }
      __syncthreads();
      if (tid < 256) {
        unsigned int t = 0;
        for (int w = 0; w < FUSED_WARPS; ++w) t += hist[w * 256 + tid];
        hist[tid] = t;
      }
      __syncthreads();
      if (warp == 0) {
        // lane l holds bins 255 - 8l down to 248 - 8l
        unsigned int c[8], s = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          c[q] = hist[255 - 8 * lane - q];
          s += c[q];
        }
        unsigned int inc = s;
        for (int off = 1; off < 32; off <<= 1) {
          const unsigned int t = __shfl_up_sync(REPRO_FULL_MASK, inc, off);
          if (lane >= off) inc += t;
        }
        const unsigned int excl = inc - s;
        const unsigned hit =
            __ballot_sync(REPRO_FULL_MASK, excl < krem && inc >= krem);
        if (lane == __ffs(hit) - 1) {
          unsigned int above = excl, cnt = 0;
          int q_sel = 0;
          bool found = false;
#pragma unroll
          for (int q = 0; q < 8; ++q) {      // the first bin from the top
            if (!found) {
              if (above + c[q] >= krem) {
                found = true;
                q_sel = q;
                cnt = c[q];
              } else {
                above += c[q];
              }
            }
          }
          const uint32_t sel = (uint32_t)(255 - 8 * lane - q_sel);
          s_sel[0] = prefix | (sel << shift);
          s_sel[1] = krem - above;
          s_sel[2] = cnt == krem - above;   // every key of the bin wanted
        }
      }
      __syncthreads();
      prefix = s_sel[0];
      krem = s_sel[1];
      const bool whole_bin = s_sel[2] != 0;
      pmask |= 0xFFu << shift;
      if (whole_bin || shift == 0) {
        thr = prefix;
        strict = !whole_bin;
        need = krem;
        break;
      }
    }
  }
  for (int i = tid; i < L; i += FUSED_THREADS) list[i] = 0;
  if (tid == 0) s_count = 0;
  __syncthreads();
  for (int b = 0; b < n; b += FUSED_THREADS) {
    const int i = b + tid;
    const uint32_t k = i < n ? key32[i] : 0u;
    const bool take = i < n && (strict ? k > thr : k >= thr);
    const unsigned bm = __ballot_sync(REPRO_FULL_MASK, take);
    if (bm) {
      unsigned int pos = 0;
      if (lane == 0) pos = atomicAdd(&s_count, (unsigned int)__popc(bm));
      pos = __shfl_sync(REPRO_FULL_MASK, pos, 0);
      if (take) list[pos + __popc(bm & lanes_below)] = key_at(k, c0 + i);
    }
  }
  if (strict) {
    // the lowest columns holding the threshold value, in column order
    __syncthreads();
    const unsigned int above = s_count;
    unsigned int seen = 0;
    for (int b = 0; b < n && seen < need; b += FUSED_THREADS) {
      const int i = b + tid;
      const bool eq = i < n && key32[i] == thr;
      const unsigned bm = __ballot_sync(REPRO_FULL_MASK, eq);
      if (lane == 0) iscratch[warp] = __popc(bm);
      __syncthreads();
      unsigned int before = 0, total = 0;
      for (int w = 0; w < FUSED_WARPS; ++w) {
        const unsigned int c = (unsigned int)iscratch[w];
        before += w < warp ? c : 0u;
        total += c;
      }
      const unsigned int rk = seen + before + __popc(bm & lanes_below);
      if (eq && rk < need) list[above + rk] = key_at(thr, c0 + i);
      seen += total;
      __syncthreads();
    }
  }
  __syncthreads();
  // keys past the first Kl are zero, below every real key: sorting the
  // first power of two >= Kl sorts the list
  int filled = 1;
  while (filled < Kl) filled <<= 1;
  bitonic_sort(list, min(L, filled));

  // -- C: the cluster merges its lists; rank 0 draws -------------------------
  if (gws != nullptr) __threadfence();
  cl.sync();                      // every list sorted, every state written
  if (rank == 0 && warp == 0) {
    float unused;
    cluster_mass_merge(cl, state, C, m, s_tot, s_hot, unused);
    if (lane == 0) {
      fin[0] = s_tot;
      fin[1] = s_hot;
    }
  }
  // level s: each rank r that is a multiple of 2s merges rank r+s's list
  // into its own. Shared path: it keeps the larger of its key i and key
  // L-1-i of rank r+s (through distributed shared memory), the top L of
  // both as a bitonic sequence, merged descending; a rank's list is read
  // once, after which it is left alone until the cluster exits. Global
  // path: the two runs of s L keys lie end to end in the workspace; the
  // same exchange between key i and key 2sL-1-i leaves two bitonic halves,
  // every key of the first above every key of the second, and each half is
  // merged descending, so the run of 2sL keeps every key. The levels run
  // on C/2, C/4, ... SMs at once.
  for (int s = 1; s < C; s <<= 1) {
    if ((rank & (2 * s - 1)) == 0) {
      if (gws == nullptr) {
        const uint64_t* other = cl.map_shared_rank(list, rank + s);
        for (int i = tid; i < L; i += FUSED_THREADS) {
          const uint64_t b = other[L - 1 - i];
          if (b > list[i]) list[i] = b;
        }
        __syncthreads();
        bitonic_merge(list, L);
      } else {
        const int N = 2 * s * L;
        for (int i = tid; i < N / 2; i += FUSED_THREADS) {
          const uint64_t a = list[i], b = list[N - 1 - i];
          if (b > a) {
            list[i] = b;
            list[N - 1 - i] = a;
          }
        }
        __syncthreads();
        for (int stride = N >> 2; stride >= 32; stride >>= 1)
          bitonic_smem(list, N, N, stride);
        bitonic_warp(list, N, N, N);
        __threadfence();
      }
    }
    cl.sync();
  }
  if (rank != 0) return;
  __syncthreads();
  s_tot = fin[0];
  s_hot = fin[1];
  const uint64_t* keys = list;     // the row's K largest keys, descending
  // entry i's value and column; an order below FUSED_ORD_LOW is the plain
  // version's (-inf, Vp)
  auto val = [&](int i) {
    const uint32_t o = (uint32_t)(keys[i] >> 32);
    return o < FUSED_ORD_LOW ? -INFINITY : from_ord(o - FUSED_ORD_LIFT);
  };
  auto col = [&](int i) {
    return (uint32_t)(keys[i] >> 32) < FUSED_ORD_LOW
               ? (uint32_t)Vp
               : 0xFFFFFFFFu - (uint32_t)keys[i];
  };

  // truncation-first filter + restricted Gumbel-max draw
  const float v0k = val(0);
  const int tk = top_k[row];
  const float tp = top_p[row], mp = min_p[row];
  const int kk = tk > 0 ? (tk < K ? tk : K) : K;
  auto weight = [&](int i) { return expf(val(i) - v0k); };
  float part = 0.0f;
  for (int i = tid; i < K; i += FUSED_THREADS)
    part += weight(i) * (i < kk ? 1.0f : 0.0f);
  const float subset_total = block_sum(part, scratch);
  const float norm_total = tk > 0 ? subset_total : s_tot;
  const float denom = clamp_lo(norm_total, 1e-30f);
  auto prob = [&](int i) {
    return weight(i) * (i < kk ? 1.0f : 0.0f) / denom;
  };
  // the cumulative mass: a run of `per` entries a thread, then an
  // exclusive scan of the runs across the block, in a fixed order; each
  // thread then walks its run again, filtering and drawing
  const int per = (K + FUSED_THREADS - 1) / FUSED_THREADS;
  const int i0 = min(tid * per, K), i1 = min(i0 + per, K);
  float c;
  {
    float run = 0.0f;
    for (int i = i0; i < i1; ++i) run += prob(i);
    float inc = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(REPRO_FULL_MASK, inc, off);
      if (lane >= off) inc += t;
    }
    c = __shfl_up_sync(REPRO_FULL_MASK, inc, 1);
    if (lane == 0) c = 0.0f;
    if (lane == 31) scratch[warp] = inc;
    __syncthreads();
    float before = 0.0f;
    for (int w = 0; w < warp; ++w) before += scratch[w];
    c = before + c;
    __syncthreads();
  }
  const float p0 = prob(0);
  const uint32_t row_seed = (uint32_t)(u_row[row] * 16777216.0f);
  // a run's entries come in index order, so the first maximum (or NaN)
  // stays; a run of -inf scores keeps its first entry, and an empty run
  // holds index K, behind every entry
  float best = -INFINITY;
  int best_i = i0, nkeep = 0;
  for (int i = i0; i < i1; ++i) {
    const float p = prob(i);
    c += p;
    const bool keep = i < kk && (c - p) < tp && p >= mp * p0;
    nkeep += keep ? 1 : 0;
    const float u = hash_uniform(FUSED_DRAW_SALT, row_seed, col(i));
    const float g = -logf(-logf(u));
    const float score = keep ? val(i) + g : -INFINITY;
    if (score > best || (score != score && best == best)) {
      best = score;
      best_i = i;
    }
  }
  // argmax: the first NaN, else the first maximum wins
  for (int off = 16; off > 0; off >>= 1) {
    const float b2 = __shfl_xor_sync(REPRO_FULL_MASK, best, off);
    const int i2 = __shfl_xor_sync(REPRO_FULL_MASK, best_i, off);
    nkeep += __shfl_xor_sync(REPRO_FULL_MASK, nkeep, off);
    if (score_wins(b2, i2, best, best_i)) {
      best = b2;
      best_i = i2;
    }
  }
  if (lane == 0) {
    scratch[warp] = best;
    iscratch[warp] = best_i;
    iscratch[32 + warp] = nkeep;
  }
  __syncthreads();
  if (tid == 0) {
    best = scratch[0];
    best_i = iscratch[0];
    nkeep = iscratch[32];
    for (int w = 1; w < FUSED_WARPS; ++w) {
      if (score_wins(scratch[w], iscratch[w], best, best_i)) {
        best = scratch[w];
        best_i = iscratch[w];
      }
      nkeep += iscratch[32 + w];
    }
    const float mass_at_cap = subset_total / denom;
    const bool explicit_k = tk > 0 && tk <= K;
    const bool nucleus_ok =
        tp < 1.0f && mass_at_cap >= clamp_hi(tp, 1.0f) - 1e-7f;
    const float p_last = weight(K - 1) / denom;
    const bool minp_ok = mp > 0.0f && p_last < mp * p0;
    const bool full_mass_ok = mass_at_cap >= 1.0f - 1e-7f;
    // where nothing is kept every score is -inf, and the lowest index
    // wins the tie: entry 0
    const int win = tm <= 0.0f ? 0 : best_i;
    const int tok = (int)col(win);
    tokens[row] = tok < V - 1 ? tok : V - 1;
    exact[row] = (explicit_k || nucleus_ok || minp_ok || full_mass_ok) ? 1 : 0;
    alpha[row] = s_hot / clamp_lo(s_tot, 1e-30f);
    kept[row] = nkeep;
  }
}

struct FusedLayout {
  int C, chunk, L, smem, global, clusters;
};

// The most dynamic shared memory a CTA of the kernel can have: the card's
// opt-in limit less the kernel's static shared memory; -1 where a query
// fails.
static int fused_max_dynamic_smem() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, fused_sample_kernel) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return optin - (int)attr.sharedSizeBytes;
}

// Clusters of C CTAs with `smem` dynamic shared bytes each that the
// current card holds at once (cudaOccupancyMaxActiveClusters), 0 where
// the query fails. Leaves the kernel's dynamic shared memory limit at
// `max_smem`, so any launch up to it is taken.
static int fused_clusters(int C, int smem, int max_smem) {
  if (cudaFuncSetAttribute(fused_sample_kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess ||
      cudaFuncSetAttribute(fused_sample_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           max_smem) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(FUSED_THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int got = 0;
  if (cudaOccupancyMaxActiveClusters(&got, fused_sample_kernel, &cfg) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return got;
}

// The launch for (B, Vp, K) on the current card; false if the kernel does
// not take it. The shared path where its list fits in the card's opt-in
// shared memory and a cluster of it fits on the card, else (or where
// `force_global` asks for it) the global one.
static bool fused_layout_uncached(int B, int Vp, int K, int force_global,
                                  FusedLayout* f) {
  if (B < 1 || B > FUSED_MAX_ROWS || K < 1 || K > Vp) return false;
  const int min_c = pow2_at_least((Vp + FUSED_MAX_COLS - 1) / FUSED_MAX_COLS);
  if (min_c > REPRO_MAX_CLUSTER) return false;
  const int optin = fused_max_dynamic_smem();
  if (optin < 0) return false;
  const RowSplit s = row_split(B, Vp, min_c);
  f->C = s.C;
  f->chunk = s.chunk;
  const long long base = (long long)s.chunk * 4 + FUSED_HIST_BYTES;
  const long long shared = base + 8LL * pow2_at_least(K);
  if (!force_global && shared <= optin) {
    f->clusters = fused_clusters(s.C, (int)shared, optin);
    if (f->clusters > 0) {
      f->L = pow2_at_least(K);
      f->smem = (int)shared;
      f->global = 0;
      return true;
    }
  }
  if (base > optin) return false;
  f->L = pow2_at_least(K < s.chunk ? K : s.chunk);
  f->smem = (int)base;
  f->global = 1;
  f->clusters = fused_clusters(s.C, f->smem, optin);
  return f->clusters > 0;
}

// fused_layout_uncached, remembered for the last few (device, B, Vp, K):
// the occupancy query costs more than a launch.
static bool fused_layout(int B, int Vp, int K, int force_global,
                         FusedLayout* f) {
  struct Entry {
    int dev, B, Vp, K, force_global;
    bool ok;
    FusedLayout f;
  };
  static std::mutex mu;
  static Entry cache[16];
  static int used = 0, next = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.dev == dev && e.B == B && e.Vp == Vp && e.K == K &&
        e.force_global == force_global) {
      *f = e.f;
      return e.ok;
    }
  }
  Entry e = {dev, B, Vp, K, force_global,
             fused_layout_uncached(B, Vp, K, force_global, f), *f};
  cache[next] = e;
  next = (next + 1) % 16;
  used = used < 16 ? used + 1 : 16;
  return e.ok;
}

// (C, chunk, L, dynamic shared bytes, threads, path: 0 shared / 1 global,
// clusters the card holds at once) of the launch, or -1s. The global path
// needs a workspace of B * C * L keys (8 bytes each).
extern "C" void fused_sample_split(int B, int Vp, int K, int force_global,
                                   int* out) {
  FusedLayout f;
  const bool ok = fused_layout(B, Vp, K, force_global, &f);
  out[0] = ok ? f.C : -1;
  out[1] = ok ? f.chunk : -1;
  out[2] = ok ? f.L : -1;
  out[3] = ok ? f.smem : -1;
  out[4] = FUSED_THREADS;
  out[5] = ok ? f.global : -1;
  out[6] = ok ? f.clusters : -1;
}

// `ws`: the global path's workspace of B * C * L keys (see
// fused_sample_split); ignored on the shared path. `force_global` takes
// the global path where the shared one would fit (to hold the two against
// each other).
extern "C" int fused_sample(const float* z, const int* cp, const int* co,
                            const float* rep, const float* pres,
                            const float* freq, const float* temp,
                            const int* top_k, const float* top_p,
                            const float* min_p, const float* u_row,
                            const unsigned char* hot, int* tokens,
                            unsigned char* exact, float* alpha, int* kept,
                            int B, int V, int Vp, int K, int force_global,
                            void* ws, void* stream) {
  FusedLayout f;
  if (V < 1 || V > Vp || !fused_layout(B, Vp, K, force_global, &f))
    return (int)cudaErrorInvalidValue;
  if (f.global && ws == nullptr) return (int)cudaErrorInvalidValue;
  return launch_row_clusters(
      fused_sample_kernel, f.C, B, FUSED_THREADS, (size_t)f.smem,
      (cudaStream_t)stream, z, cp, co, rep, pres, freq, temp, top_k, top_p,
      min_p, u_row, hot, tokens, exact, alpha, kept,
      f.global ? (uint64_t*)ws : (uint64_t*)nullptr, V, Vp, K, f.chunk, f.L);
}
