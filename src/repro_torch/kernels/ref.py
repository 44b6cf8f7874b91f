"""Plain PyTorch versions of the decision-plane kernels.

They define what the CUDA kernels compute, run on the CPU (and are what
a CPU tensor gets from :mod:`repro_torch.kernels.ops`), and are held to
the reference package's jnp oracles by ``tests/test_torch_kernels.py``.
``fused_sample_ref`` walks the vocabulary in the same ``block_v`` tiles as
the reference's tile-faithful oracle, so the two agree to the rounding of
``exp``/``log``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30

# decorrelates the fused draw's hash stream from the gumbel backend's
FUSED_DRAW_SALT = 0x46555345

_M32 = 0xFFFFFFFF


def penalty_ref(logits, counts_p, counts_o, repetition, presence, frequency,
                temperature):
    """Fused penalties + temperature scale (paper §2.2 / Eq. 1).

    logits: (B, V) any float dtype; counts_*: (B, V) int32;
    repetition/presence/frequency/temperature: (B,) f32.
    Returns penalized, temperature-scaled logits (B, V) f32.
    """
    z = logits.float()
    seen = ((counts_p > 0) | (counts_o > 0)).float()
    f = 1.0 + (repetition[:, None] - 1.0) * seen
    z = torch.where(z > 0, z / f, z * f)
    z = z - presence[:, None] * (counts_o > 0).float()
    z = z - frequency[:, None] * counts_o.float()
    return z / torch.clamp(temperature, min=1e-6)[:, None]


def shvs_mass_ref(z, hot_mask):
    """The SHVS streaming pass (paper Eq. 6–7): returns
    (m, s_hot, s_tail, tail_max), each (B,) f32.

    z: (B, V) f32 penalized/scaled logits; hot_mask: (V,) bool.
    Sums are computed in the stable basis w = exp(z - m).
    """
    m = z.amax(-1)
    w = torch.exp(z - m[:, None])
    hotf = hot_mask.float()[None, :]
    s_hot = (w * hotf).sum(-1)
    s_tail = (w * (1.0 - hotf)).sum(-1)
    tail_max = torch.where(hot_mask[None, :], NEG_INF, z).amax(-1)
    return m, s_hot, s_tail, tail_max


def _hash_uniform(seed, b, v):
    """Deterministic per-(seed, row, col) uniform in (0, 1], with 1.0 at the
    top 128 hash values, from a 32-bit integer hash (xorshift-mix),
    bit-equal to the reference's. uint32 arithmetic is done in int64 and
    masked to 32 bits (a product's low 32 bits survive int64 wrap-around).
    The uint32 -> f32 conversion rounds hash values >= 0xFFFFFF80 up to
    2^32, so u == 1.0 there exactly, as in the reference."""
    b = torch.as_tensor(b).to(torch.int64) & _M32
    v = torch.as_tensor(v).to(torch.int64) & _M32
    x = ((b * 2654435761) ^ (v * 40503) ^ (int(seed) & _M32)) & _M32
    x = x ^ (x >> 16)
    x = (x * 2246822519) & _M32
    x = x ^ (x >> 13)
    x = (x * 3266489917) & _M32
    x = x ^ (x >> 16)
    return (x.float() + 0.5) * (1.0 / 4294967296.0)


def gumbel_argmax_ref(z, seed, row0: int = 0):
    """Single-pass categorical draw via the Gumbel-max trick:
    ``argmax_v(z_v + G_v)``, ``G_v = -log(-log(U_v))`` with ``U_v =
    _hash_uniform(seed, b, v)`` for row b and column v of the operand. The
    first maximum wins; a NaN wins (the first NaN first), as in
    ``jnp.argmax``. A column with U == 1.0 gets G = +inf and wins whatever
    its logit (the reference's hash does the same).

    z: (B, V) f32; seed: the uint32 bits of the reference's int32 seed;
    ``row0``: the batch row of z's first row (b = row0 + the operand row).
    Returns tokens (B,) int32."""
    B, V = z.shape
    b = torch.arange(row0, row0 + B, device=z.device)[:, None]
    v = torch.arange(V, device=z.device)[None, :]
    u = _hash_uniform(seed, b, v)
    g = -torch.log(-torch.log(u))
    return (z + g).argmax(-1).to(torch.int32)


def _u32_from_uniform(u):
    """Map a pre-generated uniform in [0, 1) to a 24-bit integer row seed
    (exact in f32, so a pure function of the uniform's bits)."""
    return (u * 16777216.0).to(torch.int64)


def streaming_mass_update(m, s_tot, s_hot, zs, hot_f):
    """One online-softmax tile step: carries (m, s_tot, s_hot) — running
    max and total/hot exp-sums in the basis exp(z − m). zs: (bb, bv)
    scaled logits; hot_f: (1|bb, bv) f32."""
    tile_max = zs.amax(-1)
    m_new = torch.maximum(m, tile_max)
    scale = torch.exp(m - m_new)
    w = torch.exp(zs - m_new[:, None])
    s_tot = s_tot * scale + w.sum(-1)
    s_hot = s_hot * scale + (w * hot_f).sum(-1)
    return m_new, s_tot, s_hot


def argsort_desc(x):
    """The reference's ``jnp.argsort(-x, stable=True)`` along the last
    axis: values descending, equal values in index order, and every NaN
    (of either sign) after every number, -inf included, NaNs in index
    order; -0 and +0 tie. (torch's descending sort puts NaN first.) The
    values are sorted with NaN read as -inf, then a stable sort on
    ``isnan`` moves the NaNs behind the rest."""
    nan = torch.isnan(x)
    order = torch.sort(torch.where(nan, float("-inf"), x), dim=-1,
                       descending=True, stable=True).indices
    last = torch.sort(nan.gather(-1, order).to(torch.uint8), dim=-1,
                      stable=True).indices
    return order.gather(-1, last)


def topk_merge(vals, idx, tile_vals, tile_idx):
    """Merge a vocab tile into the running per-row top-K buffer.

    Buffer-first concatenation + the reference's stable descending order
    (:func:`argsort_desc`): ties resolve to the LOWEST vocabulary index,
    matching ``argmax`` tie-breaking, and a NaN ranks below -inf. So the
    buffer's initial (-inf, Vp) entries outrank every NaN and every -inf
    column: the buffer holds the K best values above -inf, then (-inf,
    Vp) entries, which decode to V - 1 through the final clamp.
    vals/idx: (bb, K); tile_vals/tile_idx: (bb, bv).
    """
    cat_v = torch.cat([vals, tile_vals], -1)
    cat_i = torch.cat([idx, tile_idx], -1)
    order = argsort_desc(cat_v)[:, :vals.shape[-1]]
    return cat_v.gather(-1, order), cat_i.gather(-1, order)


def trunc_gumbel_draw(vals, idx, s_tot, top_k, top_p, min_p, temperature,
                      row_seed):
    """Truncation-first filter + restricted Gumbel-max draw on the merged
    top-K buffer (the fused sampler's epilogue).

    vals/idx: (B, K) descending buffer of penalized, temperature-scaled
    logits and their int64 vocab ids; s_tot: (B,) total exp-mass in the
    basis exp(z − vals[:, 0]); row_seed: (B,) int64 per-row draw seeds.
    top-k / nucleus (exclusive prefix mass) / min-p are applied inside the
    buffer; the draw is argmax(vals + Gumbel) over the kept support.
    Returns (tokens int32, exact bool, kept int32).
    """
    B, K = vals.shape
    w = torch.exp(vals - vals[:, :1])
    pos = torch.arange(K, device=vals.device)[None, :]
    kk = torch.where(top_k > 0, torch.clamp(top_k, max=K), K)
    keep = pos < kk[:, None]
    subset_total = (w * keep).sum(-1)
    # with an explicit top-k the kept subset IS the support; otherwise the
    # support is the full distribution, whose mass the streaming pass
    # already accumulated
    norm_total = torch.where(top_k > 0, subset_total, s_tot)
    p = w * keep / torch.clamp(norm_total[:, None], min=1e-30)
    cum = torch.cumsum(p, -1)
    keep &= (cum - p) < top_p[:, None]
    keep &= p >= min_p[:, None] * p[:, :1]
    # provable-exactness flags (same rules as truncation_first_sample)
    mass_at_cap = subset_total / torch.clamp(norm_total, min=1e-30)
    explicit_k = (top_k > 0) & (top_k <= K)
    nucleus_ok = (top_p < 1.0) & \
        (mass_at_cap >= torch.clamp(top_p, max=1.0) - 1e-7)
    p_last = w[:, -1] / torch.clamp(norm_total, min=1e-30)
    minp_ok = (min_p > 0.0) & (p_last < min_p * p[:, 0])
    full_mass_ok = mass_at_cap >= 1.0 - 1e-7
    exact = explicit_k | nucleus_ok | minp_ok | full_mass_ok
    # restricted Gumbel-max: noise keyed on (salt, row seed, vocab id) only
    u = _hash_uniform(FUSED_DRAW_SALT, row_seed[:, None], idx)
    g = -torch.log(-torch.log(u))
    score = torch.where(keep, vals + g, float("-inf"))
    jwin = score.argmax(-1)
    tokens = idx.gather(-1, jwin[:, None])[:, 0]
    tokens = torch.where(temperature <= 0.0, idx[:, 0], tokens)
    kept = keep.sum(-1).to(torch.int32)
    return tokens.to(torch.int32), exact, kept


def fused_pad(logits, counts_p, counts_o, hot_mask, *, block_v):
    """Pad the vocabulary axis to a multiple of ``block_v``, as the
    reference does: padded columns carry z=NEG_INF, zero counts and a cold
    hot-mask (zero mass, never sampled). The reference's row padding never
    applies — its row block always divides B — and is left out."""

    def padv(x, value):
        pad = (-x.shape[-1]) % block_v
        return x if pad == 0 else F.pad(x, (0, pad), value=value)

    return (padv(logits.float(), NEG_INF), padv(counts_p.to(torch.int32), 0),
            padv(counts_o.to(torch.int32), 0),
            padv(hot_mask.to(torch.int32), 0))


def fused_sample_ref(logits, counts_p, counts_o, repetition, presence,
                     frequency, temperature, top_k, top_p, min_p, u_row,
                     hot_mask, *, k_cap, block_v=512):
    """Tile-faithful plain version of the fused single-pass sampler.

    ``penalty_ref`` materializes the penalized/scaled (B, V) tensor, then
    the vocabulary is walked in ``block_v`` tiles that update the running
    masses and the top-K buffer, then the shared epilogue filters and
    draws. K = min(k_cap, V padded to a multiple of block_v).

    Returns (tokens int32, exact bool, alpha f32, kept int32), each (B,).
    """
    B, V = logits.shape
    z, cp, co, hot = fused_pad(logits, counts_p, counts_o, hot_mask,
                               block_v=block_v)
    Vp = z.shape[1]
    K = min(k_cap, Vp)
    dev = z.device
    zs = penalty_ref(z, cp, co, repetition, presence, frequency,
                     temperature)
    m = torch.full((B,), NEG_INF, device=dev)
    s_tot = torch.zeros((B,), device=dev)
    s_hot = torch.zeros((B,), device=dev)
    vals = torch.full((B, K), float("-inf"), device=dev)
    idx = torch.full((B, K), Vp, dtype=torch.int64, device=dev)
    for j in range(Vp // block_v):
        sl = slice(j * block_v, (j + 1) * block_v)
        hot_f = hot[sl].float()[None, :]
        m, s_tot, s_hot = streaming_mass_update(m, s_tot, s_hot, zs[:, sl],
                                                hot_f)
        tile_idx = torch.arange(j * block_v, (j + 1) * block_v,
                                device=dev).expand(B, block_v)
        vals, idx = topk_merge(vals, idx, zs[:, sl], tile_idx)
    # the streamed sums are in the basis exp(z − m) and the buffer head is
    # that same running max (identical float), so s_tot needs no re-basis
    tokens, exact, kept = trunc_gumbel_draw(
        vals, idx, s_tot, top_k, top_p.float(), min_p.float(),
        temperature.float(), _u32_from_uniform(u_row.float()))
    alpha = s_hot / torch.clamp(s_tot, min=1e-30)
    return torch.clamp(tokens, max=V - 1), exact, alpha, kept
