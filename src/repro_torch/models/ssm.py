"""Linear-recurrence blocks: RWKV-6 ("Finch") and Mamba2.

Each has one sequence form, used for prefill (T prompt tokens) and decode
(T = 1); the reference's ``lax.scan`` over time is a Python loop over T
here. The recurrent state is float32 throughout.

RWKV-6 (arXiv:2404.05892), per layer
  time-mix: token-shift mixed r/k/v/w/g projections; data-dependent decay
      w_t = exp(-exp(w0 + tanh(x_w A) B))
  wkv recurrence per head (hs = head size):
      y_t = r_t · (S_{t-1} + diag(u) k_t v_t^T)
      S_t = diag(w_t) S_{t-1} + k_t v_t^T
  channel-mix: token-shift + squared-ReLU MLP with sigmoid receptance gate.

Mamba2 (SSD, simplified: ngroups=1, conv over x only), per layer
      dt_t = softplus(raw_dt + dt_bias)          (B, T, H)
      a_t  = exp(-exp(A_log) * dt_t)
      h_t  = a_t h_{t-1} + (dt_t x_t) ⊗ B_t      h: (B, H, hd, N)
      y_t  = h_t · C_t + D x_t
  with gated RMSNorm and output projection. The published mixer
  (:func:`mamba_xbc_seq`: Granite 4.0-H) runs its causal conv over x, B
  and C together, with a bias, and has a head size of its own
  (``mamba_head_dim``); given each row's length, a prefill holds a row's
  state at its own last token.

Under a mesh (``models/dist.py``) RWKV-6 is Megatron's: the time mix's
``w_r``/``w_k``/``w_v``/``w_g`` are column blocks, and ``w_o`` is
row-parallel (one ``psum``); the channel mix is column-parallel in
``w_ck`` and row-parallel in ``w_cv`` and ``w_cr`` (their two partial
sums in one ``psum``). Where the column block falls on head boundaries a
rank runs the WKV recurrence of its own heads on its block of the state.
Where it ends inside a head (rwkv6-3b's 40 heads over 16 ranks) the
recurrence is split by value columns instead, as ``cache_shardings``
splits the state (its last dimension): r/k/v/w are gathered whole in one
call, a rank runs every head over its hs/t value columns, the per-head
group norm sums its squares over the ranks (one ``psum``), and one
all-gather makes the output whole for the row-parallel ``w_o``. Mamba2's
weights are replicated (``param_spec``), so it runs whole on every rank.

Products the reference keeps in float32 (``preferred_element_type`` with
no cast) run as float32 GEMMs of the widened operands here; the others
accumulate in f32 and round to the activation dtype (``matmul``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import dist
from repro_torch.models.layers import dense_init, matmul, rms_norm, \
    row_parallel, torch_dtype


def matmul_f32(x, w):
    """x @ w with a float32 result (bf16 products are exact in f32)."""
    return torch.matmul(x.float(), w.float())


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------


def init_rwkv(gen: torch.Generator, cfg: ModelConfig, device,
              stacked: int = 0):
    """Seeded RWKV-6 layer weights in the reference's layout."""
    d, f = cfg.d_model, cfg.d_ff
    rank = cfg.ssm.decay_lora_rank
    dt = torch_dtype(cfg.dtype)
    pre = (stacked,) if stacked else ()
    mk = lambda i, o, scale=None: dense_init(gen, pre + (i, o), dt, device,
                                             scale)

    def vec(shape, init=0.0, noise=0.0):
        base = torch.full(pre + shape, init, dtype=torch.float32,
                          device=device)
        if noise:
            base = base + noise * torch.randn(pre + shape, generator=gen,
                                              device=device)
        return base.to(dt)

    return {
        # time-mix
        "mu": vec((5, d), 0.5, 0.1),          # mixing for r,k,v,w,g
        "w_r": mk(d, d), "w_k": mk(d, d), "w_v": mk(d, d),
        "w_g": mk(d, d), "w_o": mk(d, d),
        "w0": vec((d,), -6.0, 0.3),           # base decay (w ≈ 1)
        "lora_a": mk(d, rank, scale=0.01),
        "lora_b": mk(rank, d, scale=0.01),
        "u": vec((d,), 0.0, 0.3),             # per-channel bonus
        "ln_x": torch.ones(pre + (d,), dtype=dt, device=device),
        # channel-mix
        "mu_c": vec((2, d), 0.5, 0.1),
        "w_ck": mk(d, f), "w_cv": mk(f, d), "w_cr": mk(d, d),
    }


def _rwkv_decay(p, xw, cols=slice(None)):
    """Data-dependent per-channel decay in (0, 1) of the channels
    ``cols``. xw: (..., d)."""
    lora = matmul_f32(xw, p["lora_a"])
    lora = torch.matmul(torch.tanh(lora), p["lora_b"][..., cols].float())
    return torch.exp(-torch.exp(p["w0"][..., cols].float() + lora))


def _rwkv_mix(x, x_prev, mu):
    """Token-shift interpolation: x + (x_prev - x) * mu."""
    return x + (x_prev - x) * mu.to(x.dtype)


def rwkv_state_shape(dl: int, d: int, hs: int) -> Tuple[int, int, int]:
    """(heads, key, value) of a rank's WKV state whose time mix holds
    ``dl`` of the ``d`` channels: every head whole without a split, its
    heads where the block falls on head boundaries, every head's block of
    hs/t value columns where it ends inside a head."""
    if not dist.split_block(dl, d):
        return d // hs, hs, hs
    if dl % hs == 0:
        return dl // hs, hs, hs
    t = dist.tp_size()
    if hs % t:
        raise NotImplementedError(
            f"a WKV state of head size {hs} splits over {t} model ranks "
            "neither by heads nor by value columns")
    return d // hs, hs, hs // t


def _wkv(r, k, v, w, u, state):
    """The WKV recurrence over T. r, k, w: (B, T, H, hs); v: (B, T, H,
    hv); u: (H, hs, 1); state: (B, H, hs, hv). Returns (y (B, T, H, hv),
    state)."""
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]    # (B, H, hs, hv)
        ys.append(torch.matmul(r[:, t, :, None, :],
                               state + u * kv)[:, :, 0])  # (B, H, hv)
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(ys, dim=1), state


def rwkv_time_mix_seq(p, x, x_last, state, cfg: ModelConfig):
    """x: (B, T, d); x_last: (B, d) the previous token's input (zeros at
    the start); state: (B, H, hs, hs) f32. Returns (out, new_x_last,
    new_state). Under a mesh the rank's block of the r/k/v/g columns
    makes ``state`` its heads' (B, H/t, hs, hs), or every head's block of
    value columns (B, H, hs, hs/t) where the block ends inside a head
    (:func:`rwkv_state_shape`)."""
    B, T, d = x.shape
    hs = cfg.ssm.rwkv_head_size
    dl = p["w_r"].shape[-1]                 # the rank's channels
    split = dist.split_block(dl, d)
    H, _, hv = rwkv_state_shape(dl, d, hs)
    cols = slice(None)
    if split:
        c0 = dist.tp_rank() * dl
        cols = slice(c0, c0 + dl)
    x_prev = torch.cat([x_last[:, None].to(x.dtype), x[:, :-1]], dim=1)
    mu = p["mu"]
    xr, xk, xv, xw, xg = (_rwkv_mix(x, x_prev, mu[i]) for i in range(5))
    r = matmul_f32(xr, p["w_r"])
    k = matmul_f32(xk, p["w_k"])
    v = matmul_f32(xv, p["w_v"])
    g = F.silu(matmul_f32(xg, p["w_g"]))
    w = _rwkv_decay(p, xw, cols)
    if hv == hs:
        heads = lambda z: z.reshape(B, T, H, hs)
        u = p["u"][..., cols].float().reshape(H, hs)[..., :, None]
        y, state = _wkv(heads(r), heads(k), heads(v), heads(w), u, state)
        # per-head group norm
        y = rms_norm(y, torch.ones((hs,), dtype=torch.float32,
                                   device=x.device), cfg.rmsnorm_eps)
        y = y.reshape(B, T, dl)
    else:
        # by value columns: whole heads of r/k/v/w, the rank's hv columns
        # of each head's v
        heads = lambda z: z.reshape(B, T, H, hs)
        r, k, v, w = (heads(z) for z in dist.gather_cols([r, k, v, w]))
        v = dist.model_block(v, -1, hv)
        u = p["u"].float().reshape(H, hs)[..., :, None]
        y, state = _wkv(r, k, v, w, u, state)
        # the group norm of a head's hs values, hv of them on each rank
        var = dist.psum_model(y.square().sum(-1, keepdim=True)) / hs
        y = y * torch.rsqrt(var + cfg.rmsnorm_eps)
        y = dist.gather_model(y, -1).reshape(B, T, d)[..., cols]
    y = y * p["ln_x"][..., cols].float()
    y = (y * g).to(x.dtype)
    out = row_parallel(y, p["w_o"], x.dtype) if split else matmul(y, p["w_o"])
    return out, x[:, -1], state


def rwkv_channel_mix_seq(p, x, x_last, d_ff: int = 0):
    """Channel-mix with token shift. Returns (out, new_x_last). ``d_ff``
    (the config's) tells a column block of ``w_ck`` from a whole one; a
    block of ``w_cr``'s rows shows against x's whole width."""
    x_prev = torch.cat([x_last[:, None].to(x.dtype), x[:, :-1]], dim=1)
    xk = _rwkv_mix(x, x_prev, p["mu_c"][0])
    xr = _rwkv_mix(x, x_prev, p["mu_c"][1])
    k = torch.square(torch.relu(matmul_f32(xk, p["w_ck"])))
    nr = p["w_cr"].shape[-2]
    ff_split = bool(d_ff) and dist.split_block(p["w_ck"].shape[-1], d_ff)
    cr_split = dist.split_block(nr, x.shape[-1])
    if ff_split or cr_split:
        # the row-parallel partial sums, both in float32, in one psum
        kv = torch.matmul(k.to(x.dtype).float(), p["w_cv"].float())
        r = matmul_f32(dist.model_block(xr, -1, nr) if cr_split else xr,
                       p["w_cr"])
        parts = [t for t, sp in ((kv, ff_split), (r, cr_split)) if sp]
        summed = iter(dist.psum_model(torch.cat(parts, -1))
                      .split([t.shape[-1] for t in parts], -1))
        kv = next(summed) if ff_split else kv
        r = next(summed) if cr_split else r
        kv = kv.to(x.dtype)
    else:
        kv = matmul(k.to(x.dtype), p["w_cv"])
        r = matmul_f32(xr, p["w_cr"])
    r = torch.sigmoid(r)
    return r.to(x.dtype) * kv, x[:, -1]


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------


def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(inner, nheads, headdim, state). The head size is attention's
    unless the config sets one of its own (``mamba_head_dim``)."""
    inner = cfg.ssm.expand * cfg.d_model
    headdim = getattr(cfg, "mamba_head_dim", 0) or cfg.resolved_head_dim
    return inner, inner // headdim, headdim, cfg.ssm.state_size


def init_mamba(gen: torch.Generator, cfg: ModelConfig, device,
               stacked: int = 0, xbc: bool = False):
    """Seeded Mamba2 layer weights in the reference's layout; ``xbc``:
    the published mixer's (:func:`mamba_xbc_seq`), whose conv taps and
    bias span x, B and C."""
    d = cfg.d_model
    inner, nheads, headdim, N = mamba_dims(cfg)
    conv, ch = cfg.ssm.conv_size, inner + 2 * N if xbc else inner
    dt = torch_dtype(cfg.dtype)
    pre = (stacked,) if stacked else ()
    f32 = dict(dtype=torch.float32, device=device)
    p = {
        "in_proj": dense_init(gen, pre + (d, 2 * inner + 2 * N + nheads), dt,
                              device),
        "conv_w": (torch.randn(pre + (conv, ch), generator=gen,
                               device=device) / math.sqrt(conv)).to(dt),
        "A_log": torch.zeros(pre + (nheads,), **f32),
        "D": torch.ones(pre + (nheads,), **f32),
        "dt_bias": torch.zeros(pre + (nheads,), **f32),
        "norm_w": torch.ones(pre + (inner,), dtype=dt, device=device),
        "out_proj": dense_init(gen, pre + (inner, d), dt, device),
    }
    if xbc:
        p["conv_b"] = torch.zeros(pre + (ch,), dtype=dt, device=device)
    return p


def _mamba_split(p, x, cfg: ModelConfig):
    inner, nheads, headdim, N = mamba_dims(cfg)
    zxbcdt = matmul(x, p["in_proj"])
    return (zxbcdt[..., :inner], zxbcdt[..., inner:2 * inner],
            zxbcdt[..., 2 * inner:2 * inner + N],
            zxbcdt[..., 2 * inner + N:2 * inner + 2 * N],
            zxbcdt[..., 2 * inner + 2 * N:])


def _causal_conv_seq(xc, conv_w, conv_state, bias=None, lens=None):
    """Depthwise causal conv along T. xc: (B, T, C); conv_state: (B,
    K-1, C) carry-in from previous tokens. Returns (y,
    new_conv_state). The taps, then ``bias``, are summed in order in
    xc's dtype, as the reference's Python ``sum`` does. The new carry is
    the K-1 inputs that end at T, or at each row's length where ``lens``
    (B,) is given (a right-padded prefill: its pads never enter)."""
    K, T = conv_w.shape[0], xc.shape[1]
    xfull = torch.cat([conv_state.to(xc.dtype), xc], dim=1)
    y = xfull[:, 0:T] * conv_w[0].to(xc.dtype)
    for i in range(1, K):
        y = y + xfull[:, i:i + T] * conv_w[i].to(xc.dtype)
    if bias is not None:
        y = y + bias.to(xc.dtype)
    if lens is None:
        carry = xfull[:, -(K - 1):]
    else:
        idx = lens.long()[:, None] + torch.arange(K - 1, device=xc.device)
        carry = xfull.gather(1, idx[..., None].expand(-1, -1,
                                                       xfull.shape[-1]))
    return F.silu(y.float()).to(xc.dtype), carry


def _mamba_recur(p, x, z, xc, Bc, Cc, dt, ssm_state, cfg: ModelConfig,
                 lens=None):
    """Both mixers after their conv: the recurrence over T from
    ``ssm_state``, D, the gate, the group norm and ``out_proj``. With
    ``lens`` a row's dt is 0 from its length on, so a = 1 and nothing
    enters. Returns (out, ssm_state)."""
    B, T, d = x.shape
    inner, nheads, headdim, N = mamba_dims(cfg)
    dt = F.softplus(dt.float() + p["dt_bias"])                 # (B, T, H)
    if lens is not None:
        live = torch.arange(T, device=x.device)[None, :] < lens[:, None]
        dt = torch.where(live[..., None], dt, 0.0)
    a = torch.exp(-torch.exp(p["A_log"]) * dt)                 # (B, T, H)
    xh = xc.reshape(B, T, nheads, headdim).float()
    Bf, Cf = Bc.float(), Cc.float()
    dx = dt[..., None] * xh                                    # (B,T,H,hd)
    h = ssm_state
    ys = []
    for t in range(T):
        h = a[:, t, :, None, None] * h + \
            dx[:, t, :, :, None] * Bf[:, t, None, None, :]
        ys.append(torch.matmul(h, Cf[:, t, None, :, None])[..., 0])
    y = torch.stack(ys, dim=1)                                 # (B,T,H,hd)
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(B, T, inner) * F.silu(z.float())
    y = rms_norm(y, p["norm_w"], cfg.rmsnorm_eps).to(x.dtype)
    return matmul(y, p["out_proj"]), h


def mamba_seq(p, x, conv_state, ssm_state, cfg: ModelConfig):
    """x: (B, T, d); conv_state: (B, K-1, inner); ssm_state: (B, H, hd, N)
    f32. Returns (out, conv_state, ssm_state)."""
    z, xc, Bc, Cc, dt = _mamba_split(p, x, cfg)
    xc, conv_state = _causal_conv_seq(xc, p["conv_w"], conv_state)
    out, h = _mamba_recur(p, x, z, xc, Bc, Cc, dt, ssm_state, cfg)
    return out, conv_state, h


def mamba_xbc_seq(p, x, conv_state, ssm_state, cfg: ModelConfig,
                  lens=None):
    """The published Mamba2 mixer (Granite 4.0-H): z, xBC, dt = in_proj
    x; the causal conv with its bias, and SiLU, over x, B and C together
    (conv_state: (B, K-1, inner + 2N)); then as :func:`mamba_seq`.
    ``lens`` (B,): the rows' lengths in a right-padded prefill, so a
    row's conv carry and state are held at its own last token, whatever
    the pads of its call. Returns (out, conv_state, ssm_state)."""
    inner, nheads, _, N = mamba_dims(cfg)
    z, xbc, dt = matmul(x, p["in_proj"]).split(
        [inner, inner + 2 * N, nheads], dim=-1)
    xbc, conv_state = _causal_conv_seq(xbc, p["conv_w"], conv_state,
                                       bias=p["conv_b"], lens=lens)
    xc, Bc, Cc = xbc.split([inner, N, N], dim=-1)
    out, h = _mamba_recur(p, x, z, xc, Bc, Cc, dt, ssm_state, cfg, lens)
    return out, conv_state, h
