"""Family ``granite_hybrid``'s plain reference: Granite 4.0-H
(``granitemoehybrid``), a typed stack of Mamba2 and NoPE attention
layers, each followed by a top-k mixture of experts that drops nothing
and an always-on shared expert, with Granite's four multipliers; in
float32, one whole request at a time with no pads; and the FLOPs of its
tokens. Plain PyTorch; it imports nothing of the program.

Per layer (``layer_types``)::

    h = rms(x); h = mamba2(h) or attn_nope(h, scale = attention_multiplier)
    x = x + residual_multiplier * h
    h = rms(x); h = moe_topk(h) + shared_swiglu(h)
    x = x + residual_multiplier * h

with ``x0 = embed(tokens) * embedding_multiplier`` and ``logits =
(rms(x) @ E^T) / logits_scaling``. Mamba2 is computed in SSD's quadratic
masked form, ``y = (L o C B^T) (dt x) + D x`` with ``L[t, s]`` the decay
from s to t, not as a scan over the tokens.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from perfbench.reference.models import Mm, _layer, head, rms

#: the configuration's values this reference computes, key: value
COMPUTED = {"position_embedding_type": "nope", "mamba_n_groups": 1,
            "mamba_proj_bias": False, "attention_bias": False,
            "hidden_act": "silu", "normalization_function": "rmsnorm",
            "tie_word_embeddings": True}


def check_config(cfg: dict) -> None:
    """Refuse a configuration whose stated semantics this reference does
    not compute: a value of ``COMPUTED`` other than its own, layer types
    other than ``mamba`` / ``attention`` or not one a layer, Mamba2 heads
    that do not tile the inner width, or a capacity that can drop a
    (token, expert) pair (this reference drops none)."""
    for key, one in COMPUTED.items():
        if cfg.get(key, one) != one:
            raise ValueError(f"{key} {cfg[key]!r}: this reference computes "
                             f"only {one!r}")
    kinds = cfg["layer_types"]
    if len(kinds) != cfg["num_hidden_layers"] or \
            set(kinds) - {"mamba", "attention"}:
        raise ValueError("layer_types: one of 'mamba' / 'attention' a layer")
    if cfg["mamba_n_heads"] * cfg["mamba_d_head"] != \
            cfg["mamba_expand"] * cfg["hidden_size"]:
        raise ValueError("Mamba2's heads must tile its inner width")
    if cfg["capacity_factor"] < (cfg["num_local_experts"]
                                 / cfg["num_experts_per_tok"]):
        raise ValueError("the reference drops nothing: capacity_factor "
                         "must be at least experts / experts per token")


def dims(cfg: dict) -> dict:
    """The sizes the forward and the FLOPs read, by their short names."""
    d = cfg["hidden_size"]
    inner = cfg["mamba_expand"] * d
    N = cfg["mamba_d_state"]
    return dict(d=d, inner=inner, H=cfg["mamba_n_heads"],
                P=cfg["mamba_d_head"], N=N, K=cfg["mamba_d_conv"],
                C=inner + 2 * N, nh=cfg["num_attention_heads"],
                nkv=cfg["num_key_value_heads"],
                hd=d // cfg["num_attention_heads"],
                E=cfg["num_local_experts"], k=cfg["num_experts_per_tok"],
                fe=cfg["intermediate_size"],
                fs=cfg["shared_intermediate_size"])


def ssd(x, dt, la, Bm, Cm):
    """Mamba2's recurrence in SSD's quadratic form, from zero state. x
    (T, H, P); dt, la (T, H) the step and log a = -exp(A_log) dt; Bm, Cm
    (T, N). y[t] = sum_{s <= t} exp(sum_{r=s+1..t} la[r]) (C[t]·B[s])
    dt[s] x[s]. Returns y (T, H, P)."""
    T = x.shape[0]
    cs = torch.cumsum(la, 0)                                   # (T, H)
    seg = cs[:, None, :] - cs[None, :, :]                      # (t, s, H)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(causal[..., None], seg, -math.inf))
    w = decay * (Cm @ Bm.T)[..., None]                         # (t, s, H)
    return torch.einsum("tsh,shp->thp", w, dt[..., None] * x)


def scan(x, dt, la, Bm, Cm):
    """The same recurrence token by token (a test's second computation):
    h_t = a_t h_{t-1} + (dt_t x_t) ⊗ B_t, y_t = h_t · C_t."""
    h = torch.zeros(x.shape[1], x.shape[2], Bm.shape[1], device=x.device)
    ys = []
    for t in range(x.shape[0]):
        h = torch.exp(la[t])[:, None, None] * h + \
            (dt[t, :, None] * x[t])[..., None] * Bm[t]
        ys.append(h @ Cm[t])
    return torch.stack(ys)


def mamba2(cfg: dict, p: dict, h: torch.Tensor, mm: Mm) -> torch.Tensor:
    """The published Mamba2 mixer over a whole request h (T, d)."""
    s = dims(cfg)
    T = h.shape[0]
    z, xbc, dt = mm(h, p["in_proj"]).split(
        [s["inner"], s["C"], s["H"]], dim=-1)
    # depthwise causal conv over x, B and C, with its bias, then SiLU
    xp = F.pad(xbc, (0, 0, s["K"] - 1, 0))
    conv = sum(xp[i:i + T] * p["conv_w"][i] for i in range(s["K"]))
    xbc = F.silu(conv + p["conv_b"])
    x, Bm, Cm = xbc.split([s["inner"], s["N"], s["N"]], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])                         # (T, H)
    la = -torch.exp(p["A_log"]) * dt
    x = x.reshape(T, s["H"], s["P"])
    y = ssd(x, dt, la, Bm, Cm) + p["D"][:, None] * x
    y = y.reshape(T, s["inner"]) * F.silu(z)
    y = rms(y, p["norm_w"], cfg["rms_norm_eps"])     # one group: the width
    return mm(y, p["out_proj"])


def attention(cfg: dict, a: dict, h: torch.Tensor, mm: Mm) -> torch.Tensor:
    """Causal GQA attention with no positions (NoPE), its softmax scaled
    by ``attention_multiplier``."""
    s = dims(cfg)
    T, nh, nkv, hd = h.shape[0], s["nh"], s["nkv"], s["hd"]
    q = mm(h, a["w_q"]).view(T, nh, hd)
    kk = mm(h, a["w_k"]).view(T, nkv, hd).repeat_interleave(nh // nkv, 1)
    v = mm(h, a["w_v"]).view(T, nkv, hd).repeat_interleave(nh // nkv, 1)
    sc = torch.einsum("qhd,khd->hqk", q, kk) * cfg["attention_multiplier"]
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    sc = sc.masked_fill(~causal, float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1), v)
    return mm(o.reshape(T, nh * hd), a["w_o"])


def moe(cfg: dict, m: dict, h: torch.Tensor, mm: Mm) -> torch.Tensor:
    """The top-k experts (softmax over all, renormalised on the k picks)
    and the shared SwiGLU expert; every expert on every token, then each
    token's k picks."""
    T, k = h.shape[0], cfg["num_experts_per_tok"]
    probs = torch.softmax(h @ m["router"], -1)
    top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top[:, :k] / top[:, :k].sum(-1, keepdim=True)
    act = F.silu(mm(h, m["w_gate"])) * mm(h, m["w_up"])        # (E, T, fe)
    out = mm(act, m["w_down"])                                 # (E, T, d)
    y = (out[ids[:, :k], torch.arange(T, device=h.device)[:, None]]
         * gates[..., None]).sum(1)
    sh = m["shared"]
    return y + mm(F.silu(mm(h, sh["w_gate"])) * mm(h, sh["w_up"]),
                  sh["w_down"])


def hidden(cfg: dict, w: dict, tokens: torch.Tensor,
           quant: Optional[str] = None) -> torch.Tensor:
    """Final-normed hidden states (T, d) of one request."""
    mm = Mm(quant)
    eps, rm = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    st = w["stack"]
    x = w["emb"]["tok"][tokens].float() * cfg["embedding_multiplier"]
    index = {"mamba": 0, "attention": 0}
    for i, kind in enumerate(cfg["layer_types"]):
        j = index[kind]
        index[kind] += 1
        h = rms(x, st["ln1"][i].float(), eps)
        h = mamba2(cfg, _layer(st["mamba"], j), h, mm) if kind == "mamba" \
            else attention(cfg, _layer(st["attn"], j), h, mm)
        x = x + rm * h
        h = rms(x, st["ln2"][i].float(), eps)
        x = x + rm * moe(cfg, _layer(st["moe"], i), h, mm)
    return rms(x, st["final_ln"].float(), eps)


def output_logits(cfg: dict, weights: dict, items: List[dict],
                  quant: Optional[str] = None, rows: int = 16
                  ) -> List[torch.Tensor]:
    """Logits (n, V) at each output position of each item, a request at a
    time (``rows`` is not needed, nor ``padded``: the program holds each
    row's state at its own length, so no pad reaches a request)."""
    dev = weights["emb"]["tok"].device
    out: List[torch.Tensor] = []
    for it in items:
        p, o = it["prompt"], it["outputs"]
        toks = torch.tensor(list(p) + list(o[:-1]), dtype=torch.long,
                            device=dev)
        h = hidden(cfg, weights, toks, quant)
        out.append(head(cfg, weights, h[len(p) - 1:], quant)
                   / cfg["logits_scaling"])
    return out


def matmul_params(cfg: dict) -> int:
    """Weights that one token multiplies through: each Mamba2 layer's
    projections and conv taps, each attention layer's, every layer's
    active experts, shared expert and router, and the head (embedding
    lookups cost no FLOPs)."""
    s = dims(cfg)
    kinds = cfg["layer_types"]
    d = s["d"]
    mamba = (d * (2 * s["inner"] + 2 * s["N"] + s["H"]) + s["K"] * s["C"]
             + s["inner"] * d)
    attn = 2 * d * s["nh"] * s["hd"] + 2 * d * s["nkv"] * s["hd"]
    ffn = s["k"] * 3 * d * s["fe"] + 3 * d * s["fs"] + d * s["E"]
    return (kinds.count("mamba") * mamba + kinds.count("attention") * attn
            + len(kinds) * ffn + d * cfg["vocab_size"])


def _state_flops(cfg: dict) -> float:
    """A token's Mamba2 state work over the layers: 4 x heads x head size
    x state a layer (the state's update and its read by C)."""
    s = dims(cfg)
    return cfg["layer_types"].count("mamba") * 4.0 * s["H"] * s["P"] * s["N"]


def token_flops(cfg: dict, context: int) -> float:
    """2 per multiplied weight, the Mamba2 state work, and per attention
    layer 4 x heads x head size x ``context``."""
    s = dims(cfg)
    return (2.0 * matmul_params(cfg) + _state_flops(cfg)
            + cfg["layer_types"].count("attention") * 4.0 * s["nh"]
            * s["hd"] * context)


def prompt_flops(cfg: dict, prompt_len: int) -> float:
    """Token c (1-based) attends over c positions: sum_c c = n (n + 1) /
    2; the rest is a token's work n times."""
    s = dims(cfg)
    n = prompt_len
    return ((2.0 * matmul_params(cfg) + _state_flops(cfg)) * n
            + cfg["layer_types"].count("attention") * 4.0 * s["nh"]
            * s["hd"] * n * (n + 1) / 2)
