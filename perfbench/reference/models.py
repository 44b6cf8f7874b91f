"""Plain forwards of the benchmark's configurations, in float32.

Straight from the equations, one whole sequence at a time: no cache, no
batching of requests, no kernel of the program. It reads the weights the
benchmark made (the program's layout: weights ``(in, out)``, per-layer
leaves stacked on a leading layer axis) and widens each layer's leaves to
float32 as it goes. TF32 is switched off by the caller
(:func:`reference.no_tf32`).

``quant="fp8"`` is the control: every weight and every activation that
enters a matrix product is rounded to float8 e4m3 (weights per output
column, activations per token, each scaled by its largest magnitude),
the router excepted, as an fp8 serving path would compute it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Round ``x`` to float8 e4m3 with one scale per slice along ``dim``
    (the largest magnitude maps to the format's largest value)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Mm:
    """x @ w in float32, optionally through the fp8 control."""

    def __init__(self, quant: Optional[str]):
        if quant not in (None, "fp8"):
            raise ValueError(quant)
        self.quant = quant

    def __call__(self, x, w):
        x, w = x.float(), w.float()
        if self.quant == "fp8":
            x, w = _q8(x, -1), _q8(w, -2)
        return x @ w


def rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rope(x, pos, theta):
    """Rotate the two halves of each head: x (T, H, hd), pos (T,)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd // 2, device=x.device,
                                       dtype=torch.float32) / (hd // 2))
    ang = pos[:, None].float() * inv
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], -1)


def _layer(tree, i):
    out = {}
    for k, v in tree.items():
        out[k] = _layer(v, i) if isinstance(v, dict) else v[i].float()
    return out


def moe_hidden(cfg: dict, w: dict, tokens: torch.Tensor,
               quant: Optional[str] = None) -> torch.Tensor:
    """Final-normed hidden states (T, d) of a decoder with GQA attention
    (RoPE, causal) and a top-k mixture of experts that drops nothing."""
    mm = Mm(quant)
    eps = cfg["rms_norm_eps"]
    d, nh, nkv, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                      cfg["num_key_value_heads"], cfg["head_dim"])
    E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    T = tokens.shape[0]
    dev = tokens.device
    x = w["emb"]["tok"][tokens].float()
    pos = torch.arange(T, device=dev)
    causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    g = nh // nkv
    for i in range(cfg["num_hidden_layers"]):
        a = _layer(w["stack"]["attn"], i)
        h = rms(x, w["stack"]["ln1"][i].float(), eps)
        q = _rope(mm(h, a["w_q"]).view(T, nh, hd), pos, cfg["rope_theta"])
        kk = _rope(mm(h, a["w_k"]).view(T, nkv, hd), pos, cfg["rope_theta"])
        v = mm(h, a["w_v"]).view(T, nkv, hd)
        kk = kk.repeat_interleave(g, dim=1)          # head j reads kv j // g
        v = v.repeat_interleave(g, dim=1)
        s = torch.einsum("qhd,khd->hqk", q, kk) / math.sqrt(hd)
        s = s.masked_fill(~causal, float("-inf"))
        o = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)
        x = x + mm(o.reshape(T, nh * hd), a["w_o"])
        m = _layer(w["stack"]["moe"], i)
        h = rms(x, w["stack"]["ln2"][i].float(), eps)
        probs = torch.softmax(h @ m["router"], -1)
        top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates = top[:, :k] / top[:, :k].sum(-1, keepdim=True)
        ids = ids[:, :k]
        # every expert on every token, then each token's k picks
        act = F.silu(mm(h, m["w_gate"])) * mm(h, m["w_up"])   # (E, T, fe)
        out = mm(act, m["w_down"])                              # (E, T, d)
        y = (out[ids, torch.arange(T, device=dev)[:, None]]
             * gates[..., None]).sum(1)
        x = x + y
    return rms(x, w["stack"]["final_ln"].float(), eps)


def _shift(x):
    """Each token's predecessor (zeros before the first). x (B, T, d)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def rwkv6_hidden(cfg: dict, w: dict, tokens: torch.Tensor,
                 quant: Optional[str] = None) -> torch.Tensor:
    """Final-normed hidden states (B, T, d) of RWKV-6 (the program's
    form: RMS norms, static token-shift mixes, data-dependent decay, a
    per-head RMS group norm) over a batch of token rows (B, T) scanned
    from zero states. A row's trailing tokens never reach its earlier
    positions, so rows may be padded at the end."""
    mm = Mm(quant)
    eps = cfg["rms_norm_eps"]
    d, hs = cfg["hidden_size"], cfg["head_size"]
    H = d // hs
    B, T = tokens.shape
    x = w["emb"]["tok"][tokens].float()
    for i in range(cfg["num_hidden_layers"]):
        p = _layer(w["stack"]["layers"], i)
        xa = rms(x, w["stack"]["ln1"][i].float(), eps)
        prev = _shift(xa)
        mix = [xa + (prev - xa) * p["mu"][j] for j in range(5)]
        r = mm(mix[0], p["w_r"]).view(B, T, H, hs)
        kk = mm(mix[1], p["w_k"]).view(B, T, H, hs)
        v = mm(mix[2], p["w_v"]).view(B, T, H, hs)
        gate = F.silu(mm(mix[4], p["w_g"]))
        lora = torch.tanh(mm(mix[3], p["lora_a"])) @ p["lora_b"]
        decay = torch.exp(-torch.exp(p["w0"] + lora)).view(B, T, H, hs)
        u = p["u"].view(H, hs, 1)
        S = torch.zeros(B, H, hs, hs, device=x.device)
        ys = []
        for t in range(T):
            kv = kk[:, t, :, :, None] * v[:, t, :, None, :]
            ys.append((r[:, t, :, None, :] @ (S + u * kv))[:, :, 0])
            S = decay[:, t, :, :, None] * S + kv
        y = torch.stack(ys, 1)                                 # (B,T,H,hs)
        y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + eps)
        y = y.reshape(B, T, d) * p["ln_x"] * gate
        x = x + mm(y, p["w_o"])
        xc = rms(x, w["stack"]["ln2"][i].float(), eps)
        prev = _shift(xc)
        xk = xc + (prev - xc) * p["mu_c"][0]
        xr = xc + (prev - xc) * p["mu_c"][1]
        kc = torch.relu(mm(xk, p["w_ck"])).square()
        x = x + torch.sigmoid(mm(xr, p["w_cr"])) * mm(kc, p["w_cv"])
    return rms(x, w["stack"]["final_ln"].float(), eps)


def head(cfg: dict, w: dict, h: torch.Tensor,
         quant: Optional[str] = None) -> torch.Tensor:
    """Logits (..., V) of final hidden states."""
    emb = w["emb"]
    wh = emb["tok"].T if cfg["tie_word_embeddings"] else emb["head"]
    return Mm(quant)(h, wh)


def check_config(cfg: dict) -> None:
    """Refuse a configuration whose stated semantics this reference does
    not compute: a Granite multiplier other than the identity (the
    program applies none, and neither does this reference), or a capacity
    that can drop a (token, expert) pair (this reference drops none)."""
    if cfg["family"] == "moe":
        identity = {"embedding_multiplier": 1.0, "residual_multiplier": 1.0,
                    "logits_scaling": 1.0,
                    "attention_multiplier": 1.0 / math.sqrt(cfg["head_dim"])}
        for key, one in identity.items():
            if key in cfg and not math.isclose(cfg[key], one):
                raise ValueError(f"{key} {cfg[key]}: neither the program nor "
                                 f"the reference applies it (only {one})")
        if cfg["capacity_factor"] < (cfg["num_local_experts"]
                                     / cfg["num_experts_per_tok"]):
            raise ValueError("the reference drops nothing: capacity_factor "
                             "must be at least experts / experts per token")
    elif cfg["family"] != "ssm":
        raise ValueError(f"no reference for family {cfg['family']!r}")
