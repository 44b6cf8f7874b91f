"""Family ``moe``'s plain reference: a decoder of GQA attention (RoPE,
causal) and a top-k mixture of experts that drops nothing, in float32,
one whole sequence at a time; and the FLOPs of its tokens. Plain
PyTorch; it imports nothing of the program."""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from perfbench.reference.models import Mm, _layer, _rope, head, rms


def check_config(cfg: dict) -> None:
    """Refuse a configuration whose stated semantics this reference does
    not compute: a Granite multiplier other than the identity (the
    program applies none, and neither does this reference), or a capacity
    that can drop a (token, expert) pair (this reference drops none)."""
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


def output_logits(cfg: dict, weights: dict, items: List[dict],
                  quant: Optional[str] = None, rows: int = 16
                  ) -> List[torch.Tensor]:
    """Logits (n, V) at each output position of each item, a request at a
    time (``rows`` is not needed: nothing is padded)."""
    dev = weights["emb"]["tok"].device
    out: List[torch.Tensor] = []
    for it in items:
        p, o = it["prompt"], it["outputs"]
        toks = torch.tensor(list(p) + list(o[:-1]), dtype=torch.long,
                            device=dev)
        h = moe_hidden(cfg, weights, toks, quant)
        out.append(head(cfg, weights, h[len(p) - 1:], quant))
    return out


def matmul_params(cfg: dict) -> int:
    """Weights that one token multiplies through (active experts and the
    router): embedding lookups cost no FLOPs, the LM head does."""
    d, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    hd = cfg["head_dim"]
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
    E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    ffn = k * 3 * d * cfg["intermediate_size"] + d * E
    return L * (attn + ffn) + d * V


def token_flops(cfg: dict, context: int) -> float:
    """2 per multiplied weight, plus per layer 4 x heads x head size x
    ``context`` (the scores and the weighted sum)."""
    return (2.0 * matmul_params(cfg) + cfg["num_hidden_layers"] * 4.0
            * cfg["num_attention_heads"] * cfg["head_dim"] * context)


def prompt_flops(cfg: dict, prompt_len: int) -> float:
    """Token c (1-based) attends over c positions:
    sum_c c = n (n + 1) / 2."""
    return (2.0 * matmul_params(cfg) * prompt_len
            + cfg["num_hidden_layers"] * 4.0 * cfg["num_attention_heads"]
            * cfg["head_dim"] * prompt_len * (prompt_len + 1) / 2)
