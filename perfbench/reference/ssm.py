"""Family ``ssm``'s plain reference: RWKV-6 in the program's form, in
float32, over blocks of token rows scanned from zero states with the
admission call's pad tokens; and the FLOPs of its tokens. Plain PyTorch;
it imports nothing of the program."""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from perfbench.reference.models import Mm, _layer, _shift, head, rms


def check_config(cfg: dict) -> None:
    """Nothing to refuse: the configuration states no option that this
    reference leaves out."""


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


def output_logits(cfg: dict, weights: dict, items: List[dict],
                  quant: Optional[str] = None, rows: int = 16
                  ) -> List[torch.Tensor]:
    """Logits (n, V) at each output position of each item, ``rows`` items
    a block. The model scans the call's pad tokens (id 0) between prompt
    and output, as it was served: the prompt padded to ``padded``."""
    dev = weights["emb"]["tok"].device
    out: List[torch.Tensor] = []
    for b0 in range(0, len(items), rows):
        block = items[b0:b0 + rows]
        seqs, reads = [], []
        for it in block:
            p, o, pad = it["prompt"], it["outputs"], it["padded"]
            seqs.append(list(p) + [0] * (pad - len(p)) + list(o[:-1]))
            reads.append([len(p) - 1] + [pad + j - 1
                                         for j in range(1, len(o))])
        T = max(len(s) for s in seqs)
        toks = torch.zeros((len(seqs), T), dtype=torch.long, device=dev)
        for i, s in enumerate(seqs):
            toks[i, :len(s)] = torch.tensor(s, device=dev)
        h = rwkv6_hidden(cfg, weights, toks, quant)
        for i, r in enumerate(reads):
            out.append(head(cfg, weights, h[i, r], quant))
        del h
    return out


def matmul_params(cfg: dict) -> int:
    """Weights that one token multiplies through: embedding lookups cost
    no FLOPs, the LM head does."""
    d, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    r, f = cfg["decay_lora_rank"], cfg["intermediate_size"]
    # w_r, w_k, w_v, w_g, w_o; the decay LoRA; w_ck, w_cv, w_cr
    layer = 5 * d * d + 2 * d * r + 2 * d * f + d * d
    return L * layer + d * V


def token_flops(cfg: dict, context: int) -> float:
    """2 per multiplied weight, plus per layer ~6 x d x head size for the
    WKV state's update and read, whatever the context."""
    return (2.0 * matmul_params(cfg)
            + cfg["num_hidden_layers"] * 6.0 * cfg["hidden_size"]
            * cfg["head_size"])


def prompt_flops(cfg: dict, prompt_len: int) -> float:
    return prompt_len * token_flops(cfg, 0)
