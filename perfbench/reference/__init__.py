"""The plain reference of the benchmark: float32 forwards of its
configurations (:mod:`.models`) and the decision plane's semantics
(:mod:`.decision`). Plain PyTorch; it imports nothing of the program and
nothing of JAX, and works everything out from the configuration file,
the weights the benchmark made and the tokens."""
from __future__ import annotations

from typing import List, Optional

import torch

from . import decision, models


def no_tf32() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def output_logits(cfg: dict, weights: dict, items: List[dict],
                  quant: Optional[str] = None, rows: int = 16
                  ) -> List[torch.Tensor]:
    """Logits (n, V) at each output position of each served request.

    ``items``: dicts with ``prompt`` and ``outputs`` (token lists) and,
    for a recurrent model, ``padded``: the length its admission call
    padded the prompt to. The model reads the prompt, then each served
    token but the last; output j's logits are read after the prompt
    (j = 0) or after served token j - 1. A recurrent model scans the
    call's pad tokens (id 0) between prompt and output, as it was served.
    """
    dev = weights["emb"]["tok"].device
    out: List[torch.Tensor] = []
    if cfg["family"] == "ssm":
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
            h = models.rwkv6_hidden(cfg, weights, toks, quant)
            for i, r in enumerate(reads):
                out.append(models.head(cfg, weights, h[i, r], quant))
            del h
        return out
    for it in items:
        p, o = it["prompt"], it["outputs"]
        toks = torch.tensor(list(p) + list(o[:-1]), dtype=torch.long,
                            device=dev)
        h = models.moe_hidden(cfg, weights, toks, quant)
        out.append(models.head(cfg, weights, h[len(p) - 1:], quant))
    return out


def request_readings(cfg: dict, weights: dict, items: List[dict],
                     control: bool = False, seed: int = 0) -> dict:
    """The widest and the mean gap (:func:`decision.summary`) over the
    items' tokens (``gap``), their greedy ones (``greedy_gap``) and their
    sampled ones (``kept_gap``); with ``control`` also the fp8
    control's at the same positions (``..._control``), its draws made
    with uniforms from ``seed``."""
    ref = output_logits(cfg, weights, items)
    ctl = output_logits(cfg, weights, items, quant="fp8") if control \
        else [None] * len(items)
    gaps: dict = {}
    for i, (it, r, c) in enumerate(zip(items, ref, ctl)):
        dev = r.device
        g = torch.Generator(device=dev)
        g.manual_seed((int(seed) + i) % (2 ** 63))
        u = torch.rand(r.shape[0], generator=g, device=dev)
        one = decision.readings(
            r, torch.tensor(it["outputs"], device=dev),
            torch.tensor(it["prompt"], device=dev), it["contract"],
            it["greedy"], c, u)
        for k, v in one.items():
            gaps.setdefault(k, []).append(v)
    out = {}
    for name, kinds in (("gap", ("greedy", "kept")),
                        ("greedy_gap", ("greedy",)), ("kept_gap", ("kept",))):
        for suffix in ("", "_control") if control else ("",):
            one = decision.summary(
                [g for k in kinds for g in gaps.get(k + suffix, [])], name)
            out.update({k + suffix: v for k, v in one.items()})
    return out
