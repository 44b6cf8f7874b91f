"""What every family's plain forward (``reference/<family>.py``) shares,
in float32.

Each family's forward goes straight from the equations: no cache, no
kernel of the program. It reads the weights the benchmark made (the
program's layout: weights ``(in, out)``, per-layer leaves stacked on a
leading layer axis) and widens each layer's leaves to float32 as it goes
(:func:`_layer`). TF32 is switched off by the caller
(:func:`reference.no_tf32`).

``quant="fp8"`` is the control: every weight and every activation that
enters a matrix product is rounded to float8 e4m3 (weights per output
column, activations per token, each scaled by its largest magnitude),
the router excepted, as an fp8 serving path would compute it.
"""
from __future__ import annotations

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


def _shift(x):
    """Each token's predecessor (zeros before the first). x (B, T, d)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def head(cfg: dict, w: dict, h: torch.Tensor,
         quant: Optional[str] = None) -> torch.Tensor:
    """Logits (..., V) of final hidden states."""
    emb = w["emb"]
    wh = emb["tok"].T if cfg["tie_word_embeddings"] else emb["head"]
    return Mm(quant)(h, wh)
