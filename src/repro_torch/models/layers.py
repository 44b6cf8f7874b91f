"""Shared neural-net building blocks: norms, RoPE, MLPs, embeddings.

Parameters are plain dicts of tensors in the reference package's layout
(weights ``(in, out)``); functions consume them. Matmuls of bf16 weights
accumulate in float32 (cuBLAS and the CPU kernels do) and round to the
activation dtype, as the reference's ``preferred_element_type`` einsums
do; the LM head returns float32 logits.

Under a mesh the MLP and the embedding are Megatron's: the MLP is
column-parallel in ``w_gate``/``w_up`` and row-parallel in ``w_down``
(:func:`row_parallel`: the rank's partial product in float32, one
``psum`` over the model axes, then rounded), and the embedding is
vocab-parallel (the rank's rows answer its ids, the others give 0, one
``psum``). A leaf ``param_spec`` left whole runs as without a mesh.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import dist

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# init helpers (the port's own seeded init, for standalone runs)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal init scaled by 1/sqrt(in_dim); ``shape`` ends in (in, out)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def init_embeddings(gen: torch.Generator, cfg, device):
    """Token embeddings (and an untied LM head), the reference's layout."""
    dt = torch_dtype(cfg.dtype)
    p = {"tok": dense_init(gen, (cfg.vocab_size, cfg.d_model), dt, device,
                           scale=0.02)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt,
                               device)
    return p


def init_mlp(gen: torch.Generator, cfg, device, d_ff: int = 0,
             stacked: int = 0):
    """Seeded MLP weights in the reference's layout (``(in, out)``, a
    leading L axis when ``stacked``)."""
    dt = torch_dtype(cfg.dtype)
    d, f = cfg.d_model, d_ff or cfg.d_ff
    pre = (stacked,) if stacked else ()
    mk = lambda i, o: dense_init(gen, pre + (i, o), dt, device)
    p = {"w_up": mk(d, f), "w_down": mk(f, d)}
    if cfg.act == "silu":
        p["w_gate"] = mk(d, f)
    return p


def matmul(x, w):
    """x @ w, f32 accumulation, result in x's dtype."""
    return torch.matmul(x, w).to(x.dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device="cpu"):
    """Inverse frequencies for rotary embeddings (half-dim)."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_tables(positions, head_dim: int, theta: float):
    """(cos, sin) of the rotary angles, each (..., S, 1, hd/2); computed
    once per forward and shared by every layer's q and k."""
    inv_freq = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., :, None].float() * inv_freq   # (..., S, hd/2)
    return (torch.cos(angles)[..., :, None, :],
            torch.sin(angles)[..., :, None, :])


def apply_rope(x, positions, theta: float, tables=None):
    """Rotate pairs. x: (..., seq, heads, head_dim); positions: (..., seq).
    ``tables``: this forward's :func:`rope_tables`, if already made."""
    if theta <= 0:
        return x
    cos, sin = tables if tables is not None else \
        rope_tables(positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------


def row_parallel(h, w, dtype):
    """The row-parallel product ``h @ w`` of a whole ``w`` split by rows
    over the model axes: ``h`` the rank's block of columns, ``w`` its
    block of rows. The partial products are summed in float32 by one
    ``psum`` and rounded to ``dtype`` once, as the whole product is."""
    return dist.psum_model(torch.matmul(h.float(), w.float())).to(dtype)


def apply_mlp(params, x, act: str, d_ff: int = 0):
    """The MLP; ``d_ff`` is the config's hidden width, which tells a
    column/row-parallel block of the weights (its width d_ff/t) from
    whole weights (0: whole)."""
    split = bool(d_ff) and dist.split_block(params["w_up"].shape[-1], d_ff)
    if act == "silu":
        gate = matmul(x, params["w_gate"])
        up = matmul(x, params["w_up"])
        h = F.silu(gate.float()).to(x.dtype) * up
    elif act == "gelu":
        h = F.gelu(matmul(x, params["w_up"]).float(),
                   approximate="tanh").to(x.dtype)
    else:
        raise ValueError(f"unknown act {act!r}")
    if split:
        return row_parallel(h, params["w_down"], x.dtype)
    return torch.matmul(h, params["w_down"])


# ---------------------------------------------------------------------------
# embeddings / LM head
# ---------------------------------------------------------------------------


def embed(params, tokens, vocab: int = 0):
    """Rows of ``params["tok"]`` for ``tokens``. With ``vocab`` (the
    config's V) a table of V/t rows is the rank's block of a vocab-parallel
    embedding: ids in its rows are looked up, the others give 0, and one
    ``psum`` over the model axes completes every row (a sum of one value
    and zeros, so exact)."""
    tok = params["tok"]
    if vocab and dist.split_block(tok.shape[0], vocab):
        n = tok.shape[0]
        local = tokens.reshape(-1).long() - dist.tp_rank() * n
        mine = (local >= 0) & (local < n)
        rows = tok.index_select(0, torch.where(mine, local, 0))
        rows = torch.where(mine[:, None], rows, torch.zeros_like(rows))
        return dist.psum_model(rows).reshape(*tokens.shape, tok.shape[-1])
    return tok.index_select(0, tokens.reshape(-1)).reshape(
        *tokens.shape, tok.shape[-1])


def lm_head(params, x):
    """Logits in float32 (bf16 products are exact in f32; the sum runs in
    f32), so 49k logits are not rounded to bf16's three digits."""
    w = params.get("head")
    if w is None:
        w = params["tok"].T
    return torch.matmul(x.float(), w.float())
