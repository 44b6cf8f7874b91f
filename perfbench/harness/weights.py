"""Seeded weights in the program's parameter layout, made on the device.

Normal weights scaled 1/sqrt(fan-in); the projections that write the
residual stream (attention's and the MoE's outputs, RWKV-6's time-mix
output and channel-mix value) scaled by ``init.residual_out_scale``
more, 1/sqrt(2 x layers) as in GPT-2's initialisation, and the embedding
at ``init.embedding_std``: random, but not chaotic, so that a float32
reference and a bfloat16 program agree to rounding at full depth.

The benchmark makes the weights itself from the run's seed and hands the
same tensors to the program and to the plain reference. Every normal
leaf of one dtype is a view of one buffer filled by one ``normal_`` call
of a ``torch.Generator`` on the device, then scaled in place; the norms
are ones. Layout (weights ``(in, out)``, per-layer leaves stacked on a
leading layer axis): the tree ``repro_torch.models.model.Model`` serves.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

# (path, shape, kind, mean, scale, dtype key): kind "normal" or "ones";
# dtype key "model" (the config's dtype) or "float32"
Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str, float, float, str]


def _lin(path, L, i, o, scale=None) -> Leaf:
    return (path, (L, i, o), "normal", 0.0,
            scale if scale is not None else 1.0 / math.sqrt(i), "model")


def leaves(cfg: dict) -> List[Leaf]:
    """Every parameter leaf of the configuration ``cfg`` (a config file)."""
    d, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    init = cfg["init"]
    res = init["residual_out_scale"]        # on the projections that
    #                                         write the residual stream
    out: List[Leaf] = [(("emb", "tok"), (V, d), "normal", 0.0,
                        init["embedding_std"], "model")]
    if not cfg["tie_word_embeddings"]:
        out.append((("emb", "head"), (d, V), "normal", 0.0,
                    1.0 / math.sqrt(d), "model"))
    ones = lambda path, shape: (path, shape, "ones", 0.0, 0.0, "model")
    out += [ones(("stack", "ln1"), (L, d)), ones(("stack", "ln2"), (L, d)),
            ones(("stack", "final_ln"), (d,))]
    if cfg["family"] == "moe":
        hd, nh, nkv = (cfg["head_dim"], cfg["num_attention_heads"],
                       cfg["num_key_value_heads"])
        E, fe = cfg["num_local_experts"], cfg["intermediate_size"]
        a = ("stack", "attn")
        out += [_lin(a + ("w_q",), L, d, nh * hd),
                _lin(a + ("w_k",), L, d, nkv * hd),
                _lin(a + ("w_v",), L, d, nkv * hd),
                _lin(a + ("w_o",), L, nh * hd, d, res / math.sqrt(nh * hd))]
        m = ("stack", "moe")
        out += [(m + ("router",), (L, d, E), "normal", 0.0,
                 1.0 / math.sqrt(d), "float32"),
                (m + ("w_gate",), (L, E, d, fe), "normal", 0.0,
                 1.0 / math.sqrt(d), "model"),
                (m + ("w_up",), (L, E, d, fe), "normal", 0.0,
                 1.0 / math.sqrt(d), "model"),
                (m + ("w_down",), (L, E, fe, d), "normal", 0.0,
                 res / math.sqrt(fe), "model")]
    elif cfg["family"] == "ssm":
        r, f = cfg["decay_lora_rank"], cfg["intermediate_size"]
        p = ("stack", "layers")
        vec = lambda name, shape, mean, noise: (
            p + (name,), (L,) + shape, "normal", mean, noise, "model")
        out += [vec("mu", (5, d), 0.5, 0.1)]
        out += [_lin(p + (w,), L, d, d) for w in ("w_r", "w_k", "w_v", "w_g")]
        out += [_lin(p + ("w_o",), L, d, d, res / math.sqrt(d))]
        out += [vec("w0", (d,), -6.0, 0.3),
                _lin(p + ("lora_a",), L, d, r, 0.01),
                _lin(p + ("lora_b",), L, r, d, 0.01),
                vec("u", (d,), 0.0, 0.3),
                ones(p + ("ln_x",), (L, d)),
                vec("mu_c", (2, d), 0.5, 0.1),
                _lin(p + ("w_ck",), L, d, f),
                _lin(p + ("w_cv",), L, f, d, res / math.sqrt(f)),
                _lin(p + ("w_cr",), L, d, d)]
    else:
        raise ValueError(f"no weights for family {cfg['family']!r}")
    return out


def make(cfg: dict, seed: int, device) -> Dict:
    """The parameter tree of ``cfg`` from ``seed``, on ``device``."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    model_dt = _DTYPES[cfg["dtype"]]
    dts = {"model": model_dt, "float32": torch.float32}
    tree: Dict = {}
    for key in ("model", "float32"):
        mine = [lf for lf in leaves(cfg) if lf[5] == key]
        sizes = [math.prod(lf[1]) for lf in mine if lf[2] == "normal"]
        buf = torch.empty(sum(sizes), dtype=dts[key], device=device)
        if sizes:
            buf.normal_(generator=g)
        off = 0
        for path, shape, kind, mean, scale, _ in mine:
            if kind == "ones":
                t = torch.ones(shape, dtype=dts[key], device=device)
            else:
                n = math.prod(shape)
                t = buf[off:off + n].view(shape)
                off += n
                t.mul_(scale)
                if mean:
                    t.add_(mean)
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
    return tree
