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
leading layer axis): the tree ``repro_torch.models.model.Model`` serves,
each family's listed by its ``families/<family>.py``. The list's order
is the fill order, so it is the weights: a family never reorders them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from . import spec

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

# (path, shape, kind, mean, scale, dtype key): kind "normal" or "ones";
# dtype key "model" (the config's dtype) or "float32"
Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str, float, float, str]


def lin(path, L, i, o, scale=None) -> Leaf:
    """A stack of L (i, o) weights, normal at 1/sqrt(i) unless ``scale``."""
    return (path, (L, i, o), "normal", 0.0,
            scale if scale is not None else 1.0 / math.sqrt(i), "model")


def ones(path, shape) -> Leaf:
    return (path, shape, "ones", 0.0, 0.0, "model")


def base(cfg: dict) -> List[Leaf]:
    """The leaves every family's layout starts with: the embedding, an
    untied head, the two per-layer norms and the final norm."""
    d, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    out: List[Leaf] = [(("emb", "tok"), (V, d), "normal", 0.0,
                        cfg["init"]["embedding_std"], "model")]
    if not cfg["tie_word_embeddings"]:
        out.append((("emb", "head"), (d, V), "normal", 0.0,
                    1.0 / math.sqrt(d), "model"))
    return out + [ones(("stack", "ln1"), (L, d)),
                  ones(("stack", "ln2"), (L, d)),
                  ones(("stack", "final_ln"), (d,))]


def leaves(cfg: dict) -> List[Leaf]:
    """Every parameter leaf of the configuration ``cfg`` (a config file),
    in fill order, by its family's ``families/<family>.py``."""
    return spec.load_family("program", cfg["family"]).leaves(cfg)


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
