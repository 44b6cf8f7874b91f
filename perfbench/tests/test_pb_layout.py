"""Moving each family's model code into files found by name moved no
weight and no FLOP: the seeded weights, the weights' layout in fill order
and the FLOPs a token of both benchmark configurations equal the values
recorded on the tree before the move (the harness that branched on
``family``), written here as literals."""
import hashlib
import json

import pytest
import torch

from perfbench.frozen import arith
from perfbench.harness import spec, weights as W
from perfbench.tests import tiny

#: SHA-256 of ``weights.make(cfg, 1, "cpu")`` (``_tree_hash``)
TREE_SHA256 = {
    "moe": "1cf9af5ee989b06f2a512740e084ebe46627de8de87cd828ef65fd7952cf36ec",
    "ssm": "f8c8fb4b457767bb8031d84770f0e5941c271b6162e2eebb852080f8558972da",
}

#: ``weights.leaves`` of the two configuration files, each path joined
#: by "/": (path, shape, kind, mean, scale, dtype key)
GRANITE_LEAVES = [
    ("emb/tok", (49155, 1024), "normal", 0.0, 0.02, "model"),
    ("stack/ln1", (24, 1024), "ones", 0.0, 0.0, "model"),
    ("stack/ln2", (24, 1024), "ones", 0.0, 0.0, "model"),
    ("stack/final_ln", (1024,), "ones", 0.0, 0.0, "model"),
    ("stack/attn/w_q", (24, 1024, 1024), "normal", 0.0, 0.03125, "model"),
    ("stack/attn/w_k", (24, 1024, 512), "normal", 0.0, 0.03125, "model"),
    ("stack/attn/w_v", (24, 1024, 512), "normal", 0.0, 0.03125, "model"),
    ("stack/attn/w_o", (24, 1024, 1024), "normal", 0.0, 0.0045105625, "model"),
    ("stack/moe/router", (24, 1024, 32), "normal", 0.0, 0.03125, "float32"),
    ("stack/moe/w_gate", (24, 32, 1024, 512), "normal", 0.0, 0.03125, "model"),
    ("stack/moe/w_up", (24, 32, 1024, 512), "normal", 0.0, 0.03125, "model"),
    ("stack/moe/w_down", (24, 32, 512, 1024), "normal", 0.0,
     0.006378898661431493, "model"),
]

RWKV6_LEAVES = [
    ("emb/tok", (65536, 2560), "normal", 0.0, 1.0, "model"),
    ("emb/head", (2560, 65536), "normal", 0.0, 0.01976423537605237, "model"),
    ("stack/ln1", (32, 2560), "ones", 0.0, 0.0, "model"),
    ("stack/ln2", (32, 2560), "ones", 0.0, 0.0, "model"),
    ("stack/final_ln", (2560,), "ones", 0.0, 0.0, "model"),
    ("stack/layers/mu", (32, 5, 2560), "normal", 0.5, 0.1, "model"),
    ("stack/layers/w_r", (32, 2560, 2560), "normal", 0.0,
     0.01976423537605237, "model"),
    ("stack/layers/w_k", (32, 2560, 2560), "normal", 0.0,
     0.01976423537605237, "model"),
    ("stack/layers/w_v", (32, 2560, 2560), "normal", 0.0,
     0.01976423537605237, "model"),
    ("stack/layers/w_g", (32, 2560, 2560), "normal", 0.0,
     0.01976423537605237, "model"),
    ("stack/layers/w_o", (32, 2560, 2560), "normal", 0.0,
     0.0024705294220065464, "model"),
    ("stack/layers/w0", (32, 2560), "normal", -6.0, 0.3, "model"),
    ("stack/layers/lora_a", (32, 2560, 64), "normal", 0.0, 0.01, "model"),
    ("stack/layers/lora_b", (32, 64, 2560), "normal", 0.0, 0.01, "model"),
    ("stack/layers/u", (32, 2560), "normal", 0.0, 0.3, "model"),
    ("stack/layers/ln_x", (32, 2560), "ones", 0.0, 0.0, "model"),
    ("stack/layers/mu_c", (32, 2, 2560), "normal", 0.5, 0.1, "model"),
    ("stack/layers/w_ck", (32, 2560, 8960), "normal", 0.0,
     0.01976423537605237, "model"),
    ("stack/layers/w_cv", (32, 8960, 2560), "normal", 0.0,
     0.001320553523013307, "model"),
    ("stack/layers/w_cr", (32, 2560, 2560), "normal", 0.0,
     0.01976423537605237, "model"),
]

#: {config: (token_flops(cfg, 1000), prompt_flops(cfg, 77))}
FLOPS = {
    "granite-moe-1b-a400m": (955521024.0, 66300917760.0),
    "rwkv6-3b": (5840568320.0, 449723760640.0),
}
LEAVES = {"granite-moe-1b-a400m": GRANITE_LEAVES, "rwkv6-3b": RWKV6_LEAVES}


def _config(name):
    return json.loads((spec.BENCH_DIR / "configs" / f"{name}.json")
                      .read_text())


def _tree_hash(tree) -> str:
    """Paths in sorted order, each with its dtype, shape and bytes."""
    flat = []

    def walk(node, path):
        for k in sorted(node):
            if isinstance(node[k], dict):
                walk(node[k], path + (k,))
            else:
                flat.append(("/".join(path + (k,)), node[k]))
    walk(tree, ())
    h = hashlib.sha256()
    for name, t in flat:
        h.update(name.encode())
        h.update(str(t.dtype).encode())
        h.update(repr(tuple(t.shape)).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("cfg", [tiny.MOE, tiny.RWKV], ids=["moe", "ssm"])
def test_seeded_weights_are_the_recorded_ones(cfg):
    assert _tree_hash(W.make(cfg, 1, "cpu")) == TREE_SHA256[cfg["family"]]


@pytest.mark.parametrize("name", sorted(LEAVES))
def test_layout_and_fill_order_are_the_recorded_ones(name):
    got = [("/".join(path), *rest) for path, *rest in W.leaves(_config(name))]
    assert got == LEAVES[name]


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_flops_are_the_recorded_ones(name):
    cfg = _config(name)
    assert (arith.token_flops(cfg, 1000), arith.prompt_flops(cfg, 77)) == \
        FLOPS[name]
