"""The plain reference of the benchmark: float32 forwards of its
configurations, one file a model family (``<family>.py``, found by the
configuration's ``family``; what they share is :mod:`.models`), and the
decision plane's semantics (:mod:`.decision`). Plain PyTorch; it imports
nothing of the program and nothing of JAX, and works everything out from
the configuration file, the weights the benchmark made and the tokens."""
from __future__ import annotations

from typing import List, Optional

import torch

from perfbench.harness import spec

from . import decision


def no_tf32() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _family(cfg: dict):
    return spec.load_family("reference", cfg["family"])


def check_config(cfg: dict) -> None:
    """Refuse a configuration whose stated semantics the family's
    reference does not compute."""
    _family(cfg).check_config(cfg)


def output_logits(cfg: dict, weights: dict, items: List[dict],
                  quant: Optional[str] = None, rows: int = 16
                  ) -> List[torch.Tensor]:
    """Logits (n, V) at each output position of each served request, by
    the family's ``reference/<family>.py``.

    ``items``: dicts with ``prompt`` and ``outputs`` (token lists) and,
    for a recurrent model, ``padded``: the length its admission call
    padded the prompt to. The model reads the prompt, then each served
    token but the last; output j's logits are read after the prompt
    (j = 0) or after served token j - 1. A recurrent model scans the
    call's pad tokens (id 0) between prompt and output, as it was served,
    ``rows`` items at a time.
    """
    return _family(cfg).output_logits(cfg, weights, items, quant, rows)


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
