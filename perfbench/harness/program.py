"""The one seam between the benchmark and the program under test
(``repro_torch``): its model configuration built from a configuration
file (by the family's ``families/<family>.py``), and its serving engine
built from a cell's settings."""
from __future__ import annotations

import torch

from . import spec


def model_config(cfg: dict):
    """``repro_torch.config.ModelConfig`` of a configuration file, by its
    family's ``families/<family>.py``."""
    return spec.load_family("program", cfg["family"]).model_config(cfg)


def model_kwargs(cfg: dict) -> dict:
    """The ``ModelConfig`` fields every family reads the same way."""
    return dict(name=cfg["name"], num_layers=cfg["num_hidden_layers"],
                d_model=cfg["hidden_size"], d_ff=cfg["intermediate_size"],
                vocab_size=cfg["vocab_size"], rmsnorm_eps=cfg["rms_norm_eps"],
                tie_embeddings=cfg["tie_word_embeddings"], dtype=cfg["dtype"],
                source=cfg["source"])


def build_engine(cell, weights, seed: int, device, trace: bool):
    """The cell's ``Engine`` over ``weights``, by the program's own
    ``launch.serve.build_engine``; the flight-recorder tracer is on only
    in a traced run."""
    from repro_torch.launch.serve import build_engine as build
    from repro_torch.obs import StepTracer, Telemetry
    s = cell.settings["engine"]
    tel = Telemetry(tracer=StepTracer(capacity=1 << 18, enabled=True)) \
        if trace else None
    eng = build(model_config(cell.config), reduced=False,
                algorithm=s["algorithm"], batch=s["slots"],
                max_seq=s["max_seq_len"], seed=seed % (2 ** 31),
                overlap=s["overlap"], prompt_chunk=s["prompt_chunk"],
                cache=s["cache"], samplers=s["samplers"],
                sampler_mode=s["sampler_mode"], telemetry=tel,
                device=torch.device(device), params=weights)
    bucket = cell.config.get("prompt_bucket")
    if bucket is not None and eng.ecfg.prompt_bucket != bucket:
        raise ValueError(f"the engine pads prompts to {eng.ecfg.prompt_bucket}"
                         f", the configuration states {bucket}")
    return eng


def request(spec, arrival: float, request_id: int):
    """A ``repro_torch`` request of a traffic spec: no EOS, so its output
    length is the one the traffic drew."""
    from repro_torch.config import SamplingConfig
    from repro_torch.engine.request import Request
    return Request(request_id=request_id, prompt=spec.prompt.tolist(),
                   max_new_tokens=spec.max_new,
                   sampling=SamplingConfig(**spec.contract),
                   eos_token=None, arrival_time=arrival)
