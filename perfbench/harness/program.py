"""The one seam between the benchmark and the program under test
(``repro_torch``): its model configuration built from a configuration
file, and its serving engine built from a cell's settings."""
from __future__ import annotations

import torch


def model_config(cfg: dict):
    """``repro_torch.config.ModelConfig`` of a configuration file."""
    from repro_torch.config import ModelConfig, MoEConfig, SSMConfig
    d = cfg["hidden_size"]
    kw = dict(name=cfg["name"], family=cfg["family"],
              num_layers=cfg["num_hidden_layers"], d_model=d,
              d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
              rmsnorm_eps=cfg["rms_norm_eps"],
              tie_embeddings=cfg["tie_word_embeddings"], dtype=cfg["dtype"],
              source=cfg["source"])
    if cfg["family"] == "moe":
        kw.update(num_heads=cfg["num_attention_heads"],
                  num_kv_heads=cfg["num_key_value_heads"],
                  head_dim=cfg["head_dim"], rope_theta=cfg["rope_theta"],
                  act=cfg["hidden_act"],
                  moe=MoEConfig(num_experts=cfg["num_local_experts"],
                                top_k=cfg["num_experts_per_tok"],
                                d_ff_expert=cfg["intermediate_size"],
                                capacity_factor=cfg["capacity_factor"]))
    elif cfg["family"] == "ssm":
        hs = cfg["head_size"]
        kw.update(num_heads=d // hs, num_kv_heads=d // hs, head_dim=hs,
                  act="relu_sq",
                  ssm=SSMConfig(kind="rwkv6", rwkv_head_size=hs,
                                decay_lora_rank=cfg["decay_lora_rank"]))
    else:
        raise ValueError(f"no program configuration for {cfg['family']!r}")
    return ModelConfig(**kw)


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
