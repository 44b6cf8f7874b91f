"""Small cells for the benchmark's CPU tests: the two families at a few
layers of small width, float32, and the two mixes cut to lengths a CPU
serves in seconds, each with the comparison (numbers compared and their
limits) and the engine settings of a committed cell."""
from __future__ import annotations

import copy
import json

from perfbench.harness import spec

MOE = dict(name="tiny-moe", source="test", arch="granite-moe-1b-a400m",
           family="moe", dtype="float32", num_hidden_layers=2,
           hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
           head_dim=16, intermediate_size=32, num_local_experts=4,
           num_experts_per_tok=2, vocab_size=4096, rope_theta=10000.0,
           tie_word_embeddings=True, hidden_act="silu", rms_norm_eps=1e-6,
           capacity_factor=2.0,
           init=dict(embedding_std=0.08, residual_out_scale=0.5), reduced=[])
RWKV = dict(name="tiny-rwkv", source="test", arch="rwkv6-3b", family="ssm",
            dtype="float32", num_hidden_layers=6, hidden_size=128,
            head_size=32, intermediate_size=256, decay_lora_rank=16,
            vocab_size=4096, tie_word_embeddings=False, rms_norm_eps=1e-5,
            prompt_bucket=32,
            init=dict(embedding_std=1.0, residual_out_scale=0.5), reduced=[])


def mix(name: str) -> dict:
    m = json.loads((spec.BENCH_DIR / "traffic" / f"{name}.json").read_text())
    m = copy.deepcopy(m)
    m["prompt"].update(min=4, max=40)
    m["output"].update(min=4, max=24)
    if m["kind"] == "open_loop":
        m.update(prompt=dict(m["prompt"], median=12), rate_rps=6.0,
                 output=dict(m["output"], median=10), ramp_s=0.5,
                 drain_s=30.0)
        m["prompt"]["median"] = 12
    else:
        m.update(queue=4, ramp_s=0.5)
    m["warm_rows"] = 2
    # more greedy requests than the real mixes send: a short run on the
    # CPU still compares some
    shares = [0.4, 0.3, 0.3]
    m["contracts"] = [dict(c, share=x) for c, x in zip(m["contracts"],
                                                       shares)]
    return m


def cell(config: dict, traffic: str, like: str, slots: int = 6
         ) -> spec.Cell:
    """A small cell of ``config`` and the cut mix ``traffic``, with the
    committed cell ``like``'s decision plane, numbers compared and
    limits; fewer requests and greedy tokens compared, as a short run on
    the CPU serves fewer."""
    committed = json.loads((spec.BENCH_DIR / "workloads" /
                            f"{like}.json").read_text())
    e = committed["engine"]
    settings = {"engine": {"slots": slots, "max_seq_len": 128,
                           "algorithm": e["algorithm"],
                           "sampler_mode": e["sampler_mode"],
                           "samplers": e["samplers"], "cache": e["cache"],
                           "prompt_chunk": 0, "overlap": e["overlap"]},
                "check": {"greedy": 4, "sampled": 4, "min_requests": 2,
                          "min_greedy_tokens": 1,
                          "compare": list(committed["check"]["compare"])},
                "limits": dict(committed["limits"]),
                "trace": {"profile_s": 1.0}}
    return spec.Cell(name=f"{config['name']}.{traffic}", chips=1,
                     config=dict(config), traffic=mix(traffic),
                     settings=settings, end_to_end=[], per_layer=[],
                     decision_kernels=[])
