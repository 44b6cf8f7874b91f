"""Granite 4.0-H on the port (``config.HybridMoEConfig``, family
``hybrid_moe``): a typed stack of Mamba2 and NoPE attention layers, each
followed by a MoE with a shared expert, and Granite's multipliers.

At a tiny size on the CPU, float32: the port's prefill then decode
through its cache against the benchmark's plain reference
(``perfbench/reference/granite_hybrid.py``) on the benchmark's seeded
weights, which a bfloat16 program fails; a row's logits whatever the
rows padded beside it in its prefill; the reference's quadratic Mamba2
against a scan; and the engine's ``mamba`` spans and cache gauges."""
import json
import math

import pytest
import torch

from perfbench import reference as R
from perfbench.harness import program, spec, weights as W
from perfbench.reference import granite_hybrid as G
from repro_torch.config import HybridMoEConfig
from repro_torch.launch.serve import build_engine
from repro_torch.models.model import Model
from repro_torch.models.transformer import cache_bytes
from repro_torch.obs import StepTracer, Telemetry

CPU = torch.device("cpu")

#: a configuration file of the benchmark's family at a tiny size: d 64,
#: four layers (mamba, attention, mamba, mamba), Mamba2 heads 4 of 16, N 8,
#: 8 experts of top 2 and a shared expert of 32, V 256, every multiplier
#: not 1; branches scaled so the tied head's copy of the input token does
#: not dominate the logits (as the benchmark's file does)
TINY = dict(
    name="tiny-granite-hybrid", source="test", family="granite_hybrid",
    dtype="float32", num_hidden_layers=4,
    layer_types=["mamba", "attention", "mamba", "mamba"], hidden_size=64,
    num_attention_heads=4, num_key_value_heads=2, intermediate_size=32,
    shared_intermediate_size=32, num_local_experts=8, num_experts_per_tok=2,
    vocab_size=256, mamba_expand=1, mamba_n_heads=4, mamba_d_head=16,
    mamba_d_state=8, mamba_d_conv=4, mamba_n_groups=1, mamba_conv_bias=True,
    mamba_proj_bias=False, hidden_act="silu", rms_norm_eps=1e-5,
    tie_word_embeddings=True, capacity_factor=4.0, embedding_multiplier=12.0,
    attention_multiplier=0.125, residual_multiplier=0.22,
    logits_scaling=16.0, position_embedding_type="nope",
    init=dict(embedding_std=0.16, residual_out_scale=30.0,
              a_log=[math.log(4.0), 0.5], dt_bias=[-4.6, 1.0]),
    reduced=[])

#: the tolerance, in units of the reference logits' spread (their std):
#: float32 on both sides differs only by the order of its sums (a scan
#: against SSD's quadratic form, capacity buckets against every expert
#: on every token), ~1e-6 of the spread; a bfloat16 program's rounding
#: is ~2e-2 of it
TOL = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    """The shapes are tiny: one intra-op thread a test, so that the
    suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _serve(cfg, prompts, n_out, seed=7):
    """Greedy logits (n_out, V) of each prompt, prefilled together
    (right-padded, their lengths passed) and decoded through the cache."""
    w = W.make(cfg, seed, "cpu")
    m = Model(program.model_config(cfg))
    P = max(len(p) for p in prompts)
    toks = torch.zeros((len(prompts), P), dtype=torch.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    cache = m.init_cache(len(prompts), 64, device=CPU)
    lg, cache = m.prefill(w, {"tokens": toks}, cache, true_lens=lens)
    out = [lg]
    for _ in range(n_out - 1):
        lg, cache = m.decode_step(w, out[-1].argmax(-1).int(), cache)
        out.append(lg)
    return w, torch.stack(out, 1).float()


def _prompts():
    g = torch.Generator().manual_seed(3)
    return [torch.randint(1, 256, (n,), generator=g).tolist()
            for n in (11, 29)]


def _err(cfg, prompts):
    """The largest |program - reference| over every row's logits, in
    units of the reference's spread."""
    w, got = _serve(cfg, prompts, 6)
    ref_cfg = dict(cfg, dtype="float32")
    items = [dict(prompt=p, outputs=got[i].argmax(-1).tolist())
             for i, p in enumerate(prompts)]
    ref = R.output_logits(ref_cfg, w, items)
    return max(((got[i] - r).abs().max() / r.std()).item()
               for i, r in enumerate(ref))


def test_prefill_then_decode_matches_the_reference():
    assert _err(TINY, _prompts()) < TOL


def test_train_forward_matches_the_reference():
    """The whole sequence at once (train mode, each layer checkpointed):
    the logits at every position."""
    w = W.make(TINY, 7, "cpu")
    toks = _prompts()[1]
    m = Model(program.model_config(TINY))
    got, _ = m.train_logits(w, {"tokens": torch.tensor([toks])})
    ref, = R.output_logits(TINY, w, [dict(prompt=toks[:1],
                                          outputs=toks[1:] + [0])])
    assert ((got[0] - ref).abs().max() / ref.std()).item() < TOL


def test_bfloat16_program_fails_the_tolerance():
    assert _err(dict(TINY, dtype="bfloat16"), _prompts()) > TOL


def test_a_rows_logits_do_not_depend_on_its_admission_partners():
    """A short prompt alone, and padded beside a prompt 18 tokens longer
    in one prefill: its state is held at its own length, so its logits
    through prefill and decode are the same."""
    short, long = _prompts()
    _, alone = _serve(TINY, [short], 6)
    _, beside = _serve(TINY, [short, long], 6)
    spread = alone[0].std()
    assert ((alone[0] - beside[0]).abs().max() / spread).item() < 1e-5


def test_reference_quadratic_mamba2_equals_a_scan():
    g = torch.Generator().manual_seed(0)
    T, H, P, N = 23, 3, 5, 4
    x = torch.randn(T, H, P, generator=g)
    dt = torch.rand(T, H, generator=g) * 0.5
    la = -torch.rand(T, H, generator=g) * dt
    Bm, Cm = torch.randn(T, N, generator=g), torch.randn(T, N, generator=g)
    torch.testing.assert_close(G.ssd(x, dt, la, Bm, Cm),
                               G.scan(x, dt, la, Bm, Cm),
                               rtol=1e-5, atol=1e-5)


def test_config_counts_its_parameters_and_reduces_to_both_kinds():
    cfg = program.model_config(TINY)
    params = Model(cfg).init(seed=0, device=CPU)
    n = sum(t.numel() for t in torch.utils._pytree.tree_leaves(params))
    assert cfg.param_count() == n
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    assert cfg.param_count() - cfg.active_param_count() == \
        4 * (E - k) * 3 * 64 * 32
    published = json.loads((spec.BENCH_DIR / "configs" /
                            "granite-4.0-h-small.json").read_text())
    for small in (cfg.reduced(), program.model_config(published).reduced()):
        assert isinstance(small, HybridMoEConfig)
        assert small.layer_types == ("mamba", "attention")
        assert small.moe.shared_expert_d_ff and small.moe.top_k == 2
        assert small.moe.num_experts == 4
        Model(small).init(seed=0, device=CPU)
    with pytest.raises(ValueError):
        HybridMoEConfig(**{**cfg.__dict__, "layer_types": ("mamba",)})


def _engine(traced=True):
    w = W.make(TINY, 7, "cpu")
    tel = Telemetry(tracer=StepTracer(capacity=1 << 14, enabled=traced))
    return build_engine(program.model_config(TINY), reduced=False,
                        algorithm="shvs", batch=4, max_seq=64, seed=1,
                        device=CPU, params=w, telemetry=tel)


def test_traced_engine_records_a_mamba_span_per_mamba_layer():
    from repro_torch.config import SamplingConfig
    from repro_torch.engine.request import Request
    eng = _engine()
    reqs = [Request(request_id=i, prompt=list(range(1, 5 + 7 * i)),
                    max_new_tokens=3, sampling=SamplingConfig(greedy=True),
                    eos_token=None) for i in range(2)]
    eng.submit(reqs)
    while eng.scheduler.has_work or eng.in_flight:
        eng.step()
    eng.flush()
    spans = [dict(e.args) for e in eng.tracer.events() if e.kind == "mamba"]
    mamba = [0, 2, 3]
    pre = [a for a in spans if a["program"] == "prefill"]
    dec = [a for a in spans if a["program"] == "decode"]
    assert [a["layer"] for a in pre] == mamba
    assert all(a["rows"] == 2 and a["tokens"] == 2 * 32 for a in pre)
    assert dec and len(dec) % 3 == 0
    assert [a["layer"] for a in dec] == mamba * (len(dec) // 3)
    assert all(a["rows"] == 4 and a["tokens"] == 4 for a in dec)
    eng.close()


def test_cache_gauges_count_each_kind_of_state():
    eng = _engine(traced=False)
    c = eng.cache
    kv = sum(c[k].numel() * c[k].element_size() for k in ("k", "v"))
    state = sum(c[k].numel() * c[k].element_size() for k in ("conv", "ssm"))
    assert c["ssm"].dtype == torch.float32 and cache_bytes(c) == (kv, state)
    lines = eng.obs.metrics.render().splitlines()
    assert f"engine_cache_kv_bytes {float(kv)}" in lines
    assert f"engine_cache_state_bytes {float(state)}" in lines
    eng.close()
