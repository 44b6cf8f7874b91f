"""The plain reference against the program at small sizes on the CPU:
each family's prefill and decode through the cache (RWKV-6 with the
call's pad tokens scanned), the family's ``reference/<family>.py`` as
its configuration's ``family`` finds it, and the decision semantics
against the program's full-vocabulary filter and penalties. The test
imports both; the reference imports nothing of the program."""
import pytest
import torch

from perfbench import reference as R
from perfbench.harness import program, spec, weights as W
from perfbench.tests import tiny


def _served(cfg, B=3, P=(5, 11, 17), pad=32, steps=7, seed=3):
    from repro_torch.models.model import Model
    w = W.make(cfg, seed, "cpu")
    m = Model(program.model_config(cfg))
    g = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(1, cfg["vocab_size"], (p,), generator=g)
               for p in P]
    toks = torch.zeros(B, pad, dtype=torch.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    cache = m.init_cache(B, 64, device="cpu")
    lg, cache = m.prefill(w, {"tokens": toks}, cache,
                          true_lens=torch.tensor(P, dtype=torch.int32))
    outs, got = [lg.argmax(-1)], [lg]
    for _ in range(steps - 1):
        lg, cache = m.decode_step(w, outs[-1].int(), cache)
        outs.append(lg.argmax(-1))
        got.append(lg)
    outs = torch.stack(outs, 1)
    got = torch.stack(got, 1)
    items = [dict(prompt=prompts[i].tolist(), outputs=outs[i].tolist(),
                  padded=pad, contract={}, greedy=True) for i in range(B)]
    return w, items, got


def _reference(cfg):
    return spec.load_family("reference", cfg["family"])


@pytest.mark.parametrize("cfg", [tiny.MOE, tiny.RWKV], ids=["moe", "rwkv6"])
def test_reference_logits_equal_the_programs(cfg):
    w, items, got = _served(cfg)
    ref = _reference(cfg).output_logits(cfg, w, items)
    for i, r in enumerate(ref):
        assert torch.allclose(got[i], r, atol=2e-5, rtol=1e-5)


def test_rwkv_reference_needs_the_calls_padding():
    cfg = tiny.RWKV
    w, items, got = _served(cfg)
    wrong = [dict(it, padded=len(it["prompt"])) for it in items]
    ref = _reference(cfg).output_logits(cfg, w, wrong)
    assert not torch.allclose(got[0][1:], ref[0][1:], atol=1e-3)


@pytest.mark.parametrize("cfg", [tiny.MOE, tiny.RWKV], ids=["moe", "rwkv6"])
def test_greedy_served_tokens_read_zero_and_altered_ones_do_not(cfg):
    w, items, _ = _served(cfg)
    res = R.request_readings(cfg, w, items, control=True)
    assert res["greedy_gap"] == 0.0 and res["greedy_gap_mean"] == 0.0
    assert res["gap"] == 0.0 and res["gap_mean"] == 0.0
    assert res["greedy_gap_control"] > 0.0
    assert res["gap_control"] == res["greedy_gap_control"]
    assert res["kept_gap"] == 0.0       # no sampled request here
    bad = [dict(it, outputs=[(t + 1) % cfg["vocab_size"]
                             for t in it["outputs"]]) for it in items]
    res = R.request_readings(cfg, w, bad)
    assert res["greedy_gap_mean"] > 1e-3
    assert res["gap_mean"] == res["greedy_gap_mean"]


CONTRACTS = [
    {"temperature": 0.7, "top_p": 0.9, "top_k": 50,
     "repetition_penalty": 1.1},
    {"temperature": 1.0, "min_p": 0.05, "presence_penalty": 0.3,
     "frequency_penalty": 0.3},
    {"temperature": 1.3, "top_k": 7, "min_p": 0.2},
]


@pytest.mark.parametrize("c", CONTRACTS)
def test_decision_semantics_equal_the_programs(c):
    from repro_torch.config import SamplingConfig
    from repro_torch.core import penalties as pen
    from repro_torch.core.sampling import (SamplingParams,
                                           filter_mask_reference,
                                           temperature_scale)
    V, n = 300, 6
    g = torch.Generator().manual_seed(5)
    logits = torch.randn(n, V, generator=g) * 2
    prompt = torch.randint(0, V, (9,), generator=g)
    outputs = torch.randint(0, V, (n,), generator=g)
    counts = R.decision.output_counts(len(prompt), outputs, V)
    z = R.decision.penalize(logits, prompt, counts, c)
    state = pen.PenaltyState(
        prompt_counts=pen.histogram(prompt[None].expand(n, -1), V),
        output_counts=counts)
    sp = SamplingParams.broadcast(n, SamplingConfig(**c))
    zp = pen.apply_penalties_rows(logits, state, sp.repetition_penalty,
                                  sp.presence_penalty, sp.frequency_penalty)
    assert torch.equal(z, zp)
    zt = z / c["temperature"]
    assert torch.equal(R.decision.kept(zt, c), filter_mask_reference(
        temperature_scale(zp, sp.temperature), sp))


def test_kept_gap_reads_zero_inside_the_kept_set():
    c = CONTRACTS[0]
    V = 200
    logits = torch.randn(4, V, generator=torch.Generator().manual_seed(1))
    prompt = torch.tensor([1, 2, 3])
    z = R.decision.penalize(logits, prompt,
                            torch.zeros(4, V, dtype=torch.int32), c)
    keep = R.decision.kept(z / c["temperature"], c)
    inside = torch.tensor([int(torch.nonzero(k)[0]) for k in keep])
    # one token a position: histories as if the same token came before
    r = R.decision.readings(logits, inside, prompt, c, greedy=False)
    assert float(r["kept"].max()) == 0.0
    outside = torch.tensor([int(torch.nonzero(~k)[0]) for k in keep])
    r = R.decision.readings(logits, outside, prompt, c, greedy=False)
    assert float(r["kept"].min()) >= 0.0 and float(r["kept"].max()) > 0.0
    s = R.decision.summary([r["kept"]], "kept_gap")
    assert s["kept_gap"] == float(r["kept"].max())
    assert s["kept_gap_mean"] == pytest.approx(float(r["kept"].mean()))
