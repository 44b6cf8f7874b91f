"""``Engine.generate`` of the port against the reference engine on reduced
smollm-360m (f32), with the reference's weights bridged across.

One batch mixes engine-keyed, per-request-seeded and greedy requests, a
logit bias, a stop sequence, an eos stop and more requests than slots
(slot reuse). Streams — tokens and
finish reasons — are equal for ``shvs`` and ``fused``, overlapped and
sequential. The reference is run once per backend (its overlapped and
sequential loops are held equal by its own suite).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.config import SamplingConfig as JS, SHVSConfig as JSH, get_arch
from repro.engine.engine import Engine as JEngine, EngineConfig as JECfg
from repro.engine.request import Request as JRequest
from repro.models.model import Model as JModel
from repro_torch.config import (SamplingConfig as TS, SHVSConfig as TSH,
                                get_arch as tget)
from repro_torch.engine.engine import Engine as TEngine, EngineConfig as TECfg
from repro_torch.engine.request import Request as TRequest
from repro_torch.models.bridge import from_jax_params

ROOT = Path(__file__).resolve().parents[1]
ARCH = "smollm-360m"
ENGINE = dict(max_batch=4, max_seq_len=64, k_cap=64)
# request 1 stops mid-decode on both backends' streams (shvs after 4
# tokens, fused after 3), so a stop lands while a decode is in flight
STOP_AND_BIAS = dict(logit_bias={9: 0.5, 11: -2.0},
                     stop_sequences=((418, 174), (499,)))


def _requests(Request, Sampling, vocab):
    rs = np.random.default_rng(3)
    out = []
    for i in range(6):
        prompt = rs.integers(1, vocab, int(rs.integers(4, 20))).tolist()
        sampling = Sampling(temperature=0.8, top_k=40 if i % 2 else 0,
                            top_p=0.95 if i % 3 else 1.0,
                            repetition_penalty=1.1, presence_penalty=0.1,
                            seed=100 + i if i % 2 == 0 else None,
                            greedy=i in (3, 4),
                            **(STOP_AND_BIAS if i == 1 else {}))
        out.append(Request(request_id=i, prompt=prompt,
                           max_new_tokens=5 + i, sampling=sampling,
                           eos_token=7 if i == 5 else None))
    return out


@pytest.fixture(scope="module")
def weights():
    cfg = get_arch(ARCH).reduced()
    p = JModel(cfg).init(jax.random.PRNGKey(0))
    return cfg, p, from_jax_params(jax.tree_util.tree_map(np.asarray, p))


@pytest.fixture(scope="module")
def reference_streams(weights):
    cfg, p, _ = weights
    streams = {}
    for algorithm in ("shvs", "fused"):
        eng = JEngine(cfg, p, JECfg(algorithm=algorithm,
                                    shvs=JSH(hot_size=128), **ENGINE))
        reqs = _requests(JRequest, JS, cfg.vocab_size)
        list(eng.generate(reqs))
        eng.close()
        streams[algorithm] = [(r.output, r.finish_reason) for r in reqs]
    return streams


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("algorithm", ["shvs", "fused"])
def test_generate_streams_match_reference(weights, reference_streams,
                                          algorithm, overlap):
    cfg, _, tp = weights
    eng = TEngine(tget(ARCH).reduced(), tp,
                  TECfg(algorithm=algorithm, shvs=TSH(hot_size=128),
                        overlap=overlap, **ENGINE), device="cpu")
    reqs = _requests(TRequest, TS, cfg.vocab_size)
    events = list(eng.generate(reqs))
    eng.close()
    got = [(r.output, r.finish_reason) for r in reqs]
    assert got == reference_streams[algorithm]
    assert len([e for e in events if e.token is not None]) == \
        sum(len(r.output) for r in reqs)
    assert len(eng.stats_log) > 0 and eng.in_flight == 0


@pytest.mark.parametrize("field,value,item", [
    ("sampler_mode", "host", "item 8"), ("sampler_mode", "adaptive", "item 8")])
def test_unported_engine_modes_raise(weights, field, value, item):
    _, _, tp = weights
    with pytest.raises(NotImplementedError, match=item):
        TEngine(tget(ARCH).reduced(), tp, TECfg(**{field: value}),
                device="cpu")


def test_serve_driver_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--requests", "4", "--max-new", "6"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "served 4 requests, 24 tokens" in res.stdout
