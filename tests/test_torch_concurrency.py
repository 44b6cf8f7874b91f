"""Concurrent-client safety and lifecycle contracts of the port's engines,
as ``tests/test_engine_concurrency.py`` holds the reference's:

* three threads driving ``generate`` on one engine give every request the
  stream a serial run gives it (the public methods serialise on the
  engine's lock; uniforms are keyed on (request, position));
* ``close()`` is idempotent, quiet on an engine whose ``__init__`` never
  ran, and ``submit()`` after it raises.

Each holds for the single-stage ``Engine`` and for the ``PipelineEngine``
(two stages, sampling in the host pool).
"""
import threading

import pytest

from repro_torch.config import ModelConfig, SamplingConfig, SHVSConfig
from repro_torch.engine.engine import Engine, EngineConfig
from repro_torch.engine.pipeline import PipelineConfig, PipelineEngine
from repro_torch.engine.request import Request
from repro_torch.models.model import Model

VOCAB = 512
ENGINES = {"engine": (Engine, EngineConfig, {}),
           "pipeline": (PipelineEngine, PipelineConfig,
                        dict(stages=2, sampler_mode="host", samplers=2))}


@pytest.fixture(scope="module")
def model():
    cfg = ModelConfig(name="conc-test", family="dense", num_layers=2,
                      d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
                      vocab_size=VOCAB, dtype="float32")
    return cfg, Model(cfg).init(seed=0, device="cpu")


def _engine(model, kind):
    cls, ecfg, extra = ENGINES[kind]
    cfg, params = model
    return cls(cfg, params, ecfg(
        max_batch=4, max_seq_len=96, algorithm="reference",
        shvs=SHVSConfig(hot_size=VOCAB // 4), k_cap=256, **extra),
        device="cpu")


def _group(base_id: int, n: int = 2, max_new: int = 8):
    return [Request(
        request_id=base_id + i,
        prompt=[(7 * (base_id + i) + 3 * j) % (VOCAB - 1) + 1
                for j in range(5 + (base_id + i) % 4)],
        max_new_tokens=max_new,
        sampling=SamplingConfig(temperature=0.9, top_k=40, top_p=0.95,
                                seed=4000 + base_id + i))
        for i in range(n)]


def _collect(eng, reqs, out: dict) -> None:
    for ev in eng.generate(reqs):
        if ev.token is not None:
            out.setdefault(ev.request_id, []).append(ev.token)


@pytest.mark.parametrize("kind", list(ENGINES))
def test_interleaved_concurrent_streams_match_serial(model, kind):
    serial: dict = {}
    eng = _engine(model, kind)
    try:
        for base in (10, 20, 30):
            _collect(eng, _group(base), serial)
    finally:
        eng.close()
    concurrent: dict = {}
    errors: list = []
    eng = _engine(model, kind)
    try:
        def drive(g):
            try:
                _collect(eng, g, concurrent)
            except BaseException as e:        # surfaced after join
                errors.append(e)

        threads = [threading.Thread(target=drive, args=(_group(b),))
                   for b in (10, 20, 30)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), \
            "concurrent generate deadlocked"
    finally:
        eng.close()
    assert not errors, f"concurrent driver raised: {errors!r}"
    assert concurrent == serial


@pytest.mark.parametrize("kind", list(ENGINES))
def test_close_idempotent_and_submit_after_close_raises(model, kind):
    eng = _engine(model, kind)
    for _ in eng.generate(_group(70, max_new=4)):
        pass
    eng.close()
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(_group(80, n=1))


@pytest.mark.parametrize("kind", list(ENGINES))
def test_close_after_failed_startup(kind):
    cls = ENGINES[kind][0]
    eng = cls.__new__(cls)
    eng.close()
    eng.close()
