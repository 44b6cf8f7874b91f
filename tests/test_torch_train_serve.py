"""The serve and train surface of the port over the new families and the
training entry point: ``serve.py --arch internvl2-2b`` against the reference
engine (text only, the reference's weights through ``--weights``), the
engines' refusal of whisper (ROADMAP Fault 7), and
``python -m repro_torch.launch.train --ckpt`` whose checkpoint restores
into an ``Engine``. Streams (tokens and finish reasons) must be equal.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.config import get_arch
from repro.launch import serve as jserve
from repro.models.model import Model as JModel
from repro_torch.config import get_arch as tget
from repro_torch.engine.engine import Engine, EngineConfig
from repro_torch.engine.pipeline import PipelineConfig, PipelineEngine
from repro_torch.launch import serve as tserve
from repro_torch.models.bridge import save_npz
from repro_torch.models.model import Model as TModel
from repro_torch.training.checkpoint import restore_checkpoint
from repro_torch.training.optimizer import adamw_init, tree_leaves

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    """The shapes are tiny: one intra-op thread a test, so that the
    suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _streams(eng, synth, vocab, greedy=False):
    reqs = synth(6, vocab, 8, seed=11, greedy=greedy)
    list(eng.generate(reqs))
    eng.close()
    return [(r.request_id, list(r.output), r.finish_reason) for r in reqs]


@pytest.mark.parametrize("algorithm", ["shvs", "fused"])
def test_serve_internvl2_streams_match_reference(tmp_path, algorithm):
    """The VLM served text only, as the reference's engine serves it:
    seeded-sampled streams equal, untied head and all."""
    arch = "internvl2-2b"
    p = JModel(get_arch(arch).reduced()).init(jax.random.PRNGKey(0))
    path = str(tmp_path / "w.npz")
    save_npz(path, jax.tree_util.tree_map(np.asarray, p))
    kw = dict(arch=arch, reduced=True, algorithm=algorithm, batch=8,
              max_seq=64)
    jeng = jserve.build_engine(**kw)
    teng = tserve.build_engine(**kw, weights=path, device="cpu")
    assert "head" in teng.params["emb"]
    vocab = jeng.cfg.vocab_size
    assert _streams(teng, tserve.synth_requests, vocab) == \
        _streams(jeng, jserve.synth_requests, vocab)


def test_engines_refuse_whisper_naming_fault_7():
    cfg = tget("whisper-base").reduced()
    params = TModel(cfg).init(seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="Fault 7"):
        Engine(cfg, params, EngineConfig(max_batch=2, max_seq_len=32),
               device="cpu")
    with pytest.raises(NotImplementedError, match="Fault 7"):
        PipelineEngine(cfg, params, PipelineConfig(
            stages=2, microbatches=2, max_batch=2, max_seq_len=32),
            device="cpu")
    with pytest.raises(NotImplementedError, match="Fault 7"):
        tserve.build_engine("whisper-base", True, "shvs", 2, 32,
                            device="cpu")


def test_whisper_prefill_needs_frames():
    """``Model.prefill`` without the encoder's frames raises a clear error
    (the reference fails on ``None.shape``)."""
    cfg = tget("whisper-base").reduced()
    m = TModel(cfg)
    params = m.init(seed=0, device="cpu")
    toks = torch.ones((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="frames"):
        m.prefill(params, {"tokens": toks}, m.init_cache(1, 16, device="cpu"))


def test_train_cli_checkpoint_restores_into_an_engine(tmp_path):
    """``launch.train --reduced --device cpu --steps 6 --ckpt DIR`` runs;
    its checkpoint (step 6, trained weights, AdamW state) restores into
    the model's tree and serves greedy requests through ``Engine``,
    streams equal to serving the same tree restored a second time."""
    ckpt = tmp_path / "ckpt"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--steps", "6", "--batch", "2", "--seq-len",
         "16", "--ckpt", str(ckpt)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "checkpoint saved" in out.stdout and "final loss" in out.stdout
    cfg = tget("smollm-360m").reduced()
    init = TModel(cfg).init(seed=0, device="cpu")
    params, opt, step = restore_checkpoint(str(ckpt), init, adamw_init(init))
    assert step == 6 and int(opt.step) == 6
    # the trainer starts from the same seeded init: training moved it
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(params), tree_leaves(init)))
    runs = []
    for _ in range(2):
        p, _, _ = restore_checkpoint(str(ckpt), init)
        eng = Engine(cfg, p, EngineConfig(max_batch=4, max_seq_len=64),
                     device="cpu")
        runs.append(_streams(eng, tserve.synth_requests, cfg.vocab_size,
                             greedy=True))
    assert runs[0] == runs[1]
    assert all(reason == "length" and len(toks) == 8
               for _, toks, reason in runs[0])
