"""The port's public surface against the reference's (ROADMAP Fault 9).

* Every name of ``repro.core``, ``repro.engine`` and ``repro.models``
  imports from the same port package.
* The Zipf trace models (``core/hot_vocab.py``: ``zipf_probs``,
  ``synthetic_trace``, ``counts_from_trace``, ``alpha_bar``) are numpy in
  both packages and equal the reference's bit for bit at fixed seeds.
* ``SamplingParams.broadcast``, ``apply_penalties`` and
  ``masked_probs_reference`` equal the reference's on the cases of
  ``tests/test_sampling.py`` (broadcast and the penalties exactly, the
  distribution within 1e-6 absolute); ``HotSet.size`` is the set's size.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SamplingConfig as JCfg
from repro.core import hot_vocab as jhv
from repro.core import penalties as jpen
from repro.core.sampling import SamplingParams as JSP
from repro.core.sampling import masked_probs_reference as jmasked
from repro_torch.config import SamplingConfig as TCfg
from repro_torch.core import hot_vocab as thv
from repro_torch.core import penalties as tpen
from repro_torch.core.sampling import SamplingParams as TSP
from repro_torch.core.sampling import masked_probs_reference as tmasked
from repro_torch.core.shvs import make_hot_set


def _public(mod):
    return sorted(n for n in dir(mod) if not n.startswith("_") and
                  not type(getattr(mod, n)).__name__ == "module")


@pytest.mark.parametrize("pkg", ["core", "engine", "models"])
def test_every_reference_name_imports_from_the_port(pkg):
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    names = _public(ref)
    assert names
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, missing


def test_slot_params_imports_from_the_engine():
    from repro_torch.engine import SlotParams  # noqa: F401


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("s", [1.1, 0.8])
def test_zipf_trace_models_equal_reference_bitwise(seed, s):
    for permute in (True, False):
        np.testing.assert_array_equal(
            thv.zipf_probs(1000, s, permute, seed),
            jhv.zipf_probs(1000, s, permute, seed))
    tr, jr = (m.synthetic_trace(1000, 5000, s, seed) for m in (thv, jhv))
    assert tr.dtype == jr.dtype
    np.testing.assert_array_equal(tr, jr)
    tc, jc = thv.counts_from_trace(tr, 1000), jhv.counts_from_trace(jr, 1000)
    assert tc.dtype == jc.dtype
    np.testing.assert_array_equal(tc, jc)
    rows = np.random.default_rng(seed).dirichlet(np.ones(1000), size=6)
    hs = [1, 10, 100, 999, 1000, 2000]
    for counts in (None, tc):
        np.testing.assert_array_equal(thv.alpha_bar(rows, hs, counts),
                                      jhv.alpha_bar(rows, hs, counts))


# the SamplingConfig cases of tests/test_sampling.py
CASES = [dict(), dict(repetition_penalty=2.0),
         dict(presence_penalty=0.5, frequency_penalty=0.25),
         dict(repetition_penalty=1.3, presence_penalty=0.2,
              frequency_penalty=0.1),
         dict(temperature=0.7, top_k=8), dict(temperature=0.7, top_k=3,
                                              top_p=0.8),
         dict(temperature=0.7, top_p=0.9), dict(temperature=0.7, min_p=0.1),
         dict(temperature=0.7, top_k=16, min_p=0.05),
         dict(temperature=0.9, top_k=12, top_p=0.95), dict(temperature=0.0),
         dict(greedy=True, temperature=0.9), dict(seed=12345)]


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()) or "default")
def test_broadcast_penalties_and_masked_probs_equal_reference(kw):
    B, V = 4, 32
    jp, tp = JSP.broadcast(B, JCfg(**kw)), TSP.broadcast(B, TCfg(**kw))
    for f in JSP._fields:
        a, b = getattr(jp, f), getattr(tp, f)
        b = b.numpy() if isinstance(b, torch.Tensor) else b
        assert b.dtype == np.asarray(a).dtype, f
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=f)

    rng = np.random.default_rng(1)
    z = rng.normal(0, 3, (B, V)).astype(np.float32)
    prompts = rng.integers(0, V, (B, 6))
    outs = rng.integers(0, V, (3, B))
    js = jpen.init_state(B, V, prompt_tokens=jnp.asarray(prompts))
    ts = tpen.init_state(B, V, prompt_tokens=torch.from_numpy(prompts))
    for o in outs:
        js = jpen.update_histograms(js, jnp.asarray(o))
        ts = tpen.update_histograms(ts, torch.from_numpy(o))
    jz = jpen.apply_penalties(jnp.asarray(z), js, JCfg(**kw))
    tz = tpen.apply_penalties(torch.from_numpy(z), ts, TCfg(**kw))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))

    if JCfg(**kw).effective_temperature > 0:
        jm = jmasked(jz, jp)
        tm = tmasked(tz, tp.strip_rng())
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0,
                                   atol=1e-6)


def test_hot_set_size():
    hot = make_hot_set([3, 1, 9], 16)
    assert hot.size == 3
    assert thv.build_hot_set(np.arange(64), 10).size == 10
