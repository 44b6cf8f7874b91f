"""The port's serve driver against the reference's: ``build_engine`` +
``synth_requests`` give the same streams for the same arguments, once the
reference's weights reach the port through ``--weights PATH.npz``.

The npz is written from the reference's ``Model.init`` at the seed its own
``build_engine`` uses, in the layout of ``models.bridge.save_npz``; nothing
is downloaded. Streams (tokens and finish reasons) must be equal, for the
single-stage engine and for ``--stages 2 --microbatches 4``.
"""
import jax
import numpy as np
import pytest

from repro.config import get_arch
from repro.launch import serve as jserve
from repro.models.model import Model as JModel
from repro_torch.launch import serve as tserve
from repro_torch.models.bridge import load_npz, save_npz

ARCH = "smollm-360m"


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    cfg = get_arch(ARCH).reduced()
    p = JModel(cfg).init(jax.random.PRNGKey(0))   # build_engine's seed 0
    path = tmp_path_factory.mktemp("weights") / "smollm_reduced.npz"
    save_npz(path, jax.tree_util.tree_map(np.asarray, p))
    return str(path), p


def _streams(eng, synth, vocab):
    reqs = synth(6, vocab, 8, seed=11)
    list(eng.generate(reqs))
    eng.close()
    return [(r.request_id, list(r.output), r.finish_reason) for r in reqs]


def test_npz_round_trip_keeps_the_tree(weights):
    path, p = weights
    flat = jax.tree_util.tree_leaves_with_path(p)
    got = load_npz(path)
    for keys, leaf in flat:
        node = got
        for k in keys:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("stages,microbatches", [(1, 0), (2, 4)])
def test_serve_streams_match_reference(weights, stages, microbatches):
    path, _ = weights
    kw = dict(arch=ARCH, reduced=True, algorithm="shvs", batch=8, max_seq=64,
              stages=stages, microbatches=microbatches)
    jeng = jserve.build_engine(**kw)
    teng = tserve.build_engine(**kw, weights=path, device="cpu")
    assert type(teng).__name__ == type(jeng).__name__
    vocab = jeng.cfg.vocab_size
    assert _streams(teng, tserve.synth_requests, vocab) == \
        _streams(jeng, jserve.synth_requests, vocab)
