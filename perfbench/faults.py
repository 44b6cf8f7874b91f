"""Faults planted in the program under test, each a context manager that
patches one of its methods and restores it on exit. A run with one
planted must come out not correct: the CPU tests plant them in small
cells, ``readings.py --fault`` in a cell at its own size on the card.

* ``state_unchanged``: a decode step returns its cache as it found it;
* ``half_batch``: a decode step's odd rows of logits read 0;
* ``token_altered``: every token the decision plane makes is the next id;
* ``greedy_altered``: only greedy rows' tokens (temperature 0) are;
* ``filters_off``: the decision plane ignores top-k, top-p and min-p,
  and draws from the whole tempered distribution.

One card serves each cell, so there is no exchange between chips to
leave out.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, wrap):
    orig = getattr(owner, name)
    setattr(owner, name, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _model():
    from repro_torch.models.model import Model
    return Model


def _plane():
    from repro_torch.core.decision_plane import DecisionPlane
    return DecisionPlane


def state_unchanged():
    def wrap(orig):
        def step(self, params, tokens, cache, window=None):
            saved = {k: v.clone() for k, v in cache.items()}
            logits, _ = orig(self, params, tokens, cache, window)
            for k, v in saved.items():
                cache[k].copy_(v)
            return logits, cache
        return step
    return _patched(_model(), "decode_step", wrap)


def half_batch():
    def wrap(orig):
        def step(self, params, tokens, cache, window=None):
            logits, cache = orig(self, params, tokens, cache, window)
            logits = logits.clone()
            logits[1::2] = 0.0
            return logits, cache
        return step
    return _patched(_model(), "decode_step", wrap)


def _altered(greedy_only: bool):
    def wrap(orig):
        def step(self, logits, state, params, *args, **kwargs):
            tokens, state, stats = orig(self, logits, state, params, *args,
                                        **kwargs)
            bumped = (tokens + 1) % self.vocab_size
            if greedy_only:
                greedy = params.temperature.to(tokens.device) <= 0.0
                bumped = torch.where(greedy, bumped, tokens)
            return bumped, state, stats
        return step
    return _patched(_plane(), "step", wrap)


def token_altered():
    return _altered(False)


def greedy_altered():
    return _altered(True)


def filters_off():
    def wrap(orig):
        def step(self, logits, state, params, *args, **kwargs):
            params = params._replace(top_k=torch.zeros_like(params.top_k),
                                     top_p=torch.ones_like(params.top_p),
                                     min_p=torch.zeros_like(params.min_p))
            return orig(self, logits, state, params, *args, **kwargs)
        return step
    return _patched(_plane(), "step", wrap)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "token_altered": token_altered, "greedy_altered": greedy_altered,
          "filters_off": filters_off}
