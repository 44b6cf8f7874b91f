"""Hot-vocabulary construction and Zipf trace models (paper §5.3–§5.4).

The paper builds a model-dependent hot set from offline traces ("top 32k
often covers >95%"). Here:

* :func:`build_hot_set` — frequency-ranked hot set from a token-count
  trace; the engine's autotuner rebuilds the plane's hot set with it when
  H* moves.
* :func:`zipf_probs` / :func:`synthetic_trace` — Zipf(s) synthetic
  distributions used by tests/benchmarks (the paper's "Zipf-like
  next-token probabilities" assumption made explicit and tunable).
* :func:`alpha_bar` — the empirical hit-ratio curve ᾱ(H) (monotone,
  saturating; §5.4) measured from a matrix of next-token distributions.

The trace models are numpy, as in the reference, so at a fixed seed they
give the reference's arrays bit for bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.shvs import HotSet, make_hot_set


def zipf_probs(vocab_size: int, s: float = 1.1, permute: bool = True,
               seed: int = 0) -> np.ndarray:
    """Zipf(s) probability vector over a vocabulary (optionally permuted so
    hot tokens are scattered across ids, like real tokenizers)."""
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    p = ranks ** (-s)
    p /= p.sum()
    if permute:
        rng = np.random.default_rng(seed)
        perm = rng.permutation(vocab_size)
        out = np.empty_like(p)
        out[perm] = p
        return out
    return p


def synthetic_trace(vocab_size: int, num_tokens: int, s: float = 1.1,
                    seed: int = 0) -> np.ndarray:
    """Sample a synthetic token trace from a Zipf distribution."""
    rng = np.random.default_rng(seed)
    p = zipf_probs(vocab_size, s, permute=True, seed=seed)
    return rng.choice(vocab_size, size=num_tokens, p=p).astype(np.int32)


def counts_from_trace(trace: np.ndarray, vocab_size: int) -> np.ndarray:
    return np.bincount(trace, minlength=vocab_size).astype(np.int64)


def build_hot_set(counts, hot_size: int, vocab_size: int | None = None,
                  device="cpu") -> HotSet:
    """Frequency-ranked hot set: the ``hot_size`` most frequent tokens,
    ids sorted ascending, on ``device``."""
    counts = np.asarray(counts)
    V = vocab_size or counts.shape[0]
    hot_size = min(hot_size, V)
    idx = np.argpartition(-counts, hot_size - 1)[:hot_size]
    idx = idx[np.argsort(-counts[idx], kind="stable")]
    return make_hot_set(np.sort(idx), V, device)


def alpha_bar(prob_rows: np.ndarray, hot_sizes, counts=None) -> np.ndarray:
    """Empirical hit-ratio curve ᾱ(H) = E_b[ Σ_{v∈H} p̃_{b,v} ] (§5.4).

    prob_rows: (N, V) next-token distributions from a trace. The hot set
    for each H is frequency-ranked by ``counts`` (defaults to the mean of
    prob_rows).
    """
    prob_rows = np.asarray(prob_rows)
    V = prob_rows.shape[1]
    if counts is None:
        counts = prob_rows.mean(0)
    order = np.argsort(-np.asarray(counts), kind="stable")
    # cumulative per-row mass in frequency-rank order
    ranked = prob_rows[:, order]
    cum = np.cumsum(ranked.mean(0))
    hs = np.asarray(list(hot_sizes))
    return cum[np.clip(hs - 1, 0, V - 1)]
