"""Hot-vocabulary construction (paper §5.3).

The paper builds a model-dependent hot set from offline traces ("top 32k
often covers >95%"). :func:`build_hot_set` ranks token ids by a count
trace; the engine's autotuner rebuilds the plane's hot set with it when
H* moves.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.shvs import HotSet, make_hot_set


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
