"""The paper's contribution: the disaggregated decision plane.

Public API (the reference's names):
    DecisionPlane       — the sampling service shell (service API v1, §11)
    SamplerBackend      — the pluggable backend protocol + registry
    registered_backends / make_backend — backend discovery & construction
    PenaltyState        — per-sequence token histograms + masks (§2.2, Eq. 5)
    shvs_sample         — speculative hot-vocab sampling (§5.3)
    build_hot_set       — offline hot-vocab construction (§5.3)
    SizingModel         — affine cost model + H* optimisation (§5.4)
"""
from repro_torch.core.decision_plane import DecisionPlane  # noqa: F401
from repro_torch.core.sampler_backend import (  # noqa: F401
    DecisionStats, SamplerBackend, make_backend, register_backend,
    registered_backends)
from repro_torch.core.penalties import (PenaltyState,  # noqa: F401
                                        apply_penalties, update_histograms)
from repro_torch.core.sampling import (sample_reference,  # noqa: F401
                                       truncation_first_sample)
from repro_torch.core.shvs import shvs_sample  # noqa: F401
from repro_torch.core.hot_vocab import build_hot_set  # noqa: F401
from repro_torch.core.sizing import SizingModel  # noqa: F401
