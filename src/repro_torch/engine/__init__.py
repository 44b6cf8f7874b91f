"""Serving substrate: requests, the continuous-batching scheduler, the
overlapped engine, the pipeline engine, KV migration and the
prefill/decode handoff."""
from repro_torch.engine.request import Request, RequestState  # noqa: F401
from repro_torch.engine.decision_client import (  # noqa: F401
    SAMPLER_MODES, DecisionPlaneClient, canonical_sampler_mode)
from repro_torch.engine.engine import (Engine, EngineConfig,  # noqa: F401
                                       GenerationEvent, SlotParams,
                                       StreamCursor, generate_stream,
                                       locked_api)
from repro_torch.engine.migration import KVPayload  # noqa: F401
from repro_torch.engine.handoff import HandoffScheduler  # noqa: F401
from repro_torch.engine.pipeline import (MicrobatchPlanner,  # noqa: F401
                                         PipelineConfig, PipelineEngine)
