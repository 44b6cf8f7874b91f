"""Serving engine: scheduler, requests, the overlapped decode loop, KV
migration and the prefill/decode handoff."""
from repro_torch.engine.request import Request, RequestState  # noqa: F401
from repro_torch.engine.engine import (Engine, EngineConfig,  # noqa: F401
                                       GenerationEvent, StreamCursor,
                                       generate_stream)
from repro_torch.engine.migration import KVPayload  # noqa: F401
from repro_torch.engine.handoff import HandoffScheduler  # noqa: F401
from repro_torch.engine.pipeline import (PipelineConfig,  # noqa: F401
                                         PipelineEngine)
