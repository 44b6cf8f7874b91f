"""Typed step records."""
from repro_torch.obs.records import StepRecord  # noqa: F401
