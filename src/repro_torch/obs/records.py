"""Typed step records — one schema for the engines' stat streams
(DESIGN.md §17).

:class:`StepRecord` is the validated row the engines append to
``stats_log``, and :class:`CycleRecord` the pipeline engine's per-cycle
row (``cycle_log``). Both keep **mapping-style duck typing**
(``"stall_ms" in rec`` / ``rec["stall_ms"]`` / ``rec.get``) with the
dict convention the old consumers relied on: a field is *present* iff it
is set and not ``None`` — so ``"stall_ms" not in rec`` still reads "this
was a device-mode step" exactly as it did with the dicts.

Optionality encodes the decision-plane placement: ``stall_ms`` /
``sampler_ms`` / ``transfer_ms`` exist only for host-sampled steps
(§13's pool decomposition), ``bubble_frac`` only for pipeline commits,
and ``hot_size`` / ``samplers`` / ``sampler_mode`` only on steps where a
controller acted (§15). ``accept_rate`` / ``alpha_mean`` /
``fallback_rate`` may be NaN (all-inactive microbatches pool to NaN
stats) — NaN means "no sample", never "zero".
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Iterator, List, Optional

_NAN = float("nan")


class RecordMapping:
    """Mapping-style duck typing over dataclass fields: presence ==
    "set and not None", matching the optional-key convention of the
    free-form dicts these records replaced."""

    __slots__ = ()

    def __contains__(self, name: str) -> bool:
        try:
            return getattr(self, name) is not None
        except AttributeError:
            return False

    def __getitem__(self, name: str) -> Any:
        if name not in self:
            raise KeyError(name)
        return getattr(self, name)

    def get(self, name: str, default: Any = None) -> Any:
        return self[name] if name in self else default

    def keys(self) -> Iterator[str]:
        return iter(f.name for f in fields(self) if f.name in self)

    def as_dict(self) -> Dict[str, Any]:
        """Only the fields that are present — exactly the dict the old
        code would have built."""
        return {k: getattr(self, k) for k in self.keys()}


def _check_ms(name: str, v: Optional[float],
              nan_ok: bool = False) -> Optional[float]:
    if v is None:
        return None
    v = float(v)
    if math.isnan(v):
        if nan_ok:
            return v
        raise ValueError(f"{name} must not be NaN")
    if not math.isfinite(v) or v < 0.0:
        raise ValueError(f"{name} must be a finite non-negative "
                         f"duration in ms, got {v!r}")
    return v


@dataclass
class StepRecord(RecordMapping):
    """One committed engine iteration's observability stats — the
    validated stream behind ``Engine.stats_log`` /
    ``PipelineEngine.stats_log``, consumed unchanged by
    :meth:`repro.core.autotune.DecisionPlaneController.observe_record`,
    serve.py's report, and the latency benchmarks."""

    step: int                              # dispatch step / pipeline cycle
    batch: int                             # active rows committed
    accept_rate: float = _NAN              # NaN = no active rows sampled
    alpha_mean: float = _NAN
    fallback_rate: float = _NAN
    # host-sampled steps only (§13 pool decomposition)
    stall_ms: Optional[float] = None       # block on the pool ticket
    sampler_ms: Optional[float] = None     # worker CPU sampling (max shard)
    transfer_ms: Optional[float] = None    # worker device_get wait
    # queue state at commit time (always stamped by the engines)
    queue_depth: Optional[float] = None
    queue_delay_ms: Optional[float] = None  # NaN when arrivals lack stamps
    # pipeline commits only
    bubble_frac: Optional[float] = None     # NaN during fill/drain ramp
    # controller actions landing on this step (§15)
    hot_size: Optional[int] = None
    samplers: Optional[int] = None
    sampler_mode: Optional[str] = None

    def __post_init__(self) -> None:
        self.step = int(self.step)
        self.batch = int(self.batch)
        if self.step < 0 or self.batch < 0:
            raise ValueError(
                f"step/batch must be >= 0, got {self.step}/{self.batch}")
        self.accept_rate = float(self.accept_rate)
        self.alpha_mean = float(self.alpha_mean)
        self.fallback_rate = float(self.fallback_rate)
        self.stall_ms = _check_ms("stall_ms", self.stall_ms)
        self.sampler_ms = _check_ms("sampler_ms", self.sampler_ms)
        self.transfer_ms = _check_ms("transfer_ms", self.transfer_ms)
        if self.queue_depth is not None:
            self.queue_depth = float(self.queue_depth)
            if not (self.queue_depth >= 0.0):
                raise ValueError(
                    f"queue_depth must be >= 0, got {self.queue_depth!r}")
        self.queue_delay_ms = _check_ms("queue_delay_ms",
                                        self.queue_delay_ms, nan_ok=True)
        if self.bubble_frac is not None:
            self.bubble_frac = float(self.bubble_frac)
        if self.hot_size is not None:
            self.hot_size = int(self.hot_size)
        if self.samplers is not None:
            self.samplers = int(self.samplers)
        if self.sampler_mode is not None and \
                self.sampler_mode not in ("device", "host"):
            raise ValueError(
                f"sampler_mode must be 'device' or 'host' (canonical "
                f"client spelling), got {self.sampler_mode!r}")

    @property
    def is_host(self) -> bool:
        """Whether this step's decision ran on the host sampler pool."""
        return self.stall_ms is not None

    def controller_streams(self) -> Dict[str, float]:
        """The §15 controller's observation kwargs — missing fields become
        NaN, which the controller drops per stream without stalling its
        adjust clock (``CONTROLLER_STREAMS`` in repro.core.autotune)."""
        opt = lambda v: _NAN if v is None else float(v)
        return {
            "queue_depth": opt(self.queue_depth),
            "queue_delay_ms": opt(self.queue_delay_ms),
            "batch": float(self.batch),
            "stall_ms": opt(self.stall_ms),
            "sampler_ms": opt(self.sampler_ms),
            "transfer_ms": opt(self.transfer_ms),
            "bubble_frac": opt(self.bubble_frac),
            "alpha_mean": self.alpha_mean,
        }


@dataclass
class CycleRecord(RecordMapping):
    """One pipeline cycle's timing row (``PipelineEngine.cycle_log``):
    per-stage busy time plus the sampling-path costs the Eq. 4 bubble
    accounting needs. ``busy[s]`` is ``None`` for a stage that served no
    microbatch this cycle (fill/drain ramp)."""

    cycle: int
    busy: List[Optional[float]] = field(default_factory=list)  # seconds
    stall: float = 0.0              # commit block on the pool ticket (s)
    sample: float = 0.0             # synchronous last-stage draw (s, Eq. 4)
    sampler: Optional[float] = None    # pool CPU sampling (s)
    transfer: Optional[float] = None   # pool wait for the logits' copy (s)

    def __post_init__(self) -> None:
        self.cycle = int(self.cycle)
        if self.cycle < 0:
            raise ValueError(f"cycle must be >= 0, got {self.cycle}")

    @property
    def full(self) -> bool:
        """Every stage served a microbatch — a steady-state cycle."""
        return all(b is not None for b in self.busy)


__all__ = ["StepRecord", "CycleRecord", "RecordMapping"]
