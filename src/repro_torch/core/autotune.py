"""Online decision-plane controllers (the paper's "future work (i)":
QoS-aware controllers, §9).

Two layers:

* :class:`HotSizeController` — the original hot-vocab size tracker. The
  offline sizing model (§5.4) needs a trace; in production the workload
  drifts (domain shift lowers ᾱ(H), §9 limitations). This controller
  closes the loop online:

  1. observe the measured hot mass ᾱ_obs at the current H (the
     DecisionPlane already reports ``alpha_mean`` per step — §6);
  2. fit the one-parameter Zipf-tail model
         ᾱ(H) = (1 − (H/V)^(1−s)) / (1 − V^(1−s)) ≈ 1 − (H/V)^(1−s)
     to the EWMA of observations (solve s by bisection);
  3. re-derive H* from the sizing model (Eq. 10–12) under the fitted
     curve and move H toward it with hysteresis.

* :class:`DecisionPlaneController` — the global controller (DESIGN.md
  §15). The reference's latency benchmark (BENCH_latency.json) shows
  that neither sampler placement dominates: under queue pressure the disaggregated host path wins the TTFT tail
  (the draw overlaps the next forward instead of capping the step rate,
  Eq. 4), while at light load its one-step commit lag and D2H fetch are
  pure overhead and the fused device path wins. This controller observes
  the stat streams the
  engines already emit (queue depth/delay, pool stall, ``transfer_time``,
  ``sampler_time``, bubble fraction, batch occupancy, ᾱ — each EWMA'd
  per committed step) and acts online: switch the
  :class:`~repro_torch.engine.decision_client.DecisionPlaneClient` placement
  between ``device`` and ``host``, resize the
  :class:`~repro_torch.core.host_sampler.HostSamplerPool`, and run the H*
  tracker as one sub-policy. Every observation stream may carry NaN
  (all-inactive shards pool to NaN stats; device-mode steps have no pool
  decomposition at all) — non-finite values are ignored *per stream*
  without stalling the controller's adjust clock.

Exactness is never at stake — SHVS's rejection/fallback keeps every H
correct, and host/device placement is an execution strategy whose streams
are bit-identical on the CPU by construction (§13; on a card the device
runs the CUDA kernels and the pool their CPU twins, which may round sums
differently) — the controllers only chase latency/throughput.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from repro_torch.core.sizing import SizingModel


def zipf_alpha_curve(V: int, s: float, hs: np.ndarray) -> np.ndarray:
    """Closed-form cumulative Zipf(s) mass of the top-H ranks."""
    hs = np.asarray(hs, np.float64)
    if abs(s - 1.0) < 1e-6:
        return np.log(hs + 1.0) / np.log(V + 1.0)
    num = 1.0 - (hs + 1.0) ** (1.0 - s)
    den = 1.0 - (V + 1.0) ** (1.0 - s)
    return np.clip(num / den, 0.0, 1.0)


def fit_zipf_s(V: int, H: int, alpha_obs: float, lo: float = 1.0001,
               hi: float = 3.0) -> float:
    """Solve zipf_alpha_curve(V, s, H) == alpha_obs for s by bisection."""
    alpha_obs = float(np.clip(alpha_obs, 1e-4, 1.0 - 1e-4))
    f = lambda s: zipf_alpha_curve(V, s, np.asarray([H]))[0] - alpha_obs
    if f(lo) > 0:
        return lo
    if f(hi) < 0:
        return hi
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if f(mid) < 0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


@dataclass
class HotSizeController:
    """EWMA-filtered online H* tracker."""

    vocab_size: int
    h_current: int
    c0: float = 3.3e-6            # platform constants from the offline fit
    c: float = 1.4e-8
    ewma: float = 0.2             # observation smoothing
    hysteresis: float = 0.25      # move only if |log2(H*/H)| > this
    min_h: int = 256
    adjust_every: int = 32        # steps between adjustments
    history_cap: int = 256        # bounded decision log — a long-running
    #                               server must not leak one dict per
    #                               adjustment forever
    _alpha_ewma: Optional[float] = field(default=None, init=False)
    _step: int = field(default=0, init=False)
    history: deque = field(init=False)

    def __post_init__(self) -> None:
        # deque keeps the ``history[-1]`` access pattern of the examples
        # while capping the slow per-adjustment leak
        self.history = deque(maxlen=self.history_cap)

    def observe(self, alpha_mean: float) -> Optional[int]:
        """Feed one step's measured hot mass; returns a new H when the
        controller decides to move, else None."""
        a = float(alpha_mean)
        if not np.isfinite(a):
            return None
        self._alpha_ewma = a if self._alpha_ewma is None else \
            (1 - self.ewma) * self._alpha_ewma + self.ewma * a
        self._step += 1
        if self._step % self.adjust_every:
            return None
        s = fit_zipf_s(self.vocab_size, self.h_current, self._alpha_ewma)
        hs = np.unique(np.geomspace(self.min_h, self.vocab_size,
                                    96).astype(np.int64))
        model = SizingModel(c0=self.c0, c=self.c, vocab_size=self.vocab_size,
                            alpha_hs=hs.astype(np.float64),
                            alpha_vals=zipf_alpha_curve(self.vocab_size, s, hs))
        h_star = max(self.min_h, model.optimal_h(lo=self.min_h))
        self.history.append({"step": self._step, "alpha": self._alpha_ewma,
                             "s_fit": s, "h_star": h_star,
                             "h_current": self.h_current})
        if abs(np.log2(max(h_star, 1) / max(self.h_current, 1))) > self.hysteresis:
            self.h_current = int(h_star)
            # ᾱ was measured at the OLD H — fitting the Zipf tail against
            # those observations after the move would chase a stale curve
            # and can thrash across the hysteresis band. Restart the
            # observation window: the EWMA refills with new-H measurements
            # and the next adjustment happens a full ``adjust_every`` later.
            self._alpha_ewma = None
            self._step = 0
            return self.h_current
        return None


@dataclass
class ControllerAction:
    """One decision emitted by :class:`DecisionPlaneController`. Fields are
    ``None`` when that knob is untouched; falsy when nothing changed."""

    sampler_mode: Optional[str] = None   # switch client placement
    samplers: Optional[int] = None       # resize the host sampler pool
    hot_size: Optional[int] = None       # H* sub-policy move

    def __bool__(self) -> bool:
        return (self.sampler_mode is not None or self.samplers is not None
                or self.hot_size is not None)


#: observation streams the controller EWMA-filters; everything the engines
#: already emit per committed step (DESIGN.md §15). Any value may be NaN.
CONTROLLER_STREAMS = ("queue_depth", "queue_delay_ms", "batch", "stall_ms",
                      "sampler_ms", "transfer_ms", "bubble_frac",
                      "alpha_mean")


@dataclass
class DecisionPlaneController:
    """Global decision-plane controller: online sampler placement, pool
    sizing, and H* tracking from the engines' own stat streams (§15).

    Placement policy (hysteresis band + dwell): sustained queue pressure
    switches to ``host`` — under load, sampling on the accelerator steals
    forward capacity (the paper's Eq. 4 structural cost), so the draw is
    disaggregated to the pool where it overlaps the next step; a drained
    queue switches back to ``device`` — at light load there is nothing to
    overlap and the host path's one-step commit lag plus the D2H fetch
    are pure overhead (the measured bimodal regime split in
    BENCH_latency.json). ``queue_low < queue_high`` forms the hysteresis
    band and ``dwell`` bounds the switch rate, so measurement noise at a
    boundary cannot thrash the placement (the same discipline as
    ``HotSizeController.hysteresis``).

    Pool policy: sustained commit stall (the pool missing the engine's
    slack) grows the worker count; a stall-free pool shrinks back toward
    ``min_samplers`` (on shared cores every idle worker is contention).
    Both moves are geometric (double / halve), so the reachable worker
    counts are the powers of two around the initial value, a small set a
    serving warm-up can cover in full.

    Every stream tolerates non-finite observations — NaN updates are
    dropped per stream while the adjust clock keeps ticking, so an
    all-inactive microbatch (NaN pooled stats, §13) or a device-mode step
    (no pool decomposition at all) can never stall a decision.
    """

    mode: str = "device"             # current placement (canonical spelling)
    samplers: int = 2                # current pool worker count
    # -- placement policy ----------------------------------------------------
    queue_high: float = 6.0          # device -> host above (queue-depth EWMA)
    queue_low: float = 1.0           # host -> device below
    occupancy_min: float = 0.0       # device -> host also needs batch EWMA
    #                                  >= this (0 disables the gate)
    # -- pool-sizing policy --------------------------------------------------
    min_samplers: int = 1
    max_samplers: int = 8
    stall_grow_ms: float = 2.0       # grow the pool above this stall EWMA
    stall_shrink_ms: float = 0.02    # shrink it below this
    # -- clocks --------------------------------------------------------------
    ewma: float = 0.25               # observation smoothing, every stream
    adjust_every: int = 4            # steps between decisions
    dwell: int = 16                  # min steps between acting on one knob
    history_cap: int = 256           # bounded decision log (same cap
    #                                  discipline as HotSizeController)
    hot: Optional[HotSizeController] = None   # H* tracking sub-policy
    signals: Dict[str, Optional[float]] = field(init=False)
    history: deque = field(init=False)
    _step: int = field(default=0, init=False)
    _last_switch: int = field(default=0, init=False)
    _last_resize: int = field(default=0, init=False)

    def __post_init__(self) -> None:
        # canonical client spellings only (the engines map the legacy
        # pipeline names before constructing the controller)
        assert self.mode in ("device", "host"), self.mode
        self.signals = {k: None for k in CONTROLLER_STREAMS}
        self.history = deque(maxlen=self.history_cap)

    def reset(self) -> None:
        """Clear the observation window and clocks (keep mode/samplers):
        benchmarks call this after warmup so warm-up steps cannot bias
        the first decisions."""
        self.signals = {k: None for k in CONTROLLER_STREAMS}
        self._step = 0
        self._last_switch = 0
        self._last_resize = 0

    def _update(self, name: str, value) -> None:
        """EWMA one stream; non-finite observations are dropped for THIS
        stream only — the other streams and the adjust clock are
        unaffected (an all-NaN step still ticks toward the next decision)."""
        if value is None:
            return
        v = float(value)
        if not np.isfinite(v):
            return
        cur = self.signals[name]
        self.signals[name] = v if cur is None else \
            (1 - self.ewma) * cur + self.ewma * v

    def observe(self, **streams) -> Optional[ControllerAction]:
        """Feed one committed step's stats (any subset of
        ``CONTROLLER_STREAMS``, missing/NaN values ignored per stream);
        returns a :class:`ControllerAction` when the controller decides to
        move, else ``None``."""
        for name in CONTROLLER_STREAMS:
            if name in streams:
                self._update(name, streams[name])
        unknown = set(streams) - set(CONTROLLER_STREAMS)
        assert not unknown, f"unknown controller streams: {sorted(unknown)}"
        self._step += 1
        act = ControllerAction()
        if self.hot is not None:
            # the H* sub-policy keeps its own EWMA/adjust clock; its NaN
            # handling predates this controller (§13 active-row weighting)
            h = self.hot.observe(streams.get("alpha_mean", float("nan")))
            if h is not None:
                act.hot_size = h
        if self._step % self.adjust_every == 0:
            self._decide_placement(act)
            self._decide_pool(act)
        if act:
            self.history.append({
                "step": self._step, "mode": self.mode,
                "samplers": self.samplers,
                "action": {k: v for k, v in (
                    ("sampler_mode", act.sampler_mode),
                    ("samplers", act.samplers),
                    ("hot_size", act.hot_size)) if v is not None},
                "signals": dict(self.signals)})
            return act
        return None

    def observe_record(self, rec) -> Optional[ControllerAction]:
        """Feed one typed :class:`~repro_torch.obs.records.StepRecord` — the
        §17 telemetry plane's single validated stream. Equivalent to
        ``observe(**rec.controller_streams())``: unset record fields
        arrive as NaN and are dropped per stream."""
        return self.observe(**rec.controller_streams())

    def _decide_placement(self, act: ControllerAction) -> None:
        if self._step - self._last_switch < self.dwell:
            return
        q = self.signals["queue_depth"]
        if q is None:
            return
        b = self.signals["batch"]
        if self.mode == "device" and q > self.queue_high and \
                (self.occupancy_min <= 0.0
                 or (b is not None and b >= self.occupancy_min)):
            # pressure: on-device sampling caps the step rate (Eq. 4) —
            # disaggregate the draw so it overlaps the next forward
            self.mode = act.sampler_mode = "host"
            self._last_switch = self._step
        elif self.mode == "host" and q < self.queue_low:
            # drained: nothing to overlap — the host path's commit lag
            # and D2H fetch are pure overhead, fuse back on device (§2)
            self.mode = act.sampler_mode = "device"
            self._last_switch = self._step

    def _decide_pool(self, act: ControllerAction) -> None:
        if self.mode != "host" or \
                self._step - self._last_resize < self.dwell:
            return
        st = self.signals["stall_ms"]
        if st is None:
            return
        if st > self.stall_grow_ms and self.samplers < self.max_samplers:
            self.samplers = act.samplers = min(self.max_samplers,
                                               self.samplers * 2)
            self._last_resize = self._step
        elif st < self.stall_shrink_ms and self.samplers > self.min_samplers:
            self.samplers = act.samplers = max(self.min_samplers,
                                               self.samplers // 2)
            self._last_resize = self._step
