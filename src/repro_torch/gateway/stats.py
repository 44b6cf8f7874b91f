"""Per-request wire-level stats and the goodput-under-SLO metric.

DistServe's argument (PAPERS.md, arXiv:2401.09670) is that serving
systems must be judged at the *request interface* by the rate of
requests meeting their latency SLOs — goodput — not by engine-internal
timings. The gateway therefore stamps every request's life at the wire:

    arrival       the request was parsed off the socket
    admission     the engine actually admitted it (prefill scheduled) —
                  ``arrival → admission`` is the queueing delay, covering
                  both the gateway's replica queue and the engine's own
                  admission queue
    first_event   the first token event left for the client (TTFT at the
                  interface the user sees)
    finish        the terminal event left (finish_reason delivered)

Wall clocks are ``time.monotonic()`` on the gateway host; a trace is
internally consistent but not comparable across hosts.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class WireTrace:
    """One request's wire-level life (all times ``time.monotonic()`` s)."""

    request_id: int
    replica: str = ""
    arrival: float = 0.0
    admission: Optional[float] = None
    first_event: Optional[float] = None
    finish: Optional[float] = None
    n_tokens: int = 0
    finish_reason: Optional[str] = None
    token_times: List[float] = field(default_factory=list)

    def mark_token(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        if self.first_event is None:
            self.first_event = now
        self.n_tokens += 1
        self.token_times.append(now)

    @property
    def queue_s(self) -> Optional[float]:
        if self.admission is None:
            return None
        return max(0.0, self.admission - self.arrival)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_event is None:
            return None
        return self.first_event - self.arrival

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean per-output-token latency past the first token (the SLO
        unit DistServe budgets decode with); None with < 2 tokens."""
        if self.n_tokens < 2 or self.first_event is None or \
                self.finish is None:
            return None
        return (self.token_times[-1] - self.first_event) / \
            (self.n_tokens - 1)

    def as_dict(self) -> dict:
        ms = lambda v: None if v is None else v * 1e3
        return {"request_id": self.request_id, "replica": self.replica,
                "queue_ms": ms(self.queue_s), "ttft_ms": ms(self.ttft_s),
                "tpot_ms": ms(self.tpot_s), "n_tokens": self.n_tokens,
                "finish_reason": self.finish_reason}


def goodput_under_slo(traces: List[WireTrace], slo_ttft_ms: float,
                      slo_tpot_ms: float, window_s: float) -> dict:
    """Requests/s meeting BOTH latency targets (DistServe-style goodput).

    A request counts iff it finished, its wire TTFT ≤ ``slo_ttft_ms`` and
    its mean wire TPOT ≤ ``slo_tpot_ms`` (single-token requests have no
    TPOT and are judged on TTFT alone). ``window_s`` is the measurement
    window the rate is taken over (the trace's makespan).
    """
    met = 0
    for t in traces:
        if t.finish is None or t.ttft_s is None:
            continue
        if t.ttft_s * 1e3 > slo_ttft_ms:
            continue
        tpot = t.tpot_s
        if tpot is not None and tpot * 1e3 > slo_tpot_ms:
            continue
        met += 1
    return {
        "slo_ttft_ms": float(slo_ttft_ms),
        "slo_tpot_ms": float(slo_tpot_ms),
        "requests_total": len(traces),
        "requests_met": met,
        "attainment": float(met / len(traces)) if traces else 0.0,
        "goodput_rps": float(met / window_s) if window_s > 0 else 0.0,
    }


def _pcts(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
    ys = sorted(xs)
    pick = lambda q: ys[min(len(ys) - 1, int(round(q * (len(ys) - 1))))]
    return {"p50": pick(0.50), "p95": pick(0.95), "p99": pick(0.99)}


def summarize_traces(traces: List[WireTrace]) -> dict:
    """Percentile table over a trace set (ms) — the same decomposition as
    ``benchmarks/fig_latency`` (TTFT / TPOT / queue), measured at the
    wire. Pure stdlib (sorted-order percentiles) so the gateway's stats
    endpoint carries no numpy dependency."""
    ttft = [t.ttft_s * 1e3 for t in traces if t.ttft_s is not None]
    tpot = [t.tpot_s * 1e3 for t in traces if t.tpot_s is not None]
    queue = [t.queue_s * 1e3 for t in traces if t.queue_s is not None]
    return {"n": len(traces),
            "finished": sum(1 for t in traces if t.finish is not None),
            "ttft_ms": _pcts(ttft), "tpot_ms": _pcts(tpot),
            "queue_ms": _pcts(queue)}


__all__ = ["WireTrace", "goodput_under_slo", "summarize_traces"]
