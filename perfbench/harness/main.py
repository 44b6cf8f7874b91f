"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line."""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import check, drive, e2e, guard, program, spec, stats
from . import weights as W
from .profile import DeviceTrace, Profiler

ROOT = Path(__file__).resolve().parents[2]


@dataclass
class Run:
    """What the per-layer readers see of a run."""
    cell: spec.Cell
    log: drive.Log
    spans: list = field(default_factory=list)          # StepTracer events
    trace: Optional[DeviceTrace] = None
    device_name: str = ""
    profiled: tuple = (0.0, 0.0)     # host time the profiler disturbed

    def commits_in(self, t0: float, t1: float) -> list:
        return [rec for t, rec in self.log.commits if t0 <= t < t1]

    def spans_of(self, kind: str, t0: float, t1: float) -> list:
        return [e for e in self.spans
                if e.kind == kind and t0 <= e.ts < t1]

    def quiet(self) -> list:
        """The window's stretches outside the profiler's: the traced
        run's readings of the engine's own records come from these."""
        a, b = self.profiled
        ws, we = self.log.ws, self.log.we
        if b <= a:
            return [(ws, we)]
        return [(x, y) for x, y in ((ws, min(a, we)), (max(b, ws), we))
                if y > x]

    @property
    def quiet_s(self) -> float:
        return sum(b - a for a, b in self.quiet())

    def quiet_commits(self) -> list:
        return [r for a, b in self.quiet() for r in self.commits_in(a, b)]

    def quiet_spans(self, kind: str) -> list:
        return [e for a, b in self.quiet() for e in self.spans_of(kind, a, b)]


def _profile_hook(cell, prof: Profiler):
    """Profile ``profile_s`` seconds around the window's middle."""
    length = cell.settings["trace"]["profile_s"]

    def hook(now, log):
        if prof.state == "idle" and now >= (log.ws + log.we - length) / 2:
            prof.start()
        elif prof.state == "on" and now >= prof.t0 + length:
            prof.stop()
    return hook


def breakdown(run: Run) -> dict:
    """The device operations that took most time, and the longest idle
    stretches by what the host was doing then (the innermost engine span
    or the load loop's phase around the stretch's middle)."""
    tr = run.trace
    by_op: Dict[str, float] = {}
    for name, a, b, _ in tr.ops:
        by_op[name] = by_op.get(name, 0.0) + (b - a)
    host = [(e.ts, e.end, e.kind) for e in run.spans if e.ph == "X"
            and e.track == "MainThread"]
    host += [(a, b, "engine.step (outside spans)") for a, b in run.log.steps]
    by_gap: Dict[str, float] = {}
    for a, b in stats.gaps(tr.intervals(), tr.t0, tr.t1):
        mid = (a + b) / 2
        around = [(e - s, k) for s, e, k in host if s <= mid < e]
        label = min(around)[1] if around else "between steps"
        by_gap[label] = by_gap.get(label, 0.0) + (b - a)
    top = lambda d: [[k, v] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}


def one_run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: Optional[float] = None,
            control: bool = False) -> dict:
    """Set up, drive, measure and compare one run; returns the result
    (the result line's keys, and ``check`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    mix = cell.traffic
    s = cell.settings["engine"]
    params = W.make(cell.config, seed, dev)
    eng = program.build_engine(cell, params, seed, dev, trace)
    vocab = cell.config["vocab_size"]
    drive.warm_up(eng, mix, vocab, s["slots"], seed)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    prof = Profiler()
    hook = _profile_hook(cell, prof) if trace and cuda else None
    log = drive.run(eng, mix, seed, vocab, s["slots"], seconds, hook)
    if prof.state == "on":
        prof.stop()
    device_trace = prof.read() if prof.state == "done" else None
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    found = guard.banned_modules()
    if found:
        print(f"banned modules loaded: {found}", file=sys.stderr)
        raise SystemExit(4)
    run = Run(cell=cell, log=log, spans=list(eng.tracer.events())
              if trace else [], trace=device_trace,
              device_name=torch.cuda.get_device_name(dev) if cuda else "cpu",
              profiled=prof.busy)
    eng.close()
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    verdict = check.judge(cell, params, log, seed, control=control)
    metrics: Dict[str, dict] = {}
    if not trace:
        for m in cell.end_to_end:
            metrics[m.name] = {"value": e2e.value(m.name, log, setup_s),
                               "unit": m.unit}
    else:
        readers = spec.readers(cell)
        for m in cell.per_layer:
            v = readers[m.name](m.name, run)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
    lateness = [sv.submitted - sv.due for sv in log.served
                if sv.spec.due is not None]
    out = {"correct": verdict["correct"] and log.drained,
           "attempted": verdict["attempted"], "failed": verdict["failed"],
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": run.device_name,
                      "count": cell.chips if cuda else 0,
                      "memory_peak_bytes": int(peak)}}
    if run.trace is not None:
        busy = stats.busy(run.trace.intervals(), run.trace.t0, run.trace.t1)
        out["device"].update(busy_s=busy,
                             window_s=run.trace.t1 - run.trace.t0)
        out["breakdown"] = breakdown(run)
    out["run"] = {"seed": seed, "seconds": seconds, "setup_s": setup_s,
                  "window_requests": len(e2e.window_requests(log)),
                  "served": len(log.served), "steps": len(log.steps),
                  "drained": log.drained,
                  "drain_s": log.t_end - log.we,
                  "generator_late_p50_ms": _pct(lateness, 50),
                  "generator_late_max_ms": _pct(lateness, 100),
                  "rate_rps": mix.get("rate_rps"),
                  "queue_depth": _queue(log),
                  "tokens_compared": verdict["tokens_compared"],
                  "greedy_tokens": verdict["greedy_tokens"],
                  "readings": verdict["readings"]}
    if control:
        out["run"].update(control=verdict["control"],
                          control_correct=verdict["control_correct"],
                          control_compared=verdict["control_compared"])
    if cuda:
        out["run"]["power_limit"] = guard.power_limit()
    out["check"] = verdict["compared"]
    return out


def _queue(log) -> Optional[list]:
    """The waiting queue's mean depth over the first and the last
    quarter of the window's committed steps (the knee sweep's growth)."""
    qs = [rec.queue_depth for t, rec in log.commits
          if log.ws <= t < log.we and rec.queue_depth is not None]
    if len(qs) < 4:
        return None
    n = len(qs) // 4
    return [sum(qs[:n]) / n, sum(qs[-n:]) / n]


def _pct(xs: List[float], q: float) -> Optional[float]:
    return stats.percentile(xs, q) * 1e3 if xs else None


def parse(argv):
    p = argparse.ArgumentParser(
        description="Run one benchmark cell once and print its result line.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None) -> int:
    args = parse(argv)
    bench_json = ROOT / "BENCHMARK.json"
    cell = spec.load_cell(args.workload, bench_json)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = one_run(cell, args.seed, args.seconds, bool(args.trace),
                  "cuda", t_start=t_start)
    check.print_compared(out["check"])
    print(json.dumps(out))
    return 0
