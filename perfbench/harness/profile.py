"""Device time from ``torch.profiler``'s trace of a stretch of the window.

The trace (CUPTI) is exported as Chrome JSON into ``$TMPDIR``, read and
deleted. A user annotation recorded at a known ``time.perf_counter``
instant puts the device's intervals on the host clock that the engine's
spans and the load loop's records use.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import List, Tuple

MARK = "perfbench.mark"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class DeviceTrace:
    t0: float                                  # host clock, seconds
    t1: float
    ops: List[Tuple[str, float, float, str]] = field(default_factory=list)
    #      (name, start, end, category) on the host clock

    @property
    def kernels(self) -> List[Tuple[str, float, float, str]]:
        return [o for o in self.ops if o[3] == "kernel"]

    def intervals(self):
        return [(a, b) for _, a, b, _ in self.ops]


def read_chrome(events: list, t_mark: float, t0: float, t1: float
                ) -> DeviceTrace:
    """The device operations of a Chrome trace's ``traceEvents``, moved to
    the host clock by the annotation ``MARK`` that began at ``t_mark``."""
    marks = [e for e in events if e.get("name") == MARK and "ts" in e]
    if not marks:
        raise RuntimeError("the profiler's trace holds no clock mark")
    offset = t_mark - float(marks[0]["ts"]) * 1e-6
    ops = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            a = float(e["ts"]) * 1e-6 + offset
            ops.append((e["name"], a, a + float(e.get("dur", 0)) * 1e-6,
                        e["cat"]))
    return DeviceTrace(t0=t0, t1=t1, ops=ops)


class Profiler:
    """Start and stop ``torch.profiler`` around a stretch of the window;
    the trace is read after the window (:meth:`read`). ``busy`` is the
    host time the profiler itself disturbed: from before its start to
    after its stop."""

    def __init__(self):
        self._prof = None
        self.state = "idle"                    # "on", then "done"
        self.t0 = self.t1 = self.t_mark = 0.0
        self.busy = (0.0, 0.0)

    def start(self) -> None:
        import torch
        from torch import profiler as tp
        t_call = time.perf_counter()
        torch.cuda.synchronize()
        self._prof = tp.profile(activities=[tp.ProfilerActivity.CPU,
                                            tp.ProfilerActivity.CUDA])
        self._prof.start()
        self.t_mark = time.perf_counter()
        with tp.record_function(MARK):
            pass
        self.t0 = self.t_mark
        self.busy = (t_call, t_call)
        self.state = "on"

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.stop()
        self.busy = (self.busy[0], time.perf_counter())
        self.state = "done"

    def read(self) -> DeviceTrace:
        """Export the stopped profiler's trace and read it."""
        fd, path = tempfile.mkstemp(prefix="perfbench_trace_",
                                    suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self._prof = None
        return read_chrome(events, self.t_mark, self.t0, self.t1)
