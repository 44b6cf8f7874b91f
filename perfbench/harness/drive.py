"""The load loop: offers a mix's requests to the engine through
``submit()`` and steps it with ``step()``, from one thread.

Open loop: each request is submitted once it is due and stamped with its
due time as ``arrival_time``, so a stall counts against every request
behind it; the generator stops when the window closes and the requests
due in the window drain. Saturated: the waiting queue is topped up to
``queue`` requests before every step, so it never empties.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

from . import program, traffic


@dataclass
class Served:
    """A submitted request with what the benchmark knows of it."""
    spec: traffic.Spec
    request: object                  # repro_torch Request
    due: float                       # host clock
    submitted: float


@dataclass
class Log:
    ws: float = 0.0                  # window opens
    we: float = 0.0                  # window closes
    t_end: float = 0.0               # drain ends
    served: List[Served] = field(default_factory=list)
    commits: List[Tuple[float, object]] = field(default_factory=list)
    steps: List[Tuple[float, float]] = field(default_factory=list)
    drained: bool = True


def _step(eng, log: Log) -> None:
    t0 = time.perf_counter()
    rec = eng.step()
    t1 = time.perf_counter()
    log.steps.append((t0, t1))
    if rec:
        log.commits.append((t1, rec))


def warm_up(eng, mix: dict, vocab: int, slots: int, seed: int) -> None:
    """Serve a short batch first: the longest prompt the mix sends, in
    as many rows as one admission of this cell takes, then decode steps
    at the full batch, so the kernel library is built and loaded and the
    allocator holds its largest blocks before the window."""
    n = min(slots, mix.get("warm_rows", 8))
    longest = mix["prompt"]["max"]
    it = traffic.generate(mix, seed, vocab, 0)
    reqs = []
    for i in range(n):
        spec = next(it)
        spec = traffic.Spec(index=-1, due=None,
                            prompt=np.resize(spec.prompt, longest),
                            max_new=4, contract=spec.contract,
                            greedy=spec.greedy)
        reqs.append(program.request(spec, 0.0, 2 ** 31 + i))
    eng.submit(reqs)
    while eng.scheduler.has_work or eng.in_flight:
        eng.step()
    eng.flush()


def run(eng, mix: dict, seed: int, vocab: int, slots: int, seconds: float,
        hook: Optional[Callable[[float, Log], None]] = None) -> Log:
    """Drive one run: ``mix['ramp_s']`` of traffic, then the window of
    ``seconds``, then (open loop) the drain. ``hook(now, log)`` is called
    between steps (the traced run starts and stops the profiler there)."""
    log = Log()
    gen = traffic.generate(mix, seed, vocab, slots)
    open_loop = mix["kind"] == "open_loop"
    t0 = time.perf_counter()           # the traffic starts
    log.ws = t0 + mix["ramp_s"]
    log.we = log.ws + seconds
    drain_until = log.we + mix.get("drain_s", 60.0)
    nxt = next(gen)

    def submit(specs, now):
        reqs = []
        for s in specs:
            due = t0 + s.due if s.due is not None else now
            r = program.request(s, due, s.index)
            log.served.append(Served(s, r, due, now))
            reqs.append(r)
        eng.submit(reqs)

    if not open_loop:
        first = [nxt] + [next(gen) for _ in range(slots + mix["queue"] - 1)]
        submit(first, time.perf_counter())
        nxt = next(gen)
    while True:
        now = time.perf_counter()
        if hook is not None:
            hook(now, log)
        if open_loop:
            due = []
            while t0 + nxt.due <= now and t0 + nxt.due < log.we:
                due.append(nxt)
                nxt = next(gen)
            if due:
                submit(due, now)
            if now >= log.we:
                window = [s for s in log.served if s.due >= log.ws]
                if all(s.request.done or s.request.should_stop()
                       for s in window):
                    break
                if now >= drain_until:
                    log.drained = False
                    break
        else:
            if now >= log.we:
                break
            short = mix["queue"] - len(eng.scheduler.waiting)
            if short > 0:
                batch = [nxt] + [next(gen) for _ in range(short - 1)]
                nxt = next(gen)
                submit(batch, now)
        if eng.scheduler.has_work or eng.in_flight:
            _step(eng, log)
        elif open_loop:
            time.sleep(max(0.0, min(0.002, t0 + nxt.due - now)))
    eng.flush()
    log.t_end = time.perf_counter()
    return log
