"""The decode step replayed as CUDA graphs.

An eager decode step of the port is thousands of small launches, and at
B = 128 slots the host takes longer to enqueue them (65-80 ms a step on
an H100's host) than the card takes to run them. A CUDA graph captured
once replays the same kernels, on the same shapes and in the same order,
for one launch of the host. The engine (``engine/engine.py``) captures
the very functions its eager step runs, so the tokens are bit-equal
(``tests/test_torch_graph.py``).

**Two graphs.** The *forward graph* is ``Engine._forward_impl``: the
decode forward, the cache write and the ``len`` advance under the active
mask. The *decide graph* is ``Engine._decide_impl``: ``DecisionPlane.step``
from the logits to tokens, histograms and stats, and the ``where(active,
tokens, 0)``. Device placement replays both back to back; host placement
replays the forward alone and hands the logits' copy to the pool. The
split keeps the spans honest: ``dispatch`` times both replays,
``device_sample`` the decide graph's.

**Static inputs, state aliased in place.** A graph reads and writes the
tensors it was captured over. The per-step inputs have one device buffer
each (the active mask, the (B, 3) uniforms, the last tokens), into which
each step copies its values on the stream (:func:`bind`): behind the
step in flight, so nothing it still reads is overwritten. The uniforms
are still drawn on the host (``core/rng.py``) and handed to the plane as
a tensor (``DecisionPlane.step(uniforms=)``). The rows' sampling
contract and bias rows are copied in only after a row has changed
(``SlotParams`` then builds new immutable tensors). The state is the
engine's own tensors: the cache leaves, ``len`` and the histograms, and
what a program returns out of place (``len``, a recurrent state, the new
output histogram) is copied back into them inside the graph. So
admissions, migration imports, chunks and preemption keep writing rows
in place that the next replay reads; where a path replaces a tensor
instead (a chunk's new ``len``, the paged cache's block table),
:func:`bind` copies the new one into the graph's before the replay and
the engine takes the graph's back.

**Variants, captured lazily.** A variant's first use runs eagerly (it
builds and loads what a capture cannot: the kernel library, cuBLAS's
handles, the allocator's blocks) and its second captures it, at B =
``max_batch``. The variants are what the engine observes: the forward
(one an engine: its cache kind is fixed), the decision with and without
bias rows, and each with the engine's tracer on or off. A backend whose draw
reads the step index as a host integer (``SamplerBackend.keys_step``)
decides eagerly behind a replayed forward. Graphs are captured only on a
CUDA device with no active mesh; anywhere else the step is the eager one.

**Invalidation.** A graph remembers the object it was captured under
(the weights for the forward, the sampler backend for the decision) and
is captured again when that changes. A hot-set swap and a placement
switch (the histograms move) drop the decide graph, ``close`` drops
both; a dropped variant runs eagerly once and is captured again.

**Capture** (:func:`capture`) records on a side stream in thread-local
mode (a gateway's other replicas and a pool's workers go on calling CUDA
meanwhile) and synchronises nothing. No CUDA event is recorded into a
graph: a span the captured function opens through ``obs.tracer.current()``
(an MoE layer's ``moe_route``) ends the graph there and starts the next,
and each replay opens and closes the same span on the tracer current at
the replay between the graphs' replays, so a replayed step is timed as
an eager one is. With no tracer enabled the step is one graph. The
kernels' launch counters (``kernels/ops.launch_counts``) count what ran:
a capture's calls of the wrappers are taken back, and every replay adds
them.
"""
from __future__ import annotations

import gc
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build, ops
from repro_torch.obs import tracer as obs_tracer


class _Open(NamedTuple):
    """A span the captured function opened: opened again at each replay
    between the graphs before and after it."""

    kind: str
    name: Optional[str]
    track: Optional[str]
    device: Any
    args: dict


_CLOSE = object()     # the innermost open span's end


class Program:
    """A captured function: its CUDA graphs, to replay in turn, the spans
    it opened between them, and the kernel launches a replay makes."""

    __slots__ = ("parts", "launches")

    def __init__(self, parts: List[Any], launches: List[tuple]):
        self.parts = parts
        self.launches = launches

    def replay(self) -> None:
        tracer = obs_tracer.current()
        spans = []
        for part in self.parts:
            if part is _CLOSE:
                spans.pop().__exit__(None, None, None)
            elif type(part) is _Open:
                span = tracer.span(part.kind, name=part.name,
                                   track=part.track, device=part.device,
                                   **part.args)
                span.__enter__()
                spans.append(span)
            else:
                part.replay()
        if self.launches:
            with _build.COUNT_LOCK:
                for kernel, n in self.launches:
                    kernel.launches += n


class StepGraph:
    """One captured program of the engine's step.

    ``inputs``: the tensors the graph reads in place of its inputs (and
    writes, for state), as the caller lays them out; ``out``: what the
    captured function returned — tensors the graph writes on every
    replay; ``owner``: the object whose identity the program was captured
    under (the weights, the sampler backend): a graph whose owner has
    changed is stale."""

    __slots__ = ("graph", "inputs", "out", "owner", "sources")

    def __init__(self, graph, inputs: Any, out: Any, owner: Any):
        self.graph = graph
        self.inputs = inputs
        self.out = out
        self.owner = owner
        #: the immutable objects last copied into ``inputs`` (per slot of
        #: the caller's choosing), so an unchanged source is not copied
        self.sources: dict = {}

    def replay(self) -> None:
        self.graph.replay()


class _SplitSpan:
    """A span opened under capture: the graph ends at its entry and at its
    exit, and the span is noted between them."""

    __slots__ = ("split", "mark")

    def __init__(self, split, mark: _Open):
        self.split, self.mark = split, mark

    def __enter__(self) -> "_SplitSpan":
        self.split(self.mark)
        return self

    def __exit__(self, *exc) -> bool:
        self.split(_CLOSE)
        return False

    def set(self, **args) -> None:
        self.mark.args.update(args)


class _Splitter:
    """The tracer current while a traced step is captured."""

    enabled = True

    def __init__(self, split):
        self._split = split

    def span(self, kind: str, name: Optional[str] = None,
             track: Optional[str] = None, device=None, **args):
        return _SplitSpan(self._split, _Open(kind, name, track, device, args))


def capture(device: torch.device, fn: Callable[[], Any],
            stream: "torch.cuda.Stream") -> Tuple[Program, Any]:
    """Capture ``fn()`` on ``stream`` (not the current stream: a capture
    needs one of its own); returns ``(program, fn's result)``. Nothing
    runs until the program is replayed.

    The capture is thread-local: other threads' CUDA calls go on meanwhile
    (a gateway's replicas, a host pool's workers waiting on their
    copies). Python's garbage collector is held off while it runs: a
    collection in this thread could destroy another engine's graphs,
    which a capture forbids. Where this thread's tracer is enabled, each
    span ``fn`` opens through ``obs.tracer.current()`` splits the capture
    into graphs of one memory pool, replayed in the order captured.
    Nothing here synchronises the device."""
    pool = torch.cuda.graph_pool_handle()
    parts: List[Any] = []

    def begin() -> None:
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        parts.append(graph)

    def split(mark) -> None:
        parts[-1].capture_end()
        parts.append(mark)
        begin()

    tracer = _Splitter(split) if obs_tracer.current().enabled \
        else obs_tracer.NULL_TRACER
    before = [k.launches for k in ops.KERNELS]
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.device(device), torch.cuda.stream(stream), \
                obs_tracer.use(tracer):
            begin()
            try:
                out = fn()
            finally:
                parts[-1].capture_end()
    finally:
        if collecting:
            gc.enable()
    launches = []
    with _build.COUNT_LOCK:
        for kernel, n0 in zip(ops.KERNELS, before):
            if kernel.launches != n0:
                launches.append((kernel, kernel.launches - n0))
                kernel.launches = n0
    return Program(parts, launches), out


def bind(static: torch.Tensor, value) -> torch.Tensor:
    """Copy ``value`` (a tensor or a host array) into ``static`` on the
    current stream, unless it is ``static`` itself; returns ``static``.

    The copy lands behind the work already on the stream, so the step in
    flight still reads the old values. A host array is pageable memory,
    which the CUDA runtime stages before the call returns: the host may
    reuse it at once."""
    if value is static:
        return static
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(value)
    static.copy_(value, non_blocking=True)
    return static


__all__ = ["StepGraph", "Program", "capture", "bind"]
