"""What one rank's program does, read from a trace of it.

The reference's ``launch/hlo_parse.py`` reads the optimized HLO text of a
compiled XLA program: dot FLOPs, a traffic proxy and the collectives,
multiplied along the call graph by the loops' trip counts. A torch program
has no HLO text. This twin runs the program itself, as one rank, on fake
tensors (``torch._subclasses.fake_tensor.FakeTensorMode``: shapes and
dtypes, nothing allocated or computed) and counts what its aten ops do:

  * dot FLOPs      — ``torch.utils.flop_counter``'s formulas (the table
    ``FlopCounterMode`` counts by: 2 · M · N · K a matmul, its backward's
    too, the convolutions and attention), applied in the same pass;
  * traffic bytes  — Σ (operand bytes + result bytes) over every op but
    views and metadata queries (:class:`ProgramTrace`): no op fuses here,
    so this is the fusion-blind upper bound the reference's text scan
    also is;
  * collectives    — what ``models/dist.py``'s wrappers counted
    (``dist.collective_stats()``), the bytes a rank receives under the
    conventions of ``launch/hlo_analysis.py``;
  * peak bytes     — the most bytes the program's live tensors (its
    arguments, and every storage an op made, until it is freed) held at
    once: the trace's counterpart of the compiled program's memory
    analysis.

A Python loop (RWKV-6's and Mamba2's recurrences over time) is traced
step by step, so no trip count is needed; the trace costs its length.
"""
from __future__ import annotations

import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.hlo_analysis import _KIND
from repro_torch.models import dist


def _tensors(tree, out=None):
    """The tensors of an op's arguments or results (tuples, lists and dicts
    of them), in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ProgramTrace(TorchDispatchMode):
    """Counts every op's dot FLOPs, its operand and result bytes (views
    and ``prim`` metadata queries left out: they move nothing) and the
    live storages' peak bytes. ``hold``: the tensors alive from the start
    (the program's arguments)."""

    def __init__(self, hold=()):
        super().__init__()
        self.flops = 0
        self.traffic = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, weakref.ref] = {}
        for t in hold:
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)

        def freed(_, key=key, n=n):
            self.live -= n
            self._seen.pop(key, None)

        self._seen[key] = weakref.ref(st, freed)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not func.is_view and func.namespace != "prim":
            self.ops += 1
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
            self.traffic += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.traffic += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out


class ProgramStats:
    """One traced run of ``fn(*args)`` (the twin of the reference's
    ``HloModuleStats``): the counts of the module docstring, per rank."""

    def __init__(self, fn, *args):
        held = _tensors(args)
        dist.reset_collective_stats()
        with ProgramTrace(hold=held) as trace:
            self.outputs = fn(*args)
        self.dot_flops = float(trace.flops)
        self.traffic = float(trace.traffic)
        self.ops = trace.ops
        self.argument_bytes = float(sum(_nbytes(t) for t in held))
        self.output_bytes = float(sum(_nbytes(t)
                                      for t in _tensors(self.outputs)))
        self.peak_bytes = float(trace.peak)
        self.collectives = dist.collective_stats()

    def totals(self) -> dict:
        coll, counts = {}, {}
        for name, st in self.collectives.items():
            kind = _KIND[name]
            coll[kind] = coll.get(kind, 0.0) + float(st["received"])
            counts[kind] = counts.get(kind, 0.0) + float(st["calls"])
        return {
            "collective_bytes": sum(coll.values()),
            "collective_bytes_by_kind": coll,
            "collective_counts": counts,
            "dot_flops": self.dot_flops,
            "traffic_bytes": self.traffic,
        }


def analyze_trace(fn, *args) -> dict:
    """The twin of the reference's ``analyze_hlo``, with its keys, for one
    traced run of ``fn(*args)`` (call it under ``FakeTensorMode`` and the
    program's mesh)."""
    return ProgramStats(fn, *args).totals()
