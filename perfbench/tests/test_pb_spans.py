"""The readers of the engine's device-timed spans on synthetic runs:
``dispatch_ms``, ``sample_share`` and ``moe_route_share`` outside the
profiler's stretch, and ``None`` where the spans carry no device time."""
from types import SimpleNamespace as NS

import pytest

from perfbench.harness import drive, spec
from perfbench.harness.main import Run


def _cell(name):
    return spec.load_cell(name, spec.BENCH_DIR.parent / "BENCHMARK.json")


def _span(kind, ts, dur, **args):
    return NS(kind=kind, ph="X", ts=ts, dur=dur, track="MainThread",
              args=tuple(sorted(args.items())))


def _spans_run(spans, name="granite-moe.chat"):
    """A window of 4 s whose second second the profiler disturbed."""
    return Run(cell=_cell(name), log=drive.Log(ws=99.0, we=103.0),
               spans=spans, profiled=(100.0, 101.0))


def test_dispatch_ms_reads_outside_the_profiler():
    read = spec.load_reader("dispatch_ms")
    run = _spans_run([_span("dispatch", 99.5, 0.02, step=1, rows=3),
                      _span("dispatch", 100.5, 1.0, step=2, rows=3),
                      _span("dispatch", 101.5, 0.04, step=3, rows=3),
                      _span("forward", 99.5, 0.5, step=1)])
    assert read("dispatch_ms.chat", run) == pytest.approx(30.0)
    assert read("dispatch_ms.decode", _spans_run([])) is None


def test_sample_share_pairs_decode_decisions_with_their_dispatch():
    read = spec.load_reader("sample_share")
    spans = [_span("dispatch", 99.1, 0.01, step=1, device_ms=10.0),
             _span("dispatch", 99.2, 0.01, step=2, device_ms=20.0),
             _span("dispatch", 99.3, 0.01, step=3),         # unresolved
             _span("dispatch", 100.5, 0.01, step=4, device_ms=40.0),
             _span("device_sample", 99.11, 0.001, program="decode", step=1,
                   rows=4, device_ms=1.0),
             _span("device_sample", 99.21, 0.001, program="decode", step=2,
                   rows=4, device_ms=3.0),
             _span("device_sample", 99.31, 0.001, program="decode", step=3,
                   rows=4, device_ms=0.5),
             _span("device_sample", 100.51, 0.001, program="decode",
                   step=4, rows=4, device_ms=9.0),   # in the profiler's
             _span("device_sample", 99.4, 0.001, program="prefill", step=1,
                   rows=2, device_ms=5.0)]
    assert read("sample_share.chat", _spans_run(spans)) == \
        pytest.approx(4.0 / 30.0 * 100)
    bare = [_span(e.kind, e.ts, e.dur, **{k: v for k, v in e.args
                                         if k != "device_ms"})
            for e in spans]
    assert read("sample_share.decode", _spans_run(bare)) is None


def test_moe_route_share_over_the_quiet_window():
    read = spec.load_reader("moe_route_share")
    spans = [_span("moe_route", 99.5, 0.001, pairs=16, device_ms=300.0),
             _span("moe_route", 102.0, 0.001, pairs=16, device_ms=600.0),
             _span("moe_route", 100.5, 0.001, pairs=16, device_ms=1000.0),
             _span("moe_route", 102.5, 0.001, pairs=16)]     # unresolved
    assert read("moe_route_share.chat", _spans_run(spans)) == \
        pytest.approx(0.9 / 3.0 * 100)
    assert read("moe_route_share.chat", _spans_run(
        [_span("moe_route", 99.5, 0.001, pairs=16)])) is None
