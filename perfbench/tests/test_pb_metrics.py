"""The metric arithmetic on synthetic inputs: tails over every request
and gap, a rate over the window, device busy and idle from intervals,
the clock mark of a profiler trace, the readers, FLOPs and bytes."""
import json
import math
from types import SimpleNamespace as NS

import numpy as np
import pytest

from perfbench.frozen import arith
from perfbench.harness import drive, e2e, spec, stats
from perfbench.harness.main import Run
from perfbench.harness.profile import MARK, DeviceTrace, read_chrome


def test_percentile_matches_numpy_linear():
    rng = np.random.default_rng(0)
    xs = list(rng.exponential(size=257))
    for q in (50, 90, 95, 99, 100):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_busy_and_gaps_of_overlapping_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 12.0)]
    assert stats.busy(iv, 0.0, 10.0) == pytest.approx(2.0 + 1.0 + 1.0)
    assert stats.gaps(iv, 0.0, 10.0) == [(2.0, 3.0), (4.0, 9.0)]
    assert stats.busy(iv, 1.5, 3.5) == pytest.approx(1.0)


def _req(due, times, prompt=10):
    r = NS(token_times=list(times), first_token_time=times[0] if times
           else None, prompt=[1] * prompt, output=[0] * len(times))
    return drive.Served(spec=NS(due=due, greedy=False), request=r, due=due,
                        submitted=due)


def _log():
    log = drive.Log(ws=10.0, we=20.0)
    log.served = [_req(5.0, [6.0, 11.0, 12.0]),          # due before
                  _req(10.0, [10.5, 10.6, 10.7, 25.0]),
                  _req(19.0, [21.0, 21.5]),              # first token late
                  _req(20.0, [20.5])]                    # due after
    return log


def test_ttft_from_due_time_over_window_requests():
    log = _log()
    xs = [0.5, 2.0]
    assert e2e.value("ttft_p90_ms", log, 0) == pytest.approx(
        np.percentile(xs, 90) * 1e3)


def test_itl_counts_every_gap_of_window_requests():
    log = _log()
    gaps = [0.1, 0.1, 14.3, 0.5]
    assert e2e.value("itl_p95_ms", log, 0) == pytest.approx(
        np.percentile(gaps, 95) * 1e3)


def test_tokens_per_s_counts_commits_inside_the_window():
    log = _log()
    # 11.0, 12.0, 10.5, 10.6, 10.7 are inside [10, 20)
    assert e2e.value("tokens_per_s", log, 0) == pytest.approx(5 / 10)
    assert e2e.value("setup_s", log, 7.5) == 7.5
    with pytest.raises(KeyError):
        e2e.value("nonsense", log, 0)


def test_read_chrome_moves_device_ops_to_the_host_clock():
    ev = [{"ph": "X", "cat": "user_annotation", "name": MARK, "ts": 1000.0,
           "dur": 1.0},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 1500.0,
           "dur": 250.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "ts": 2000.0,
           "dur": 100.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1200.0,
           "dur": 5.0}]
    tr = read_chrome(ev, t_mark=50.0, t0=50.0, t1=51.0)
    assert [o[0] for o in tr.ops] == ["k1", "Memcpy"]
    assert tr.ops[0][1] == pytest.approx(50.0005)
    assert tr.ops[0][2] == pytest.approx(50.00075)
    assert len(tr.kernels) == 1
    with pytest.raises(RuntimeError):
        read_chrome(ev[1:], 50.0, 50.0, 51.0)


def _cell(name="rwkv6.decode"):
    return spec.load_cell(name, spec.BENCH_DIR.parent / "BENCHMARK.json")


def _run_with_trace(cell, kernels, steps, t0=100.0, t1=101.0):
    log = drive.Log(ws=99.0, we=103.0)
    log.commits = [(t0 + (i + 0.5) * (t1 - t0) / steps,
                    NS(sampler_ms=None, stall_ms=None))
                   for i in range(steps)]
    tr = DeviceTrace(t0=t0, t1=t1, ops=[(n, a, b, "kernel")
                                         for n, a, b in kernels])
    return Run(cell=cell, log=log, trace=tr,
               device_name="NVIDIA H100 80GB HBM3", profiled=(t0, t1))


def test_device_idle_and_launches_readers():
    cell = _cell()
    run = _run_with_trace(cell, [("a", 100.0, 100.25), ("b", 100.2, 100.3),
                                 ("c", 100.9, 101.2)], steps=2)
    idle = spec.load_reader("device_idle")("device_idle.decode", run)
    assert idle == pytest.approx((1 - 0.4) * 100)
    lps = spec.load_reader("launches_per_step")("launches_per_step.decode",
                                                run)
    assert lps == pytest.approx(1.5)


def test_decision_roofline_never_above_the_bound():
    cell = _cell()
    V = cell.config["vocab_size"]
    slots = cell.settings["engine"]["slots"]
    bw = arith.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"]
    least = arith.decision_bytes(slots, V) / bw
    # one decode step whose listed kernels took exactly twice the least
    run = _run_with_trace(cell, [("penalty_scale_kernel(float*)", 100.1,
                                  100.1 + least),
                                 ("shvs_masses_kernel", 100.2,
                                  100.2 + least),
                                 ("unlisted", 100.3, 100.9)], steps=1)
    r = spec.load_reader("decision_roofline")("decision_roofline.decode", run)
    assert r == pytest.approx(50.0)


def test_step_ms_reads_outside_the_profiler():
    cell = _cell()
    run = _run_with_trace(cell, [("a", 100.0, 100.1)], steps=10)
    # 10 commits inside the profiled second, 3 more outside
    run.log.commits += [(99.5, NS()), (101.5, NS()), (102.5, NS())]
    v = spec.load_reader("step_ms")("step_ms.decode", run)
    assert v == pytest.approx((4.0 - 1.0) / 3 * 1e3)


def test_token_flops_counts_active_experts_and_attention():
    cfg = json.loads((spec.BENCH_DIR / "configs" /
                      "granite-moe-1b-a400m.json").read_text())
    d, L, V = 1024, 24, 49155
    attn = d * 16 * 64 + 2 * d * 8 * 64 + 16 * 64 * d
    ffn = 8 * 3 * d * 512 + d * 32
    n = L * (attn + ffn) + d * V
    assert arith.matmul_params(cfg) == n
    assert arith.token_flops(cfg, 100) == 2 * n + L * 4 * 16 * 64 * 100
    assert arith.prompt_flops(cfg, 3) == pytest.approx(
        sum(arith.token_flops(cfg, c) for c in (1, 2, 3)))


def test_rwkv_flops_have_no_attention_term():
    cfg = json.loads((spec.BENCH_DIR / "configs" /
                      "rwkv6-3b.json").read_text())
    assert arith.token_flops(cfg, 10) == arith.token_flops(cfg, 5000)
    assert arith.prompt_flops(cfg, 7) == 7 * arith.token_flops(cfg, 0)
    # about 3 B weights a token
    assert 2.5e9 < arith.matmul_params(cfg) < 3.5e9


def test_decision_bytes_and_peaks():
    assert arith.decision_bytes(128, 49155) == 128 * 49155 * 4 + 128 * 4
    assert math.isclose(arith.peaks("NVIDIA H100 80GB HBM3")["bf16_flops"],
                        989e12)
    with pytest.raises(KeyError):
        arith.peaks("no such card")
