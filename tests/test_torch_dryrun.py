"""The port's dry-run (``repro_torch.launch.dryrun``), its trace counts
(``launch/hlo_parse.py``, ``hlo_analysis.analyze_program``) and its
report, on the CPU.

* Three combinations, each through ``python -m repro_torch.launch.dryrun
  --device cpu`` in a subprocess (run side by side, with the reference's
  own dry-run of whisper-base in a JAX subprocess): whisper-base
  ``decode_32k``, smollm-360m ``train_4k`` (the train step under the
  mesh: forward, backward, the gradient sum and the norm) and rwkv6-3b
  ``decode_32k`` (40 heads over 16 model ranks: the WKV recurrence split
  by value columns) on 16×16, each ``1/1 ok``.
* whisper-base against the reference's record: the reference's keys are
  a subset of the port's, ``model_flops`` and ``hlo_bytes`` (the analytic
  models) are equal, and the trace's dot FLOPs · chips lie between
  ``model_flops`` and 16 times it (16 = the model axes' size: what they do
  not split — here the LM head of V = 51865 and the cross attention over
  1500 frames, neither a multiple of 16 — runs on each of their ranks,
  and model_flops counts no attention over the context).
* ``launch/report.py`` tabulates the port's record beside the
  reference's.
* A program of known matmuls on fake tensors gives its dot FLOPs (a
  GEMM's 2·M·N·K, its backward's twice that) and its traffic bytes
  exactly.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.launch import hlo_parse, report

from test_torch_distributed import HERE, _env  # noqa: E402

COMBOS = (("whisper-base", "decode_32k"), ("smollm-360m", "train_4k"),
          ("rwkv6-3b", "decode_32k"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    root = os.path.join(HERE, "..")
    procs = {}
    for arch, shape in COMBOS:
        procs[(arch, shape)] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--device", "cpu",
             "--out", str(d / f"{arch}.jsonl")],
            env=_env(), cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    procs["reference"] = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.dryrun", "--arch",
         "whisper-base", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(d / "reference.jsonl")],
        env=_env(), cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for key, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            out[key] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return d, out


def _record(path):
    with open(path) as f:
        return json.loads(f.read().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_dryrun_combination_ok(runs, arch, shape):
    d, out = runs
    rc, stdout, stderr = out[(arch, shape)]
    assert rc == 0, stderr[-4000:]
    assert "dry-run complete: 1/1 ok" in stdout
    r = _record(d / f"{arch}.jsonl")
    assert r["status"] == "ok" and r["package"] == "repro_torch"
    assert r["mesh"] == "16x16" and r["chips"] == 256
    assert r["compile_s"] == 0.0 and r["lower_s"] > 0
    # the rank's program runs collectives over the fake group and GEMMs
    assert sum(r["collective_counts"].values()) > 0
    assert r["parsed_dot_flops"] > 0
    assert r["hlo_flops"] == max(r["parsed_dot_flops"], r["model_flops"])
    ma = r["memory_analysis"]
    assert ma["argument_size_in_bytes"] > 0
    assert r["bytes_per_device"] == pytest.approx(
        sum(ma[k] for k in ("argument_size_in_bytes", "output_size_in_bytes",
                            "temp_size_in_bytes")))


def test_whisper_record_matches_reference(runs):
    d, out = runs
    rc, _, stderr = out["reference"]
    assert rc == 0, stderr[-4000:]
    ref = _record(d / "reference.jsonl")
    port = _record(d / "whisper-base.jsonl")
    assert set(ref) <= set(port)
    assert port["model_flops"] == ref["model_flops"]
    assert port["hlo_bytes"] == ref["hlo_bytes"]
    ratio = port["parsed_dot_flops"] / port["model_flops"]
    assert 1.0 <= ratio <= 16.0, ratio


def test_report_tabulates_both_packages(runs, capsys):
    d, _ = runs
    report.main([str(d / "whisper-base.jsonl"), str(d / "reference.jsonl")])
    text = capsys.readouterr().out
    rows = [line for line in text.splitlines()
            if "| whisper-base | decode_32k |" in line]
    # the roofline and the records table, one row a package each
    assert len(rows) == 4
    assert sum(line.startswith("| repro_torch |") for line in rows) == 2
    assert sum(line.startswith("| repro |") for line in rows) == 2
    assert "repro_torch: 1/1 combinations ok" in text
    assert "repro: 1/1 combinations ok" in text


def test_known_program_counts_exactly():
    M, K, N = 64, 128, 256
    with FakeTensorMode():
        x = torch.empty(M, K, dtype=torch.bfloat16)
        w = torch.empty(K, N, dtype=torch.bfloat16, requires_grad=True)

        def fwd(x, w):
            return x @ w

        def train(x, w):
            (g,) = torch.autograd.grad((x @ w).float().sum(), [w])
            return g

        fwd_stats = hlo_parse.ProgramStats(fwd, x, w)
        train_stats = hlo_parse.ProgramStats(train, x, w)
    assert fwd_stats.dot_flops == 2 * M * N * K
    # the backward's dW = xᵀ·dY is one more GEMM of the same size
    assert train_stats.dot_flops == 2 * (2 * M * N * K) == 8_388_608
    # one mm: x and w read, the result written
    assert fwd_stats.traffic == 2 * (M * K + K * N + M * N)
    assert fwd_stats.ops == 1
    assert fwd_stats.argument_bytes == 2 * (M * K + K * N)
    assert fwd_stats.output_bytes == 2 * M * N
    assert fwd_stats.peak_bytes == 2 * (M * K + K * N + M * N)
    totals = hlo_parse.analyze_trace(fwd, x, w)
    assert sorted(totals) == sorted(["collective_bytes",
                                     "collective_bytes_by_kind",
                                     "collective_counts", "dot_flops",
                                     "traffic_bytes"])
