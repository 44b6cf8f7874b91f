"""The analytic half of ``launch/hlo_analysis.py`` against the
reference's, and its collective statistics from a gloo job.

* ``analytic_memory_bytes`` and ``model_flops_estimate`` read only the
  config and the shape: equal floats for every arch × ``SHAPES`` entry.
* ``Roofline``'s terms under the H100 SXM5 constants (989e12 bf16 FLOP/s,
  3.35e12 B/s of HBM, 450e9 B/s of NVLink a direction), its bottleneck
  and its row's keys, which are the reference's.
* ``collective_stats_from`` on ``dist.collective_stats()`` of known
  collectives over a 2-rank gloo group (``torch_dist_worker.py`` in
  "stats" mode): calls and bytes received by the reference's conventions.
"""
import importlib
import json
import os
import pkgutil
import subprocess
import sys

import pytest

import repro.configs
import repro_torch.configs
from repro.config import SHAPES, get_arch as jget
from repro.launch import hlo_analysis as jh
from repro_torch.config import ShapeConfig, get_arch as tget
from repro_torch.launch import hlo_analysis as th

from test_torch_distributed import HERE, _env, _free_port  # noqa: E402

for _pkg in (repro.configs, repro_torch.configs):
    for _m in pkgutil.iter_modules(_pkg.__path__):
        importlib.import_module(f"{_pkg.__name__}.{_m.name}")
from repro.config import ARCH_REGISTRY  # noqa: E402

ARCHS = sorted(ARCH_REGISTRY)


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_models_equal_reference(arch):
    for name, js in SHAPES.items():
        ts = ShapeConfig(**{f: getattr(js, f) for f in
                            ("name", "seq_len", "global_batch", "kind",
                             "window_override")})
        assert th.analytic_memory_bytes(tget(arch), ts) == \
            jh.analytic_memory_bytes(jget(arch), js), name
        assert th.model_flops_estimate(tget(arch), ts) == \
            jh.model_flops_estimate(jget(arch), js), name


def test_roofline_terms_under_h100_constants():
    assert (th.PEAK_FLOPS, th.HBM_BW, th.NVLINK_BW) == (989e12, 3.35e12,
                                                       450e9)
    r = th.Roofline("x", chips=4, hlo_flops=4 * 989e12, hlo_bytes=2 * 3.35e12,
                    collective_bytes=8 * 450e9, model_flops=2 * 989e12)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(0.5)
    assert r.collective_s == pytest.approx(2.0)
    assert r.bottleneck == "collective"
    assert r.useful_flops_ratio == pytest.approx(0.5)
    j = jh.Roofline("x", 4, 1.0, 1.0, 1.0, 1.0)
    assert sorted(r.row()) == sorted(j.row())


def test_collective_stats_from_a_gloo_job(tmp_path):
    path = str(tmp_path / "stats.json")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_worker.py"), str(r),
         "2", str(port), "-", path, "stats"], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-4000:]
    with open(path) as f:
        out = json.load(f)
    assert out["group"] == 2
    stats = out["stats"]
    assert {k: v["calls"] for k, v in stats.items()} == {
        "all_gather": 1, "psum": 2, "pmax": 1, "psum_scatter": 1,
        "all_to_all": 1}
    cs = th.collective_stats_from(stats, {k: 2 for k in stats})
    assert cs.count_by_kind == {"all-gather": 1, "all-reduce": 3,
                                "reduce-scatter": 1, "all-to-all": 1}
    # all-gather: (n-1)·in; all-reduce: 2·operand; reduce-scatter:
    # in - in/n; all-to-all: operand
    assert cs.bytes_by_kind == {"all-gather": 96,
                                "all-reduce": 2 * (96 + 24 + 96),
                                "reduce-scatter": 48, "all-to-all": 96}
    assert cs.total_bytes == 96 + 432 + 48 + 96
