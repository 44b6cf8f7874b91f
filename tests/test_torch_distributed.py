"""The port's distribution slice against the reference, on the CPU.

One JAX subprocess (8 forced host devices, ``torch_dist_jax_ref.py``)
writes the reference's outputs; one gloo job of 8 CPU processes
(``torch_dist_worker.py``) runs the port's counterparts on the same numpy
inputs and weights, and holds them:

* S1 and ``vocab_gather`` planes at (2, 4), B = 16, V = 256: tokens and
  histograms equal the reference's exactly, 3 steps;
* ``hierarchical_sample`` at (2, 4), B = 16, V = 500 (four parameter sets)
  and V = 502 (padded blocks): tokens, accepted, exact_fast and
  histograms exact, alpha within 1e-6 relative;
* the EP MoE (reduced f32 granite: 4 experts, d_ff_expert 512) at (2, 4)
  under ``REPRO_MOE_STRATEGY=gather`` and ``=scatter``: output within
  2e-4 absolute + 2e-4 relative of the reference's EP output, aux within
  1e-5 relative of its EP aux;
* the port's distributed plane (S1 with shvs, fused, gumbel;
  vocab_gather; hierarchical) equals its own single-device plane;
* reduced smollm and granite decode steps at (2, 2) and (1, 4) (two
  replicas over the 8 ranks): logits blocks equal the single-process
  logits' slices within 1e-5 (abs + rel), greedy tokens equal;
* the collective wrappers against their definitions, and
  ``make_local_mesh(2, 4)``'s shape.
"""
import json
import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORLD = 8


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    env.pop("REPRO_MOE_STRATEGY", None)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    ref = str(d / "ref.npz")
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_dist_jax_ref.py"), ref],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    path = str(d / "results.json")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_worker.py"),
         str(r), str(WORLD), str(port), ref, path], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            if p.returncode:
                errs.append(err[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert not errs, errs[0]
    with open(path) as f:
        return json.load(f)


def _held(results, name):
    r = results[name]
    assert r["ok"], (name, r)


def test_local_mesh_shape(results):
    assert results["mesh_shape"] == {"data": 2, "model": 4}


def test_collectives(results):
    _held(results, "collectives")
    # gloo takes CPU tensors for every collective: nothing staged
    assert results["staged"] == []


@pytest.mark.parametrize("mode", ["sequence_parallel", "vocab_gather"])
def test_sp_planes_match_reference(results, mode):
    _held(results, f"sp_reference_{mode}")


@pytest.mark.parametrize("case", ["tau1", "greedy", "topk", "topp", "pad"])
def test_hierarchical_matches_reference(results, case):
    _held(results, f"hierarchical_reference_{case}")
    _held(results, f"hierarchical_reference_single_{case}")
    assert results[f"hierarchical_reference_{case}"]["blocked"] == \
        (case != "pad")


@pytest.mark.parametrize("strategy", ["gather", "scatter"])
def test_ep_moe_matches_reference(results, strategy):
    _held(results, f"moe_reference_{strategy}")


def test_ep_moe_auto_path_follows_traffic_model(results):
    # the global batch's tokens, 2·(4·8)·256·4 = 65,536 B, against the
    # rank's f-slice gather, 3·1·256·512·4·(2−1)/2 = 786,432 B: moving the
    # activations is cheaper, so the traffic model picks the scatter path
    assert results["moe_auto_path"] == "scatter"


@pytest.mark.parametrize("run", [
    "sequence_parallel_shvs", "sequence_parallel_fused",
    "sequence_parallel_gumbel", "vocab_gather_shvs", "hierarchical_shvs",
    "hierarchical_truncation_first"])
def test_plane_equals_single_device(results, run):
    _held(results, f"plane_vs_single_{run}")


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m"])
@pytest.mark.parametrize("shape", ["2x2", "1x4"])
def test_decode_blocks(results, arch, shape):
    _held(results, f"decode_{arch}_{shape}")
    r = results[f"decode_{arch}_{shape}"]
    d, m = map(int, shape.split("x"))
    V = 512
    assert r["logits_block"] == [4 // d, V // m]
    if arch.startswith("granite"):
        assert r["expert_block"] == [2, 4 // m, 256, 512 // d]
