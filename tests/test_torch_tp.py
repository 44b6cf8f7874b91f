"""The port's tensor-parallel forward and its serving programs on gloo
meshes of 8 CPU processes (``torch_dist_worker.py`` in "tp" mode, one
job), held against the port's single-process forward and the
reference's programs.

* Every family — dense (smollm-360m; qwen3-8b with qk-norm; tinyllama;
  starcoder2 with a 16-slot sliding window that a 20-token prompt wraps),
  the VLM (internvl2-2b, patch embeddings), whisper-base (encoder, cross
  attention), MoE (granite: TP attention, EP experts; llama4: the shared
  expert), RWKV-6 and Zamba2 — reduced in f32 at (2, 2), (1, 4) and
  (2, 4): after a prefill and 3 greedy decode steps each rank's logits
  block is within 1e-5 (abs + rel; Zamba2 5e-5, see
  ``torch_dist_worker.TP_TOL``) of the single-process logits' block, the
  greedy tokens are equal, the rank's weight bytes equal ``param_spec``'s
  reckoning and its cache bytes are at most ``cache_shardings``'.
* The port's per-rank prefill and serve-step programs (S1, ``shvs``) at
  (2, 4) on reduced smollm-360m: the first tokens and three serve steps'
  tokens equal the reference's jitted GSPMD programs
  (``torch_dist_jax_ref.py programs``), the logits blocks within 1e-5.
"""
import json
import os
import subprocess
import sys

import pytest

from test_torch_distributed import HERE, WORLD, _env, _free_port  # noqa: E402

ARCHS = ["smollm-360m", "qwen3-8b", "tinyllama-1.1b", "starcoder2-7b",
         "internvl2-2b", "whisper-base", "granite-moe-1b-a400m",
         "llama4-maverick-400b-a17b", "rwkv6-3b", "zamba2-1.2b"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    ref = str(d / "programs.npz")
    port = _free_port()
    path = str(d / "results.json")
    # the reference's programs run beside the first half of the job
    jax_ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_jax_ref.py"), ref,
         "programs"], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    _, err = jax_ref.communicate(timeout=300)
    assert jax_ref.returncode == 0, err[-4000:]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_worker.py"),
         str(r), str(WORLD), str(port), ref, path, "tp"], env=_env(),
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


@pytest.mark.parametrize("shape", ["2x2", "1x4", "2x4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_forward_equals_single_process(results, arch, shape):
    r = results[f"tp_{arch}_{shape}"]
    assert r["ok"], r
    assert r["tokens_equal"]
    assert r["weight_bytes"] == r["weight_bytes_spec"]
    assert r["cache_bytes"] <= r["cache_bytes_spec"]
    d, m = map(int, shape.split("x"))
    V = 512
    assert r["logits_block"] == [4 // d, V // m]


def test_tp_forward_with_the_batch_replicated(results):
    # the batch replicated (the reference's B = 1 layout): the spec splits
    # Zamba2's SSM state over the model axes, which the forward gathers
    r = results["tp_zamba2-1.2b_1x4_replicated"]
    assert r["ok"], r
    assert r["logits_block"] == [4, 128]
    assert r["cache_bytes"] <= r["cache_bytes_spec"]
    assert r["cache_bytes"] < results["tp_zamba2-1.2b_1x4"]["cache_bytes"]


def test_tp_splits_the_weights(results):
    # smollm-360m reduced: every matrix split, norms whole; a rank of t = 4
    # holds about a quarter of what a rank of t = 2 holds
    w2 = results["tp_smollm-360m_2x2"]["weight_bytes"]
    w4 = results["tp_smollm-360m_1x4"]["weight_bytes"]
    assert 0.49 < w4 / w2 < 0.51


def test_programs_equal_reference_programs(results):
    r = results["programs_reference_2x4"]
    assert r["ok"], r
