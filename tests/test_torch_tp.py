"""The port's tensor-parallel forward and its serving programs on gloo
meshes of 8 CPU processes (``torch_dist_worker.py`` in "tp" mode, one
job), held against the port's single-process forward and the
reference's programs.

* Every family — dense (smollm-360m; qwen3-8b with qk-norm; tinyllama;
  starcoder2 with a 16-slot sliding window that a 20-token prompt wraps),
  the VLM (internvl2-2b, patch embeddings), whisper-base (encoder, cross
  attention), MoE (granite: TP attention, EP experts; llama4: the shared
  expert), RWKV-6 (also with heads of 16 over t = 4, a block ending
  inside a head) and Zamba2 — reduced in f32 at (2, 2), (1, 4) and
  (2, 4): after a prefill and 3 greedy decode steps each rank's logits
  block is within 1e-5 (abs + rel; Zamba2 5e-5, see
  ``torch_dist_worker.TP_TOL``) of the single-process logits' block, the
  greedy tokens are equal, the rank's weight bytes equal ``param_spec``'s
  reckoning and its cache bytes are at most ``cache_shardings``'.
* The port's per-rank prefill and serve-step programs (S1, ``shvs``) at
  (2, 4) on reduced smollm-360m: the first tokens and three serve steps'
  tokens equal the reference's jitted GSPMD programs
  (``torch_dist_jax_ref.py programs``), the logits blocks within 1e-5.
* The train step under the mesh (the collectives' adjoints, the
  vocab-parallel loss, the gradient summed over the axes a leaf is whole
  on, the norm over the blocks), every family at (2, 2), (1, 4) and
  (2, 4), plus RWKV-6 with 6 heads of 16 whose column block at t = 4
  ends inside a head (the recurrence split by value columns): from one
  init and one batch (B = 4, S = 8), the loss and grad norm within 1e-5
  relative of the single process's, each gradient block within 1e-5 of
  the leaf's largest single-process gradient, and the parameters after
  the step (the blocks gathered) within 1e-6 absolute + 1e-5 relative
  plus what the gradient's tolerance moves the first AdamW step by (its
  first-order bound; 2·lr where the single process's gradient is within
  the tolerance of 0 and its sign is open), after the scheme of
  ``tests/test_torch_steps.py``. RWKV-6, Zamba2 and llama4's reduced
  MoE, ill-conditioned in f32, are held at the single process's own
  one-ulp sensitivity (gradients within 2e-4, 5e-5 and 2e-5:
  ``torch_dist_worker.TRAIN_TOL``). No leaf goes
  without a gradient, as in the single process.
* The port's per-rank train program at (2, 4) against the reference's
  jitted GSPMD train program on reduced smollm-360m, granite-moe-1b-a400m
  (the EP experts) and rwkv6-3b, from the reference's parameters: loss
  and grad norm within 1e-5 relative, the parameters after the step as
  ``tests/test_torch_steps.py`` holds them (a 5e-4 share for RWKV-6).
"""
import json
import os
import subprocess
import sys

import pytest

from test_torch_distributed import HERE, WORLD, _env, _free_port  # noqa: E402

ARCHS = ["smollm-360m", "qwen3-8b", "tinyllama-1.1b", "starcoder2-7b",
         "internvl2-2b", "whisper-base", "granite-moe-1b-a400m",
         "llama4-maverick-400b-a17b", "rwkv6-3b", "zamba2-1.2b",
         "rwkv6-3b-midhead"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    ref = str(d / "programs.npz")
    port = _free_port()
    path = str(d / "results.json")
    # the reference's programs run beside the job, whose ranks wait for
    # their file only at the end
    jax_ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_jax_ref.py"), ref,
         "programs"], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_worker.py"),
         str(r), str(WORLD), str(port), ref, path, "tp"], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    errs = []
    try:
        _, err = jax_ref.communicate(timeout=300)
        assert jax_ref.returncode == 0, err[-4000:]
        for p in procs:
            _, err = p.communicate(timeout=300)
            if p.returncode:
                errs.append(err[-4000:])
    finally:
        for p in procs + [jax_ref]:
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


@pytest.mark.parametrize("shape", ["2x2", "1x4", "2x4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_train_step_equals_single_process(results, arch, shape):
    r = results[f"train_{arch}_{shape}"]
    assert r["ok"], r
    assert r["severed"] is None and r["unused_single"] == []
    ph = r["phases"]
    # the adjoints: the backward runs one collective for each of the
    # forward's but the loss's pmax; the gradient sum and the norm are
    # one psum per set of axes
    assert ph["backward"] == ph["forward"] - 1
    assert 1 <= ph["dp_mean"] <= 2 and 1 <= ph["norm"] <= 2
    assert ("metrics" in ph) == shape.startswith("2")


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m",
                                  "rwkv6-3b"])
def test_train_program_equals_reference_program(results, arch):
    r = results[f"train_program_reference_{arch}_2x4"]
    assert r["ok"], r
