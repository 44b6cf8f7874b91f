"""The granite-4.0-h-small configuration's files (family
``granite_hybrid``) and the cell ``granite-4h.decode``: the seeded
weights' layout and the FLOPs a token pinned as literals, the reference
free of the program and of JAX, the Mamba2 readers on a recorded run and
the roofline's bytes at the published widths, and the cell's comparison
on a tiny float32 copy (the program correct, the fp8 control not)."""
import json
import math
import subprocess
import sys
from types import SimpleNamespace as NS

import pytest
import torch

from perfbench.frozen import arith
from perfbench.harness import drive, main, spec, weights as W
from perfbench.harness.main import Run
from perfbench.tests import tiny

ROOT = spec.BENCH_DIR.parent
CELL = "granite-4h.decode"

#: ``weights.leaves`` of the configuration file, each path joined by "/"
LEAVES = [
    ("emb/tok", (100352, 4096), "normal", 0.0, 0.16, "model"),
    ("stack/ln1", (20, 4096), "ones", 0.0, 0.0, "model"),
    ("stack/ln2", (20, 4096), "ones", 0.0, 0.0, "model"),
    ("stack/final_ln", (4096,), "ones", 0.0, 0.0, "model"),
    ("stack/mamba/in_proj", (18, 4096, 16768), "normal", 0.0, 0.015625,
     "model"),
    ("stack/mamba/conv_w", (18, 4, 8448), "normal", 0.0, 0.5, "model"),
    ("stack/mamba/conv_b", (18, 8448), "normal", 0.0, 0.5, "model"),
    ("stack/mamba/A_log", (18, 128), "normal", 1.386294, 0.5, "float32"),
    ("stack/mamba/D", (18, 128), "ones", 0.0, 0.0, "float32"),
    ("stack/mamba/dt_bias", (18, 128), "normal", -4.6, 1.0, "float32"),
    ("stack/mamba/norm_w", (18, 8192), "ones", 0.0, 0.0, "model"),
    ("stack/mamba/out_proj", (18, 8192, 4096), "normal", 0.0,
     1.1048543456039803, "model"),
    ("stack/attn/w_q", (2, 4096, 4096), "normal", 0.0, 0.015625, "model"),
    ("stack/attn/w_k", (2, 4096, 1024), "normal", 0.0, 0.015625, "model"),
    ("stack/attn/w_v", (2, 4096, 1024), "normal", 0.0, 0.015625, "model"),
    ("stack/attn/w_o", (2, 4096, 4096), "normal", 0.0, 1.5625, "model"),
    ("stack/moe/router", (20, 4096, 72), "normal", 0.0, 0.015625,
     "float32"),
    ("stack/moe/w_gate", (20, 72, 4096, 768), "normal", 0.0, 0.015625,
     "model"),
    ("stack/moe/w_up", (20, 72, 4096, 768), "normal", 0.0, 0.015625,
     "model"),
    ("stack/moe/w_down", (20, 72, 768, 4096), "normal", 0.0,
     3.6084391824351614, "model"),
    ("stack/moe/shared/w_gate", (20, 4096, 1536), "normal", 0.0, 0.015625,
     "model"),
    ("stack/moe/shared/w_up", (20, 4096, 1536), "normal", 0.0, 0.015625,
     "model"),
    ("stack/moe/shared/w_down", (20, 1536, 4096), "normal", 0.0,
     2.551551815399144, "model"),
]

#: (token_flops(cfg, 1000), prompt_flops(cfg, 77))
FLOPS = (9321484288.0, 715329556480.0)

#: ``mamba_roofline.decode_bytes`` at the published widths, 128 rows:
#: in_proj 4096 x 16768, conv 5 x 8448 (taps and bias) and out_proj
#: 8192 x 4096 in bf16, and per row the f32 state 128 x 64 x 128 and the
#: conv carry 3 x 8448 in bf16, each read and written
DECODE_BYTES_128 = 1291274752


def _config():
    return json.loads((spec.BENCH_DIR / "configs" /
                       "granite-4.0-h-small.json").read_text())


def test_layout_and_fill_order_are_the_recorded_ones():
    got = [("/".join(path), *rest) for path, *rest in W.leaves(_config())]
    assert got == LEAVES
    assert sum(math.prod(shape) for _, shape, *_ in got) == 16309191936


def test_flops_are_the_recorded_ones():
    cfg = _config()
    assert (arith.token_flops(cfg, 1000), arith.prompt_flops(cfg, 77)) == \
        FLOPS


def test_cell_is_the_published_model_cut_to_two_periods():
    cell = spec.load_cell(CELL, ROOT / "BENCHMARK.json")
    cfg = cell.config
    pub = cfg["published"]
    assert cfg["layer_types"] == pub["layer_types"][:20]
    assert pub["num_hidden_layers"] == 40 == len(pub["layer_types"])
    assert [i for i, t in enumerate(cfg["layer_types"])
            if t == "attention"] == [5, 15]
    assert cell.settings["engine"]["slots"] == 128
    assert cell.settings["engine"]["max_seq_len"] == 1152
    spec.load_family("reference", cfg["family"]).check_config(cfg)


def test_cell_and_reference_load_no_banned_module():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from perfbench.harness import spec, guard, program\n"
        "import perfbench.reference\n"
        "cell = spec.load_cell(%r, spec.BENCH_DIR.parent / "
        "'BENCHMARK.json')\n"
        "spec.readers(cell)\n"
        "program.model_config(cell.config)\n"
        "import repro_torch.launch.serve\n"
        "print(guard.banned_modules())\n" % (str(ROOT), str(ROOT / "src"),
                                             CELL))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    src = (spec.BENCH_DIR / "reference" / "granite_hybrid.py").read_text()
    assert "repro_torch" not in src and "import jax" not in src
    assert "from repro" not in src and "import repro" not in src


def _span(ts, **args):
    return NS(kind="mamba", ph="X", ts=ts, dur=0.001, track="MainThread",
              args=tuple(sorted(args.items())))


def _run(spans):
    """A window of 4 s whose second second the profiler disturbed."""
    cell = spec.load_cell(CELL, ROOT / "BENCHMARK.json")
    return Run(cell=cell, log=drive.Log(ws=99.0, we=103.0), spans=spans,
               profiled=(100.0, 101.0), device_name="NVIDIA H100 80GB HBM3")


def test_mamba_readers_on_a_recorded_run():
    share = spec.load_reader("mamba_share")
    roof = spec.load_reader("mamba_roofline")
    spans = [_span(99.5, layer=0, rows=128, tokens=128, program="decode",
                   device_ms=2.0),
             _span(102.0, layer=1, rows=128, tokens=128, program="decode",
                   device_ms=2.0),
             _span(102.5, layer=0, rows=3, tokens=96, program="prefill",
                   device_ms=20.0),
             _span(100.5, layer=2, rows=128, tokens=128, program="decode",
                   device_ms=500.0),                  # in the profiler's
             _span(102.7, layer=3, rows=128, tokens=128, program="decode")]
    assert share("mamba_share.decode", _run(spans)) == \
        pytest.approx(0.024 / 3.0 * 100)
    assert roof("mamba_roofline.decode", _run(spans)) == pytest.approx(
        2 * DECODE_BYTES_128 / 3.35e12 / 4e-3 * 100)
    assert share("mamba_share.decode", _run([])) is None
    assert roof("mamba_roofline.decode", _run(spans[2:3])) is None


def test_mamba_roofline_bytes_at_the_published_widths():
    mod = spec._load_file("mamba_roofline",
                          spec.BENCH_DIR / "layer_metrics" /
                          "mamba_roofline.py")
    assert mod.decode_bytes(_config(), 128) == DECODE_BYTES_128


#: the configuration file's family at a tiny float32 size (four layers:
#: mamba, attention, mamba, mamba; every multiplier as published). The
#: embedding's std is 1.28 so that the logits spread ~0.64 at d 64, as the
#: cell's do at d 4096 (1.28 x 8 / 16), and the branches are scaled with
#: it: the cell's limit is in logits, and so is the fp8 control's gap
TINY = dict(
    name="tiny-granite-hybrid", source="test", family="granite_hybrid",
    dtype="float32", num_hidden_layers=4,
    layer_types=["mamba", "attention", "mamba", "mamba"], hidden_size=64,
    num_attention_heads=4, num_key_value_heads=2, intermediate_size=32,
    shared_intermediate_size=32, num_local_experts=8, num_experts_per_tok=2,
    vocab_size=4096, mamba_expand=1, mamba_n_heads=4, mamba_d_head=16,
    mamba_d_state=8, mamba_d_conv=4, mamba_n_groups=1, mamba_conv_bias=True,
    mamba_proj_bias=False, hidden_act="silu", rms_norm_eps=1e-5,
    tie_word_embeddings=True, capacity_factor=4.0, embedding_multiplier=12.0,
    attention_multiplier=0.0078125, residual_multiplier=0.22,
    logits_scaling=16.0, position_embedding_type="nope", prompt_bucket=32,
    init=dict(embedding_std=1.28, residual_out_scale=240.0,
              a_log=[1.386294, 0.5], dt_bias=[-4.6, 1.0]), reduced=[])


def test_control_fails_where_the_program_passes():
    torch.set_num_threads(2)
    cell = tiny.cell(TINY, "decode", CELL)
    out = main.one_run(cell, 2 ** 31 + 7, 2.0, False, "cpu", control=True)
    assert out["correct"] is True, out["check"]
    assert out["run"]["control_correct"] is False, \
        out["run"]["control_compared"]
