"""Discovery by name, and BENCHMARK.json against its required shape:
every cell's configuration, mix, settings and readers are files of their
own, found by the names BENCHMARK.json gives, and so is the code of each
configuration's model family."""
import json
import re
import shutil
import subprocess
import sys

import pytest

from perfbench.harness import spec
from perfbench.tests import tiny

ROOT = spec.BENCH_DIR.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = [w["why"] for w in BENCH["workloads"]] + \
        [c["why"] for c in BENCH["configs"]] + \
        [m["layer"] for m in BENCH["per_layer"]]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t
               for t in texts)


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        reports = e2e[m["moves"]].get("workloads", CELLS)
        assert m["workloads"] and set(m["workloads"]) <= set(reports)


def test_every_cell_reports_enough():
    for c in CELLS:
        e2e = [m for m in BENCH["end_to_end"]
               if c in m.get("workloads", CELLS)]
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert any(c in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_found_by_name(cell):
    c = spec.load_cell(cell, ROOT / "BENCHMARK.json")
    assert c.chips == 1
    assert c.config["name"] in [x["name"] for x in BENCH["configs"]]
    assert {"engine", "check", "limits", "trace"} <= set(c.settings)
    assert c.traffic["kind"] in ("open_loop", "saturated")
    readers = spec.readers(c)
    assert set(readers) == {m.name for m in c.per_layer}
    assert {k["kernel"] for k in c.decision_kernels} >= {
        "penalty_scale_kernel", "shvs_masses_kernel"}


def test_configs_are_files_under_paths_with_their_reductions():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    widths = re.compile(r"(_dim|_rank)$|hidden|intermediate|head_size|"
                        r"experts_per_tok|latent|state|expand|proj")
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert not [k for k in c["reduced"] if widths.search(k)]
        assert cfg["source"] == c["source"]


def test_unknown_cell_and_reader_are_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no.such.cell", ROOT / "BENCHMARK.json")
    with pytest.raises(FileNotFoundError):
        spec.load_reader("no_such_family")


def test_family_without_files_is_refused_at_load(tmp_path):
    bench = dict(BENCH, configs=[dict(BENCH["configs"][0],
                                      file="perfbench/configs/x.json")])
    (tmp_path / "perfbench" / "configs").mkdir(parents=True)
    (tmp_path / "perfbench" / "configs" / "x.json").write_text(
        json.dumps(dict(tiny.MOE, family="no_such_family")))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(FileNotFoundError,
                       match=re.escape(str(spec.BENCH_DIR / "families" /
                                           "no_such_family.py"))):
        spec.load_cell(bench["workloads"][0]["name"],
                       tmp_path / "BENCHMARK.json")


#: run in a copy of the benchmark to which a family ``toy`` was added as
#: files alone: ``moe``'s two files under another name
TOY = """
import json, sys
sys.path[:0] = [%r, %r]
import torch
from repro_torch.models.model import Model
from perfbench import reference as R
from perfbench.frozen import arith
from perfbench.harness import program, spec, weights as W
from perfbench.tests import tiny
cell = spec.load_cell("toy.chat", spec.BENCH_DIR.parent / "BENCHMARK.json")
toy, moe = cell.config, dict(tiny.MOE, name="toy")
w, w_moe = W.make(toy, 1, "cpu"), W.make(moe, 1, "cpu")
m = Model(program.model_config(toy))
prompt = torch.randint(1, toy["vocab_size"], (1, 9),
                       generator=torch.Generator().manual_seed(2))
cache = m.init_cache(1, 32, device="cpu")
lg, _ = m.prefill(w, {"tokens": prompt.int()}, cache,
                  true_lens=torch.tensor([9], dtype=torch.int32))
item = dict(prompt=prompt[0].tolist(), outputs=[int(lg[0].argmax())],
            padded=9)
ref, ref_moe = (R.output_logits(c, w, [item]) for c in (toy, moe))
print(json.dumps({
    "files": [spec.load_family(k, "toy").__file__ for k in ("program",
                                                             "reference")],
    "model_config": program.model_config(toy) == program.model_config(moe),
    "weights": W.leaves(toy) == W.leaves(moe) and all(
        torch.equal(a, b) for a, b in zip(
            torch.utils._pytree.tree_leaves(w),
            torch.utils._pytree.tree_leaves(w_moe))),
    "served": bool(torch.allclose(lg[0], ref[0][0], atol=2e-5, rtol=1e-5)),
    "referenced": bool(torch.equal(ref[0], ref_moe[0])),
    "counted": [arith.token_flops(toy, 100), arith.prompt_flops(toy, 7)] ==
               [arith.token_flops(moe, 100), arith.prompt_flops(moe, 7)],
}))
"""


def test_family_added_as_files_alone_is_found_by_name(tmp_path):
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(
        name="toy", source="test", file="perfbench/configs/toy.json",
        reduced=[], why="moe's files under another family name"))
    bench["workloads"].append(dict(
        name="toy.chat", config="toy", traffic="chat", chips=1,
        why="moe's files under another family name"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    copy = tmp_path / "perfbench"
    shutil.copytree(spec.BENCH_DIR, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(copy): p.read_bytes()
              for p in copy.rglob("*") if p.is_file()}
    for folder in ("families", "reference"):
        shutil.copy(copy / folder / "moe.py", copy / folder / "toy.py")
    (copy / "configs" / "toy.json").write_text(
        json.dumps(dict(tiny.MOE, name="toy", family="toy")))
    shutil.copy(copy / "workloads" / "granite-moe.chat.json",
                copy / "workloads" / "toy.chat.json")
    out = subprocess.run(
        [sys.executable, "-c", TOY % (str(tmp_path), str(ROOT / "src"))],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got.pop("files") == [str(copy / "families" / "toy.py"),
                                str(copy / "reference" / "toy.py")]
    assert got == dict.fromkeys(got, True) and len(got) == 5
    assert all(p.read_bytes() == b for p, b in
               ((copy / r, b) for r, b in before.items()))
