"""Discovery by name, and BENCHMARK.json against its required shape:
every cell's configuration, mix, settings and readers are files of their
own, found by the names BENCHMARK.json gives."""
import json
import re

import pytest

from perfbench.harness import spec

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
