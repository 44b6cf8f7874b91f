"""Discovery: everything of one cell is found by name.

* ``BENCHMARK.json``'s ``workloads`` entry names the configuration and
  the traffic mix;
* ``workloads/<workload>.json``: the cell's engine settings and the
  limits of its correctness comparison;
* ``configs/<config>.json`` (the file ``configs`` names): the model;
  its ``family`` key names the model's two files of code:
* ``families/<family>.py``: the seam into the program, ``model_config``
  (the program's model configuration of a configuration file) and
  ``leaves`` (the seeded weights' layout, in fill order);
* ``reference/<family>.py``: the plain float32 forward (``check_config``,
  ``output_logits``) and the FLOPs a token (``matmul_params``,
  ``token_flops``, ``prompt_flops``), importing nothing of the program;
* ``traffic/<traffic>.json``: the mix's parameters;
* ``layer_metrics/<family>.py``: the reader of every per-layer metric
  whose name starts with ``<family>`` (up to the first dot);
* ``decision_kernels/*.json``: the device kernels that make up the
  decision plane, for its roofline.

A later cell adds files and a ``workloads`` entry, and a later model
family adds its two files; no file here changes.
"""
from __future__ import annotations

import functools
import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]

#: the two files of a model family: {kind: (folder, functions they hold)}
FAMILY_FILES = {
    "program": ("families", ("model_config", "leaves")),
    "reference": ("reference", ("check_config", "output_logits",
                                "matmul_params", "token_flops",
                                "prompt_flops")),
}


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    moves: str = ""
    layer: str = ""
    workloads: List[str] = field(default_factory=list)
    bound: float = 0.0

    def applies(self, workload: str) -> bool:
        return not self.workloads or workload in self.workloads


@dataclass
class Cell:
    name: str
    chips: int
    config: dict                    # configs/<config>.json
    traffic: dict                   # traffic/<traffic>.json
    settings: dict                  # workloads/<name>.json
    end_to_end: List[Metric]
    per_layer: List[Metric]
    decision_kernels: List[dict]
    bench_dir: Path = BENCH_DIR


def _read(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(workload: str, bench_json: Path,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``bench_json``, with its files read from
    ``bench_dir``. Raises KeyError for an unknown cell."""
    bench = _read(bench_json)
    entry = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in {bench_json}")
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[entry["config"]]
    root = bench_json.parent
    config = _read(root / cfg_entry["file"])
    if sorted(config.get("reduced", [])) != sorted(cfg_entry["reduced"]):
        raise ValueError(f"{cfg_entry['file']}: 'reduced' differs from "
                         "BENCHMARK.json's")
    for kind in FAMILY_FILES:
        load_family(kind, config["family"], bench_dir)
    metrics = lambda key: [Metric(**{k: m[k] for k in m})
                           for m in bench[key]]
    e2e = [m for m in metrics("end_to_end") if m.applies(workload)]
    per = [m for m in metrics("per_layer") if m.applies(workload)]
    return Cell(name=workload, chips=int(entry["chips"]), config=config,
                traffic=_read(bench_dir / "traffic" /
                              f"{entry['traffic']}.json"),
                settings=_read(bench_dir / "workloads" / f"{workload}.json"),
                end_to_end=e2e, per_layer=per,
                decision_kernels=[_read(p) for p in sorted(
                    (bench_dir / "decision_kernels").glob("*.json"))],
                bench_dir=bench_dir)


def _load_file(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_family(kind: str, family: str, bench_dir: Path = BENCH_DIR):
    """The model family's ``families/<family>.py`` (``kind`` "program")
    or ``reference/<family>.py`` (``kind`` "reference"), loaded once."""
    return _load_family(kind, family, Path(bench_dir))


@functools.lru_cache(maxsize=None)
def _load_family(kind: str, family: str, bench_dir: Path):
    folder, functions = FAMILY_FILES[kind]
    if not re.fullmatch(r"[A-Za-z0-9_]+", family):
        raise ValueError(f"model family {family!r}: letters, digits and _")
    path = bench_dir / folder / f"{family}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file {path} for model family "
                                f"{family!r}")
    mod = _load_file(f"perfbench_family_{kind}_{family}", path)
    missing = [f for f in functions if not callable(getattr(mod, f, None))]
    if missing:
        raise AttributeError(f"{path} lacks {', '.join(missing)}")
    return mod


def metric_family(name: str) -> str:
    return name.split(".", 1)[0]


def load_reader(family: str, bench_dir: Path = BENCH_DIR):
    """``layer_metrics/<family>.py``'s ``read(name, run)``."""
    path = bench_dir / "layer_metrics" / f"{family}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader {path} for metric family "
                                f"{family!r}")
    return _load_file(f"perfbench_layer_metric_{family}", path).read


def readers(cell: Cell) -> Dict[str, object]:
    """{metric name: reader} for the cell's per-layer metrics."""
    return {m.name: load_reader(metric_family(m.name), cell.bench_dir)
            for m in cell.per_layer}
