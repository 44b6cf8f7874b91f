"""Each ``examples/torch_*.py`` (the port's twins of ``examples/*.py``)
runs once on the CPU, at its smallest arguments, through its ``main``
(in this process, torch pinned to one intra-op thread while it runs),
and prints its report. The train example writes its checkpoint (three
copies of ~86 M f32 parameters: the weights and AdamW's two moments) into
the test's temporary directory, so it runs three steps of one 16-token
row."""
import contextlib
import importlib.util
import io
import os

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

EXAMPLES = {
    "torch_quickstart.py": ([], "decision plane: fast-path acceptance="),
    "torch_serve_continuous_batching.py": (
        ["--requests", "4", "--max-new", "4"], "shvs"),
    "torch_autotune_serving.py": (["--requests", "4", "--max-new", "16"],
                                  "served 4 requests"),
    "torch_shvs_sizing.py": (["--iters", "1"], "H* (first-order condition)"),
    "torch_train_100m.py": (["--steps", "3", "--batch", "1", "--seq-len",
                             "16"], "checkpoint round-trip ok at step 3"),
}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_cpu(name, tmp_path, one_thread):
    args, expect = EXAMPLES[name]
    if name == "torch_train_100m.py":
        args = args + ["--ckpt", str(tmp_path / "ckpt")]
    spec = importlib.util.spec_from_file_location(
        name[:-3], os.path.join(HERE, "..", "examples", name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main(["--device", "cpu", *args])
    assert expect in out.getvalue(), out.getvalue()[-2000:]
