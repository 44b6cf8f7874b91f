"""No process of the benchmark may hold JAX or the JAX package, compared
by whole top-level names, and a checkout without the program or without
a card prints no result."""
import json
import os
import shutil
import subprocess
import sys

from perfbench.harness import guard, spec

ROOT = spec.BENCH_DIR.parent


def test_banned_names_are_compared_whole():
    assert guard.banned_modules(["repro_torch", "repro_torch.engine",
                                 "reproduce", "torch"]) == []
    assert guard.banned_modules(["repro.core", "jax", "jaxlib.xla",
                                 "flax", "numpy"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def test_harness_and_reference_load_no_banned_module():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import perfbench.harness.main, perfbench.harness.program\n"
        "import perfbench.reference, perfbench.readings\n"
        "from perfbench.harness import spec, guard\n"
        "cell = spec.load_cell('granite-moe.chat', spec.BENCH_DIR.parent / "
        "'BENCHMARK.json')\n"
        "spec.readers(cell)\n"
        "from perfbench.harness import program\n"
        "program.model_config(cell.config)\n"
        "import repro_torch.launch.serve\n"
        "print(guard.banned_modules())\n" % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    src = "\n".join(p.read_text() for p in
                    (spec.BENCH_DIR / "reference").glob("*.py"))
    assert "repro_torch" not in src and "import jax" not in src
    assert "from repro" not in src and "import repro" not in src


def test_no_result_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "rwkv6.decode",
         "--seed", "2147483700", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "rwkv6.decode",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())
