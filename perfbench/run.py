"""Run one benchmark cell once:

    python3 perfbench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the program (``src/repro_torch``). It loads and warms up, measures
for ``--seconds``, compares what the window served with the plain
reference, and prints the numbers compared, each beside its limit, as
the last lines on standard error and one JSON result line as the last
line on standard output. Without enough CUDA devices it exits with 3 and
prints no result.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout; no
    library of the program's may load JAX on its own."""
    build = ROOT / "build"
    os.environ.setdefault("REPRO_TORCH_BUILD_DIR",
                          str(build / "repro_torch_kernels"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"the program (src/repro_torch) is not in {ROOT}",
              file=sys.stderr)
        return 2
    _environment()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench.harness.main import main as run
    return run(sys.argv[1:], t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
