"""The knee sweep of an open-loop cell: one run at each offered rate, in
one process, to find the highest rate at which the waiting queue does
not grow over the window. The rate the cell offers is then written into
its traffic file as a number; the benchmark's own runs never sweep.

    python3 perfbench/sweep.py --workload <name> --seed <n> \\
        --seconds <s> --rates <r1,r2,...>

One JSON line a rate: the queue's mean depth over the window's first and
last quarter of steps, the tails, and whether the run was correct.
"""
import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    args = p.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import run
    run._environment()
    import torch
    from perfbench.harness import main as hm, spec
    cell = spec.load_cell(args.workload, ROOT / "BENCHMARK.json")
    if not torch.cuda.is_available():
        print("the sweep needs a CUDA device", file=sys.stderr)
        return 3
    if cell.traffic["kind"] != "open_loop":
        print(f"{args.workload} offers no rate to sweep", file=sys.stderr)
        return 2
    for rate in (float(r) for r in args.rates.split(",")):
        at = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                    rate_rps=rate))
        out = hm.one_run(at, args.seed, args.seconds, False, "cuda")
        r = out["run"]
        print(json.dumps({"rate_rps": rate, "correct": out["correct"],
                          "queue_depth": r["queue_depth"],
                          "window_requests": r["window_requests"],
                          "metrics": {k: v["value"] for k, v in
                                      out["metrics"].items()}}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
