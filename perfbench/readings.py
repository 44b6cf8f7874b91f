"""The readings a cell's correctness limits are set from: the program's
numbers and the fp8 control's over many seeds, in one process; or, with
``--fault``, the program's with each named fault planted in turn
(``perfbench/faults.py``).

    python3 perfbench/readings.py --workload <name> --seconds <s> \\
        --seeds <n1,n2,...> [--fault <name1,name2,...>]

Each seed is a whole run at the cell's own load (weights, engine,
warm-up, traffic, window, comparison). Without ``--fault`` the control
is read beside the program at the same positions and judged by the
cell's own comparison and limits in the program's place. One JSON line a
run (the program's verdict ``correct``, the control's
``control_correct``, the numbers compared beside their limits), then,
with the control, a summary: the largest reading of the program and the
smallest of the control, per number. The benchmark's own runs never run
the control.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault", default=None)
    args = p.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import run
    run._environment()
    import torch
    from perfbench import faults
    from perfbench.harness import check, main as hm, spec
    cell = spec.load_cell(args.workload, ROOT / "BENCHMARK.json")
    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 3
    control = args.fault is None
    seeds = [int(x) for x in args.seeds.split(",")]
    runs = [(f, x) for f in (args.fault.split(",") if args.fault else [None])
            for x in seeds]
    prog = {k: [] for k in check.NUMBERS}
    ctl = {k: [] for k in check.NUMBERS}
    for fault, seed in runs:
        t0 = time.perf_counter()
        try:
            with faults.FAULTS[fault]() if fault else \
                    contextlib.nullcontext():
                out = hm.one_run(cell, seed, args.seconds, False, "cuda",
                                 control=control)
        except Exception as e:      # a fault may crash the run: not correct
            if not fault:
                raise
            print(json.dumps({"seed": seed, "fault": fault, "correct": False,
                              "error": repr(e)}), flush=True)
            torch.cuda.empty_cache()
            continue
        r = out["run"]
        line = {"seed": seed, "fault": fault, "correct": out["correct"],
                "failed": out["failed"],
                "tokens_compared": r["tokens_compared"],
                "greedy_tokens": r["greedy_tokens"], "steps": r["steps"],
                "served": r["served"], "program": r["readings"],
                "compared": out["check"]}
        for k in check.NUMBERS:
            prog[k].append(r["readings"][k])
        if control:
            line.update(control=r["control"],
                        control_correct=r["control_correct"],
                        control_compared=r["control_compared"])
            for k in check.NUMBERS:
                ctl[k].append(r["control"][k])
        line["wall_s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    if control:
        print(json.dumps({"workload": args.workload,
                          "program_max": {k: max(v) for k, v in prog.items()},
                          "control_min": {k: min(v) for k, v in ctl.items()},
                          "program": prog, "control": ctl}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
