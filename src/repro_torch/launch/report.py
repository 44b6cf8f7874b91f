"""The dry-run's tables from its JSONL records, the port's and the
reference's side by side.

    PYTHONPATH=src python -m repro_torch.launch.report port.jsonl [ref.jsonl ...]

A record of ``repro_torch.launch.dryrun`` carries ``"package":
"repro_torch"``; one without the key is the reference's
(``repro.launch.dryrun``), whose keys the port's records hold too. Each
table has a package column, so one combination's two records sit on
adjacent rows. A port record's "lower" is its trace's seconds and its
"compile" 0 (nothing is compiled).
"""
from __future__ import annotations

import json
import sys
from collections import defaultdict


def fmt_s(x):
    if x is None:
        return "-"
    if x == 0:
        return "0"
    for unit, scale in (("s", 1), ("ms", 1e-3), ("us", 1e-6), ("ns", 1e-9)):
        if abs(x) >= scale:
            return f"{x / scale:.2f}{unit}"
    return f"{x:.1e}s"


def fmt_b(x):
    if x is None:
        return "-"
    for unit, scale in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if abs(x) >= scale:
            return f"{x / scale:.2f}{unit}"
    return f"{x:.0f}B"


def package(r) -> str:
    return r.get("package", "repro")


def load(*paths):
    """The records of every file, the LAST per (package, arch, shape,
    mesh) kept (reruns supersede)."""
    out = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                if line.strip():
                    r = json.loads(line)
                    out[(package(r), r["arch"], r["shape"], r["mesh"])] = r
    return list(out.values())


def _order(r):
    return (r["arch"], r["shape"], r["mesh"], package(r))


def roofline_table(recs, mesh="16x16"):
    rows = ["| package | arch | shape | compute | memory | collective | "
            "bottleneck | MODEL_FLOPS | HLO_FLOPS | useful | coll bytes | "
            "HBM bytes |",
            "|" + "---|" * 12]
    for r in sorted(recs, key=_order):
        if r["mesh"] != mesh or r.get("status") != "ok":
            continue
        rows.append(
            f"| {package(r)} | {r['arch']} | {r['shape']} | "
            f"{fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} | "
            f"{fmt_s(r['collective_s'])} | **{r['bottleneck']}** | "
            f"{r['model_flops']:.2e} | {r['hlo_flops']:.2e} | "
            f"{r['useful_ratio']:.2f} | {fmt_b(r['collective_bytes'])} | "
            f"{fmt_b(r['hlo_bytes'])} |")
    return "\n".join(rows)


def dryrun_table(recs):
    rows = ["| package | arch | shape | mesh | status | lower | compile | "
            "per-device bytes | collectives (counts) |",
            "|" + "---|" * 9]
    for r in sorted(recs, key=_order):
        ma = r.get("memory_analysis", {})
        per_dev = None
        if isinstance(ma, dict) and "temp_size_in_bytes" in ma:
            per_dev = (ma.get("argument_size_in_bytes", 0) +
                       ma.get("output_size_in_bytes", 0) +
                       ma.get("temp_size_in_bytes", 0))
        cc = r.get("collective_counts", {})
        cstr = ",".join(f"{k}:{int(v)}" for k, v in sorted(cc.items()) if v)
        rows.append(
            f"| {package(r)} | {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r.get('status')} | {r.get('lower_s', 0):.1f}s | "
            f"{r.get('compile_s', 0):.1f}s | {fmt_b(per_dev)} | {cstr} |")
    return "\n".join(rows)


def summary(recs):
    lines = []
    for pkg in sorted({package(r) for r in recs}):
        mine = [r for r in recs if package(r) == pkg]
        ok = [r for r in mine if r.get("status") == "ok"]
        by_bn = defaultdict(int)
        for r in ok:
            if r["mesh"] == "16x16":
                by_bn[r["bottleneck"]] += 1
        lines.append(f"{pkg}: {len(ok)}/{len(mine)} combinations ok; "
                     f"single-pod bottlenecks: {dict(by_bn)}")
    return "\n".join(lines)


def main(argv=None):
    paths = (argv if argv is not None else sys.argv[1:]) or \
        ["dryrun_all.jsonl"]
    recs = load(*paths)
    print("## Summary\n")
    print(summary(recs))
    print("\n## Roofline (single-pod 16x16, 256 chips)\n")
    print(roofline_table(recs, "16x16"))
    print("\n## Roofline (multi-pod 2x16x16, 512 chips)\n")
    print(roofline_table(recs, "2x16x16"))
    print("\n## Dry-run records\n")
    print(dryrun_table(recs))


if __name__ == "__main__":
    main()
