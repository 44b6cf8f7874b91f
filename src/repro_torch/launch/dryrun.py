"""Multi-pod dry-run: every (arch × shape × mesh) program traced as one rank
of 512, on fake tensors, with its roofline record.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi --out results.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch whisper-base \\
        --shape decode_32k --device cpu

The reference lowers and compiles each program for 512 placeholder host
devices. Here the process starts ``torch.distributed``'s ``fake`` process
group at world size 512 (no peer exists: every collective returns at
once), builds the production mesh on it (16×16 or 2×16×16,
``launch/mesh.make_production_mesh``), and runs the program of
``launch/steps.py`` as rank 0 under ``dist.use_mesh``: its inputs are
fake tensors on ``--device`` (shapes and dtypes, nothing allocated; the
rank's blocks of the whole inputs, ``steps.local_inputs``), and
``launch/hlo_analysis.analyze_program`` counts its FLOPs, traffic,
collectives and bytes from the trace. On ``cuda`` the kernels' wrappers
see fake CUDA tensors and return shapes without launching
(``kernels/_build.shape_only``).

A record has the keys of the reference's: ``lower_s`` is the trace's
seconds (there is no lowering), and ``compile_s`` is 0 (nothing is
compiled). It adds ``package`` ("repro_torch", which ``launch/report.py``
tells from the reference's records by), ``device`` and ``traced_ops``.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback

import torch

from repro_torch.config import (ARCH_IDS, SHAPES, get_arch, get_shape,
                                model_for_shape)
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.hlo_analysis import analyze_program
from repro_torch.launch.mesh import make_production_mesh, mesh_axes
from repro_torch.launch.sharding import batch_axes_for
from repro_torch.models import dist

WORLD = 512


def init_fake_world(world: int = WORLD) -> None:
    """Rank 0 of a ``fake`` process group of ``world`` ranks (once)."""
    import torch.distributed as tdist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if not tdist.is_initialized():
        tdist.init_process_group("fake", store=FakeStore(), rank=0,
                                 world_size=world)


def _fake_inputs(mode, inputs, device):
    """Fake tensors of the program's meta ``inputs``' shapes and dtypes on
    ``device`` (other leaves as they are). An input that is a 0-d integer
    (the serve step's index) is the number 0: the host reads its value to
    pick the step's uniforms, which do not change the work."""
    def f(x):
        if isinstance(x, torch.Tensor):
            with mode:
                return torch.empty(x.shape, dtype=x.dtype, device=device)
        if isinstance(x, dict):
            return {k: f(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(f(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(f(v) for v in x)
        return x
    return tuple(0 if isinstance(x, torch.Tensor) and x.dim() == 0 and
                 not x.is_floating_point() else f(x) for x in inputs)


def run_one(arch: str, shape_name: str, multi_pod: bool,
            parallelism: str = "sequence_parallel",
            algorithm: str = "shvs", device: str = "cuda",
            verbose: bool = True) -> dict:
    """Trace one combination as rank 0; return the roofline record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    init_fake_world()
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    batch_axes, model_axes = mesh_axes(mesh)
    eff_batch = batch_axes_for(shape, mesh)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    name = f"{arch}|{shape_name}|{mesh_name}|{parallelism}|{algorithm}"

    t0 = time.perf_counter()
    with dist.use_mesh(mesh, batch_axes=eff_batch, model_axes=model_axes):
        make = steps_mod.program_for(shape.kind)
        kw = {"device": device}
        if shape.kind == "decode":
            kw.update(parallelism=parallelism, algorithm=algorithm)
        elif shape.kind == "prefill":
            kw.update(parallelism=parallelism)
        fn, a_in, in_sh, _, _ = make(cfg, shape, mesh, **kw)
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        whole = _fake_inputs(mode, a_in, device)
        with mode:
            local = steps_mod.local_inputs(model_for_shape(cfg, shape),
                                           whole, in_sh, mesh)
            roof = analyze_program(name, fn, local, mesh.size(),
                                   model_for_shape(cfg, shape), shape)
    t_trace = time.perf_counter() - t0

    rec = roof.row()
    rec.update({
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "parallelism": parallelism, "algorithm": algorithm,
        "lower_s": t_trace, "compile_s": 0.0,
        "collective_counts": roof.collectives.count_by_kind,
        "collective_bytes_by_kind": roof.collectives.bytes_by_kind,
        "status": "ok", "package": "repro_torch", "device": device,
        "memory_analysis": roof.memory_analysis,
        "traced_ops": roof.trace.ops,
    })
    if verbose:
        print(f"[ok] {name}: compute={rec['compute_s']:.3e}s "
              f"memory={rec['memory_s']:.3e}s coll={rec['collective_s']:.3e}s "
              f"bottleneck={rec['bottleneck']} "
              f"(trace {t_trace:.1f}s, {roof.trace.ops} ops)", flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--parallelism", default="sequence_parallel",
                    choices=("sequence_parallel", "vocab_gather",
                             "hierarchical"))
    ap.add_argument("--algorithm", default="shvs",
                    choices=("shvs", "truncation_first", "reference"))
    ap.add_argument("--all", action="store_true",
                    help="every (arch × shape) combination")
    ap.add_argument("--out", default=None, help="append JSON records here")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (cuda: the kernels' "
                    "path; cpu: their plain versions)")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    records = []
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    rec = run_one(arch, shape, mp, args.parallelism,
                                  args.algorithm, args.device)
                except Exception as e:
                    failures += 1
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "error", "error": repr(e),
                           "package": "repro_torch", "device": args.device}
                    print(f"[FAIL] {arch}|{shape}|{rec['mesh']}: {e}",
                          flush=True)
                    traceback.print_exc()
                records.append(rec)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    ok = sum(1 for r in records if r.get("status") == "ok")
    print(f"\ndry-run complete: {ok}/{len(records)} ok, {failures} failures")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
