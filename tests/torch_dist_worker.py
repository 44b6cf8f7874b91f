"""One rank of ``tests/test_torch_distributed.py``: the port's distributed
paths on a gloo mesh of CPU processes, held to the reference's outputs
(``torch_dist_jax_ref.py``'s ``.npz``) and to the port's own
single-device paths.

    python tests/torch_dist_worker.py RANK WORLD PORT REF.npz OUT.json

Every rank runs every check (SPMD); rank 0 writes the results as JSON:
for each check, whether it held on every rank and what it measured.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as tdist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.config import SHVSConfig, get_arch
from repro_torch.core import penalties as pen
from repro_torch.core.decision_plane import DecisionPlane
from repro_torch.core.hierarchical import hierarchical_sample
from repro_torch.core.sampling import SamplingParams
from repro_torch.core.sequence_parallel import sampler_axes
from repro_torch.launch import sharding
from repro_torch.launch.mesh import MeshShape, make_local_mesh
from repro_torch.models import dist, moe
from repro_torch.models.model import Model

SAMPLING_DEFAULTS = dict(temperature=1.0, top_k=0, top_p=1.0, min_p=0.0,
                         repetition_penalty=1.0, presence_penalty=0.0,
                         frequency_penalty=0.0)
HIER_SETS = {"tau1": dict(temperature=1.0), "greedy": dict(temperature=0.0),
             "topk": dict(temperature=0.9, top_k=20),
             "topp": dict(temperature=0.8, top_p=0.9),
             "pad": dict(temperature=1.0)}
HIER_CMP = {"tau1": "shvs", "greedy": "shvs", "topk": "truncation_first",
            "topp": "truncation_first", "pad": "shvs"}


def params(B, **kw):
    """SamplingParams for B rows: each field a scalar for all rows or a
    list a row, the rest at ``SamplingConfig``'s defaults."""
    vals = {**SAMPLING_DEFAULTS, **kw}

    def col(f, dt):
        v = vals[f]
        return torch.tensor(v if isinstance(v, list) else [v] * B, dtype=dt)

    return SamplingParams(
        temperature=col("temperature", torch.float32),
        top_k=col("top_k", torch.int32), top_p=col("top_p", torch.float32),
        min_p=col("min_p", torch.float32),
        repetition_penalty=col("repetition_penalty", torch.float32),
        presence_penalty=col("presence_penalty", torch.float32),
        frequency_penalty=col("frequency_penalty", torch.float32))


class Results:
    def __init__(self):
        self.out = {}

    def check(self, name, ok, **info):
        """Record a check: it holds if it held on every rank."""
        flag = torch.tensor([1 if ok else 0])
        tdist.all_reduce(flag, op=tdist.ReduceOp.MIN)
        self.out[name] = {"ok": bool(flag.item()), **info}

    def worst(self, x: float) -> float:
        t = torch.tensor([float(x)], dtype=torch.float64)
        tdist.all_reduce(t, op=tdist.ReduceOp.MAX)
        return float(t.item())


def blocks(mesh, x, spec):
    return sharding.local_shard(x, spec, mesh)


def state_block(mesh, state, mode):
    specs = sharding.decision_state_shardings(state, mesh, ("data",), mode)
    return pen.PenaltyState(*(blocks(mesh, s, sp) for s, sp in
                              zip(state, specs)))


def logits_block(mesh, z):
    """The LM head's layout: data rows, V split over model where it
    divides."""
    V = z.shape[1]
    tp = dist.get_ctx().axis_size(("model",))
    return blocks(mesh, z, ("data", "model" if V % tp == 0 else None))


def assemble_rows(x, mode):
    """A rank's decision rows (an even block of the batch) -> the global
    batch."""
    return dist.all_gather(x, sampler_axes(mode), dim=0, tiled=True)


def check_collectives(res):
    """The wrappers against their definitions, on a (2, 4) mesh."""
    r = tdist.get_rank()
    base = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    x = base + 100 * r                                  # (8, 6) a rank
    ranks = dist.get_ctx().mesh.mesh                    # (2, 4)
    d, m = dist.axis_index("data"), dist.axis_index("model")
    peers = ranks[d].tolist()                           # my model group
    ok = True
    # all_to_all: rows split over the group, columns concatenated
    got = dist.all_to_all(x, "model", split_dim=0, concat_dim=1)
    want = torch.cat([(base + 100 * p)[2 * m:2 * m + 2] for p in peers], 1)
    ok &= torch.equal(got, want)
    # psum_scatter: the group's sum, block m of the rows
    got = dist.psum_scatter(x, "model", dim=0)
    want = sum(base + 100 * p for p in peers)[2 * m:2 * m + 2]
    ok &= torch.equal(got, want)
    # tiled and stacked all_gather, pmax, the flattened (data, model) group
    ok &= torch.equal(dist.all_gather(x, "model", dim=1, tiled=True),
                      torch.cat([base + 100 * p for p in peers], 1))
    ok &= tuple(dist.all_gather(x, "model", dim=1).shape) == (8, 4, 6)
    ok &= torch.equal(dist.pmax(x, "model"), base + 100 * max(peers))
    ok &= torch.equal(
        dist.all_gather(torch.tensor([r]), ("data", "model"), tiled=True),
        torch.arange(8))
    ok &= dist.axis_index(("data", "model")) == r
    ok &= torch.equal(dist.pmean(x, ("data", "model")), base + 350.0)
    res.check("collectives", ok)


def check_sp_reference(res, ref, mesh):
    """S1 and vocab_gather planes at (2, 4) == the reference's, 3 steps."""
    z = torch.from_numpy(ref["sp_z"])
    B, V = z.shape
    p = params(B, temperature=0.9, top_k=20, repetition_penalty=1.2)
    for mode in ("sequence_parallel", "vocab_gather"):
        plane = DecisionPlane(V, algorithm="shvs",
                              shvs=SHVSConfig(hot_size=32),
                              sampling_parallelism=mode, k_cap=64, seed=7,
                              device="cpu")
        st = state_block(mesh, plane.init_state(
            B, prompt_tokens=torch.from_numpy(ref["sp_prompts"])), mode)
        zb = logits_block(mesh, z)
        toks = []
        for s in range(3):
            t, st, _ = plane.step(zb, st, p, s)
            toks.append(dist.all_gather(t, "data", tiled=True))
        counts = assemble_rows(st.output_counts, mode)
        want_t = ref[f"sp_{mode}_tokens"]
        ok = np.array_equal(torch.stack(toks).numpy(), want_t) and \
            np.array_equal(counts.numpy(), ref[f"sp_{mode}_counts"])
        ok &= np.array_equal(want_t, ref["sp_single_tokens"])
        res.check(f"sp_reference_{mode}", ok,
                  rows=list(zb.shape), tokens=torch.stack(toks).tolist())


def _gather_hier(x, V, blocked):
    """A hierarchical block (data rows, V/t) -> global."""
    if blocked and x.dim() == 2:
        x = dist.all_gather(x, "model", dim=1, tiled=True)
    return dist.all_gather(x, "data", dim=0, tiled=True)


def check_hierarchical_reference(res, ref, mesh):
    for name, kw in HIER_SETS.items():
        pre = f"h_{name}_"
        z = torch.from_numpy(ref[pre + "z"])
        B, V = z.shape
        p = params(B, repetition_penalty=1.2, **kw)
        plane = DecisionPlane(V, algorithm="shvs",
                              shvs=SHVSConfig(hot_size=64),
                              sampling_parallelism="hierarchical", k_cap=64,
                              seed=7, device="cpu")
        st_g = plane.init_state(B, prompt_tokens=torch.from_numpy(
            ref[pre + "prompts"]))
        st = state_block(mesh, st_g, "hierarchical")
        zb = logits_block(mesh, z)
        blocked = zb.shape[1] != V
        r0, n = dist.rows(B, ("data",))
        u = torch.from_numpy(plane.uniforms(0, B))[r0:r0 + n]
        p_loc = SamplingParams(*(f[r0:r0 + n] for f in p[:7]))
        toks, st2, hr = hierarchical_sample(zb, st, p_loc, u, plane.hot_set,
                                            k_cap=64, vocab=V)
        g = {k: _gather_hier(getattr(hr, k), V, blocked)
             for k in ("tokens", "accepted", "alpha", "exact_fast")}
        counts = _gather_hier(st2.output_counts, V, blocked)
        ok = np.array_equal(plane.hot_set.indices.numpy(), ref[pre + "hot"])
        for k in ("tokens", "accepted", "exact_fast"):
            ok &= np.array_equal(g[k].numpy(), ref[pre + k])
        ok &= np.array_equal(counts.numpy(), ref[pre + "counts"])
        a, want_a = g["alpha"].numpy(), ref[pre + "alpha"]
        ok &= np.allclose(a, want_a, rtol=1e-6, atol=0.0, equal_nan=True)
        nz = want_a != 0
        alpha_err = float(np.max(np.abs(a[nz] - want_a[nz]) /
                                 np.abs(want_a[nz]), initial=0.0))
        # through the plane's seam, params for the global batch
        t_plane, _, _ = plane.step(zb, st, p, 0)
        ok &= np.array_equal(dist.all_gather(t_plane, "data", tiled=True)
                             .numpy(), ref[pre + "tokens"])
        res.check(f"hierarchical_reference_{name}", ok,
                  alpha_rel_err=res.worst(alpha_err), blocked=blocked,
                  tokens=g["tokens"].tolist())
        # the reference's own single-device comparator agrees
        res.check(f"hierarchical_reference_single_{name}", np.array_equal(
            ref[pre + "tokens"], ref[pre + "single_tokens"]))


def check_moe_reference(res, ref, mesh):
    cfg = get_arch("granite-moe-1b-a400m").reduced()
    cfg = dataclasses.replace(cfg, dtype="float32")
    p_full = {k: torch.from_numpy(ref[f"moe_p_{k}"])
              for k in ("router", "w_gate", "w_up", "w_down")}
    p = sharding.shard_tree({"stack": {"moe": p_full}}, mesh, cfg)
    p = p["stack"]["moe"]
    x = blocks(mesh, torch.from_numpy(ref["moe_x"]), ("data", None, None))
    for strategy in ("gather", "scatter", "auto"):
        os.environ["REPRO_MOE_STRATEGY"] = strategy
        scatter = moe._prefer_scatter(x, cfg, dist.get_ctx())
        y, aux = moe.apply_moe(p, x, cfg, train=True)
        y = dist.all_gather(y, "data", dim=0, tiled=True)
        if strategy == "auto":
            res.out["moe_auto_path"] = "scatter" if scatter else "gather"
            continue
        want_y = ref[f"moe_{strategy}_y"]
        want_aux = float(ref[f"moe_{strategy}_aux"])
        y_err = float(np.max(np.abs(y.numpy() - want_y) /
                             (2e-4 + 2e-4 * np.abs(want_y))))
        aux_err = abs(float(aux) - want_aux) / abs(want_aux)
        res.check(f"moe_reference_{strategy}",
                  y_err <= 1.0 and aux_err <= 1e-5 and
                  scatter == (strategy == "scatter") and
                  tuple(p["w_gate"].shape) == (1, cfg.d_model, 256),
                  y_err_over_tol=res.worst(y_err),
                  aux_rel_err=res.worst(aux_err),
                  w_gate_block=list(p["w_gate"].shape))
    os.environ.pop("REPRO_MOE_STRATEGY")


def check_plane_vs_single(res, mesh):
    """The port's distributed plane == its own single-device plane."""
    B, V = 16, 256
    rs = np.random.default_rng(5)
    z = torch.from_numpy(rs.normal(0, 2, (B, V)).astype(np.float32))
    prompts = torch.from_numpy(rs.integers(0, V, (B, 5)))
    mixed = params(
        B, temperature=[0.8, 0.0, 1.0, 0.7] * 4,
        top_k=[0, 0, 20, 0] * 4, top_p=[1.0, 1.0, 1.0, 0.9] * 4,
        repetition_penalty=1.2, presence_penalty=0.1, frequency_penalty=0.05)
    runs = [("sequence_parallel", "shvs", mixed),
            ("sequence_parallel", "fused", mixed),
            ("sequence_parallel", "gumbel", mixed),
            ("vocab_gather", "shvs", mixed)]
    runs += [("hierarchical", HIER_CMP[k], params(B, repetition_penalty=1.2,
                                                  **HIER_SETS[k]))
             for k in ("tau1", "greedy", "topk", "topp")]
    for mode, algo, p in runs:
        kw = dict(shvs=SHVSConfig(hot_size=32), k_cap=64, seed=7,
                  device="cpu")
        with dist.use_mesh(None):
            single = DecisionPlane(V, algorithm=algo, **kw)
            st = single.init_state(B, prompt_tokens=prompts)
            want = []
            for s in range(3):
                t, st, _ = single.step(z, st, p, s)
                want.append(t)
            want_counts = st.output_counts
        plane = DecisionPlane(V, algorithm="shvs" if mode == "hierarchical"
                              else algo, sampling_parallelism=mode, **kw)
        st = state_block(mesh, plane.init_state(B, prompt_tokens=prompts),
                         mode)
        zb = logits_block(mesh, z)
        got = []
        for s in range(3):
            t, st, _ = plane.step(zb, st, p, s)
            got.append(dist.all_gather(t, "data", tiled=True))
        counts = st.output_counts
        if mode == "hierarchical":
            counts = _gather_hier(counts, V, zb.shape[1] != V)
        else:
            counts = assemble_rows(counts, mode)
        ok = torch.equal(torch.stack(got), torch.stack(want)) and \
            torch.equal(counts, want_counts)
        res.check(f"plane_vs_single_{mode}_{algo}", ok)


def check_decode(res, shape):
    """A reduced smollm / granite decode at ``shape`` (replicated twice
    over the 8 ranks): logits blocks == the single-process logits'
    slices, greedy tokens equal."""
    data, model = shape
    reps = tdist.get_world_size() // (data * model)
    mesh = init_device_mesh("cpu", (reps, data, model),
                            mesh_dim_names=("replica", "data", "model"))
    for arch in ("smollm-360m", "granite-moe-1b-a400m"):
        cfg = get_arch(arch).reduced()
        m = Model(cfg)
        params_full = m.init(seed=0, device="cpu")
        B, S, steps = 4, 6, 3
        toks = torch.from_numpy(np.random.default_rng(6).integers(
            0, cfg.vocab_size, (B, S)))
        greedy = params(B, temperature=0.0)
        with dist.use_mesh(None):
            cache = m.init_cache(B, 16, device="cpu")
            lg, cache = m.prefill(params_full, {"tokens": toks}, cache)
            want_logits, want_tokens = [lg], []
            for _ in range(steps):
                t = lg.argmax(-1)
                want_tokens.append(t)
                lg, cache = m.decode_step(params_full, t, cache)
                want_logits.append(lg)
        with dist.use_mesh(mesh):
            p = sharding.shard_tree(params_full, mesh, cfg)
            r0, n = dist.rows(B, ("data",))
            plane = DecisionPlane(cfg.vocab_size, algorithm="shvs",
                                  k_cap=64, device="cpu")
            st = state_block(mesh, plane.init_state(B), "sequence_parallel")
            cache = m.init_cache(n, 16, device="cpu")
            lg, cache = m.prefill(p, {"tokens": toks[r0:r0 + n]}, cache)
            err, tok_ok = 0.0, True
            for i in range(steps + 1):
                tp = dist.get_ctx().axis_size(("model",))
                V = cfg.vocab_size
                cols = V // tp if V % tp == 0 else V
                c0 = dist.axis_index("model") * cols if cols != V else 0
                want = want_logits[i][r0:r0 + n, c0:c0 + cols]
                ok_shape = tuple(lg.shape) == tuple(want.shape)
                err = max(err, float(torch.max(torch.abs(lg - want) /
                                               (1e-5 + 1e-5 * want.abs())))
                          if ok_shape else float("inf"))
                if i == steps:
                    break
                t, st, _ = plane.step(lg, st, greedy, i)
                tok_ok &= torch.equal(t.long(), want_tokens[i][r0:r0 + n])
                lg, cache = m.decode_step(p, t, cache)
            experts = p["stack"]["moe"]["w_gate"].shape \
                if cfg.moe is not None else None
        res.check(f"decode_{arch}_{data}x{model}", err <= 1.0 and tok_ok,
                  err_over_tol=res.worst(err), logits_block=list(lg.shape),
                  expert_block=list(experts) if experts else None)


def main(rank, world, port, ref_path, out_path):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=world, rank=rank)
    ref = np.load(ref_path)
    res = Results()
    mesh = make_local_mesh(2, 4)
    res.out["mesh_shape"] = dict(MeshShape.of(mesh).shape)
    with dist.use_mesh(mesh):
        check_collectives(res)
        check_sp_reference(res, ref, mesh)
        check_hierarchical_reference(res, ref, mesh)
        check_moe_reference(res, ref, mesh)
        check_plane_vs_single(res, mesh)
    for shape in ((2, 2), (1, 4)):
        check_decode(res, shape)
    res.out["staged"] = list(dist.staged_collectives())
    tdist.barrier()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res.out, f)
    tdist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
