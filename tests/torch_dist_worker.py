"""One rank of ``tests/test_torch_distributed.py``: the port's distributed
paths on a gloo mesh of CPU processes, held to the reference's outputs
(``torch_dist_jax_ref.py``'s ``.npz``) and to the port's own
single-device paths.

    python tests/torch_dist_worker.py RANK WORLD PORT REF.npz OUT.json [MODE]

MODE "tp" runs instead the checks of ``tests/test_torch_tp.py`` (the
tensor-parallel forward and train step of every family against the
single-process ones, and the serving and train programs against the
reference's, REF.npz being ``torch_dist_jax_ref.py``'s "programs"
output); MODE "stats" (2 ranks, no
REF) runs known collectives and writes ``dist.collective_stats()`` for
``tests/test_torch_hlo_analysis.py``.

Every rank runs every check (SPMD); rank 0 writes the results as JSON:
for each check, whether it held on every rank and what it measured.
"""
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as tdist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.config import SHVSConfig, ShapeConfig, get_arch
from repro_torch.core import penalties as pen
from repro_torch.core.decision_plane import DecisionPlane
from repro_torch.core.hierarchical import hierarchical_sample
from repro_torch.core.sampling import SamplingParams
from repro_torch.core.sequence_parallel import sampler_axes
from repro_torch.launch import sharding, steps
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


#: the families of the tensor-parallel forward, reduced f32: (arch, prompt
#: length, cache length, window override). starcoder2's window of 16 under
#: a 20-token prompt makes the cache a ring that wraps; llama4's reduced
#: MoE carries the shared expert; "rwkv6-3b-midhead" is reduced RWKV-6
#: with 6 heads of 16, whose time mix's column block at t = 4 (24 of 96)
#: ends inside a head (:func:`reduced_config`).
TP_ARCHS = (("smollm-360m", 6, 16, None), ("qwen3-8b", 6, 16, None),
            ("tinyllama-1.1b", 6, 16, None), ("starcoder2-7b", 20, 32, 16),
            ("internvl2-2b", 6, 32, None), ("whisper-base", 6, 16, None),
            ("granite-moe-1b-a400m", 6, 16, None),
            ("llama4-maverick-400b-a17b", 6, 16, None),
            ("rwkv6-3b", 6, 16, None), ("zamba2-1.2b", 6, 16, None),
            ("rwkv6-3b-midhead", 6, 16, None))
TP_STEPS = 3
#: the logits' tolerance (abs + rel) of the tensor-parallel forward: its
#: row-parallel sums add the same terms in another order. Reduced Zamba2
#: is ill-conditioned in f32: a relative noise of 1.2e-7 (one ulp) on its
#: embedding table alone moves its logits by 1.0-1.9 times 1e-5
#: (smollm-360m: 0.08-0.13 times), so it is held at 5e-5.
TP_TOL = {"zamba2-1.2b": 5e-5}


def tp_batch(cfg, B, S):
    """Seeded numpy inputs: tokens, and the VLM's patch embeddings or the
    audio family's encoder frames."""
    rs = np.random.default_rng(11)
    batch = {"tokens": torch.from_numpy(rs.integers(0, cfg.vocab_size,
                                                    (B, S)))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rs.normal(size=(
            B, cfg.frontend.num_embeddings, cfg.d_model)).astype(np.float32))
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(rs.normal(size=(
            B, cfg.encoder.num_frames, cfg.d_model)).astype(np.float32))
    return batch


def _whole_vocab(lg, V):
    """A rank's logits block -> its data rows over the whole vocabulary."""
    if lg.shape[1] != V:
        lg = dist.all_gather(lg, "model", dim=1, tiled=True)
    return lg


def check_tp(res, shape, archs=TP_ARCHS, batch_axes=("data",), tag=""):
    """The tensor-parallel forward at ``shape`` (replicated over the 8
    ranks) against the single-process forward, every family: after a
    prefill and TP_STEPS greedy decode steps, each rank's logits block
    within 1e-5 (abs + rel) of the single-process block, greedy tokens
    equal, the rank's weight bytes equal to param_spec's reckoning and
    its cache bytes at most cache_shardings' (TP_TOL: Zamba2's).
    ``batch_axes`` None replicates the batch (the reference's B = 1
    layout), under which the spec splits Zamba2's SSM state too."""
    data, model = shape
    reps = tdist.get_world_size() // (data * model)
    mesh = init_device_mesh("cpu", (reps, data, model),
                            mesh_dim_names=("replica", "data", "model"))
    B = 4
    for arch, S, Sc, window in archs:
        cfg = reduced_config(arch)
        m = Model(cfg)
        V = cfg.vocab_size
        tol = TP_TOL.get(arch, 1e-5)
        params_full = m.init(seed=0, device="cpu")
        batch = tp_batch(cfg, B, S)
        with dist.use_mesh(None):
            cache = m.init_cache(B, Sc, window=window, device="cpu")
            whole_cache = {k: v.clone() for k, v in cache.items()}
            lg, cache = m.prefill(params_full, batch, cache, window=window)
            want_logits, want_tokens = [lg], []
            for _ in range(TP_STEPS):
                t = lg.argmax(-1)
                want_tokens.append(t)
                lg, cache = m.decode_step(params_full, t, cache,
                                          window=window)
                want_logits.append(lg)
        with dist.use_mesh(mesh, batch_axes=batch_axes):
            p = sharding.shard_tree(params_full, mesh, cfg,
                                    keep=sharding.every_leaf)
            r0, n = dist.rows(B, batch_axes)
            cache = m.init_cache(n, Sc, window=window, device="cpu")
            mine = {k: v[r0:r0 + n] for k, v in batch.items()}
            dist.reset_collective_stats()
            lg, cache = m.prefill(p, mine, cache, window=window)
            err, tok_ok = 0.0, True
            for i in range(TP_STEPS + 1):
                tp = dist.get_ctx().axis_size(("model",))
                cols = V // tp if V % tp == 0 else V
                c0 = dist.axis_index("model") * cols if cols != V else 0
                want = want_logits[i][r0:r0 + n, c0:c0 + cols]
                ok_shape = tuple(lg.shape) == tuple(want.shape)
                err = max(err, float(torch.max(torch.abs(lg - want) /
                                               (tol + tol * want.abs())))
                          if ok_shape else float("inf"))
                if i == TP_STEPS:
                    break
                t = _whole_vocab(lg, V).argmax(-1)
                tok_ok &= torch.equal(t, want_tokens[i][r0:r0 + n])
                lg, cache = m.decode_step(p, t, cache, window=window)
            calls = sum(v["calls"] for v in
                        dist.collective_stats().values())
            w_spec = sharding.rank_bytes(
                params_full, sharding.param_shardings(params_full, mesh,
                                                      cfg), mesh)
            c_spec = sharding.rank_bytes(
                whole_cache, sharding.cache_shardings(
                    whole_cache, mesh, cfg, batch_axes), mesh)
            w_held = sharding.held_bytes(p)
            c_held = sharding.held_bytes(cache)
        res.check(f"tp_{arch}_{data}x{model}{tag}",
                  err <= 1.0 and tok_ok and w_held == w_spec and
                  c_held <= c_spec,
                  err_over_tol=res.worst(err), tokens_equal=tok_ok,
                  logits_block=list(lg.shape), weight_bytes=w_held,
                  weight_bytes_spec=w_spec, cache_bytes=c_held,
                  cache_bytes_spec=c_spec, collective_calls=calls)


#: the train step's tolerances, after ``tests/test_torch_steps.py``'s
#: scheme for the first AdamW step: loss and grad norm within TRAIN_RTOL
#: relative; each gradient block within TRAIN_RTOL of the leaf's largest
#: single-process gradient (the row-parallel and psum'd sums add the same
#: terms in another order); the parameters after the step within 1e-6
#: absolute + 1e-5 relative plus what the gradient's tolerance δ moves the
#: first AdamW step by: it moves an element by lr·g/(|g| + ε), ε = 1e-8,
#: so by at most lr·ε·δ/((|g| − δ + ε)(|g| + ε)) more where |g| > δ, and
#: by up to 2·lr where |g| ≤ δ (g's sign open); |g| the single process's
#: gradient. Against the reference's program (no gradient to read) the
#: scheme is test_torch_steps.py's: at most a 1e-4 share of a leaf's
#: elements off (or one element), each within twice the learning rate.
TRAIN_RTOL = 1e-5
#: (gradient tolerance, the share against the reference) where the
#: reduced config's step is ill-conditioned in f32, at the single
#: process's own sensitivity: one-ulp relative noise (1.2e-7) on the
#: parameters alone moves its gradients by up to 19.8e-5 (RWKV-6), 5.0e-5
#: (Zamba2) and 1.8e-5 (llama4's router) of a leaf's largest (smollm-360m:
#: 0.18e-5), and its parameters after the step off as above on up to a
#: 3.1e-4 share of a leaf (RWKV-6; smollm-360m: 0.9e-4)
TRAIN_TOL = {"rwkv6-3b": (2e-4, 5e-4), "rwkv6-3b-midhead": (2e-4, 5e-4),
             "zamba2-1.2b": (5e-5, 5e-4),
             "llama4-maverick-400b-a17b": (2e-5, 5e-4)}
TRAIN_B, TRAIN_S = 4, 8


def train_batch(cfg, B=TRAIN_B, S=TRAIN_S):
    batch = tp_batch(cfg, B, S)
    rs = np.random.default_rng(12)
    batch["labels"] = torch.from_numpy(rs.integers(0, cfg.vocab_size,
                                                   (B, S)))
    return batch


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _single_step(model, params, batch, tcfg):
    """The single process's train step, its gradient computed once: (the
    gradient tree, the parameters after the step, the metrics, the leaves
    the loss does not reach)."""
    from repro_torch.training.optimizer import (adamw_init, adamw_update,
                                                tree_leaves, tree_map,
                                                tree_unflatten)
    from repro_torch.training.train_loop import loss_fn
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, met = loss_fn(model, live, batch, tcfg, remat=tcfg.remat)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    unused = sorted(k for k, g in zip(_leaves(params), grads) if g is None)
    g = tree_unflatten(params, [torch.zeros_like(p) if g is None else g
                                for p, g in zip(leaves, grads)])
    after, _, opt_met = adamw_update(params, g, adamw_init(params), tcfg)
    return g, after, {**met, **opt_met}, unused


def _grad_errors(got_g, want_g, rtol):
    """The worst gradient block's error over its tolerance (``rtol`` of
    the leaf's largest single-process gradient)."""
    err = 0.0
    for k, want in _leaves(want_g).items():
        got = _leaves(got_g)[k]
        if tuple(got.shape) != tuple(want.shape):
            return float("inf")
        scale = rtol * max(float(want.abs().max()), 1e-30)
        err = max(err, float((got.float() - want.float()).abs().max())
                  / scale)
    return err


def _param_errors(got_p, want_p, lr, g_whole=None, rtol=TRAIN_RTOL,
                  share=1e-4, eps=1e-8):
    """The parameters after the step (``got_p``: the ranks' blocks
    gathered) against ``want_p``, both {path: leaf}: (the worst count of a
    leaf's elements off by more than allowed over the count allowed off,
    whether every element off is within 2·lr). With the single process's
    whole gradients ``g_whole`` an element is allowed 1e-6 + 1e-5·|want|
    plus what the gradient's tolerance δ (``rtol`` of the leaf's largest)
    moves AdamW's first step by (TRAIN_RTOL's comment), and none may be
    off; without, 1e-6 + 1e-5·|want|, and a ``share`` of the leaf (at
    least one element) may be off."""
    worst, ok = 0.0, True
    for k, want in want_p.items():
        got = got_p[k].float()
        want = want.float()
        diff = (got - want).abs()
        allowed = 1e-6 + 1e-5 * want.abs()
        if g_whole is not None:
            g = g_whole[k].float().abs()
            d = rtol * float(g.max())
            moved = lr * eps * d / ((g - d + eps) * (g + eps))
            allowed = allowed + torch.where(g > d, moved, 2 * lr)
        off = diff > allowed
        if g_whole is not None:
            worst = max(worst, float(off.sum()))
        else:
            worst = max(worst, int(off.sum()) / max(share * off.numel(), 1))
        ok &= bool((diff[off] < 2 * lr).all())
    return worst, ok


def check_tp_train(res, shape, archs=None, single=None):
    """The train program's step at ``shape`` (replicated over the 8
    ranks) against the single process's, every family (``TP_ARCHS`` and
    the mid-head RWKV-6): the loss and grad norm within TRAIN_RTOL, each
    rank's gradient blocks and the parameters after the step (the blocks
    gathered) as TRAIN_RTOL's comment says (TRAIN_TOL's gradient tolerance
    where a family is ill-conditioned), the leaves without a gradient the single
    process's (none), and the collectives of the step by phase.
    ``single``: a dict the single-process steps are kept in across
    shapes."""
    from repro_torch.config import TrainConfig
    from repro_torch.training.optimizer import adamw_init, adamw_update
    from repro_torch.training.train_loop import grad_layout, grads_of
    data, model_ax = shape
    reps = tdist.get_world_size() // (data * model_ax)
    mesh = init_device_mesh("cpu", (reps, data, model_ax),
                            mesh_dim_names=("replica", "data", "model"))
    tcfg = TrainConfig(warmup_steps=1, total_steps=10)
    single = {} if single is None else single
    for arch in archs or TRAIN_ARCHS:
        cfg = reduced_config(arch)
        m = Model(cfg)
        batch = train_batch(cfg)
        if arch not in single:
            with dist.use_mesh(None):
                p_full = m.init(seed=0, device="cpu")
                single[arch] = (p_full,) + _single_step(m, p_full, batch,
                                                        tcfg)
        p_full, g_full, p1, met, unused = single[arch]
        with dist.use_mesh(mesh, batch_axes=("data",)):
            keep = sharding.every_leaf
            p = sharding.shard_tree(p_full, mesh, cfg, keep=keep)
            want_g = sharding.shard_tree(g_full, mesh, cfg, keep=keep)
            r0, n = dist.rows(TRAIN_B, ("data",))
            mine = {k: v[r0:r0 + n] for k, v in batch.items()}
            # the train step's two halves, as make_train_step runs them
            cut, g, q, tmet = None, None, p, {}
            dist.reset_collective_stats()
            layout = grad_layout(m, p)
            try:
                _, tmet, g = grads_of(m, p, mine, tcfg, remat=tcfg.remat,
                                      layout=layout)
                q, _, opt_met = adamw_update(
                    p, g, adamw_init(p), tcfg,
                    split_axes=[axes for axes, _ in layout])
                tmet.update(opt_met)
            except RuntimeError as e:
                cut = str(e)
            phases = {ph: sum(v["calls"] for v in st.values())
                      for ph, st in dist.phase_stats().items()}
            specs = _leaves(sharding.param_shardings(p_full, mesh, cfg))
            q = {k: _gather_block(v, specs[k])
                 for k, v in _leaves(q).items()}
        lr = float(met["lr"])
        g_tol, _ = TRAIN_TOL.get(arch, (TRAIN_RTOL, 1e-4))
        g_err = float("inf") if g is None else \
            _grad_errors(g, want_g, g_tol)
        off, off_ok = _param_errors(q, _leaves(p1), lr, _leaves(g_full),
                                    g_tol)
        rel = lambda k: abs(float(tmet[k]) - float(met[k])) / \
            max(abs(float(met[k])), 1e-30) if k in tmet else float("inf")
        loss_err = rel("loss") / TRAIN_RTOL
        norm_err = rel("grad_norm") / TRAIN_RTOL
        ok = (cut is None and not unused and loss_err <= 1 and
              norm_err <= 1 and g_err <= 1 and off == 0 and off_ok)
        res.check(f"train_{arch}_{data}x{model_ax}", ok,
                  loss_over_tol=res.worst(loss_err),
                  grad_norm_over_tol=res.worst(norm_err),
                  grad_over_tol=res.worst(g_err),
                  params_off=res.worst(off), severed=cut,
                  unused_single=unused, phases=phases)


#: the train step's families: TP_ARCHS'
TRAIN_ARCHS = tuple(a[0] for a in TP_ARCHS)


def reduced_config(arch):
    if arch == "rwkv6-3b-midhead":
        cfg = get_arch("rwkv6-3b").reduced()
        return dataclasses.replace(
            cfg, d_model=96, ssm=dataclasses.replace(cfg.ssm,
                                                     rwkv_head_size=16))
    return get_arch(arch).reduced()


def _gather_block(x, spec):
    """A leaf's whole value from the ranks' blocks under ``spec``."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            x = dist.all_gather(x, entry, dim=dim, tiled=True)
    return x


def check_programs_reference(res, ref):
    """The port's per-rank prefill and serve-step programs (S1, shvs) at
    (2, 4) on reduced f32 smollm-360m == the reference's jitted GSPMD
    programs (``torch_dist_jax_ref.py programs``): the first tokens and
    three serve steps' tokens exactly, the logits blocks within 1e-5
    (abs + rel)."""
    cfg = get_arch("smollm-360m").reduced()
    model = Model(cfg)
    B, S, Sc = 8, 16, 32
    params_full = {}
    for key in ref.files:
        if key.startswith("p/"):
            node = params_full
            *path, leaf = key[2:].split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = torch.from_numpy(ref[key])
    tokens = torch.from_numpy(ref["tokens"])
    sp = SamplingParams(**{f: torch.from_numpy(ref[f"sp_{f}"]).to(
        torch.int32 if f == "top_k" else torch.float32)
        for f in SAMPLING_DEFAULTS})
    mesh = make_local_mesh(2, 4)
    want_t, want_l = ref["ref_tokens"], ref["ref_logits"]
    pre = steps.make_prefill_program(cfg, ShapeConfig("p", S, B, "prefill"),
                                     mesh, device="cpu")
    dec = steps.make_serve_step_program(
        cfg, ShapeConfig("d", Sc, B, "decode"), mesh, device="cpu")
    err, tok_ok = 0.0, True

    def held(lg, i):
        r0, n = dist.rows(B, ("data",))
        cols = cfg.vocab_size // 4
        c0 = dist.axis_index("model") * cols
        want = torch.from_numpy(want_l[i][r0:r0 + n, c0:c0 + cols])
        return float(torch.max(torch.abs(lg - want) /
                               (1e-5 + 1e-5 * want.abs())))

    def rows_of(cache):
        r0, n = dist.rows(B, ("data",))
        return {k: v.clone() for k, v in cache.items()} | \
            {"len": cache["len"][r0:r0 + n].clone()}

    with dist.use_mesh(mesh, batch_axes=pre[4], model_axes=("model",)):
        fn, a_in, ins, _, _ = pre
        zeros = {k: torch.zeros(v.shape, dtype=v.dtype)
                 for k, v in a_in[2].items()}
        p, batch, cache, spl = steps.local_inputs(
            cfg, (params_full, {"tokens": tokens}, zeros, sp), ins, mesh)
        lg, _ = model.prefill(p, batch, rows_of(cache))
        err = max(err, held(lg, 0))
        tok, cache = fn(p, batch, cache, spl)
        tok_all = dist.all_gather(tok, "data", tiled=True)
        tok_ok &= np.array_equal(tok_all.numpy(), want_t[0])
        whole = {k: _gather_block(v, spec) for (k, v), spec in
                 zip(cache.items(), ins[2].values())}
    for k in ("k", "v"):
        pad = whole[k].new_zeros(whole[k].shape[:2] + (Sc - S,) +
                                 whole[k].shape[3:])
        whole[k] = torch.cat([whole[k], pad], dim=2)
    state = pen.update_histograms(pen.init_state(B, cfg.vocab_size, tokens),
                                  tok_all)
    with dist.use_mesh(mesh, batch_axes=dec[4], model_axes=("model",)):
        fn, _, ins, _, _ = dec
        _, cache, st, tok, spl, _ = steps.local_inputs(
            cfg, (params_full, whole, state, tok_all, sp, 0), ins, mesh)
        for i in range(3):
            lg, _ = model.decode_step(p, tok, rows_of(cache))
            err = max(err, held(lg, i + 1))
            tok, cache, st = fn(p, cache, st, tok, spl, i + 1)
            tok_ok &= np.array_equal(
                dist.all_gather(tok, "data", tiled=True).numpy(),
                want_t[i + 1])
    res.check("programs_reference_2x4", err <= 1.0 and tok_ok,
              err_over_tol=res.worst(err), tokens_equal=tok_ok)


def check_train_programs_reference(res, ref):
    """The port's per-rank train program at (2, 4) == the reference's
    jitted GSPMD train program (``torch_dist_jax_ref.train_program``) on
    reduced f32 smollm-360m, granite-moe-1b-a400m and rwkv6-3b, from the
    reference's parameters: loss and grad norm within TRAIN_RTOL relative,
    the parameters after the step (the ranks' blocks gathered) with at
    most a 1e-4 share of a leaf off (TRAIN_TOL's for RWKV-6), as
    TRAIN_RTOL's comment says."""
    from repro_torch.training.optimizer import adamw_init
    mesh = make_local_mesh(2, 4)
    for arch in ("smollm-360m", "granite-moe-1b-a400m", "rwkv6-3b"):
        cfg = get_arch(arch).reduced()
        pre = f"train/{arch}/"

        def tree(tag):
            out = {}
            for key in ref.files:
                if key.startswith(pre + tag + "/"):
                    node = out
                    *path, leaf = key[len(pre) + len(tag) + 1:].split("/")
                    for k in path:
                        node = node.setdefault(k, {})
                    node[leaf] = torch.from_numpy(ref[key])
            return out

        p_full, q_want = tree("p"), tree("q")
        batch = {k: torch.from_numpy(ref[pre + k])
                 for k in ("tokens", "labels")}
        B, S = batch["tokens"].shape
        fn, a_in, ins, _, baxes = steps.make_train_step_program(
            cfg, ShapeConfig("t", S, B, "train"), mesh, device="cpu")
        with dist.use_mesh(mesh, batch_axes=baxes, model_axes=("model",)):
            p, opt, b = steps.local_inputs(
                cfg, (p_full, adamw_init(p_full), batch), ins, mesh)
            q, _, met = fn(p, opt, b)
            specs = _leaves(ins[0])
            q = {k: _gather_block(v, specs[k])
                 for k, v in _leaves(q).items()}
        _, off_max = TRAIN_TOL.get(arch, (TRAIN_RTOL, 1e-4))
        lr = float(ref[pre + "lr"])
        off, off_ok = _param_errors(q, _leaves(q_want), lr, share=off_max)
        rel = lambda k: abs(float(met[k]) - float(ref[pre + k])) / \
            abs(float(ref[pre + k])) / TRAIN_RTOL
        res.check(f"train_program_reference_{arch}_2x4",
                  rel("loss") <= 1 and rel("grad_norm") <= 1 and
                  off <= 1 and off_ok,
                  loss_over_tol=res.worst(rel("loss")),
                  grad_norm_over_tol=res.worst(rel("grad_norm")),
                  param_off_over_tol=res.worst(off))


def check_stats(res):
    """Known collectives over the model group of a (1, 2) mesh; the
    counts and bytes ``dist.collective_stats`` keeps, for
    ``launch/hlo_analysis.collective_stats_from``."""
    mesh = make_local_mesh(1, 2)
    with dist.use_mesh(mesh):
        dist.reset_collective_stats()
        x = torch.ones((4, 6), dtype=torch.float32)
        dist.all_gather(x, "model", dim=0, tiled=True)        # 96 B in
        dist.psum(x, "model")                                 # 96 B
        dist.psum(x[:1], "model")                             # 24 B
        dist.pmax(x, "model")                                 # 96 B
        dist.psum_scatter(x, "model", dim=0)                  # 96 B
        dist.all_to_all(x, "model", split_dim=0, concat_dim=1)  # 96 B
        res.out["stats"] = dist.collective_stats()
        res.out["group"] = dist.tp_size()


def wait_for(path, timeout=600.0):
    """``path`` once it exists (the reference's outputs, written by a
    process that runs beside this job)."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.5)
    return path


def main(rank, world, port, ref_path, out_path, mode="distribution"):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=world, rank=rank)
    res = Results()
    if mode == "stats":
        check_stats(res)
    elif mode == "tp":
        single = {}
        for shape in ((2, 2), (1, 4), (2, 4)):
            check_tp(res, shape)
            check_tp_train(res, shape, single=single)
        check_tp(res, (1, 4), [a for a in TP_ARCHS if a[0] == "zamba2-1.2b"],
                 batch_axes=None, tag="_replicated")
        ref = np.load(wait_for(ref_path))
        check_programs_reference(res, ref)
        check_train_programs_reference(res, ref)
    else:
        ref = np.load(ref_path)
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
         sys.argv[5], *sys.argv[6:])
