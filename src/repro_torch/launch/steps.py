"""The programs the launchers and the dry-run run, one rank's each.

* ``make_train_step_program``  — forward+backward+AdamW   (train_4k)
* ``make_prefill_program``     — prompt prefill + first-token decision
  (prefill_32k)
* ``make_serve_step_program``  — ONE decode token against the KV cache +
  the full decision plane (decode_32k, long_500k)

Each returns ``(fn, inputs, in_specs, out_specs, batch_axes)``, as the
reference's return what ``jax.jit(fn, in_shardings, out_shardings)``
lowers. Here ``fn`` is the program of one rank: it takes the rank's
blocks of the inputs (:func:`local_inputs` cuts them from whole inputs)
and returns its blocks of the outputs, under ``dist.use_mesh(mesh,
batch_axes, model_axes)``, which the caller installs (as the reference's
dry-run does). ``inputs`` are the whole inputs as meta tensors (shapes and
dtypes, nothing allocated); the specs are the reference's, from
``launch/sharding.py``. ``mesh`` may be None (one rank, no mesh).

Where a spec leaves a leaf whole but the rank's program needs less of it,
the rank holds less: RWKV-6's WKV state holds only the heads (or the
value columns) of the rank's time mix (``models/transformer.init_cache``).
The per-sequence ``len`` of a cache is replicated by its spec, so a
program reads its rows of it and returns it whole.

The train program's ``fn`` is one rank's AdamW step on its blocks of the
parameters and moments and its rows of the batch
(``training/train_loop.make_train_step``): the vocab-parallel loss, the
gradient through the collectives' adjoints, each leaf's gradient summed
over the axes its spec does not split, and the clip norm over the
blocks. Its metrics come out replicated, the same on every rank.
"""
from __future__ import annotations

import torch

from repro_torch.config import (ModelConfig, ShapeConfig, SHVSConfig,
                                TrainConfig, model_for_shape)
from repro_torch.core import penalties as pen
from repro_torch.core.decision_plane import DecisionPlane
from repro_torch.core.sampling import SamplingParams
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import dist
from repro_torch.models.model import Model
from repro_torch.models.transformer import kv_slots, rwkv_state_local
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_loop import make_train_step

_ONE = MeshShape((1, 1), ("data", "model"))


def _mesh(mesh):
    return _ONE if mesh is None else mesh


def _decision_plane(cfg: ModelConfig, parallelism: str,
                    device) -> DecisionPlane:
    return DecisionPlane(
        cfg.vocab_size, algorithm="shvs",
        shvs=SHVSConfig(hot_size=min(32768, max(1024, cfg.vocab_size // 4))),
        sampling_parallelism=parallelism, k_cap=min(1024, cfg.vocab_size),
        device=device)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _abstract_sampling_params(B):
    f = lambda dt: _meta((B,), dt)
    return SamplingParams(temperature=f(torch.float32),
                          top_k=f(torch.int32), top_p=f(torch.float32),
                          min_p=f(torch.float32),
                          repetition_penalty=f(torch.float32),
                          presence_penalty=f(torch.float32),
                          frequency_penalty=f(torch.float32))


def _sampling_params_spec(batch_axes):
    return SamplingParams(*([shd._P(tuple(batch_axes) if batch_axes
                                    else None)] * 7))


def _abstract(model: Model, fn):
    """Meta tensors of the whole (global) inputs: built with no mesh, so
    no block is cut."""
    with dist.use_mesh(None):
        return fn(model)


def _global_params(sp: SamplingParams, B: int) -> SamplingParams:
    """The rank's rows of the sampling params (their spec splits the
    batch) -> the global batch's, which the plane reads: one all-gather
    over the batch axes of the seven fields packed (top-k's ids are exact
    in float32)."""
    ctx = dist.get_ctx()
    if sp.temperature.shape[0] == B:
        return sp
    packed = torch.stack([f.float() for f in sp[:7]], -1)
    whole = dist.all_gather(packed, ctx.batch_axes, dim=0, tiled=True)
    fields = [whole[:, i].contiguous() for i in range(7)]
    fields[1] = fields[1].to(torch.int32)
    return SamplingParams(*fields)


def _rows(cache, B: int):
    """The rank's data rows of a cache whose ``len`` is whole (its spec
    replicates it): (the cache with its rows of ``len``, the whole
    ``len``, or None where the cache holds every row)."""
    lens = cache["len"]
    b = next(v.shape[1] for v in cache.values() if v.dim() >= 2)
    if b == lens.shape[0]:
        return cache, None
    r0, _ = dist.rows(B, dist.get_ctx().batch_axes)
    return {**cache, "len": lens[r0:r0 + b]}, lens


def _whole_len(cache, before, lens):
    """The cache a step returned, with ``len`` whole again: every row
    advanced by the step's tokens (``before``: the rows' cache the step
    took)."""
    if lens is None:
        return cache
    return {**cache, "len": lens + (cache["len"][:1] - before["len"][:1])}


def make_train_step_program(cfg: ModelConfig, shape: ShapeConfig, mesh,
                            train_cfg: TrainConfig = TrainConfig(),
                            device="cuda"):
    cfg = model_for_shape(cfg, shape)
    model = Model(cfg)
    m = _mesh(mesh)
    batch_axes = shd.batch_axes_for(shape, m)
    step = make_train_step(model, train_cfg)

    B, S = shape.global_batch, shape.seq_len
    a_params = _abstract(model, lambda md: md.init(device="meta"))
    a_opt = adamw_init(a_params)
    a_batch = {"tokens": _meta((B, S), torch.int32),
               "labels": _meta((B, S), torch.int32)}
    for k, v in model.input_specs(B, S, "train").items():
        if k != "tokens":
            a_batch[k] = v

    p_shard = shd.param_shardings(a_params, m, cfg)
    o_shard = shd.opt_shardings(a_opt, p_shard, m)
    b_shard = shd.batch_shardings(a_batch, m, batch_axes)
    rep = {k: () for k in ("loss", "ce", "z_loss", "moe_aux", "ppl", "lr",
                           "grad_norm")}
    return (step, (a_params, a_opt, a_batch), (p_shard, o_shard, b_shard),
            (p_shard, o_shard, rep), batch_axes)


def make_prefill_program(cfg: ModelConfig, shape: ShapeConfig, mesh,
                         parallelism: str = "sequence_parallel",
                         device="cuda"):
    cfg = model_for_shape(cfg, shape)
    model = Model(cfg)
    dp = _decision_plane(cfg, parallelism, device)
    m = _mesh(mesh)
    batch_axes = shd.batch_axes_for(shape, m)
    B, S = shape.global_batch, shape.seq_len
    window = shape.window_override or None

    def prefill_step(params, batch, cache, sparams):
        rows, lens = _rows(cache, B)
        logits, cache = model.prefill(params, batch, rows, window=window)
        pstate = _prompt_state(batch["tokens"], B, cfg.vocab_size,
                               parallelism)
        tokens, _, _ = dp.step(logits, pstate, _global_params(sparams, B), 0)
        return tokens, _whole_len(cache, rows, lens)

    a_params = _abstract(model, lambda md: md.init(device="meta"))
    a_batch = model.input_specs(B, S, "prefill")
    a_cache = _abstract(model, lambda md: md.init_cache(
        B, S, window=window, device="meta"))
    a_sp = _abstract_sampling_params(B)

    p_shard = shd.param_shardings(a_params, m, cfg)
    b_shard = shd.batch_shardings(a_batch, m, batch_axes)
    c_shard = shd.cache_shardings(a_cache, m, cfg, batch_axes)
    sp_shard = _sampling_params_spec(batch_axes)
    tok_out = shd._P(tuple(batch_axes) if batch_axes else None)
    return (prefill_step, (a_params, a_batch, a_cache, a_sp),
            (p_shard, b_shard, c_shard, sp_shard), (tok_out, c_shard),
            batch_axes)


def _prompt_state(tokens, B: int, V: int, parallelism: str):
    """The penalty state of the prompts (the reference's ``init_state(B,
    V, tokens)``) in the plane's layout: the global batch's histograms,
    from the ranks' token blocks gathered over the batch axes, cut to the
    rank's block by ``decision_state_shardings``."""
    ctx = dist.get_ctx()
    if tokens.shape[0] != B:
        tokens = dist.all_gather(tokens, ctx.batch_axes, dim=0, tiled=True)
    state = pen.init_state(B, V, tokens)
    if not ctx.active:
        return state
    specs = shd.decision_state_shardings(state, ctx.mesh, ctx.batch_axes,
                                         mode=parallelism)
    return shd.local_tree(state, specs, ctx.mesh)


def make_serve_step_program(cfg: ModelConfig, shape: ShapeConfig, mesh,
                            parallelism: str = "sequence_parallel",
                            algorithm: str = "shvs", device="cuda"):
    """One decode iteration: forward one token + full decision plane."""
    cfg = model_for_shape(cfg, shape)
    model = Model(cfg)
    dp = _decision_plane(cfg, parallelism, device)
    dp.algorithm = algorithm
    m = _mesh(mesh)
    batch_axes = shd.batch_axes_for(shape, m)
    B, S = shape.global_batch, shape.seq_len
    window = shape.window_override or None

    def serve_step(params, cache, pstate, last_tokens, sparams, step_idx):
        rows, lens = _rows(cache, B)
        logits, cache = model.decode_step(params, last_tokens, rows,
                                          window=window)
        tokens, pstate, _ = dp.step(logits, pstate,
                                    _global_params(sparams, B), step_idx)
        return tokens, _whole_len(cache, rows, lens), pstate

    a_params = _abstract(model, lambda md: md.init(device="meta"))
    a_cache = _abstract(model, lambda md: md.init_cache(
        B, S, window=window, device="meta"))
    a_pstate = pen.init_state(B, cfg.vocab_size, device="meta")
    a_tok = _meta((B,), torch.int32)
    a_sp = _abstract_sampling_params(B)
    a_step = _meta((), torch.int32)

    p_shard = shd.param_shardings(a_params, m, cfg)
    c_shard = shd.cache_shardings(a_cache, m, cfg, batch_axes)
    st_shard = shd.decision_state_shardings(a_pstate, m, batch_axes,
                                            mode=parallelism)
    tok_shard = shd._P(tuple(batch_axes) if batch_axes else None)
    sp_shard = _sampling_params_spec(batch_axes)
    return (serve_step,
            (a_params, a_cache, a_pstate, a_tok, a_sp, a_step),
            (p_shard, c_shard, st_shard, tok_shard, sp_shard, ()),
            (tok_shard, c_shard, st_shard), batch_axes)


def program_for(kind: str):
    return {"train": make_train_step_program,
            "prefill": make_prefill_program,
            "decode": make_serve_step_program}[kind]


def local_inputs(cfg: ModelConfig, inputs, in_specs, mesh=None):
    """A rank's blocks of a program's whole ``inputs`` (real tensors in
    the meta inputs' layout) under its ``in_specs``, run under the
    program's ``dist.use_mesh``: each leaf cut by its spec (the rank at
    ``mesh``'s coordinate), a cache cut further where the rank's program
    holds less (RWKV-6's state: the heads or value columns of its time
    mix). Raises where a
    K/V cache's block could not be told from a whole cache
    (``transformer.kv_slots``). Without a mesh the inputs come back as
    they are."""
    if mesh is None or not dist.get_ctx().active:
        return inputs
    caches = lambda xs: [x for x in xs if isinstance(x, dict) and "len" in x]
    for cache in caches(inputs):
        for name in ("k", "v"):
            if name in cache:
                kv_slots(cache[name].shape[2])
    out = shd.local_tree(list(inputs), list(in_specs), mesh)
    for cache in caches(out):
        if cfg.family == "ssm":
            for dim, n in zip((2, 3, 4), rwkv_state_local(cfg)):
                if cache["ssm"].shape[dim] != n:
                    cache["ssm"] = dist.model_block(cache["ssm"], dim,
                                                    n).contiguous()
    return tuple(out)
