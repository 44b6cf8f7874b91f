"""The reference package's distribution outputs, for
``tests/test_torch_distributed.py``: run as its own process (8 forced
host devices), it writes one ``.npz`` of inputs and outputs.

    python tests/torch_dist_jax_ref.py OUT.npz

* S1 and ``vocab_gather`` planes at (2, 4), B = 16, V = 256 (the fixture
  of ``tests/test_distributed.py``), three steps, tokens and histograms;
* ``hierarchical_sample`` at B = 16, V = 500 for four parameter sets, and
  at V = 502 (no multiple of 4: the padded blocks): tokens, accepted,
  alpha, exact_fast and histograms;
* the EP MoE on reduced f32 granite (4 experts, d_ff_expert 512) at
  (2, 4) under ``REPRO_MOE_STRATEGY=gather`` and ``=scatter``, and the
  local path: output and aux, with the weights and input.

    python tests/torch_dist_jax_ref.py OUT.npz programs

writes instead (whole, under its final name only once written) the
reference's serving programs at (2, 4) on reduced f32
smollm-360m (``tests/test_torch_tp.py``): ``make_prefill_program`` (B = 8,
a 16-token prompt) and three ``make_serve_step_program`` steps (S1,
``shvs``; the prefill cache padded to 32 slots), each jitted with its own
shardings, with their tokens and the logits of the same forward
(``Model.prefill`` / ``decode_step`` jitted with the programs' param and
cache shardings), the inputs, and the weights under ``p/...``; and one
step of ``make_train_step_program`` at (2, 4) on reduced f32
smollm-360m, granite-moe-1b-a400m and rwkv6-3b (:func:`train_program`).
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from repro.config import SamplingConfig, SHVSConfig, get_arch  # noqa: E402
from repro.core.decision_plane import DecisionPlane  # noqa: E402
from repro.core.hierarchical import hierarchical_sample  # noqa: E402
from repro.core.sampling import SamplingParams  # noqa: E402
from repro.models import dist  # noqa: E402
from repro.models.moe import apply_moe, init_moe  # noqa: E402

SP_STEPS = 3
# (name, sampling config kwargs, single-device comparator)
HIER_SETS = (("tau1", dict(temperature=1.0), "shvs"),
             ("greedy", dict(temperature=0.0), "shvs"),
             ("topk", dict(temperature=0.9, top_k=20), "truncation_first"),
             ("topp", dict(temperature=0.8, top_p=0.9), "truncation_first"))


def main(path):
    assert len(jax.devices()) == 8
    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "model"))
    out = {}

    # ---- S1 / vocab_gather ----------------------------------------------
    B, V = 16, 256
    z = np.random.default_rng(0).normal(0, 3, (B, V)).astype(np.float32)
    prompts = np.random.default_rng(0).integers(0, V, (B, 4))
    out["sp_z"], out["sp_prompts"] = z, prompts
    params = SamplingParams.broadcast(B, SamplingConfig(
        temperature=0.9, top_k=20, repetition_penalty=1.2))
    for mode in ("single", "sequence_parallel", "vocab_gather"):
        dp = DecisionPlane(V, algorithm="shvs", shvs=SHVSConfig(hot_size=32),
                           sampling_parallelism=(
                               "sequence_parallel" if mode == "single"
                               else mode), k_cap=64, seed=7)
        st = dp.init_state(B, prompt_tokens=jnp.asarray(prompts))
        toks = []
        for s in range(SP_STEPS):
            if mode == "single":
                t, st, _ = jax.jit(dp.step)(jnp.asarray(z), st, params,
                                            jnp.asarray(s))
            else:
                with dist.use_mesh(mesh):
                    zz = jax.device_put(z, NamedSharding(mesh,
                                                         P("data", "model")))
                    t, st, _ = jax.jit(dp.step)(zz, st, params,
                                                jnp.asarray(s))
            toks.append(np.asarray(t))
        out[f"sp_{mode}_tokens"] = np.stack(toks)
        out[f"sp_{mode}_counts"] = np.asarray(st.output_counts)

    # ---- hierarchical --------------------------------------------------------
    B2 = 16
    cases = [(name, kw, cmp, 500) for name, kw, cmp in HIER_SETS] + \
        [("pad", dict(temperature=1.0), "shvs", 502)]
    for name, kw, cmp, V2 in cases:
        z2 = np.random.default_rng(3).normal(0, 3, (B2, V2)).astype(np.float32)
        prompts2 = np.random.default_rng(4).integers(0, V2, (B2, 4))
        params2 = SamplingParams.broadcast(B2, SamplingConfig(
            repetition_penalty=1.2, **kw))
        dp_h = DecisionPlane(V2, algorithm="shvs",
                             shvs=SHVSConfig(hot_size=64),
                             sampling_parallelism="hierarchical", k_cap=64,
                             seed=7)
        st = dp_h.init_state(B2, prompt_tokens=jnp.asarray(prompts2))
        u = dp_h.uniforms(0, B2)
        with dist.use_mesh(mesh):
            # the head's layout: V split where 4 divides it, whole rows else
            spec = P("data", "model" if V2 % 4 == 0 else None)
            zz = jax.device_put(z2, NamedSharding(mesh, spec))
            toks, st2, res = jax.jit(
                lambda z_, s_, p_, u_: hierarchical_sample(
                    z_, s_, p_, u_, dp_h.hot_set, k_cap=64))(
                zz, st, params2.strip_rng(), u)
        dp_ref = DecisionPlane(V2, algorithm=cmp, shvs=SHVSConfig(hot_size=64),
                               k_cap=64, seed=7)
        t_ref, _, _ = jax.jit(dp_ref.step)(
            jnp.asarray(z2), dp_ref.init_state(
                B2, prompt_tokens=jnp.asarray(prompts2)),
            params2, jnp.asarray(0))
        pre = f"h_{name}_"
        out[pre + "z"], out[pre + "prompts"] = z2, prompts2
        out[pre + "hot"] = np.asarray(dp_h.hot_set.indices)
        out[pre + "tokens"] = np.asarray(toks)
        out[pre + "accepted"] = np.asarray(res.accepted)
        out[pre + "alpha"] = np.asarray(res.alpha)
        out[pre + "exact_fast"] = np.asarray(res.exact_fast)
        out[pre + "counts"] = np.asarray(st2.output_counts)
        out[pre + "single_tokens"] = np.asarray(t_ref)

    # ---- EP MoE --------------------------------------------------------------
    cfg = get_arch("granite-moe-1b-a400m").reduced()
    cfg = dataclasses.replace(cfg, dtype="float32")
    key = jax.random.PRNGKey(0)
    p = init_moe(key, cfg)
    x = 0.5 * jax.random.normal(jax.random.fold_in(key, 1),
                                (4, 8, cfg.d_model))
    for k, v in p.items():
        out[f"moe_p_{k}"] = np.asarray(v)
    out["moe_x"] = np.asarray(x)
    y, aux = apply_moe(p, x, cfg, train=True)
    out["moe_local_y"], out["moe_local_aux"] = np.asarray(y), np.asarray(aux)
    for strategy in ("gather", "scatter"):
        os.environ["REPRO_MOE_STRATEGY"] = strategy
        with dist.use_mesh(mesh):
            xx = jax.device_put(x, NamedSharding(mesh, P("data", None, None)))
            y, aux = jax.jit(lambda p_, x_: apply_moe(p_, x_, cfg,
                                                      train=True))(p, xx)
        out[f"moe_{strategy}_y"] = np.asarray(y)
        out[f"moe_{strategy}_aux"] = np.asarray(aux)
    os.environ.pop("REPRO_MOE_STRATEGY")
    np.savez(path, **out)


PROG_B, PROG_S, PROG_SC, PROG_STEPS = 8, 16, 32, 3
# rows alternate greedy and sampled (τ 0.8, top-k 20, repetition 1.2)
PROG_SP = dict(temperature=[0.0, 0.8] * 4, top_k=[0, 20] * 4,
               top_p=[1.0] * 8, min_p=[0.0] * 8,
               repetition_penalty=[1.0, 1.2] * 4, presence_penalty=[0.0] * 8,
               frequency_penalty=[0.0] * 8)


def programs(path):
    """The reference's prefill and serve-step programs at (2, 4)."""
    from repro.config import ShapeConfig
    from repro.core import penalties as pen
    from repro.launch import steps
    from repro.models.model import Model

    assert len(jax.devices()) == 8
    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "model"))
    cfg = get_arch("smollm-360m").reduced()
    model = Model(cfg)
    B, S, Sc = PROG_B, PROG_S, PROG_SC
    params = model.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(21).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    sp = SamplingParams(**{k: jnp.asarray(v, jnp.int32 if k == "top_k"
                                          else jnp.float32)
                           for k, v in PROG_SP.items()})
    out = {"tokens": tokens}
    for k, v in PROG_SP.items():
        out[f"sp_{k}"] = np.asarray(v)
    flat = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            flat["p/" + prefix] = np.asarray(t)
    walk(params, "")
    out.update(flat)

    pre = steps.make_prefill_program(
        cfg, ShapeConfig("p", S, B, "prefill"), mesh)
    dec = steps.make_serve_step_program(
        cfg, ShapeConfig("d", Sc, B, "decode"), mesh)
    with dist.use_mesh(mesh, batch_axes=pre[4], model_axes=("model",)):
        fn, a_in, ins, outs, _ = pre
        p_sh, b_sh, c_sh, _ = ins
        cache0 = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype),
                                        a_in[2])
        batch = {"tokens": jnp.asarray(tokens)}
        logits = jax.jit(lambda p, b, c: model.prefill(p, b, c)[0],
                         in_shardings=(p_sh, b_sh, c_sh))(
            params, batch, cache0)
        tok, cache = jax.jit(fn, in_shardings=ins, out_shardings=outs)(
            params, batch, cache0, sp)
    toks, lgs = [np.asarray(tok)], [np.asarray(logits)]
    # the prefill cache padded to the serve step's slots, in numpy
    cache = {k: np.asarray(v) for k, v in cache.items()}
    for k in ("k", "v"):
        pad = np.zeros(cache[k].shape[:2] + (Sc - S,) + cache[k].shape[3:],
                       cache[k].dtype)
        cache[k] = np.concatenate([cache[k], pad], axis=2)
    state = pen.update_histograms(
        pen.init_state(B, cfg.vocab_size, jnp.asarray(tokens)), tok)
    state = type(state)(*(np.asarray(x) for x in state))
    with dist.use_mesh(mesh, batch_axes=dec[4], model_axes=("model",)):
        fn, a_in, ins, outs, _ = dec
        p_sh, c_sh = ins[0], ins[1]
        step = jax.jit(fn, in_shardings=ins, out_shardings=outs)
        logit_fn = jax.jit(lambda p, t, c: model.decode_step(p, t, c)[0],
                           in_shardings=(p_sh, ins[3], c_sh))
        for i in range(PROG_STEPS):
            lgs.append(np.asarray(logit_fn(params, tok, cache)))
            tok, cache, state = step(params, cache, state, tok, sp,
                                     jnp.asarray(i + 1, jnp.int32))
            toks.append(np.asarray(tok))
    out["ref_tokens"] = np.stack(toks)
    out["ref_logits"] = np.stack(lgs)
    for arch in TRAIN_PROG_ARCHS:
        out.update(train_program(arch, mesh))
    # written whole, then renamed: the workers that run beside this
    # process wait for the file to appear
    with open(path + ".part", "wb") as f:
        np.savez(f, **out)
    os.replace(path + ".part", path)


#: the train program's families at (2, 4): dense, MoE (the EP experts) and
#: RWKV-6; B = 8 rows of 16 tokens
TRAIN_PROG_ARCHS = ("smollm-360m", "granite-moe-1b-a400m", "rwkv6-3b")
TRAIN_PROG_B, TRAIN_PROG_S = 8, 16


def _flat(tree, prefix):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
    else:
        out[prefix] = np.asarray(tree)
    return out


def train_program(arch, mesh):
    """The reference's ``make_train_step_program`` jitted with its own
    shardings at (2, 4) on reduced f32 ``arch``: one AdamW step from the
    reference's init at ``PRNGKey(0)``. Writes under ``train/<arch>/``
    the tokens and labels, the parameters before (``p/...``) and after
    (``q/...``), and the loss and grad norm."""
    from repro.config import ShapeConfig
    from repro.launch import steps
    from repro.models.model import Model
    from repro.training.optimizer import adamw_init

    cfg = get_arch(arch).reduced()
    B, S = TRAIN_PROG_B, TRAIN_PROG_S
    fn, _, ins, outs, baxes = steps.make_train_step_program(
        cfg, ShapeConfig("t", S, B, "train"), mesh)
    params = Model(cfg).init(jax.random.PRNGKey(0))
    rs = np.random.default_rng(31)
    batch = {k: rs.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    with dist.use_mesh(mesh, batch_axes=baxes, model_axes=("model",)):
        q, _, met = jax.jit(fn, in_shardings=ins, out_shardings=outs)(
            params, adamw_init(params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    pre = f"train/{arch}/"
    out = {pre + k: v for k, v in batch.items()}
    out.update({pre + "p" + k: v for k, v in _flat(params, "").items()})
    out.update({pre + "q" + k: v for k, v in _flat(q, "").items()})
    for k in ("loss", "grad_norm", "lr"):
        out[pre + k] = np.asarray(met[k])
    return out


if __name__ == "__main__":
    if sys.argv[2:] == ["programs"]:
        programs(sys.argv[1])
    else:
        main(sys.argv[1])
