"""Degenerate decision rows: one fixture for the CPU tests
(``tests/test_torch_degenerate.py``: the port against the reference), the
card tests (``tests/test_torch_gpu.py``: each kernel against its plain
version) and ``chip_smoke.py``'s degenerate phase. numpy only, so it runs
where neither JAX nor the card is.

:func:`case` draws ordinary rows from a seed (the draws of
``tests/test_torch_decision.py``'s ``_case``, so ``case(name, 8, 512, s)``
starts from ``_case(s)``'s arrays, with its eight rows of controls tiled
to B rows) and then makes one thing degenerate:

* filters that keep nothing: ``top_p`` 0 or -0.5, ``min_p`` 1.5 or 2;
  ``min_p`` 1 keeps the top entry (and its ties);
* ``temperature`` 1e-30 (scaled by the 1e-6 floor) and NaN, and
  ``repetition_penalty`` 0 with the rows' counts (a seen positive logit
  becomes +inf);
* values: a NaN column in the first, a middle and the last vocabulary
  block (the first, a middle and the last CTA's range of a kernel that
  splits a row), an all-NaN row, an all -inf row, a +inf column;
* rows with fewer finite values than K and rows with more (the rest NaN,
  or the rest -inf), over a spread of counts; their ``min_p`` is at least
  0.02, so no entry of zero mass is kept: whether one is depends on a
  cumulative mass that rounds to 1.0 (ROADMAP Fault 1).
"""
from __future__ import annotations

import numpy as np

CASES = ("top_p_0", "top_p_neg", "min_p_1.5", "min_p_2", "min_p_1",
         "tau_1e-30", "tau_nan", "rep_0", "nan_first", "nan_mid",
         "nan_last", "nan_row", "neginf_row", "posinf_col", "few_finite",
         "few_above_neginf")

# _case's eight rows of controls
_TEMPERATURE = (0.8, 0.0, 1.0, 0.7, 1.2, 0.0, 0.9, 1.0)
_TOP_K = (40, 0, 1, 0, 0, 5, 0, 1)
_TOP_P = (0.95, 1.0, 1.0, 0.9, 1.0, 1.0, 1.0, 0.5)
_MIN_P = (0.0, 0.0, 0.0, 0.0, 0.05, 0.0, 0.0, 0.0)
_ACTIVE = (1, 1, 1, 0, 1, 1, 1, 1)
# finite values a row of few_finite / few_above_neginf (clipped to V)
_FEW = (1, 5, 50, 200, 1000, 3000, 20000, 1 << 30)

NAN_ROW, NEGINF_ROW, POSINF_COL = 2, 4, 9


def nan_column(name: str, V: int) -> int:
    """The NaN column of ``nan_first`` / ``nan_mid`` / ``nan_last``."""
    return {"nan_first": 7, "nan_mid": V // 2 + 1, "nan_last": V - 2}[name]


def _tile(vals, B, dtype):
    return np.resize(np.asarray(vals, dtype), B)


def case(name: str, B: int, V: int, seed: int = 0) -> dict:
    """The fixture's rows ``name`` at (B, V) from ``seed``: logits (B, V)
    f32, counts ``cp``/``co`` (B, V) int32, the seven per-row controls,
    the decision plane's rng tags (``seed``, ``use_seed``, ``nonces``,
    ``positions``), ``active``, the fused draw's uniform column ``u`` (B,)
    f32 and a ``hot`` mask (V,) bool (the first quarter, at most 1024)."""
    if name not in CASES:
        raise ValueError(f"unknown degenerate case {name!r}")
    rs = np.random.default_rng(seed)
    c = dict(
        logits=rs.normal(0, 1.5, (B, V)).astype(np.float32),
        cp=(rs.integers(0, 3, (B, V)) * (rs.random((B, V)) < 0.05)
            ).astype(np.int32),
        co=(rs.integers(0, 3, (B, V)) * (rs.random((B, V)) < 0.05)
            ).astype(np.int32),
        temperature=_tile(_TEMPERATURE, B, np.float32),
        top_k=_tile(_TOP_K, B, np.int32),
        top_p=_tile(_TOP_P, B, np.float32),
        min_p=_tile(_MIN_P, B, np.float32),
        repetition_penalty=rs.uniform(1.0, 1.5, B).astype(np.float32),
        presence_penalty=rs.uniform(0, 0.5, B).astype(np.float32),
        frequency_penalty=rs.uniform(0, 0.3, B).astype(np.float32),
        seed=rs.integers(0, 2 ** 32, B, dtype=np.uint64).astype(np.uint32),
        use_seed=rs.random(B) < 0.5,
        nonces=rs.integers(0, 1000, B).astype(np.uint32),
        positions=rs.integers(0, 64, B).astype(np.int32),
        active=_tile(_ACTIVE, B, bool))
    c["u"] = rs.random(B).astype(np.float32)
    c["hot"] = np.arange(V) < max(1, min(1024, V // 4))
    z = c["logits"]
    if name == "top_p_0":
        c["top_p"][:] = 0.0
    elif name == "top_p_neg":
        c["top_p"][:] = -0.5
    elif name.startswith("min_p_"):
        c["min_p"][:] = float(name[len("min_p_"):])
    elif name == "tau_1e-30":
        c["temperature"][:] = 1e-30
    elif name == "tau_nan":
        c["temperature"][:] = np.nan
    elif name == "rep_0":
        c["repetition_penalty"][:] = 0.0
    elif name.startswith("nan_") and name != "nan_row":
        z[:, nan_column(name, V)] = np.nan
    elif name == "nan_row":
        z[NAN_ROW % B] = np.nan
    elif name == "neginf_row":
        z[NEGINF_ROW % B] = -np.inf
    elif name == "posinf_col":
        z[:, POSINF_COL % V] = np.inf
    else:                                   # few_finite, few_above_neginf
        fill = np.nan if name == "few_finite" else -np.inf
        for b in range(B):
            n = min(_FEW[b % len(_FEW)], V)
            keep = rs.permutation(V)[:n]
            row = np.full(V, fill, np.float32)
            row[keep] = z[b, keep]
            z[b] = row
        c["min_p"][:] = np.maximum(c["min_p"], 0.02)
    return c


# -- on a device: each kernel against its plain version ----------------------

def tensors(c: dict, dev) -> dict:
    """The case's arrays as tensors on ``dev``."""
    import torch
    return {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
            for k, v in c.items()}


def probe_inputs(dev) -> dict:
    """The probe that first showed ``fused_sample``'s out-of-bounds draw
    (ROADMAP Fault 10): B = 3, V = 1000, logits ``torch.randn`` from a
    generator on ``dev`` seeded 0, times 2; no counts, τ = 1, no filter
    but ``min_p`` = 2 on every row, no penalties, u = 0.5, the first 128
    ids hot; k_cap 64."""
    import torch
    B, V = 3, 1000
    gen = torch.Generator(device=dev).manual_seed(0)
    f32 = dict(dtype=torch.float32, device=dev)
    zeros = torch.zeros((B, V), dtype=torch.int32, device=dev)
    return dict(logits=torch.randn((B, V), generator=gen, **f32) * 2,
                cp=zeros, co=zeros.clone(),
                repetition_penalty=torch.ones(B, **f32),
                presence_penalty=torch.zeros(B, **f32),
                frequency_penalty=torch.zeros(B, **f32),
                temperature=torch.ones(B, **f32),
                top_k=torch.zeros(B, dtype=torch.int32, device=dev),
                top_p=torch.ones(B, **f32), min_p=torch.full((B,), 2.0, **f32),
                u=torch.full((B,), 0.5, **f32),
                hot=torch.arange(V, device=dev) < 128)


def _same(a, b):
    """Per row: equal everywhere, a NaN equal to a NaN (-0 equals +0)."""
    eq = a == b
    if a.is_floating_point():
        eq |= a.isnan() & b.isnan()
    return eq.reshape(a.shape[0], -1).all(-1)


def _close(a, b, rtol=1e-5):
    import torch
    return torch.isclose(a, b, rtol=rtol, atol=0.0, equal_nan=True)


PEN = ("logits", "cp", "co", "repetition_penalty", "presence_penalty",
       "frequency_penalty", "temperature")
FUSED = PEN + ("top_k", "top_p", "min_p", "u", "hot")


def kernel_rows(x: dict, k_caps=(256, 2048), block_v: int = 2048,
                gumbel_seed: int = 7) -> dict:
    """Each kernel on ``x`` (tensors on a CUDA device, see :func:`tensors`)
    against its plain version on the same inputs: ``penalty_scale`` bit for
    bit; ``shvs_masses`` on the penalised logits, m and tail_max bit for
    bit, the sums within rtol 1e-5; ``fused_sample`` at each k_cap on the
    path it picks and on the global path, tokens, ``exact`` and ``kept``
    equal and ``alpha`` within rtol 1e-5; ``gumbel_argmax`` on the
    penalised logits, tokens equal. NaN equals NaN throughout.

    Returns {check: [equal?] a row}, and under ``"differ"`` each failing
    check's rows with the kernel's and the plain version's values."""
    import torch
    from repro_torch.kernels import (fused_kernel, gumbel_kernel,
                                     penalty_kernel, ref, shvs_kernel)
    B, V = x["logits"].shape
    out, differ = {}, {}

    def record(check, ok, got, want):
        out[check] = ok.tolist()
        if not ok.all():
            rows = (~ok).nonzero()[:, 0].tolist()
            differ[check] = {"rows": rows, "kernel": [
                [g[r].tolist() for r in rows[:4]] for g in got], "plain": [
                [w[r].tolist() for r in rows[:4]] for w in want]}

    pen = [x[k] for k in PEN]
    zs = ref.penalty_ref(*pen)
    got = penalty_kernel.penalty_scale(*pen)
    torch.cuda.synchronize()
    ok = _same(got, zs)
    record("penalty_scale", ok, [got.amax(-1)], [zs.amax(-1)])

    got = shvs_kernel.shvs_masses(zs, x["hot"])
    want = ref.shvs_mass_ref(zs, x["hot"])
    torch.cuda.synchronize()
    ok = _same(got[0], want[0]) & _same(got[3], want[3]) & \
        _close(got[1], want[1]) & _close(got[2], want[2])
    record("shvs_masses", ok, got, want)

    f = [x[k] for k in FUSED]
    Vp = -(-V // block_v) * block_v
    for k_cap in k_caps:
        K = min(k_cap, Vp)
        want = ref.fused_sample_ref(*f, k_cap=k_cap, block_v=block_v)
        for path in (None, "global"):
            name = fused_kernel.split(B, Vp, K, path)["path"]
            got = fused_kernel.fused_sample(*f, k_cap=k_cap,
                                            block_v=block_v, path=path)
            torch.cuda.synchronize()
            ok = _same(got[0], want[0]) & _same(got[1], want[1]) & \
                _same(got[3], want[3]) & _close(got[2], want[2])
            record(f"fused_sample k_cap={k_cap} "
                   f"{'global (forced)' if path else name}", ok, got, want)

    got = gumbel_kernel.gumbel_argmax(zs, gumbel_seed)
    want = ref.gumbel_argmax_ref(zs, gumbel_seed)
    torch.cuda.synchronize()
    record("gumbel_argmax", _same(got, want), [got], [want])
    out["differ"] = differ
    return out
