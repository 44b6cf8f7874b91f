"""Dispatch between the CUDA kernels and their plain versions.

A tensor on the CPU gets the plain version (``kernels/ref.py``); any other
tensor gets the kernel, which raises unless it is a CUDA tensor it can
launch on. There is no fallback: nothing on a card runs a plain version in
place of a kernel.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import (_build, fused_kernel, gumbel_kernel,
                                 penalty_kernel, ref, shvs_kernel)

KERNELS = (penalty_kernel, shvs_kernel, fused_kernel, gumbel_kernel)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel name since the last reset."""
    return {k.NAME: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    with _build.COUNT_LOCK:
        for k in KERNELS:
            k.launches = 0


def fused_penalty_scale(logits, counts_p, counts_o, repetition, presence,
                        frequency, temperature):
    """Eq. 1 penalties + temperature on (B, V) f32 logits."""
    if logits.device.type == "cpu":
        return ref.penalty_ref(logits, counts_p, counts_o, repetition,
                               presence, frequency, temperature)
    return penalty_kernel.penalty_scale(logits, counts_p, counts_o,
                                        repetition, presence, frequency,
                                        temperature)


def fused_shvs_masses(z, hot_mask):
    """The SHVS streaming pass: (m, s_hot, s_tail, tail_max)."""
    if z.device.type == "cpu":
        return ref.shvs_mass_ref(z, hot_mask)
    return shvs_kernel.shvs_masses(z, hot_mask)


def fused_sample(logits, counts_p, counts_o, params, u_row, hot_mask, *,
                 k_cap: int, block_v: int = 2048):
    """The fused single-pass sampling decision. ``params`` is the 7-field
    ``SamplingParams`` core struct; ``u_row`` the (B,) uniform column that
    drives the draw. Returns (tokens int32, exact bool, alpha, kept)."""
    args = (logits, counts_p, counts_o, params.repetition_penalty,
            params.presence_penalty, params.frequency_penalty,
            params.temperature, params.top_k, params.top_p, params.min_p,
            u_row, hot_mask)
    if logits.device.type == "cpu":
        return ref.fused_sample_ref(*args, k_cap=k_cap, block_v=block_v)
    return fused_kernel.fused_sample(*args, k_cap=k_cap, block_v=block_v)


def fused_gumbel_argmax(z, seed: int, row0: int = 0):
    """Single-pass Gumbel-max draw ``argmax_v(z + G(hash(seed, b, v)))`` on
    (B, V) f32 logits, b = ``row0`` + the operand's row; ``seed`` is the
    uint32 bits of the reference's int32 seed. Returns tokens (B,) int32."""
    if z.device.type == "cpu":
        return ref.gumbel_argmax_ref(z, seed, row0)
    return gumbel_kernel.gumbel_argmax(z, seed, row0)
