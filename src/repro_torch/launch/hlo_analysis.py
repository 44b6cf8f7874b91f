"""Roofline terms of a program: the analytic traffic and FLOP models, the
roofline's three terms and the collective statistics they read.

The reference's ``launch/hlo_analysis.py`` reads the rest from the HLO
text of a compiled XLA program (``_shape_bytes``, ``parse_collectives``,
``analyze_compiled``), which a torch program has none of: here
:func:`analyze_program`, the twin of ``analyze_compiled``, reads a trace
of one rank's program on fake tensors (``launch/hlo_parse.py``), and
:class:`CollectiveStats` is filled from what the collectives of
``models/dist.py`` counted (:func:`collective_stats_from`). No port code
reads HLO text, so ``_shape_bytes`` and ``parse_collectives`` have no
twin.

Byte conventions of the collective term, as in the reference (bytes a
device receives):

  all-gather          : output bytes − input bytes
  all-reduce          : 2 × operand bytes            (ring RS+AG)
  reduce-scatter      : input bytes − output bytes
  all-to-all          : operand bytes

Hardware model: one NVIDIA H100 SXM5, from the NVIDIA H100 Tensor Core GPU
datasheet, SXM5 column — 989 TFLOP/s dense bf16 on the tensor cores (no
sparsity), 3.35 TB/s of HBM3, and NVLink at 900 GB/s, which the datasheet
counts in both directions together: 450 GB/s a direction, the rate at which
one card receives (the direction the collective term counts).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.models.dist import received_bytes

# H100 SXM5 constants (per card)
PEAK_FLOPS = 989e12          # bf16, dense
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s received by one card (900e9 both ways)


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


#: the ``models/dist.py`` wrapper -> the HLO collective the reference names
_KIND = {"all_gather": "all-gather", "psum": "all-reduce",
         "pmax": "all-reduce", "psum_scatter": "reduce-scatter",
         "all_to_all": "all-to-all"}


def collective_stats_from(stats: Dict[str, dict],
                          group_size: Dict[str, int]) -> CollectiveStats:
    """A :class:`CollectiveStats` from ``dist.collective_stats()``: each
    wrapper's calls and the rank's input bytes, turned into the bytes a
    device receives under the conventions above. ``group_size`` gives, per
    wrapper, the size n of the group it ran over (an all-gather of an
    input of b bytes receives (n − 1)·b; a reduce-scatter of b bytes
    receives b − b/n)."""
    out = CollectiveStats()
    for name, st in stats.items():
        kind = _KIND[name]
        moved = received_bytes(name, int(st["bytes"]),
                               group_size.get(name, 1))
        out.bytes_by_kind[kind] = out.bytes_by_kind.get(kind, 0) + moved
        out.count_by_kind[kind] = (out.count_by_kind.get(kind, 0)
                                   + int(st["calls"]))
    return out


@dataclass
class Roofline:
    """Per-(arch × shape × mesh) roofline terms, all in seconds."""

    name: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float
    bytes_per_device: Optional[float] = None
    collectives: Optional[CollectiveStats] = None

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.chips * NVLINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    def row(self) -> dict:
        return {
            "raw_cost_flops": getattr(self, "raw_cost_flops", None),
            "raw_cost_bytes": getattr(self, "raw_cost_bytes", None),
            "parsed_traffic_upper": getattr(self, "parsed_traffic_upper", None),
            "parsed_dot_flops": getattr(self, "parsed_dot_flops", None),
            "name": self.name, "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bottleneck": self.bottleneck,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_flops_ratio,
            "bytes_per_device": self.bytes_per_device,
        }


def analytic_memory_bytes(cfg, shape) -> float:
    """Global HBM traffic model for one program invocation.

    decode : active weights read once + KV cache (or SSM state) read +
             one-slot write + logits write
    prefill: weights + activations (~12 d-vectors/layer/token) + cache write
    train  : weights fwd+bwd + grads + AdamW moments (f32) + activations
             with remat (~1.5× fwd recompute) + logits fwd/bwd
    """
    n_active = cfg.active_param_count()
    n_total = cfg.param_count()
    B, S = shape.global_batch, shape.seq_len
    d, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    bt = 2.0  # bf16
    if shape.kind == "decode":
        w = n_active * bt
        if cfg.attention_free or cfg.family == "hybrid":
            hs = cfg.ssm.rwkv_head_size if cfg.ssm.kind == "rwkv6" else 0
            if cfg.ssm.kind == "rwkv6":
                state = L * B * (d // hs) * hs * hs * 4
            else:
                inner = cfg.ssm.expand * d
                state = L * B * (inner // cfg.resolved_head_dim) * \
                    cfg.resolved_head_dim * cfg.ssm.state_size * 4
            cache = 2 * state          # read + write
            if cfg.family == "hybrid":
                Sc = min(S, cfg.sliding_window or 4096)
                G = -(-L // cfg.hybrid.attn_every)
                cache += G * B * Sc * cfg.num_kv_heads * \
                    cfg.resolved_head_dim * bt * 2
        else:
            Sc = min(S, cfg.sliding_window) if cfg.sliding_window else S
            cache = L * B * Sc * cfg.num_kv_heads * cfg.resolved_head_dim * \
                bt * 2
        logits = B * V * 4
        act = L * B * d * bt * 12
        return w + cache + logits + act
    if shape.kind == "prefill":
        w = n_active * bt
        act = L * B * S * d * bt * 12
        Sc = min(S, cfg.sliding_window) if cfg.sliding_window else S
        cache_w = L * B * Sc * cfg.num_kv_heads * cfg.resolved_head_dim * \
            bt * 2
        logits = B * V * 4  # last position only
        return w + act + cache_w + logits
    # train
    w_traffic = n_total * (bt * 2      # fwd + bwd weight reads
                           + 4        # grad write (bf16 rw ~4)
                           + 16 + 4)  # AdamW moments rw (f32) + param update
    act = L * B * S * d * bt * 12 * 1.5   # remat recompute factor
    logits = B * S * V * 4 * 2
    return w_traffic + act + logits


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params.

    D = processed tokens for this program: B·S for train/prefill, B for one
    decode step.
    """
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch   # one decode token per seq


def analyze_program(name: str, fn, args, chips: int, cfg, shape) -> Roofline:
    """Roofline terms of one rank's program ``fn(*args)``, traced on fake
    tensors (call it under ``FakeTensorMode`` and the program's mesh),
    combined as the reference's ``analyze_compiled`` combines the compiled
    program's:

    * FLOPs: ``max(dot FLOPs · chips, model_flops_estimate)`` — the
      trace's dot FLOPs are the rank's, so times the chips the global;
    * bytes: :func:`analytic_memory_bytes`, with the trace's fusion-blind
      traffic · chips kept as its upper bound;
    * bytes per device: the rank's arguments + outputs + the trace's peak
      above its arguments (the compiled memory analysis's argument, output
      and temp sizes).

    ``raw_cost_flops`` and ``raw_cost_bytes``, which the reference takes
    from XLA's loop-blind cost analysis, are the trace's own counts for
    one rank here (its dot FLOPs and traffic bytes): a trace runs every
    loop, so nothing is left uncounted. Returns the :class:`Roofline`;
    its ``trace`` attribute holds the ``hlo_parse.ProgramStats``."""
    from repro_torch.launch.hlo_parse import ProgramStats
    trace = ProgramStats(fn, *args)
    parsed = trace.totals()
    stats = CollectiveStats(
        bytes_by_kind={k: int(v * chips) for k, v in
                       parsed["collective_bytes_by_kind"].items()},
        count_by_kind={k: int(v) for k, v in
                       parsed["collective_counts"].items()})
    mflops = model_flops_estimate(cfg, shape)
    flops = max(parsed["dot_flops"] * chips, mflops)
    temp = max(trace.peak_bytes - trace.argument_bytes, 0.0)
    roof = Roofline(name=name, chips=chips, hlo_flops=flops,
                    hlo_bytes=analytic_memory_bytes(cfg, shape),
                    collective_bytes=float(stats.total_bytes),
                    model_flops=mflops,
                    bytes_per_device=trace.argument_bytes +
                    trace.output_bytes + temp,
                    collectives=stats)
    roof.raw_cost_flops = parsed["dot_flops"]
    roof.raw_cost_bytes = parsed["traffic_bytes"]
    roof.parsed_traffic_upper = parsed["traffic_bytes"] * chips
    roof.parsed_dot_flops = parsed["dot_flops"] * chips
    roof.memory_analysis = {"argument_size_in_bytes": trace.argument_bytes,
                            "output_size_in_bytes": trace.output_bytes,
                            "temp_size_in_bytes": temp}
    roof.trace = trace
    return roof
