"""Central configuration system for the repro framework.

Everything the launcher, engine, trainer, and dry-run need is described by
plain dataclasses here. Architecture configs live in ``repro_torch.configs.<id>``
and register themselves into :data:`ARCH_REGISTRY` via :func:`register_arch`.

Design notes
------------
* Configs are frozen dataclasses -> hashable, usable as jit static args.
* ``ModelConfig.reduced()`` produces the CPU smoke-test variant of the same
  family (<=2 layers, d_model<=512, <=4 experts) required by the assignment.
* ``ShapeConfig`` describes the four assigned input shapes; ``kind`` selects
  whether the dry-run lowers ``train_step`` or ``serve_step``.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts feed-forward configuration."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    # Llama-4 style always-on shared expert (0 disables).
    shared_expert_d_ff: int = 0
    # Router auxiliary load-balance loss weight (train only).
    aux_loss_weight: float = 0.01
    router_jitter: float = 0.0
    # Capacity factor used to bound per-expert token count in dispatch.
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    """State-space / linear-recurrence configuration (RWKV6, Mamba2)."""

    kind: str  # "rwkv6" | "mamba2"
    state_size: int = 64           # mamba2 SSD state dim per head
    conv_size: int = 4             # mamba2 depthwise conv width
    expand: int = 2                # mamba2 inner expansion factor
    rwkv_head_size: int = 64       # rwkv6 per-head dim
    decay_lora_rank: int = 64      # rwkv6 data-dependent decay LoRA rank


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid wiring: mamba blocks with a periodically applied
    shared attention block."""

    attn_every: int = 6            # apply the shared attention block every N
    shared_attn: bool = True       # single weight-tied attention block


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder (the conv/mel frontend itself is stubbed; the
    encoder transformer is real)."""

    num_layers: int = 6
    num_frames: int = 1500         # post-conv frame count fed to the encoder


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend stub description (assignment carve-out: frontends
    provide precomputed embeddings of the right shape)."""

    kind: str                      # "vision" | "audio"
    num_embeddings: int            # patches per image / frames per clip
    embed_dim: int                 # dimension of the provided embeddings


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rmsnorm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"              # silu (SwiGLU) | gelu (plain MLP)
    # Sliding-window attention (0 = full causal). The long_500k shape
    # overrides this for full-attention archs (see ShapeConfig.window_override).
    sliding_window: int = 0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[FrontendConfig] = None
    source: str = ""               # citation: paper / model card
    dtype: str = "bfloat16"

    # -- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v, l, f = self.d_model, self.vocab_size, self.num_layers, self.d_ff
        hd = self.resolved_head_dim
        n = v * d  # embeddings
        if not self.tie_embeddings:
            n += v * d  # lm head
        per_layer = 0
        if self.family == "ssm" and self.ssm and self.ssm.kind == "rwkv6":
            # r,k,v,g,o projections + decay lora + channel-mix
            per_layer = 5 * d * d + 2 * d * self.ssm.decay_lora_rank
            per_layer += 2 * d * f  # channel mix (k,v)
            per_layer += d * f      # receptance of channel mix approx
        else:
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            attn = q + kv + o
            if self.moe is not None:
                ff = self.moe.num_experts * 3 * d * self.moe.d_ff_expert
                ff += d * self.moe.num_experts  # router
                if self.moe.shared_expert_d_ff:
                    ff += 3 * d * self.moe.shared_expert_d_ff
            else:
                ff = (3 if self.act == "silu" else 2) * d * f
            if self.family == "hybrid" and self.ssm is not None:
                # mamba2 block approx: in_proj (2*expand*d + heads*state terms)
                inner = self.ssm.expand * d
                mamba = d * (2 * inner) + inner * d + inner * self.ssm.conv_size
                per_layer = mamba + ff
                # one shared attn block amortized
                per_layer += attn // max(1, (self.hybrid.attn_every if self.hybrid else 6))
            else:
                per_layer = attn + ff
        n += l * per_layer
        n += l * 2 * d  # norms
        if self.encoder is not None:
            enc_attn = 4 * d * d
            enc_ff = 2 * d * f
            n += self.encoder.num_layers * (enc_attn + enc_ff + 2 * d)
            n += l * (4 * d * d)  # decoder cross-attention
        return n

    def active_param_count(self) -> int:
        """Active (per-token) parameters — differs from total for MoE."""
        if self.moe is None:
            return self.param_count()
        d, l = self.d_model, self.num_layers
        total = self.param_count()
        all_experts = l * self.moe.num_experts * 3 * d * self.moe.d_ff_expert
        active = l * self.moe.top_k * 3 * d * self.moe.d_ff_expert
        return total - all_experts + active

    # -- reduced smoke variant ----------------------------------------------
    def reduced(self) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests.

        Per assignment: <=2 layers, d_model<=512, <=4 experts. Keeps family
        wiring (GQA ratio, qk_norm, MoE/SSM/hybrid structure) intact.
        """
        d_model = min(self.d_model, 256)
        heads = max(2, min(self.num_heads, 4))
        ratio = max(1, self.num_heads // max(1, self.num_kv_heads))
        kv = max(1, heads // min(ratio, heads))
        hd = d_model // heads
        moe = None
        if self.moe is not None:
            ne = min(self.moe.num_experts, 4)
            moe = replace(
                self.moe,
                num_experts=ne,
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 512),
                shared_expert_d_ff=min(self.moe.shared_expert_d_ff, 256),
                # capacity == tokens*k: no token dropping in smoke tests, so
                # prefill/decode consistency is exact
                capacity_factor=float(ne),
            )
        ssm = None
        if self.ssm is not None:
            ssm = replace(
                self.ssm,
                state_size=min(self.ssm.state_size, 16),
                rwkv_head_size=min(self.ssm.rwkv_head_size, hd),
                decay_lora_rank=min(self.ssm.decay_lora_rank, 8),
            )
        enc = None
        if self.encoder is not None:
            enc = replace(self.encoder, num_layers=2, num_frames=16)
        fe = None
        if self.frontend is not None:
            fe = replace(self.frontend, num_embeddings=8, embed_dim=d_model)
        hyb = None
        if self.hybrid is not None:
            hyb = replace(self.hybrid, attn_every=2)
        return replace(
            self,
            name=self.name + "-smoke",
            num_layers=2,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            moe=moe,
            ssm=ssm,
            hybrid=hyb,
            encoder=enc,
            frontend=fe,
            dtype="float32",
        )


LAYER_KINDS = ("mamba", "attention")


@dataclass(frozen=True)
class HybridMoEConfig(ModelConfig):
    """A typed stack of Mamba2 and attention layers, each followed by a
    MoE (family ``"hybrid_moe"``: Granite 4.0-H, HF ``granitemoehybrid``).

    ``layer_types[i]`` is layer i's mixer, ``"mamba"`` or ``"attention"``;
    every layer then runs ``moe`` (its shared expert included). The
    Mamba2 mixer is the published one (``ssm.mamba_xbc_seq``: one group
    of B and C, a causal conv with a bias over x, B and C together) with
    heads of ``mamba_head_dim``, not attention's. Granite's multipliers
    scale the embedding, attention's softmax (``attention_multiplier`` in
    place of 1/sqrt(head_dim)), each residual branch, and divide the
    logits.

    Every field here defaults to the identity. The class is registered
    in no arch registry: a benchmark configuration builds it."""

    layer_types: Tuple[str, ...] = ()
    mamba_head_dim: int = 0        # 0 -> attention's head size
    embedding_multiplier: float = 1.0
    attention_multiplier: float = 0.0   # 0 -> 1/sqrt(head_dim)
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0

    def __post_init__(self):
        if len(self.layer_types) != self.num_layers or \
                set(self.layer_types) - set(LAYER_KINDS):
            raise ValueError(f"{self.name}: layer_types must name "
                             f"{self.num_layers} layers of {LAYER_KINDS}")
        if self.ssm is None or self.moe is None:
            raise ValueError(f"{self.name}: a hybrid MoE needs ssm and moe")
        if (self.ssm.expand * self.d_model) % self._mamba_hd:
            raise ValueError(f"{self.name}: Mamba2 heads of "
                             f"{self._mamba_hd} do not tile the inner width")

    @property
    def _mamba_hd(self) -> int:
        return self.mamba_head_dim or self.resolved_head_dim

    @property
    def mamba_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.layer_types)
                     if t == "mamba")

    @property
    def attention_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.layer_types)
                     if t == "attention")

    @property
    def softmax_scale(self) -> float:
        return self.attention_multiplier or \
            1.0 / self.resolved_head_dim ** 0.5

    def param_count(self) -> int:
        d, V, E = self.d_model, self.vocab_size, self.moe.num_experts
        hd, N, K = self.resolved_head_dim, self.ssm.state_size, \
            self.ssm.conv_size
        inner = self.ssm.expand * d
        H, conv_ch = inner // self._mamba_hd, inner + 2 * N
        mamba = (d * (2 * inner + 2 * N + H) + (K + 1) * conv_ch + 3 * H
                 + inner + inner * d)
        attn = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                + self.num_heads * hd * d)
        moe = (E * 3 * d * self.moe.d_ff_expert + d * E
               + 3 * d * self.moe.shared_expert_d_ff)
        n = V * d * (1 if self.tie_embeddings else 2) + d
        n += len(self.mamba_layers) * mamba + \
            len(self.attention_layers) * attn
        return n + self.num_layers * (moe + 2 * d)

    def active_param_count(self) -> int:
        idle = self.moe.num_experts - self.moe.top_k
        return self.param_count() - \
            self.num_layers * idle * 3 * self.d_model * self.moe.d_ff_expert

    def reduced(self) -> "HybridMoEConfig":
        """The base reduction (two layers, d <= 256, 4 experts of top 2,
        the shared expert kept) of a stack that keeps a layer of each
        kind it has, with Mamba2 heads of at most 32."""
        kinds = tuple(k for k in LAYER_KINDS if k in self.layer_types)
        small = ModelConfig.reduced(replace(
            self, layer_types=(kinds * 2)[:2], num_layers=2,
            mamba_head_dim=0))
        return replace(small, mamba_head_dim=min(
            self.mamba_head_dim or small.resolved_head_dim, 32))


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"
    # window applied to full-attention archs for sub-quadratic long decode
    window_override: int = 0

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode",
                             window_override=8_192),
}


# ---------------------------------------------------------------------------
# Parallelism / sampling configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParallelConfig:
    data: int = 1
    model: int = 1
    pod: int = 1
    # Decision-plane parallelism mode (the paper's S1 vs the baseline):
    #   "sequence_parallel" — shard sampling along batch across ALL axes
    #   "vocab_gather"      — all-gather logits over model axis (baseline)
    sampling_parallelism: str = "sequence_parallel"

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.pod


@dataclass(frozen=True)
class SamplingConfig:
    """Per-request sampling contract (service API v1, DESIGN.md §11).

    The full production control set (§6 of paper) plus the per-request
    service fields:

    * ``seed`` — when set, the request's uniform stream is drawn from
      ``PRNGKey(seed)`` keyed on output position only: the token stream is
      a pure function of (seed, prompt, params), invariant to batch
      composition, admission order, engine seed, overlap mode, and KV
      layout. ``None`` (default) keeps the engine-keyed (request-id)
      stream.
    * ``greedy`` — argmax decoding regardless of ``temperature`` (exactly
      equivalent to ``temperature=0``; every backend's τ=0 path).
    * ``logit_bias`` — ``((token_id, bias), ...)`` added to the logits
      before penalties and filtering (a dict also works and is normalized
      to a sorted tuple so the config stays hashable).
    * ``stop_sequences`` — token-level stop sequences ``((id, ...), ...)``;
      a request finishes with ``finish_reason == "stop"`` as soon as its
      committed output ends with any of them (matching is over output
      tokens only, never across the prompt boundary; the matched tokens
      stay in ``Request.output``).
    """

    temperature: float = 1.0
    top_k: int = 0                 # 0 disables
    top_p: float = 1.0             # 1.0 disables
    min_p: float = 0.0             # 0 disables
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    seed: Optional[int] = None     # per-request RNG stream; None = engine's
    greedy: bool = False           # argmax regardless of temperature
    logit_bias: Tuple[Tuple[int, float], ...] = ()
    stop_sequences: Tuple[Tuple[int, ...], ...] = ()

    def __post_init__(self):
        # normalize the container fields to sorted hashable tuples (a frozen
        # dataclass must stay usable as a jit static arg / dict key, and two
        # configs denoting the same bias must compare/hash equal regardless
        # of pair order or dict-vs-tuple spelling)
        bias = self.logit_bias
        if isinstance(bias, dict):
            bias = bias.items()
        object.__setattr__(self, "logit_bias",
                           tuple(sorted((int(t), float(b)) for t, b in bias)))
        object.__setattr__(self, "stop_sequences",
                           tuple(tuple(int(t) for t in s)
                                 for s in self.stop_sequences if len(s)))

    @property
    def effective_temperature(self) -> float:
        """The temperature actually dispatched: ``greedy`` pins τ=0 (every
        backend's argmax path) regardless of ``temperature``."""
        return 0.0 if self.greedy else self.temperature

    @property
    def seeded(self) -> bool:
        return self.seed is not None

    @property
    def seed_u32(self) -> int:
        """The per-request seed as the uint32 actually folded into the RNG
        (0 when unseeded). Single source of truth for the normalization —
        the engine's SlotParams rows and SamplingParams.broadcast must stay
        bit-identical or the seeded-stream contract silently splits."""
        return (self.seed or 0) & 0xFFFFFFFF

    @property
    def needs_penalties(self) -> bool:
        return (self.repetition_penalty != 1.0 or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0)

    @property
    def needs_filter(self) -> bool:
        return self.top_k > 0 or self.top_p < 1.0 or self.min_p > 0.0


@dataclass(frozen=True)
class SHVSConfig:
    """Speculative hot-vocab sampling configuration (§5.3/§5.4)."""

    enabled: bool = True
    hot_size: int = 0              # 0 -> use sizing model / default heuristic
    # guard: fast path must provably contain the filter support
    containment_guard: bool = True

    def resolve_hot_size(self, vocab_size: int) -> int:
        if self.hot_size:
            return min(self.hot_size, vocab_size)
        # paper: top 32k often covers >95%; cap at V/4 for small vocabs
        # (and never exceed the vocabulary itself)
        return min(vocab_size, 32_768, max(1024, vocab_size // 4))


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    z_loss_weight: float = 1e-4
    remat: bool = True             # activation checkpointing per layer


@dataclass(frozen=True)
class RunConfig:
    """Top-level bundle handed to launchers."""

    model: ModelConfig
    shape: ShapeConfig
    parallel: ParallelConfig = ParallelConfig()
    sampling: SamplingConfig = SamplingConfig()
    shvs: SHVSConfig = SHVSConfig()
    train: TrainConfig = TrainConfig()


# ---------------------------------------------------------------------------
# Architecture registry
# ---------------------------------------------------------------------------

ARCH_REGISTRY: dict[str, ModelConfig] = {}

ARCH_IDS = (
    "llama4-maverick-400b-a17b",
    "rwkv6-3b",
    "qwen3-8b",
    "internvl2-2b",
    "starcoder2-7b",
    "zamba2-1.2b",
    "granite-moe-1b-a400m",
    "whisper-base",
    "tinyllama-1.1b",
    "smollm-360m",
)


def register_arch(cfg: ModelConfig) -> ModelConfig:
    ARCH_REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ModelConfig:
    """Look up an architecture config, importing its module on demand."""
    if name not in ARCH_REGISTRY:
        mod = name.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    if name not in ARCH_REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; known: {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[name]


def all_archs() -> dict[str, ModelConfig]:
    for a in ARCH_IDS:
        get_arch(a)
    return dict(ARCH_REGISTRY)


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def model_for_shape(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Apply shape-driven overrides (e.g. sliding window for long decode)."""
    if shape.window_override and cfg.family not in ("ssm",) and not cfg.attention_free:
        if cfg.sliding_window == 0 or cfg.sliding_window > shape.window_override:
            return replace(cfg, sliding_window=shape.window_override)
    return cfg
