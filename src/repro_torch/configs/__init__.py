"""Assigned architecture configs. Importing this package registers all of
them; individual modules may also be imported lazily via
:func:`repro_torch.config.get_arch`."""
from repro_torch.config import ARCH_IDS, all_archs  # noqa: F401

# Eagerly import every assigned arch so ``import repro_torch.configs`` is
# enough.
from repro_torch.configs import (  # noqa: F401
    llama4_maverick_400b_a17b,
    rwkv6_3b,
    qwen3_8b,
    internvl2_2b,
    starcoder2_7b,
    zamba2_1_2b,
    granite_moe_1b_a400m,
    whisper_base,
    tinyllama_1_1b,
    smollm_360m,
)
