"""What a run must not carry, and what it records of the card."""
from __future__ import annotations

import subprocess
import sys
from typing import List, Optional

#: top-level module names that no process of the benchmark may hold: JAX
#: and the JAX package the program was ported from
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules(modules=None) -> List[str]:
    """The banned top-level names among ``modules`` (default
    ``sys.modules``), each compared whole: ``repro_torch`` is not
    ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names} & set(BANNED))


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None
