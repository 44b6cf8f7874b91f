"""Device selection and host-to-device transfers for the port.

Entry points take an explicit ``device`` that defaults to ``"cuda"``; asking
for CUDA without a card raises instead of carrying on on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but torch sees no CUDA "
            "device; pass device='cpu' to run on the CPU")
    return dev


def to_device(array, device: torch.device) -> torch.Tensor:
    """A private copy of a host array on ``device``.

    Always a copy: on the CPU ``torch.from_numpy`` would alias the host
    buffer, which the engine keeps mutating after dispatch. On CUDA the
    copy is ``non_blocking``: from pageable memory the driver stages the
    bytes before returning and does not wait for the stream, so the
    overlapped loop is never serialised by an upload.
    """
    t = torch.from_numpy(np.array(array, copy=True))
    if device.type == "cpu":
        return t
    return t.to(device, non_blocking=True)
