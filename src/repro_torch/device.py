"""Device selection and host-to-device transfers for the port.

Entry points take an explicit ``device`` that defaults to ``"cuda"``; asking
for CUDA without a card raises instead of carrying on on the CPU.
"""
from __future__ import annotations

from typing import List

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


class HostCopy:
    """Tensors on their way to the host.

    On CUDA the copies into pinned memory are enqueued on the tensors'
    device's current stream when this object is made — behind the work
    that produces the tensors and ahead of whatever is enqueued next — and
    an event recorded on that stream marks their end: :meth:`wait` waits
    for that event only, from any thread (a gateway replica drives its
    engine from a worker thread, whose current device may be another). A
    plain ``.cpu()`` later would queue behind the next step's kernels and
    serialise the loop. CPU tensors are cloned (later in-place updates
    must not reach them). The pinned buffers live as long as this
    object."""

    def __init__(self, *tensors: torch.Tensor):
        self.event = None
        if tensors[0].is_cuda:
            self.vals = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in tensors]
            for dst, src in zip(self.vals, tensors):
                dst.copy_(src, non_blocking=True)   # on src's device's stream
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(tensors[0].device))
        else:
            self.vals = [t.clone() for t in tensors]

    def wait(self) -> List[torch.Tensor]:
        """The tensors on the host, once their copies have landed."""
        if self.event is not None:
            self.event.synchronize()
        return self.vals
