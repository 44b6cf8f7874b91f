"""KV migration payloads: prefill/decode disaggregation (DESIGN.md §18).

A :class:`KVPayload` is one request frozen at a *commit boundary* — the
quiesce point where every dispatched token has been committed to request
state (``Engine.flush``) — packaged so a different engine instance can
resume its decode bit-identically:

* **KV entries**, gathered into contiguous per-layer ``(L, T, kv, hd)``
  tensors. The representation is *layout-invariant* (a paged source
  gathers its blocks, a contiguous source slices its slab) and
  *instance-invariant* (no block ids, no slot ids — the importer
  scatters into whatever blocks/slot it allocates).
* **The sampling contract** (:class:`~repro_torch.config.SamplingConfig`)
  and the penalty state's prompt/output histogram rows, copied bitwise —
  presence/frequency penalties depend on C_p/C_o (Eq. 5), so they must
  travel rather than be recomputed under a truncated prompt window.
* **The RNG position**: uniforms are keyed on (request nonce, output
  position), so carrying ``next_pos`` (= ``len(output)``) is sufficient
  for the continuation stream to be the same pure function of
  (seed, prompt, params) it always was.

In memory the K/V and histogram rows are torch tensors; on the in-process
path they stay on the exporting engine's device (the importer copies them
to its own). ``to_bytes``/``from_bytes`` give the portable form: a
self-contained ``.npz`` with JSON meta, free of any framework, with the
reference package's array names, meta keys and dtype strings, so a payload
written by either package is read by the other. numpy has no bfloat16 of
its own, so bf16-family K/V are widened to float32 on write and narrowed
back through torch on read — both exact, so the round trip is bitwise.
"""
from __future__ import annotations

import io
import json
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.config import SamplingConfig
from repro_torch.engine.request import Request, RequestState
from repro_torch.models.layers import torch_dtype


def _sampling_to_dict(s: SamplingConfig) -> dict:
    return {
        "temperature": s.temperature, "top_k": s.top_k, "top_p": s.top_p,
        "min_p": s.min_p, "repetition_penalty": s.repetition_penalty,
        "presence_penalty": s.presence_penalty,
        "frequency_penalty": s.frequency_penalty, "seed": s.seed,
        "greedy": s.greedy,
        "logit_bias": [[t, b] for t, b in s.logit_bias],
        "stop_sequences": [list(seq) for seq in s.stop_sequences],
    }


def _sampling_from_dict(d: dict) -> SamplingConfig:
    return SamplingConfig(
        temperature=d["temperature"], top_k=d["top_k"], top_p=d["top_p"],
        min_p=d["min_p"], repetition_penalty=d["repetition_penalty"],
        presence_penalty=d["presence_penalty"],
        frequency_penalty=d["frequency_penalty"], seed=d["seed"],
        greedy=d["greedy"],
        logit_bias=tuple((int(t), float(b)) for t, b in d["logit_bias"]),
        stop_sequences=tuple(tuple(int(t) for t in seq)
                             for seq in d["stop_sequences"]))


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` (bf16/f16 widened to float32, exactly)."""
    t = t.cpu()
    return (t.float() if t.is_floating_point() else t).numpy()


@dataclass
class KVPayload:
    """One quiesced request's migratable state (DESIGN.md §18)."""

    # request identity + progress
    request_id: int
    prompt: List[int]
    output: List[int]                  # committed tokens (>= 1)
    max_new_tokens: int
    sampling: SamplingConfig
    eos_token: Optional[int]
    prompt_offset: int                 # head-skip of the prefilled window
    arrival_time: float
    # KV entries at the quiesce point: T = kv_len committed cache rows
    kv_len: int
    k: torch.Tensor                    # (L, T, kv, hd), cache dtype
    v: torch.Tensor                    # (L, T, kv, hd), cache dtype
    # decision-plane row state, copied bitwise
    prompt_counts: torch.Tensor        # (V,) int32 — C_p (Eq. 5)
    output_counts: torch.Tensor        # (V,) int32 — C_o, with output[-1]
    last_token: int                    # output[-1]: sampled, not yet forwarded
    next_pos: int                      # RNG output position = len(output)
    # provenance / observability
    exported_at: float = 0.0           # perf_counter at export (handoff_wait)
    source: str = ""                   # exporting engine/replica tag
    # in-process fast path: the live request object (None after from_bytes)
    request: Optional[Request] = field(default=None, repr=False)

    def to_request(self) -> Request:
        """Reconstruct a detached :class:`Request` (the wire path — a
        payload that crossed ``to_bytes`` has no live object to reuse)."""
        r = Request(request_id=self.request_id, prompt=list(self.prompt),
                    max_new_tokens=self.max_new_tokens,
                    sampling=self.sampling, eos_token=self.eos_token,
                    arrival_time=self.arrival_time)
        r.output = list(self.output)
        r.prompt_offset = self.prompt_offset
        r.state = RequestState.WAITING
        return r

    def to_bytes(self) -> bytes:
        """Self-contained ``.npz`` image (the K/V and histograms move to
        the host). bf16-family cache dtypes are widened to float32 (exact)
        and named in ``kv_dtype`` so the reader narrows them back."""
        kv_dtype = str(self.k.dtype).removeprefix("torch.")   # numpy's name
        meta = {
            "request_id": int(self.request_id),
            "max_new_tokens": int(self.max_new_tokens),
            "sampling": _sampling_to_dict(self.sampling),
            "eos_token": self.eos_token,
            "prompt_offset": int(self.prompt_offset),
            "arrival_time": float(self.arrival_time),
            "kv_len": int(self.kv_len),
            "kv_dtype": kv_dtype,
            "last_token": int(self.last_token),
            "next_pos": int(self.next_pos),
            "exported_at": float(self.exported_at),
            "source": self.source,
        }
        buf = io.BytesIO()
        np.savez_compressed(
            buf, meta=np.frombuffer(
                json.dumps(meta).encode("utf-8"), np.uint8),
            prompt=np.asarray(self.prompt, np.int64),
            output=np.asarray(self.output, np.int64),
            k=_host_array(self.k), v=_host_array(self.v),
            prompt_counts=_host_array(self.prompt_counts),
            output_counts=_host_array(self.output_counts))
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "KVPayload":
        """Read a ``.npz`` payload of either package into CPU tensors, the
        K/V narrowed to ``kv_dtype``."""
        with np.load(io.BytesIO(data)) as z:
            meta = json.loads(bytes(z["meta"]).decode("utf-8"))
            try:
                kv_dtype = torch_dtype(meta["kv_dtype"])
            except KeyError:
                raise ValueError(f"payload kv_dtype {meta['kv_dtype']!r} "
                                 "is no cache dtype of this package")
            k, v = (torch.from_numpy(z[n]).to(kv_dtype) for n in ("k", "v"))
            return cls(
                request_id=meta["request_id"],
                prompt=[int(t) for t in z["prompt"]],
                output=[int(t) for t in z["output"]],
                max_new_tokens=meta["max_new_tokens"],
                sampling=_sampling_from_dict(meta["sampling"]),
                eos_token=meta["eos_token"],
                prompt_offset=meta["prompt_offset"],
                arrival_time=meta["arrival_time"],
                kv_len=meta["kv_len"], k=k, v=v,
                prompt_counts=torch.from_numpy(z["prompt_counts"]),
                output_counts=torch.from_numpy(z["output_counts"]),
                last_token=meta["last_token"],
                next_pos=meta["next_pos"],
                exported_at=meta["exported_at"],
                source=meta["source"])

    @property
    def nbytes(self) -> int:
        """Transfer size of the KV entries (the dominant term)."""
        return int(self.k.nbytes + self.v.nbytes)


def stamp_export(payload: KVPayload) -> KVPayload:
    """Mark the handoff clock: ``handoff_wait`` spans run from this stamp
    to the importer's install (same ``perf_counter`` axis in-process)."""
    payload.exported_at = time.perf_counter()
    return payload


__all__ = ["KVPayload", "stamp_export"]
