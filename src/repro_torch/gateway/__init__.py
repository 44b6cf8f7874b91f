"""Async serving gateway of the port: HTTP/SSE front-end over a replica
fleet (DESIGN.md §16), the twin of the reference's ``gateway`` package.

The engines speak integer tokens through in-process Python calls; this
package is the path from "a user on the network" to ``Engine.generate``:

* :mod:`~repro_torch.gateway.codec` — the text⇄token seam (`Codec`
  protocol, a byte-level reference codec, and a worker pool that keeps
  tokenize / detokenize off the engine and event-loop threads);
* :mod:`~repro_torch.gateway.fleet` — ``ReplicaFleet``: N engines, each
  on its own worker thread behind a single-owner submission queue,
  streaming committed tokens to per-request sinks;
* :mod:`~repro_torch.gateway.router` — least-loaded dispatch with
  session affinity and bounded-queue admission (429 + Retry-After, never
  unbounded buffering);
* :mod:`~repro_torch.gateway.http` — the stdlib-asyncio HTTP server: an
  OpenAI-style ``/v1/completions`` endpoint with SSE streaming, health
  and stats endpoints, graceful drain;
* :mod:`~repro_torch.gateway.client` — a minimal stdlib HTTP/SSE client
  used by the smoke run and the tests;
* :mod:`~repro_torch.gateway.stats` — per-request wire-level traces
  (arrival → admission → first event → finish) and the
  goodput-under-SLO metric (DistServe).

No dependencies beyond the standard library and the port itself.
"""
from repro_torch.gateway.client import (StreamResult,  # noqa: F401
                                        request_json, stream_completion)
from repro_torch.gateway.codec import (ByteCodec, Codec,  # noqa: F401
                                       CodecPool, get_codec,
                                       registered_codecs)
from repro_torch.gateway.fleet import Replica, ReplicaFleet  # noqa: F401
from repro_torch.gateway.http import GatewayServer  # noqa: F401
from repro_torch.gateway.router import Router, RouteResult  # noqa: F401
from repro_torch.gateway.stats import (WireTrace,  # noqa: F401
                                       goodput_under_slo, summarize_traces)
