"""Stdlib-asyncio HTTP front-end: OpenAI-style completions with SSE
streaming over the replica fleet (DESIGN.md §16).

One process, one event loop, no dependencies beyond the standard
library. The loop owns only connection handling and JSON; everything
with real cost lives elsewhere — model work on the replica worker
threads, codec work in the
:class:`~repro_torch.gateway.codec.CodecPool` — and token events cross
from the worker threads onto the loop through
``loop.call_soon_threadsafe`` into per-request ``asyncio.Queue``s (the
fleet-bridge seam).

Endpoints:

* ``POST /v1/completions`` — body: ``prompt`` (text, or a raw token-id
  list to bypass the codec), ``max_tokens``, the sampling contract
  (``temperature`` / ``top_k`` / ``top_p`` / ``min_p`` /
  ``repetition_penalty`` / ``presence_penalty`` / ``frequency_penalty``
  / ``seed`` / ``greedy`` / ``stop`` (text) / ``stop_tokens`` (id
  lists) / ``eos_token``), ``stream`` (SSE when true), ``session_id``
  (replica affinity; also the ``X-Session-Id`` header).
  Backpressure: 429 + ``Retry-After`` when every eligible replica is at
  capacity, 503 while draining — the gateway never buffers unboundedly.
* ``GET /healthz`` — liveness + per-replica loads.
* ``GET /v1/stats`` — wire-level percentile summary + admission counters.
* ``GET /metrics`` — Prometheus text exposition (§17): the gateway's own
  wire-level instruments (TTFT / TPOT / queue histograms, request
  counters by status, replica load) merged with every replica engine's
  registry, each replica's families labelled ``replica="<name>"``.
* ``GET /v1/trace`` — Chrome trace-event JSON snapshot of the gateway's
  flight recorder merged with every replica engine's (load it in
  ``chrome://tracing`` / Perfetto), when the gateway was constructed
  with ``trace=True``.

Every response closes its connection (``Connection: close``); clients
stream SSE by reading to EOF — ``curl -N`` works as-is.
"""
from __future__ import annotations

import asyncio
import json
import math
import time
from collections import deque
from itertools import count
from typing import Dict, List, Optional, Tuple

from repro_torch.config import SamplingConfig
from repro_torch.engine.engine import GenerationEvent
from repro_torch.engine.request import Request
from repro_torch.gateway.codec import CodecPool, get_codec
from repro_torch.gateway.fleet import ReplicaFleet
from repro_torch.gateway.router import Router
from repro_torch.gateway.stats import WireTrace, summarize_traces
from repro_torch.obs import (MetricsRegistry, StepTracer, chrome_trace,
                       render_registries)

_MAX_BODY = 8 * 1024 * 1024     # request bodies beyond this → 413


class _BadRequest(Exception):
    """Client error surfaced as HTTP 400 with the message as JSON."""


#: terminal marker crossing the thread bridge after a stream's last event
_DONE = object()


class GatewayServer:
    """The serving gateway: fleet + router + codec pool behind asyncio.

    ``serve`` binds and accepts until :meth:`shutdown`; ``shutdown``
    executes the graceful-drain contract — stop admissions (new requests
    get 503), drain every in-flight stream, then close every replica.
    """

    def __init__(self, fleet: ReplicaFleet, codec: str = "byte",
                 codec_workers: int = 2, retry_after: float = 1.0,
                 max_tokens_cap: int = 512, trace_window: int = 4096,
                 trace: bool = False):
        self.fleet = fleet
        # for_fleet wires disaggregation (§18): prefill-role replicas get
        # place_decode as their handoff hook; colocated fleets route as
        # before
        self.router = Router.for_fleet(fleet, retry_after=retry_after)
        self.codec_pool = CodecPool(get_codec(codec), codec_workers)
        self.max_tokens_cap = max_tokens_cap
        self.traces: deque = deque(maxlen=trace_window)
        self._ids = count(1)
        self._server: Optional[asyncio.AbstractServer] = None
        self._shut = False
        self.started_at = time.monotonic()
        # telemetry plane (§17): the gateway's own wire-level registry +
        # flight recorder; /metrics and /v1/trace merge in the replicas'
        self.metrics = MetricsRegistry()
        self.tracer = StepTracer(capacity=16384, enabled=trace)
        self._ttft = self.metrics.histogram(
            "gateway_ttft_ms", "wire time-to-first-token")
        self._tpot = self.metrics.histogram(
            "gateway_tpot_ms",
            "wire mean per-output-token latency past the first")
        self._queue = self.metrics.histogram(
            "gateway_queue_ms",
            "arrival -> engine admission (gateway + engine queues)")
        self._tokens = self.metrics.counter(
            "gateway_tokens_streamed_total",
            "token events delivered to clients")

    def _count_request(self, status: str) -> None:
        """One labelled admission-outcome tick (counters are get-or-create,
        so each status label materializes on first use)."""
        self.metrics.counter(
            "gateway_requests_total",
            "completions requests by admission outcome",
            status=status).inc()

    # -- lifecycle -----------------------------------------------------------
    async def serve(self, host: str = "127.0.0.1", port: int = 0) -> None:
        """Bind and start accepting; sets :attr:`port` (useful with an
        ephemeral ``port=0``)."""
        self.fleet.start()
        self._server = await asyncio.start_server(
            self._handle_conn, host, port, limit=_MAX_BODY)
        self.host = host
        self.port = self._server.sockets[0].getsockname()[1]

    async def serve_forever(self, host: str = "127.0.0.1",
                            port: int = 8100) -> None:
        await self.serve(host, port)
        async with self._server:
            await self._server.serve_forever()

    async def shutdown(self, drain_timeout: float = 30.0) -> None:
        """Graceful drain (idempotent): stop admissions → in-flight
        streams finish → every replica closed → listener closed."""
        if self._shut:
            return
        self._shut = True
        self.router.stop_accepting()
        self.fleet.stop_accepting()
        loop = asyncio.get_running_loop()
        # fleet.drain blocks in threading; keep the loop serving the
        # still-open SSE connections while we wait
        await loop.run_in_executor(None, self.fleet.drain, drain_timeout)
        await loop.run_in_executor(None, self.fleet.close)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self.codec_pool.close()

    # -- HTTP plumbing -------------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError,
                ConnectionError):
            writer.close()
            return
        try:
            method, path, headers = _parse_head(head)
            body = b""
            n = int(headers.get("content-length", "0"))
            if n > _MAX_BODY:
                await _send_json(writer, 413,
                                 {"error": "request body too large"})
                return
            if n:
                body = await reader.readexactly(n)
            await self._route(method, path, headers, body, writer)
        except _BadRequest as e:
            self._count_request("bad_request")
            await _send_json(writer, 400, {"error": str(e)})
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except Exception as e:                      # never kill the loop
            self._count_request("error")
            try:
                await _send_json(writer, 500, {"error": repr(e)})
            except Exception:
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _route(self, method: str, path: str, headers: Dict[str, str],
                     body: bytes, writer: asyncio.StreamWriter) -> None:
        if method == "POST" and path == "/v1/completions":
            await self._completions(headers, body, writer)
        elif method == "GET" and path == "/healthz":
            await _send_json(writer, 200, self._health())
        elif method == "GET" and path == "/v1/stats":
            await _send_json(writer, 200, self._stats())
        elif method == "GET" and path == "/metrics":
            await _send_text(writer, 200, self._metrics_text(),
                             content_type="text/plain; version=0.0.4; "
                                          "charset=utf-8")
        elif method == "GET" and path == "/v1/trace":
            await _send_json(writer, 200, self._trace_snapshot())
        else:
            await _send_json(writer, 404,
                             {"error": f"no route {method} {path}"})

    def _health(self) -> dict:
        return {"status": "draining" if self._shut or
                not self.router.accepting else "ok",
                "accepting": self.router.accepting,
                "uptime_s": time.monotonic() - self.started_at,
                "replicas": self.fleet.loads()}

    def _stats(self) -> dict:
        traces = list(self.traces)
        return {"wire": summarize_traces(traces),
                "served": sum(r.served for r in self.fleet.replicas),
                "rejected_busy": self.router.rejected_busy,
                "rejected_draining": self.router.rejected_draining,
                "disaggregated": self.fleet.disaggregated,
                # per-replica role/load/free-block/migration counts (§18)
                # — the router's decisions, debuggable from the outside
                "replicas": {r.name: r.stats()
                             for r in self.fleet.replicas},
                "recent": [t.as_dict() for t in traces[-16:]]}

    def _metrics_text(self) -> str:
        """Prometheus text exposition (§17): the gateway's registry plus
        every replica engine's, each labelled ``replica="<name>"``.
        Replica loads are refreshed at scrape time — a gauge per replica,
        so queue pressure is visible without hitting /healthz."""
        for name, load in self.fleet.loads().items():
            self.metrics.gauge("gateway_replica_load",
                               "in-flight streams per replica",
                               replica=name).set(float(load))
        sources = [({}, self.metrics)]
        for rep in self.fleet.replicas:
            obs = getattr(rep.engine, "obs", None)
            if obs is not None:
                sources.append(({"replica": rep.name}, obs.metrics))
        return render_registries(sources)

    def _trace_snapshot(self) -> dict:
        """Chrome trace-event JSON over the gateway's flight recorder and
        every replica engine's — one clock (perf_counter), one file."""
        sources = [("gateway", self.tracer)]
        for rep in self.fleet.replicas:
            tr = getattr(rep.engine, "tracer", None)
            if tr is not None:
                sources.append((f"replica:{rep.name}", tr))
        return chrome_trace(sources)

    # -- the completions endpoint -------------------------------------------
    async def _completions(self, headers: Dict[str, str], body: bytes,
                           writer: asyncio.StreamWriter) -> None:
        loop = asyncio.get_running_loop()
        try:
            payload = json.loads(body or b"{}")
        except ValueError:
            raise _BadRequest("body is not valid JSON")
        if not isinstance(payload, dict):
            raise _BadRequest("body must be a JSON object")
        req, stream, session_id = await self._build_request(
            loop, payload, headers)

        trace = WireTrace(request_id=req.request_id,
                          arrival=time.monotonic())
        events: "asyncio.Queue" = asyncio.Queue()

        def sink(ev: GenerationEvent) -> None:     # replica worker thread
            loop.call_soon_threadsafe(events.put_nowait, ev)

        def on_done(request: Request,
                    err: Optional[BaseException]) -> None:
            loop.call_soon_threadsafe(events.put_nowait, (_DONE, err))

        req.arrival_time = time.perf_counter()
        res = self.router.submit(req, sink, on_done, session_id=session_id)
        if res.status == "busy":
            self._count_request("busy")
            await _send_json(
                writer, 429, {"error": "all replicas at capacity"},
                extra=[("Retry-After", str(math.ceil(res.retry_after)))])
            return
        if res.status == "draining":
            self._count_request("draining")
            await _send_json(
                writer, 503, {"error": "gateway is draining"},
                extra=[("Retry-After", str(math.ceil(res.retry_after)))])
            return
        self._count_request("ok")
        trace.replica = res.replica.name
        self.traces.append(trace)
        if stream:
            await self._stream_response(loop, writer, req, trace, events)
        else:
            await self._unary_response(loop, writer, req, trace, events)

    async def _build_request(self, loop, payload: dict,
                             headers: Dict[str, str]
                             ) -> Tuple[Request, bool, Optional[str]]:
        prompt = payload.get("prompt")
        if isinstance(prompt, str):
            tokens = await self.codec_pool.encode_async(loop, prompt)
        elif isinstance(prompt, list) and \
                all(isinstance(t, int) for t in prompt):
            tokens = list(prompt)               # raw ids bypass the codec
        else:
            raise _BadRequest(
                "'prompt' must be a string or a list of token ids")
        if not tokens:
            raise _BadRequest("'prompt' must not be empty")
        max_tokens = payload.get("max_tokens", 16)
        if not isinstance(max_tokens, int) or \
                not 1 <= max_tokens <= self.max_tokens_cap:
            raise _BadRequest(
                f"'max_tokens' must be an int in [1, {self.max_tokens_cap}]")
        stops: List[Tuple[int, ...]] = []
        for s in payload.get("stop", []) or []:
            if not isinstance(s, str):
                raise _BadRequest("'stop' must be a list of strings")
            stops.append(tuple(await self.codec_pool.encode_async(loop, s)))
        for s in payload.get("stop_tokens", []) or []:
            if not (isinstance(s, list) and
                    all(isinstance(t, int) for t in s)):
                raise _BadRequest(
                    "'stop_tokens' must be a list of token-id lists")
            stops.append(tuple(s))
        seed = payload.get("seed")
        if seed is not None and not isinstance(seed, int):
            raise _BadRequest("'seed' must be an int")
        try:
            sampling = SamplingConfig(
                temperature=float(payload.get("temperature", 1.0)),
                top_k=int(payload.get("top_k", 0)),
                top_p=float(payload.get("top_p", 1.0)),
                min_p=float(payload.get("min_p", 0.0)),
                repetition_penalty=float(
                    payload.get("repetition_penalty", 1.0)),
                presence_penalty=float(payload.get("presence_penalty", 0.0)),
                frequency_penalty=float(
                    payload.get("frequency_penalty", 0.0)),
                seed=seed,
                greedy=bool(payload.get("greedy", False)),
                stop_sequences=tuple(stops),
            )
        except (TypeError, ValueError) as e:
            raise _BadRequest(f"bad sampling parameters: {e}")
        eos = payload.get("eos_token")
        if eos is not None and not isinstance(eos, int):
            raise _BadRequest("'eos_token' must be an int")
        session_id = payload.get("session_id") or headers.get("x-session-id")
        req = Request(request_id=next(self._ids), prompt=tokens,
                      max_new_tokens=max_tokens, sampling=sampling,
                      eos_token=eos)
        return req, bool(payload.get("stream", False)), session_id

    # -- response bodies -----------------------------------------------------
    def _finalize_trace(self, trace: WireTrace, req: Request) -> None:
        trace.finish = time.monotonic()
        trace.finish_reason = req.finish_reason
        if req.admit_time is not None and req.arrival_time:
            # the engine stamps admission on its perf_counter clock; carry
            # the *delta* over so the trace stays single-clock
            trace.admission = trace.arrival + \
                (req.admit_time - req.arrival_time)
        # fold the wire timings into /metrics the moment the terminal
        # event leaves — the histograms cover every finished request,
        # not a sampled window
        if trace.ttft_s is not None:
            self._ttft.observe(trace.ttft_s * 1e3)
        tpot = trace.tpot_s
        if tpot is not None:
            self._tpot.observe(tpot * 1e3)
        if trace.queue_s is not None:
            self._queue.observe(trace.queue_s * 1e3)
        self._tokens.inc(trace.n_tokens)
        if self.tracer.enabled and req.arrival_time:
            # the request's wire-level life on the repo-wide clock
            # (arrival_time is perf_counter — same axis as engine spans)
            self.tracer.add("request", req.arrival_time,
                            time.perf_counter(), track="gateway",
                            name=f"req#{req.request_id}",
                            request_id=int(req.request_id),
                            replica=trace.replica,
                            n_tokens=trace.n_tokens,
                            finish_reason=req.finish_reason)

    async def _stream_response(self, loop, writer, req: Request,
                               trace: WireTrace, events) -> None:
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Connection: close\r\n\r\n")
        await writer.drain()
        tokens: List[int] = []
        sent_text = ""
        while True:
            item = await events.get()
            if isinstance(item, tuple) and item[0] is _DONE:
                err = item[1]
                self._finalize_trace(trace, req)
                if err is not None:
                    payload = {"id": req.request_id, "error": repr(err)}
                else:
                    payload = {"id": req.request_id, "token": None,
                               "finish_reason": req.finish_reason,
                               "stats": trace.as_dict()}
                writer.write(_sse(payload))
                writer.write(b"data: [DONE]\n\n")
                await writer.drain()
                return
            ev: GenerationEvent = item
            trace.mark_token()
            chunk = {"id": req.request_id, "token": ev.token,
                     "finish_reason": ev.finish_reason}
            if ev.token is not None:
                tokens.append(ev.token)
                # incremental detokenization: decode the full prefix (in
                # the codec pool, off the loop) and emit only the stable
                # delta — withheld while the decode doesn't extend what
                # was already sent (e.g. a trailing incomplete multibyte
                # character), so the client never sees half a character
                decoded = await self.codec_pool.decode_async(loop, tokens)
                if decoded.startswith(sent_text) and \
                        len(decoded) > len(sent_text) and \
                        not decoded.endswith("�"):
                    chunk["text"] = decoded[len(sent_text):]
                    sent_text = decoded
            writer.write(_sse(chunk))
            await writer.drain()

    async def _unary_response(self, loop, writer, req: Request,
                              trace: WireTrace, events) -> None:
        tokens: List[int] = []
        err: Optional[BaseException] = None
        while True:
            item = await events.get()
            if isinstance(item, tuple) and item[0] is _DONE:
                err = item[1]
                break
            trace.mark_token()
            if item.token is not None:
                tokens.append(item.token)
        self._finalize_trace(trace, req)
        if err is not None and not tokens:
            status = 400 if isinstance(err, ValueError) else 500
            await _send_json(writer, status, {"error": repr(err)})
            return
        text = await self.codec_pool.decode_async(loop, tokens)
        await _send_json(writer, 200, {
            "id": req.request_id,
            "object": "text_completion",
            "choices": [{"index": 0, "text": text, "token_ids": tokens,
                         "finish_reason": req.finish_reason}],
            "usage": {"prompt_tokens": len(req.prompt),
                      "completion_tokens": len(tokens),
                      "total_tokens": len(req.prompt) + len(tokens)},
            "stats": trace.as_dict(),
        })


def _parse_head(head: bytes) -> Tuple[str, str, Dict[str, str]]:
    try:
        lines = head.decode("latin-1").split("\r\n")
        method, path, _version = lines[0].split(" ", 2)
    except ValueError:
        raise _BadRequest("malformed request line")
    headers: Dict[str, str] = {}
    for ln in lines[1:]:
        if not ln:
            continue
        k, _, v = ln.partition(":")
        headers[k.strip().lower()] = v.strip()
    return method.upper(), path, headers


def _sse(obj: dict) -> bytes:
    return b"data: " + json.dumps(obj).encode("utf-8") + b"\n\n"


_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            413: "Payload Too Large", 429: "Too Many Requests",
            500: "Internal Server Error", 503: "Service Unavailable"}


async def _send_json(writer: asyncio.StreamWriter, status: int, obj: dict,
                     extra: Optional[List[Tuple[str, str]]] = None) -> None:
    body = json.dumps(obj).encode("utf-8")
    head = [f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}",
            "Content-Type: application/json",
            f"Content-Length: {len(body)}",
            "Connection: close"]
    for k, v in extra or []:
        head.append(f"{k}: {v}")
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body)
    await writer.drain()


async def _send_text(writer: asyncio.StreamWriter, status: int, text: str,
                     content_type: str = "text/plain; charset=utf-8"
                     ) -> None:
    body = text.encode("utf-8")
    head = [f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(body)}",
            "Connection: close"]
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body)
    await writer.drain()


__all__ = ["GatewayServer"]
