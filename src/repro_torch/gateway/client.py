"""Minimal stdlib-asyncio HTTP/SSE client for the gateway.

Just enough HTTP/1.1 to drive :mod:`repro_torch.gateway.http` — one request
per connection (the server answers ``Connection: close``), JSON bodies,
and ``text/event-stream`` parsing. Used by the latency benchmark's
``--gateway`` mode, the gateway tests, and the CI smoke check; it is
not a general HTTP client.
"""
from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


async def _request(host: str, port: int, method: str, path: str,
                   payload: Optional[dict], timeout: float
                   ) -> Tuple[int, Dict[str, str], asyncio.StreamReader,
                              asyncio.StreamWriter]:
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port), timeout)
    body = b"" if payload is None else json.dumps(payload).encode("utf-8")
    head = (f"{method} {path} HTTP/1.1\r\n"
            f"Host: {host}:{port}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n").encode("latin-1")
    writer.write(head + body)
    await writer.drain()
    status_line = await asyncio.wait_for(reader.readline(), timeout)
    try:
        status = int(status_line.split(b" ", 2)[1])
    except (IndexError, ValueError):
        raise ConnectionError(f"malformed status line: {status_line!r}")
    headers: Dict[str, str] = {}
    while True:
        line = await asyncio.wait_for(reader.readline(), timeout)
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    return status, headers, reader, writer


async def request_json(host: str, port: int, path: str,
                       payload: Optional[dict] = None,
                       method: Optional[str] = None,
                       timeout: float = 30.0) -> Tuple[int, dict]:
    """One JSON round trip; returns ``(status, parsed body)``."""
    method = method or ("POST" if payload is not None else "GET")
    status, headers, reader, writer = await _request(
        host, port, method, path, payload, timeout)
    try:
        if "content-length" in headers:
            raw = await asyncio.wait_for(
                reader.readexactly(int(headers["content-length"])), timeout)
        else:
            raw = await asyncio.wait_for(reader.read(), timeout)
        return status, json.loads(raw) if raw else {}
    finally:
        writer.close()


@dataclass
class StreamResult:
    """Everything one streamed completion produced, plus client-side
    clocks (``time.monotonic()``) for wire-latency measurement."""

    status: int
    headers: Dict[str, str] = field(default_factory=dict)
    events: List[dict] = field(default_factory=list)
    error: Optional[dict] = None
    sent_at: float = 0.0
    first_event_at: Optional[float] = None
    finished_at: Optional[float] = None
    event_times: List[float] = field(default_factory=list)

    @property
    def tokens(self) -> List[int]:
        return [e["token"] for e in self.events
                if e.get("token") is not None]

    @property
    def text(self) -> str:
        return "".join(e.get("text", "") for e in self.events)

    @property
    def finish_reason(self) -> Optional[str]:
        for e in reversed(self.events):
            if e.get("finish_reason"):
                return e["finish_reason"]
        return None

    @property
    def server_stats(self) -> Optional[dict]:
        for e in reversed(self.events):
            if "stats" in e:
                return e["stats"]
        return None

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_event_at is None:
            return None
        return self.first_event_at - self.sent_at

    @property
    def tpot_s(self) -> Optional[float]:
        times = [t for t, e in zip(self.event_times, self.events)
                 if e.get("token") is not None]
        if len(times) < 2:
            return None
        return (times[-1] - times[0]) / (len(times) - 1)


async def stream_completion(host: str, port: int, payload: dict,
                            timeout: float = 120.0) -> StreamResult:
    """POST ``/v1/completions`` with ``stream=true`` and consume the SSE
    stream to ``[DONE]``/EOF. Non-200 answers come back with ``status``
    and ``error`` set and no events — callers branch on ``status`` (429
    → back off by the Retry-After header, 503 → gateway draining)."""
    body = dict(payload)
    body["stream"] = True
    sent_at = time.monotonic()
    status, headers, reader, writer = await _request(
        host, port, "POST", "/v1/completions", body, timeout)
    res = StreamResult(status=status, headers=headers, sent_at=sent_at)
    try:
        if status != 200:
            if "content-length" in headers:
                raw = await asyncio.wait_for(
                    reader.readexactly(int(headers["content-length"])),
                    timeout)
                try:
                    res.error = json.loads(raw)
                except ValueError:
                    res.error = {"error": raw.decode("utf-8", "replace")}
            return res
        while True:
            line = await asyncio.wait_for(reader.readline(), timeout)
            if not line:                                 # EOF
                break
            line = line.strip()
            if not line or not line.startswith(b"data:"):
                continue
            data = line[len(b"data:"):].strip()
            if data == b"[DONE]":
                break
            ev = json.loads(data)
            now = time.monotonic()
            if ev.get("token") is not None and res.first_event_at is None:
                res.first_event_at = now
            res.events.append(ev)
            res.event_times.append(now)
            if "error" in ev:
                res.error = ev
        res.finished_at = time.monotonic()
        return res
    finally:
        writer.close()


__all__ = ["StreamResult", "stream_completion", "request_json"]
