"""HandoffScheduler: in-process prefill/decode disaggregation, one loop
over two engines (DESIGN.md §18).

The DistServe-style split without the gateway: one engine instance owns
prefill (admission + first token), a second owns decode (the steady
token stream). The scheduler drives both engines' iteration loops from
one thread and migrates each request at its first committed token via
the :meth:`Engine.export_request` / :meth:`Engine.import_request` seam —
so prefill bursts on instance A can never stall decode steps on
instance B, the paper's goodput argument for disaggregation.

The streamed events are the union of both engines' commit streams
through one :class:`~repro_torch.engine.engine.StreamCursor` per
request (the cursor follows the *request object*, which crosses engines
intact on the in-process path), so a consumer sees exactly the
``generate_stream``-shaped protocol with the migration invisible —
tokens are bit-identical to a never-migrated run by the §18 identity
argument.

Degradation contract: a request that finishes before it can migrate
(stop condition on its very first token) simply retires on the prefill
engine; if ``export_request`` races a finishing flush, the request stays
where it is. Nothing ever blocks on the other instance.
"""
from __future__ import annotations

from typing import Iterator, List

from repro_torch.engine.engine import GenerationEvent, StreamCursor
from repro_torch.engine.request import Request, RequestState


class HandoffScheduler:
    """Drive a prefill-role engine and a decode-role engine as one
    serving unit, migrating requests at their first committed token.

    Both engines must share model parameters (the cross-instance
    identity premise); ``handoff_after`` tokens (default 1 = at first
    token, the DistServe split point) must commit before a request
    moves."""

    def __init__(self, prefill_engine, decode_engine,
                 handoff_after: int = 1):
        assert handoff_after >= 1, "a request migrates at a commit boundary"
        self.prefill = prefill_engine
        self.decode = decode_engine
        self.handoff_after = handoff_after
        self.migrated = 0

    def _movable(self, req: Request, on_prefill: set) -> bool:
        return (req.request_id in on_prefill
                and req.state is RequestState.RUNNING
                and len(req.output) >= self.handoff_after
                and not req.should_stop())

    def _migrate_ready(self, requests: List[Request],
                       on_prefill: set) -> None:
        for r in requests:
            # re-check per request: exporting one request flushes the
            # prefill engine, which may finish (or stop) the next one
            if not self._movable(r, on_prefill):
                if r.request_id in on_prefill and r.should_stop():
                    on_prefill.discard(r.request_id)  # retires on prefill
                continue
            try:
                payload = self.prefill.export_request(r.request_id)
            except (KeyError, ValueError):
                # raced a finishing/preempting flush — leave it in place
                continue
            self.decode.import_request(payload)
            on_prefill.discard(r.request_id)
            self.migrated += 1

    def generate(self, requests: List[Request],
                 max_steps: int = 10_000) -> Iterator[GenerationEvent]:
        """Submit ``requests`` to the prefill engine and stream
        :class:`GenerationEvent` items as tokens commit on either engine;
        each request is handed off to the decode engine once its first
        ``handoff_after`` tokens committed. Raises ``RuntimeError`` if
        ``max_steps`` engine iterations pass with requests still open."""
        requests = list(requests)
        if not requests:
            return
        self.prefill.submit(requests)
        cursors = [StreamCursor(r) for r in requests]
        on_prefill = {r.request_id for r in requests}

        def drain():
            for c in cursors:
                yield from c.drain()

        steps = 0
        while not all(c.closed for c in cursors) and steps < max_steps:
            stepped = False
            if self.prefill.scheduler.has_work or self.prefill.in_flight:
                self.prefill.step()
                steps += 1
                stepped = True
                yield from drain()
            self._migrate_ready(requests, on_prefill)
            yield from drain()      # tokens committed by the export flush
            if self.decode.scheduler.has_work or self.decode.in_flight:
                self.decode.step()
                steps += 1
                stepped = True
                yield from drain()
            if not stepped:
                break
        self.prefill.flush()
        self.decode.flush()
        yield from drain()
        if not all(c.closed for c in cursors):
            open_ids = [c.request.request_id for c in cursors if not c.closed]
            raise RuntimeError(
                f"HandoffScheduler hit max_steps={max_steps} with requests "
                f"still unfinished: {open_ids}")

    def close(self) -> None:
        self.prefill.close()
        self.decode.close()


__all__ = ["HandoffScheduler"]
