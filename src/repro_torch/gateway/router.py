"""Request router: least-loaded dispatch, session affinity, admission
backpressure (DESIGN.md §16).

The router is the gateway's single admission decision point. Policy:

* **session affinity** — a request carrying a ``session_id`` sticks to
  the replica its session first landed on (KV reuse / conversational
  locality is per-replica state in every real deployment). Affinity is
  deliberately *strict*: if the sticky replica is full the request is
  refused (429) rather than silently migrated — a migrated follow-up
  would lose whatever the affinity existed for, and the client's retry
  lands back on the sticky replica once it drains.
* **least-loaded** — otherwise, replicas are tried in ascending open-load
  order (ties by index, deterministic). ``try_submit`` re-checks capacity
  atomically, so a race between two connections can refuse, never
  over-admit.
* **backpressure** — if no replica admits, the router answers ``busy``
  with a Retry-After hint instead of queueing: the gateway holds no
  unbounded buffer, the bound lives in the per-replica capacity.

The affinity table is bounded (LRU by insertion refresh) so a session
flood cannot grow gateway memory without bound.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Optional

from repro_torch.gateway.fleet import Replica


@dataclass
class RouteResult:
    """Outcome of one admission attempt.

    ``status``: ``ok`` (admitted to ``replica``), ``busy`` (every
    eligible replica at capacity → HTTP 429 + ``retry_after``), or
    ``draining`` (gateway is shutting down → HTTP 503).
    """

    status: str
    replica: Optional[Replica] = None
    retry_after: float = 1.0


class Router:
    def __init__(self, replicas: List[Replica], retry_after: float = 1.0,
                 max_sessions: int = 4096,
                 decode_replicas: Optional[List[Replica]] = None):
        """``replicas`` are the admission targets. With
        ``decode_replicas`` set, the router is *disaggregated*
        (DESIGN.md §18): prompts are admitted least-loaded to the
        (prefill) ``replicas``, and :meth:`place_decode` — installed as
        every prefill replica's handoff hook — reserves a decode replica
        for each request at its first committed token. Session affinity
        then lives on the DECODE side (it moves with the request: decode
        replicas hold the long-lived KV state that affinity exists for),
        and stays strict: a sticky decode replica at capacity refuses the
        migration, and the request keeps decoding on its prefill replica
        until the sticky target drains."""
        assert replicas
        self.replicas = list(replicas)
        self.decode_replicas = list(decode_replicas) if decode_replicas \
            else None
        self.retry_after = retry_after
        self.max_sessions = max_sessions
        # session -> index into the affinity pool (decode_replicas when
        # disaggregated, the admission replicas otherwise)
        self._affinity: "OrderedDict[str, int]" = OrderedDict()
        self._lock = threading.Lock()
        self._accepting = True
        self.rejected_busy = 0
        self.rejected_draining = 0

    @classmethod
    def for_fleet(cls, fleet, retry_after: float = 1.0,
                  max_sessions: int = 4096) -> "Router":
        """Build the router for a fleet and, when the fleet is
        disaggregated, install :meth:`place_decode` as every prefill
        replica's handoff hook — the one place admission policy and
        migration policy are wired together."""
        router = cls(fleet.prefill_replicas, retry_after=retry_after,
                     max_sessions=max_sessions,
                     decode_replicas=fleet.decode_replicas or None)
        if router.decode_replicas:
            for r in fleet.prefill_replicas:
                r.set_handoff(router.place_decode)
        return router

    @property
    def _affinity_pool(self) -> List[Replica]:
        return self.decode_replicas if self.decode_replicas \
            else self.replicas

    @property
    def accepting(self) -> bool:
        return self._accepting

    def stop_accepting(self) -> None:
        """Drain mode: every subsequent submit answers ``draining``."""
        self._accepting = False

    def _sticky(self, session_id: str) -> Optional[Replica]:
        with self._lock:
            idx = self._affinity.get(session_id)
            if idx is not None:
                self._affinity.move_to_end(session_id)
                return self._affinity_pool[idx]
        return None

    def _pin(self, session_id: str, replica: Replica) -> None:
        idx = self._affinity_pool.index(replica)
        with self._lock:
            self._affinity[session_id] = idx
            self._affinity.move_to_end(session_id)
            while len(self._affinity) > self.max_sessions:
                self._affinity.popitem(last=False)

    def submit(self, request, sink, on_done=None,
               session_id: Optional[str] = None) -> RouteResult:
        """Route and admit in one step (the capacity check must be atomic
        with admission, so the router never *selects* without
        submitting)."""
        if not self._accepting:
            self.rejected_draining += 1
            return RouteResult("draining", retry_after=self.retry_after)
        if session_id is not None and self.decode_replicas is None:
            # colocated: affinity binds admission. (Disaggregated skips
            # this — prefill replicas hold no session state; affinity is
            # enforced at the decode handoff instead.)
            sticky = self._sticky(session_id)
            if sticky is not None:
                if sticky.try_submit(request, sink, on_done,
                                     session_id=session_id):
                    return RouteResult("ok", sticky)
                self.rejected_busy += 1
                return RouteResult("busy", retry_after=self.retry_after)
        # least-loaded first; the load read is a snapshot, try_submit
        # re-checks capacity atomically
        order = sorted(range(len(self.replicas)),
                       key=lambda i: (self.replicas[i].load, i))
        for i in order:
            r = self.replicas[i]
            if r.try_submit(request, sink, on_done, session_id=session_id):
                if session_id is not None and self.decode_replicas is None:
                    self._pin(session_id, r)
                return RouteResult("ok", r)
        self.rejected_busy += 1
        return RouteResult("busy", retry_after=self.retry_after)

    def place_decode(self, session_id: Optional[str] = None
                     ) -> Optional[Replica]:
        """Reserve a decode-role replica for one migrating request — the
        prefill replicas' handoff hook (DESIGN.md §18). Strict session
        affinity moves with the request: a session's first migration pins
        its decode replica; later migrations for the same session either
        reserve THAT replica or return None (the request keeps decoding
        where it is and the handoff is retried — never silently
        re-homed). Sessionless requests go least-loaded."""
        if not self.decode_replicas or not self._accepting:
            return None
        if session_id is not None:
            sticky = self._sticky(session_id)
            if sticky is not None:
                return sticky if sticky.reserve() else None
        order = sorted(range(len(self.decode_replicas)),
                       key=lambda i: (self.decode_replicas[i].load, i))
        for i in order:
            r = self.decode_replicas[i]
            if r.reserve():
                if session_id is not None:
                    self._pin(session_id, r)
                return r
        return None


__all__ = ["Router", "RouteResult"]
