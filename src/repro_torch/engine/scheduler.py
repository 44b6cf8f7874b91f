"""Iteration-level continuous-batching scheduler (§4.2 step ⓪).

Admission into a fixed pool of batch slots, vLLM-style: finished sequences
free their slot at iteration boundaries; waiting requests are admitted into
free slots. Each iteration the scheduler emits a compact *scheduling
output* — the analogue of the paper's scheduling stream on the shared-memory
ring — describing which slots decode, which requests are newly admitted, and
the chunk of prompt work due for each mid-prefill slot.

Two upgrades over plain FCFS (DESIGN.md §8):

* **Chunked prefill** — a prompt longer than ``prompt_chunk`` is admitted in
  ``PREFILLING`` state and prefilled ``prompt_chunk`` tokens per iteration,
  interleaved with the decode batch, so one long prompt can no longer stall
  every running sequence for a full monolithic prefill (the serving analogue
  of the paper's "sampling caps pipeline frequency" argument).
* **Priority admission** — when slots free up, single-chunk prompts are
  admitted before multi-chunk ones (they reach decode in one iteration),
  FCFS within each class; a request that has waited ``max_admission_wait``
  schedule calls is promoted to the front regardless, so long prompts
  cannot starve.
* **Block-based admission + preemption** (DESIGN.md §9) — with a paged KV
  engine, ``kv_gate`` admits a request only when its worst-case
  ``ceil((prompt+max_new)/block_size)`` blocks are free, and ``preempt``
  evicts the most recently admitted request under pool pressure,
  re-queueing it at the front for recompute-on-resume.

The engine commits tokens against the *snapshot* of slot assignments taken
when the iteration was dispatched (``SchedulingOutput.slot_request``), which
is what makes the overlapped engine's one-step commit lag safe: by the time
a token is fetched to the host, the slot may already host a different
request (speculative slot reuse — DESIGN.md §2).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from repro_torch.engine.request import Request, RequestState


@dataclass
class ChunkTask:
    """One iteration's prefill work for one mid-prefill slot."""

    slot: int
    request: Request
    start: int          # first prompt index of this chunk
    end: int            # one past the last prompt index
    final: bool         # chunk completes the prompt -> sample first token


@dataclass
class SchedulingOutput:
    """One iteration's plan (the paper's 'scheduling output')."""

    step: int
    active_slots: np.ndarray            # (B,) bool — slots decoding this step
    new_requests: List[Request]         # admitted this iteration (monolithic)
    new_chunked: List[Request]          # admitted this iteration (chunked)
    chunks: List[ChunkTask]             # prompt chunks due this iteration
    slot_request: List[Optional[Request]]  # per-slot request snapshot


class Scheduler:
    def __init__(self, num_slots: int, prompt_chunk: int = 0,
                 priority_admission: bool = True,
                 max_admission_wait: int = 64,
                 max_prompt: Optional[int] = None,
                 kv_gate: Optional[Callable[[Request, List[Request]], bool]]
                 = None,
                 on_free: Optional[Callable[[int, Request], None]] = None):
        """``kv_gate(req, admitted_this_round)``: block-based admission
        (DESIGN.md §9) — a request enters a free slot only if the KV pool
        can cover its worst case; candidates that do not fit are skipped
        (not head-of-line blocking) and retried every round. ``on_free``
        fires whenever a slot gives up its claim (retire or preemption) so
        the engine can release the slot's KV blocks and reset its
        sampling-contract row (stale ``SlotParams`` must never survive into
        the slot's next occupant)."""
        self.num_slots = num_slots
        self.prompt_chunk = prompt_chunk
        self.priority_admission = priority_admission
        self.max_admission_wait = max_admission_wait
        self.max_prompt = max_prompt
        self.kv_gate = kv_gate
        self.on_free = on_free
        self.waiting: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * num_slots
        self.step = 0
        self.finished: List[Request] = []
        self.preemptions = 0

    # -- queue management -----------------------------------------------------
    def submit(self, request: Request) -> None:
        self.waiting.append(request)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    # -- iteration boundary -----------------------------------------------------
    def retire_finished(self, group=None) -> None:
        """Free slots whose requests have committed their stop condition.

        ``group`` (optional container of slot ids) restricts retirement to
        those slots — the pipeline engine retires only the microbatch
        re-entering stage 1, because other microbatches' slots may have
        forwards in flight (DESIGN.md §12)."""
        for i, req in enumerate(self.slots):
            if group is not None and i not in group:
                continue
            if req is not None and req.state is RequestState.RUNNING \
                    and req.should_stop():
                req.state = RequestState.FINISHED
                self.finished.append(req)
                self.slots[i] = None
                if self.on_free is not None:
                    self.on_free(i, req)

    def preempt(self, victim: Request) -> None:
        """Evict a slotted request under KV-block pressure (DESIGN.md §9):
        free its slot (releasing its blocks via ``on_free``) and re-queue
        it at the *front* of the waiting queue. Committed output survives —
        the next admission re-prefills prompt+output (recompute-on-resume)
        and decoding continues bit-identically at position len(output)."""
        slot = victim.slot
        assert 0 <= slot < self.num_slots and self.slots[slot] is victim, \
            "preempt target is not slotted"
        self.slots[slot] = None
        victim.slot = -1
        victim.state = RequestState.WAITING
        victim.preempt_count += 1
        victim.prompt_pos = 0
        # re-queued victims are never starved: front of the queue plus the
        # aged priority class (admission order puts them first)
        victim.admit_wait = self.max_admission_wait
        self.preemptions += 1
        if self.on_free is not None:
            self.on_free(slot, victim)
        self.waiting.insert(0, victim)

    def remove(self, victim: Request) -> None:
        """Detach a slotted request WITHOUT re-queueing it — the migration
        export path (DESIGN.md §18). Frees the slot exactly like
        :meth:`preempt` (``on_free`` releases KV blocks and resets the
        sampling-contract row) but leaves the request's destination to the
        caller: committed output survives on the request object, and the
        exported :class:`~repro_torch.engine.migration.KVPayload` carries
        everything a target engine needs to resume."""
        slot = victim.slot
        assert 0 <= slot < self.num_slots and self.slots[slot] is victim, \
            "remove target is not slotted"
        self.slots[slot] = None
        victim.slot = -1
        victim.state = RequestState.WAITING
        victim.prompt_pos = 0
        if self.on_free is not None:
            self.on_free(slot, victim)

    def _admission_order(self) -> List[int]:
        """Indices into ``waiting`` in admission order.

        Priority classes (stable within each): (0) aged past
        ``max_admission_wait`` — anti-starvation, (1) single-chunk prompts,
        (2) multi-chunk prompts. Plain FCFS when chunking or priority is off.
        """
        if not (self.priority_admission and self.prompt_chunk > 0):
            return list(range(len(self.waiting)))
        return sorted(range(len(self.waiting)), key=lambda i: (
            0 if self.waiting[i].admit_wait >= self.max_admission_wait else 1,
            0 if self.waiting[i].prompt_len <= self.prompt_chunk else 1,
            i))

    def schedule(self, group=None) -> SchedulingOutput:
        """Retire finished requests, admit waiting ones, emit the plan.

        ``group`` (optional container of slot ids) makes the call
        *microbatch-aware* (DESIGN.md §12): only the group's slots are
        retired, admitted into, or scheduled for prompt chunks. The waiting
        queue and priority classes stay global, so admission order across
        microbatches is still FCFS-with-priority."""
        self.retire_finished(group)
        # admit into free slots in priority order; with a kv_gate, a
        # candidate whose block demand does not fit is skipped this round
        # (later, smaller requests may still be admitted)
        new: List[Request] = []
        new_chunked: List[Request] = []
        slot_range = range(self.num_slots) if group is None else group
        free = [i for i in slot_range if self.slots[i] is None]
        if free and self.waiting:
            order = self._admission_order()
            admitted: set = set()
            round_admits: List[Request] = []
            for rank in order:
                if not free:
                    break
                req = self.waiting[rank]
                if self.kv_gate is not None and \
                        not self.kv_gate(req, round_admits):
                    if req.admit_wait >= self.max_admission_wait:
                        # drain for an aged (or preempted) request: stop
                        # admitting behind it so freed blocks accumulate
                        # toward its demand instead of being re-consumed
                        # by younger, smaller requests (no starvation, §9)
                        break
                    continue
                slot = free.pop(0)
                req.slot = slot
                req.admit_step = self.step
                if req.admit_time is None:    # first admission only — a
                    # preemption resume is not fresh queueing delay
                    req.admit_time = time.perf_counter()
                self.slots[slot] = req
                admitted.add(rank)
                round_admits.append(req)
                if self.prompt_chunk > 0 and \
                        req.prompt_len > self.prompt_chunk and \
                        not req.output:
                    # head-skip overlong prompts (the monolithic path's
                    # truncation, expressed as an offset so the caller's
                    # prompt is never modified). Resumed requests (committed
                    # output after preemption) always re-prefill
                    # monolithically — chunk spans index the prompt alone.
                    req.prompt_offset = 0
                    if self.max_prompt and req.prompt_len > self.max_prompt:
                        req.prompt_offset = req.prompt_len - self.max_prompt
                    req.state = RequestState.PREFILLING
                    req.prompt_pos = req.prompt_offset
                    new_chunked.append(req)
                else:
                    req.state = RequestState.RUNNING
                    new.append(req)
            self.waiting = [r for i, r in enumerate(self.waiting)
                            if i not in admitted]
        for r in self.waiting:
            r.admit_wait += 1
        # emit one prompt chunk per mid-prefill slot
        chunks: List[ChunkTask] = []
        for i, req in enumerate(self.slots):
            if group is not None and i not in group:
                continue
            if req is None or req.state is not RequestState.PREFILLING:
                continue
            start = req.prompt_pos
            end = min(start + self.prompt_chunk, req.prompt_len)
            final = end == req.prompt_len
            chunks.append(ChunkTask(slot=i, request=req, start=start,
                                    end=end, final=final))
            req.prompt_pos = end
            if final:
                # joins the decode batch this same iteration (the engine
                # samples its first token from the final chunk's logits)
                req.state = RequestState.RUNNING
        active = np.array([s is not None and s.state is RequestState.RUNNING
                           for s in self.slots])
        out = SchedulingOutput(step=self.step, active_slots=active,
                               new_requests=new, new_chunked=new_chunked,
                               chunks=chunks, slot_request=list(self.slots))
        self.step += 1
        return out

    # -- commit (§4.2 step ⑥) ---------------------------------------------------
    def commit(self, tokens: np.ndarray, slot_request: List[Optional[Request]],
               active: np.ndarray, now: float = 0.0) -> None:
        """Write sampled tokens back into request state.

        ``slot_request``/``active`` are the snapshot taken when the iteration
        was *dispatched* — under the overlapped engine the commit lands one
        step later, when the slot may already hold a different request.
        Tokens for requests that had already satisfied their stop condition
        are dropped (rollback of the speculative decode, DESIGN.md §2).
        The guard is ``Request.should_stop`` = ``finish_reason is not None``,
        so every stop class — eos, length, token-level stop sequences,
        truncation — rolls back its speculative decode the same way.
        """
        for i, req in enumerate(slot_request):
            if req is None or not active[i] or req.should_stop():
                continue
            req.record_token(int(tokens[i]), now)
