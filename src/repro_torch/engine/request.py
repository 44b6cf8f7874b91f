"""Request lifecycle for the serving engine."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.config import SamplingConfig


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILLING = "prefilling"   # admitted; prompt being prefilled in chunks
    RUNNING = "running"
    FINISHED = "finished"


@dataclass
class Request:
    request_id: int
    prompt: List[int]
    max_new_tokens: int
    sampling: SamplingConfig = SamplingConfig()
    eos_token: Optional[int] = None
    arrival_time: float = 0.0

    # runtime state
    state: RequestState = RequestState.WAITING
    output: List[int] = field(default_factory=list)
    slot: int = -1
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    token_times: List[float] = field(default_factory=list)
    prompt_pos: int = 0      # next prompt index to prefill (chunked path)
    prompt_offset: int = 0   # head tokens skipped at admission (chunked path)
    admit_wait: int = 0      # schedule() calls spent waiting (admission aging)
    admit_step: int = -1     # scheduler step of the latest admission
    admit_time: Optional[float] = None  # wall clock of the FIRST admission —
    #                          TTFT decomposes into queueing delay
    #                          (admit_time − arrival_time) + prefill
    #                          (benchmarks/fig_latency.py)
    preempt_count: int = 0   # times evicted under KV-block pressure (§9)
    truncated: bool = False  # stopped at cache capacity (paged decode, §9)
    kv_payload: Optional[object] = None  # carried KV from a migration
    #                          export (engine.migration.KVPayload) —
    #                          consumed (set back to None) when admission
    #                          installs it, so a later preemption falls
    #                          back to recompute-on-resume (DESIGN.md §18)
    handoff_count: int = 0   # completed cross-instance migrations (§18)

    def record_token(self, tok: int, now: float) -> None:
        """Commit one sampled token into request state (single source of
        truth for output/timing bookkeeping — engine and scheduler share it)."""
        if not self.output:
            self.first_token_time = now
        self.output.append(tok)
        self.token_times.append(now)
        if self.should_stop():
            self.finish_time = now

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    def context_tokens(self) -> List[int]:
        """Effective prompt plus committed output — the sequence a resume
        re-prefills. Honors ``prompt_offset`` so a head-skipped chunked
        prompt resumes over exactly the window it originally prefilled
        (bit-identity through preemption, DESIGN.md §9)."""
        return list(self.prompt[self.prompt_offset:]) + list(self.output)

    @property
    def done(self) -> bool:
        return self.state == RequestState.FINISHED

    @property
    def finish_reason(self) -> Optional[str]:
        """Why the request is (or is about to be) finished — the single
        stop-condition oracle of the service API (DESIGN.md §11); ``None``
        while generation should continue.

          "truncated"  stopped at KV-cache capacity (paged decode, §9)
          "eos"        last committed token is the request's eos token
          "stop"       committed output ends with one of
                       ``sampling.stop_sequences`` (token-level match over
                       output only; matched tokens stay in ``output``)
          "length"     ``max_new_tokens`` committed
        """
        if self.truncated:
            return "truncated"
        if self.output:
            if self.eos_token is not None and \
                    self.output[-1] == self.eos_token:
                return "eos"
            for seq in self.sampling.stop_sequences:
                n = len(seq)
                if n and len(self.output) >= n and \
                        tuple(self.output[-n:]) == seq:
                    return "stop"
        if len(self.output) >= self.max_new_tokens:
            return "length"
        return None

    def should_stop(self) -> bool:
        return self.finish_reason is not None
