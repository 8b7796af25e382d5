"""Request lifecycle (paper Fig. 2 workflow) — port of
``repro.serving.request`` (token prompts only: the audio and vision
frontends are not ported)."""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np


class State(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    TRANSFERRING = "transferring"
    DECODING = "decoding"
    FINISHED = "finished"
    FAILED = "failed"
    # rejected by admission control before entering the cluster: terminal,
    # never dispatched, never produced a token (open-loop load shedding)
    SHED = "shed"


@dataclasses.dataclass
class Request:
    req_id: str
    prompt: np.ndarray                      # (S,) int32 token ids
    max_new_tokens: int
    # None = "stamp me at submit". An explicit value — *including 0.0*
    # (virtual-clock or epoch-relative schedules) — is the request's
    # scheduled arrival and must survive submit untouched: TTFT measures
    # from here, not from when the driver got around to enqueueing.
    arrival_time: Optional[float] = None
    # sampling
    temperature: float = 0.0                # 0 → greedy
    # lifecycle
    state: State = State.QUEUED
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    prefill_instance: str = ""
    decode_instance: str = ""
    first_token_time: Optional[float] = None
    last_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    retries: int = 0
    chunks_streamed: int = 0                # KV chunks shipped P→D
    decode_steps_at_dispatch: int = 0

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def seq_len(self) -> int:
        """Prompt + generated (the KV length)."""
        return self.prompt_len + len(self.output_tokens)

    @property
    def done(self) -> bool:
        return len(self.output_tokens) >= self.max_new_tokens

    def ttft(self) -> Optional[float]:
        if self.first_token_time is None or self.arrival_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def tpot(self) -> Optional[float]:
        if self.finish_time is None or self.first_token_time is None:
            return None
        n = max(len(self.output_tokens) - 1, 1)
        return (self.finish_time - self.first_token_time) / n
