"""Request lifecycle (paper Fig. 2 workflow) — port of
``repro.serving.request``. A prompt is token ids, optionally preceded by
a vision frontend's patch embeddings, or beside an audio frontend's frame
embeddings that an encoder-decoder model's encoder reads (the frontends
are stubs, as in the reference: the request carries them precomputed)."""
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
    # multimodal (STUB frontends)
    patches: Optional[np.ndarray] = None    # (P, d) vision patch embeddings
    # (F, d) audio frame embeddings, float32: the encoder's input. They
    # occupy no self-attention KV, so no length here counts them
    frames: Optional[np.ndarray] = None
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
    def num_patches(self) -> int:
        """Patch embeddings before the prompt (0 for a text request)."""
        return 0 if self.patches is None else int(self.patches.shape[0])

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

    def tpot_live(self) -> Optional[float]:
        """Per-output-token latency including *in-flight* streams: uses the
        last emitted token's timestamp when the request hasn't finished.
        The autoscaler steers on this — a completed-only sample is biased
        toward short requests and reacts a full request-length late."""
        end = self.finish_time if self.finish_time is not None \
            else self.last_token_time
        if end is None or self.first_token_time is None \
                or len(self.output_tokens) < 2:
            return None
        return (end - self.first_token_time) / (len(self.output_tokens) - 1)
