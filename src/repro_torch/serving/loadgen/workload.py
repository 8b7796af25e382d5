"""Request synthesis for the open-loop harness — port of
``repro.serving.loadgen.workload`` (same draws in the same order).

Prompt and output lengths follow independent clamped log-normal
distributions — the ShareGPT-like shape (many short exchanges, a heavy
tail of long ones) that serving papers benchmark against, scaled down by
the caller's clamps so the same generator drives both the tiny CI model
and a real config. Deterministic under a seed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.serving.request import Request


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """Length mixture + vocab for synthesized requests. The log-normal
    (mu, sigma) are in log-token space; samples are clamped to
    [min, max] so the tail cannot exceed an engine's max_seq_len."""
    vocab_size: int = 512
    prompt_mu: float = 2.6          # median ≈ e^2.6 ≈ 13 tokens
    prompt_sigma: float = 0.4
    prompt_min: int = 4
    prompt_max: int = 32
    output_mu: float = 1.8          # median ≈ 6 tokens
    output_sigma: float = 0.5
    output_min: int = 2
    output_max: int = 16
    # multimodal mix: fraction of requests carrying encoder input and the
    # modality payload sizes. modality "audio" attaches ``frames``
    # (encoder source positions, fixed length — a Whisper-style resampled
    # window), "vision" attaches ``patches`` (drawn uniformly from
    # [patch_min, patch_max] — images vary in tiling). ``encoder_d``
    # is the embedding width of the synthesized frame/patch rows; it must
    # match the target engine's d_model.
    multimodal_fraction: float = 0.0
    modality: str = "audio"         # "audio" | "vision"
    encoder_d: int = 64
    frame_len: int = 10
    patch_min: int = 2
    patch_max: int = 8


@dataclasses.dataclass
class ScheduledRequest:
    """One workload item: a request plus its scheduled arrival offset
    (seconds from the run epoch). The offset is kept outside the request
    so ``Request.arrival_time`` can be rebased to the host monotonic
    clock at run start without losing the schedule."""
    offset_s: float
    request: Request


def _clamped_lognormal(rng: np.random.Generator, n: int, mu: float,
                       sigma: float, lo: int, hi: int) -> np.ndarray:
    ln = rng.lognormal(mu, sigma, size=n)
    return np.clip(np.rint(ln).astype(np.int64), lo, hi)


def build_workload(offsets: List[float], cfg: Optional[WorkloadConfig] = None,
                   seed: int = 0, id_prefix: str = "load"
                   ) -> List[ScheduledRequest]:
    """One request per arrival offset, lengths drawn from ``cfg``'s
    mixture. Same (offsets, cfg, seed) → identical prompts and lengths."""
    cfg = cfg or WorkloadConfig()
    rng = np.random.default_rng(seed)
    n = len(offsets)
    p_lens = _clamped_lognormal(rng, n, cfg.prompt_mu, cfg.prompt_sigma,
                                cfg.prompt_min, cfg.prompt_max)
    o_lens = _clamped_lognormal(rng, n, cfg.output_mu, cfg.output_sigma,
                                cfg.output_min, cfg.output_max)
    mm = rng.random(n) < cfg.multimodal_fraction
    out = []
    for i, off in enumerate(sorted(offsets)):
        prompt = rng.integers(0, cfg.vocab_size,
                              int(p_lens[i])).astype(np.int32)
        frames = patches = None
        if mm[i]:
            if cfg.modality == "audio":
                frames = rng.standard_normal(
                    (cfg.frame_len, cfg.encoder_d)).astype(np.float32)
            else:
                np_i = int(rng.integers(cfg.patch_min, cfg.patch_max + 1))
                patches = rng.standard_normal(
                    (np_i, cfg.encoder_d)).astype(np.float32)
        out.append(ScheduledRequest(
            offset_s=float(off),
            request=Request(req_id=f"{id_prefix}-{i:04d}", prompt=prompt,
                            max_new_tokens=int(o_lens[i]), frames=frames,
                            patches=patches)))
    return out
