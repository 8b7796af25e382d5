"""Synthetic data pipeline — deterministic, seeded, host-side token stream
(a copy of ``repro.training.data``: the same seed gives the same batches,
bit for bit, in both packages).

Produces exactly the batch dict the model entry points consume:
  {"tokens": (B,S) int32, "labels": (B,S) int32,
   "frames": (B,F,d) for enc-dec (audio stub),
   "patches": (B,P,d) for VLM (vision stub)}

Labels are next-token-shifted tokens with -1 at padding. The stream is a
Zipf-ish unigram distribution so cross-entropy decreases measurably within
a few hundred steps (uniform tokens would pin loss at log V).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    seed: int = 0
    vocab_cap: int = 0          # 0 → model vocab
    zipf_a: float = 1.3


def _frames_len(cfg: ModelConfig) -> int:
    return min(cfg.max_source_len, 64)


class SyntheticTokens:
    """Infinite iterator of training batches."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig):
        self.cfg = cfg
        self.dcfg = dcfg
        self.rng = np.random.default_rng(dcfg.seed)
        self.vocab = dcfg.vocab_cap or cfg.vocab_size
        # fixed random "bigram" table makes the stream learnable
        self._next = np.asarray(
            self.rng.integers(0, self.vocab, size=(min(self.vocab, 4096),)),
            np.int32)

    def _sample_tokens(self, b: int, s: int) -> np.ndarray:
        z = self.rng.zipf(self.dcfg.zipf_a, size=(b, s + 1)).astype(np.int64)
        toks = (z % self.vocab).astype(np.int32)
        # half the positions follow the deterministic bigram table
        follow = self.rng.random((b, s)) < 0.5
        nxt = self._next[toks[:, :-1] % len(self._next)]
        toks[:, 1:] = np.where(follow, nxt, toks[:, 1:])
        return toks

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        cfg, d = self.cfg, self.dcfg
        toks = self._sample_tokens(d.batch_size, d.seq_len)
        batch: Dict[str, np.ndarray] = {
            "tokens": toks[:, :-1].copy(),
            "labels": toks[:, 1:].copy(),
        }
        if cfg.is_enc_dec:
            f = _frames_len(cfg)
            batch["frames"] = self.rng.standard_normal(
                (d.batch_size, f, cfg.d_model)).astype(np.float32) * 0.02
        if cfg.frontend.kind == "vision":
            p = min(cfg.frontend.num_patches, 16)
            batch["patches"] = self.rng.standard_normal(
                (d.batch_size, p, cfg.d_model)).astype(np.float32) * 0.02
        return batch
