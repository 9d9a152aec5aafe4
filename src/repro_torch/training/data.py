"""Deterministic synthetic data: a token stream a language model can
learn, and the classification stream of the cascade examples.

Counterpart of the JAX package's ``training/data.py``.
``classification_stream`` is numpy and gives the same arrays bit for bit.
``SyntheticLM`` keeps the JAX package's generative process: tokens of a
Markov chain over the first min(vocab, 4096) ids, whose next-token
logits are a low-rank transition (``_transition_logits``, numpy, the
same matrices) of the current token, 0.5 a[tok] @ b, plus a
per-sequence topic drawn from N(0, 0.25) through b; the labels are the
tokens shifted by one with -100 at the end. ``batch_at(step)`` is a pure
function of (seed, step). It draws from a ``torch.Generator`` seeded
from them, where the JAX package draws with ``jax.random``: the same
distribution, not the same bits (as ``common.trunc_normal_`` draws the
weights), so tests that compare the two packages feed both one numpy
batch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models.common import IGNORE
from repro_torch.models.model import resolve_device

MAX_EFF_VOCAB = 4096
TOPICS = 32


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _transition_logits(vocab, seed):
    rng = np.random.default_rng(seed)
    # low-rank structured transition: tokens cluster into 32 topics
    k = TOPICS
    a = rng.standard_normal((vocab, k)).astype(np.float32)
    b = rng.standard_normal((k, vocab)).astype(np.float32)
    return a, b


class SyntheticLM:
    """Batches of the synthetic token stream on ``device`` (the card by
    default; raises without one unless ``device="cpu"``)."""

    def __init__(self, cfg: DataConfig, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._eff_vocab = min(cfg.vocab_size, MAX_EFF_VOCAB)
        a, b = _transition_logits(self._eff_vocab, cfg.seed)
        self._a = torch.from_numpy(a).to(self.device)
        self._b = torch.from_numpy(b).to(self.device)

    def batch_at(self, step: int, *, batch: Optional[int] = None,
                 seq_len: Optional[int] = None):
        """{"tokens": (B, S) int32, "labels": (B, S) int32}, the same for
        the same (seed, step)."""
        b = batch or self.cfg.global_batch
        s = seq_len or self.cfg.seq_len
        gen = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed * 1_000_003 + step)
        topic = torch.randn(b, TOPICS, generator=gen,
                            device=self.device) * 0.5
        drift = topic @ self._b                                # (B, V)
        tok = torch.randint(0, self._eff_vocab, (b,), generator=gen,
                            device=self.device)
        tokens = torch.empty(b, s, dtype=torch.int32, device=self.device)
        for i in range(s):
            logits = self._a[tok] @ self._b * 0.5 + drift
            # a categorical draw by the Gumbel-max trick, as
            # jax.random.categorical draws
            u = torch.rand(logits.shape, generator=gen, device=self.device)
            tok = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
            tokens[:, i] = tok
        labels = torch.cat([tokens[:, 1:],
                            torch.full((b, 1), IGNORE, dtype=torch.int32,
                                       device=self.device)], dim=1)
        return {"tokens": tokens, "labels": labels}


def classification_stream(n: int, seq_len: int, vocab: int, n_classes: int,
                          seed: int):
    """Sequences whose label is a deterministic function of the tokens
    (last token mod n_classes — learnable in tens of steps, with residual
    hard cases when the confusable tokens dominate) — ground truth for
    the live cascade examples. Returns (tokens (n,S) int32, labels (n,))."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (n, seq_len), dtype=np.int32)
    labels = toks[:, -1] % n_classes
    return toks, labels.astype(np.int64)
