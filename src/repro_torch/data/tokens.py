"""Deterministic, restartable synthetic token pipeline.

Batches are a pure function of (seed, step) — a counter-mode PRNG — so (a)
resuming from a checkpoint replays the exact stream (the checkpoint stores
{seed, step}), and (b) every data-parallel host can independently generate
its own shard (no coordinator), exactly how large-scale loaders index into
a global dataset order.

The synthetic LM task is next-token prediction over structured sequences
(Zipf-ish unigram mix + a copy motif) so small models show a real,
monotonically decreasing loss during the examples' training runs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class TokenStreamState:
    seed: int
    step: int

    def as_dict(self) -> Dict:
        return dict(seed=self.seed, step=self.step)

    @classmethod
    def from_dict(cls, d: Dict) -> "TokenStreamState":
        return cls(seed=int(d["seed"]), step=int(d["step"]))


class TokenStream:
    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 start_step: int = 0, n_ctx: int = 0, d_model: int = 0):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.n_ctx, self.d_model = n_ctx, d_model
        self.state = TokenStreamState(seed=seed, step=start_step)
        # Zipf-ish unigram distribution (shared across steps)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.state.seed * 1_000_003 + self.state.step) & 0x7FFFFFFF)
        toks = rng.choice(self.vocab, size=(self.batch, self.seq),
                          p=self._probs).astype(np.int32)
        # plant copy motifs: second half of some rows repeats the first
        rows = rng.random(self.batch) < 0.5
        half = self.seq // 2
        toks[rows, half:2 * half] = toks[rows, :half]
        batch = dict(tokens=toks,
                     labels=np.roll(toks, -1, axis=1).astype(np.int32))
        if self.n_ctx:
            batch["ctx"] = rng.normal(
                0, 1, size=(self.batch, self.n_ctx, self.d_model)
            ).astype(np.float32)
        self.state.step += 1
        return batch
