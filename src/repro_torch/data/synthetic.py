"""Deterministic synthetic LM data: a copy of ``repro.data.synthetic.MarkovLM``
(numpy only), so the port and the JAX package draw identical batches from
the same seed."""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class MarkovLM:
    """Order-k Markov chain token stream with a peaked transition table.

    ``order=2`` (default) keys the transition on the last *two* tokens;
    ``order=1`` on the previous token only (learnable within tens of
    steps).  ``clusters > 0`` makes transitions depend on token % clusters
    only, so gradients are genuinely low-rank."""

    vocab: int
    seed: int = 0
    branching: int = 4  # plausible next-tokens per context
    order: int = 2
    clusters: int = 0

    def __post_init__(self):
        if self.order not in (1, 2):
            raise ValueError(f"order must be 1 or 2, got {self.order}")
        rng = np.random.RandomState(self.seed)
        self._mix = rng.randint(1, 2**31 - 1, size=3)

    def _ctx(self, c):
        return c % self.clusters if self.clusters else c

    def sample(self, batch: int, seq: int, step: int) -> np.ndarray:
        """``(batch, seq + 1)`` int32 tokens; batch ``step`` of the stream."""
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % 2**31)
        out = np.empty((batch, seq + 1), dtype=np.int32)
        c1 = rng.randint(0, self.vocab, size=batch)
        c2 = rng.randint(0, self.vocab, size=batch)
        out[:, 0] = c1
        out[:, 1] = c2
        choices = rng.randint(0, self.branching, size=(batch, seq - 1))
        noise = rng.rand(batch, seq - 1) < 0.05  # 5% uniform noise
        noise_tok = rng.randint(0, self.vocab, size=(batch, seq - 1))
        a, b, c = self._mix
        for t in range(seq - 1):
            base = (self._ctx(c1) * a * (self.order > 1)
                    + self._ctx(c2) * b) % (2**31 - 1)
            nxt = (base + choices[:, t] * c) % self.vocab
            nxt = np.where(noise[:, t], noise_tok[:, t], nxt)
            out[:, t + 2] = nxt
            c1, c2 = c2, nxt
        return out

    def batches(self, batch: int, seq: int) -> Iterator[dict]:
        """Endless stream of numpy batches ``{"tokens", "labels"}``, each
        ``(batch, seq)``: batch ``step`` of :meth:`sample`, step 0 first,
        split into inputs and next-token labels."""
        step = 0
        while True:
            toks = self.sample(batch, seq, step)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
            step += 1
