"""Deterministic synthetic data: copies of ``MarkovLM``, ``GaussianClusters``
and ``shard_batch`` of ``repro.data.synthetic`` (numpy only), so the port
and the JAX package draw identical batches from the same seed.

They stand in for the paper's datasets at their input shapes: ``MarkovLM``
token streams for WikiText-2, ``GaussianClusters`` images for CIFAR-10."""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

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


@dataclasses.dataclass
class GaussianClusters:
    """k-class Gaussian blobs rendered as ``(H, W, C)`` images (for the
    ResNet): each image is its class's fixed center plus ``noise`` times
    standard normal noise."""

    num_classes: int = 10
    image_size: int = 16
    channels: int = 3
    seed: int = 0
    noise: float = 0.8

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        d = self.image_size * self.image_size * self.channels
        self._centers = rng.randn(self.num_classes, d).astype(np.float32)

    def sample(self, batch: int, step: int) -> Dict[str, np.ndarray]:
        """Batch ``step`` of the stream: ``images`` ``(batch, H, W, C)``
        float32 and ``labels`` ``(batch,)`` int32."""
        rng = np.random.RandomState((self.seed * 7_368_787 + step) % 2**31)
        labels = rng.randint(0, self.num_classes, size=batch)
        d = self._centers.shape[1]
        x = self._centers[labels] + self.noise * rng.randn(batch, d).astype(np.float32)
        images = x.reshape(batch, self.image_size, self.image_size, self.channels)
        return {"images": images, "labels": labels.astype(np.int32)}

    def batches(self, batch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Endless stream of :meth:`sample` batches, step 0 first."""
        step = 0
        while True:
            yield self.sample(batch, step)
            step += 1


def shard_batch(batch: dict, worker: int, num_workers: int) -> dict:
    """This worker's slice of a global batch: rows ``worker·b`` to
    ``(worker + 1)·b`` of every leaf, with ``b = n / num_workers``."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % num_workers:
            raise ValueError(f"{k}: batch {n} does not split over "
                             f"{num_workers} workers")
        per = n // num_workers
        out[k] = v[worker * per:(worker + 1) * per]
    return out
