"""Deterministic synthetic-LM data pipeline (the port of
``repro/data/pipeline.py``; numpy only, so every batch is bitwise the
reference's).

- **Deterministic and resumable**: the batch at step t is a pure function
  of (seed, t), so resuming from a checkpointed step neither replays nor
  skips data.
- **Host-sharded**: each host takes its slice of the global batch
  (``host_index``, ``host_count``); every host draws the global batch the
  same way, so the stream does not depend on the topology.
- **Static shapes**: every batch is (B, S) int32.

The tokens are Zipfian unigrams with repeated n-gram motifs written in,
so the LM loss has structure to learn without external data.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataState:
    seed: int
    step: int

    def next(self) -> "DataState":
        return DataState(self.seed, self.step + 1)


@dataclasses.dataclass(frozen=True)
class SyntheticLMData:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 16
    n_motifs: int = 64

    def _motifs(self) -> np.ndarray:
        rng = np.random.RandomState(self.seed ^ 0x5EED)
        return rng.randint(1, self.vocab,
                           size=(self.n_motifs, self.motif_len))

    def batch_at(self, step: int, *, host_index: int = 0,
                 host_count: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens, labels), each (B / host_count, S) int32: this host's
        slice of global step ``step``."""
        assert self.global_batch % host_count == 0
        per_host = self.global_batch // host_count
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step) % (2**31 - 1))
        zipf = rng.zipf(1.3, size=(self.global_batch, self.seq_len + 1))
        tokens = np.minimum(zipf, self.vocab - 1).astype(np.int32)
        motifs = self._motifs()
        n_insert = max(1, self.seq_len // (4 * self.motif_len))
        for b in range(self.global_batch):
            for _ in range(n_insert):
                m = motifs[rng.randint(self.n_motifs)]
                start = rng.randint(0, self.seq_len + 1 - self.motif_len)
                tokens[b, start:start + self.motif_len] = m
        lo = host_index * per_host
        sl = tokens[lo:lo + per_host]
        return sl[:, :-1], sl[:, 1:]

    def iterate(self, state: DataState, *, host_index: int = 0,
                host_count: int = 1) -> Iterator:
        while True:
            yield self.batch_at(state.step, host_index=host_index,
                                host_count=host_count), state
            state = state.next()


def make_pipeline(cfg, shape, seed: int = 0) -> SyntheticLMData:
    return SyntheticLMData(vocab=cfg.vocab, seq_len=shape.seq_len,
                           global_batch=shape.global_batch, seed=seed)
