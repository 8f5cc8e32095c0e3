"""Deterministic, shardable synthetic token pipeline.

Production shape without production data: an order-1 Markov stream with
a per-(host, cursor) seeded generator, so

  * every data-parallel shard reads a disjoint deterministic slice,
  * a restart from a checkpointed ``cursor`` reproduces the exact stream,
  * the chain has enough structure that a ~100M model's loss visibly
    drops within a few hundred steps (examples/train_lm.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    batch_size: int              # per-host batch
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    cursor: int = 0              # number of batches already emitted
    latent_k: int = 0            # latent alphabet size (0 -> min(256, V))

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # order-1 Markov structure over a small latent alphabet, embedded
        # into the vocab by a fixed injective map (so the conditional
        # structure is learnable within a few hundred steps)
        k = self.latent_k or min(256, self.vocab_size)
        k = min(k, self.vocab_size)
        raw = rng.dirichlet(np.full(k, 0.05), size=k)
        self._trans = raw / raw.sum(1, keepdims=True)
        self._k = k
        self._vocab_map = rng.permutation(self.vocab_size)[:k]

    def _batch_rng(self, cursor: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed, self.host_id, self.num_hosts, cursor))

    def next_batch(self) -> dict:
        """Returns {"tokens": [B, S+1] int32} and advances the cursor."""
        rng = self._batch_rng(self.cursor)
        B, S, k = self.batch_size, self.seq_len, self._k
        toks = np.empty((B, S + 1), np.int64)
        state = rng.integers(0, k, size=B)
        toks[:, 0] = state
        # vectorized Markov walk via inverse-CDF sampling
        cdf = np.cumsum(self._trans, axis=1)
        for t in range(1, S + 1):
            u = rng.random(B)
            state = (cdf[state] < u[:, None]).sum(1)
            toks[:, t] = state
        toks = self._vocab_map[toks]
        self.cursor += 1
        return {"tokens": toks.astype(np.int32)}

    def state(self) -> dict:
        return {"cursor": self.cursor, "seed": self.seed,
                "host_id": self.host_id, "num_hosts": self.num_hosts}

    @classmethod
    def from_state(cls, vocab_size: int, seq_len: int, batch_size: int,
                   state: dict) -> "TokenPipeline":
        return cls(vocab_size=vocab_size, seq_len=seq_len,
                   batch_size=batch_size, seed=state["seed"],
                   host_id=state["host_id"], num_hosts=state["num_hosts"],
                   cursor=state["cursor"])
