"""Synthetic LM data pipeline: sharded, deterministic, checkpointable — the
JAX package's `repro.data.pipeline`, copied (numpy only), so both packages
see the same tokens bit for bit.

Production framing without external datasets: a seeded generator produces
structured token streams (a mixture of copy/induction patterns and Zipfian
noise — learnable, so train-loss curves are meaningful), batched to the
global batch and shardable across hosts. The iterator state is a single
(seed, step) pair, so data position is restored exactly on restart —
checkpoint/resume of the *pipeline* is what matters at fleet scale, and this
keeps it byte-exact.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class DataState:
    seed: int
    step: int

    def to_dict(self):
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(int(d["seed"]), int(d["step"]))


class SyntheticLMData:
    """Deterministic synthetic LM batches.

    Each sequence: a random "program" of period-p repetition: tokens repeat
    with period p ∈ [4, 32], corrupted by Zipf noise — next-token prediction
    is learnable (copy heads) but not trivial.
    """

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1):
        assert global_batch % num_hosts == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // num_hosts
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.state = DataState(seed=seed, step=0)

    def _gen(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.state.seed * 1_000_003 + step) * 65_521 + self.host_id)
        B, S, V = self.local_batch, self.seq, self.vocab
        periods = rng.integers(4, 33, size=(B, 1))
        base = rng.integers(1, V, size=(B, 33))
        idx = np.arange(S + 1)[None, :] % periods
        toks = np.take_along_axis(
            np.broadcast_to(base, (B, 33)), idx.clip(max=32), axis=1)
        noise = rng.random((B, S + 1)) < 0.05
        toks = np.where(noise, rng.integers(1, V, size=(B, S + 1)), toks)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self._gen(self.state.step)
        self.state.step += 1
        return batch

    def restore(self, state: DataState) -> None:
        self.state = dataclasses.replace(state)
