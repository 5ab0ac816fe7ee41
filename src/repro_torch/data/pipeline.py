"""Deterministic, resumable synthetic data pipeline.

Port of `repro.data.pipeline`.  `SyntheticLM` is numpy only and copied
as it is, so its batches are bit for bit the JAX package's: a pure
function of (seed, step), so restart and elastic resume need no loader
state beyond the step counter (the checkpoint records it).  The stream
is a fixed random first-order Markov chain over the vocab, so training
measurably learns (loss drops from ln V toward the chain's conditional
entropy).  `device_batches` yields torch int64 tensors on an explicit
device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 4          # out-degree of the Markov chain

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # each token has `branching` likely successors
        self.succ = rng.integers(
            0, self.vocab_size, (self.vocab_size, self.branching)
        )

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed + 1) * 1_000_003 + step)
        B, S = self.global_batch, self.seq_len
        toks = np.empty((B, S + 1), dtype=np.int64)
        toks[:, 0] = rng.integers(0, self.vocab_size, B)
        choices = rng.integers(0, self.branching, (B, S))
        noise = rng.random((B, S)) < 0.05
        rand_tok = rng.integers(0, self.vocab_size, (B, S))
        for t in range(S):
            nxt = self.succ[toks[:, t], choices[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
        }

    def conditional_entropy(self) -> float:
        """Entropy of the next-token distribution (nats) — the loss floor."""
        p_succ = 0.95 / self.branching
        h = -self.branching * p_succ * np.log(p_succ)
        h += -0.05 * np.log(0.05 / self.vocab_size)
        return float(h)


def device_batches(
    source: SyntheticLM,
    start_step: int,
    device: DeviceLike = None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """`source`'s batches from `start_step` on, as int64 tensors on
    `device` (the CUDA card by default)."""
    dev = resolve_device(device)
    step = start_step
    while True:
        yield {k: torch.from_numpy(v).to(device=dev, dtype=torch.int64)
               for k, v in source.batch_at(step).items()}
        step += 1
