"""Synthetic token pipeline for LM training examples and tests: the port
of ``repro.data.lm_data``.

A deterministic Zipf-ish Markov stream: learnable structure (so a ~100M
model's loss visibly drops within a few hundred steps) without external
data. The same ``numpy`` generator as the reference's, so a seed draws
the same tokens in both packages; :func:`batches` puts them on a device,
:func:`sharded_batches` lays them out over a mesh of devices.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device


class MarkovTokens:
    """Order-1 Markov chain over the vocab with Zipf marginals."""

    def __init__(self, vocab: int, seed: int = 0, branch: int = 16):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        # Each token transitions to `branch` successors with Zipf weights.
        self.succ = rng.integers(0, vocab, size=(vocab, branch))
        w = 1.0 / np.arange(1, branch + 1)
        self.w = w / w.sum()
        self.rng = rng

    def sample(self, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq + 1), np.int32)
        cur = self.rng.integers(0, self.vocab, size=batch)
        out[:, 0] = cur
        for t in range(1, seq + 1):
            choice = self.rng.choice(len(self.w), size=batch, p=self.w)
            cur = self.succ[cur, choice]
            out[:, t] = cur
        return out


def batches(vocab: int, batch: int, seq: int, n_steps: int, seed: int = 0, *, device="cuda"
            ) -> Iterator[dict[str, torch.Tensor]]:
    """``n_steps`` batches of int32 ``tokens`` and next-token ``labels``
    (batch, seq) on ``device`` (the card unless told otherwise)."""
    dev = resolve_device(device)
    gen = MarkovTokens(vocab, seed)

    def gen_batches():
        for _ in range(n_steps):
            toks = torch.from_numpy(gen.sample(batch, seq))
            yield {"tokens": toks[:, :-1].contiguous().to(dev), "labels": toks[:, 1:].contiguous().to(dev)}

    return gen_batches()


def sharded_batches(vocab: int, batch: int, seq: int, n_steps: int, sharding, seed: int = 0
                    ) -> Iterator[dict]:
    """:func:`batches` with every leaf placed by ``sharding`` (a
    :func:`~repro_torch.distributed.sharding.named` placement over a mesh
    of devices, e.g. the batch over the ``data`` axis): ``Placed`` leaves
    holding each entry's rows on its device."""
    from repro_torch.distributed.sharding import place

    for b in batches(vocab, batch, seq, n_steps, seed, device="cpu"):
        yield {k: place(v, sharding) for k, v in b.items()}
