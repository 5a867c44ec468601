"""Synthetic LM token batches: a numpy copy of the JAX package's
`data/synthetic.py::token_stream`, so both packages draw identical
batches from one seed."""
from __future__ import annotations

from typing import Iterator

import numpy as np


def token_stream(vocab: int, batch: int, seq: int, seed: int = 0
                 ) -> Iterator[dict]:
    """Markov-ish synthetic token batches (next-token predictable)."""
    rng = np.random.RandomState(seed)
    # sparse deterministic transition table makes loss reducible
    trans = rng.randint(0, vocab, size=(vocab,)).astype(np.int32)
    while True:
        start = rng.randint(0, vocab, size=(batch, 1)).astype(np.int32)
        seqs = [start[:, 0]]
        for _ in range(seq):
            nxt = trans[seqs[-1]]
            flip = rng.rand(batch) < 0.1
            nxt = np.where(flip, rng.randint(0, vocab, size=batch), nxt)
            seqs.append(nxt.astype(np.int32))
        arr = np.stack(seqs, axis=1)
        yield {"tokens": arr[:, :-1], "labels": arr[:, 1:]}
