"""Synthetic data substrate, a numpy copy of the JAX package's
`data/synthetic.py`, so both packages draw identical data from one seed.

Two generators:
  * `image_classification` — Gaussian class-prototype images standing in
    for MNIST / CIFAR-10 / AI-READI / Fed-ISIC2019 (the learning problem
    is real: clients reduce their loss and the global model separates
    classes).
  * `token_stream` — LM token batches for the LM training hooks.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class ImageDataset:
    x: np.ndarray        # (n, h, w, c) float32
    y: np.ndarray        # (n,) int32
    n_classes: int

    def __len__(self):
        return len(self.y)


def image_classification(n: int, img: int = 28, channels: int = 1,
                         n_classes: int = 10, noise: float = 0.35,
                         seed: int = 0) -> ImageDataset:
    rng = np.random.RandomState(seed)
    protos = rng.randn(n_classes, img, img, channels).astype(np.float32)
    y = rng.randint(0, n_classes, size=n).astype(np.int32)
    x = protos[y] + noise * rng.randn(n, img, img, channels).astype(np.float32)
    return ImageDataset(x.astype(np.float32), y, n_classes)


DATASET_SPECS = {
    # name: (img, channels, classes)  — shapes scaled to CPU-runnable sizes
    "mnist": (28, 1, 10),
    "cifar10": (32, 3, 10),
    "aireadi": (48, 3, 4),       # retinal fundus -> device category (4 src)
    "isic2019": (64, 3, 8),      # melanoma classes
}


def make_dataset(name: str, n: int, seed: int = 0) -> ImageDataset:
    img, ch, ncls = DATASET_SPECS[name]
    return image_classification(n, img, ch, ncls, seed=seed)


def minibatches(ds: ImageDataset, idx: np.ndarray, batch: int,
                seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.RandomState(seed)
    order = rng.permutation(idx)
    for i in range(0, len(order) - batch + 1, batch):
        sel = order[i:i + batch]
        yield ds.x[sel], ds.y[sel]


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
