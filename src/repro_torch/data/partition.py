"""Dual-Dirichlet non-IID federated partitioner (paper §IV-A).

The paper partitions MNIST / CIFAR-10 / AI-READI "using a dual Dirichlet
method [FedCompass] to simulate non-IID heterogeneous data, modeling both
class imbalance and variation in client data volume":

  1. client volume   ~ Dirichlet(alpha_vol * 1_K)   -> samples per client
  2. class mixture_k ~ Dirichlet(alpha_cls * 1_C)   -> per-client class dist

Fed-ISIC2019 keeps its natural (institution) partition — modeled here by
explicit per-client fractions.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def dual_dirichlet_partition(labels: np.ndarray, n_clients: int,
                             alpha_class: float = 0.5,
                             alpha_volume: float = 2.0,
                             seed: int = 0,
                             min_per_client: int = 8) -> List[np.ndarray]:
    """Returns per-client index arrays covering a subset of `labels`."""
    rng = np.random.RandomState(seed)
    n = len(labels)
    classes = np.unique(labels)
    by_class = {c: rng.permutation(np.where(labels == c)[0])
                for c in classes}
    heads = {c: 0 for c in classes}

    volumes = rng.dirichlet([alpha_volume] * n_clients)
    volumes = np.maximum(volumes, min_per_client / n)
    volumes = volumes / volumes.sum()
    counts = np.floor(volumes * n).astype(int)

    out = []
    for ci in range(n_clients):
        mix = rng.dirichlet([alpha_class] * len(classes))
        want = np.floor(mix * counts[ci]).astype(int)
        idx: List[int] = []
        for k, c in enumerate(classes):
            take = min(want[k], len(by_class[c]) - heads[c])
            idx.extend(by_class[c][heads[c]:heads[c] + take])
            heads[c] += take
        # top up from whatever classes still have samples
        need = counts[ci] - len(idx)
        for c in classes:
            if need <= 0:
                break
            take = min(need, len(by_class[c]) - heads[c])
            idx.extend(by_class[c][heads[c]:heads[c] + take])
            heads[c] += take
            need -= take
        rng.shuffle(idx)
        out.append(np.asarray(idx, np.int64))
    return out


def natural_partition(labels: np.ndarray, fractions: Sequence[float],
                      seed: int = 0) -> List[np.ndarray]:
    """Institution-style split with fixed volume fractions (Fed-ISIC2019)."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(labels))
    fr = np.asarray(fractions, np.float64)
    fr = fr / fr.sum()
    bounds = np.floor(np.cumsum(fr) * len(labels)).astype(int)
    out, lo = [], 0
    for hi in bounds:
        out.append(idx[lo:hi])
        lo = hi
    return out
