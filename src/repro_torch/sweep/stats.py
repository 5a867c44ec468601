"""Per-cell summary statistics: mean, percentiles, bootstrap CI.

A sweep cell is a handful of seeds (5-30), far too few for normal
approximations on cost distributions that preemption makes heavy-tailed
— so the confidence interval on the mean comes from a seeded
percentile bootstrap instead. The bootstrap RNG is seeded from the
data-independent `seed` argument, keeping the whole report
deterministic: two runs of the same sweep produce byte-identical JSON.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

DEFAULT_N_BOOT = 1000


def bootstrap_ci(values: Sequence[float], seed: int = 0,
                 n_boot: int = DEFAULT_N_BOOT,
                 level: float = 0.95) -> Tuple[float, float]:
    """Percentile-bootstrap CI for the mean of `values`: resample with
    replacement `n_boot` times (seeded), take the (1-level)/2 and
    1-(1-level)/2 quantiles of the resampled means. A single value
    collapses the interval to that value."""
    x = np.asarray(values, dtype=np.float64)
    if len(x) == 0:
        raise ValueError("bootstrap_ci needs at least one value")
    if len(x) == 1:
        return float(x[0]), float(x[0])
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, len(x), size=(n_boot, len(x)))
    means = x[idx].mean(axis=1)
    alpha = (1.0 - level) / 2.0
    lo, hi = np.percentile(means, [100.0 * alpha, 100.0 * (1 - alpha)])
    return float(lo), float(hi)


def summarize(values: Sequence[float], seed: int = 0,
              n_boot: int = DEFAULT_N_BOOT) -> Dict[str, float]:
    """The per-cell record the report stores for one metric: mean,
    p10/p50/p90, bootstrap CI bounds, and the sample count."""
    x = np.asarray(values, dtype=np.float64)
    lo, hi = bootstrap_ci(x, seed=seed, n_boot=n_boot)
    return {
        "mean": float(x.mean()),
        "p10": float(np.percentile(x, 10.0)),
        "p50": float(np.percentile(x, 50.0)),
        "p90": float(np.percentile(x, 90.0)),
        "ci_lo": lo,
        "ci_hi": hi,
        "n": int(len(x)),
    }
