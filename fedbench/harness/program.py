"""The system under test: the port's `TorchTrainerHooks`, built from a
configuration file and a traffic mix, driven round by round as the sync
engine drives it (`run_local` for every client, then `aggregate` with
staleness 0), with the weights the benchmark made.

The port is imported here, in `harness/spans.py` (its spans, for the
per-layer metrics) and in each family's `port_config`
(`fedbench/families/`), and nowhere else in the benchmark.
"""
from __future__ import annotations

from typing import Dict, List

import torch

# the hooks' token stream i is seeded with seed + 17 i, which NumPy takes
# below 2**32: seeds at and above this are folded under it
HOOK_SEED_MOD = 2 ** 32 - 2 ** 10


def hook_seed(seed: int) -> int:
    return int(seed) % HOOK_SEED_MOD


def lm_fields(z: dict, cfg: dict) -> dict:
    """The port's ModelConfig fields that every family sets alike, from
    the family's sizes `z` and the configuration file."""
    return dict(num_layers=z["layers"], d_model=z["d"], vocab_size=z["v"],
                tie_embeddings=z["tied"], norm_eps=z["eps"],
                dtype=cfg["torch_dtype"], param_dtype=cfg["torch_dtype"],
                remat=cfg["remat"], logit_softcap=None, qkv_bias=False)


class Program:
    """One `TorchTrainerHooks` object, from set-up through the window."""

    def __init__(self, family, cfg: dict, mix: dict, seed: int,
                 weights: Dict[str, torch.Tensor], device="cuda"):
        from repro_torch.common.bridge import flatten_with_paths, unflatten
        from repro_torch.fl.training import TorchTrainerHooks
        port_cfg = family.port_config(cfg, mix)
        self._flatten = flatten_with_paths
        self.clients = [f"client_{i}" for i in range(mix["clients"])]
        self.hooks = TorchTrainerHooks(
            self.clients, local_steps=mix["local_steps"], batch=mix["batch"],
            seq=mix["seq"], lr=mix["lr"], quantize=mix["arm"] == "int8",
            seed=hook_seed(seed),
            weights=dict(zip(self.clients, mix["weights"])), device=device,
            cfg=port_cfg)
        have = {k: (tuple(v.shape), v.dtype)
                for k, v in flatten_with_paths(self.hooks.params)}
        want = {k: (tuple(v.shape), v.dtype) for k, v in weights.items()}
        if have != want:
            raise ValueError(f"the port's parameters differ from the "
                             f"benchmark's schema: "
                             f"{sorted(set(have.items()) ^ set(want.items()))}")
        self.hooks.params = unflatten(dict(weights))
        self.round = 0

    def run_round(self) -> None:
        """One synchronous round, as `fl/engines/sync.py` calls the hooks:
        each client's update marked, then the barrier's aggregate."""
        for c in self.clients:
            self.hooks.run_local(c, self.round)
        self.hooks.aggregate(list(self.clients), self.round, staleness=None)
        self.round += 1

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self._flatten(self.hooks.params))

    def momentum(self) -> List[Dict[str, torch.Tensor]]:
        return self.hooks.mu

    def losses(self) -> List[float]:
        """The mean loss of every round so far."""
        return [r["mean_loss"] for r in self.hooks.losses]
