"""The system under test: the port's `TorchTrainerHooks`, built from a
configuration file and a traffic mix, driven round by round as the sync
engine drives it (`run_local` for every client, then `aggregate` with
staleness 0), with the weights the benchmark made.

This is the one module of the benchmark that imports the port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from fedbench.reference.schema import dims

# the hooks' token stream i is seeded with seed + 17 i, which NumPy takes
# below 2**32: seeds at and above this are folded under it
HOOK_SEED_MOD = 2 ** 32 - 2 ** 10


def hook_seed(seed: int) -> int:
    return int(seed) % HOOK_SEED_MOD


def port_config(cfg: dict):
    """The port's ModelConfig of the configuration file: the port's model
    of that family with every size the file states."""
    from repro_torch import configs
    from repro_torch.common.config import SSMConfig
    z = dims(cfg)
    base = configs.get_config(cfg["port_model"])
    if base.pattern != (z["kind"],):
        raise ValueError(f"{cfg['port_model']}: pattern {base.pattern}, the "
                         f"file describes {z['kind']} layers")
    fields = dict(num_layers=z["layers"], d_model=z["d"], vocab_size=z["v"],
                  tie_embeddings=z["tied"], norm_eps=z["eps"],
                  dtype=cfg["torch_dtype"], param_dtype=cfg["torch_dtype"],
                  remat=cfg["remat"], logit_softcap=None, qkv_bias=False)
    if z["kind"] == "attn":
        fields.update(num_heads=z["n"], num_kv_heads=z["k"], head_dim=z["h"],
                      d_ff=z["f"], rope_theta=z["theta"], mlp_kind="swiglu",
                      moe=None)
    else:
        fields.update(d_ff=0, moe=None, ssm=SSMConfig(
            d_state=z["n"], head_dim=z["p"], expand=z["d_in"] // z["d"],
            conv_width=z["conv"], n_groups=z["g"], chunk_size=z["chunk"],
            dt_min=z["dt_min"], dt_max=z["dt_max"],
            a_init_range=z["a_range"]))
    return dataclasses.replace(base, **fields)


class Program:
    """One `TorchTrainerHooks` object, from set-up through the window."""

    def __init__(self, cfg: dict, mix: dict, seed: int,
                 weights: Dict[str, torch.Tensor], device="cuda"):
        from repro_torch.common.bridge import flatten_with_paths, unflatten
        from repro_torch.fl.training import TorchTrainerHooks
        window = cfg.get("sliding_window")
        if window is not None and mix["seq"] > window:
            raise ValueError(f"seq {mix['seq']} passes the configuration's "
                             f"sliding window of {window}, which the port "
                             f"does not apply")
        self._flatten = flatten_with_paths
        self.clients = [f"client_{i}" for i in range(mix["clients"])]
        self.hooks = TorchTrainerHooks(
            self.clients, local_steps=mix["local_steps"], batch=mix["batch"],
            seq=mix["seq"], lr=mix["lr"], quantize=mix["arm"] == "int8",
            seed=hook_seed(seed),
            weights=dict(zip(self.clients, mix["weights"])), device=device,
            cfg=port_config(cfg))
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
