"""End-to-end paper reproduction driver on the port (the paper's kind:
FL training with cost-aware scheduling), the counterpart of the JAX
package's `examples/paper_reproduction.py`.

Runs the full MNIST row of Table I with real training attached: 3
clients train the paper's two-layer CNN on a dual-Dirichlet non-IID
partition while the simulator accrues dollar costs under all three
policies; then prints the Table-I-style comparison and the global
model's accuracy. It trains on the card unless asked for the CPU:

    PYTHONPATH=src python -m repro_torch.examples.paper_reproduction \
        [--device cpu|cuda]

`federation` and `run_policy` build the same run for any dataset of
`DATASET_SPECS` and its model in `MODELS` (`chip_smoke.py` runs them).
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.checkpoint.store import MemoryStore
from repro_torch.common.bridge import leaves
from repro_torch.common.config import CloudConfig, ClientProfile, FLRunConfig
from repro_torch.data.partition import dual_dirichlet_partition
from repro_torch.data.synthetic import (DATASET_SPECS, ImageDataset,
                                        make_dataset, minibatches)
from repro_torch.fl.client import FLClient
from repro_torch.fl.runner import FLCloudRunner
from repro_torch.fl.server import FederatedServer, ServerTrainerHooks
from repro_torch.models import cnn
from repro_torch.optim.optimizers import adamw

N_EPOCHS = 10          # paper: MNIST, 3 clients, 10 epochs
EPOCH_S = (818.0, 511.0, 348.0)          # derived in benchmarks/table1.py
POLICIES = ("on_demand", "spot", "fedcostaware")
PAPER = {"on_demand": 6.9489, "spot": 2.7174, "fedcostaware": 2.2901}
# the paper's model of each dataset (Table I)
MODELS = {"mnist": "small_cnn", "cifar10": "resnet18",
          "aireadi": "resnet50", "isic2019": "efficientnet"}
CLOUD = CloudConfig(on_demand_rate=1.0060, spot_rate_mean=0.3937 / 0.98,
                    spot_rate_sigma=0.0, spin_up_mean_s=160.0,
                    spin_up_sigma=0.0)


class Federation:
    """One dataset's row: its data and dual-Dirichlet partition over 3
    clients, the initial model, and the client profiles."""

    def __init__(self, dataset: str = "mnist", n: int = 1500,
                 device="cuda"):
        img, ch, _ = DATASET_SPECS[dataset]
        self.dataset = dataset
        self.device = device
        self.ds: ImageDataset = make_dataset(dataset, n, seed=0)
        self.parts = dual_dirichlet_partition(
            self.ds.y, 3, alpha_class=1.0, alpha_volume=2.0, seed=0)
        self.params0, self.apply_fn, _ = cnn.build(
            MODELS[dataset], torch.Generator().manual_seed(0),
            self.ds.n_classes, ch, img, device=device)
        self.store = MemoryStore()
        self.profiles = tuple(
            ClientProfile(f"client_{i}", mean_epoch_s=EPOCH_S[i],
                          cold_multiplier=1.12, jitter=0.0,
                          n_samples=len(self.parts[i]))
            for i in range(3))

    def clients(self) -> Dict[str, FLClient]:
        out = {}
        for i, idx in enumerate(self.parts):
            def data_fn(r, idx=idx, i=i):
                return minibatches(self.ds, idx, 32, seed=100 * r + i)
            c = FLClient(f"client_{i}", self.apply_fn, adamw(lr=1e-3),
                         data_fn, len(idx),
                         checkpointer=Checkpointer(self.store),
                         checkpoint_every=5, device=self.device)
            out[c.name] = c
        return out

    def hooks(self) -> ServerTrainerHooks:
        return ServerTrainerHooks(FederatedServer(self.params0),
                                  self.clients(), device=self.device)

    def accuracy(self, params, n: int = 512) -> float:
        dev = leaves(params)[0].device
        with torch.no_grad():
            logits = self.apply_fn(params,
                                   torch.from_numpy(self.ds.x[:n]).to(dev))
        y = torch.from_numpy(self.ds.y[:n]).to(dev, torch.int64)
        return float(torch.mean((torch.argmax(logits, -1) == y).float()))


def run_policy(fed: Federation, policy: str, hooks, n_epochs: int = N_EPOCHS,
               record: bool = False):
    """One run of the port's runner over `hooks`: its `RunResult`, and
    its event trace when `record`."""
    cfg = FLRunConfig(dataset=fed.dataset, clients=fed.profiles,
                      n_epochs=n_epochs, policy=policy)
    runner = FLCloudRunner(cfg, cloud_cfg=CLOUD, hooks=hooks, record=record)
    res = runner.run()
    return res, (runner.recorder.dumps() if record else None)


def run(device="cuda", record: bool = False) -> Tuple[Federation, List[dict]]:
    """The MNIST row under every policy: one dict a policy with its
    result, trace (when `record`), trained server and accuracy."""
    fed = Federation("mnist", 1500, device)
    rows = []
    for policy in POLICIES:
        hooks = fed.hooks()
        res, trace = run_policy(fed, policy, hooks, record=record)
        rows.append({"policy": policy, "result": res, "trace": trace,
                     "server": hooks.server,
                     "acc": fed.accuracy(hooks.server.params)})
    return fed, rows


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, rows = run(args.device)
    print("policy,total_cost,paper_cost,savings_vs_od,final_acc")
    od_cost = None
    for row in rows:
        policy, res = row["policy"], row["result"]
        od_cost = res.total_cost if policy == "on_demand" else od_cost
        sav = "" if policy == "on_demand" else \
            f"{100 * (1 - res.total_cost / od_cost):.1f}%"
        print(f"{policy},{res.total_cost:.4f},{PAPER[policy]},{sav},"
              f"{row['acc']:.3f}")


if __name__ == "__main__":
    main()
