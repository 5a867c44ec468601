"""Quickstart: cost-aware federated learning on the port, the counterpart
of the JAX package's `examples/quickstart.py`.

Three clients with heterogeneous speeds train a real CNN under the
FedCostAware scheduler on the simulated cloud; compares dollar cost
against plain-spot and on-demand. It trains on the card unless asked
for the CPU:

    PYTHONPATH=src python -m repro_torch.examples.quickstart \
        [--device cpu|cuda]
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from repro_torch.common.config import ClientProfile, FLRunConfig
from repro_torch.data.partition import dual_dirichlet_partition
from repro_torch.data.synthetic import make_dataset, minibatches
from repro_torch.fl.client import FLClient
from repro_torch.fl.runner import FLCloudRunner
from repro_torch.fl.server import FederatedServer, ServerTrainerHooks
from repro_torch.models import cnn
from repro_torch.optim.optimizers import adamw


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    # -- data: non-IID partition over 3 clients --------------------------
    ds = make_dataset("mnist", 900, seed=0)
    parts = dual_dirichlet_partition(ds.y, 3, alpha_class=2.0, seed=0)

    # -- model + FL clients -----------------------------------------------
    params, apply_fn, _ = cnn.build("small_cnn",
                                    torch.Generator().manual_seed(0),
                                    ds.n_classes, 1, 28, device=device)
    clients = {}
    for i, idx in enumerate(parts):
        def data_fn(r, idx=idx, i=i):
            return minibatches(ds, idx, 32, seed=100 * r + i)
        c = FLClient(f"client_{i}", apply_fn, adamw(lr=1e-3), data_fn,
                     len(idx), device=device)
        clients[c.name] = c

    # -- heterogeneous cloud profiles: client_0 is the straggler ---------
    profiles = tuple(
        ClientProfile(f"client_{i}", mean_epoch_s=900 / (i + 1), jitter=0.0,
                      n_samples=len(parts[i]))
        for i in range(3))

    for policy in ("on_demand", "spot", "fedcostaware", "fedcostaware_async"):
        server = FederatedServer(params)
        hooks = ServerTrainerHooks(server, clients, device=device)
        cfg = FLRunConfig(dataset="mnist", clients=profiles, n_epochs=5,
                          policy=policy)
        res = FLCloudRunner(cfg, hooks=hooks).run()
        loss = server.history[-1]["mean_client_loss"]
        print(f"{policy:14s} cost=${res.total_cost:6.3f} "
              f"makespan={res.makespan_s/60:5.1f}min final_loss={loss:.4f}")


if __name__ == "__main__":
    main()
