"""FL in the mesh: federated training of a transformer LM whose clients
are stacked on one device, the port's counterpart of the JAX package's
`examples/mesh_fl_lm.py` (where each client is a pod of a device mesh).

Two clients (client 0 holding 3x the data) train phi3-mini SMOKE for 6
synchronous rounds of 4 local steps on 8 x 32 token batches; the FedAvg
barrier leaves both with the identical model (asserted). It runs on the
card unless asked for the CPU:

    PYTHONPATH=src python -m repro_torch.examples.mesh_fl_lm \
        [--device cpu|cuda]
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.common.bridge import leaves, tree_map
from repro_torch.common.device import require_device
from repro_torch.data.synthetic import token_stream
from repro_torch.fl import mesh_fl
from repro_torch.models import lm

N_CLIENTS = 2
LOCAL_STEPS = 4
ROUNDS = 6
B_LOCAL, SEQ = 8, 32


def main(argv: Optional[List[str]] = None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = require_device(ap.parse_args(argv).device, "mesh_fl_lm")

    cfg = configs.get_config("phi3-mini-3.8b", smoke=True)
    params = lm.init_params(cfg, seed=0, device=dev)
    params_stk = mesh_fl.stack_params_for_clients(params, N_CLIENTS)
    mu_stk = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=dev), params_stk)
    weights = torch.tensor([3.0, 1.0], device=dev)  # client 0 has 3x the data

    round_step = mesh_fl.make_fl_round_step(
        cfg, opt=5e-3, local_steps=LOCAL_STEPS, compressed=False)
    streams = [token_stream(cfg.vocab_size, B_LOCAL, SEQ, seed=i)
               for i in range(N_CLIENTS)]

    for r in range(ROUNDS):
        rows = [[next(s) for _ in range(LOCAL_STEPS)] for s in streams]
        batch = {k: torch.from_numpy(np.stack([np.stack([b[k] for b in c])
                                               for c in rows])).long().to(dev)
                 for k in ("tokens", "labels")}
        params_stk, mu_stk, losses = round_step(params_stk, mu_stk, batch,
                                                weights)
        print(f"round {r}: per-client loss = "
              + ", ".join(f"{float(l):.3f}" for l in losses))

    # all clients hold the identical aggregated model after the barrier
    drift = max(float((leaf[0].float() - leaf[1].float()).abs().max())
                for leaf in leaves(params_stk))
    print(f"max cross-client param drift after FedAvg barrier: {drift:.2e}")
    if not drift < 1e-5:
        raise RuntimeError(f"clients drifted apart by {drift:.2e} after "
                           f"the barrier")
    print("OK: synchronous FL in the mesh converged with a single "
          "aggregation as the round barrier.")
    return drift


if __name__ == "__main__":
    main()
