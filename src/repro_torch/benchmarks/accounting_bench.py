"""Micro-benchmark: incremental CostAccountant vs the legacy O(n) scan.

The seed runner recorded the Fig-5 cost curve by calling
`CloudSimulator.client_cost` (a scan over every instance ever created)
for every client at every round end — O(clients^2 * rounds) instance
visits across a run once lifecycle churn piles up instances. The
refactor's `CostAccountant` folds billing events incrementally, so the
same queries touch only each client's open segment.

This bench replays the access pattern at 100 clients x 200 rounds with
per-round instance churn (each client terminates + respins every round,
as FedCostAware does for fast clients), then times the full cost-curve
recording three ways: the seed's full scan (reified inline — the
simulator's own `client_cost` no longer scans), the simulator's
per-client index + settled-cost accumulator, and the event-driven
accountant.

    PYTHONPATH=src python -m repro_torch.benchmarks.accounting_bench
"""
from __future__ import annotations

import time

from repro_torch.cloud.accounting import CostAccountant
from repro_torch.cloud.simulator import CloudSimulator
from repro_torch.common.config import CloudConfig

N_CLIENTS = 100
N_ROUNDS = 200


def build_history():
    """One instance per client per round (the churn FedCostAware creates),
    plus an open instance per client at the end."""
    sim = CloudSimulator(CloudConfig(spot_rate_sigma=0.0), seed=0)
    acct = CostAccountant(sim.bus, sim.prices, clock=lambda: sim.now)
    clients = [f"client_{i:03d}" for i in range(N_CLIENTS)]
    for r in range(N_ROUNDS):
        insts = [sim.request_instance(c) for c in clients]
        sim.run_until_idle()
        sim.now += 300.0                      # a round of training
        if r < N_ROUNDS - 1:
            for inst in insts:
                sim.terminate(inst)           # lifecycle churn
    return sim, acct, clients


def record_curve_scan(sim, clients):
    """The seed's query shape: a full `_instances` scan per client.
    (Reified here because `CloudSimulator.client_cost` itself is now
    served from a per-client index + settled accumulator.)"""
    return [[sum(sim.accrued_cost(i) for i in sim._instances.values()
                 if i.client == c)
             for c in clients]]


def record_curve_sim(sim, clients):
    """The simulator's own indexed queries (settled accumulator + open
    segments) — the fix this bench pins."""
    return [[sim.client_cost(c) for c in clients]]


def record_curve_acct(acct, clients):
    return [[acct.client_cost(c) for c in clients]]


def main():
    print(f"# {N_CLIENTS} clients x {N_ROUNDS} rounds "
          f"({N_CLIENTS * N_ROUNDS} instances total)")
    sim, acct, clients = build_history()

    t0 = time.perf_counter()
    scan = record_curve_scan(sim, clients)
    t_scan = time.perf_counter() - t0

    t0 = time.perf_counter()
    idx = record_curve_sim(sim, clients)
    t_sim = time.perf_counter() - t0

    t0 = time.perf_counter()
    inc = record_curve_acct(acct, clients)
    t_acct = time.perf_counter() - t0

    drift = max(abs(a - b) for a, b in zip(scan[0], inc[0]))
    drift_sim = max(abs(a - b) for a, b in zip(scan[0], idx[0]))
    print("method,seconds_per_round_of_queries,per_client_us")
    print(f"legacy_scan,{t_scan:.6f},{1e6 * t_scan / N_CLIENTS:.1f}")
    print(f"sim_indexed,{t_sim:.6f},{1e6 * t_sim / N_CLIENTS:.1f}")
    print(f"accountant,{t_acct:.6f},{1e6 * t_acct / N_CLIENTS:.1f}")
    print(f"# accountant speedup: {t_scan / t_acct:.1f}x   "
          f"sim-index speedup: {t_scan / t_sim:.1f}x   "
          f"max drift: {max(drift, drift_sim):.2e}")
    assert drift < 1e-9, "accountant must agree with the scan"
    assert drift_sim < 1e-9, "indexed sim queries must agree with the scan"
    assert t_acct < t_scan, "accountant should beat the full scan"
    assert t_sim < t_scan, "indexed sim queries should beat the full scan"


if __name__ == "__main__":
    main()
