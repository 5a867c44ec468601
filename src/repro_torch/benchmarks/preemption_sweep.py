"""Beyond-paper: cost & completion robustness vs spot preemption rate.

The paper observed no preemptions (§IV-B) but built fault tolerance for
them (§III-D). This sweep injects Poisson preemptions at increasing
rates and verifies (a) every round still completes via checkpoint-resume
+ dynamic schedule adjustment, (b) cost degrades gracefully, (c)
FedCostAware keeps beating plain spot even under churn.
"""
from __future__ import annotations

import numpy as np

from repro_torch.common.config import CloudConfig, ClientProfile, FLRunConfig
from repro_torch.fl.runner import FLCloudRunner

CLIENTS = (
    ClientProfile("slow", mean_epoch_s=900, jitter=0.0, n_samples=3),
    ClientProfile("mid", mean_epoch_s=450, jitter=0.0, n_samples=2),
    ClientProfile("fast", mean_epoch_s=150, jitter=0.0, n_samples=1),
)


def run_rate(policy, rate, seed=0, n_epochs=8):
    cloud = CloudConfig(preemption_rate_per_hr=rate, spot_rate_sigma=0.0)
    cfg = FLRunConfig(dataset="p", clients=CLIENTS, n_epochs=n_epochs,
                      policy=policy, seed=seed)
    r = FLCloudRunner(cfg, cloud_cfg=cloud)
    res = r.run()
    n_preempt = sum(1 for e in r.sim.event_log if e["kind"] == "preempt")
    return res, n_preempt


def main():
    print("preempt_per_hr,policy,seeds,mean_cost,mean_preemptions,"
          "all_rounds_completed")
    for rate in (0.0, 0.2, 0.5, 1.0):
        for policy in ("spot", "fedcostaware"):
            costs, preempts, done = [], [], True
            for seed in range(3):
                res, np_ = run_rate(policy, rate, seed)
                costs.append(res.total_cost)
                preempts.append(np_)
                done &= res.rounds_completed == 8
            print(f"{rate},{policy},3,{np.mean(costs):.3f},"
                  f"{np.mean(preempts):.1f},{done}")
            assert done, (rate, policy)


if __name__ == "__main__":
    main()
