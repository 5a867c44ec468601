"""Fault tolerance + budget adherence scenario (paper §III-D / §III-E).

A preemption-heavy spot market (0.5 preemptions/hour/instance) with one
budget-capped client: the run must (1) finish every round despite
interruptions via checkpoint-resume, (2) exclude the poor client once its
budget cannot cover another round, (3) push back other clients' pre-warm
targets while a preempted client recovers (dynamic schedule adjustment).

    PYTHONPATH=src python -m repro_torch.examples.preemption_and_budgets
"""
from repro_torch.common.config import CloudConfig, ClientProfile, FLRunConfig
from repro_torch.fl.runner import FLCloudRunner


def main() -> None:
    clients = (
        ClientProfile("hospital_A", mean_epoch_s=900, n_samples=120),
        ClientProfile("hospital_B", mean_epoch_s=500, n_samples=60),
        ClientProfile("clinic_C", mean_epoch_s=200, n_samples=20, budget=0.40),
    )
    cloud = CloudConfig(preemption_rate_per_hr=0.5)
    cfg = FLRunConfig(dataset="demo", clients=clients, n_epochs=10,
                      policy="fedcostaware", seed=7)
    runner = FLCloudRunner(cfg, cloud_cfg=cloud)
    res = runner.run()

    kinds = {}
    for e in runner.sim.event_log:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    print(f"rounds completed : {res.rounds_completed}/10")
    print(f"cloud events     : {kinds}")
    print(f"excluded clients : {res.excluded_clients}")
    print(f"per-client cost  : "
          + ", ".join(f"{c}=${v:.3f}" for c, v in res.per_client_cost.items()))
    print(f"total            : ${res.total_cost:.3f}")
    assert res.rounds_completed == 10, "run must survive preemptions"
    if kinds.get("preempt", 0) > 0:
        print(f"-> survived {kinds['preempt']} preemption(s) via "
              "checkpoint-resume + schedule adjustment")
    if res.excluded_clients:
        print(f"-> budget adherence excluded: {res.excluded_clients}")


if __name__ == "__main__":
    main()
