"""Paper Table I reproduction on the port: total cost + savings for
(Fed-ISIC2019, AI-READI, CIFAR-10, MNIST) x (FedCostAware, Spot,
On-demand), and the real-training row, where `TorchTrainerHooks` train
an LM on the card and the measured round anchors the simulated epochs.

    python -m repro_torch.benchmarks.table1 [--row MNIST] [--record-dir DIR]
    python -m repro_torch.benchmarks.table1 --real-training \\
        [--model phi3-mini-3.8b] [--layers N] [--assert-comm-win]
    python -m repro_torch.benchmarks.table1 --real-training --smoke \\
        --device cpu --assert-comm-win

A port of the JAX package's `benchmarks/table1.py`. Client
heterogeneity profiles are derived from the paper's own cost identities
(documented in EXPERIMENTS.md §Repro-Table1):

  makespan        = od_total / (n_clients * od_rate)
  slowest epoch   ~ (makespan - spin_up) / n_epochs
  busy fraction   = fca_total / spot_total
                  -> distributes the remaining clients' epoch times

The paper's Fed-ISIC sizes follow FLamby's natural institution split
(client 1 has the largest volume — see Fig. 4); the synthetic datasets
use the dual-Dirichlet volume skew. Rates are the paper's measured
g5.xlarge prices per dataset row.

The real-training row trains on the card (`--device cuda`, the
default) at `--model`'s main path (`MAIN_PATHS`: full width, the depth
cut, the batch and sequence of a round; `--layers` cuts the depth
further or less), or at its SMOKE size with `--smoke`; without a card
the default raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

from repro_torch import configs
from repro_torch.common.config import (CloudConfig, ClientProfile,
                                       FLRunConfig, MarketConfig,
                                       ProviderConfig)
from repro_torch.fl.runner import FLCloudRunner


@dataclasses.dataclass(frozen=True)
class Table1Row:
    dataset: str
    n_clients: int
    n_epochs: int
    od_rate: float
    spot_rate: float
    target: Dict[str, float]          # paper's Total Cost column
    epoch_s: Tuple[float, ...]        # per-client warm epoch seconds
    spin_up_s: float = 150.0          # g5.xlarge provision+boot


ROWS = [
    Table1Row(
        "Fed-ISIC2019", 6, 20, 1.0080, 0.3951,
        {"on_demand": 24.2978, "spot": 9.5239, "fedcostaware": 7.1740},
        # natural institution split: client 0 dominates (paper Fig. 4)
        (718.0, 523.0, 390.0, 246.0, 195.0, 133.0), 335.0),
    Table1Row(
        "AI-READI", 5, 15, 1.0060, 0.3946,
        {"on_demand": 25.3805, "spot": 9.9550, "fedcostaware": 8.3300},
        (1200.0, 1033.0, 881.0, 689.0, 395.0), 220.0),
    Table1Row(
        "CIFAR-10", 4, 20, 1.0080, 0.3951,
        {"on_demand": 26.0609, "spot": 10.2150, "fedcostaware": 7.2399},
        (1155.0, 689.0, 507.0, 334.0), 265.0),
    Table1Row(
        "MNIST", 3, 10, 1.0060, 0.3937,
        {"on_demand": 6.9489, "spot": 2.7174, "fedcostaware": 2.2901},
        (818.0, 511.0, 348.0), 160.0),
]

# fedcostaware_async is the beyond-paper fourth column: same spot market
# + budgets, but FedBuff-style buffered-async rounds (no paper target).
POLICIES = ("fedcostaware", "fedcostaware_async", "spot", "on_demand")


def run_row(row: Table1Row, policy: str, seed: int = 0,
            record_to: Optional[Union[str, Path]] = None,
            market: Optional[MarketConfig] = None,
            cross_provider: Optional[bool] = None):
    clients = tuple(
        ClientProfile(f"client_{i}", mean_epoch_s=t, cold_multiplier=1.12,
                      jitter=0.0, n_samples=int(t))
        for i, t in enumerate(row.epoch_s))
    # the paper's spot rate is the *cheapest-zone* price actually paid;
    # zone means carry a ±2% spread, so scale the mean so min == rate.
    cloud = CloudConfig(on_demand_rate=row.od_rate,
                        spot_rate_mean=row.spot_rate / 0.98,
                        spot_rate_sigma=0.0, spin_up_mean_s=row.spin_up_s,
                        spin_up_sigma=0.0, market=market)
    cfg = FLRunConfig(dataset=row.dataset, clients=clients,
                      n_epochs=row.n_epochs, policy=policy, seed=seed,
                      cross_provider=cross_provider)
    return FLCloudRunner(cfg, cloud_cfg=cloud,
                         record_to=record_to).run()


def _trace_path(record_dir: Union[str, Path], dataset: str,
                policy: str) -> Path:
    slug = dataset.lower().replace("-", "_")
    return Path(record_dir) / f"{slug}__{policy}.events.jsonl"


def run(record_dir: Optional[Union[str, Path]] = None,
        only_dataset: Optional[str] = None) -> List[dict]:
    out = []
    for row in ROWS:
        if only_dataset is not None and row.dataset != only_dataset:
            continue
        od_cost = None
        for policy in POLICIES:
            rec_path = (_trace_path(record_dir, row.dataset, policy)
                        if record_dir is not None else None)
            res = run_row(row, policy, record_to=rec_path)
            target = row.target.get(policy)    # async has no paper column
            rec = {
                "dataset": row.dataset, "n_clients": row.n_clients,
                "n_epochs": row.n_epochs, "algorithm": policy,
                "rate_per_hr": (row.od_rate if policy == "on_demand"
                                else row.spot_rate),
                "total_cost": round(res.total_cost, 4),
                "checkpoint_cost": round(res.checkpoint_cost, 6),
                "comm_cost": round(res.comm_cost, 6),
                "paper_cost": target,
                "rel_err": (round(abs(res.total_cost - target) / target, 4)
                            if target is not None else None),
                "makespan_h": round(res.makespan_s / 3600, 3),
            }
            if policy == "on_demand":
                od_cost = res.total_cost
            out.append(rec)
        for rec in out[-len(POLICIES):]:
            if rec["algorithm"] != "on_demand":
                rec["savings_vs_od_pct"] = round(
                    100 * (1 - rec["total_cost"] / od_cost), 2)
                if rec["paper_cost"] is not None:
                    paper_sav = 100 * (1 - rec["paper_cost"]
                                       / row.target["on_demand"])
                    rec["paper_savings_pct"] = round(paper_sav, 2)
    return out


# ---------------------------------------------------------------------------
# --real-training: `TorchTrainerHooks` client steps stand in for the
# simulated epoch durations; the comms subsystem prices every update
# upload off the actual parameter dict.
# ---------------------------------------------------------------------------

# simulated-seconds per measured round-second: a round of tens of ms to
# a fraction of a second anchors cloud-scale epochs without losing the
# measured heterogeneity (the paper's scaled-duration knob)
_TIME_SCALE = 1000.0

# AWS-style egress ($0.09/GB) and a 100 Mbps client uplink: the rates
# that make `comm_cost` and upload makespan non-zero for real runs
_EGRESS_USD_PER_MB = 0.09 / 1024
_UPLINK_MBPS = 100.0


def comm_market(row: Table1Row) -> MarketConfig:
    """The row's synthetic single-provider market with transfer pricing
    and a client uplink attached (the paper market priced compute
    only)."""
    return MarketConfig(providers=(
        ProviderConfig(name="aws", on_demand_rate=row.od_rate,
                       spot_rate_mean=row.spot_rate / 0.98,
                       spot_rate_sigma=0.0, n_zones=3,
                       update_egress_usd_per_mb=_EGRESS_USD_PER_MB,
                       uplink_mbps=_UPLINK_MBPS),))


# The main path of each supported model on one card: full width, depth
# cut to (layers), and the batch and sequence of each local step. mamba2
# runs at the context it was trained at (8 chunks of 256), recurrentgemma
# at twice its 2048 window, so the window masks; granite-moe-3b-a800m at
# phi3's batch and sequence (4096 tokens a step: 32 dispatch groups of
# 128). At SMOKE size a step is the JAX package's, batch 4 of 16 tokens;
# every model of the registry has one.
MAIN_PATHS = {"phi3-mini-3.8b": (2, 4, 1024),
              "mamba2-1.3b": (2, 2, 2048),
              "recurrentgemma-2b": (3, 1, 4096),
              "granite-moe-3b-a800m": (2, 4, 1024)}
SMOKE_BATCH, SMOKE_SEQ = 4, 16
# LM steps per client per simulated epoch, as in the JAX package
LOCAL_STEPS = 2
# rounds of the calibration before and in its timing: the median of
# CAL_ITERS rounds after CAL_WARMUP, so one slow round moves no epoch
CAL_WARMUP, CAL_ITERS = 3, 5


def main_path(model: str = "phi3-mini-3.8b", layers: Optional[int] = None,
              smoke: bool = False):
    """(config, batch, seq) of `model`'s main path (`MAIN_PATHS`), its
    depth cut to `layers` where given, or of its SMOKE size."""
    if smoke:
        cfg, batch, seq = (configs.get_config(model, smoke=True),
                           SMOKE_BATCH, SMOKE_SEQ)
    else:
        if model not in MAIN_PATHS:
            raise KeyError(f"{model!r} has no main path; known: "
                           f"{list(MAIN_PATHS)} (any model runs --smoke)")
        depth, batch, seq = MAIN_PATHS[model]
        cfg = dataclasses.replace(configs.get_config(model),
                                  num_layers=depth)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg, batch, seq


def run_real(row: Table1Row, policy: str = "fedcostaware",
             rounds: int = 2, n_clients: int = 2,
             quantize: bool = False, seed: int = 0,
             record_to: Optional[Union[str, Path]] = None,
             model: str = "phi3-mini-3.8b", layers: Optional[int] = None,
             smoke: bool = False, device="cuda"):
    """One Table-1 row with *real* training: every simulated epoch maps
    to `LOCAL_STEPS` LM steps of `model`'s main path (`main_path`) on
    `device`, epoch durations are calibrated from the measured round,
    and update uploads are sized from the live parameters (int8
    quantized when `quantize`). Returns (RunResult, hooks, calibration).
    """
    from repro_torch.fl import training as T
    cfg, batch, seq = main_path(model, layers, smoke)
    names = tuple(f"client_{i}" for i in range(n_clients))
    hooks = T.TorchTrainerHooks(names, local_steps=LOCAL_STEPS, batch=batch,
                                seq=seq, quantize=quantize, seed=seed,
                                device=device, cfg=cfg)
    cal = T.calibrate(hooks, warmup=CAL_WARMUP, iters=CAL_ITERS)
    profiles = tuple(
        ClientProfile(name, mean_epoch_s=row.epoch_s[i % len(row.epoch_s)],
                      cold_multiplier=1.12, jitter=0.0)
        for i, name in enumerate(names))
    profiles = tuple(T.calibrated_profiles(profiles, cal,
                                           time_scale=_TIME_SCALE))
    cloud = CloudConfig(spin_up_mean_s=row.spin_up_s, spin_up_sigma=0.0,
                        market=comm_market(row))
    run_cfg = FLRunConfig(dataset=row.dataset, clients=profiles,
                          n_epochs=rounds, policy=policy, seed=seed,
                          quantize_updates=quantize)
    res = FLCloudRunner(run_cfg, cloud_cfg=cloud, hooks=hooks,
                        record_to=record_to).run()
    return res, hooks, cal


def assert_comm_win(fp32_rec: dict, quant_rec: dict,
                    loss_delta_bound: float = 0.75) -> None:
    """The real-training gate: quantization must strictly cut egress
    dollars (both runs must bill a nonzero `comm_cost`) without moving
    the final training loss by more than `loss_delta_bound`."""
    c_fp, c_q = fp32_rec["comm_cost"], quant_rec["comm_cost"]
    if not (c_fp > 0.0 and c_q > 0.0):
        raise SystemExit(f"--assert-comm-win needs nonzero comm_cost "
                         f"on both runs (fp32 {c_fp}, quantized {c_q})")
    if not c_q < c_fp:
        raise SystemExit(f"quantized egress {c_q} not below fp32 {c_fp}")
    dl = abs(quant_rec["final_loss"] - fp32_rec["final_loss"])
    if not dl <= loss_delta_bound:
        raise SystemExit(
            f"quantized final loss {quant_rec['final_loss']:.4f} drifts "
            f"{dl:.4f} from fp32 {fp32_rec['final_loss']:.4f} "
            f"(bound {loss_delta_bound})")
    print(f"# comm win: quantized ${c_q:.6f} < fp32 ${c_fp:.6f} "
          f"({100 * (1 - c_q / c_fp):.1f}% less egress, "
          f"final-loss delta {dl:.4f} <= {loss_delta_bound})")


def run_real_rows(row: Table1Row, rounds: int, n_clients: int,
                  quantize: bool, both: bool,
                  policy: str = "fedcostaware", seed: int = 0,
                  **hook_kw) -> List[dict]:
    """The real-training record list: one row per (quantization) arm —
    the requested arm only, or fp32 + quantized when `both` (the
    --assert-comm-win pairing). `hook_kw` goes to `run_real` (model,
    layers, smoke, device). Each record also carries the run's
    `calibration`. The runner's event bus and engines hold one another,
    so a run's hooks, and their tensors on the card, live until the
    cycle collector runs: each arm collects them before it starts."""
    arms = [False, True] if both else [quantize]
    out = []
    for q in arms:
        gc.collect()
        res, hooks, cal = run_real(row, policy=policy, rounds=rounds,
                                   n_clients=n_clients, quantize=q,
                                   seed=seed, **hook_kw)
        out.append({
            "dataset": row.dataset, "n_clients": n_clients,
            "n_epochs": rounds,
            "algorithm": f"{policy}[{'int8' if q else 'fp32'}]",
            "total_cost": round(res.total_cost, 6),
            "checkpoint_cost": round(res.checkpoint_cost, 6),
            "comm_cost": round(res.comm_cost, 6),
            "paper_cost": None, "rel_err": None,
            "makespan_h": round(res.makespan_s / 3600, 6),
            "final_loss": round(hooks.final_loss(), 4),
            "calibrated_epoch_s": round(
                cal.mean_epoch_s(_TIME_SCALE), 3),
            "roofline_ratio": round(cal.ratio, 3),
            "calibration": cal,
        })
        del res, hooks
    gc.collect()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--record-dir", metavar="DIR", default=None,
                    help="record every run's event log into DIR as "
                         "<dataset>__<policy>.events.jsonl")
    ap.add_argument("--row", metavar="DATASET", default=None,
                    choices=[r.dataset for r in ROWS],
                    help="run a single Table-1 row (e.g. MNIST)")
    ap.add_argument("--real-training", action="store_true",
                    help="replace simulated epochs with real LM steps of "
                         "TorchTrainerHooks and bill update egress off "
                         "the live parameters")
    ap.add_argument("--quantize-updates", action="store_true",
                    help="with --real-training: int8-quantize client "
                         "updates (grad_quant codec) end to end — "
                         "smaller payloads, cheaper egress")
    ap.add_argument("--rounds", type=int, default=2,
                    help="with --real-training: FL rounds (default 2)")
    ap.add_argument("--clients", type=int, default=2,
                    help="with --real-training: client count (default 2)")
    ap.add_argument("--assert-comm-win", action="store_true",
                    help="with --real-training: run fp32 AND quantized "
                         "arms; fail unless quantized egress dollars "
                         "are strictly lower at a bounded final-loss "
                         "delta")
    ap.add_argument("--model", default="phi3-mini-3.8b",
                    choices=configs.ARCH_IDS,
                    help="with --real-training: the model trained")
    ap.add_argument("--layers", type=int, default=None,
                    help="with --real-training: this many layers instead "
                         "of the main path's depth (MAIN_PATHS)")
    ap.add_argument("--smoke", action="store_true",
                    help="with --real-training: the model's SMOKE size "
                         "instead of its full width")
    ap.add_argument("--device", default="cuda",
                    help="with --real-training: where the hooks train "
                         "(default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)

    def fmt(v):
        return "" if v is None else v

    if args.real_training:
        row = next(r for r in ROWS
                   if r.dataset == (args.row or "MNIST"))
        recs = run_real_rows(
            row, rounds=args.rounds, n_clients=args.clients,
            quantize=args.quantize_updates, both=args.assert_comm_win,
            model=args.model, layers=args.layers, smoke=args.smoke,
            device=args.device)
        print("dataset,algorithm,total_cost,checkpoint_cost,comm_cost,"
              "final_loss,calibrated_epoch_s,roofline_ratio,makespan_h")
        for r in recs:
            print(f"{r['dataset']},{r['algorithm']},{r['total_cost']},"
                  f"{r['checkpoint_cost']},{r['comm_cost']},"
                  f"{r['final_loss']},{r['calibrated_epoch_s']},"
                  f"{r['roofline_ratio']},{r['makespan_h']}")
        if args.assert_comm_win:
            assert_comm_win(recs[0], recs[1])
        return

    print("dataset,algorithm,total_cost,checkpoint_cost,comm_cost,"
          "paper_cost,rel_err,savings_vs_od_pct,paper_savings_pct")
    for r in run(record_dir=args.record_dir, only_dataset=args.row):
        print(f"{r['dataset']},{r['algorithm']},{r['total_cost']},"
              f"{r['checkpoint_cost']},{r['comm_cost']},"
              f"{fmt(r['paper_cost'])},{fmt(r['rel_err'])},"
              f"{fmt(r.get('savings_vs_od_pct'))},"
              f"{fmt(r.get('paper_savings_pct'))}")


if __name__ == "__main__":
    main()
