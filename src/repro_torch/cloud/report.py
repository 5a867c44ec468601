"""Cost reporting, reconciliation and pre-launch budget screening over
recorded event logs (`python -m repro_torch.cloud.report`, docs/reporting.md).

The paper's pitch is FL for budget-constrained institutions, yet every
dollar of a run lives in a `.events.jsonl` stream that only tests
replay. This module is the human-facing answer to "where did the money
go?" — four subcommands, all pure replay consumers over
`core.eventlog` (zero engine or simulator involvement, mirroring the
Multi-FedLS record-then-audit discipline):

  summary    per-client / per-provider / per-zone spend split into
             compute, checkpoint-storage and update-egress categories,
             plus idle-time, preemption and lost-work columns rebuilt
             from the recorded Fig-4 state stream; `--per-round` adds
             dollars bucketed by the round window open at settlement
             time (RoundStarted -> RoundCompleted)
  trends     cost / makespan / preemption trajectories across every
             trace in a directory (deterministic sorted-key JSON or a
             CSV-style table)
  reconcile  the audit primitive: assert the run total equals
             per-client compute + checkpoint + egress +
             fleet-unattributed dollars to a tolerance, and on failure
             report the delta and the *first divergent event*
  validate   pre-launch budget screening (§III-E applied before the
             run exists): estimate the run's cost from client epoch
             times — given directly or derived from roofline FLOP /
             byte counts — and current `SpotMarket` prices, refuse
             over-budget launches and suggest the cheapest zone

Every output is byte-deterministic (sorted keys, fixed float formats,
no timestamps): CI runs the CLI twice and diffs the bytes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.events import (BillingTick, CheckpointBilled,
                               ClientCheckpointed, ClientLost,
                               ClientStateChanged, ClientUpdateSent,
                               EventBus, FleetStepSummary, RoundCompleted,
                               RoundStarted, RunCompleted, TransferBilled)
from repro_torch.core.eventlog import iter_events, read_header

# the provider every legacy single-provider log implicitly ran on
# (InstanceRef's decode default): used when an event predates provider
# stamping and carries an empty string
_FALLBACK_PROVIDER = "aws"

# the reconciliation invariant's tolerance (dollars)
RECONCILE_TOL = 1e-9


# ---------------------------------------------------------------------------
# summary — category breakdowns from one stream walk.
# ---------------------------------------------------------------------------
def summarize_path(path: Union[str, Path]) -> Dict[str, Any]:
    """One trace's full spend breakdown as a JSON-ready dict.

    A single pass over the recorded events attributes every settled
    dollar to (client, provider, zone) x (compute | checkpoint |
    egress):

      * `BillingTick` — compute dollars, attributed via the instance
        snapshot's client / provider / zone;
      * `CheckpointBilled` — checkpoint-storage dollars; the provider
        comes from the client's preceding `ClientCheckpointed` (the
        live accountant publishes the charge nested inside that event,
        so it directly follows it in every recorded stream);
      * `TransferBilled` — update-egress dollars; provider / zone from
        the client's preceding `ClientUpdateSent`, same nesting;
      * `FleetStepSummary` — the fleet path's aggregate settlements:
        per-client compute from `client_cost_delta`, per-zone compute
        from `by_zone`, and pre-v6 summaries (no attribution map) into
        `fleet_unattributed`.

    Idle seconds fold from the `ClientStateChanged` stream and
    `lost_work_s` estimates preemption-interrupted training time (the
    elapsed training segment at each `ClientLost`, an upper bound that
    ignores checkpoint credit — replayed `RunResult.lost_work_s` is
    live-only and stays 0). The category totals are the reconciliation
    invariant's parts: tests pin them to the replayed
    `RunResult.{total,checkpoint,comm}_cost` to 1e-9.
    """
    path = Path(path)
    header = read_header(path)
    compute: Dict[str, float] = defaultdict(float)
    ckpt: Dict[str, float] = defaultdict(float)
    egress: Dict[str, float] = defaultdict(float)
    prov: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"compute": 0.0, "checkpoint": 0.0, "egress": 0.0})
    zone: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"compute": 0.0, "egress": 0.0})
    preempt: Dict[str, int] = defaultdict(int)
    lost: Dict[str, float] = defaultdict(float)
    state_s: Dict[Tuple[str, str], float] = defaultdict(float)
    cur_state: Dict[str, Tuple[str, float]] = {}
    last_ckpt_prov: Dict[str, str] = {}
    last_sent: Dict[str, Tuple[str, str]] = {}
    fleet_unattributed = 0.0
    fleet_preemptions = 0
    done: Optional[RunCompleted] = None

    def close_state(client: str, t: float) -> None:
        st = cur_state.pop(client, None)
        if st is not None:
            state_s[(client, st[0])] += t - st[1]

    for ev in iter_events(path):
        if isinstance(ev, BillingTick):
            inst = ev.instance
            p = getattr(inst, "provider", "") or _FALLBACK_PROVIDER
            compute[ev.client] += ev.amount
            prov[p]["compute"] += ev.amount
            zone[f"{p}/{inst.zone}"]["compute"] += ev.amount
        elif isinstance(ev, ClientCheckpointed):
            last_ckpt_prov[ev.client] = ev.provider or _FALLBACK_PROVIDER
        elif isinstance(ev, CheckpointBilled):
            p = last_ckpt_prov.get(ev.client, _FALLBACK_PROVIDER)
            ckpt[ev.client] += ev.amount
            prov[p]["checkpoint"] += ev.amount
        elif isinstance(ev, ClientUpdateSent):
            last_sent[ev.client] = (ev.provider or _FALLBACK_PROVIDER,
                                    ev.zone)
        elif isinstance(ev, TransferBilled):
            p, z = last_sent.get(ev.client, (_FALLBACK_PROVIDER, ""))
            egress[ev.client] += ev.amount
            prov[p]["egress"] += ev.amount
            if z:
                zone[f"{p}/{z}"]["egress"] += ev.amount
        elif isinstance(ev, FleetStepSummary):
            if ev.client_cost_delta:
                for c, a in ev.client_cost_delta.items():
                    compute[c] += a
            else:
                fleet_unattributed += ev.cost_delta
            for zkey, aggs in ev.by_zone.items():
                amount = aggs.get("cost", 0.0)
                zone[zkey]["compute"] += amount
                prov[zkey.split("/", 1)[0]]["compute"] += amount
            fleet_preemptions += ev.n_preemptions
        elif isinstance(ev, ClientLost):
            preempt[ev.client] += 1
            st = cur_state.get(ev.client)
            if st is not None and st[0] == "training":
                lost[ev.client] += ev.t - st[1]
        elif isinstance(ev, ClientStateChanged):
            close_state(ev.client, ev.t)
            if ev.state != "done":
                cur_state[ev.client] = (ev.state, ev.t)
        elif isinstance(ev, RunCompleted):
            done = ev
    if done is None:
        raise ValueError(f"{path}: event log has no RunCompleted "
                         f"summary (truncated recording?)")
    for c in list(cur_state):
        close_state(c, done.t)

    clients = sorted(set(compute) | set(ckpt) | set(egress))
    per_client = {
        c: {"compute": compute[c], "checkpoint": ckpt[c],
            "egress": egress[c],
            "total": compute[c] + ckpt[c] + egress[c],
            "idle_s": state_s.get((c, "idle"), 0.0),
            "preemptions": preempt[c], "lost_work_s": lost[c]}
        for c in clients}
    totals = {
        "compute": sum(compute.values()),
        "checkpoint": sum(ckpt.values()),
        "egress": sum(egress.values()),
        "fleet_unattributed": fleet_unattributed,
        "total": (sum(compute.values()) + sum(ckpt.values())
                  + sum(egress.values()) + fleet_unattributed),
        "makespan_s": done.makespan_s,
        "rounds": done.rounds_completed,
        "preemptions": sum(preempt.values()) + fleet_preemptions,
        "lost_work_s": sum(lost.values()),
    }
    return {"trace": path.name,
            "dataset": header.get("dataset"),
            "policy": header.get("policy"),
            "seed": header.get("seed"),
            "schema": header["schema"],
            "totals": totals,
            "per_client": per_client,
            "per_provider": {p: dict(v) for p, v in sorted(prov.items())},
            "per_zone": {z: dict(v) for z, v in sorted(zone.items())}}


def render_summary(payload: Dict[str, Any]) -> str:
    """The `summary` table for one trace: header comments, then one
    CSV block per breakdown (client / provider / zone). Fixed float
    formats keep the bytes deterministic across runs."""
    t = payload["totals"]
    lines = [
        f"# {payload['trace']}: dataset={payload['dataset']}, "
        f"policy={payload['policy']}, seed={payload['seed']}, "
        f"schema={payload['schema']}",
        f"# total ${t['total']:.6f} = compute ${t['compute']:.6f} + "
        f"checkpoint ${t['checkpoint']:.6f} + egress ${t['egress']:.6f}"
        f" + fleet-unattributed ${t['fleet_unattributed']:.6f}",
        f"# makespan {t['makespan_s'] / 3600:.3f} h, "
        f"rounds {t['rounds']}, preemptions {t['preemptions']}, "
        f"lost-work {t['lost_work_s']:.1f} s",
        "client,compute_usd,checkpoint_usd,egress_usd,total_usd,"
        "idle_s,preemptions,lost_work_s",
    ]
    for c, row in sorted(payload["per_client"].items()):
        lines.append(
            f"{c},{row['compute']:.6f},{row['checkpoint']:.6f},"
            f"{row['egress']:.6f},{row['total']:.6f},"
            f"{row['idle_s']:.1f},{row['preemptions']},"
            f"{row['lost_work_s']:.1f}")
    lines.append("provider,compute_usd,checkpoint_usd,egress_usd")
    for p, row in payload["per_provider"].items():
        lines.append(f"{p},{row['compute']:.6f},"
                     f"{row['checkpoint']:.6f},{row['egress']:.6f}")
    lines.append("zone,compute_usd,egress_usd")
    for z, row in payload["per_zone"].items():
        lines.append(f"{z},{row['compute']:.6f},{row['egress']:.6f}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# per-round attribution — which round the money settled in.
# ---------------------------------------------------------------------------
def per_round_rows(path: Union[str, Path]) -> List[Dict[str, Any]]:
    """Per-round cost attribution: every settled dollar bucketed by
    the round window open at its settlement time.

    A `RoundStarted` opens round `round_idx`; its `RoundCompleted`
    closes it. Settlements (`BillingTick`, `CheckpointBilled`,
    `TransferBilled`, fleet `FleetStepSummary.cost_delta`) landing
    between the two attribute to that round. Under the async engines
    round windows overlap — a settlement inside several open windows
    attributes to the *most recently started* one (the round the money
    is actually buying progress for). Settlements outside every window
    — the initial spin-up before round 0 and the tail after the last
    aggregation — land in the `"-"` row, so the rows always sum back
    to the trace total (the `summary` reconciliation invariant holds
    per-round too).
    """
    path = Path(path)
    open_rounds: List[int] = []     # stack: most recently started last
    acc: Dict[Optional[int], Dict[str, float]] = defaultdict(
        lambda: {"compute": 0.0, "checkpoint": 0.0, "egress": 0.0})
    window: Dict[int, Dict[str, Any]] = {}

    def bucket() -> Optional[int]:
        return open_rounds[-1] if open_rounds else None

    for ev in iter_events(path):
        if isinstance(ev, RoundStarted):
            open_rounds.append(ev.round_idx)
            window[ev.round_idx] = {"t_start": ev.t, "t_end": None,
                                    "participants": len(ev.participants)}
        elif isinstance(ev, RoundCompleted):
            if ev.round_idx in open_rounds:
                open_rounds.remove(ev.round_idx)
            w = window.setdefault(
                ev.round_idx,
                {"t_start": ev.t,
                 "participants": len(ev.participants)})
            w["t_end"] = ev.t
        elif isinstance(ev, BillingTick):
            acc[bucket()]["compute"] += ev.amount
        elif isinstance(ev, CheckpointBilled):
            acc[bucket()]["checkpoint"] += ev.amount
        elif isinstance(ev, TransferBilled):
            acc[bucket()]["egress"] += ev.amount
        elif isinstance(ev, FleetStepSummary):
            acc[bucket()]["compute"] += ev.cost_delta

    rows: List[Dict[str, Any]] = []
    for idx in sorted(window):
        w, a = window[idx], acc.get(idx) or {
            "compute": 0.0, "checkpoint": 0.0, "egress": 0.0}
        rows.append({
            "round": idx, "t_start_s": w["t_start"],
            "t_end_s": w["t_end"], "participants": w["participants"],
            "compute": a["compute"], "checkpoint": a["checkpoint"],
            "egress": a["egress"],
            "total": a["compute"] + a["checkpoint"] + a["egress"]})
    out = acc.get(None)
    if out is not None:
        rows.append({
            "round": None, "t_start_s": None, "t_end_s": None,
            "participants": 0, "compute": out["compute"],
            "checkpoint": out["checkpoint"], "egress": out["egress"],
            "total": (out["compute"] + out["checkpoint"]
                      + out["egress"])})
    return rows


def render_per_round(trace: str, rows: List[Dict[str, Any]]) -> str:
    """The `summary --per-round` CSV block: one row per round window
    plus the `-` outside-round bucket, fixed float formats (CI diffs
    the bytes)."""
    lines = [f"# per-round attribution: {trace} (dollars by "
             f"settlement-time round window; '-' = outside any round)",
             "round,t_start_s,t_end_s,participants,compute_usd,"
             "checkpoint_usd,egress_usd,total_usd"]
    for r in rows:
        idx = "-" if r["round"] is None else str(r["round"])
        t0 = ("-" if r["t_start_s"] is None
              else f"{r['t_start_s']:.1f}")
        t1 = "-" if r["t_end_s"] is None else f"{r['t_end_s']:.1f}"
        lines.append(
            f"{idx},{t0},{t1},{r['participants']},"
            f"{r['compute']:.6f},{r['checkpoint']:.6f},"
            f"{r['egress']:.6f},{r['total']:.6f}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# reconcile — the dollar-exact audit primitive.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Reconciliation:
    """Outcome of auditing one trace against the invariant
    `total == Σ per-client compute + checkpoint + egress +
    fleet_unattributed` (and the recorded `RunCompleted.total_cost`
    against the independent replay fold). `first_divergence` is the
    one-line description of the earliest event at which the folds
    disagreed, None when `ok`."""
    trace: str
    ok: bool
    total: float
    parts: Dict[str, float]
    delta: float
    first_divergence: Optional[str] = None


def reconcile_path(path: Union[str, Path],
                   tol: float = RECONCILE_TOL) -> Reconciliation:
    """Stream one trace through a fresh replay-mode `CostAccountant`
    and assert, after *every* event, that its per-category parts sum
    back to its running total — so a divergence is pinned to the first
    event that introduced it, not discovered at the end. The recorded
    `RunCompleted.total_cost` is additionally checked against the
    independent fold (a tampered or miscomputed summary reconciles as
    a failure at that event)."""
    from repro_torch.cloud.accounting import CostAccountant
    path = Path(path)
    bus = EventBus()
    acct = CostAccountant(bus)

    def parts_sum() -> float:
        per_client_compute = sum(
            acct.client_cost(c) - acct.checkpoint_cost(c)
            - acct.transfer_cost(c) for c in acct.per_client())
        return (per_client_compute + acct.checkpoint_cost_total()
                + acct.transfer_cost_total() + acct.fleet_unattributed)

    first: Optional[str] = None
    saw_summary = False
    for idx, ev in enumerate(iter_events(path)):
        bus.publish(ev)
        saw_summary = saw_summary or isinstance(ev, RunCompleted)
        if first is not None:
            continue
        total = acct.total_cost()
        parts = parts_sum()
        if abs(total - parts) > tol:
            first = (f"event[{idx}] {type(ev).__name__} t={ev.t:.3f}: "
                     f"running total ${total:.9f} vs category sum "
                     f"${parts:.9f}")
        elif isinstance(ev, RunCompleted) and \
                abs(ev.total_cost - total) > tol:
            first = (f"event[{idx}] RunCompleted t={ev.t:.3f}: "
                     f"recorded total ${ev.total_cost:.9f} vs "
                     f"replayed fold ${total:.9f}")

    if first is None and not saw_summary:
        # a cleanly cut log (whole trailing lines removed) parses fine
        # but carries no recorded total to audit against — that is a
        # failed audit, not a passing one
        first = ("no RunCompleted summary event "
                 "(truncated recording?)")
    total = acct.total_cost()
    parts = {
        "per_client_compute": sum(
            acct.client_cost(c) - acct.checkpoint_cost(c)
            - acct.transfer_cost(c) for c in acct.per_client()),
        "checkpoint": acct.checkpoint_cost_total(),
        "egress": acct.transfer_cost_total(),
        "fleet_unattributed": acct.fleet_unattributed,
    }
    delta = total - sum(parts.values())
    ok = abs(delta) <= tol and first is None
    return Reconciliation(trace=path.name, ok=ok, total=total,
                          parts=parts, delta=delta,
                          first_divergence=first)


def render_reconciliation(rec: Reconciliation, tol: float) -> str:
    """One PASS/FAIL line per trace (plus the first divergent event on
    failure) — what the CI smoke step greps."""
    p = rec.parts
    head = (f"# reconcile {rec.trace}: "
            f"{'PASS' if rec.ok else 'FAIL'} "
            f"total ${rec.total:.9f} = compute "
            f"${p['per_client_compute']:.9f} + checkpoint "
            f"${p['checkpoint']:.9f} + egress ${p['egress']:.9f} + "
            f"fleet-unattributed ${p['fleet_unattributed']:.9f} "
            f"(delta {rec.delta:.3e}, tol {tol:.0e})")
    if rec.first_divergence is not None:
        head += f"\n#   first divergent {rec.first_divergence}"
    return head


# ---------------------------------------------------------------------------
# trends — trajectories across a directory of recorded runs.
# ---------------------------------------------------------------------------
def trend_rows(directory: Union[str, Path]) -> List[Dict[str, Any]]:
    """One row per `*.events.jsonl` under `directory` (sorted by file
    name, so output order is deterministic): run identity from the
    header plus replayed cost / makespan / preemption aggregates."""
    directory = Path(directory)
    paths = sorted(directory.glob("*.events.jsonl"))
    if not paths:
        raise ValueError(f"{directory}: no *.events.jsonl traces found")
    rows = []
    for p in paths:
        s = summarize_path(p)
        t = s["totals"]
        rows.append({
            "trace": s["trace"], "dataset": s["dataset"],
            "policy": s["policy"], "seed": s["seed"],
            "schema": s["schema"], "total_usd": t["total"],
            "checkpoint_usd": t["checkpoint"],
            "egress_usd": t["egress"],
            "makespan_h": t["makespan_s"] / 3600.0,
            "rounds": t["rounds"], "preemptions": t["preemptions"]})
    return rows


def render_trends(rows: List[Dict[str, Any]]) -> str:
    """The `trends` CSV table (one row per trace, fixed formats)."""
    lines = ["trace,dataset,policy,seed,total_usd,checkpoint_usd,"
             "egress_usd,makespan_h,rounds,preemptions"]
    for r in rows:
        lines.append(
            f"{r['trace']},{r['dataset']},{r['policy']},{r['seed']},"
            f"{r['total_usd']:.6f},{r['checkpoint_usd']:.6f},"
            f"{r['egress_usd']:.6f},{r['makespan_h']:.3f},"
            f"{r['rounds']},{r['preemptions']}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# validate — pre-launch budget screening.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BudgetCheck:
    """A pre-launch estimate against a budget: the requested
    placement's estimated dollars, the cheapest spot zone across every
    provider, and that fallback's own estimate."""
    estimate: float
    budget: float
    basis: str
    cheapest_zone: str
    cheapest_rate: float
    cheapest_estimate: float

    @property
    def ok(self) -> bool:
        """Whether the requested launch fits the budget."""
        return self.estimate <= self.budget


def screen_budget(epoch_s: Sequence[float], n_epochs: int, budget: float,
                  market, *, spin_up_s: float = 150.0,
                  on_demand: bool = False,
                  providers: Optional[Sequence[str]] = None) -> BudgetCheck:
    """§III-E screening before the run exists: each client owes
    `n_epochs * epoch_s + spin_up_s` busy seconds, priced at the
    requested placement — the cheapest spot zone of the requested
    `providers` at t=0, or the default provider's on-demand rate. The
    suggestion (`cheapest_zone`) always searches every provider's spot
    zones, so a refused on-demand or single-provider launch names the
    cheapest feasible alternative."""
    hours = [(n_epochs * e + spin_up_s) / 3600.0 for e in epoch_s]
    if on_demand:
        rate = market.provider_of(None).on_demand_rate
        basis = (f"{len(hours)} clients x {n_epochs} epochs, on-demand "
                 f"{market.default_provider} @ ${rate:.4f}/hr, "
                 f"spin-up {spin_up_s:.0f}s")
    else:
        z, rate = market.cheapest_zone(0.0, providers=providers)
        basis = (f"{len(hours)} clients x {n_epochs} epochs, spot "
                 f"{z.provider}/{z.name} @ ${rate:.4f}/hr, "
                 f"spin-up {spin_up_s:.0f}s")
    estimate = sum(hours) * rate
    best, best_rate = market.cheapest_zone(0.0)
    return BudgetCheck(
        estimate=estimate, budget=budget, basis=basis,
        cheapest_zone=f"{best.provider}/{best.name}",
        cheapest_rate=best_rate,
        cheapest_estimate=sum(hours) * best_rate)


def render_budget_check(chk: BudgetCheck) -> str:
    """The `validate` verdict: a one-line refusal naming the estimate
    and budget (the format tests pin), plus the cheapest-zone
    suggestion; or the pass line with headroom."""
    lines = []
    if chk.ok:
        lines.append(f"# validate: estimated ${chk.estimate:.2f} within "
                     f"budget ${chk.budget:.2f} "
                     f"(headroom ${chk.budget - chk.estimate:.2f})")
    else:
        lines.append(f"error: estimated ${chk.estimate:.2f} exceeds "
                     f"budget ${chk.budget:.2f}")
    lines.append(f"# basis: {chk.basis}")
    fits = chk.cheapest_estimate <= chk.budget
    lines.append(
        f"# cheapest zone: {chk.cheapest_zone} spot @ "
        f"${chk.cheapest_rate:.4f}/hr — estimated "
        f"${chk.cheapest_estimate:.2f} "
        f"{'fits' if fits else 'still exceeds'} budget "
        f"${chk.budget:.2f}")
    return "\n".join(lines)


def _roofline_epoch_s(args) -> float:
    """Epoch seconds from roofline FLOP/byte counts: steps-per-epoch
    times the `launch.roofline` step-time estimate at the caller's
    `--peak-flops`/`--hbm-bw` (the port holds no hardware constant),
    scaled by `--time-scale` (the simulated-seconds-per-step-second
    knob real training calibrates with)."""
    from repro_torch.launch.roofline import estimate_step_time
    step_s = estimate_step_time(args.roofline_flops, args.roofline_bytes,
                                peak_flops=args.peak_flops,
                                hbm_bw=args.hbm_bw)
    return args.steps_per_epoch * step_s * args.time_scale


def _validate_market(args):
    """The `SpotMarket` the validate subcommand prices against: a
    trace-driven multi-provider market under `--price-trace`, else a
    synthetic single-provider market from the `--od-rate`/`--spot-rate`
    scalars (sigma 0 — screening wants the mean, not one noise draw)."""
    from repro_torch.cloud.pricing import SpotMarket
    from repro_torch.common.config import (CloudConfig, MarketConfig,
                                     ProviderConfig)
    if args.price_trace is not None:
        providers = tuple(p.strip() for p in args.providers.split(",")
                          if p.strip())
        market = MarketConfig(providers=tuple(
            ProviderConfig(name=p, on_demand_rate=args.od_rate,
                           price_trace=str(Path(args.price_trace)
                                           / f"{p}.csv"))
            for p in providers))
        cfg = CloudConfig(market=market)
    else:
        cfg = CloudConfig(on_demand_rate=args.od_rate,
                          spot_rate_mean=args.spot_rate / 0.98,
                          spot_rate_sigma=0.0)
    return SpotMarket.for_cloud_config(cfg, seed=0)


# ---------------------------------------------------------------------------
# CLI.
# ---------------------------------------------------------------------------
def _dumps(obj: Any) -> str:
    """Byte-deterministic JSON: sorted keys, no timestamps."""
    return json.dumps(obj, sort_keys=True, indent=2)


def _cmd_summary(args) -> int:
    payloads = [summarize_path(p) for p in args.traces]
    if args.per_round:
        for p, path in zip(payloads, args.traces):
            p["per_round"] = per_round_rows(path)
    if args.json:
        print(_dumps(payloads))
    else:
        blocks = []
        for p in payloads:
            block = render_summary(p)
            if args.per_round:
                block += "\n" + render_per_round(p["trace"],
                                                 p["per_round"])
            blocks.append(block)
        print("\n\n".join(blocks))
    return 0


def _cmd_trends(args) -> int:
    rows = trend_rows(args.directory)
    print(_dumps(rows) if args.json else render_trends(rows))
    return 0


def _cmd_reconcile(args) -> int:
    failed = False
    for p in args.traces:
        rec = reconcile_path(p, tol=args.tol)
        print(render_reconciliation(rec, args.tol))
        failed = failed or not rec.ok
    return 1 if failed else 0


def _cmd_validate(args) -> int:
    if (args.epoch_s is None) == (args.roofline_flops is None):
        raise ValueError("validate needs exactly one of --epoch-s or "
                         "--roofline-flops/--roofline-bytes")
    if args.epoch_s is not None:
        epoch_s = [float(x) for x in args.epoch_s.split(",") if x.strip()]
    else:
        if args.roofline_bytes is None:
            raise ValueError("--roofline-flops requires --roofline-bytes")
        if args.peak_flops is None or args.hbm_bw is None:
            raise ValueError("--roofline-flops requires --peak-flops and "
                             "--hbm-bw (the device's measured peaks)")
        epoch_s = [_roofline_epoch_s(args)] * args.clients
    market = _validate_market(args)
    providers = None
    if not args.cross_provider:
        providers = (market.default_provider,)
    chk = screen_budget(epoch_s, args.epochs, args.budget, market,
                        spin_up_s=args.spin_up_s,
                        on_demand=args.on_demand, providers=providers)
    print(render_budget_check(chk))
    return 0 if chk.ok else 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Argparse entry point (`python -m repro_torch.cloud.report ...`);
    returns the process exit code: 0 on success, 1 on a failed
    reconciliation or refused budget, 2 on unreadable input."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.cloud.report",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summary",
                       help="per-client/provider/zone spend breakdown "
                            "of recorded traces")
    p.add_argument("traces", nargs="+", metavar="TRACE",
                   help="recorded .events.jsonl trace path(s)")
    p.add_argument("--json", action="store_true",
                   help="emit sorted-key JSON instead of the table")
    p.add_argument("--per-round", action="store_true",
                   help="append per-round cost attribution: dollars "
                        "settled inside each RoundStarted -> "
                        "RoundCompleted window, split into compute / "
                        "checkpoint / egress")
    p.set_defaults(func=_cmd_summary)

    p = sub.add_parser("trends",
                       help="cost/makespan/preemption trajectories "
                            "across every trace in a directory")
    p.add_argument("directory", metavar="DIR",
                   help="directory holding *.events.jsonl traces")
    p.add_argument("--json", action="store_true",
                   help="emit sorted-key JSON instead of the table")
    p.set_defaults(func=_cmd_trends)

    p = sub.add_parser("reconcile",
                       help="audit traces against the cost invariant; "
                            "nonzero exit on any divergence")
    p.add_argument("traces", nargs="+", metavar="TRACE",
                   help="recorded .events.jsonl trace path(s)")
    p.add_argument("--tol", type=float, default=RECONCILE_TOL,
                   help="dollar tolerance (default 1e-9)")
    p.set_defaults(func=_cmd_reconcile)

    p = sub.add_parser("validate",
                       help="pre-launch budget screening against "
                            "current market prices")
    p.add_argument("--budget", type=float, required=True,
                   help="run budget in dollars")
    p.add_argument("--epoch-s", default=None, metavar="LIST",
                   help="comma-separated per-client warm epoch seconds")
    p.add_argument("--epochs", type=int, default=10,
                   help="FL rounds to screen for (default 10)")
    p.add_argument("--spin-up-s", type=float, default=150.0,
                   help="provision+boot seconds per client (default 150)")
    p.add_argument("--on-demand", action="store_true",
                   help="price the launch at the default provider's "
                        "on-demand rate instead of cheapest spot")
    p.add_argument("--od-rate", type=float, default=1.008,
                   help="synthetic-market on-demand $/hr (default "
                        "1.008, the paper's g5.xlarge rate)")
    p.add_argument("--spot-rate", type=float, default=0.3951,
                   help="synthetic-market cheapest-zone spot $/hr "
                        "(default 0.3951)")
    p.add_argument("--price-trace", metavar="DIR", default=None,
                   help="price off real spot-history traces "
                        "(<provider>.csv per provider under DIR)")
    p.add_argument("--providers", metavar="NAMES", default="aws",
                   help="comma-separated provider list for "
                        "--price-trace (default: aws)")
    p.add_argument("--cross-provider", action="store_true",
                   help="let the requested placement span every "
                        "provider (default: default provider only; "
                        "the suggestion always searches all)")
    p.add_argument("--roofline-flops", type=float, default=None,
                   help="per-step FLOPs for a roofline-derived epoch "
                        "time (with --roofline-bytes)")
    p.add_argument("--roofline-bytes", type=float, default=None,
                   help="per-step HBM bytes for the roofline estimate")
    p.add_argument("--steps-per-epoch", type=int, default=100,
                   help="steps per epoch for the roofline estimate "
                        "(default 100)")
    p.add_argument("--peak-flops", type=float, default=None,
                   help="the device's peak FLOP/s for the roofline "
                        "estimate (required with --roofline-flops)")
    p.add_argument("--hbm-bw", type=float, default=None,
                   help="the device's memory bandwidth for the roofline "
                        "estimate, bytes/s (required with "
                        "--roofline-flops)")
    p.add_argument("--time-scale", type=float, default=1.0,
                   help="simulated seconds per roofline second "
                        "(default 1.0)")
    p.add_argument("--clients", type=int, default=1,
                   help="client count for the roofline path "
                        "(default 1)")
    p.set_defaults(func=_cmd_validate)

    args = ap.parse_args(argv)
    try:
        return args.func(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
