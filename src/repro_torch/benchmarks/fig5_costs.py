"""Paper Fig. 5 reproduction: accumulated per-client cost over the 20
FedCostAware rounds on Fed-ISIC2019.

Pure reporter: the curve invariants (monotonicity, slowest-client
dominance) are asserted in tests/test_paper_claims.py via golden-trace
replay, not here.

Offline mode: `--replay run.events.jsonl` rebuilds the cost curve from
a recorded event log's `RoundCompleted` snapshots without re-running the
simulation; `--record path` records the fresh run it renders.
"""
from __future__ import annotations

import argparse
from typing import Optional

from repro_torch.benchmarks.fig4_timeline import describe, header_of
from repro_torch.benchmarks.table1 import ROWS, run_row, trace_market
from repro_torch.core.eventlog import EventReplayer
from repro_torch.fl.telemetry import replay_result


def run(replay: Optional[str] = None, record: Optional[str] = None,
        price_trace: Optional[str] = None,
        providers: tuple = ("aws",)):
    if replay is not None:
        replayer = EventReplayer.load(replay)
        res = replay_result(replayer)
        desc = describe(replayer.header)
    else:
        row = ROWS[0]
        market = (trace_market(price_trace, providers, row.od_rate)
                  if price_trace is not None else None)
        res = run_row(row, "fedcostaware", record_to=record,
                      market=market)
        desc = describe(header_of(row, "fedcostaware"))
        if price_trace is not None:
            desc += f" (trace market: {','.join(providers)})"
        else:
            desc += " (paper: $7.1740)"
    # cost_curve: one record per (round end, client)
    rounds = sorted({r["round"] for r in res.cost_curve})
    clients = sorted({r["client"] for r in res.cost_curve})
    table = {c: {} for c in clients}
    for rec in res.cost_curve:
        table[rec["client"]][rec["round"]] = rec["cum_cost"]
    return rounds, clients, table, res, desc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--replay", metavar="EVENTS_JSONL", default=None,
                      help="render from a recorded event log "
                           "(no simulation)")
    mode.add_argument("--record", metavar="EVENTS_JSONL", default=None,
                      help="record the fresh run's event log to this path")
    ap.add_argument("--price-trace", metavar="DIR", default=None,
                    help="price the fresh run off real spot-history "
                         "traces (<provider>.csv per provider under DIR)")
    ap.add_argument("--providers", metavar="NAMES", default="aws",
                    help="comma-separated provider list for "
                         "--price-trace (default: aws)")
    args = ap.parse_args(argv)
    providers = tuple(p.strip() for p in args.providers.split(",")
                      if p.strip())
    try:
        rounds, clients, table, res, desc = run(
            replay=args.replay, record=args.record,
            price_trace=args.price_trace, providers=providers)
    except (ValueError, OSError) as e:
        # truncated/corrupt JSONL or an unknown future schema: a
        # one-line error and nonzero exit, not a raw traceback
        raise SystemExit(f"error: {e}")
    print(f"# {desc}")
    print("round," + ",".join(clients))
    for r in rounds:
        vals = [table[c].get(r, float("nan")) for c in clients]
        print(f"{r}," + ",".join(f"{v:.4f}" for v in vals))
    final = {c: table[c][rounds[-1]] for c in clients}
    total = sum(final.values())
    print(f"\n# total = ${total:.4f}")


if __name__ == "__main__":
    main()
