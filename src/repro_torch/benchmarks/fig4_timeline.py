"""Paper Fig. 4 reproduction: client operational states over time
(training / spinup / idle / savings) for Fed-ISIC2019, 6 clients x 20
epochs under FedCostAware. Emits an ASCII Gantt + per-state totals.

Pure reporter: the paper's qualitative claims are asserted in
tests/test_paper_claims.py (via golden-trace replay), not here.

Offline mode: `--replay run.events.jsonl` renders from a recorded event
log without re-running the simulation (no CloudSimulator involved);
`--record path` records the fresh run it renders.
"""
from __future__ import annotations

import argparse
from typing import Optional

from repro_torch.benchmarks.table1 import ROWS, run_row
from repro_torch.core.eventlog import EventReplayer
from repro_torch.fl.telemetry import replay_result, state_totals


def describe(header: dict) -> str:
    """One-line run identity from a recorded trace's metadata header
    (the same dict `EventRecorder` stamps on every `FLCloudRunner`
    recording)."""
    n = header.get("n_clients", len(header.get("clients", [])))
    return (f"{header.get('dataset', '?')}, {n} clients x "
            f"{header.get('n_epochs', '?')} epochs, "
            f"{header.get('policy', '?')}")


def header_of(row, policy: str) -> dict:
    """describe()-compatible header for a fresh Table-1 row run."""
    return {"dataset": row.dataset, "n_clients": row.n_clients,
            "n_epochs": row.n_epochs, "policy": policy}


def run(replay: Optional[str] = None, record: Optional[str] = None):
    if replay is not None:
        replayer = EventReplayer.load(replay)
        res = replay_result(replayer)
        desc = describe(replayer.header)
    else:
        row = ROWS[0]                   # Fed-ISIC2019
        res = run_row(row, "fedcostaware", record_to=record)
        desc = describe(header_of(row, "fedcostaware"))
    by_client = {}
    for seg in res.timeline:
        by_client.setdefault(seg.client, []).append(seg)
    return res, by_client, state_totals(res.timeline), desc


GLYPH = {"training": "#", "spinup": "^", "idle": ".", "savings": " "}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--replay", metavar="EVENTS_JSONL", default=None,
                      help="render from a recorded event log "
                           "(no simulation)")
    mode.add_argument("--record", metavar="EVENTS_JSONL", default=None,
                      help="record the fresh run's event log to this path")
    args = ap.parse_args(argv)
    try:
        res, by_client, totals, desc = run(replay=args.replay,
                                           record=args.record)
    except (ValueError, OSError) as e:
        # truncated/corrupt JSONL or an unknown future schema: a
        # one-line error and nonzero exit, not a raw traceback
        raise SystemExit(f"error: {e}")
    width = 100
    scale = res.makespan_s / width
    src = f"replay of {args.replay}" if args.replay else "fresh run"
    print(f"# {desc} (makespan {res.makespan_s/60:.0f} min, {src})")
    print("# '#'=training  '^'=spinup  '.'=idle(billed)  ' '=off(savings)")
    for client in sorted(by_client):
        line = [" "] * width
        for seg in by_client[client]:
            a = int(seg.t0 / scale)
            b = max(int(seg.t1 / scale), a + 1)
            for i in range(a, min(b, width)):
                line[i] = GLYPH.get(seg.state, "?")
        print(f"{client:10s} |{''.join(line)}|")
    print("\nclient,training_min,spinup_min,idle_min,savings_min")
    clients = sorted({c for c, _ in totals})
    for c in clients:
        vals = [totals.get((c, s), 0.0) / 60
                for s in ("training", "spinup", "idle", "savings")]
        print(f"{c}," + ",".join(f"{v:.1f}" for v in vals))


if __name__ == "__main__":
    main()
