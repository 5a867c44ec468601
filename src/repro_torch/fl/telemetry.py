"""Run telemetry as pure bus consumers.

`TimelineRecorder` (the Fig-4 client-state timeline) and
`CostCurveRecorder` (the Fig-5 cumulative cost curve) are driven
entirely by engine-level telemetry events (`ClientStateChanged`,
`RoundCompleted`, `RunCompleted`) — they never read the simulator
clock. The same consumer therefore works in two modes:

  live    — subscribed to the run's bus while the simulation executes
  replay  — subscribed to a fresh bus fed by `EventReplayer`
            (core.eventlog), rebuilding timelines / costs offline from
            a recorded `.events.jsonl` without invoking `CloudSimulator`

`replay_result` is the offline entry point: it wires replay-mode
consumers (including a price-book-free `CostAccountant`) to a fresh bus,
replays a trace, and assembles a full `RunResult` — what
`benchmarks/fig4_timeline.py --replay` / `fig5_costs.py --replay` render
from.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Tuple, Union

from repro_torch.core.events import (ClientStateChanged, EventBus, RoundCompleted,
                               RunCompleted)


@dataclasses.dataclass
class Segment:
    """One closed span of a client's Fig-4 operational state."""
    client: str
    state: str          # spinup | training | uploading | idle | savings
    t0: float
    t1: float


class TimelineRecorder:
    """Per-client open/close segment bookkeeping off `ClientStateChanged`
    events: each event closes the client's previous segment at `ev.t`
    and opens `ev.state` ("done" closes without opening)."""

    def __init__(self, bus: EventBus):
        self.segments: List[Segment] = []
        bus.subscribe(ClientStateChanged, self._on_state)

    def _on_state(self, ev: ClientStateChanged):
        self.mark(ev.client, ev.state, ev.t)

    def mark(self, client: str, state: str, t: float):
        """Close the client's open segment at `t` and open `state`
        ("done" closes without opening)."""
        for seg in reversed(self.segments):
            if seg.client == client and seg.t1 < 0:
                seg.t1 = t
                break
        if state != "done":
            self.segments.append(Segment(client, state, t, -1.0))

    def close(self, t: float):
        """Safety net: close every still-open segment at `t`. A no-op on
        complete streams — engines publish "done" for every client."""
        for seg in self.segments:
            if seg.t1 < 0:
                seg.t1 = t

def state_totals(segments: List[Segment]) -> Dict[Tuple[str, str], float]:
    """`TimelineRecorder.state_totals` over an already-built segment list
    (e.g. a `RunResult.timeline`)."""
    totals: Dict[Tuple[str, str], float] = {}
    for seg in segments:
        key = (seg.client, seg.state)
        totals[key] = totals.get(key, 0.0) + (seg.t1 - seg.t0)
    return totals


class CostCurveRecorder:
    """Rebuilds the Fig-5 cost curve from `RoundCompleted` /
    `RunCompleted` events: one `{t, client, cum_cost, round}` record per
    (event, client), reading the cost snapshots the engine embedded at
    aggregation time. The final (`RunCompleted`) records carry the
    drain-time `t` rather than the engine-finish `t` of a live run's
    last snapshot; costs are frozen by then, so the dollar values are
    identical.
    """

    def __init__(self, bus: EventBus):
        self.records: List[dict] = []
        bus.subscribe(RoundCompleted, self._on_round)
        bus.subscribe(RunCompleted, self._on_run)

    def _append(self, t: float, round_idx: int, client_costs):
        for c, cost in client_costs.items():
            self.records.append({"t": t, "client": c, "cum_cost": cost,
                                 "round": round_idx})

    def _on_round(self, ev: RoundCompleted):
        self._append(ev.t, ev.round_idx, ev.client_costs)

    def _on_run(self, ev: RunCompleted):
        self._append(ev.t, ev.final_round_idx, ev.client_costs)


# ---------------------------------------------------------------------------
# Offline replay -> RunResult.
# ---------------------------------------------------------------------------
def replay_result(source: Union[str, Path, "EventReplayer"]) -> "RunResult":
    """Rebuild a `RunResult` from a recorded event log.

    Costs come from a replay-mode `CostAccountant` folding the recorded
    `BillingTick`s (not from the `RunCompleted` summary), so replayed
    totals are an independent check against the live run — the
    differential oracle the golden-trace tests rely on.
    """
    from repro_torch.cloud.accounting import CostAccountant
    from repro_torch.core.eventlog import EventReplayer
    from repro_torch.fl.types import RunResult

    replayer = source if isinstance(source, EventReplayer) \
        else EventReplayer.load(source)

    bus = EventBus()
    accountant = CostAccountant(bus)
    timeline = TimelineRecorder(bus)
    curve = CostCurveRecorder(bus)
    per_round: List[List[str]] = []
    summary: List[RunCompleted] = []
    bus.subscribe(RoundCompleted,
                  lambda ev: per_round.append(list(ev.participants)))
    bus.subscribe(RunCompleted, summary.append)

    replayer.replay(bus)

    if not summary:
        raise ValueError("event log has no RunCompleted summary "
                         "(truncated recording?)")
    done = summary[-1]
    timeline.close(done.t)
    # union of the summary's clients and everyone the accountant saw a
    # dollar for — fleet traces leave `RunCompleted.client_costs` empty
    # and attribute through FleetStepSummary.client_cost_delta instead
    clients = sorted(set(done.client_costs) | set(accountant.per_client()))
    has_clients = accountant.has_client_costs()
    return RunResult(
        total_cost=accountant.total_cost(),
        per_client_cost=({c: accountant.client_cost(c) for c in clients}
                         if has_clients else {}),
        makespan_s=done.makespan_s,
        timeline=timeline.segments,
        cost_curve=curve.records,
        rounds_completed=done.rounds_completed,
        excluded_clients=list(done.excluded_clients),
        per_round_participants=per_round,
        checkpoint_cost=accountant.checkpoint_cost_total(),
        comm_cost=accountant.transfer_cost_total(),
        has_client_costs=has_clients)
