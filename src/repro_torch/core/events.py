"""Typed event bus connecting the cloud / cluster / engine layers.

The FedCostAware stack is layered (PR: multi-layer refactor):

  CloudSimulator   -- publishes cloud-level events (InstanceReady,
                      InstancePreempted, InstanceTerminated, BillingTick)
  ClusterManager   -- subscribes to cloud events, owns instance
                      lifecycle, re-publishes client-level events
                      (ClientReady, ClientLost)
  RoundEngine      -- subscribes to client events, owns FL-round
                      semantics (sync barrier / async buffered), and
                      publishes engine-level telemetry (RoundStarted,
                      RoundCompleted, ClientStateChanged,
                      BudgetExhausted)
  CostAccountant   -- subscribes to billing events, maintains per-client
                      accrued cost incrementally (O(1) queries)
  EventRecorder    -- wildcard subscriber (core.eventlog): serializes
                      the full stream to JSONL for offline replay

Events are frozen dataclasses dispatched by exact type. Publishing is
synchronous: `publish` invokes every subscriber before returning, so the
discrete-event simulator's deterministic ordering (heap + FIFO sequence
numbers) is preserved — a handler that schedules follow-up events does so
in the same order a direct callback would have.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import (Any, Callable, Dict, List, Mapping, Optional, Tuple,
                    Type)


@dataclasses.dataclass(frozen=True)
class Event:
    """Base class for all bus events; `t` is simulated time (seconds)."""
    t: float


# ---------------------------------------------------------------------------
# Cloud-layer events (published by CloudSimulator).
# `instance` fields are `repro_torch.cloud.simulator.Instance`; typed as Any to
# keep the core layer free of cloud imports.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InstanceRequested(Event):
    """Placement chosen for an instance; spin-up begins."""
    instance: Any


@dataclasses.dataclass(frozen=True)
class InstanceReady(Event):
    """Instance finished spinning up; billing starts now."""
    instance: Any


@dataclasses.dataclass(frozen=True)
class InstancePreemptionWarning(Event):
    """Provider reclaim notice (e.g. AWS's 2-minute warning): the
    instance will be preempted at `reclaim_at` unless terminated first.
    Only emitted when the instance's provider has a non-zero
    `preemption_notice_s`."""
    instance: Any
    reclaim_at: float


@dataclasses.dataclass(frozen=True)
class InstancePreempted(Event):
    """Spot market reclaimed a RUNNING instance (billing already closed)."""
    instance: Any


@dataclasses.dataclass(frozen=True)
class InstanceTerminated(Event):
    """Deliberate terminate (paper's terminate-specific-node API)."""
    instance: Any


@dataclasses.dataclass(frozen=True)
class BillingTick(Event):
    """A billing segment [t0, t1) closed, charging `amount` dollars.

    Emitted whenever the simulator finalizes billing (terminate or
    preemption); `t1 - t0` already includes the min-billing floor.
    """
    instance: Any
    client: str
    t0: float
    t1: float
    amount: float


# ---------------------------------------------------------------------------
# Cluster-layer events (published by ClusterManager). Only fired for
# instances the cluster currently tracks — stale cloud events (e.g. a
# preemption racing a deliberate replace) are filtered out below this
# layer, so engines never see them.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ClientReady(Event):
    """The client's tracked instance became RUNNING.

    `resume_token` carries engine-opaque recovery state when this ready
    answers a resume-from-checkpoint request (set via
    `ClusterManager.request(..., resume_token=...)`), else None.
    """
    client: str
    instance: Any
    cold: bool
    resume_token: Optional[Any] = None


@dataclasses.dataclass(frozen=True)
class ClientPreemptionWarning(Event):
    """The client's tracked instance received its provider's reclaim
    notice: it will be preempted at `reclaim_at` unless terminated
    first. The cluster-level translation of
    `InstancePreemptionWarning`, filtered the same way as
    `ClientReady`/`ClientLost` — engines never see warnings for
    instances the cluster no longer tracks."""
    client: str
    instance: Any
    reclaim_at: float


@dataclasses.dataclass(frozen=True)
class ClientLost(Event):
    """The client's tracked instance was preempted (cluster already
    dropped it; the engine decides whether/how to recover)."""
    client: str
    instance: Any


@dataclasses.dataclass(frozen=True)
class ClientCheckpointed(Event):
    """A preemption-notice-triggered checkpoint landed in cloud storage
    inside the warning window (engine `on_warning` policy "checkpoint"
    or "drain"): the client's training state through `progress_s`
    seconds of the epoch is durable, so a reclaim now only loses work
    done after the snapshot. `remaining_s` is the epoch time still owed
    if the client resumes from this snapshot. `size_mb` is the model
    state written and `provider` the cloud the writing instance runs
    on — what the provider's `StorageRates` bill (schema v4; absent
    in older logs and defaulted on decode)."""
    client: str
    round_idx: int
    progress_s: float
    remaining_s: float
    reclaim_at: float
    size_mb: float = 0.0
    provider: str = ""


@dataclasses.dataclass(frozen=True)
class ClientResumedFromCheckpoint(Event):
    """A replacement instance picked the client's training up from its
    warning-window checkpoint (rather than re-doing the round
    contribution from the last periodic checkpoint); the client owes
    only `remaining_s` seconds of epoch time."""
    client: str
    round_idx: int
    remaining_s: float


# ---------------------------------------------------------------------------
# Engine-level telemetry events (published by RoundEngines / the runner).
# These make a run fully observable on the bus: an `EventRecorder`
# (core.eventlog) that captures them plus the cloud/cluster events above
# holds everything needed to rebuild timelines and cost curves offline.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RoundStarted(Event):
    """An FL round opened with the given participant set."""
    round_idx: int
    participants: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class RoundCompleted(Event):
    """Aggregation fired for `round_idx`.

    `client_costs` is the accountant's cumulative per-client spend at
    the instant of aggregation — recorded here so replay consumers can
    rebuild the Fig-5 cost curve without re-pricing open segments.
    """
    round_idx: int
    participants: Tuple[str, ...]
    client_costs: Mapping[str, float]


@dataclasses.dataclass(frozen=True)
class ClientStateChanged(Event):
    """Fig-4 operational-state transition for one client.

    `state` is one of spinup | training | idle | savings | done; "done"
    closes the client's timeline without opening a new segment.
    """
    client: str
    state: str


@dataclasses.dataclass(frozen=True)
class BudgetExhausted(Event):
    """Budget screening (§III-E) permanently excluded `client`."""
    client: str


@dataclasses.dataclass(frozen=True)
class ClientScreenedOut(Event):
    """A `ScreenOut` directive was executed: budget screening excluded
    `client` from `round_idx` on (schema v4). Follows the
    `BudgetExhausted` event and precedes the instance teardown."""
    client: str
    round_idx: int = -1


@dataclasses.dataclass(frozen=True)
class DirectiveIssued(Event):
    """Observability trace of one executed strategy directive (schema
    v4). Only published when directive tracing is enabled
    (`FLRunConfig.trace_directives`) — default event streams carry
    none, keeping golden traces unmoved. `kind` is the directive class
    name; `detail` a short human-readable argument summary."""
    kind: str
    client: str
    detail: str = ""


@dataclasses.dataclass(frozen=True)
class CheckpointBilled(Event):
    """Storage dollars charged for one warning-window checkpoint write
    (S3 PUT + per-MB egress, the provider's `StorageRates`; schema v4).
    Published by the live `CostAccountant` so replay consumers rebuild
    the same checkpoint spend without a price book. Only published when
    the charge is non-zero."""
    client: str
    amount: float


@dataclasses.dataclass(frozen=True)
class ClientUpdateSent(Event):
    """A client finished local training and uploaded its model update
    to the aggregation server (schema v7, the comms subsystem
    `repro_torch.comms`). `size_mb` is the payload actually sent — the fp32
    pytree bytes, or the grad_quant int8 (blocks + scales) layout when
    `quantized` — and `transfer_s` how long the upload occupied the
    client's uplink (0 on an unmodeled/instantaneous channel).
    `provider`/`zone` locate the instance the update left from, which
    is what `TransferRates` egress pricing keys on. Only published
    when a run enables comms modeling (`FLRunConfig.update_payload_mb`
    or payload-exposing trainer hooks) — default event streams carry
    none, keeping golden traces unmoved."""
    client: str
    round_idx: int
    size_mb: float
    quantized: bool = False
    provider: str = ""
    zone: str = ""
    transfer_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class TransferBilled(Event):
    """Egress dollars charged for one client-update upload (the
    provider's `TransferRates`; schema v7). Published by the live
    `CostAccountant` in response to `ClientUpdateSent`, mirroring
    `CheckpointBilled`, so replay consumers rebuild the same transfer
    spend without a price book. Only published when the charge is
    non-zero."""
    client: str
    amount: float


@dataclasses.dataclass(frozen=True)
class FleetStepSummary(Event):
    """Aggregate fleet telemetry for one simulation step (one FL round
    of the vectorized fleet core, schema v6).

    Above `CloudConfig.fleet_threshold` the struct-of-arrays hot path
    (`repro_torch.cloud.fleet`) batches thousands of instance lifecycles per
    step; publishing the per-instance vocabulary would cost more than
    the simulation itself, so the fleet emits one summary per step
    instead: lifecycle counts, the dollars *settled* this step
    (`cost_delta`; the sum over a complete run equals the run's total
    cost, which is what replay accounting folds), and per-"provider/
    zone" breakdowns. `open_accrued` is the informational accrued cost
    of still-open billing segments at step end — replay consumers must
    not fold it (those dollars settle in a later step's delta).

    `client_cost_delta` (schema v6) attributes the step's settled
    dollars per client — only clients that settled a nonzero amount
    this step appear, and the values sum to `cost_delta`. Replay
    accounting folds the map into per-client totals (it must NOT also
    fold it into the run total; `cost_delta` already is that sum). A
    v5 log decodes with the empty default, which replay consumers
    report as *unattributed* rather than pretending every client cost
    zero dollars."""
    step_idx: int                # round index of the fleet step
    n_clients: int               # participants (cohort) this step
    n_spinups: int               # fresh instances requested
    n_preemptions: int           # spot reclaims absorbed
    n_terminations: int          # deliberate (Listing-1 / final) stops
    cost_delta: float            # dollars settled during this step
    open_accrued: float          # accrued-but-unsettled dollars, step end
    by_zone: Mapping[str, Mapping[str, float]]  # "provider/zone" -> aggs
    # client -> dollars settled this step (v6+; empty on v5 replays)
    client_cost_delta: Mapping[str, float] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass(frozen=True)
class ForecastUpdated(Event):
    """One learned-forecast evaluation for a tracked training spot
    client (schema v8, the `repro_torch.forecast` subsystem). Published by
    `LearnedForecastStrategy` once per poll: the predicted
    interruption probability over `horizon_s` (`p_interrupt`, from
    `hazard_per_hr`), the learned price band (`price_lo` / `price_mid`
    / `price_hi`; zeros when the forecaster does not model prices),
    the running calibration metrics (`brier`, `coverage`; -1.0 before
    their first resolution) and the cost-of-error `action` chosen
    ("hold" / "prewarm" / "release" / "checkpoint" /
    "prewarm+checkpoint" / "drain"). Only published when a policy
    composes the learned strategy — default event streams carry none,
    keeping golden traces unmoved."""
    client: str
    provider: str = ""
    zone: str = ""
    forecaster: str = ""
    horizon_s: float = 0.0
    p_interrupt: float = 0.0
    hazard_per_hr: float = 0.0
    price_lo: float = 0.0
    price_mid: float = 0.0
    price_hi: float = 0.0
    brier: float = -1.0
    coverage: float = -1.0
    action: str = "hold"


@dataclasses.dataclass(frozen=True)
class RunCompleted(Event):
    """Terminal event carrying the run summary.

    Published by the composition root *after* the event heap drains (the
    sync engine's makespan includes post-finish drain time, so only the
    runner knows it). `client_costs` equals the accountant's final
    per-client totals; costs are frozen once the engine finishes, so the
    snapshot is identical at finish and at drain.
    """
    makespan_s: float
    total_cost: float
    client_costs: Mapping[str, float]
    rounds_completed: int
    excluded_clients: Tuple[str, ...]
    final_round_idx: int


# Name -> type registry for (de)serialization (core.eventlog). Every
# event class that can appear on a recorded bus must be listed.
EVENT_TYPES: Dict[str, Type[Event]] = {
    cls.__name__: cls for cls in (
        InstanceRequested, InstanceReady, InstancePreemptionWarning,
        InstancePreempted, InstanceTerminated, BillingTick, ClientReady,
        ClientPreemptionWarning, ClientLost, ClientCheckpointed,
        ClientResumedFromCheckpoint, RoundStarted, RoundCompleted,
        ClientStateChanged, BudgetExhausted, ClientScreenedOut,
        DirectiveIssued, CheckpointBilled, ClientUpdateSent,
        TransferBilled, FleetStepSummary, ForecastUpdated, RunCompleted,
    )
}


# ---------------------------------------------------------------------------
# Bus.
# ---------------------------------------------------------------------------
Handler = Callable[[Event], None]


class EventBus:
    """Minimal synchronous pub/sub keyed by exact event type."""

    def __init__(self):
        self._subs: Dict[Type[Event], List[Handler]] = defaultdict(list)
        self._all: List[Handler] = []

    def subscribe(self, etype: Type[Event], handler: Handler) -> Handler:
        """Call `handler` for every future event of exactly `etype`
        (no subclass dispatch); returns `handler` for unsubscribing."""
        self._subs[etype].append(handler)
        return handler

    def subscribe_all(self, handler: Handler) -> Handler:
        """Wildcard subscription: `handler` sees every published event
        (before type-keyed subscribers). Used by the event recorder."""
        self._all.append(handler)
        return handler

    def unsubscribe(self, etype: Type[Event], handler: Handler) -> None:
        """Remove a type-keyed subscription added by `subscribe`."""
        self._subs[etype].remove(handler)

    def unsubscribe_all(self, handler: Handler) -> None:
        """Remove a wildcard subscription added by `subscribe_all`."""
        self._all.remove(handler)

    def publish(self, event: Event) -> None:
        """Synchronously invoke every subscriber (wildcards first,
        then type-keyed, each in subscription order) before returning."""
        # snapshot: a handler may (un)subscribe while we iterate
        for h in list(self._all):
            h(event)
        for h in list(self._subs[type(event)]):
            h(event)
