"""Event-log record/replay: persist a run's typed event stream, rebuild
it offline.

`EventRecorder` subscribes (wildcard) to an `EventBus` and serializes
every frozen event dataclass to JSONL: one header line carrying the
schema version + run metadata, then one line per event in publish order.
Object references (`repro_torch.cloud.simulator.Instance`) are replaced by a
stable snapshot keyed on the instance id, taken at publish time — the
log is plain data, diffable across runs, and two runs of the same
seeded config produce byte-comparable streams (the determinism CI job
relies on this).

`EventReplayer` parses a recorded stream back into typed events
(instances become frozen `InstanceRef` stand-ins) and re-publishes them
onto a fresh bus in recorded order. Pure consumers — `CostAccountant`
with no price book, `TimelineRecorder`, `CostCurveRecorder`
(fl.telemetry) — then rebuild per-client costs, Fig-4 timelines and
Fig-5 cost curves without ever touching `CloudSimulator`. That is the
record-then-audit discipline of Multi-FedLS-style post-hoc cost
accounting, and it turns recorded traces into golden regression
fixtures (tests/golden/).

Layering: this module depends only on `core.events` and the stdlib.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from repro_torch.core.events import EVENT_TYPES, Event, EventBus

# Schema history (full vocabulary per version in docs/events.md):
#   v1 — engine-split vocabulary; instance snapshots without provider
#   v2 — instance snapshots carry the provider of the zone they run in
#        (multi-cloud SpotMarket); v1 logs decode with the
#        single-provider default on InstanceRef
#   v3 — preemption-notice checkpointing vocabulary:
#        ClientPreemptionWarning / ClientCheckpointed /
#        ClientResumedFromCheckpoint. Purely additive — v1/v2 logs
#        (golden copies under tests/golden/v1, tests/golden/v2) replay
#        unchanged.
#   v4 — strategy-API vocabulary: DirectiveIssued (opt-in directive
#        tracing), ClientScreenedOut (§III-E exclusions),
#        CheckpointBilled (storage dollars per warning checkpoint);
#        ClientCheckpointed gains `size_mb`. Purely additive — v1–v3
#        logs (golden copies under tests/golden/v1..v3) replay
#        unchanged; fields absent from older logs take their
#        dataclass defaults on decode.
#   v5 — fleet-core vocabulary: FleetStepSummary (aggregate per-step
#        lifecycle counts + settled cost deltas per provider/zone,
#        emitted by the struct-of-arrays fleet path above
#        `CloudConfig.fleet_threshold` in place of per-instance
#        events). Purely additive — v1–v4 logs (golden copies under
#        tests/golden/v1..v4) replay unchanged, and sub-threshold runs
#        still record the exact per-instance vocabulary.
#   v6 — FleetStepSummary gains `client_cost_delta` (client -> dollars
#        settled that step, summing to `cost_delta`), fixing the v5
#        replay gap where fleet traces rebuilt the correct run total
#        but reported every per-client cost as zero. Purely additive —
#        v1–v5 logs (golden copies under tests/golden/v1..v5) replay
#        unchanged; a v5 summary decodes with an empty map, which
#        replay accounting surfaces as "per-client attribution absent"
#        (`RunResult.has_client_costs=False`) instead of zeros.
#   v7 — communication-cost vocabulary (the `repro_torch.comms` subsystem):
#        ClientUpdateSent (one per client-update upload: payload MB,
#        quantized flag, provider/zone, transfer seconds) and
#        TransferBilled (egress dollars the live accountant priced for
#        that upload, mirroring CheckpointBilled). Purely additive —
#        v1–v6 logs (golden copies under tests/golden/v1..v6) replay
#        unchanged, and runs without comms modeling (the default:
#        `FLRunConfig.update_payload_mb=None`, zero egress rates)
#        record streams identical to v6 apart from the header.
#   v8 — learned-forecast vocabulary (the `repro_torch.forecast` subsystem):
#        ForecastUpdated (one per forecast poll per tracked training
#        spot client: predicted interruption probability + hazard,
#        learned price band, running Brier/coverage calibration, and
#        the cost-of-error action chosen). Headers may additionally
#        carry `hazard_source` ("oracle" | "observable" | "mixed")
#        naming which hazard signal the run's strategies actually
#        consulted — absent when none did. Purely additive — v1–v7
#        logs (golden copies under tests/golden/v1..v7) replay
#        unchanged, and runs without a learned-forecast strategy (the
#        default policies) record streams identical to v7 apart from
#        the header.
SCHEMA_VERSION = 8
SUPPORTED_SCHEMAS = (1, 2, 3, 4, 5, 6, 7, 8)

_SCALARS = (bool, int, float, str)


@dataclasses.dataclass(frozen=True)
class InstanceRef:
    """Replay-side stand-in for a live `Instance`: the recorded snapshot
    of its scalar fields at event time. Replayed billing segments are
    always already closed, hence the class-level `_billing_from` — the
    accountant's open-segment pricing sees `None` and charges nothing.

    `provider` defaults to the single provider every v1 log implicitly
    ran on, so v1 snapshots (no provider key) decode losslessly.
    """
    iid: int
    client: str
    zone: str
    on_demand: bool
    t_request: float
    t_ready: Optional[float] = None
    t_end: Optional[float] = None
    state: str = "spinning_up"
    provider: str = "aws"

    _billing_from = None        # class attr on purpose: never a field


_INSTANCE_FIELDS = tuple(f.name for f in dataclasses.fields(InstanceRef))


# ---------------------------------------------------------------------------
# Encoding (live objects -> JSON-ready dicts).
# ---------------------------------------------------------------------------
def _encode_value(v: Any) -> Any:
    if v is None or isinstance(v, _SCALARS):
        return v
    if hasattr(v, "iid") and hasattr(v, "client"):     # Instance(-Ref)
        return {"$instance": {f: getattr(v, f, None)
                              for f in _INSTANCE_FIELDS}}
    if isinstance(v, dict):
        return {str(k): _encode_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_encode_value(x) for x in v]
    raise TypeError(f"event field of type {type(v).__name__} is not "
                    f"serializable: {v!r}")


def encode_event(ev: Event) -> Dict[str, Any]:
    """Event dataclass -> JSON-ready dict (`type` key + every field,
    instances snapshotted)."""
    rec: Dict[str, Any] = {"type": type(ev).__name__}
    for f in dataclasses.fields(ev):
        rec[f.name] = _encode_value(getattr(ev, f.name))
    return rec


def _decode_value(v: Any) -> Any:
    if isinstance(v, dict):
        if "$instance" in v:
            return InstanceRef(**v["$instance"])
        return {k: _decode_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return tuple(_decode_value(x) for x in v)
    return v


def decode_event(rec: Dict[str, Any]) -> Event:
    """Inverse of `encode_event`; instance snapshots decode to
    `InstanceRef`. Raises on event types absent from `EVENT_TYPES`.
    Fields an older-schema log does not carry (e.g. v3's
    `ClientCheckpointed` without `size_mb`) take their dataclass
    defaults, so additive field growth never breaks replay."""
    name = rec["type"]
    if name not in EVENT_TYPES:
        raise ValueError(f"unknown event type in log: {name!r}")
    cls = EVENT_TYPES[name]
    kwargs = {f.name: _decode_value(rec[f.name])
              for f in dataclasses.fields(cls) if f.name in rec}
    return cls(**kwargs)


# ---------------------------------------------------------------------------
# Recorder.
# ---------------------------------------------------------------------------
class EventRecorder:
    """Captures every event published on `bus` as an encoded record.

    Events are encoded at publish time, so the log reflects instance
    state at the instant of each event even though `Instance` objects
    mutate afterwards.
    """

    def __init__(self, bus: EventBus, meta: Optional[Dict[str, Any]] = None):
        self.header: Dict[str, Any] = {"schema": SCHEMA_VERSION,
                                       **(meta or {})}
        self.records: List[Dict[str, Any]] = []
        bus.subscribe_all(self._on_event)

    def _on_event(self, ev: Event) -> None:
        self.records.append(encode_event(ev))

    # ------------------------------------------------------------------
    def dumps(self) -> str:
        """The full log as JSONL text: header line, then one event per
        line in publish order."""
        # no sort_keys: dataclass field order and profile insertion
        # order are deterministic, and preserving them keeps replayed
        # dict iteration (e.g. cost-curve client order) identical to
        # the live run's.
        lines = [json.dumps(self.header)]
        lines.extend(json.dumps(r) for r in self.records)
        return "\n".join(lines) + "\n"

    def dump(self, path: Union[str, Path]) -> Path:
        """Write `dumps()` to `path`, creating parent directories."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.dumps())
        return path


# ---------------------------------------------------------------------------
# Read-only stream access (shared by the replayer and the reporting
# CLI, repro_torch.cloud.report). Errors are one-line ValueErrors naming the
# source and line number — replay-consuming entry points print them
# verbatim instead of a raw traceback on truncated/corrupt logs.
# ---------------------------------------------------------------------------
def _parse_header(line: str, source: str) -> Dict[str, Any]:
    try:
        header = json.loads(line)
    except json.JSONDecodeError as e:
        raise ValueError(
            f"{source}: header line is not valid JSON ({e.msg}) — "
            f"corrupt file or not a recorded event log") from None
    if not isinstance(header, dict) or "schema" not in header:
        raise ValueError(
            f"{source}: header carries no schema field — not a "
            f"recorded event log")
    if header["schema"] not in SUPPORTED_SCHEMAS:
        raise ValueError(
            f"{source}: event log schema {header['schema']!r} not in "
            f"supported {SUPPORTED_SCHEMAS}")
    return header


def read_header(path: Union[str, Path]) -> Dict[str, Any]:
    """Parse only a recorded trace's header line (schema + run
    metadata) without decoding any events — the cheap identity lookup
    `repro_torch.cloud.report trends` scans whole directories with."""
    path = Path(path)
    with path.open() as fh:
        for line in fh:
            if line.strip():
                return _parse_header(line, str(path))
    raise ValueError(f"{path}: empty event log")


def iter_events(path: Union[str, Path]):
    """Lazily decode a recorded trace's events in publish order (header
    validated first). Corrupt or truncated lines raise a one-line
    `ValueError` naming the source and line number instead of leaking
    a raw `json` traceback."""
    path = Path(path)
    saw_header = False
    with path.open() as fh:
        for lineno, line in enumerate(fh, start=1):
            if not line.strip():
                continue
            if not saw_header:
                _parse_header(line, str(path))
                saw_header = True
                continue
            yield _decode_line(line, lineno, str(path))
    if not saw_header:
        raise ValueError(f"{path}: empty event log")


def _decode_line(line: str, lineno: int, source: str) -> Event:
    try:
        rec = json.loads(line)
    except json.JSONDecodeError:
        raise ValueError(
            f"{source}: line {lineno} is not valid JSON — truncated "
            f"or corrupt event log") from None
    try:
        return decode_event(rec)
    except (TypeError, KeyError, ValueError) as e:
        raise ValueError(f"{source}: line {lineno}: {e}") from None


# ---------------------------------------------------------------------------
# Replayer.
# ---------------------------------------------------------------------------
class EventReplayer:
    """Re-publishes a recorded stream onto a bus, in recorded order."""

    def __init__(self, header: Dict[str, Any], events: List[Event]):
        self.header = header
        self.events = events

    @classmethod
    def loads(cls, text: str,
              source: str = "event log") -> "EventReplayer":
        """Parse JSONL log text; rejects unsupported schema versions
        and raises one-line, line-numbered `ValueError`s on corrupt
        or truncated input."""
        numbered = [(i, ln) for i, ln in enumerate(text.splitlines(),
                                                  start=1) if ln.strip()]
        if not numbered:
            raise ValueError(f"{source}: empty event log")
        header = _parse_header(numbered[0][1], source)
        events = [_decode_line(ln, i, source) for i, ln in numbered[1:]]
        return cls(header, events)

    @classmethod
    def load(cls, path: Union[str, Path]) -> "EventReplayer":
        """`loads` over a file on disk (errors name the path)."""
        return cls.loads(Path(path).read_text(), source=str(path))

    def replay(self, bus: EventBus) -> None:
        """Publish every recorded event onto `bus`, in recorded order."""
        for ev in self.events:
            bus.publish(ev)
