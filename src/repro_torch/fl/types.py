"""Shared FL-runner types: the trainer attachment interface and the run
result record. Engine-agnostic — both the sync barrier engine and the
async buffered engine produce the same `RunResult` shape, which is what
lets `repro_torch/benchmarks/table1.py` treat `fedcostaware_async` as just another
column."""
from __future__ import annotations

import dataclasses
import inspect
import warnings
from typing import Dict, List, Optional

from repro_torch.fl.telemetry import Segment


class TrainerHooks:
    """Optional attachment for real model training."""

    def run_local(self, client: str, round_idx: int) -> None:  # pragma: no cover
        """Execute the client's local training for `round_idx` (called
        at the simulated completion instant of the epoch)."""
        pass

    def aggregate(self, participants: List[str], round_idx: int,
                  staleness: Optional[Dict[str, int]] = None) -> None:  # pragma: no cover
        """Fold the participants' buffered updates into the global model.

        `staleness` maps each participant to the number of aggregation
        rounds that fired between its dispatch and this aggregation
        (always 0 under the synchronous barrier; FedBuff-style async
        engines report how stale each buffered update is so the
        implementation can discount it, e.g. by 1/sqrt(1+staleness)).
        Implementations overriding the legacy 2-argument signature keep
        working — engines sniff once at construction
        (`aggregate_accepts_staleness`) and only pass `staleness` to
        hooks that accept it, with a `DeprecationWarning` for the
        legacy form.
        """
        pass

    def update_payload(self, quantized: bool = False):  # pragma: no cover
        """The wire size of one client update these hooks produce, as a
        `repro_torch.comms.payload.UpdatePayload` — or None when the hooks
        have no real parameters to size (the default). When non-None,
        the runner builds a comms model from it (it wins over the
        modeled `FLRunConfig.update_payload_mb`)."""
        return None


def aggregate_accepts_staleness(hooks: Optional[TrainerHooks]) -> bool:
    """Whether `hooks.aggregate` accepts the modern `staleness` kwarg.

    Engines call this exactly once at construction and cache the answer
    — the per-round `inspect.signature` sniffing it replaces showed up
    in profiles and re-warned nothing. The legacy 2-argument override
    (`aggregate(participants, round_idx)`) still works but now draws a
    `DeprecationWarning` naming the hook class; hooks whose signature
    cannot be inspected (builtins, C callables) are conservatively
    treated as legacy, silently.
    """
    if hooks is None:
        return False
    try:
        sig = inspect.signature(hooks.aggregate)
    except (TypeError, ValueError):
        return False
    accepts = ("staleness" in sig.parameters
               or any(p.kind is inspect.Parameter.VAR_KEYWORD
                      for p in sig.parameters.values()))
    if not accepts:
        warnings.warn(
            f"{type(hooks).__name__}.aggregate uses the legacy "
            f"2-argument signature; add a `staleness=None` keyword "
            f"(async engines report per-update staleness through it)",
            DeprecationWarning, stacklevel=2)
    return accepts


@dataclasses.dataclass
class RunResult:
    """Everything a finished (or replayed) run reports."""
    total_cost: float
    per_client_cost: Dict[str, float]
    makespan_s: float
    timeline: List[Segment]
    cost_curve: List[dict]            # {t, client, cum_cost} at round ends
    rounds_completed: int
    excluded_clients: List[str]
    per_round_participants: List[List[str]]
    # preemption-resilience metrics (live runs only; replayed results
    # keep the defaults — the event log does not record lost work):
    # client-seconds of training redone because a reclaim landed after
    # the last surviving checkpoint, and how many tracked instances the
    # spot market took (deliberate drain terminations not included)
    lost_work_s: float = 0.0
    n_preemptions: int = 0
    # storage dollars of warning-window checkpoint writes (S3 PUT +
    # per-MB egress, the provider's StorageRates) — a subset of
    # total_cost; rebuilt on replay from CheckpointBilled events
    checkpoint_cost: float = 0.0
    # egress dollars of client-update uploads (per-MB TransferRates of
    # the sending provider) — a subset of total_cost; rebuilt on
    # replay from TransferBilled events. Zero unless the run models
    # comms (repro_torch.comms) with non-zero rates.
    comm_cost: float = 0.0
    # False when `per_client_cost` does not account for `total_cost`:
    # a replay of a pre-v6 fleet trace folds step totals whose
    # summaries carry no per-client attribution, so the breakdown is
    # *absent* (empty), not a claim that every client cost zero
    has_client_costs: bool = True
