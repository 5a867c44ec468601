"""The explicit cost-of-error decision rule: probabilities -> dollars
-> directives.

A forecast only earns its keep through the asymmetric costs of acting
on it. For a predicted interruption probability `p` over the decision
horizon, priced at the client's live spot rate:

  pre-warm a standby   costs the standby's expected *wasted* runtime,
                       `(1 - p) * horizon * rate` (when the reclaim
                       does land, the standby is promoted and its
                       seconds are not wasted). Skipping it risks
                       `p * (spin_up * stall_weight + lost_work) *
                       rate`: the replacement's cold boot stalls not
                       just the victim but every peer idling at the
                       sync barrier (`stall_weight` ~ the number of
                       stalled clients), plus the lost work since the
                       last durable snapshot.
  checkpoint now       costs `ckpt_usd`: the storage write (the
                       provider's `StorageRates`) plus the write
                       window's paid instance seconds, priced by the
                       caller. Skipping it risks `p * unsnapshotted *
                       rate` of redone work, so snapshots naturally
                       densify as the hazard rises — an adaptive
                       checkpoint cadence.
  drain                only when doom is near-certain
                       (`p >= drain_threshold`) *and* a fresh snapshot
                       makes the vacate lossless — draining on a false
                       alarm throws away a healthy instance, so the
                       rule is deliberately conservative.

`decide` is a pure function of its arguments (no hidden state, no
market access) so the rule itself is unit-testable in isolation and
every threshold is explicit in one place. Hysteresis: an active
standby is only released once the expected loss falls below
`prewarm_hysteresis` times the standby cost, preventing flapping at
the decision boundary.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DecisionConfig:
    """Knobs of the cost-of-error rule (module docstring)."""
    horizon_s: float = 600.0          # decision/forecast horizon
    stall_weight: float = 3.0         # peers stalled per cold respin
    prewarm_hysteresis: float = 0.5   # release below this x standby cost
    drain_threshold: float = 0.95     # p floor for vacating an instance


@dataclasses.dataclass(frozen=True)
class Decision:
    """One evaluated decision: the chosen actions plus the dollar
    quantities that chose them (recorded for auditability)."""
    prewarm: bool
    release: bool
    checkpoint: bool
    drain: bool
    expected_loss_usd: float          # cost of *not* acting
    standby_usd: float                # expected wasted standby dollars

    @property
    def action(self) -> str:
        """Compressed label for telemetry: the strongest action."""
        if self.drain:
            return "drain"
        if self.checkpoint and self.prewarm:
            return "prewarm+checkpoint"
        if self.checkpoint:
            return "checkpoint"
        if self.prewarm:
            return "prewarm"
        if self.release:
            return "release"
        return "hold"


def decide(p: float, spot_rate_hr: float, spin_up_s: float,
           lost_work_s: float, unsnapshotted_s: float,
           ckpt_usd: float, standby_active: bool,
           have_fresh_snapshot: bool,
           cfg: DecisionConfig = DecisionConfig()) -> Decision:
    """Evaluate the cost-of-error rule for one client.

    `p` is the forecast interruption probability within
    `cfg.horizon_s`; `spot_rate_hr` the client's live spot price;
    `spin_up_s` the expected replacement boot time; `lost_work_s` the
    training seconds a reclaim would force the client to redo;
    `unsnapshotted_s` the portion of that not yet covered by any
    durable snapshot; `ckpt_usd` the all-in cost of writing a snapshot
    now (storage dollars + the write window's instance seconds).
    `have_fresh_snapshot` gates the drain arm only — checkpointing
    re-fires as `unsnapshotted_s` grows back after each write.
    """
    p = min(max(p, 0.0), 1.0)
    rate_s = spot_rate_hr / 3600.0
    expected_loss = p * (spin_up_s * cfg.stall_weight
                         + lost_work_s) * rate_s
    standby = (1.0 - p) * cfg.horizon_s * rate_s
    prewarm = not standby_active and expected_loss > standby
    release = (standby_active
               and expected_loss < cfg.prewarm_hysteresis * standby)
    checkpoint = (unsnapshotted_s > 0.0
                  and p * unsnapshotted_s * rate_s > ckpt_usd)
    drain = p >= cfg.drain_threshold and have_fresh_snapshot
    return Decision(prewarm=prewarm, release=release,
                    checkpoint=checkpoint, drain=drain,
                    expected_loss_usd=expected_loss,
                    standby_usd=standby)
