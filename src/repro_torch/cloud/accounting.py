"""Incremental per-client cost accounting driven by billing events.

The seed implementation answered every `client_cost` query with a full
scan over *all instances ever created* (O(n) per query, O(n^2) across a
run's cost-curve recording). `CostAccountant` subscribes to the event
bus and folds each closed billing segment into per-client totals as it
happens, so `client_cost` / `total_cost` only have to price the (at most
one per client) still-open billing segment:

  closed cost  — accumulated from `BillingTick` events, O(1) amortized
  open segment — priced on demand from the instance's billing start to
                 `clock()`; there are at most O(#clients) open segments
                 alive at any instant, independent of run length.

`benchmarks/accounting_bench.py` measures the gap at 100 clients x 200
rounds.

The accountant is also a *pure replay consumer*: constructed with no
price book / clock and subscribed to a bus fed by
`core.eventlog.EventReplayer`, it rebuilds the exact per-client totals
of the recorded run from the closed `BillingTick`s alone (a complete
trace terminates every instance, so no open segment is ever priced).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, Optional, Sequence, Set

import numpy as np

from repro_torch.core.events import (BillingTick, CheckpointBilled,
                               ClientCheckpointed, ClientUpdateSent,
                               EventBus, FleetStepSummary,
                               InstancePreempted, InstanceReady,
                               InstanceTerminated, TransferBilled)
from repro_torch.cloud.pricing import SpotMarket


class CostAccountant:
    """Per-client dollar totals as a bus consumer: O(1) amortized
    folding of closed `BillingTick` segments plus on-demand pricing of
    the open ones. Pass `prices=None` (no clock) for replay mode.

    Warning-window checkpoint writes are billed too (ROADMAP
    "checkpoint-aware cost model"): on `ClientCheckpointed` the live
    accountant prices the write against the client's provider's
    `StorageRates` (S3 PUT + per-MB egress of the snapshot's
    `size_mb`) and publishes the charge as `CheckpointBilled`, whose
    handler folds it into the totals — so a replayed stream rebuilds
    the exact same checkpoint spend without a price book. Default
    rates are zero: checkpoint dollars only appear when a market opts
    in, keeping every pre-redesign total unchanged."""

    def __init__(self, bus: EventBus, prices: Optional[SpotMarket] = None,
                 clock: Optional[Callable[[], float]] = None):
        self._bus = bus
        self._prices = prices
        self._clock = clock
        self._closed: Dict[str, float] = defaultdict(float)
        self._closed_total = 0.0
        self._ckpt: Dict[str, float] = defaultdict(float)
        self._ckpt_total = 0.0
        self._xfer: Dict[str, float] = defaultdict(float)
        self._xfer_total = 0.0
        self._open: Dict[int, object] = {}          # iid -> Instance
        self._open_by_client: Dict[str, Set[int]] = defaultdict(set)
        # fleet-step dollars folded into the total without per-client
        # attribution (pre-v6 logs whose summaries carry no
        # `client_cost_delta`); nonzero means `per_client()` is not the
        # whole story — see `has_client_costs`
        self.fleet_unattributed = 0.0
        bus.subscribe(InstanceReady, self._on_ready)
        bus.subscribe(BillingTick, self._on_billing)
        bus.subscribe(InstanceTerminated, self._on_closed)
        bus.subscribe(InstancePreempted, self._on_closed)
        bus.subscribe(ClientCheckpointed, self._on_checkpointed)
        bus.subscribe(CheckpointBilled, self._on_checkpoint_billed)
        bus.subscribe(ClientUpdateSent, self._on_update_sent)
        bus.subscribe(TransferBilled, self._on_transfer_billed)
        bus.subscribe(FleetStepSummary, self._on_fleet_step)

    # ------------------------------------------------------------------
    # Event handlers.
    # ------------------------------------------------------------------
    def _on_ready(self, ev: InstanceReady):
        inst = ev.instance
        self._open[inst.iid] = inst
        self._open_by_client[inst.client].add(inst.iid)

    def _on_billing(self, ev: BillingTick):
        self._closed[ev.client] += ev.amount
        self._closed_total += ev.amount
        self._drop_open(ev.instance)

    def _on_closed(self, ev):
        # terminated-while-spinning instances never opened a segment;
        # terminate/preempt after RUNNING already closed via BillingTick.
        self._drop_open(ev.instance)

    def _drop_open(self, inst):
        if self._open.pop(inst.iid, None) is not None:
            self._open_by_client[inst.client].discard(inst.iid)

    def _on_checkpointed(self, ev: ClientCheckpointed):
        """Live mode: price the checkpoint write against the storage
        rates of the provider that wrote it (stamped on the event by
        the executor), and publish the (non-zero) charge as
        `CheckpointBilled`. Replay mode skips this — the recorded
        `CheckpointBilled` carries the charge."""
        if self._prices is None:
            return
        rates = self._prices.provider_of(ev.provider or None).storage
        amount = rates.checkpoint_cost(ev.size_mb)
        if amount > 0.0:
            self._bus.publish(CheckpointBilled(ev.t, ev.client, amount))

    def _on_checkpoint_billed(self, ev: CheckpointBilled):
        """Fold one checkpoint's storage dollars into the totals (live
        and replay alike)."""
        self._ckpt[ev.client] += ev.amount
        self._ckpt_total += ev.amount

    def _on_update_sent(self, ev: ClientUpdateSent):
        """Live mode: price one client-update upload's egress against
        the sending provider's `TransferRates` and publish the
        (non-zero) charge as `TransferBilled` — the same live/replay
        split as checkpoint billing. Replay mode skips this; the
        recorded `TransferBilled` carries the charge."""
        if self._prices is None:
            return
        rates = self._prices.provider_of(ev.provider or None).transfer
        amount = rates.transfer_cost(ev.size_mb)
        if amount > 0.0:
            self._bus.publish(TransferBilled(ev.t, ev.client, amount))

    def _on_transfer_billed(self, ev: TransferBilled):
        """Fold one upload's egress dollars into the totals (live and
        replay alike)."""
        self._xfer[ev.client] += ev.amount
        self._xfer_total += ev.amount

    def _on_fleet_step(self, ev: FleetStepSummary):
        """Replay mode only: fold one fleet step's *settled* dollars
        (schema v6 aggregate trace). A live fleet run settles the same
        dollars through the fleet core's own arrays, so a live (priced)
        accountant ignores the summary — folding both would double
        count. The step total folds from `cost_delta`; per-client
        attribution folds from `client_cost_delta` (v6), whose values
        sum to `cost_delta` — it must not be added to the total again.
        A pre-v6 summary carries no attribution map: those dollars are
        tracked as *unattributed* so consumers (`replay_result`) can
        flag the per-client breakdown as absent instead of silently
        reporting every client as free (the schema-v5 bug)."""
        if self._prices is not None:
            return
        self._closed_total += ev.cost_delta
        if ev.client_cost_delta:
            for c, a in ev.client_cost_delta.items():
                self._closed[c] += a
        else:
            self.fleet_unattributed += ev.cost_delta

    # ------------------------------------------------------------------
    # Batched settlement (the fleet core's path into the same totals).
    # ------------------------------------------------------------------
    def settle_batch(self, clients: Sequence[str],
                     amounts: np.ndarray) -> float:
        """Fold a whole step's closed billing segments at once:
        `amounts[i]` dollars settle for `clients[i]`. Per-client dict
        updates are grouped with `np.unique`/`np.bincount`, so the
        Python-level work is O(distinct clients), not O(segments).
        Returns the total settled."""
        amounts = np.asarray(amounts, dtype=np.float64)
        if len(amounts) == 0:
            return 0.0
        uniq, inv = np.unique(np.asarray(clients, dtype=object),
                              return_inverse=True)
        sums = np.bincount(inv, weights=amounts, minlength=len(uniq))
        for c, a in zip(uniq, sums):
            self._closed[c] += float(a)
        total = float(amounts.sum())
        self._closed_total += total
        return total

    # ------------------------------------------------------------------
    # Queries.
    # ------------------------------------------------------------------
    def _open_cost(self, inst) -> float:
        t0 = inst._billing_from
        if t0 is None or self._prices is None:
            return 0.0          # closed, or replay mode (always closed)
        return self._prices.cost(inst.zone, t0, self._clock(),
                                 inst.on_demand,
                                 provider=getattr(inst, "provider", None))

    def client_cost(self, client: str) -> float:
        """Dollars accrued by `client` so far: open segments,
        checkpoint storage and update egress included."""
        return (self._closed[client] + self._ckpt[client]
                + self._xfer[client]
                + sum(self._open_cost(self._open[i])
                      for i in self._open_by_client[client]))

    def total_cost(self) -> float:
        """Dollars accrued by the whole run so far."""
        return (self._closed_total + self._ckpt_total + self._xfer_total
                + sum(self._open_cost(i) for i in self._open.values()))

    def checkpoint_cost(self, client: str) -> float:
        """Storage dollars `client`'s warning-window checkpoint writes
        have accrued (a subset of `client_cost`)."""
        return self._ckpt[client]

    def checkpoint_cost_total(self) -> float:
        """Storage dollars all checkpoint writes have accrued (a
        subset of `total_cost`)."""
        return self._ckpt_total

    def transfer_cost(self, client: str) -> float:
        """Egress dollars `client`'s update uploads have accrued (a
        subset of `client_cost`)."""
        return self._xfer[client]

    def transfer_cost_total(self) -> float:
        """Egress dollars all update uploads have accrued (a subset
        of `total_cost`)."""
        return self._xfer_total

    def per_client(self) -> Dict[str, float]:
        """`client_cost` for every client ever billed or running."""
        clients = (set(self._closed) | set(self._open_by_client)
                   | set(self._xfer))
        return {c: self.client_cost(c) for c in clients}

    def has_client_costs(self, tiny: float = 1e-12) -> bool:
        """Whether `per_client()` accounts for every folded dollar.
        False when fleet-step summaries without per-client attribution
        (pre-v6 logs) contributed to the total — the breakdown is then
        absent, not zero."""
        return self.fleet_unattributed <= tiny
