"""ClusterManager + DirectiveExecutor: instance lifecycle for FL clients.

`ClusterManager` sits between the cloud simulator and the round engines.
It consumes the cloud-level bus events (`InstanceReady`,
`InstancePreempted`, `InstancePreemptionWarning`), filters out stale
ones (an event for an instance the cluster no longer tracks is dropped
here, so engines never have to guard against races), and re-publishes
client-level events (`ClientReady`, `ClientLost`,
`ClientPreemptionWarning`).

Owns, per client:
  * the tracked instance (at most one),
  * an optional *standby* replacement (forecast pre-warming,
    `repro_torch.core.strategy.ForecastPrewarmStrategy`): a second instance
    spun up alongside a doomed-looking one; the next `request` —
    typically the reclaim recovery — promotes it instead of launching
    cold, collapsing the spin-up gap,
  * freshness (has the instance completed an epoch yet — drives the
    cold/warm duration split and the spin-up observations),
  * pre-warm scheduling with generation counters (a re-issued pre-warm
    invalidates the previous one) honoring §III-D queue adjustments,
  * resume-from-checkpoint requests: `request(..., resume_token=...)`
    stamps the replacement instance so the engine can distinguish a
    recovery ready from a fresh dispatch.

`DirectiveExecutor` is the write-side of the strategy API
(`repro_torch.core.strategy`): strategies answer events with typed directives
(`SpinUp`, `Terminate`, `PreWarm`, `Checkpoint`, `Drain`, `ScreenOut`)
and the executor applies them against the cluster/bus — engines never
execute scheduling decisions themselves.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.checkpoint import snapshots
from repro_torch.cloud.simulator import (RUNNING, SPINNING_UP, CloudSimulator,
                                   Instance)
from repro_torch.common.config import ClientProfile
from repro_torch.core.events import (BudgetExhausted, ClientCheckpointed,
                               ClientLost, ClientPreemptionWarning,
                               ClientReady, ClientScreenedOut,
                               ClientStateChanged, DirectiveIssued,
                               InstancePreempted,
                               InstancePreemptionWarning, InstanceReady)
from repro_torch.core.policies import Policy
from repro_torch.core.scheduler import FedCostAwareScheduler
from repro_torch.core.strategy import (Checkpoint, Directive, Drain, PreWarm,
                                 ScreenOut, SpinUp, Terminate)


class ClusterManager:
    """Per-client instance ownership between the cloud simulator and
    the round engines (see module docstring)."""

    def __init__(self, sim: CloudSimulator, policy: Policy,
                 profiles: Dict[str, ClientProfile],
                 scheduler: Optional[FedCostAwareScheduler] = None,
                 prewarm_target_of: Optional[
                     Callable[[str], Optional[float]]] = None):
        self.sim = sim
        self.policy = policy
        self.profiles = profiles
        self.scheduler = scheduler
        if prewarm_target_of is not None:
            self._prewarm_target = prewarm_target_of
        elif scheduler is not None:
            self._prewarm_target = scheduler.prewarm_queue.get
        else:
            self._prewarm_target = lambda c: None
        self.instances: Dict[str, Optional[Instance]] = {
            c: None for c in profiles}
        self._standby: Dict[str, Instance] = {}
        self._fresh: Dict[int, bool] = {}       # iid -> no epoch done yet
        self._resume_tokens: Dict[int, Any] = {}  # iid -> engine payload
        self._prewarm_gen: Dict[str, int] = {}
        self._shutdown = False
        sim.bus.subscribe(InstanceReady, self._on_instance_ready)
        sim.bus.subscribe(InstancePreempted, self._on_instance_preempted)
        sim.bus.subscribe(InstancePreemptionWarning,
                          self._on_instance_warning)

    # ------------------------------------------------------------------
    # Requests / termination.
    # ------------------------------------------------------------------
    def request(self, client: str, resume_token: Any = None) -> Instance:
        """Request an instance for `client` in its pinned
        (provider, zone), or the currently-cheapest zone under
        cheapest-zone policies — arbitrated across every provider in
        the market when the policy allows cross-provider placement,
        else only on the market's default provider.

        A live standby (forecast pre-warming) is promoted instead of
        launching fresh: it becomes the tracked instance, inherits the
        resume token, and — if already RUNNING — re-announces itself
        as `ClientReady` immediately, which is exactly the collapsed
        spin-up gap the forecast strategy buys."""
        sb = self._standby.pop(client, None)
        if sb is not None and sb.state in (SPINNING_UP, RUNNING):
            self.instances[client] = sb
            if resume_token is not None:
                self._resume_tokens[sb.iid] = resume_token
            self.sim.bus.publish(
                ClientStateChanged(self.sim.now, client, "spinup"))
            if sb.state == RUNNING:
                self.sim.schedule(self.sim.now,
                                  lambda: self._announce_ready(sb))
            return sb
        zone, provider = self._placement(self.profiles[client])
        inst = self.sim.request_instance(client, zone=zone,
                                         on_demand=self.policy.on_demand,
                                         provider=provider)
        self.instances[client] = inst
        self._fresh[inst.iid] = True
        if resume_token is not None:
            self._resume_tokens[inst.iid] = resume_token
        self.sim.bus.publish(
            ClientStateChanged(self.sim.now, client, "spinup"))
        return inst

    def _placement(self, prof: ClientProfile):
        """Resolve a client's (zone, provider) placement: the pinned
        pair when set, else — under cheapest-zone policies — the
        cheapest zone across the providers the policy allows. A (None,
        None) answer defers to the simulator's own cheapest-zone
        fallback."""
        zone, provider = prof.zone, prof.provider
        if zone is None and self.policy.pick_cheapest_zone:
            z, _ = self.sim.market.cheapest_zone(
                self.sim.now, providers=self._placement_providers())
            zone, provider = z.name, z.provider
        return zone, provider

    def request_standby(self, client: str) -> Optional[Instance]:
        """Spin up a standby replacement next to the client's tracked
        instance (forecast pre-warming). At most one standby per
        client; a no-op (returning the existing one) when a standby is
        already up, and None when the client has nothing to back up."""
        existing = self._standby.get(client)
        if existing is not None:
            return existing
        if self.instances.get(client) is None:
            return None
        zone, provider = self._placement(self.profiles[client])
        inst = self.sim.request_instance(client, zone=zone,
                                         on_demand=self.policy.on_demand,
                                         provider=provider)
        self._standby[client] = inst
        self._fresh[inst.iid] = True
        return inst

    def standby_of(self, client: str) -> Optional[Instance]:
        """The client's standby replacement, or None."""
        return self._standby.get(client)

    def cancel_standby(self, client: str) -> Optional[Instance]:
        """Terminate and drop the client's standby (hazard subsided,
        screening excluded the client, or the run is over)."""
        sb = self._standby.pop(client, None)
        if sb is not None:
            self.sim.terminate(sb)
        return sb

    def _announce_ready(self, inst: Instance) -> None:
        """Publish `ClientReady` for a promoted, already-RUNNING
        standby (its original `InstanceReady` was filtered while it
        waited unpromoted). Stale-guarded like every cluster event."""
        cur = self.instances.get(inst.client)
        if cur is None or cur.iid != inst.iid or inst.state != RUNNING:
            return
        token = self._resume_tokens.pop(inst.iid, None)
        self.sim.bus.publish(ClientReady(
            self.sim.now, inst.client, inst, self.is_fresh(inst.iid),
            token))

    def _placement_providers(self) -> Optional[list]:
        """None (all providers) under cross-provider policies, else the
        market's default provider only."""
        if self.policy.cross_provider:
            return None
        return [self.sim.market.default_provider]

    def terminate(self, client: str) -> Optional[Instance]:
        """Deliberately stop the client's tracked instance (if any) and
        untrack it; returns the instance that was terminated. The
        standby (if any) is left alone — a follow-up `request` promotes
        it, which is what `Drain` relies on."""
        inst = self.instances.get(client)
        if inst is not None:
            self.sim.terminate(inst)
            self.instances[client] = None
        return inst

    def instance_of(self, client: str) -> Optional[Instance]:
        """The client's currently tracked instance, or None."""
        return self.instances.get(client)

    def shutdown(self):
        """Stop honoring queued pre-warm fires and release every
        standby (end of run)."""
        self._shutdown = True
        for c in list(self._standby):
            self.cancel_standby(c)

    @property
    def is_shutdown(self) -> bool:
        """Has the run shut the cluster down?"""
        return self._shutdown

    # ------------------------------------------------------------------
    # Market lookups shared with the strategy layer.
    # ------------------------------------------------------------------
    def spot_price_of(self, client: str) -> float:
        """The $/hr price the client's next epoch would pay: its pinned
        zone's current rate, or the cheapest placement the policy
        allows (what §III-E budget screening prices rounds with)."""
        prof = self.profiles[client]
        if prof.zone is None:
            _, p = self.sim.market.cheapest_zone(
                self.sim.now, providers=self._placement_providers())
            return p
        return self.sim.market.price(prof.zone, self.sim.now,
                                     self.policy.on_demand,
                                     provider=prof.provider)

    # ------------------------------------------------------------------
    # Freshness (cold/warm) bookkeeping.
    # ------------------------------------------------------------------
    def is_fresh(self, iid: int) -> bool:
        """Has instance `iid` completed no epoch yet (cold)?"""
        return self._fresh.get(iid, True)

    def mark_warm(self, iid: int):
        """Record that instance `iid` finished an epoch (warm)."""
        self._fresh[iid] = False

    # ------------------------------------------------------------------
    # Pre-warming (scheduler decision -> future spin-up).
    # ------------------------------------------------------------------
    def schedule_prewarm(self, client: str, t: float):
        """Spin the client's next instance up at `t` (the scheduler's
        `F_s - T_spin_up - T_buffer` target). Re-issuing supersedes the
        previous pre-warm; a queue entry moved later (§III-D) defers
        the fire; `shutdown()` cancels all of them."""
        gen = self._prewarm_gen.get(client, 0) + 1
        self._prewarm_gen[client] = gen

        def fire():
            if self._prewarm_gen.get(client) != gen or self._shutdown:
                return
            # stale if queue entry moved later (§III-D adjustment)
            q_t = self._prewarm_target(client)
            if q_t is not None and q_t > self.sim.now + 1e-6:
                self.schedule_prewarm(client, q_t)
                return
            if self.instances.get(client) is None:
                self.request(client)

        self.sim.schedule(max(t, self.sim.now), fire)

    # ------------------------------------------------------------------
    # Cloud-event translation.
    # ------------------------------------------------------------------
    def _on_instance_ready(self, ev: InstanceReady):
        inst = ev.instance
        client = inst.client
        if self.instances.get(client) is not inst:
            return          # stale or standby: not the tracked instance
        token = self._resume_tokens.pop(inst.iid, None)
        self.sim.bus.publish(ClientReady(
            ev.t, client, inst, self.is_fresh(inst.iid), token))

    def _on_instance_preempted(self, ev: InstancePreempted):
        inst = ev.instance
        client = inst.client
        if self._standby.get(client) is inst:
            del self._standby[client]       # standby reclaimed: silent
            return
        cur = self.instances.get(client)
        if cur is None or cur.iid != inst.iid:
            return                              # stale: already replaced
        self.instances[client] = None
        self.sim.bus.publish(ClientLost(ev.t, client, inst))

    def _on_instance_warning(self, ev: InstancePreemptionWarning):
        """Translate a provider reclaim notice into a client-level
        warning, filtered like every other cloud event: a warning for
        an instance the cluster no longer tracks is dropped."""
        inst = ev.instance
        cur = self.instances.get(inst.client)
        if cur is None or cur.iid != inst.iid:
            return                              # stale: already replaced
        self.sim.bus.publish(ClientPreemptionWarning(
            ev.t, inst.client, inst, ev.reclaim_at))


# ---------------------------------------------------------------------------
# Directive execution (the strategy API's write side).
# ---------------------------------------------------------------------------
class DirectiveExecutor:
    """Applies typed strategy directives (`repro_torch.core.strategy`)
    against the cluster and the bus.

    Execution preserves the exact event orderings the engines used to
    produce inline (Listing-1 termination publishes the "savings"
    state *after* the instance teardown; budget screening publishes
    `BudgetExhausted` before the "idle" mark and teardown), which is
    what keeps pre-redesign golden traces bit-identical.

    With `trace=True` (`FLRunConfig.trace_directives`) every applied
    directive additionally publishes a `DirectiveIssued` event before
    executing — off by default so default streams stay unchanged.
    """

    def __init__(self, cluster: ClusterManager, ckpt_store=None,
                 ckpt_size_mb: float = 0.0, trace: bool = False):
        self.cluster = cluster
        self.bus = cluster.sim.bus
        self.ckpt_store = ckpt_store
        self.ckpt_size_mb = ckpt_size_mb
        self.trace = trace

    @property
    def _now(self) -> float:
        return self.cluster.sim.now

    def apply(self, directives: Sequence[Directive]) -> List[Directive]:
        """Execute `directives` in order; returns them for chaining."""
        for d in directives:
            if self.trace:
                self.bus.publish(DirectiveIssued(
                    self._now, type(d).__name__, d.client,
                    self._detail(d)))
            if isinstance(d, SpinUp):
                self._spin_up(d)
            elif isinstance(d, Terminate):
                self._terminate(d)
            elif isinstance(d, PreWarm):
                self.cluster.schedule_prewarm(d.client, d.at_t)
            elif isinstance(d, Checkpoint):
                self._checkpoint(d)
            elif isinstance(d, Drain):
                self._drain(d)
            elif isinstance(d, ScreenOut):
                self._screen_out(d)
            else:
                raise TypeError(
                    f"unknown directive {type(d).__name__}")
        return list(directives)

    # ------------------------------------------------------------------
    @staticmethod
    def _detail(d: Directive) -> str:
        """Short human-readable argument summary for tracing."""
        if isinstance(d, PreWarm):
            return f"at_t={d.at_t:.1f}"
        if isinstance(d, Terminate) and d.standby:
            return "standby"
        if isinstance(d, Checkpoint):
            return f"remaining={d.remaining_s:.1f}"
        if isinstance(d, Drain):
            return f"remaining={d.resume_token['remaining']:.1f}" \
                if d.resume_token else ""
        if isinstance(d, ScreenOut):
            return f"round={d.round_idx}"
        return ""

    def _spin_up(self, d: SpinUp) -> None:
        """Fresh request when untracked, standby otherwise."""
        if self.cluster.instance_of(d.client) is None:
            self.cluster.request(d.client, resume_token=d.resume_token)
        else:
            self.cluster.request_standby(d.client)

    def _terminate(self, d: Terminate) -> None:
        """Listing-1 idle stop (tracked instance + Fig-4 "savings"
        state), or a standby cancellation."""
        if d.standby:
            self.cluster.cancel_standby(d.client)
            return
        self.cluster.terminate(d.client)
        self.bus.publish(
            ClientStateChanged(self._now, d.client, "savings"))

    def _checkpoint(self, d: Checkpoint) -> None:
        """Persist the warning-window snapshot and publish
        `ClientCheckpointed` (stamped with the writing instance's
        provider, whose `StorageRates` bill the write)."""
        snapshots.save_snapshot(self.ckpt_store, d.client,
                                dict(d.payload or {}))
        inst = self.cluster.instance_of(d.client)
        self.bus.publish(ClientCheckpointed(
            self._now, d.client, d.round_idx, d.progress_s,
            d.remaining_s, d.reclaim_at, self.ckpt_size_mb,
            getattr(inst, "provider", "") or ""))

    def _drain(self, d: Drain) -> None:
        """Vacate the doomed instance; re-request (or promote a
        standby) with the resume token."""
        self.cluster.terminate(d.client)
        self.cluster.request(d.client, resume_token=d.resume_token)

    def _screen_out(self, d: ScreenOut) -> None:
        """§III-E exclusion: `BudgetExhausted` + `ClientScreenedOut`,
        then stop paying for whatever the client still runs."""
        self.bus.publish(BudgetExhausted(self._now, d.client))
        self.bus.publish(
            ClientScreenedOut(self._now, d.client, d.round_idx))
        self.cluster.cancel_standby(d.client)
        if self.cluster.instance_of(d.client) is not None:
            self.bus.publish(
                ClientStateChanged(self._now, d.client, "idle"))
            self.cluster.terminate(d.client)
