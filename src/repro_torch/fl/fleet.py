"""FleetRunner: the vectorized sync-barrier round loop over the
struct-of-arrays fleet core (`repro_torch.cloud.fleet`).

The per-object stack (CloudSimulator heap + ClusterManager + SyncEngine)
prices one Python callback chain per instance lifecycle transition. This
runner replays the *same round discipline* as array sweeps — one batch
of spin-ups, one batch of duration draws, one batch of billing
settlements and one batch of preemption draws per FL round — so a
100k-client cohort round costs a handful of numpy passes.

Semantics mirrored from the per-object path (and pinned by
tests/test_fleet.py: identical `RunResult` totals within 1e-9 on
deterministic configs):

  * sync barrier — the round ends at the slowest participant's finish;
    the next round starts 1.0s later; the final terminate lands 1.0s
    after the last round's barrier.
  * billing — opens at instance-ready, settles at terminate/preempt
    with the provider's min-billing floor + granularity rounding.
  * Listing-1 lifecycle (fedcostaware) — each finisher (except the
    round's last) compares its idle window against its *post-update*
    spin-up EMA; terminated clients pre-warm at `F_s - T_spin - T_buf`.
    The per-client F_s is reconstructed order-exactly: sort finishers
    stably by finish time, then F_s at position k is the max of the
    prefix of actual finishes (<= k) and the suffix of registered
    finish predictions (> k).
  * §III-B EMAs — cold/warm epoch EMAs (NaN = no observation, falling
    back to each other) and the spin-up EMA (prior =
    `CloudConfig.spin_up_mean_s`); resumed (preempted) epochs update
    only the spin-up EMA, exactly like `note_resume_result`.
  * §III-E budget screening (round >= 1) — spent = settled + open
    accrual; estimate = (warm-epoch prediction + spin-up EMA) * $/hr /
    3600; screened clients are permanently excluded and torn down.
  * §III-D preemption recovery — reclaim mid-epoch settles the
    instance, loses work back to the last periodic checkpoint
    (`SchedulerConfig.checkpoint_every_s`), respins, and resumes the
    remaining duration (floor 1.0s); reclaims while idle are absorbed
    at the next dispatch. Preemption delays are drawn per step through
    `PreemptionModel.next_preemption_delays`, anchored at the step's
    start and measured from each instance's ready instant.

Documented fleet-mode approximations (why goldens below
`CloudConfig.fleet_threshold` stay on the per-object path): no
per-instance events — each round publishes one `FleetStepSummary`
(eventlog schema v6, carrying the step's per-client settled dollars in
`client_cost_delta` so replays rebuild `per_client_cost` exactly); no
Fig-4 timeline / Fig-5 cost-curve sampling; no standby instances,
preemption-notice reactions or §III-D pre-warm-queue adjustments;
`RunCompleted.client_costs` stays empty (per-client totals live in
`RunResult.per_client_cost`, built once from the settled array, and on
replay from the summed step deltas).

Cohort sampling (`FLRunConfig.population` + `cohort_size`) draws each
round's participants without replacement from a dedicated RNG lane, so
cohort sequences are reproducible per seed.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from repro_torch.cloud.fleet import (ABSENT, RUNNING, SPINNING, ClientArrays,
                               FleetState)
from repro_torch.cloud.preemption import build_preemption_model
from repro_torch.cloud.pricing import SpotMarket
from repro_torch.common.config import CloudConfig, FLRunConfig, SchedulerConfig
from repro_torch.core.events import EventBus, FleetStepSummary
from repro_torch.core.policies import Policy
from repro_torch.core.strategy import BudgetScreenSpec, LifecycleSpec
from repro_torch.fl.types import RunResult

__all__ = ["FleetRunner", "fleet_supported"]


def fleet_supported(policy: Policy) -> bool:
    """Can `policy` run on the vectorized fleet path? Sync-barrier
    engines with at most Listing-1 + budget-screening strategies and no
    preemption-notice reaction — i.e. Table I's on_demand / spot /
    fedcostaware columns. Everything else (async engines, forecast
    pre-warming, warning checkpoint/drain modes) needs the per-object
    event vocabulary."""
    return (policy.engine == "sync"
            and policy.on_warning == "ignore"
            and all(isinstance(s, (LifecycleSpec, BudgetScreenSpec))
                    for s in policy.strategies))


class FleetRunner:
    """One FL run over the struct-of-arrays core (see module
    docstring). Constructed by `FLCloudRunner` when the fleet path is
    engaged; `run()` returns the same `RunResult` shape as the
    per-object engines."""

    def __init__(self, run_cfg: FLRunConfig, cloud_cfg: CloudConfig,
                 sched_cfg: SchedulerConfig, policy: Policy,
                 market: SpotMarket, bus: EventBus, seed: int):
        if not fleet_supported(policy):
            raise ValueError(
                f"policy {policy.name!r} is not fleet-capable (needs the "
                f"per-object path: sync engine, on_warning='ignore', "
                f"lifecycle/budget strategies only)")
        self.run_cfg = run_cfg
        self.cloud_cfg = cloud_cfg
        self.sched_cfg = sched_cfg
        self.policy = policy
        self.market = market
        self.bus = bus
        self.clients = (ClientArrays.from_population(run_cfg.population)
                        if run_cfg.population is not None
                        else ClientArrays.from_profiles(run_cfg.clients))
        n = self.clients.n
        self.state = FleetState(n, market, policy.on_demand)
        self._model = build_preemption_model(cloud_cfg, market)
        # RNG lanes: independent streams per draw family (the per-object
        # path interleaves sim/engine draws per event; the fleet batches
        # them, so it owns its own lanes — equivalence tests pin totals
        # on deterministic configs, not draw-for-draw streams)
        self._rng_spin = np.random.RandomState(seed + 17)
        self._rng_dur = np.random.RandomState(seed + 101)
        self._rng_pre = np.random.RandomState(seed + 307)
        self._rng_cohort = np.random.RandomState(seed + 211)
        # §III-B estimator state (NaN = unobserved; spin prior as EMA init)
        self.ema_cold = np.full(n, np.nan)
        self.ema_warm = np.full(n, np.nan)
        self.ema_spin = np.full(n, float(cloud_cfg.spin_up_mean_s))
        self._alpha = sched_cfg.ema_alpha
        self.excluded = np.zeros(n, dtype=bool)
        self.lost_work_s = 0.0
        self.per_round_participants: List[List[str]] = []
        # pinned placements resolved once; -1 = policy-driven
        self._pinned_zone = np.full(n, -1, dtype=np.int64)
        for i, pz in enumerate(self.clients.pinned):
            if pz is not None:
                self._pinned_zone[i] = self.state.resolve_zone(pz[0],
                                                               pz[1])

    # ------------------------------------------------------------------
    # Placement / pricing / draws.
    # ------------------------------------------------------------------
    def _providers(self) -> Optional[list]:
        """Provider filter for cheapest-zone arbitration (None = all),
        mirroring `ClusterManager._placement_providers`."""
        if self.policy.cross_provider:
            return None
        return [self.market.default_provider]

    def _request_zones(self, idx: np.ndarray, times) -> np.ndarray:
        """Zone-table index each slot in `idx` launches in at its own
        request time: the pinned zone when set, else the cheapest zone
        the policy allows — one market lookup per *distinct* request
        time (a whole dispatch batch shares one)."""
        k = len(idx)
        times = np.broadcast_to(
            np.asarray(times, dtype=np.float64), (k,))
        out = np.empty(k, dtype=np.int64)
        pinned = self._pinned_zone[idx]
        mask = pinned >= 0
        out[mask] = pinned[mask]
        un = ~mask
        if un.any():
            providers = (self._providers() if self.policy.pick_cheapest_zone
                         else None)
            for t in np.unique(times[un]):
                sel = un & (times == t)
                z, _ = self.market.cheapest_zone(float(t),
                                                 providers=providers)
                out[sel] = self.state.zone_index[(z.provider, z.name)]
        return out

    def _prices_of(self, idx: np.ndarray, t: float) -> np.ndarray:
        """$/hr each client's next epoch would pay at `t` (what §III-E
        screening prices rounds with): pinned zone's current rate, or
        the cheapest placement the policy allows."""
        out = np.empty(len(idx))
        pinned = self._pinned_zone[idx]
        un = pinned < 0
        if un.any():
            _, p = self.market.cheapest_zone(t, providers=self._providers())
            out[un] = p
        for z in np.unique(pinned[pinned >= 0]):
            sel = pinned == z
            prov, zname = self.state.zone_table[int(z)]
            out[sel] = self.market.price(zname, t, self.policy.on_demand,
                                         provider=prov)
        return out

    def _draw_spin(self, k: int) -> np.ndarray:
        """Batch of lognormal spin-up delays (same arithmetic as
        `CloudSimulator.sample_spin_up`)."""
        mu = math.log(self.cloud_cfg.spin_up_mean_s)
        return np.exp(mu + self._rng_spin.randn(k)
                      * self.cloud_cfg.spin_up_sigma)

    def _ema_update(self, arr: np.ndarray, idx: np.ndarray,
                    obs: np.ndarray) -> None:
        """Vectorized EMA fold: first observation seeds the value,
        later ones blend at `SchedulerConfig.ema_alpha` — the exact
        `core.estimator.EMA.update` rule."""
        if len(idx) == 0:
            return
        old = arr[idx]
        arr[idx] = np.where(np.isnan(old), obs,
                            self._alpha * obs + (1 - self._alpha) * old)

    # ------------------------------------------------------------------
    # Between-round sweeps.
    # ------------------------------------------------------------------
    def _promote_ready(self, t: float) -> None:
        """SPINNING instances whose ready time has passed become
        RUNNING (billing opens at their own ready instant; spot slots
        get preemption draws)."""
        st = self.state
        sel = np.nonzero((st.status == SPINNING) & (st.t_ready <= t))[0]
        if len(sel):
            st.activate(sel, self._model, self._rng_pre, t)

    def _reclaim_idle(self, t: float) -> None:
        """Absorb spot reclaims that landed while instances sat idle
        (or pre-warmed) between barriers: settle at the true reclaim
        time, free the slot — the next dispatch re-requests."""
        st = self.state
        sel = np.nonzero((st.status == RUNNING) & (st.preempt_at <= t))[0]
        if len(sel):
            st.preempt(sel, st.preempt_at[sel].copy())

    # ------------------------------------------------------------------
    # §III-E screening.
    # ------------------------------------------------------------------
    def _screen(self, idx: np.ndarray, t: float, r: int) -> np.ndarray:
        """Permanently exclude candidates whose remaining budget cannot
        cover the next epoch's estimate, tearing their instances down
        at `t`; returns the surviving participants."""
        st = self.state
        spent = st.settled[idx] + st.open_cost(t, idx)
        remaining = self.clients.budget[idx] - spent
        warm_pred = np.where(np.isnan(self.ema_warm[idx]),
                             np.where(np.isnan(self.ema_cold[idx]), 0.0,
                                      self.ema_cold[idx]),
                             self.ema_warm[idx])
        est = ((warm_pred + self.ema_spin[idx])
               * self._prices_of(idx, t) / 3600.0)
        keep = remaining >= est
        out = idx[~keep]
        if len(out):
            self.excluded[out] = True
            st.terminate(out, np.full(len(out), t))
        return idx[keep]

    # ------------------------------------------------------------------
    # One FL round.
    # ------------------------------------------------------------------
    def _round(self, r: int, t0: float) -> Optional[float]:
        """Run round `r` starting at `t0`; returns the barrier time
        (slowest finish), or None when nobody participates (the run
        ends at `t0`)."""
        st, ca, cfg = self.state, self.clients, self.sched_cfg
        self._promote_ready(t0)
        self._reclaim_idle(t0)

        active = (ca.join_round <= r) & ~self.excluded
        idx = np.nonzero(active)[0]
        cohort = self.run_cfg.cohort_size
        if cohort is not None and len(idx) > cohort:
            idx = np.sort(self._rng_cohort.choice(idx, size=cohort,
                                                  replace=False))
        if r >= 1 and self.policy.enforce_budgets and len(idx):
            idx = self._screen(idx, t0, r)
        if len(idx) == 0:
            return None
        self.per_round_participants.append([ca.name(i) for i in idx])
        k = len(idx)

        # dispatch: absent slots spin up; pre-warmed-but-booting slots
        # keep their schedule; running slots start training immediately
        need = idx[st.status[idx] == ABSENT]
        if len(need):
            st.request(need, self._request_zones(need, t0),
                       np.full(len(need), t0), self._draw_spin(len(need)))
        includes_spin = st.status[idx] == SPINNING
        cold = st.fresh[idx].copy()
        start = np.where(includes_spin, st.t_ready[idx], t0)

        # registered finish predictions (pre-round EMAs, dispatch time
        # t0 — exactly what `register_dispatch` + `predict_finish` see)
        cold_pred = np.where(np.isnan(self.ema_cold[idx]),
                             np.where(np.isnan(self.ema_warm[idx]), 0.0,
                                      self.ema_warm[idx]),
                             self.ema_cold[idx])
        warm_pred = np.where(np.isnan(self.ema_warm[idx]),
                             np.where(np.isnan(self.ema_cold[idx]), 0.0,
                                      self.ema_cold[idx]),
                             self.ema_warm[idx])
        pred = (t0 + np.where(includes_spin, self.ema_spin[idx], 0.0)
                + np.where(cold, cold_pred, warm_pred))
        spin_ema_pre = self.ema_spin[idx].copy()

        # epoch durations (same lognormal-jitter arithmetic as
        # `BaseEngine._sample_duration`)
        base = ca.warm_mean[idx] * np.where(cold, ca.cold_mult[idx], 1.0)
        dur = base * np.exp(self._rng_dur.randn(k) * ca.jitter[idx])
        finish = start + dur

        # booting slots become RUNNING at their ready instant
        st.activate(idx[includes_spin], self._model, self._rng_pre, t0)

        # §III-D absorption: reclaims landing before a finish settle the
        # instance, lose work back to the last periodic checkpoint,
        # respin and resume the remainder — iterated until no reclaim
        # precedes any finish
        resumed = np.zeros(k, dtype=bool)
        ckpt = cfg.checkpoint_every_s
        guard = 0
        while True:
            hit = np.nonzero(st.preempt_at[idx] <= finish)[0]
            if len(hit) == 0:
                break
            guard += 1
            if guard > 10000:
                raise RuntimeError(
                    "preemption absorption failed to converge")
            gi = idx[hit]
            t_p = st.preempt_at[gi].copy()
            st.preempt(gi, t_p)
            elapsed = t_p - start[hit]
            preserved = (np.floor(elapsed / ckpt) * ckpt if ckpt > 0.0
                         else np.zeros(len(hit)))
            remaining = np.maximum(dur[hit] - preserved, 1.0)
            self.lost_work_s += float(
                np.maximum(elapsed - preserved, 0.0).sum())
            ready = st.request(gi, self._request_zones(gi, t_p), t_p,
                               self._draw_spin(len(gi)))
            st.activate(gi, self._model, self._rng_pre, t0)
            start[hit] = ready
            dur[hit] = remaining
            finish[hit] = ready + remaining
            # §III-D recovery estimate replaces the registered prediction
            pred[hit] = t_p + spin_ema_pre[hit] + remaining
            resumed[hit] = True

        # §III-B updates at each finish: full epochs feed the cold/warm
        # EMAs; resumed (partial) epochs feed only the spin-up EMA; any
        # finish on a fresh instance contributes its spin-up observation
        cold_at_finish = st.fresh[idx].copy()
        full = ~resumed
        spin_obs = st.t_ready[idx] - st.t_request[idx]
        self._ema_update(self.ema_cold, idx[full & cold],
                         (finish - start)[full & cold])
        self._ema_update(self.ema_warm, idx[full & ~cold],
                         (finish - start)[full & ~cold])
        self._ema_update(self.ema_spin, idx[cold_at_finish],
                         spin_obs[cold_at_finish])
        st.fresh[idx] = False

        # Listing-1 lifecycle at each finish (order-exact, vectorized)
        if (self.policy.manage_lifecycle
                and r >= cfg.calibration_rounds and k > 1):
            self._lifecycle(idx, finish, pred, r)

        f_s = float(finish.max())
        self._summary(f_s, r, k)
        return f_s

    def _lifecycle(self, idx: np.ndarray, finish: np.ndarray,
                   pred: np.ndarray, r: int) -> None:
        """Vectorized `evaluate_termination` for every finisher of the
        round, in finish order: F_s at sorted position p is
        max(prefix-max of actual finishes <= p, suffix-max of
        registered predictions > p); a finisher whose idle window beats
        its (post-update) spin-up EMA by more than `t_threshold_s`
        terminates at its finish and — when more rounds remain —
        pre-warms at `F_s - T_spin - T_buffer` (never before its own
        finish). The round's last finisher never evaluates (the barrier
        has already closed)."""
        st, cfg = self.state, self.sched_cfg
        order = np.argsort(finish, kind="stable")
        f_sorted = finish[order]
        prefix = np.maximum.accumulate(f_sorted)
        pred_sorted = pred[order]
        sfx = np.full(len(order), -np.inf)
        if len(order) > 1:
            sfx[:-1] = np.maximum.accumulate(
                pred_sorted[::-1])[::-1][1:]
        f_s_each = np.maximum(prefix, sfx)
        idle = f_s_each - f_sorted
        t_spin = self.ema_spin[idx][order]
        term = (idle - t_spin) > cfg.t_threshold_s
        term[-1] = False
        if not term.any():
            return
        gi = idx[order[term]]
        st.terminate(gi, f_sorted[term])
        if r + 1 < self.run_cfg.n_epochs:
            pw_t = np.maximum(f_s_each[term] - t_spin[term]
                              - cfg.t_buffer_s, f_sorted[term])
            st.request(gi, self._request_zones(gi, pw_t), pw_t,
                       self._draw_spin(len(gi)))

    def _summary(self, t: float, step_idx: int, k: int) -> None:
        """Publish the round's `FleetStepSummary` (schema v6): settled
        dollars + lifecycle counts since the previous summary, the
        informational open accrual at the barrier, and the per-client
        attribution of the settled dollars (only clients that settled
        this step — names materialize per touched slot, not per
        fleet)."""
        cost_delta, by_zone, touched, amounts = self.state.flush_step()
        self.bus.publish(FleetStepSummary(
            t, step_idx, k,
            int(sum(z.get("spinups", 0.0) for z in by_zone.values())),
            int(sum(z.get("preemptions", 0.0) for z in by_zone.values())),
            int(sum(z.get("terminations", 0.0)
                    for z in by_zone.values())),
            cost_delta,
            float(self.state.open_cost(t).sum()),
            by_zone,
            {self.clients.name(int(i)): float(a)
             for i, a in zip(touched, amounts)}))

    # ------------------------------------------------------------------
    def run(self) -> RunResult:
        """Execute every round and the final teardown; returns the
        fleet-mode `RunResult` (empty timeline/cost-curve — see module
        docstring)."""
        t = 0.0
        completed = 0
        for r in range(self.run_cfg.n_epochs):
            end = self._round(r, t)
            if end is None:
                break
            completed += 1
            t = end + 1.0
        # final teardown at t: absorb in-flight readies/reclaims, then
        # terminate everything still up (min-billing floors apply)
        st = self.state
        self._promote_ready(t)
        self._reclaim_idle(t)
        alive = np.nonzero(st.status != ABSENT)[0]
        st.terminate(alive, np.full(len(alive), t))
        self._summary(t, completed, 0)

        names = self.clients.names()
        per_client = {names[i]: float(st.settled[i])
                      for i in range(self.clients.n)}
        return RunResult(
            total_cost=float(st.settled.sum()),
            per_client_cost=per_client,
            makespan_s=t,
            timeline=[], cost_curve=[],
            rounds_completed=completed,
            excluded_clients=[names[i]
                              for i in np.nonzero(self.excluded)[0]],
            per_round_participants=self.per_round_participants,
            lost_work_s=self.lost_work_s,
            n_preemptions=st.n_preemptions)
