"""SyncEngine: the paper's synchronous round barrier (Table I).

Behavior-preserving port of the seed `FLCloudRunner` round logic — for a
fixed seed it schedules the identical event sequence, so `RunResult`
totals for the on_demand / spot / fedcostaware policies match the
pre-refactor values (pinned by tests/test_engines.py). One deliberate
deviation: the seed's preemption recovery ignored a client's pinned
zone under cheapest-zone policies (recovering in the cheapest zone);
`ClusterManager.request` now honors the pin on every request, initial
or recovery.

One FL round dispatches every participant, waits for all results (the
synchronous barrier), aggregates, then starts the next round. The
engine itself makes no scheduling decisions: results, dispatches and
recoveries are reported to the `StrategyStack`, whose components
(Listing-1 lifecycle, §III-E budget screening — `repro_torch.core.strategy`)
answer with directives the `DirectiveExecutor` applies.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.cloud.simulator import RUNNING, SPINNING_UP
from repro_torch.core.events import ClientLost, ClientReady
from repro_torch.fl.engines.base import BaseEngine, EngineContext


class SyncEngine(BaseEngine):
    name = "sync"

    def __init__(self, ctx: EngineContext):
        super().__init__(ctx)
        self._pending_task: Dict[str, Optional[int]] = {}  # client->round
        self._resumed: set = set()
        self._round_pending: set = set()
        self._participants: List[str] = []

    # ------------------------------------------------------------------
    def start(self):
        self.sim.schedule(0.0, lambda: self._start_round(0))

    # ------------------------------------------------------------------
    # Round lifecycle.
    # ------------------------------------------------------------------
    def _start_round(self, r: int):
        if r >= self.run_cfg.n_epochs:
            self._finish_run()
            return
        self.strategies.begin_round(r)
        # elastic scaling: clients may join at a later round (§V future
        # work); budget exhaustion below is the symmetric leave path.
        clients = [c for c, p in self.profiles.items()
                   if p.join_round <= r]
        if r >= 1:
            clients = self._screen_round(r, clients)
        if not clients:
            # nobody makes it into round r: it never ran, so leave
            # _round_idx at the last *completed* round (keeps
            # rounds_completed == #RoundCompleted events).
            self._finish_run()
            return
        self._round_idx = r
        self._participants = clients
        self.per_round_participants.append(list(clients))
        self._round_pending = set(clients)
        self._publish_round_started(r, clients)
        for c in clients:
            self._dispatch(c, r)

    def _dispatch(self, c: str, r: int):
        inst = self.cluster.instance_of(c)
        t = self.sim.now
        if inst is not None and inst.state == RUNNING:
            cold = self.cluster.is_fresh(inst.iid)
            self.strategies.note_dispatch(c, t, cold, False)
            self._begin_training(c, cold)
        elif inst is not None and inst.state == SPINNING_UP:
            # pre-warmed instance still booting: task queued until ready
            self._pending_task[c] = r
            self.strategies.note_dispatch(c, t, True, True)
        else:
            self._pending_task[c] = r
            self.strategies.note_dispatch(c, t, True, True)
            self.cluster.request(c)

    def _on_client_ready(self, ev: ClientReady):
        c = ev.client
        if ev.resume_token is not None:
            self._resume(c, ev)
        elif self._pending_task.get(c) is not None:
            self._pending_task[c] = None
            self._begin_training(c, cold=True)
        else:
            self._mark(c, "idle")  # pre-warmed, waits for next round

    def _is_training(self, c: str) -> bool:
        """Mid-epoch iff the round still owes `c` a result and its
        tracked instance is RUNNING (a resuming client's replacement is
        still SPINNING_UP, an aggregated client left `_round_pending`,
        an uploading client's epoch compute is already done)."""
        inst = self.cluster.instance_of(c)
        return (c in self._round_pending and c in self._train_start
                and c not in self._uploading
                and inst is not None and inst.state == RUNNING)

    # ------------------------------------------------------------------
    # Local training execution (simulated duration; real training via hooks).
    # ------------------------------------------------------------------
    def _begin_training(self, c: str, cold: bool):
        r = self._round_idx
        dur = self._sample_duration(c, cold)
        self._train_start[c] = self.sim.now
        self._train_duration[c] = dur
        self._mark(c, "training")
        iid = self.cluster.instance_of(c).iid
        self.sim.schedule_in(dur, lambda: self._finish_training(c, r, iid))

    def _finish_training(self, c: str, r: int, iid: int):
        inst = self.cluster.instance_of(c)
        if inst is None or inst.iid != iid or r != self._round_idx:
            return                                  # stale (preempted)
        if c not in self._round_pending:
            return
        self.strategies.invalidate_ckpt(c)  # epoch done: snapshot stale
        t = self.sim.now
        dur = t - self._train_start[c]
        cold = self.cluster.is_fresh(inst.iid)
        spin_obs = None
        if cold and inst.t_ready is not None:
            spin_obs = inst.t_ready - inst.t_request
        self.cluster.mark_warm(inst.iid)
        if c in self._resumed:
            # Partial (resumed) epochs would corrupt the epoch-time EMAs;
            # only the spin-up observation is still valid.
            self._resumed.discard(c)
            self.strategies.note_resume_result(c, t, spin_obs)
        else:
            self.strategies.note_result(c, t, dur, cold, spin_obs)
        if self.hooks:
            self.hooks.run_local(c, r)
        if self.comms is not None:
            self._begin_upload(c, r)
            return
        self._complete_result(c, r)

    def _begin_upload(self, c: str, r: int):
        """Comms modeling: the finished update occupies the client's
        uplink before the barrier can count it. The update itself is
        already committed (`run_local` buffered it), so a reclaim
        mid-upload loses no work — only the modeled transfer time
        stretches the round."""
        xfer = self._publish_update_sent(c, r)
        if xfer <= 0.0:
            self._complete_result(c, r)
            return
        self._uploading.add(c)
        self._mark(c, "uploading")
        self.sim.schedule_in(xfer, lambda: self._finish_upload(c, r))

    def _finish_upload(self, c: str, r: int):
        self._uploading.discard(c)
        if r != self._round_idx or c not in self._round_pending:
            return                                  # stale (run moved on)
        self._complete_result(c, r)

    def _complete_result(self, c: str, r: int):
        """The barrier receives `c`'s round-`r` update: release the
        client and end the round when it was the last one owed."""
        self._round_pending.discard(c)
        self._mark(c, "idle")

        if self._round_pending:
            more = (r + 1) < self.run_cfg.n_epochs
            self.strategies.client_result(c, self.sim.now, more)

        if not self._round_pending:
            self._end_round(r)

    # ------------------------------------------------------------------
    # Preemption (§III-D).
    # ------------------------------------------------------------------
    def _on_client_lost(self, ev: ClientLost):
        c = ev.client
        was_training = (c in self._round_pending and c in self._train_start
                        and c not in self._uploading)
        if not was_training:
            # idle / pre-warmed / mid-upload instance lost: an uploading
            # client's update is already committed (no redo) — the
            # upload completes on schedule; next dispatch re-requests
            self._mark(c, "savings")
            return
        # Progress up to the best surviving checkpoint survives: the
        # warning-window snapshot when the provider's notice let us
        # write one (§III-D fault tolerance + notice-aware extension),
        # else the last periodic checkpoint. The client reloads from
        # cloud storage and resumes mid-epoch.
        remaining, source = self._preemption_remaining(c)
        self.note_lost_work(c, remaining)
        r = self._round_idx
        self.cluster.request(
            c, resume_token={"round": r, "remaining": remaining,
                             "source": source})
        self.strategies.recovered(c, remaining)

    def after_drain(self, c: str, remaining: float):
        """Drain vacates the instance and re-requests immediately —
        the same recovery shape as a reclaim, so the peers' pre-warm
        targets move by the same §III-D adjustment (otherwise they
        would spin up at their original targets and idle at the
        barrier while `c` redoes `remaining` seconds)."""
        self.strategies.recovered(c, remaining)

    def _resume(self, c: str, ev: ClientReady):
        tok = ev.resume_token
        if tok["round"] != self._round_idx:
            return
        remaining = tok["remaining"]
        self._resumed.add(c)
        self._train_start[c] = self.sim.now
        self._train_duration[c] = remaining
        if tok.get("source") == "warning":
            self._publish_resumed_from_checkpoint(
                c, self._round_idx, remaining)
        self._mark(c, "training")
        r = self._round_idx
        iid = ev.instance.iid
        self.sim.schedule_in(
            remaining, lambda: self._finish_training(c, r, iid))

    # ------------------------------------------------------------------
    def _end_round(self, r: int):
        # barrier semantics: every update aggregated here is fresh
        self._call_aggregate(list(self._participants), r)
        snap = self._cost_snapshot()
        self._record_costs(snap)
        self._publish_round_completed(r, self._participants, snap)
        self.sim.schedule_in(1.0, lambda: self._start_round(r + 1))

    def _finish_run(self):
        self._done = True
        self.cluster.shutdown()
        for c in self.profiles:
            if self.cluster.instance_of(c) is not None:
                self.cluster.terminate(c)
            self._mark(c, "done")
        self._record_costs()
