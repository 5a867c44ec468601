"""AsyncBufferedEngine: FedBuff-style buffered asynchronous rounds.

A workload the synchronous barrier cannot express: the server aggregates
as soon as `K = buffer_k` client results are buffered (default: all but
one client), then immediately opens the next round. Clients never wait
at a barrier — each one is re-dispatched on the freshest global model
the moment its previous epoch finishes, and a straggler's in-flight
result simply rolls into whichever round's buffer is open when it lands
(FedBuff, arXiv:2106.06639). Each buffered result is tagged with the
round it was dispatched in; at aggregation the engine reports
`staleness = aggregating_round - dispatch_round` per participant to
`TrainerHooks.aggregate`, and the training hook discounts stale updates by
the FedBuff weight 1/sqrt(1+staleness).

Cost behavior: instances are never idle-at-the-barrier, so there is
nothing for Listing-1 terminate/pre-warm decisions to reclaim — the
saving comes from finishing the same number of aggregations in far less
wall-clock (lower makespan => fewer billed instance-seconds for the fast
clients' peers). Budget screening (§III-E) still runs at every round
boundary, and per-client spend is tracked by the same `CostAccountant`
as the sync engine.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.cloud.simulator import RUNNING
from repro_torch.core.events import ClientLost, ClientReady
from repro_torch.fl.engines.base import BaseEngine, EngineContext


class AsyncBufferedEngine(BaseEngine):
    name = "async_buffered"

    def __init__(self, ctx: EngineContext):
        super().__init__(ctx)
        n = len(self.profiles)
        k = ctx.run_cfg.buffer_k
        self.buffer_k = max(1, min(k if k is not None else n - 1, n))
        self._buffer: List[str] = []       # results awaiting aggregation
        self._buffer_round: Dict[str, int] = {}  # client -> dispatch round
        self._dispatch_round: Dict[str, int] = {}
        self._active: List[str] = []       # participating clients, ordered
        self._task: Dict[str, int] = {}    # client -> in-flight task iid
        self._resumed: set = set()            # partial epochs: skip EMAs
        self._pending_dispatch: set = set()   # waiting for instance ready

    # ------------------------------------------------------------------
    def start(self):
        self.sim.schedule(0.0, self._launch)

    def _launch(self):
        self._round_idx = 0
        joins = [c for c, p in self.profiles.items() if p.join_round <= 0]
        self._publish_round_started(0, joins)
        for c in joins:
            self._join(c)

    def _join(self, c: str):
        self._active.append(c)
        self._dispatch(c)

    # ------------------------------------------------------------------
    # Dispatch / local training.
    # ------------------------------------------------------------------
    def _dispatch(self, c: str):
        inst = self.cluster.instance_of(c)
        if inst is not None and inst.t_ready is not None:
            self._begin_training(c, cold=self.cluster.is_fresh(inst.iid))
        else:
            self._pending_dispatch.add(c)
            if inst is None:
                self.cluster.request(c)

    def _begin_training(self, c: str, cold: bool,
                        duration: Optional[float] = None):
        """`duration` overrides the sampled epoch time for checkpoint
        resumes (the task only owes the post-checkpoint remainder)."""
        dur = duration if duration is not None \
            else self._sample_duration(c, cold)
        self._train_start[c] = self.sim.now
        self._train_duration[c] = dur
        # checkpoint resumes keep the original dispatch round: the
        # update is still based on that round's global model
        if duration is None:
            self._dispatch_round[c] = self._round_idx
        self._mark(c, "training")
        iid = self.cluster.instance_of(c).iid
        self._task[c] = iid
        if duration is not None:
            self._resumed.add(c)
        self.sim.schedule_in(dur, lambda: self._finish_training(c, iid))

    def _is_training(self, c: str) -> bool:
        """Mid-epoch iff the client's in-flight task is bound to its
        currently tracked, RUNNING instance."""
        iid = self._task.get(c)
        inst = self.cluster.instance_of(c)
        return (iid is not None and inst is not None
                and inst.iid == iid and inst.state == RUNNING)

    def _finish_training(self, c: str, iid: int):
        if self._done:
            return
        inst = self.cluster.instance_of(c)
        if inst is None or inst.iid != iid or self._task.get(c) != iid:
            return                                  # stale (preempted)
        if c not in self._active:
            return                                  # excluded mid-flight
        self.strategies.invalidate_ckpt(c)  # epoch done: snapshot stale
        t = self.sim.now
        dur = t - self._train_start[c]
        cold = self.cluster.is_fresh(inst.iid)
        spin_obs = None
        if cold and inst.t_ready is not None:
            spin_obs = inst.t_ready - inst.t_request
        self.cluster.mark_warm(inst.iid)
        del self._task[c]
        # keep the estimator EMAs fresh — budget screening prices the
        # next epoch off them, exactly as in the sync engine. Partial
        # (checkpoint-resumed) epochs would corrupt the epoch EMAs, so
        # only the spin-up observation survives for those.
        if c in self._resumed:
            self._resumed.discard(c)
        else:
            self.strategies.note_observation(c, epoch_s=dur, cold=cold)
        if spin_obs is not None:
            self.strategies.note_observation(c, spin_up_s=spin_obs)
        if self.hooks:
            self.hooks.run_local(c, self._round_idx)
        dr = self._dispatch_round.get(c, self._round_idx)
        if self.comms is not None:
            self._begin_upload(c, dr)
            return
        self._complete_result(c, dr)

    def _begin_upload(self, c: str, dr: int):
        """Comms modeling: the finished update occupies the client's
        uplink before it can enter the buffer (and before the client is
        re-dispatched). `dr` pins the update's dispatch round now — a
        reclaim mid-upload may start the client's *next* epoch before
        the upload lands, clobbering `_dispatch_round`."""
        xfer = self._publish_update_sent(c, self._round_idx)
        if xfer <= 0.0:
            self._complete_result(c, dr)
            return
        self._uploading.add(c)
        self._mark(c, "uploading")
        self.sim.schedule_in(xfer, lambda: self._finish_upload(c, dr))

    def _finish_upload(self, c: str, dr: int):
        self._uploading.discard(c)
        if self._done or c not in self._active:
            return                                  # excluded mid-upload
        self._complete_result(c, dr)

    def _complete_result(self, c: str, dr: int):
        """`c`'s round-`dr` update reaches the server: buffer it,
        aggregate when the buffer fills, put the client back to work."""
        self._buffer.append(c)
        self._buffer_round[c] = dr
        if c not in self._task:
            self._mark(c, "idle")
        # exclusions may shrink the pool below buffer_k; clamp so the
        # run can still make progress (else it would spin forever)
        k_eff = min(self.buffer_k, max(1, len(self._active)))
        if len(self._buffer) >= k_eff:
            self._aggregate()
        # a reclaim mid-upload may already have re-requested (or even
        # restarted) the client; only dispatch when nothing is in flight
        if (not self._done and c in self._active
                and self._task.get(c) is None
                and c not in self._pending_dispatch):
            self._dispatch(c)       # straight back to work, no barrier

    # ------------------------------------------------------------------
    # Buffered aggregation = one async "round".
    # ------------------------------------------------------------------
    def _aggregate(self):
        r = self._round_idx
        participants = list(self._buffer)
        self._buffer.clear()
        # FedBuff staleness: rounds elapsed since each buffered result's
        # dispatch (a straggler dispatched in round r-k lands with
        # staleness k; the hook discounts it by 1/sqrt(1+k)). A fast
        # client can appear in `participants` twice per aggregation;
        # hooks keyed on client (TorchTrainerHooks) then see only its
        # latest update, and this dict matches that update's dispatch
        # round — the surviving entry, not the overwritten one.
        staleness = {c: max(r - self._buffer_round.get(c, r), 0)
                     for c in participants}
        self._buffer_round.clear()
        self._call_aggregate(participants, r, staleness)
        self.per_round_participants.append(participants)
        snap = self._cost_snapshot()
        self._record_costs(snap)
        self._publish_round_completed(r, participants, snap)
        if r + 1 >= self.run_cfg.n_epochs:
            self._finish_run()
            return
        self._screen_budgets(r + 1)
        if not self._active and not self._buffer:
            # round r+1 never opens: keep _round_idx at the last
            # completed round so rounds_completed == #RoundCompleted.
            self._finish_run()
            return
        self._round_idx = r + 1
        joins = [c for c, p in self.profiles.items()
                 if c not in self._active and c not in self.excluded
                 and p.join_round <= self._round_idx]
        self._publish_round_started(
            self._round_idx, list(self._active) + joins)
        for c in joins:
            self._join(c)

    def _screen_budgets(self, round_idx: int):
        """§III-E screening at the round boundary: the strategy stack
        excludes the unaffordable clients (publishing and tearing
        down through `ScreenOut` directives); the engine only drops
        them from its own dispatch bookkeeping."""
        keep = self._screen_round(round_idx, list(self._active))
        for c in [c for c in self._active if c not in keep]:
            self._active.remove(c)
            self._task.pop(c, None)
            self._pending_dispatch.discard(c)

    # ------------------------------------------------------------------
    # Bus events.
    # ------------------------------------------------------------------
    def _on_client_ready(self, ev: ClientReady):
        c = ev.client
        if self._done or c not in self._active:
            return
        if ev.resume_token is not None:
            if ev.resume_token.get("source") == "warning":
                self._publish_resumed_from_checkpoint(
                    c, self._round_idx, ev.resume_token["remaining"])
            self._begin_training(c, cold=True,
                                 duration=ev.resume_token["remaining"])
        elif c in self._pending_dispatch:
            self._pending_dispatch.discard(c)
            self._begin_training(c, cold=True)

    def _on_client_lost(self, ev: ClientLost):
        c = ev.client
        if self._done or c not in self._active:
            return
        if self._task.pop(c, None) is None:
            # idle or mid-upload (the committed update still lands on
            # schedule — only instance-seconds were lost, no redo)
            self._mark(c, "savings")
            self._pending_dispatch.add(c)       # re-request on next need
            self.cluster.request(c)
            return
        # resume from the best surviving checkpoint: the warning-window
        # snapshot when the provider's notice let us write one, else
        # the last periodic checkpoint (§III-D)
        remaining, source = self._preemption_remaining(c)
        self.note_lost_work(c, remaining)
        self.cluster.request(c, resume_token={"remaining": remaining,
                                              "source": source})

    # ------------------------------------------------------------------
    def _finish_run(self):
        self._done = True
        self._makespan = self.sim.now
        self.cluster.shutdown()
        for c in self.profiles:
            if self.cluster.instance_of(c) is not None:
                self.cluster.terminate(c)       # stragglers cut off here
            self._mark(c, "done")
        self._record_costs()
