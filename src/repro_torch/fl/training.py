"""Real-training hooks of the port: LM client steps on one card behind
the FL engines' `TrainerHooks` protocol.

`TorchTrainerHooks` is the counterpart of the JAX package's
`fl/training.py::MeshTrainerHooks` and follows its round mapping: the
engine calls `run_local(c, r)` at each client's simulated
epoch-completion instant, which only marks the client as a round
participant, and the compute runs inside `aggregate`. There every
participant trains `local_steps` SGD-momentum steps from the global
model, its fp32 delta is (on the quantized arm) round-tripped leaf by
leaf through the `kernels/grad_quant` int8 codec, and the deltas are
folded into the global model with FedAvg weights discounted for
staleness by the FedBuff 1/sqrt(1+s) rule.

Where the JAX package trains every client slot at once on its own mesh
pod (`vmap`) and then masks out the non-participants, the port trains
the participants one after another on the one card and skips the
others. Every slot's batches are still drawn each round, so each
client's `token_stream` stays where the JAX run's would be, and a
non-participant keeps its momentum, as the JAX `keep` mask does.

The hooks run on the card (`device="cuda"`) unless the caller asks for
the CPU; without a card the default raises.

Calibration (`calibrate` / `calibrated_profiles`) anchors simulated
time to real compute, as the JAX package's does: it wall-clocks one
round of local training of every slot, cross-checks the measurement
against a roofline estimate (`launch.roofline.estimate_step_time`) built
from the FLOPs and bytes counted over one such round
(`launch.roofline.WorkCounter`, the kernels' own work included) and the
peaks measured on the hooks' device, and rewrites
`ClientProfile.mean_epoch_s` from the measurement.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import configs
from repro_torch.common.bridge import flatten_with_paths, unflatten
from repro_torch.common.config import ClientProfile, ModelConfig
from repro_torch.comms.payload import UpdatePayload
from repro_torch.data.synthetic import token_stream
from repro_torch.fl.types import TrainerHooks
from repro_torch.kernels.grad_quant import ops as gq
from repro_torch.launch.roofline import WorkCounter, estimate_step_time
from repro_torch.models import lm


def _require_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "TorchTrainerHooks: no CUDA device is available; pass "
            "device='cpu' to run the plain versions on the CPU")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class TorchTrainerHooks(TrainerHooks):
    """Real LM training on one device behind the engine hook protocol
    (see the module docstring for the round mapping)."""

    def __init__(self, clients: Sequence[str],
                 model: str = "phi3-mini-3.8b", smoke: bool = True,
                 local_steps: int = 4, batch: int = 8, seq: int = 32,
                 lr: float = 5e-3, quantize: bool = False, seed: int = 0,
                 weights: Optional[Dict[str, float]] = None,
                 device="cuda", cfg: Optional[ModelConfig] = None):
        self.device = _require_device(device)
        self.clients = list(clients)
        self.slot = {c: i for i, c in enumerate(self.clients)}
        if len(self.slot) != len(self.clients):
            raise ValueError("duplicate client names")
        self.cfg = cfg if cfg is not None else configs.get_config(
            model, smoke=smoke)
        self.local_steps = local_steps
        self.batch = batch
        self.seq = seq
        self.quantize = quantize
        self._lr = lr
        n = len(self.clients)
        self.params = lm.init_params(self.cfg, seed, self.device)
        self.mu = [self._zero_momentum() for _ in range(n)]
        self._base_w = np.array(
            [float((weights or {}).get(c, 1.0)) for c in self.clients])
        self._streams = [token_stream(self.cfg.vocab_size, batch, seq,
                                      seed=seed + 17 * i)
                         for i in range(n)]
        self._participants: Dict[str, int] = {}   # client -> last round
        self.losses: List[dict] = []              # per-aggregation record

    def _zero_momentum(self):
        return {k: torch.zeros(p.shape, dtype=torch.float32,
                               device=self.device)
                for k, p in flatten_with_paths(self.params)}

    @staticmethod
    def staleness_discount(staleness: int) -> float:
        """FedBuff (arXiv:2106.06639) polynomial staleness weight: a
        fresh update keeps its full weight, an update `s` rounds stale
        is discounted by 1/sqrt(1+s)."""
        return 1.0 / math.sqrt(1.0 + max(staleness, 0))

    # ------------------------------------------------------------------
    # Round pieces.
    # ------------------------------------------------------------------
    def _local_train(self, params, mu, batches):
        """`local_steps` SGD-momentum steps on one client from `params`.
        Returns the client's flat params, its new momentum and its
        per-step losses; `params` and `mu` are left as they were."""
        cfg, lr = self.cfg, self._lr
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in flatten_with_paths(params)}
        m = {k: v.clone() for k, v in mu.items()}
        tree = unflatten(p)
        losses = []
        for batch in batches:
            loss = lm.loss_fn(tree, cfg, batch)
            grads = torch.autograd.grad(loss, list(p.values()))
            with torch.no_grad():
                for (k, leaf), g in zip(p.items(), grads):
                    m[k].mul_(0.9).add_(g.float())
                    leaf.copy_((leaf.float() - lr * m[k]).to(leaf.dtype))
            losses.append(loss.detach())
        new_p = {k: v.detach() for k, v in p.items()}
        return new_p, m, torch.stack(losses).float().cpu().numpy()

    def _quant_roundtrip(self, delta):
        """Round-trip one participant's fp32 leaf delta through the int8
        codec — the aggregated update is built from exactly the payload
        the comms subsystem bills."""
        q, s = gq.quantize(delta)
        return gq.dequantize(q, s, delta.shape, torch.float32)

    # ------------------------------------------------------------------
    # TrainerHooks protocol.
    # ------------------------------------------------------------------
    def run_local(self, client: str, round_idx: int) -> None:
        """Mark the client's round-`round_idx` update as produced; the
        compute itself runs in `aggregate`."""
        if client not in self.slot:
            raise KeyError(f"unknown client {client!r}")
        self._participants[client] = round_idx

    def aggregate(self, participants: List[str], round_idx: int,
                  staleness: Optional[Dict[str, int]] = None) -> None:
        """Run the real round: local training of every participant, then
        fold their (optionally int8-round-tripped) deltas into the
        global model with staleness-discounted FedAvg weights."""
        live = [c for c in participants if c in self._participants]
        if not live:
            return
        stale = staleness or {}
        batches = self._next_batches()
        mask = np.zeros(len(self.clients))
        for c in set(live):
            mask[self.slot[c]] = (self._base_w[self.slot[c]]
                                  * self.staleness_discount(stale.get(c, 0)))
        w = torch.tensor(mask, dtype=torch.float32)
        wn = w / torch.clamp(torch.sum(w), min=1e-12)

        global_p = dict(flatten_with_paths(self.params))
        avg: Dict[str, torch.Tensor] = {}
        mean_losses = []
        for i in sorted(self.slot[c] for c in set(live)):
            new_p, self.mu[i], losses = self._local_train(
                self.params, self.mu[i], batches[i])
            mean_losses.append(losses.mean())
            for k, g in global_p.items():
                d = new_p[k].float() - g.float()
                if self.quantize:
                    d = self._quant_roundtrip(d)
                d = d * wn[i]
                avg[k] = avg[k] + d if k in avg else d
            del new_p
        self.params = unflatten({
            k: (g.float() + avg[k]).to(g.dtype) for k, g in global_p.items()})
        self.losses.append({"round": round_idx,
                            "mean_loss": float(np.mean(mean_losses))})
        for c in live:
            self._participants.pop(c, None)

    def update_payload(self, quantized: bool = False) -> UpdatePayload:
        """Byte-exact size of one client's update: the global parameters
        in the requested wire format."""
        return UpdatePayload.from_tree(self.params, quantized=quantized)

    # ------------------------------------------------------------------
    # Round execution + measurement.
    # ------------------------------------------------------------------
    def _next_batches(self):
        """`local_steps` batches for every client slot, on the device."""
        out = []
        for s in self._streams:
            rows = [next(s) for _ in range(self.local_steps)]
            out.append([{k: torch.from_numpy(r[k]).long().to(self.device)
                         for k in ("tokens", "labels")} for r in rows])
        return out

    def global_params(self):
        """The current global model (a nested dict of tensors)."""
        return self.params

    def final_loss(self) -> float:
        """Mean participant loss of the last aggregation (inf before
        the first one) — the accuracy side of the egress trade."""
        return self.losses[-1]["mean_loss"] if self.losses \
            else float("inf")

    def measure_round_s(self, warmup: int = 1, iters: int = 2) -> float:
        """Wall-clock one round of local training of every slot, on
        held-out batches, after `warmup` runs: the median of `iters`
        timed rounds (their mean for two). State is not advanced."""
        batches = self._next_batches()

        def one_round():
            t0 = time.perf_counter()
            for i, b in enumerate(batches):
                self._local_train(self.params, self.mu[i], b)
            _sync(self.device)
            return time.perf_counter() - t0

        for _ in range(max(warmup, 1)):
            one_round()
        return float(np.median([one_round() for _ in range(max(iters, 1))]))

    def count_round_work(self) -> WorkCounter:
        """The FLOPs and bytes of one round of local training of every
        slot, on held-out batches, as `measure_round_s` times it. State
        is not advanced."""
        batches = self._next_batches()
        with WorkCounter() as wc:
            for i, b in enumerate(batches):
                self._local_train(self.params, self.mu[i], b)
        return wc


# ---------------------------------------------------------------------------
# Calibration: measured round time -> simulated ClientProfile epoch times,
# cross-checked against a measured-peak roofline estimate.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StepCalibration:
    """One calibration measurement and its roofline cross-check."""
    measured_round_s: float      # wall-clock of one round of every slot
    roofline_round_s: float      # estimate from counted work + peaks
    flops: float                 # FLOPs counted over that round
    bytes_accessed: float        # bytes counted over that round
    peak_flops: float            # measured matmul throughput (FLOP/s)
    mem_bw: float                # measured memory bandwidth (bytes/s)

    @property
    def ratio(self) -> float:
        """measured / roofline — the cross-check of the measurement."""
        return self.measured_round_s / self.roofline_round_s

    def mean_epoch_s(self, time_scale: float = 1.0) -> float:
        """The simulated epoch duration this measurement anchors:
        one local-training round scaled by `time_scale` (the paper's
        scaled-duration simulation knob)."""
        return self.measured_round_s * time_scale


def _per_call_s(fn, dev: torch.device, iters: int) -> float:
    """Seconds one call of `fn` takes on `dev`, over `iters` calls after
    one warm-up call. On the card it is device time (CUDA events), the
    calls queued behind a sleep kernel of about 50 ms, so the host's
    time to issue them, and any pause of the host meanwhile, stays out."""
    fn()
    _sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def _measure_peaks(device, iters: int = 8):
    """Measured peaks of `device` for the roofline cross-check:
    achievable matmul FLOP/s and memory copy bandwidth (bytes read and
    written by `x + 1`). On the CPU at the JAX package's sizes, fp32
    products of dim 256 and a 16 MB copy, comparable to the smoke
    model's ops; on the card at sizes that reach its peak, bf16
    products of dim 8192 and a 1 GiB copy. Each timed call writes into
    one output, so no allocation falls inside the timing."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dim, dtype, n_copy = 8192, torch.bfloat16, 1 << 28
    else:
        dim, dtype, n_copy = 256, torch.float32, 1 << 22
    gen = torch.Generator().manual_seed(0)
    a, b = (torch.randn(dim, dim, generator=gen).to(dtype).to(dev)
            for _ in range(2))
    c = torch.empty(dim, dim, dtype=dtype, device=dev)
    flops_s = 2.0 * dim ** 3 / _per_call_s(
        lambda: torch.mm(a, b, out=c), dev, iters)
    del a, b, c

    x = torch.zeros(n_copy, dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    bw = 2.0 * x.numel() * 4 / _per_call_s(
        lambda: torch.add(x, 1.0, out=out), dev, iters)
    del x, out
    return flops_s, bw


def calibrate(hooks: TorchTrainerHooks, warmup: int = 1,
              iters: int = 2) -> StepCalibration:
    """Measure one round's wall-clock and cross-check it against the
    roofline estimate built from the FLOPs and bytes counted over one
    round and the peaks measured on the hooks' device. A round trains
    every slot in turn, so the counts are the whole round's, and the
    terms combine serially (`combine="sum"`)."""
    measured = hooks.measure_round_s(warmup=warmup, iters=iters)
    wc = hooks.count_round_work()
    flops, nbytes = wc.flops, wc.bytes_accessed
    peak_flops, bw = _measure_peaks(hooks.device)
    roofline = estimate_step_time(flops, nbytes, peak_flops=peak_flops,
                                  hbm_bw=bw, combine="sum")
    return StepCalibration(measured_round_s=measured,
                           roofline_round_s=roofline, flops=flops,
                           bytes_accessed=nbytes, peak_flops=peak_flops,
                           mem_bw=bw)


def calibrated_profiles(profiles: Sequence[ClientProfile],
                        cal: StepCalibration,
                        time_scale: float = 1.0) -> List[ClientProfile]:
    """Rewrite each profile's `mean_epoch_s` from the measurement —
    simulated durations anchored to real compute instead of config
    guesses. Relative client speed (each profile's epoch time vs the
    cohort mean) is preserved so heterogeneity survives calibration."""
    base = float(np.mean([p.mean_epoch_s for p in profiles]))
    anchor = cal.mean_epoch_s(time_scale)
    return [dataclasses.replace(
        p, mean_epoch_s=anchor * (p.mean_epoch_s / base if base > 0
                                  else 1.0))
            for p in profiles]
