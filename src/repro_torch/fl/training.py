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
the CPU; without a card the default raises. `calibrate` and
`calibrated_profiles` come with the slice that ports the roofline
tooling (ROADMAP §1, queued item 2).
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import configs
from repro_torch.common.bridge import flatten_with_paths, unflatten
from repro_torch.common.config import ModelConfig
from repro_torch.comms.payload import UpdatePayload
from repro_torch.data.synthetic import token_stream
from repro_torch.fl.types import TrainerHooks
from repro_torch.kernels.grad_quant import ops as gq
from repro_torch.models import lm


def _require_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "TorchTrainerHooks: no CUDA device is available; pass "
            "device='cpu' to run the plain versions on the CPU")
    return dev


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
        held-out batches, after `warmup` runs. State is not advanced."""
        batches = self._next_batches()

        def one_round():
            for i, b in enumerate(batches):
                self._local_train(self.params, self.mu[i], b)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        for _ in range(max(warmup, 1)):
            one_round()
        t0 = time.perf_counter()
        for _ in range(max(iters, 1)):
            one_round()
        return (time.perf_counter() - t0) / max(iters, 1)
