"""Plain reference of one synchronous FL round: every client's local
SGD-momentum steps from the global model on its own token stream, its
update through the int8 block codec where the arm has it, and the FedAvg
fold. NumPy and plain PyTorch; nothing of the program.

The configuration states the stored precision: parameters in their
schema dtype (bfloat16 for the matrices, float32 for norms and per-head
scalars), momentum and updates in float32. So a step computes the loss
and its gradients in float32 from the stored parameters, and stores
(p - lr * m) back in the parameter's dtype; a delta is the float32
difference of two stored values, and the fold stores g + sum w_i d_i.
`fault` plants one of the faults that a correct comparison must catch
(see `FAULTS`); the benchmark's own runs never set it.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from fedbench.reference import model as M

BLOCK = 2048
MOMENTUM = 0.9
# stream i of a run seeded s draws from RandomState(s + STREAM_STRIDE * i)
STREAM_STRIDE = 17

FAULTS = ("unchanged", "half_batch", "client_dropped", "labels_altered",
          "codec_altered")


def token_stream(vocab: int, batch: int, seq: int, seed: int
                 ) -> Iterator[dict]:
    """Token batches of a sparse Markov chain: a random start a row, then
    each token maps through one fixed random table, or with chance 0.1 is
    drawn afresh. Labels are the tokens shifted by one."""
    rng = np.random.RandomState(seed)
    trans = rng.randint(0, vocab, size=(vocab,)).astype(np.int32)
    while True:
        start = rng.randint(0, vocab, size=(batch, 1)).astype(np.int32)
        seqs = [start[:, 0]]
        for _ in range(seq):
            nxt = trans[seqs[-1]]
            flip = rng.rand(batch) < 0.1
            nxt = np.where(flip, rng.randint(0, vocab, size=batch), nxt)
            seqs.append(nxt.astype(np.int32))
        arr = np.stack(seqs, axis=1)
        yield {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


def codec_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """x through the int8 block codec and back: flattened, cut into rows
    of BLOCK (the last padded with zeros), each row scaled by its largest
    magnitude over 127 (an IEEE float32 quotient), rounded half to even
    and clamped to [-127, 127]."""
    flat = x.reshape(-1).float()
    n = flat.numel()
    rows = max(-(-n // BLOCK), 1)
    x2 = torch.nn.functional.pad(flat, (0, rows * BLOCK - n)).reshape(
        rows, BLOCK)
    amax = torch.clamp(x2.abs().amax(dim=1, keepdim=True), min=1e-12)
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x2 / scale), -127, 127).to(torch.int8)
    return (q.float() * scale).reshape(-1)[:n].reshape(x.shape)


def _local_train(family, cfg, stored, mu, batches, lr, prec, fault,
                 device):
    """One client's local steps from `stored`. Returns its stored
    parameters, its momentum and its step losses."""
    p = {k: v.clone() for k, v in stored.items()}
    m = {k: v.clone() for k, v in mu.items()}
    losses = []
    for batch in batches:
        tokens = torch.from_numpy(batch["tokens"]).long().to(device)
        labels = torch.from_numpy(batch["labels"]).long().to(device)
        if fault == "labels_altered":
            labels = tokens
        if fault == "half_batch":
            half = tokens.shape[0] // 2
            tokens, labels = tokens[:half], labels[:half]
        work = {k: v.float().requires_grad_(True) for k, v in p.items()}
        loss = family.loss(work, cfg, tokens, labels, prec)
        grads = torch.autograd.grad(loss, list(work.values()))
        with torch.no_grad():
            for (k, w), g in zip(work.items(), grads):
                m[k].mul_(MOMENTUM).add_(g)
                if fault != "unchanged":
                    p[k] = (w - lr * m[k]).to(p[k].dtype)
        losses.append(float(loss.detach()))
        del work, grads, loss
    return p, m, losses


def zero_momentum(stored: Dict[str, torch.Tensor]):
    return {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for k, v in stored.items()}


def run_round(family, cfg: dict, mix: dict,
              stored: Dict[str, torch.Tensor], seed: int,
              prec: Optional[M.Precision] = None,
              fault: Optional[str] = None) -> dict:
    """The first round of a run seeded `seed` from the stored parameters
    `stored` (flat key -> tensor in its schema dtype; left unchanged), the
    loss that of the configuration's `family` (`fedbench/families/`).
    Returns the round's mean loss, each client's momentum after its steps
    and the stored parameters after the fold."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    prec = prec or M.Precision()
    if {k for k, *_ in family.schema(cfg)} != set(stored):
        raise ValueError("stored parameters do not match the schema")
    device = next(iter(stored.values())).device
    n = mix["clients"]
    base = np.array([float(w) for w in mix["weights"]])
    w = torch.tensor(base, dtype=torch.float32)
    wn = w / torch.clamp(torch.sum(w), min=1e-12)
    vocab = family.dims(cfg)["v"]
    streams = [token_stream(vocab, mix["batch"], mix["seq"],
                            seed + STREAM_STRIDE * i) for i in range(n)]
    batches = [[next(s) for _ in range(mix["local_steps"])] for s in streams]
    avg: Dict[str, torch.Tensor] = {}
    mus: List[Dict[str, torch.Tensor]] = []
    losses = []
    for i in range(n):
        new_p, mu, step_losses = _local_train(
            family, cfg, stored, zero_momentum(stored), batches[i],
            mix["lr"], prec, fault, device)
        mus.append(mu)
        losses.append(float(np.mean(step_losses)))
        if fault == "client_dropped" and i == n - 1:
            continue
        for k, g in stored.items():
            d = new_p[k].float() - g.float()
            if mix["arm"] == "int8":
                d = codec_roundtrip(d)
                if fault == "codec_altered":
                    d = 2.0 * d
            d = d * wn[i]
            avg[k] = avg[k] + d if k in avg else d
        del new_p
    folded = {k: (g.float() + avg[k]).to(g.dtype) for k, g in stored.items()}
    return {"mean_loss": float(np.mean(losses)), "mu": mus,
            "params": folded}
