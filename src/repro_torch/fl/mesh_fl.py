"""FL in the mesh: synchronous federated rounds over client-stacked
parameters, the port of the JAX package's `fl/mesh_fl.py`.

Client-stacked parameters carry a leading client dim. The JAX package
shards that dim over the `pod` axis of its mesh; the port runs it one of
two ways:

  stacked   (`group=None`) all C clients on one device, trained one
            after another, aggregated by a local weighted sum;
  one rank  (`group` a `torch.distributed` process group) each rank
  a client  holds its own slot (leading dim 1) and the full (C,) weights;
            the aggregation is a collective over the group.

Local steps touch no other client (the paper's "no data leaves the
client"); the round boundary is one aggregation. Two aggregation paths:

  fedavg_sync             plain weighted average of the client models,
                          fp32 sums (an `all_reduce` over a group)
  fedavg_sync_compressed  the clients' deltas from the global model,
                          int8 per tensor, summed in the order of a ring
                          of pods (an `all_gather` over a group)

Each counts the bytes of its collective for the dry run
(`collective_stats`): the all-reduce's fp32 payload a client hands in,
and the int8 ring's bytes each client receives, (n-1) pieces of int8
values, one fp32 scale and one fp32 weight a leaf. Stacked, they count
what each client would move over n pods.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.common.bridge import flatten_with_paths, tree_map, unflatten
from repro_torch.launch.roofline import CollectiveStats
from repro_torch.models import lm
from repro_torch.sharding.rules import INERT, ShardingCtx


def _group_rank(group):
    return dist.get_rank(group), dist.get_world_size(group)


def _device(tree):
    return flatten_with_paths(tree)[0][1].device


# ---------------------------------------------------------------------------
# Plain FedAvg over the client dim.
# ---------------------------------------------------------------------------
def fedavg_sync(params_stacked, weights, group=None):
    """params_stacked: (C, ...) tree, or (1, ...) on each rank of `group`;
    weights: (C,). Returns the averaged params re-broadcast to every
    client slot (all clients leave the round with the identical global
    model, as synchronous FL requires). The weights are normalised and
    the weighted sum taken in fp32, client by client in slot order
    (over a group, each rank's term summed by `all_reduce`), then cast
    to each leaf's dtype."""
    w = (weights / torch.sum(weights)).float().to(_device(params_stacked))

    def avg(p):
        if group is None:
            m = p[0].float() * w[0]
            for c in range(1, p.shape[0]):
                m = m + p[c].float() * w[c]
            n = p.shape[0]
        else:
            rank, n = _group_rank(group)
            m = p[0].float() * w[rank]
            dist.all_reduce(m, group=group)
        if n > 1:
            fedavg_sync.collective_bytes += m.numel() * 4
            fedavg_sync.collectives += 1
        return m[None].to(p.dtype).expand(p.shape)

    return tree_map(avg, params_stacked)


fedavg_sync.collective_bytes = 0
fedavg_sync.collectives = 0


# ---------------------------------------------------------------------------
# Compressed FedAvg: int8 per tensor, summed in a ring's order.
# ---------------------------------------------------------------------------
def _quantize_int8(x):
    """Symmetric per-tensor int8 quantization; returns (q, scale).
    `torch.round` rounds halves to even, as `jnp.round` does."""
    xf = x.float()
    amax = torch.clamp(torch.max(torch.abs(xf)), min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q, scale):
    return q.float() * scale


def _ring_sum(qs, scales, ws, r):
    """Pod r's sum: its own term, then those of pods r-1, r-2, ... as a
    ring whose every step passes each pod's piece to pod i+1 brings
    them (the JAX package's `ppermute` with `i -> i+1`)."""
    n = len(qs)
    acc = _dequantize_int8(qs[r], scales[r]) * ws[r]
    for t in range(1, n):
        j = (r - t) % n
        acc = acc + _dequantize_int8(qs[j], scales[j]) * ws[j]
    return acc


def _all_gather(t, group, n):
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t, group=group)
    return out


def fedavg_sync_compressed(params_stacked, global_params, weights,
                           group=None, n_pods: Optional[int] = None):
    """Aggregate client *deltas* (client - global) in int8 over a ring of
    pods, then add back to the global model.

    Deltas (not raw weights) are quantized: their range is far smaller
    after a round of local training, so the int8 error stays within
    2 amax(delta) / 127 of the plain average. `global_params` is this
    rank's pre-round model, the same on every client after the previous
    barrier. Over `group`, each rank's q, scale and weight are gathered
    with `all_gather` (n-1 pieces received a rank, as a ring moves them)
    and summed locally in the ring's order, so pod r's sum is the JAX
    package's pod r's; for n > 2 the pods add the same terms in
    different orders, and their results may differ in the last bits.
    """
    wn = (weights / torch.sum(weights)).float().to(_device(params_stacked))
    if group is not None:
        rank, n = _group_rank(group)
    else:
        rank, n = None, flatten_with_paths(params_stacked)[0][1].shape[0]
    if n_pods is not None and n_pods != n:
        raise ValueError(f"fedavg_sync_compressed: n_pods={n_pods}, but "
                         f"{n} clients take part")
    if wn.shape != (n,):
        raise ValueError(f"fedavg_sync_compressed: weights {tuple(wn.shape)}"
                         f" for {n} clients")

    def one_leaf(p_stk, g):
        delta = p_stk.float() - g.float()[None]
        if group is None:
            coded = [_quantize_int8(d) for d in delta]
            qs, scales = [q for q, _ in coded], [s for _, s in coded]
            ws = list(wn)
            acc = torch.stack([_ring_sum(qs, scales, ws, r)
                               for r in range(n)])
        else:
            if p_stk.shape[0] != 1:
                raise ValueError("fedavg_sync_compressed: one client slot "
                                 "a rank over a group")
            q, scale = _quantize_int8(delta[0])
            qs = _all_gather(q, group, n)
            sw = _all_gather(torch.stack([scale, wn[rank]]), group, n)
            acc = _ring_sum(qs, [x[0] for x in sw], [x[1] for x in sw],
                            rank)[None]
        fedavg_sync_compressed.collective_bytes += (n - 1) * (
            delta[0].numel() + 8)
        fedavg_sync_compressed.collectives += 2 * int(n > 1)
        return (g.float()[None] + acc.expand(p_stk.shape)).to(p_stk.dtype)

    return tree_map(one_leaf, params_stacked, global_params)


fedavg_sync_compressed.collective_bytes = 0
fedavg_sync_compressed.collectives = 0


def collective_stats() -> CollectiveStats:
    """The bytes and calls both aggregations counted since the last
    `reset_collective_stats`, by collective kind."""
    return CollectiveStats(
        {"all-reduce": fedavg_sync.collective_bytes,
         "all-gather": fedavg_sync_compressed.collective_bytes},
        {"all-reduce": fedavg_sync.collectives,
         "all-gather": fedavg_sync_compressed.collectives})


def reset_collective_stats() -> None:
    for fn in (fedavg_sync, fedavg_sync_compressed):
        fn.collective_bytes = 0
        fn.collectives = 0


# ---------------------------------------------------------------------------
# The full FL round step: N local steps, then the synchronous barrier.
# ---------------------------------------------------------------------------
def _local_train(cfg, opt, params, mu, batches, local_steps):
    """`local_steps` SGD-momentum steps of one client: m = 0.9 m + g in
    fp32, p = p - opt m cast back to p's dtype. Returns the new flat
    params and momentum and the mean loss (a 0-d fp32 tensor)."""
    p = {k: v.detach() for k, v in flatten_with_paths(params)}
    m = dict(flatten_with_paths(mu))
    losses = []
    for s in range(local_steps):
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        loss = lm.loss_fn(unflatten(leaves), cfg,
                          {k: v[s] for k, v in batches.items()})
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    materialize_grads=True)
        with torch.no_grad():
            for (k, leaf), g in zip(leaves.items(), grads):
                m[k] = 0.9 * m[k] + g.float()
                p[k] = (leaf.float() - opt * m[k]).to(leaf.dtype)
        losses.append(loss.detach())
    return p, m, torch.mean(torch.stack(losses))


def make_fl_round_step(cfg, opt, shard: ShardingCtx = INERT,
                       local_steps: int = 1, compressed: bool = False,
                       group=None, n_pods: int = 1):
    """Returns round_step(params_stacked, mu_stacked, batches, weights)
    -> (params_stacked, mu_stacked, losses (C_local,)).

    params_stacked : (C, ...) model params (stacked), or (1, ...) on each
                     rank of `group`
    mu_stacked     : the same tree in fp32, each client's momentum
    batches        : dict of (C, local_steps, B_local, S) tensors (or
                     (1, ...) a rank)
    weights        : (C,) FedAvg weights (client sample counts)

    Each local client slot trains its `local_steps` steps in turn (the JAX
    package vmaps the slots and scans the steps), then all clients
    aggregate: `fedavg_sync`, or with `compressed` the int8 ring over
    `n_pods` clients. `shard` is accepted for the reference's signature
    and is an identity here (`sharding/rules.py`).
    """

    def round_step(params_stacked, mu_stacked, batches, weights):
        flat_p = dict(flatten_with_paths(params_stacked))
        flat_mu = dict(flatten_with_paths(mu_stacked))
        n_local = next(iter(flat_p.values())).shape[0]
        global_params = unflatten({k: v[0] for k, v in flat_p.items()})
        slots = [_local_train(cfg, opt,
                              unflatten({k: v[c] for k, v in flat_p.items()}),
                              {k: v[c] for k, v in flat_mu.items()},
                              {k: v[c] for k, v in batches.items()},
                              local_steps)
                 for c in range(n_local)]
        new_p = unflatten({k: torch.stack([s[0][k] for s in slots])
                           for k in flat_p})
        new_mu = unflatten({k: torch.stack([s[1][k] for s in slots])
                            for k in flat_mu})
        losses = torch.stack([s[2] for s in slots])
        del slots
        if compressed:
            agg = fedavg_sync_compressed(new_p, global_params, weights,
                                         group, n_pods)
        else:
            agg = fedavg_sync(new_p, weights, group)
        return agg, new_mu, losses

    return round_step


def stack_params_for_clients(params, n_clients: int):
    """Every leaf with a leading client dim of `n_clients` (a view)."""
    return tree_map(lambda p: p[None].expand((n_clients,) + p.shape), params)
