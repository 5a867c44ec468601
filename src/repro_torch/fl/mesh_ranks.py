"""One FL client a process: `fl/mesh_fl.py`'s round over a
`torch.distributed` group of ranks.

`spawn_ranks` starts n processes (`spawn`), joins them into one gloo
group over a `FileStore` (a file, no port) and runs `worker(group, rank,
n, *args)` in each, returning each rank's result. gloo runs the same
code on CPU tensors and on CUDA ones, and several ranks may share one
card (NCCL refuses two ranks on one device), so the int8 ring runs
there on a single card.

`aggregate_on_rank` and `round_on_rank` are such workers: each rank
takes its own client slot of a stacked tree (numpy in, numpy out: what
crosses between processes is plain data) and aggregates over the group.
`tasks_on_rank` runs several workers in turn on one group, so one set
of processes serves them all.
"""
from __future__ import annotations

import os
import queue
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.bridge import flatten_with_paths, tree_map, unflatten
from repro_torch.common.device import require_device
from repro_torch.fl import mesh_fl


def _rank_main(worker, rank, n, store_path, args, results):
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, n), rank=rank,
            world_size=n)
        try:
            out = worker(dist.group.WORLD, rank, n, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:          # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(worker, n: int, store_path: str, *args,
                timeout: float = 600.0):
    """Run `worker(group, rank, n, *args)` in `n` spawned processes joined
    by gloo over a `FileStore` at `store_path` (which must not exist
    yet). `worker` must be importable by its module path, and its
    arguments and result picklable. Returns the results by rank; raises
    if a rank fails or does not answer within `timeout` seconds."""
    if os.path.exists(store_path):
        raise ValueError(f"spawn_ranks: store {store_path} exists")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(worker, r, n, store_path, args, results))
             for r in range(n)]
    for p in procs:
        p.start()
    out, errors = [None] * n, []
    try:
        # the first failure ends the wait: the other ranks may be blocked
        # in a collective with the failed one
        for _ in range(n):
            rank, ok, value = results.get(timeout=timeout)
            if not ok:
                errors.append(f"rank {rank}:\n{value}")
                break
            out[rank] = value
    except queue.Empty:
        errors.append(f"no answer within {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
            if p.is_alive():
                p.terminate()
                p.join()
    if errors:
        raise RuntimeError("spawn_ranks: " + "\n".join(errors))
    return out


def _to_numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _from_numpy(tree, dev):
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)


def _slot(tree, rank):
    """The rank's client slot of a stacked tree, leading dim kept."""
    return unflatten({k: v[rank:rank + 1]
                      for k, v in flatten_with_paths(tree)})


def aggregate_on_rank(group, rank, n, stacked, global_params, weights,
                      compressed, device="cuda"):
    """Aggregate this rank's slot of `stacked` ((n, ...) numpy leaves)
    over `group`: `fedavg_sync`, or with `compressed`
    `fedavg_sync_compressed` from `global_params`. Returns the rank's
    aggregate (numpy, leading dim 1) and the bytes it received."""
    dev = require_device(device, "aggregate_on_rank")
    mesh_fl.reset_collective_stats()
    mine = _from_numpy(_slot(stacked, rank), dev)
    w = torch.from_numpy(np.asarray(weights, np.float32)).to(dev)
    if compressed:
        agg = mesh_fl.fedavg_sync_compressed(
            mine, _from_numpy(global_params, dev), w, group, n)
    else:
        agg = mesh_fl.fedavg_sync(mine, w, group)
    return _to_numpy(agg), mesh_fl.collective_stats().bytes_by_kind


def round_on_rank(group, rank, n, cfg, params, batches, weights, opt,
                  local_steps, compressed, device="cuda"):
    """One `make_fl_round_step` round of this rank's client: `params` is
    the global model (numpy), `batches` the stacked (n, local_steps, B,
    S) token batches (numpy). Returns (the rank's aggregate, numpy with
    leading dim 1; its mean loss; the bytes it received)."""
    dev = require_device(device, "round_on_rank")
    mesh_fl.reset_collective_stats()
    p = mesh_fl.stack_params_for_clients(_from_numpy(params, dev), 1)
    mu = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                        device=dev), p)
    b = {k: torch.from_numpy(np.asarray(v[rank:rank + 1])).long().to(dev)
         for k, v in batches.items()}
    w = torch.from_numpy(np.asarray(weights, np.float32)).to(dev)
    step = mesh_fl.make_fl_round_step(cfg, opt, local_steps=local_steps,
                                      compressed=compressed, group=group,
                                      n_pods=n)
    agg, _, losses = step(p, mu, b, w)
    return (_to_numpy(agg), float(losses[0]),
            mesh_fl.collective_stats().bytes_by_kind)


def tasks_on_rank(group, rank, n, tasks):
    """Run each (worker, args) of `tasks` in turn on this rank's group;
    returns their results in order."""
    return [worker(group, rank, n, *args) for worker, args in tasks]
