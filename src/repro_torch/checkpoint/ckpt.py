"""Pytree checkpointing to an ObjectStore: serialization, sharded layout,
async writes, and resume. The port of the JAX package's
`checkpoint/ckpt.py`, writing its byte format exactly, so each package
restores the other's checkpoints.

A checkpoint is one object: an 8-byte little-endian header length, a
JSON header `{"leaves": [{"key", "dtype", "shape"}, ...]}` with each
leaf's `/`-joined path (`common/bridge.py::flatten_with_paths`, the JAX
package's `_flatten_with_paths`: `opt_state/.mu/c1` for a NamedTuple
field) and its numpy dtype name, then each leaf's raw bytes behind
their 8-byte length. Tensor leaves are copied to the host; a Python
number is a 0-d numpy value, as `np.asarray` makes it (an int is
int64). bfloat16 is written as its bits, so no numpy bfloat16 type is
needed.

`ShardedCheckpointer` writes one object per (host, leaf), the layout at
pod scale where each process persists only what it owns.

Restores need a template: the JAX package's `Checkpointer.restore`
without one reads the body as an npz file, which `serialize_pytree`
never writes (ROADMAP §3, fault (b)), so the port has only the template
restore.
"""
from __future__ import annotations

import io
import json
import queue
import threading
from typing import List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import ObjectStore
from repro_torch.common.bridge import flatten_with_paths, unflatten_as

_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}


# ---------------------------------------------------------------------------
# Pytree <-> bytes.
# ---------------------------------------------------------------------------
def _encode(leaf):
    """(dtype name, shape, raw bytes) of one leaf, as numpy names them."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", list(t.shape), t.view(torch.int16).numpy() \
                .tobytes()
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return str(arr.dtype), list(arr.shape), arr.tobytes()


def _decode(buf: bytes, dtype: str, shape) -> torch.Tensor:
    dt = _TORCH_DTYPES[dtype]
    if not buf:
        return torch.empty(shape, dtype=dt)
    return torch.frombuffer(bytearray(buf), dtype=dt).reshape(shape)


def serialize_pytree(tree) -> bytes:
    """Raw-bytes encoding (dtype-string + shape + buffer per leaf)."""
    metas, bufs = [], []
    for key, leaf in flatten_with_paths(tree):
        dtype, shape, buf = _encode(leaf)
        metas.append({"key": key, "dtype": dtype, "shape": shape})
        bufs.append(buf)
    header = json.dumps({"leaves": metas}).encode()
    out = io.BytesIO()
    out.write(len(header).to_bytes(8, "little"))
    out.write(header)
    for b in bufs:
        out.write(len(b).to_bytes(8, "little"))
        out.write(b)
    return out.getvalue()


def _decode_leaves(data: bytes) -> List[torch.Tensor]:
    hlen = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + hlen])
    pos = 8 + hlen
    leaves = []
    for meta in header["leaves"]:
        n = int.from_bytes(data[pos:pos + 8], "little")
        pos += 8
        leaves.append(_decode(data[pos:pos + n], meta["dtype"],
                              meta["shape"]))
        pos += n
    return leaves


def _like(arr: torch.Tensor, tpl):
    """`arr` on the template leaf's device and in its dtype; a Python
    number's template leaves the stored CPU tensor as it is."""
    if isinstance(tpl, torch.Tensor):
        return arr.to(device=tpl.device, dtype=tpl.dtype)
    return arr


def deserialize_into(template, data: bytes):
    """Restore leaves into the structure of `template`."""
    leaves = _decode_leaves(data)
    tpl = [leaf for _, leaf in flatten_with_paths(template)]
    if len(leaves) != len(tpl):
        raise ValueError(f"checkpoint holds {len(leaves)} leaves, the "
                         f"template {len(tpl)}")
    return unflatten_as(template, [_like(a, t) for a, t in zip(leaves, tpl)])


# ---------------------------------------------------------------------------
# Checkpointer (single object per key).
# ---------------------------------------------------------------------------
class Checkpointer:
    def __init__(self, store: ObjectStore, prefix: str = "ckpt"):
        self.store = store
        self.prefix = prefix

    def _k(self, key: str) -> str:
        return f"{self.prefix}/{key}"

    def save(self, key: str, tree) -> None:
        self.store.put(self._k(key), serialize_pytree(tree))

    def restore(self, key: str, template):
        """The tree saved under `key` in `template`'s structure, or None."""
        data = self.store.get(self._k(key))
        if data is None:
            return None
        return deserialize_into(template, data)

    def latest_step(self, prefix: str) -> Optional[int]:
        keys = self.store.list(self._k(prefix))
        steps = []
        for k in keys:
            tail = k.rsplit("step=", 1)
            if len(tail) == 2:
                try:
                    steps.append(int(tail[1].split("/")[0]))
                except ValueError:
                    pass
        return max(steps) if steps else None


# ---------------------------------------------------------------------------
# Async + sharded variants (pod-scale).
# ---------------------------------------------------------------------------
class AsyncCheckpointer(Checkpointer):
    """Non-blocking saves on a writer thread (overlaps training compute —
    the standard trick so checkpoint I/O does not stall the step loop)."""

    def __init__(self, store: ObjectStore, prefix: str = "ckpt"):
        super().__init__(store, prefix)
        self._q: "queue.Queue" = queue.Queue()
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()
        self._errors: List[BaseException] = []

    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            key, data = item
            try:
                self.store.put(self._k(key), data)
            except BaseException as e:   # surfaced on wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def save(self, key: str, tree) -> None:
        # serialize synchronously (cheap, and tree may mutate), write async
        self._q.put((key, serialize_pytree(tree)))

    def wait(self):
        self._q.join()
        if self._errors:
            raise self._errors[0]


class ShardedCheckpointer:
    """One object per (host, shard) — each process persists only the
    array shards it owns. On restore, shards are reassembled (or loaded
    per-host at scale)."""

    def __init__(self, store: ObjectStore, prefix: str = "ckpt",
                 process_index: int = 0):
        self.store = store
        self.prefix = prefix
        self.process_index = process_index

    def save(self, key: str, tree) -> None:
        manifest = []
        for name, leaf in flatten_with_paths(tree):
            dtype, shape, buf = _encode(leaf)
            manifest.append({"name": name, "shape": shape, "dtype": dtype})
            self.store.put(
                f"{self.prefix}/{key}/p{self.process_index}/{name}", buf)
        self.store.put(f"{self.prefix}/{key}/MANIFEST",
                       json.dumps(manifest).encode())

    def restore(self, key: str, template):
        man = self.store.get(f"{self.prefix}/{key}/MANIFEST")
        if man is None:
            return None
        metas = {m["name"]: m for m in json.loads(man)}
        leaves = []
        for name, tpl in flatten_with_paths(template):
            data = self.store.get(
                f"{self.prefix}/{key}/p{self.process_index}/{name}")
            meta = metas[name]
            leaves.append(_like(_decode(data, meta["dtype"], meta["shape"]),
                                tpl))
        return unflatten_as(template, leaves)
