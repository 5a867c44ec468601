"""Client training-state snapshots in an `ObjectStore`.

The paper's clients checkpoint to cloud storage (Fig. 1) so a preempted
instance's replacement can resume mid-epoch. This module is the small
serialization layer between the round engines and
`repro_torch.checkpoint.store`: a snapshot is a JSON-encodable dict of plain
training metadata (round index, seconds of epoch progress preserved,
seconds still owed), written through the store's atomic `put` so a
reclaim mid-write never corrupts the latest durable state.

Engines use it on the preemption-notice path (docs/events.md): a
warning-window checkpoint is `save_snapshot`, the replacement
instance's recovery is `load_snapshot`. Keys are per client and
overwrite — only the latest snapshot matters for recovery.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional

from repro_torch.checkpoint.store import ObjectStore

KEY_PREFIX = "ckpt/clients/"


def snapshot_key(client: str) -> str:
    """Store key holding `client`'s latest training snapshot."""
    return f"{KEY_PREFIX}{client}/latest"


def save_snapshot(store: ObjectStore, client: str,
                  payload: Dict[str, Any]) -> str:
    """Persist `payload` (JSON-encodable training metadata) as the
    client's latest snapshot; returns the key written."""
    key = snapshot_key(client)
    store.put(key, json.dumps(payload, sort_keys=True).encode("utf-8"))
    return key


def load_snapshot(store: ObjectStore,
                  client: str) -> Optional[Dict[str, Any]]:
    """The client's latest snapshot, or None if it never checkpointed
    (or the snapshot was deleted after a clean resume)."""
    raw = store.get(snapshot_key(client))
    if raw is None:
        return None
    return json.loads(raw.decode("utf-8"))


def delete_snapshot(store: ObjectStore, client: str) -> None:
    """Drop the client's snapshot (after a successful resume or a
    round completion that supersedes it)."""
    store.delete(snapshot_key(client))
