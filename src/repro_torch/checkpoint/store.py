"""Object store abstraction — the simulated S3 (paper Fig. 1: clients
checkpoint to cloud storage; server & clients exchange models through it).

Backends: in-memory (tests) and local filesystem (examples). Keys are
hierarchical strings; values are bytes. Writes are atomic (temp + rename)
so a preemption mid-write never corrupts the latest checkpoint.
"""
from __future__ import annotations

import os
import tempfile
import threading
from typing import Dict, List, Optional


class ObjectStore:
    """Abstract key -> bytes store (the simulated S3 surface)."""

    def put(self, key: str, data: bytes) -> None:
        """Durably write `data` under `key`, replacing any old value."""
        raise NotImplementedError

    def get(self, key: str) -> Optional[bytes]:
        """The bytes under `key`, or None if absent."""
        raise NotImplementedError

    def list(self, prefix: str = "") -> List[str]:
        """Sorted keys starting with `prefix`."""
        raise NotImplementedError

    def delete(self, key: str) -> None:
        """Remove `key` (a no-op when absent)."""
        raise NotImplementedError


class MemoryStore(ObjectStore):
    """In-process dict-backed store (tests, default runs)."""

    def __init__(self):
        self._data: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def put(self, key, data):
        """Store a copy of `data` under `key`."""
        with self._lock:
            self._data[key] = bytes(data)

    def get(self, key):
        """The bytes under `key`, or None."""
        with self._lock:
            return self._data.get(key)

    def list(self, prefix=""):
        """Sorted keys starting with `prefix`."""
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))

    def delete(self, key):
        """Remove `key` if present."""
        with self._lock:
            self._data.pop(key, None)


class FileStore(ObjectStore):
    """Local-filesystem store; keys flatten to one directory level
    (`/` -> `__`), writes are atomic (temp file + rename)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        safe = key.replace("/", "__")
        return os.path.join(self.root, safe)

    def put(self, key, data):
        """Atomically write `data` under `key` (temp + rename), so a
        crash/preemption mid-write never corrupts the old value."""
        path = self._path(key)
        fd, tmp = tempfile.mkstemp(dir=self.root)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)          # atomic
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def get(self, key):
        """The bytes under `key`, or None."""
        path = self._path(key)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    def list(self, prefix=""):
        """Sorted keys starting with `prefix`."""
        safe = prefix.replace("/", "__")
        return sorted(k.replace("__", "/") for k in os.listdir(self.root)
                      if k.startswith(safe) and not k.startswith("tmp"))

    def delete(self, key):
        """Remove `key` if present."""
        path = self._path(key)
        if os.path.exists(path):
            os.unlink(path)
