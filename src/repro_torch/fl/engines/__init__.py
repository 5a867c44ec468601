"""RoundEngine registry.

Policies name their engine by registry key (`Policy.engine`); the
composition root resolves it here. To add a new round discipline,
subclass `BaseEngine`, register it, and point a policy at it — no
changes to the cloud, cluster, or accounting layers required.
"""
from __future__ import annotations

from typing import Dict, Type

from repro_torch.fl.engines.base import BaseEngine, EngineContext
from repro_torch.fl.engines.sync import SyncEngine
from repro_torch.fl.engines.async_buffered import AsyncBufferedEngine

ENGINES: Dict[str, Type[BaseEngine]] = {
    "sync": SyncEngine,
    "async_buffered": AsyncBufferedEngine,
    "fedbuff": AsyncBufferedEngine,       # alias: the algorithm's name
}


def get_engine(name: str) -> Type[BaseEngine]:
    """Resolve a registry key to an engine class (KeyError lists the
    known keys)."""
    try:
        return ENGINES[name]
    except KeyError:
        raise KeyError(
            f"unknown round engine {name!r}; known: {sorted(ENGINES)}")


__all__ = ["BaseEngine", "EngineContext", "SyncEngine",
           "AsyncBufferedEngine", "ENGINES", "get_engine"]
