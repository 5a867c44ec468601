"""Spans of the port's FL round, on the profiler's clock.

Turning it on. Tracing is on exactly while a `torch.profiler` records:
run the round inside `with torch.profiler.profile(...):`, with any
activities. There is no flag, option or environment variable. With no
profiler recording, `span` costs one boolean read and returns one shared
no-op context: no `record_function`, no CUDA event, no record.

What each span covers (`fl/training.py`, `models/lm.py` and the
kernels' autograd Functions):

    fl.round          TorchTrainerHooks.aggregate, its whole body
    fl.data_draw      every slot's batches in _next_batches
    fl.local_train    one participant's _local_train
    lm.step           one batch of it: forward, backward, update
    lm.forward        the models.lm.loss_fn call
    lm.backward       the torch.autograd.grad call, recompute included
    lm.mix.mamba2     one Mamba2 mixer (models/lm.py), in the forward
                      and, under remat, again in the backward's
                      recompute
    lm.mix.attn       one attention mixer (self or cross), the same way
    lm.mlp            one MLP (dense or MoE), the same way
    fl.sgd            the momentum and parameter writes of a step
    fl.loss_readback  the participant's losses copied to the host
    fl.fold           one participant's delta, codec round trip, weight
                      and sum
    fl.apply          the new global parameters
    attn.bwd          kernels/flash_attention's backward
    ssd.bwd           kernels/ssd's backward: the tensor-core kernel
                      (bf16) or the plain recompute, its scratch and
                      outputs allocated

Each span enters `torch.profiler.record_function(name)`, so it lands in
the profiler's trace as a `user_annotation` beside the ops it launched,
on the same clock: a profiler that names the host event under a device
idle gap names the innermost span. Every span of a round carries the
round's index (`Span.round`, given to `fl.round`).

Device wall. Where CUDA is in use, a span records a CUDA event on the
current stream at its start and at its end, and its device wall
(`Span.device_s`) is the time between the two on the device: its
kernels, and the idle it causes the device by holding the host (a data
draw, a readback, launch gaps). A span that starts while the device
still runs earlier work counts from when the device reaches it. On the
CPU the device wall is the host duration (`Span.host_s`, from
`time.perf_counter_ns`).

Reading. `roots(name)` returns the completed top-level spans, oldest
first (of that name, if one is given), each with its `children` in the
order they started; `Span.walk()` yields a span and all below it. The
first `roots` call after new spans resolves their events with one
`torch.cuda.synchronize`; nothing synchronizes inside the round.

Memory. While the profiler records, a span keeps only strings and
integers in flat lists, and its two events come from a pool made in
blocks: a record holds no object that Python's garbage collector
tracks, so the spans leave the collector's work as it was (in a large
process its full collections take about a second each). The records
and the pool are kept until `clear()`, a few dozen host bytes and two
CUDA events a span: a program that profiles without end calls
`clear()` between reads. The stack of open spans is process-wide, not
per thread: autograd runs a Function's backward on its own thread while
the caller waits in `torch.autograd.grad`, and those spans belong under
`lm.backward`. A span closed while another is open above it (two
threads opening spans at once) raises `RuntimeError`.
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, List, Optional

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()
EVENT_BLOCK = 1024       # CUDA events made at once when the pool runs out

# one entry a span, in the order the spans started
_name: List[str] = []
_parent: List[int] = []  # the enclosing span's record, -1 at a root
_round: List[int] = []   # -1 where no round encloses the span
_event: List[int] = []   # its first pool event, -1 without CUDA
_t0: List[int] = []      # host clock at enter and exit (ns)
_t1: List[int] = []
_open: List[int] = []    # the open spans' records, innermost last
_pool: list = []         # CUDA events, two a record, used again after clear()
_used = 0                # events of the pool handed out
# what roots() has resolved: one Span a record, and the top-level ones
_views: List["Span"] = []
_roots: List["Span"] = []


class Span:
    """One completed span, resolved: its name, round, host and device
    seconds, and the spans it contains."""

    __slots__ = ("name", "round", "children", "host_s", "device_s")

    def __init__(self, name: str, rnd: Optional[int], host_s: float,
                 device_s: float):
        self.name = name
        self.round = rnd
        self.children: List[Span] = []
        self.host_s = host_s
        self.device_s = device_s

    def walk(self) -> Iterator["Span"]:
        """This span, then every span below it, depth first."""
        yield self
        for c in self.children:
            yield from c.walk()


class _Recording:
    """The context of one span while a profiler records."""

    __slots__ = ("_name", "_rnd", "_i", "_rf")

    def __init__(self, name: str, rnd: Optional[int]):
        self._name = name
        self._rnd = rnd

    def __enter__(self):
        global _used
        i = len(_name)
        parent = _open[-1] if _open else -1
        rnd = self._rnd
        if rnd is None:
            rnd = _round[parent] if parent >= 0 else -1
        _name.append(self._name)
        _parent.append(parent)
        _round.append(rnd)
        _open.append(i)
        self._i = i
        _t0.append(time.perf_counter_ns())
        _t1.append(0)
        self._rf = torch.profiler.record_function(self._name)
        self._rf.__enter__()
        e = -1
        if torch.cuda.is_initialized():
            e = _used
            if e + 2 > len(_pool):
                _pool.extend(torch.cuda.Event(enable_timing=True)
                             for _ in range(EVENT_BLOCK))
            _used = e + 2
            _pool[e].record()
        _event.append(e)
        return self

    def __exit__(self, *exc):
        i = self._i
        if _open[-1] != i:
            raise RuntimeError(
                f"span {self._name!r} closed while {_name[_open[-1]]!r}, "
                f"opened after it, is still open")
        if _event[i] >= 0:
            _pool[_event[i] + 1].record()
        self._rf.__exit__(*exc)
        _t1[i] = time.perf_counter_ns()
        _open.pop()
        return False


def span(name: str, round: Optional[int] = None):
    """A context that traces `name` while a profiler records, and does
    nothing otherwise; `round` is the round's index, which the spans
    inside it inherit."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, round)


def roots(name: Optional[str] = None) -> List[Span]:
    """The completed top-level spans (named `name`, if given), oldest
    first, with their device walls resolved."""
    end = _open[0] if _open else len(_name)
    start = len(_views)
    if start < end:
        if any(e >= 0 for e in _event[start:end]):
            torch.cuda.synchronize()
        for i in range(start, end):
            host = (_t1[i] - _t0[i]) / 1e9
            e = _event[i]
            dev = _pool[e].elapsed_time(_pool[e + 1]) / 1e3 if e >= 0 \
                else host
            s = Span(_name[i], _round[i] if _round[i] >= 0 else None,
                     host, dev)
            _views.append(s)
            if _parent[i] >= 0:
                _views[_parent[i]].children.append(s)
            else:
                _roots.append(s)
    return [r for r in _roots if name is None or r.name == name]


def clear() -> None:
    """Forget every completed span; the pool's events are used again."""
    global _used
    if _open:
        raise RuntimeError("trace.clear() while a span is open")
    for store in (_name, _parent, _round, _event, _t0, _t1, _views,
                  _roots):
        store.clear()
    _used = 0
