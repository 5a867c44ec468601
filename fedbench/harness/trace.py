"""The traced window: whole rounds under `torch.profiler`, read back from
its Chrome trace (written to a temporary file and deleted).

The rounds whose device ops give the per-layer metrics are traced with
CUDA activity alone: recording every host op as well stretched a
24-layer mamba2 round's host time by half and more, and with it the idle
share. One more round is traced with the host's events too, to say what
the host was doing in each idle gap: the innermost host event running at
the gap's middle (an aten op, one of the program's own spans, such as
`fl.data_draw`, or the benchmark's `fedbench.round` around each call into
the program).
"""
from __future__ import annotations

import collections
import json
import os
import tempfile
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def read_chrome_trace(path: str) -> dict:
    """Device ops [(name, start_us, dur_us)] and host events
    [(name, start_us, dur_us)] of a Chrome trace file."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        row = (e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
        if e.get("cat") in DEVICE_CATS:
            dev.append(row)
        elif e.get("cat") in HOST_CATS:
            host.append(row)
    return {"device": dev, "host": host}


def busy_intervals(device: List[Tuple[str, float, float]]):
    """The union of the device ops' intervals, in order (us)."""
    spans = sorted((t, t + d) for _, t, d in device)
    out: List[List[float]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_by_host(intervals, host, limit=10):
    """The idle time between busy intervals, summed by the innermost host
    event running at each gap's middle (the shortest one that covers
    it), the `limit` largest: [(name, seconds)]."""
    by = collections.defaultdict(float)
    host = sorted(host, key=lambda r: r[1])
    nxt, active = 0, []
    # the gaps come in time order: sweep the host events once
    for (_, a), (b, _) in zip(intervals, intervals[1:]):
        mid = (a + b) / 2
        while nxt < len(host) and host[nxt][1] <= mid:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h[1] + h[2] >= mid]
        name = min(active, key=lambda h: h[2])[0] if active else "host"
        by[name] += (b - a) / 1e6
    return sorted(by.items(), key=lambda kv: -kv[1])[:limit]


def device_ops(device, limit=10):
    """Device seconds by op name, the `limit` largest: [(name, s)]."""
    by = collections.defaultdict(float)
    for name, _, d in device:
        by[name] += d / 1e6
    return sorted(by.items(), key=lambda kv: -kv[1])[:limit]


def profile_rounds(step, rounds: int, dev, host: bool = False) -> Dict:
    """Run `step()` `rounds` times under the profiler, on the host clock
    from a synchronized start to a synchronized end, recording the host's
    events too where `host` (always on the CPU, which has no other).
    Returns the window's seconds and the trace's device ops and host
    events."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cuda = dev.type == "cuda"
    activities = ([ProfilerActivity.CPU] if host or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with profile(activities=activities) as prof:
            sync()
            t0 = time.perf_counter()
            for _ in range(rounds):
                with record_function("fedbench.round"):
                    step()
            sync()
            window = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        out = read_chrome_trace(path)
    finally:
        os.unlink(path)
    out["window_s"] = window
    return out
