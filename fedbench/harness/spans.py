"""The program's own spans (`repro_torch.common.trace`), read for the
per-layer metrics of the traced window.

The port records a span at each layer boundary of its FL round while a
profiler records. The window's rounds are the first `ctx["rounds"]`
`fl.round` spans: set-up runs untraced, and the labelled round traced
after the window comes later. A span's device wall is the time between
its two CUDA events: its kernels and the device idle it causes.
"""
from __future__ import annotations

from typing import Optional


def window_share(ctx, *names: str) -> Optional[float]:
    """100 x the summed device wall of the spans named `names` in the
    window's rounds, over the window's seconds; None where no such span
    ran (or the port records none)."""
    try:
        from repro_torch.common import trace
    except ImportError:
        return None
    if ctx["window_s"] <= 0:
        return None
    rounds = trace.roots("fl.round")[:ctx["rounds"]]
    walls = [s.device_s for r in rounds for s in r.walk() if s.name in names]
    if not walls:
        return None
    return 100.0 * sum(walls) / ctx["window_s"]
