"""idle_share: the share of the traced window in which no operation ran
on the device (1 - the union of the device ops' intervals over the
window), from torch.profiler's trace."""


def read(ctx):
    if ctx["window_s"] <= 0 or ctx["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
