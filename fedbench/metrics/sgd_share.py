"""sgd_share: the SGD-momentum update's share of the traced window. It
reads the program's spans: the device wall of every step's `fl.sgd` (the
fp32 momentum and the parameter writes, a few launches a leaf)."""
from fedbench.harness import spans


def read(ctx):
    return spans.window_share(ctx, "fl.sgd")
