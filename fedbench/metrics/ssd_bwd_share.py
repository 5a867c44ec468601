"""ssd_bwd_share: the SSD backward's share of the traced window. It reads
the program's spans: the device wall of every `ssd.bwd` (the SSD op's
backward: the tensor-core backward kernel for bf16 at the head dims the
forward kernel takes, the plain recompute otherwise), its launch gaps
included."""
from fedbench.harness import spans


def read(ctx):
    return spans.window_share(ctx, "ssd.bwd")
