"""mlp_share: the MLPs' share of the traced window. It reads the
program's spans: the device wall of every `lm.mlp` (one MLP of
`models/lm.py`, in the forward and again in remat's recompute inside the
backward; the MLP's backward lies outside it), its launch gaps included.
A program without the span reads nothing."""
from fedbench.harness import spans


def read(ctx):
    return spans.window_share(ctx, "lm.mlp")
