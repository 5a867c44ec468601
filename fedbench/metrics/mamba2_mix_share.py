"""mamba2_mix_share: the Mamba2 mixers' share of the traced window. It
reads the program's spans: the device wall of every `lm.mix.mamba2` (one
Mamba2 mixer of `models/lm.py`, in the forward and again in remat's
recompute inside the backward; the mixer's own backward lies outside
it), its launch gaps included. A program without the span reads
nothing."""
from fedbench.harness import spans


def read(ctx):
    return spans.window_share(ctx, "lm.mix.mamba2")
