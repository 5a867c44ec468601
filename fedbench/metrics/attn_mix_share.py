"""attn_mix_share: the attention mixers' share of the traced window.
It reads the program's spans: the device wall of every `lm.mix.attn`
(one attention mixer of `models/lm.py`, in the forward and again in
remat's recompute inside the backward; the attention backward, which
`attn_bwd_share` reads, lies outside it), its launch gaps included. A
program without the span reads nothing."""
from fedbench.harness import spans


def read(ctx):
    return spans.window_share(ctx, "lm.mix.attn")
