"""attn_bwd_share: the attention backward's share of the traced window.
It reads the program's spans: the device wall of every `attn.bwd` (the
flash-attention op's backward, which recomputes attention with the plain
version), its launch gaps included."""
from fedbench.harness import spans


def read(ctx):
    return spans.window_share(ctx, "attn.bwd")
