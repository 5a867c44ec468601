"""mfu: the model FLOPs of the traced rounds over the traced window's
seconds at the card's bf16 peak (the family's `model_flops`,
`fedbench/families/`: 6 x the dense products' parameters x tokens, plus 3
x the mixer's forward)."""


def read(ctx):
    peaks = ctx["peaks"]
    if peaks is None or ctx["rounds"] < 1 or ctx["window_s"] <= 0:
        return None
    flops = ctx["family"].model_flops(ctx["cfg"], ctx["mix"]) * ctx["rounds"]
    return 100.0 * flops / (ctx["window_s"] * peaks["bf16_flops"])
