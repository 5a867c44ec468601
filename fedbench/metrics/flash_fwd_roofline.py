"""flash_fwd_roofline: the flash-attention forward kernels' share of
their roofline, from the device trace.

Every launch in a cell runs at the cell's shape (batch x seq, the
configuration's attention heads and head dim, causal). A launch's least
time is the larger of its causal-pair FLOPs over the bf16 (or fp32) peak
and its Q+K+V+O bytes, each once, over the HBM peak. The share is the launches'
least time over their summed device time. Nothing to read without a
launch of these kernels or without the card in the peak table.
"""
import re

from fedbench.harness import work

KERNELS = re.compile(r"\bflash_fwd(_sm90)?_kernel\b")


def read(ctx):
    times = [d for name, _, d in ctx["device"] if KERNELS.search(name)]
    z = work.layer_dims(ctx["dims"], "attn")
    mix, peaks = ctx["mix"], ctx["peaks"]
    if not times or peaks is None or z is None:
        return None
    bf16 = ctx["cfg"]["torch_dtype"] == "bfloat16"
    flops, nbytes = work.attention_work(
        mix["batch"], mix["seq"], mix["seq"], z["n"], z["h"],
        2 if bf16 else 4)
    least = work.bound_s(flops, nbytes,
                         peaks["bf16_flops" if bf16 else "fp32_flops"],
                         peaks["hbm_bytes_s"])
    return 100.0 * len(times) * least / (sum(times) / 1e6)
