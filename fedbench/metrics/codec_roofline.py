"""codec_roofline: the int8 block codec's kernels (quantize and
dequantize) against their roofline, from the device trace.

A round sends every leaf of every participant's fp32 delta through one
quantize and one dequantize launch; a launch over n elements in rows of
2048 moves 4n bytes of fp32, the int8 rows and the fp32 scales, each once
(bytes bound: the arithmetic is a few operations an element). The
launches traced, over the leaves a round sends, give the leaf sizes they
ran at; the share is their least time over their summed device time.
"""
import re

QUANTIZE = re.compile(r"(?<!de)\bquantize_kernel\b")
DEQUANTIZE = re.compile(r"\bdequantize_kernel\b")
BLOCK = 2048


def codec_bytes(n):
    rows = max(-(-n // BLOCK), 1)
    return 4 * n + rows * BLOCK + 4 * rows


def read(ctx):
    peaks, mix = ctx["peaks"], ctx["mix"]
    if peaks is None or mix["arm"] != "int8":
        return None
    sizes = ctx["leaf_sizes"]
    per_leaf = sum(codec_bytes(n) for n in sizes) / len(sizes)
    least, total = 0.0, 0.0
    for name, _, d in ctx["device"]:
        if DEQUANTIZE.search(name) or QUANTIZE.search(name):
            least += per_leaf / peaks["hbm_bytes_s"]
            total += d / 1e6
    return 100.0 * least / total if total > 0 else None
