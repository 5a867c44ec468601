"""ssd_fwd_roofline: the SSD scan forward kernels' share of their
roofline, from the device trace.

Every launch in a cell runs at the cell's shape: (batch, seq, the
configuration's ssm heads x head dim, its groups and state). A launch's
least time is the larger of the chunked scan's products, counted at the
rows a chunk that the launched kernel runs (the tensor-core kernel's
128-row pieces; the other kernel's chunk), over the peak of the inputs'
dtype, and its bytes over the HBM peak: x read and y written, the fp32
log decay, one group's B and C read once. The share is the launches'
least time over their summed device time.
"""
import re

from fedbench.harness import work

KERNELS = re.compile(r"\bssd_fwd(_sm90)?_kernel\b")


def ssd_bytes(b, s, h, p, g, n, elem_bytes):
    return (2 * b * s * h * p * elem_bytes + b * s * h * 4
            + 2 * b * s * g * n * elem_bytes)


def read(ctx):
    z = work.layer_dims(ctx["dims"], "mamba2")
    mix, peaks = ctx["mix"], ctx["peaks"]
    if peaks is None or z is None:
        return None
    bf16 = ctx["cfg"]["torch_dtype"] == "bfloat16"
    b, s = mix["batch"], mix["seq"]
    least, total = 0.0, 0.0
    for name, _, d in ctx["device"]:
        m = KERNELS.search(name)
        if not m:
            continue
        rows = (min(work.SSD_PIECE, z["chunk"]) if m.group(1)
                else min(z["chunk"], s))
        flops = work.ssd_flops(b, s, z["nh"], z["p"], z["n"], rows)
        nbytes = ssd_bytes(b, s, z["nh"], z["p"], z["g"], z["n"],
                           2 if bf16 else 4)
        least += work.bound_s(flops, nbytes,
                              peaks["bf16_flops" if bf16 else "fp32_flops"],
                              peaks["hbm_bytes_s"])
        total += d / 1e6
    return 100.0 * least / total if total > 0 else None
