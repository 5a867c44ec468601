"""ssd_bwd_roofline: the SSD scan backward kernels' share of their
roofline, from the device trace.

One backward call launches one `ssd_bwd_sm90_kernel` (and the helper
kernels named `ssd_bwd_<part>_kernel`), every call at the cell's shape:
(batch, seq, the configuration's ssm heads x head dim, its groups and
state). A call's least time is the larger of twice the forward's chunked
scan products at the tensor-core kernel's 128-row pieces (whatever
pieces the backward cuts) over the bf16 peak, and its bytes over the HBM
peak: x, gy and dx, the fp32 log decay and its gradient, one group's B,
C, dB and dC, each once. The share is the calls' least time over the
summed device time of every backward kernel. Without such a kernel in
the trace (a program whose backward runs no kernel) it reads nothing.
"""
import re

from fedbench.harness import work

CALLS = re.compile(r"\bssd_bwd_sm90_kernel\b")
KERNELS = re.compile(r"\bssd_bwd\w*_kernel\b")


def ssd_bwd_bytes(b, s, h, p, g, n, elem_bytes):
    return (3 * b * s * h * p * elem_bytes + 2 * b * s * h * 4
            + 4 * b * s * g * n * elem_bytes)


def read(ctx):
    z = work.layer_dims(ctx["dims"], "mamba2")
    mix, peaks = ctx["mix"], ctx["peaks"]
    if peaks is None or z is None:
        return None
    bf16 = ctx["cfg"]["torch_dtype"] == "bfloat16"
    b, s = mix["batch"], mix["seq"]
    flops = 2 * work.ssd_flops(b, s, z["nh"], z["p"], z["n"], work.SSD_PIECE)
    nbytes = ssd_bwd_bytes(b, s, z["nh"], z["p"], z["g"], z["n"],
                           2 if bf16 else 4)
    least = work.bound_s(flops, nbytes,
                         peaks["bf16_flops" if bf16 else "fp32_flops"],
                         peaks["hbm_bytes_s"])
    calls, total = 0, 0.0
    for name, _, d in ctx["device"]:
        if KERNELS.search(name):
            calls += bool(CALLS.search(name))
            total += d / 1e6
    return 100.0 * calls * least / total if calls and total > 0 else None
