"""The benchmark's `ssd_bwd_roofline` reader (`fedbench/metrics/`) by
hand, at mamba2-1.3b's cell: one call a `ssd_bwd_sm90_kernel` launch,
the summed device time of every `ssd_bwd_*_kernel`, nothing where no
backward kernel ran (a program whose backward is the plain recompute)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from fedbench.harness import spec as S, work            # noqa: E402
from fedbench.reference.schema import dims               # noqa: E402

CELL = "mamba2.int8.b2x2048"
KERNEL = ("void (anonymous namespace)::ssd_bwd_sm90_kernel<128>("
          "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
          "(anonymous namespace)::Args)")
REDUCE = ("(anonymous namespace)::ssd_bwd_reduce_kernel(float const*, "
          "float const*, __nv_bfloat16*, __nv_bfloat16*, long long, int, "
          "int, int)")


def _ctx(device, cell=CELL, peaks=True):
    spec = S.benchmark()
    w = S.cell(spec, cell)
    cfg, mix = S.config(spec, w["config"]), S.traffic(w["traffic"])
    return {"cfg": cfg, "mix": mix, "dims": dims(cfg), "device": device,
            "window_s": 2.0, "busy_s": 1.5, "rounds": 2,
            "peaks": S.peaks("NVIDIA H100 80GB HBM3") if peaks else None,
            "leaf_sizes": [1000]}


def _read(ctx):
    return S.reader("ssd_bwd_roofline")(ctx)


def test_a_call_at_mamba2s_layer_by_hand():
    """Two calls of 500 us in the kernel and 100 us in the reduce, beside
    a forward kernel the reader leaves out: the bound is 106,954,752
    bytes at 3.35 TB/s (0.0319 ms; 30.2 GFLOP take 0.0305 ms)."""
    dev = [(KERNEL, 0.0, 500.0), (REDUCE, 0.0, 100.0)] * 2 + [
        ("void (anonymous namespace)::ssd_fwd_sm90_kernel<128, 64>()", 0.0,
         140.0)]
    nbytes = 3 * 2 * 2048 * 64 * 64 * 2 + 2 * 2 * 2048 * 64 * 4 \
        + 4 * 2 * 2048 * 128 * 2
    flops = 2 * work.ssd_flops(2, 2048, 64, 64, 128, 128)
    assert nbytes == 106_954_752 and flops / 989e12 < nbytes / 3.35e12
    assert _read(_ctx(dev)) == pytest.approx(
        100.0 * 2 * (nbytes / 3.35e12) / 1200e-6)


@pytest.mark.parametrize("device,cell,peaks", [
    ([], CELL, True),
    ([("void (anonymous namespace)::ssd_fwd_sm90_kernel<128, 64>()", 0.0,
       140.0)], CELL, True),
    ([(KERNEL, 0.0, 500.0)], CELL, False),
    ([(KERNEL, 0.0, 500.0)], "phi3-d16.int8.b4x1024", True)])
def test_reads_nothing_without_the_kernel(device, cell, peaks):
    """No backward kernel in the trace (the parent's plain recompute), no
    published peaks, or a cell without an SSM: nothing to read."""
    assert _read(_ctx(device, cell, peaks)) is None
